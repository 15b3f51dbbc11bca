"""mamba_state_roofline.zamba2.backlog: the Mamba2 layers' share of
their roofline in the window's decode steps, in %: the least time for
their weights once and every row's SSD and conv state read and written
once (``state_rows`` of each ``continuous.chunk.stats``), over the
step's ``mamba_ms``; None outside a ``zamba2`` configuration."""
from portbench import readers, roofline_zamba2 as rz


def read(ctx):
    if ctx.spec.get("family") != "zamba2":
        return None
    bound = took = 0.0
    for _, _, _, a in readers.spans(ctx, "continuous.chunk.stats"):
        if "mamba_ms" in a and "state_rows" in a:
            rows = a["state_rows"]
            bound += rz.bound_s(rz.mamba_step_flops(ctx.spec, rows),
                                rz.mamba_step_bytes(ctx.spec, rows))
            took += a["mamba_ms"] * 1e-3
    return readers.share(bound, took)
