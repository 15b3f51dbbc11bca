"""paged_decode_attention_roofline.zamba2.backlog: the paged decode
attention kernel's share of its roofline over the traced slice's decode
chunks, in %: the least time for each step's live rows over every shared
application (``portbench.roofline_zamba2``: 32 heads of 224, their
cached K/V read once, q and the output once; rows that took no step
count nothing) over the profiler's time of the kernel (``paged_decode``)
inside those chunks; None outside a ``zamba2`` configuration."""
from portbench import readers, roofline_zamba2 as rz


def read(ctx):
    sl = ctx.profile
    if sl is None or ctx.spec.get("family") != "zamba2":
        return None
    bound = took = 0.0
    for c in readers.chunks_in(ctx, sl.start, sl.end):
        steps = max((n for _, n in c.rows), default=0)
        for i in range(steps):
            bound += rz.bound_s(*rz.decode_attention_cost(
                ctx.spec, readers.step_ctxs(c.rows, i)))
        took += sl.kernel_time("paged_decode", c.start, c.end)
    return readers.share(bound, took)
