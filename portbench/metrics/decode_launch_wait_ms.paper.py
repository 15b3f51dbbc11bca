"""decode_launch_wait_ms.paper: mean over the window's
``continuous.chunk.stats`` spans of ``first_step_ms - step_ms``: how long
the device waited for a chunk's first graph launch, by its own clock."""
from portbench import readers


def read(ctx):
    return readers.mean(a["first_step_ms"] - a["step_ms"]
                        for _, _, _, a in
                        readers.spans(ctx, "continuous.chunk.stats")
                        if "step_ms" in a)
