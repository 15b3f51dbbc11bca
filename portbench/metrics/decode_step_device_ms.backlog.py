"""decode_step_device_ms.backlog: mean ``step_ms`` of the port's
``continuous.chunk.stats`` spans in the window: a decode step's time on
the device's own clock (CUDA events between the chunk's replays) when the
steps are fed back to back."""
from portbench import readers


def read(ctx):
    return readers.mean(a["step_ms"] for _, _, _, a in
                        readers.spans(ctx, "continuous.chunk.stats")
                        if "step_ms" in a)
