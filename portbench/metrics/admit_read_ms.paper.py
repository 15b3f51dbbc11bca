"""admit_read_ms.paper: mean duration of the port's ``continuous.admit.read``
spans in the window: the blocking read of an admission's first tokens,
the device's tail after the host has enqueued the prefill."""
from portbench import readers


def read(ctx):
    return readers.mean(1e3 * (e - s) for _, s, e, _ in
                        readers.spans(ctx, "continuous.admit.read"))
