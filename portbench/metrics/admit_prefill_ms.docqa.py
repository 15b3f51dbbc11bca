"""admit_prefill_ms.docqa: mean duration of the port's
``continuous.admit`` spans in the window (one prefill each)."""
from portbench import readers


def read(ctx):
    return readers.mean(1e3 * (e - s) for _, s, e, _ in
                        readers.spans(ctx, "continuous.admit"))
