"""decode_step_ms.backlog: the port's ``continuous.decode_chunk`` span over
its ``chunk`` steps, averaged over the window's chunks."""
from portbench import readers


def read(ctx):
    return readers.mean(1e3 * (e - s) / a["chunk"] for _, s, e, a in
                        readers.spans(ctx, "continuous.decode_chunk"))
