"""slots_active_mean.backlog: mean ``occupancy`` of the port's
``continuous.decode_chunk`` spans in the window (live rows)."""
from portbench import readers


def read(ctx):
    return readers.mean(a["occupancy"] for _, _, _, a in
                        readers.spans(ctx, "continuous.decode_chunk"))
