"""chunk_host_ms.backlog: the engine's host work around a decode chunk, in ms
a chunk: the summed ``continuous.chunk.prepare`` and
``continuous.chunk.retire`` spans in the window over the number of
``continuous.decode_chunk`` spans in it (the device holds no decode work
while they run)."""
from portbench import readers


def read(ctx):
    chunks = readers.spans(ctx, "continuous.decode_chunk")
    host = [e - s for name in ("continuous.chunk.prepare",
                               "continuous.chunk.retire")
            for _, s, e, _ in readers.spans(ctx, name)]
    if not chunks or not host:
        return None
    return 1e3 * sum(host) / len(chunks)
