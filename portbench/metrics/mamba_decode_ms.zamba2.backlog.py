"""mamba_decode_ms.zamba2.backlog: mean ``mamba_ms`` of the port's
``continuous.chunk.stats`` spans in the window: the Mamba2 layers' time
in a decode step on the device's clock (the timing events the captured
step records between the Mamba2 layers and the shared applications)."""
from portbench import readers


def read(ctx):
    return readers.mean(a["mamba_ms"] for _, _, _, a in
                        readers.spans(ctx, "continuous.chunk.stats")
                        if "mamba_ms" in a)
