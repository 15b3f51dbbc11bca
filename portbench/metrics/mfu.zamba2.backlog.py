"""mfu.zamba2.backlog: model FLOPs of the tokens decoded in the window's
chunks (every weight a token multiplies through and attention over its
cached positions, by ``portbench.roofline_zamba2``) over the window's
seconds times the bf16 peak, in %; None outside a ``zamba2``
configuration."""
from portbench import readers, roofline_zamba2 as rz


def read(ctx):
    if ctx.spec.get("family") != "zamba2":
        return None
    flops = sum(rz.decode_token_flops(ctx.spec, pos + i + 1)
                for c in readers.chunks_in(ctx, ctx.t_open, ctx.t_close)
                for pos, n in c.rows for i in range(n))
    return readers.share(flops / rz.PEAK_BF16_FLOPS, ctx.seconds)
