"""mfu.backlog: model FLOPs of the tokens decoded in the window's chunks
(active parameters and attention over each token's cached positions, by
``portbench.roofline``) over the window's seconds times the bf16 peak, in
%."""
from portbench import readers, roofline


def read(ctx):
    flops = sum(readers.decode_flops(ctx.spec, c) for c in
                readers.chunks_in(ctx, ctx.t_open, ctx.t_close))
    return readers.share(flops / roofline.PEAK_BF16_FLOPS, ctx.seconds)
