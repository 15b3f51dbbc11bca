"""fused_ffn_roofline.backlog: the fused FFN kernels' share of their
roofline over the traced slice's decode chunks, in %: the least time for
the weights of the experts each chunk's steps hit (``experts_hit`` of the
``continuous.chunk.stats`` after it, summed over steps and layers), the
shared experts' weights in every step and layer, and each routed pair's
and row's activations (``pairs``: every row the step routes, live or
not, which is the work needed where every row is live, as in this cell),
over the profiler's time of ``csrc/fused_ffn.cu``'s kernels inside those
chunks."""
from portbench import phases, readers, roofline


def read(ctx):
    sl = ctx.profile
    if sl is None:
        return None
    L, k = ctx.spec["num_hidden_layers"], ctx.spec["num_experts_per_tok"]
    bound = took = 0.0
    for span in phases.within(ctx, "continuous.decode_chunk", sl.start,
                              sl.end):
        a = phases.after(ctx, "continuous.chunk.stats", span)
        if a is None or "experts_hit" not in a:
            continue
        bound += roofline.bound_s(*phases.ffn_cost(
            ctx.spec, a["experts_hit"], a["pairs"], a["pairs"] // k,
            L * span[3]["chunk"]))
        took += phases.ffn_time(sl, span[1], span[2])
    return readers.share(bound, took)
