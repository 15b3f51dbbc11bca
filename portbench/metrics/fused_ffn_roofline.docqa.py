"""fused_ffn_roofline.docqa: the fused FFN kernels' share of their
roofline over the traced slice's admissions, in %: the least time for the
``kept`` routed pairs (capacity dispatch drops the rest), the prompt's
rows through the shared experts, the weights of the experts hit in each
layer (``experts_hit`` of the ``continuous.admit.stats`` after the
admission) and the shared experts' in every layer, over the profiler's
time of ``csrc/fused_ffn.cu``'s kernels inside the ``continuous.admit``
spans. The slice holds few whole admissions (about one at this cell's
rate), so the share follows those prompts' lengths."""
from portbench import phases, readers, roofline


def read(ctx):
    sl = ctx.profile
    if sl is None:
        return None
    L = ctx.spec["num_hidden_layers"]
    bound = took = 0.0
    for span in phases.within(ctx, "continuous.admit", sl.start, sl.end):
        a = phases.after(ctx, "continuous.admit.stats", span)
        if a is None or "kept" not in a:
            continue
        rows = span[3]["rows"] * span[3]["S"] * L
        bound += roofline.bound_s(*phases.ffn_cost(
            ctx.spec, a["experts_hit"], a["kept"], rows, L))
        took += phases.ffn_time(sl, span[1], span[2])
    return readers.share(bound, took)
