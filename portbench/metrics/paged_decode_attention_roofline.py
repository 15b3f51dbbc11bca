"""paged_decode_attention_roofline: the paged decode attention kernel's
share of its roofline over the traced slice's decode chunks, in %: the
least time for each step's live rows (their cached K/V read once, q and
the output once; rows that took no step count nothing) over the
profiler's time of the kernel (``paged_decode``) inside those chunks."""
from portbench import readers, roofline


def read(ctx):
    sl = ctx.profile
    if sl is None:
        return None
    bound = took = 0.0
    for c in readers.chunks_in(ctx, sl.start, sl.end):
        steps = max((n for _, n in c.rows), default=0)
        for i in range(steps):
            bound += roofline.bound_s(*roofline.decode_attention_cost(
                ctx.spec, readers.step_ctxs(c.rows, i)))
        took += sl.kernel_time("paged_decode", c.start, c.end)
    return readers.share(bound, took)
