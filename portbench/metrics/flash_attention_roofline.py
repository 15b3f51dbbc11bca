"""flash_attention_roofline: the flash attention kernel's share of its
roofline over the traced slice's admissions, in %: causal FLOPs and the
bytes of q, k, v and the output of each admitted prompt in every layer,
over the profiler's time of the kernel (``flash``) inside them."""
from portbench import readers, roofline


def read(ctx):
    sl = ctx.profile
    if sl is None:
        return None
    bound = took = 0.0
    for _, s, e, S in readers.admissions_in(ctx, sl.start, sl.end):
        bound += roofline.bound_s(*roofline.flash_cost(ctx.spec, S))
        took += sl.kernel_time("flash", s, e)
    return readers.share(bound, took)
