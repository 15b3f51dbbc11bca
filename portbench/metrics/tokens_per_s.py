"""tokens_per_s: output tokens read back inside the window, per second."""
from portbench import stats


def read(ctx):
    return stats.tokens_per_s(ctx.requests, ctx.t_open, ctx.t_close)
