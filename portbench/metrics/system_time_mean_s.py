"""system_time_mean_s: the paper's E[T], the mean over the requests due in
the window of the time from due to the last token (unfinished: the age at
the close)."""
from portbench import stats


def read(ctx):
    return stats.poisson_metrics(ctx.requests, ctx.t_open,
                                 ctx.t_close)["system_time_mean_s"]
