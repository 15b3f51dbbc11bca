"""ttft_p90_ms.docqa: p90 over the requests due in the window of the
time from due to the host read of the first token (unadmitted: the age
at the close)."""
from portbench import stats


def read(ctx):
    return stats.poisson_metrics(ctx.requests, ctx.t_open,
                                 ctx.t_close)["ttft_p90_ms"]
