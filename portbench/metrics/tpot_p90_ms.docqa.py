"""tpot_p90_ms.docqa: p90 over the requests due in the window with two
tokens read of (last read - first read) / (tokens - 1)."""
from portbench import stats


def read(ctx):
    return stats.poisson_metrics(ctx.requests, ctx.t_open,
                                 ctx.t_close)["tpot_p90_ms"]
