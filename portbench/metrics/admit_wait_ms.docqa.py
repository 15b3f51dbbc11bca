"""admit_wait_ms.docqa: mean over the requests due in the window of the
time from due to the start of its admission (not admitted: to the close),
on the loop's own clock."""
from portbench import readers, stats


def read(ctx):
    due = stats.due_in(ctx.requests, ctx.t_open, ctx.t_close)
    return readers.mean(
        1e3 * ((r.admit_start if r.admit_start <= ctx.t_close
                else ctx.t_close) - r.due) for r in due)
