"""device_idle_share.docqa: 1 - (union of device activity) / wall time
of the traced slice, in %."""


def read(ctx):
    sl = ctx.profile
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
