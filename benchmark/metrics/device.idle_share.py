"""device.idle_share: the share (%) of the traced window in which no
kernel, copy or memset ran on the card (the union of the trace's device
intervals)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
