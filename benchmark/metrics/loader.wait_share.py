"""loader.wait_share: the share (%) of the window that the engine's loop
spent outside its steps, mostly waiting for the next batch: 1 - (sum of
the window's step times) / (window wall time)."""


def read(ctx):
    if not ctx.step_ms:
        return None
    return 100.0 * (1.0 - sum(ctx.step_ms) / (ctx.window_s * 1e3))
