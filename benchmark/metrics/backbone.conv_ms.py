"""backbone.conv_ms: device milliseconds a step in convolution kernels,
forward and backward (cuDNN's implicit-GEMM fprop / dgrad / wgrad kernels
and its direct convolutions), summed from the trace by kernel name."""

PATTERN = (r"(?i)(conv|fprop|dgrad|wgrad|implicit_gemm|"
           r"implicit_convolve)")


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    t = ctx.yardstick.device_seconds(ctx.trace, PATTERN)
    return 1e3 * t / ctx.steps if t > 0 else None
