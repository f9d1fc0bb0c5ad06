"""k1_roofline: K1, the max-pool forward (`max_tile`; the generic
`pool_fwd`): the bytes the window's calls must move
(yardstick.py) at the HBM bandwidth, over the kernels' device time in the
trace (%). The kernels are found by their names in the CUDA sources."""

PATTERN = r"\b(max_tile|pool_fwd)\b"


def read(ctx):
    return ctx.yardstick.roofline(ctx, PATTERN, ctx.work.k1_bytes)
