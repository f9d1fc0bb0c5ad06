"""k2_roofline: K2, the max-pool backward, route and gather passes
together (`route_tile` + `gather_tile`; the generic `pool_route` +
`pool_gather`): the bytes the window's calls must move
(yardstick.py) at the HBM bandwidth, over the kernels' device time in the
trace (%). The kernels are found by their names in the CUDA sources."""

PATTERN = r"\b(route_tile|gather_tile|pool_route|pool_gather)\b"


def read(ctx):
    return ctx.yardstick.roofline(ctx, PATTERN, ctx.work.k2_bytes)
