"""k3_roofline: K3, the colour augment (`augment_resident`; the generic
`luma_partials` + `apply_chain`): the bytes the window's calls must move
(yardstick.py) at the HBM bandwidth, over the kernels' device time in the
trace (%). The kernels are found by their names in the CUDA sources."""

PATTERN = r"\b(augment_resident|luma_partials|apply_chain)\b"


def read(ctx):
    return ctx.yardstick.roofline(ctx, PATTERN, ctx.work.k3_bytes)
