"""backbone.nonlocal_fwd_ms: the median over the window's steps of the
summed device ms of the step's `rsp.backbone.nonlocal` spans: SlowFast's
non-local blocks (the theta, phi, g and output convolutions, the pool,
the two attention products and the BN), forward, 5 a pass, in the key
pass and in the query pass."""
from benchmark import nested_spans


def read(ctx):
    return nested_spans.median_step_ms(ctx, "rsp.backbone.nonlocal")
