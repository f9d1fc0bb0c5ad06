"""backbone.spatial_fwd_ms: the median over the window's steps of the
summed device ms of the step's `rsp.backbone.spatial` spans: the
(1, kh, kw) spatial halves of R(2+1)D's factored convolutions with their
BN and ReLU, forward, 12 a pass, in the key pass and in the query
pass."""
from benchmark import nested_spans


def read(ctx):
    return nested_spans.median_step_ms(ctx, "rsp.backbone.spatial")
