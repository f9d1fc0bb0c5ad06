"""backbone.temporal_fwd_ms: the median over the window's steps of the
summed device ms of the step's `rsp.backbone.temporal` spans: the bare
(kt, 1, 1) temporal halves of R(2+1)D's factored convolutions, forward,
12 a pass, in the key pass and in the query pass."""
from benchmark import nested_spans


def read(ctx):
    return nested_spans.median_step_ms(ctx, "rsp.backbone.temporal")
