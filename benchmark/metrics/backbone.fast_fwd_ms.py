"""backbone.fast_fwd_ms: the median over the window's steps of the summed
device ms of the step's `rsp.backbone.fast` spans: SlowFast's whole fast
pathway (its stem and four stages, all T frames at an eighth of the
channels), forward, one a pass, in the key pass and in the query pass."""
from benchmark import nested_spans


def read(ctx):
    return nested_spans.median_step_ms(ctx, "rsp.backbone.fast")
