"""step.bwd_ms: the median over the window's steps of the device time of
the MoCo step's `rsp.step.backward` phase (the query encoder's
backward)."""
from benchmark import spans


def read(ctx):
    return spans.phases_device_ms(ctx, ["rsp.step.backward"])
