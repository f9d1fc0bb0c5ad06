"""step.update_ms: the median over the window's steps of the device time of
the MoCo step's updates: `rsp.step.ema` (the key encoder's moving
average), `rsp.step.optimizer` (gradient combine and SGD) and
`rsp.step.enqueue` (the negative keys into the queue)."""
from benchmark import spans


def read(ctx):
    return spans.phases_device_ms(
        ctx, ["rsp.step.ema", "rsp.step.optimizer", "rsp.step.enqueue"])
