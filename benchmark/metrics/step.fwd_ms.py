"""step.fwd_ms: the median over the window's steps of the device time of
the MoCo step's forward phases: `rsp.step.gather` (the dual-speed
gather), `rsp.step.key_pass` (the fused 2B key pass) and
`rsp.step.q_forward` (the query pass and the objective)."""
from benchmark import spans


def read(ctx):
    return spans.phases_device_ms(
        ctx, ["rsp.step.gather", "rsp.step.key_pass", "rsp.step.q_forward"])
