"""engine.enqueue_ms: the median over the window's steps of the host time
the engine takes to enqueue one step: the program's span `rsp.engine.step`
(the interval `step_times` records) less its child `rsp.engine.sync`, the
wait for the card at the step's end."""
from benchmark import spans


def _enqueue(step, children):
    return step.host_ms - sum(c.host_ms for c in children
                              if c.name == "rsp.engine.sync")


def read(ctx):
    return spans.median_ms(ctx, _enqueue)
