"""engine.step_ms_p90: the 90th percentile of the engine's own step times
over the window (``PretrainEngine.step_times``: host clock around the
augment and ``train_step``, ended by a device sync; the wait for data is
not in it)."""
import numpy as np


def read(ctx):
    if not ctx.step_ms:
        return None
    return float(np.percentile(np.asarray(ctx.step_ms, np.float64), 90))
