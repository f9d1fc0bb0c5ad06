"""Process environment helpers (port of rspnet_tpu/framework/environment.py)."""
from __future__ import annotations


def ulimit_n_max() -> None:
    """Raise RLIMIT_NOFILE to the hard max (video datasets open many files)."""
    try:
        import resource
        _soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def scale_learning_rate(lr: float, world_size: int, batch_size: int,
                        base_batch_size: int = 64) -> float:
    """Linear LR scaling with global batch
    (reference: framework/utils/environment.py:13-16)."""
    return lr * world_size * batch_size / base_batch_size
