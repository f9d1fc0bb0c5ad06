"""MoCo queue-size fixup (copy of rspnet_tpu/utils/moco.py).

The queue length K must be a multiple of the global batch so that every
enqueue is one whole slice of the ring buffer; with a K-sharded queue
(``moco/sharded_queue.py``) each enqueue must land inside one of the M
shards, so K/M must be a multiple of the global batch.
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def trim_moco_k(k: int, global_batch_size: int,
                model_parallel: int = 1) -> int:
    """Largest K' <= K with K' a multiple of global batch x model
    parallel."""
    quantum = global_batch_size * model_parallel
    return k - k % quantum


def replace_moco_k_in_config(cfg, global_batch_size: int,
                             model_parallel: int = 1) -> None:
    k = cfg.get_int("moco.k")
    new_k = trim_moco_k(k, global_batch_size, model_parallel)
    if new_k != k:
        logger.warning("moco.k trimmed %d -> %d (global batch %d, "
                       "model-parallel %d)", k, new_k, global_batch_size,
                       model_parallel)
    if new_k <= 0:
        raise ValueError(
            f"moco.k={k} smaller than global batch {global_batch_size} x "
            f"model-parallel {model_parallel}")
    cfg.put("moco.k", new_k)
