"""MoCo queue-size fixup (copy of rspnet_tpu/utils/moco.py).

The queue length K must be a multiple of the global batch so that every
enqueue is one whole slice of the ring buffer.
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def trim_moco_k(k: int, global_batch_size: int) -> int:
    """Largest K' <= K with K' a multiple of the global batch."""
    return k - k % global_batch_size


def replace_moco_k_in_config(cfg, global_batch_size: int) -> None:
    k = cfg.get_int("moco.k")
    new_k = trim_moco_k(k, global_batch_size)
    if new_k != k:
        logger.warning("moco.k trimmed %d -> %d (global batch %d)", k, new_k,
                       global_batch_size)
    if new_k <= 0:
        raise ValueError(
            f"moco.k={k} smaller than global batch {global_batch_size}")
    cfg.put("moco.k", new_k)
