"""Reproducibility: seed the host RNGs per rank (port of
rspnet_tpu/framework/reproduction.py; reference:
framework/utils/reproduction.py:29-39, pretrain.py:267 seeds seed + rank
per worker).

Each rank seeds python, numpy and torch with ``seed + rank``, so ranks
draw different augment streams and permutations; an identical seed on
every rank would repeat the same draws at corresponding rows of the
global batch. The engines build their models and queues from ``seed``
alone (one set of weights on every rank) and draw the speed of exact
multi-speed from ``seed + 0x5BEE`` on every rank (one speed a step for
the whole mesh, rspnet_tpu/engines/pretrain.py:112-118).
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def initialize_seed(seed: int, rank: Optional[int] = None) -> int:
    """Seed python, numpy and torch with ``seed + rank`` (``rank``
    defaults to this process's); returns it."""
    if rank is None:
        from ..parallel import get_rank
        rank = get_rank()
    effective = seed + rank
    random.seed(effective)
    np.random.seed(effective % (2 ** 32))
    torch.manual_seed(effective)
    return effective
