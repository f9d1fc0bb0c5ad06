"""dataset.mean / dataset.std config reads (copy of
rspnet_tpu/engines/normalization.py).

Reference semantics (datasets/classification/__init__.py):
- :152-162 `_get_normalize` — VID pipeline (pretrain/visualization):
  reads `dataset.mean`/`dataset.std` from config; `--debug` swaps in an
  identity normalize.
- :222-227 `get_transform` — classification pipeline (finetune/retrieval):
  always config-driven, debug does NOT disable it.

Every shipped config inherits `imagenet_stats`
(config/lib/datasets.libsonnet:4-7), so the defaults only apply when
`-x '{dataset: {...}}'` *replaces* the dataset block.
"""
from __future__ import annotations

from typing import Tuple

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# identity normalize: x -> (x - 0) / 1
DEBUG_DISABLED = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

Stats = Tuple[Tuple[float, float, float], Tuple[float, float, float]]


def dataset_normalization(cfg, *, vid_debug: bool = False) -> Stats:
    """(mean, std) for the device augment, from `dataset.mean`/`dataset.std`.

    `vid_debug=True` replicates the VID pipeline's `--debug` identity
    normalize (reference :153-156); pass it only from the vid workloads
    (pretrain, visualization) — finetune/retrieval normalize regardless.
    """
    if vid_debug:
        return DEBUG_DISABLED
    mean = tuple(float(v) for v in cfg.get_list("dataset.mean",
                                                list(IMAGENET_MEAN)))
    std = tuple(float(v) for v in cfg.get_list("dataset.std",
                                               list(IMAGENET_STD)))
    if len(mean) != 3 or len(std) != 3:
        raise ValueError(f"dataset.mean/std must be 3-channel, got "
                         f"{mean}/{std}")
    return mean, std
