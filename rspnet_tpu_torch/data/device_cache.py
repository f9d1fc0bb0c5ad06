"""Device-resident dataset cache: train from the card's memory, not the
host link (port of rspnet_tpu/data/device_cache.py).

Materializes every sample ONCE through a wrapped ``VideoDataLoader`` (one
host decode pass, one host-to-device copy per clip position), then serves
every epoch from device memory: the host draws the epoch permutation and
each batch is a batch-axis ``index_select`` out of the cached tensors.

For datasets that fit on the card: probes, ablations, debugging,
benchmarks. The reference has no equivalent (its GPU collate re-ships
every batch every epoch, datasets/classification/__init__.py:22-50).

Semantics (those of the JAX cache):
- Validation caching is EXACT: the eval temporal (EvenNCrop) and spatial
  (center-max crop) transforms are deterministic, so cached batches are
  bit-identical to re-loaded ones.
- Train caching freezes each sample's TEMPORAL window at cache time (the
  epoch-0 draw). Spatial crop / flip / colour jitter / grayscale / blur
  stay per step: they run in the engine's device augment, which with
  ``device_geometry`` samples fresh crop boxes every step. The epoch order
  is drawn per epoch from numpy (``seed * 99991 + 7 * epoch + 1``), so the
  port's cache yields the JAX cache's rows in the JAX cache's order.
- The clips stay uint8, the loader's dtype, on an explicit device; labels
  and masks stay on the host.
- More than one process is refused (each would cache only its shard; a
  global re-permutation would need an exchange between ranks).

Config: ``cache_device: true`` (every split) or ``"train"`` (the train
split only), read by ``data/pipeline.py:build_loader``.
RSPNET_CACHE_LIMIT_MB (default 6144, as in the JAX package) bounds the
cached bytes; raise it deliberately (an H100 holds 80 GB).

``clip_to_device`` moves a batch's clip to the engine's device: a host
array is copied (the span ``rsp.loader.h2d``; the counters
``loader.h2d_calls`` and ``loader.h2d_bytes`` of ``framework/tracing.py``),
a tensor already there is returned as is, so a cached clip feeds
``crop_resize`` and K3 exactly as an uncached one does.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np
import torch

from ..framework import tracing

logger = logging.getLogger(__name__)


def clip_to_device(clip, device: torch.device) -> torch.Tensor:
    """A batch's uint8 clip as a tensor on ``device``: a numpy array is
    copied there; a tensor on that device (a cached batch) is not."""
    if torch.is_tensor(clip):
        if clip.device != torch.device(device):
            raise ValueError(f"clip on {clip.device}, engine on {device}")
        return clip
    tracing.add("loader.h2d_calls")
    tracing.add("loader.h2d_bytes", clip.nbytes)
    with tracing.span("rsp.loader.h2d"):
        return torch.from_numpy(clip).to(device)


class DeviceCachedLoader:
    """Wraps a VideoDataLoader; same iteration contract, batches served
    from device memory after a one-time materialization pass."""

    def __init__(self, inner, device: torch.device):
        if inner.cfg.process_count > 1:
            raise ValueError(
                "cache_device does not support multi-process loading: each "
                "process sees only its batch shard; run with one process "
                "or disable the cache")
        self._inner = inner
        self.cfg = inner.cfg
        self.epoch = 0
        self.device = torch.device(device)
        t0 = time.perf_counter()

        inner.set_epoch(0)
        limit_mb = float(os.environ.get("RSPNET_CACHE_LIMIT_MB", "6144"))
        clips: List[List[np.ndarray]] = [
            [] for _ in range(inner.cfg.num_clips)]
        labels, masks = [], []
        first = True
        # an error raised mid-iteration would leave the loader generator
        # suspended inside its worker pool: close the iterator first
        it = iter(inner)
        try:
            for batch in it:
                if first:
                    # preflight: estimate the whole cache from the first
                    # batch before paying the full decode pass (per-sample
                    # bytes are uniform: static shapes)
                    b0 = batch["labels"].shape[0]
                    per_sample = sum(np.asarray(a).nbytes
                                     for a in batch["clips"]) / max(b0, 1)
                    est_mb = per_sample * inner.num_samples / 1e6
                    if est_mb > limit_mb:
                        raise ValueError(
                            f"cache_device preflight: ~{est_mb:.0f} MB "
                            f"estimated ({inner.num_samples} samples x "
                            f"{per_sample / 1e6:.1f} MB) > limit "
                            f"{limit_mb:.0f} MB (RSPNET_CACHE_LIMIT_MB); "
                            f"refusing before the full decode pass")
                    first = False
                for c, arr in enumerate(batch["clips"]):
                    clips[c].append(np.asarray(arr))
                labels.append(np.asarray(batch["labels"]))
                masks.append(np.asarray(batch["mask"]))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        if not labels:
            raise ValueError("cache_device on an empty loader")
        self._labels = np.concatenate(labels)
        self._mask = np.concatenate(masks)

        host = [np.concatenate(c) for c in clips]
        total_mb = sum(a.nbytes for a in host) / 1e6
        if total_mb > limit_mb:
            raise ValueError(
                f"cache_device: dataset is {total_mb:.0f} MB > limit "
                f"{limit_mb:.0f} MB (RSPNET_CACHE_LIMIT_MB); this cache "
                f"must fit in device memory")
        logger.info("cache_device: caching %d samples (%.0f MB) on %s",
                    len(self._labels), total_mb, self.device)
        self._cache = [torch.from_numpy(a).to(self.device) for a in host]
        # settle the copies so that the build is not billed to step 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # seconds of the whole build: the decode pass and the copy
        self.build_s = time.perf_counter() - t0

    # -- loader contract ----------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def num_samples(self) -> int:
        return self._inner.num_samples

    @property
    def nbytes(self) -> int:
        """Bytes the cached clips hold on the device."""
        return sum(c.numel() * c.element_size() for c in self._cache)

    def num_valid_samples(self) -> int:
        return self._inner.num_valid_samples()

    def __len__(self) -> int:
        return len(self._labels) // self.cfg.batch_size

    def _epoch_order(self) -> np.ndarray:
        n = len(self._labels)
        if self.cfg.train:
            rng = np.random.default_rng(
                self.cfg.seed * 99991 + 7 * self.epoch + 1)
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self):
        order = self._epoch_order()
        B = self.cfg.batch_size
        for b in range(len(self)):
            idx = order[b * B:(b + 1) * B]
            dev_idx = torch.from_numpy(idx).to(self.device)
            yield {
                # whole samples along the batch axis: contiguous rows
                "clips": [c.index_select(0, dev_idx) for c in self._cache],
                "labels": self._labels[idx],
                "mask": self._mask[idx],
            }
