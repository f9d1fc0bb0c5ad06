"""Where the spatial crop of a served batch happens, for the engines'
device augment and preprocess.

A loader with ``device_geometry`` ships decode-resolution clips, and the
engine draws the crop box (``crop_area``) or takes the centre max box; any
other loader crops and resizes on the host, so the engine takes the whole
frame and draws no crop (rspnet_tpu/engines/pretrain.py:188-214).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..ops.augment import (AugmentParams, center_crop_params,
                           sample_train_params)


class ClipGeometry(NamedTuple):
    """A served batch's geometry (``clip_geometry``)."""
    on_device: bool
    # the train crop's area range; (1.0, 1.0), the whole frame, on the host
    crop_area: Tuple[float, float]
    # the host cropped and resized to the network's size: K3 takes the
    # uint8 clip as it is (``augment_batch``'s ``identity_geometry``)
    identity: bool
    shape: Tuple[int, int, int]         # [B, H, W] of the served clips

    def train_params(self, rng: np.random.Generator, **aug) -> AugmentParams:
        """``sample_train_params`` for the batch: a crop box drawn from
        ``crop_area`` on the device, the whole frame on the host (no
        draw); ``aug`` its colour and flip keywords."""
        B, H, W = self.shape
        return sample_train_params(rng, B, [(H, W)],
                                   crop_area=self.crop_area, **aug)

    def eval_boxes(self) -> np.ndarray:
        """[B, 4] evaluation boxes: the centre max box on the device, the
        whole frame on the host."""
        B, H, W = self.shape
        if self.on_device:
            return center_crop_params(B, [(H, W)]).boxes
        return np.array([[0, 0, H, W]] * B, np.float32)


def clip_geometry(loader_cfg, shape, size: int) -> ClipGeometry:
    """The geometry of clips of ``shape`` [B, H, W] served by a loader of
    ``loader_cfg`` (a ``PipelineConfig``) to a network of ``size``²."""
    _, H, W = shape
    if getattr(loader_cfg, "device_geometry", False):
        return ClipGeometry(True, loader_cfg.crop_area, False, tuple(shape))
    return ClipGeometry(False, (1.0, 1.0), (H, W) == (size, size),
                        tuple(shape))
