"""The engines' clip geometry (rspnet_tpu_torch/engines/geometry.py), in
host and device geometry, train and eval: its boxes, identity flag and
draws against direct ``sample_train_params`` / ``center_crop_params``
calls. Host geometry draws no crop box."""
import types

import numpy as np
import pytest

from rspnet_tpu_torch.engines.geometry import clip_geometry
from rspnet_tpu_torch.ops.augment import (center_crop_params,
                                          sample_train_params)

B, SIZE = 5, 16
# the pretrain engine's aug_plus draws
AUG = dict(h_flip=0.5, gray_p=0.2, jitter=(0.4, 0.4, 0.4, 0.1),
           jitter_p=0.8, blur_p=0.5)
# (device_geometry, served [H, W], identity)
GEOMETRIES = {"host": (False, (SIZE, SIZE), True),
              "host_wide": (False, (SIZE, SIZE + 8), False),
              "device": (True, (40, 56), False)}


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_clip_geometry_against_direct_draws(geometry, split):
    on_device, (H, W), identity = GEOMETRIES[geometry]
    cfg = types.SimpleNamespace(device_geometry=on_device,
                                crop_area=(0.4, 1.0))
    geom = clip_geometry(cfg, (B, H, W), SIZE)
    assert geom.on_device == on_device and geom.identity == identity
    whole = np.array([[0, 0, H, W]] * B, np.float32)
    rng, direct = np.random.default_rng(3), np.random.default_rng(3)
    if split == "train":
        got = geom.train_params(rng, **AUG)
        want = sample_train_params(
            direct, B, [(H, W)],
            crop_area=cfg.crop_area if on_device else (1.0, 1.0), **AUG)
        for field in ("boxes", "flip", "jitter", "order", "gray", "blur"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), field)
        if not on_device:
            np.testing.assert_array_equal(got.boxes, whole)
    else:
        boxes = geom.eval_boxes()
        want = (center_crop_params(B, [(H, W)]).boxes if on_device
                else whole)
        assert boxes.dtype == np.float32
        np.testing.assert_array_equal(boxes, want)
    assert rng.bit_generator.state == direct.bit_generator.state
