"""Backbones of the port: S3D-G, S3D, C3D, the 3-D ResNets, R(2+1)D and
TSM.

Every constructor takes the compute ``dtype`` (models/common.py); the
wrappers build the backbone without its classifier, ``model_type:
1stream`` with it. Each backbone has ``features`` (NCDHW channels-last
views) and ``feature_dim``.
"""
import inspect
from functools import partial

from . import tsm as _tsm
from .c3d import C3D
from .r2plus1d import R2Plus1DNet, r2plus1d_18, r2plus1d_vcop
from .resnet3d import DEPTHS, ResNet3D
from .s3dg import S3DG, s3d, s3dg
from .tsm import TSM

_REGISTRY = {"c3d": C3D, "s3dg": s3dg, "s3d": s3d,
             "r2plus1d-vcop": r2plus1d_vcop, "r2plus1d-18": r2plus1d_18,
             **{arch: partial(ResNet3D, block=block, layers=layers)
                for arch, (block, layers) in DEPTHS.items()}}


def get_model_class(arch: str, **model_cfg):
    """arch and the config's other ``model.*`` keys -> constructor
    (rspnet_tpu/models/__init__.py:46-76 for the ported archs): ``tsm``
    reads ``base_model``, ``num_segments``, ``non_local`` and
    ``shift_groups``; the others read none.

    Deviation: a key that the arch does not read raises
    NotImplementedError, where the JAX package drops it silently (which
    once built a resnet50-based TSM for the tsm-r18 config)."""
    if arch == "tsm":
        unread = set(model_cfg) - set(
            inspect.signature(_tsm.get_model_class).parameters)
        if not unread:
            return _tsm.get_model_class(**model_cfg)
    elif arch in _REGISTRY:
        unread = set(model_cfg)
        if not unread:
            return _REGISTRY[arch]
    else:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (see ROADMAP.md); ported: "
            f"{sorted(_REGISTRY) + ['tsm']}")
    raise NotImplementedError(
        f"model keys {sorted(unread)} of arch {arch!r} are not ported "
        f"(see ROADMAP.md)")


__all__ = ["C3D", "R2Plus1DNet", "ResNet3D", "S3DG", "TSM",
           "get_model_class"]
