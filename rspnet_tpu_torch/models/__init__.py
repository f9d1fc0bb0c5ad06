"""Backbones of the port: S3D-G, S3D, C3D, the 3-D ResNets, R(2+1)D, TSM,
MFNet-3D, torchvision's r3d_18 and the SlowFast family (SlowFast, Slow,
C2D, I3D): every arch of the JAX package's ``available_archs()``.

Every constructor takes the compute ``dtype`` (models/common.py); the
wrappers build the backbone without its classifier, ``model_type:
1stream`` with it. Each backbone has ``features`` (NCDHW channels-last
views) and ``feature_dim``.
"""
import inspect
from functools import partial

from . import slowfast as _slowfast
from . import tsm as _tsm
from .c3d import C3D
from .mfnet import MFNet3D
from .r2plus1d import R2Plus1DNet, r2plus1d_18, r2plus1d_vcop
from .resnet3d import DEPTHS, ResNet3D
from .s3dg import S3DG, s3d, s3dg
from .slowfast import SPECS as SLOWFAST_SPECS
from .slowfast import SlowFast
from .tsm import TSM
from .video_resnet import VideoResNet, r3d_18

_REGISTRY = {"c3d": C3D, "s3dg": s3dg, "s3d": s3d,
             "r2plus1d-vcop": r2plus1d_vcop, "r2plus1d-18": r2plus1d_18,
             "mfnet": MFNet3D,
             **{arch: partial(ResNet3D, block=block, layers=layers)
                for arch, (block, layers) in DEPTHS.items()}}
# archs whose constructor reads ``model.*`` keys: arch -> the factory that
# takes them (its parameters are the keys it reads) and gives the
# constructor
_KEYED = {
    "tsm": _tsm.get_model_class,
    "slowfast": partial(_slowfast.get_model_class, "slowfast"),
    "torchvision-resnet18": lambda pretrain=False: partial(
        r3d_18, pretrain=pretrain),
}


def available_archs():
    """Every arch ``get_model_class`` builds, as the JAX package's
    ``available_archs`` lists them (the SlowFast spec names build too)."""
    return sorted(set(_REGISTRY) | set(_KEYED))


def get_model_class(arch: str, **model_cfg):
    """arch and the config's other ``model.*`` keys -> constructor
    (rspnet_tpu/models/__init__.py:46-76): ``tsm`` reads ``base_model``,
    ``num_segments``, ``non_local`` and ``shift_groups``; ``slowfast``
    ``cfg_file`` (a YAML path; a mapping, as the ``slowfast`` preset of
    config/lib/models.libsonnet writes it, falls back to ``variant``, whose
    default is ``SLOWFAST_4x16_R50``, as in the JAX package) and
    ``variant``; ``torchvision-resnet18`` ``pretrain``; the others,
    ``SLOWFAST*`` / ``SLOW_*`` / ``C2D*`` / ``I3D*`` spec names included,
    read none. An unknown arch raises ``ValueError``, as there.

    Deviation: a key that the arch does not read raises
    NotImplementedError, where the JAX package drops it silently (which
    once built a resnet50-based TSM for the tsm-r18 config)."""
    if arch in _KEYED:
        factory = _KEYED[arch]
        unread = set(model_cfg) - set(inspect.signature(factory).parameters)
        if not unread:
            return factory(**model_cfg)
    elif arch in _REGISTRY or arch in SLOWFAST_SPECS:
        unread = set(model_cfg)
        if not unread:
            return (_REGISTRY[arch] if arch in _REGISTRY
                    else _slowfast.get_model_class(arch))
    else:
        raise ValueError(f"Unknown arch {arch!r}; available: "
                         f"{available_archs()}")
    raise NotImplementedError(
        f"model keys {sorted(unread)} of arch {arch!r} are not ported "
        f"(see ROADMAP.md)")


__all__ = ["C3D", "MFNet3D", "R2Plus1DNet", "ResNet3D", "S3DG", "SlowFast",
           "TSM", "VideoResNet", "available_archs", "get_model_class"]
