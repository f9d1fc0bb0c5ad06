"""Backbones of the port: S3D-G, S3D, C3D and the 3-D ResNets.

Every constructor takes the compute ``dtype`` (models/common.py); the
wrappers build the backbone without its classifier. Each backbone has
``features`` (NCDHW channels-last views) and ``feature_dim``.
"""
from functools import partial

from .c3d import C3D
from .resnet3d import DEPTHS, ResNet3D
from .s3dg import S3DG, s3d, s3dg

_REGISTRY = {"c3d": C3D, "s3dg": s3dg, "s3d": s3d,
             **{arch: partial(ResNet3D, block=block, layers=layers)
                for arch, (block, layers) in DEPTHS.items()}}


def get_model_class(arch: str):
    """arch -> constructor (rspnet_tpu/models/__init__.py:26-40 for the
    ported archs)."""
    if arch not in _REGISTRY:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (see ROADMAP.md); ported: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch]


__all__ = ["C3D", "ResNet3D", "S3DG", "get_model_class"]
