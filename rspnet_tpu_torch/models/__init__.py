"""Backbones of the port (S3D-G so far)."""
from .s3dg import S3DG, get_model_class

__all__ = ["S3DG", "get_model_class"]
