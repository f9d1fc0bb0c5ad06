"""Process environment helpers (port of rspnet_tpu/framework/environment.py)
and the engines' run-time policy: device, compute dtype, matmul precision."""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def ulimit_n_max() -> None:
    """Raise RLIMIT_NOFILE to the hard max (video datasets open many files)."""
    try:
        import resource
        _soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def scale_learning_rate(lr: float, world_size: int, batch_size: int,
                        base_batch_size: int = 64) -> float:
    """Linear LR scaling with global batch
    (reference: framework/utils/environment.py:13-16)."""
    return lr * world_size * batch_size / base_batch_size


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; ``cuda`` without a card raises (never a quiet
    fall back to the CPU)."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")


def resolve_runtime(name: str) -> Tuple[torch.device, Optional[torch.dtype]]:
    """The engines' device (``resolve_device``) and compute dtype, chosen
    from the device as the JAX engines choose it from their platform
    (rspnet_tpu/engines/pretrain.py:69-71): bf16 on ``cuda``, None (f32)
    on the CPU. TF32 is off for the f32 matmuls and convolutions, and bf16
    GEMMs reduce in f32 (torch's default allows reduced-precision
    reductions), as in the JAX package; the three flags are process-wide,
    set here and logged."""
    device = resolve_device(name)
    dtype = torch.bfloat16 if device.type == "cuda" else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    logger.info(
        "Device %s; compute dtype %s; allow_tf32: matmul=%s cudnn=%s; "
        "bf16 reduced-precision reduction: %s", device,
        dtype or torch.float32, torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    return device, dtype
