"""The blocks every plain float32 reference backbone is built of, the MoCo
heads, and the lookup of a backbone by its arch name.

A backbone is one file, ``backbones/<arch>.py``, named after the string a
configuration's ``model.arch`` holds (``s3dg.py``, ``resnet18.py``).
``build(arch, dim)`` loads that file by path, once a process, and wraps
what its ``build()`` returns in the ``Encoder``: a global average pool,
one linear layer and an L2 normalization for each of the two pretext
heads of RSPNet. A backbone file

- defines ``build() -> nn.Module``; the module has ``features(x)``, which
  maps NCDHW clips to NCDHW features, and ``feature_dim``, their channels;
- names its modules and parameters as the port's model does
  (``encoder.feature.sepConv1.sep_conv.0.conv3d.weight``,
  ``encoder.layer1.0.conv1.weight``; the heads add ``fc1.linear.weight``),
  so that one state dict loads into this model and into the program's;
- computes in float32 with the blocks below (``Conv``, ``Linear``,
  ``BN``, ``MaxPool``, imported by absolute path) and gives any other
  module that rounds an activation a ``quant`` of its own, so that the
  control's ``quant`` reaches every rounding site;
- uses only ``torch.nn.functional`` operations (cuDNN's convolutions,
  ``F.batch_norm``, ``F.max_pool3d``) and imports nothing of the program
  under test.

Inputs are NDHWC clips [B, T, H, W, 3]; the backbones run in NCDHW.

``quant`` rounds a tensor where a lower-precision computation would hold
it: the input and the weight of every convolution and linear layer, and
every activation that a reduced-precision network keeps (each batch
norm's output, the self-gating's mean, gate and product, a residual sum,
the pooled features, the heads' outputs). The benchmark's control
computes in float8 through it; ``None`` computes in float32.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

BACKBONE_DIR = Path(__file__).resolve().parent / "backbones"

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """A bias-free (or biased) 3-D convolution whose weight is a leaf of
    its own (the reference names put it at ``<name>.weight``)."""

    def __init__(self, cin, cout, k, stride=1, pad=0, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *_t3(k)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.pad = _t3(stride), _t3(pad)
        self.quant: Quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv3d(x, w, self.bias, self.stride, self.pad)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.quant: Quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, self.bias)


class BN(nn.Module):
    """Batch normalization over (N, T, H, W) with the biased variance of
    the batch, as every training-mode batch norm does. The running
    statistics are kept as buffers (for the state dict) but not updated:
    no compared number depends on them."""

    def __init__(self, c, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

        self.quant: Quant = None

    def forward(self, x):
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y if self.quant is None else self.quant(y)


class MaxPool(nn.Module):
    def __init__(self, k, s, p):
        super().__init__()
        self.k, self.s, self.p = _t3(k), _t3(s), _t3(p)

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p)


# --------------------------------------------------------------------------
# the MoCo encoder: backbone and the two heads
# --------------------------------------------------------------------------

class Head(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear = Linear(cin, dim)
        self.quant: Quant = None

    def forward(self, feat):
        q = self.quant or (lambda t: t)
        return q(F.normalize(q(self.linear(q(feat.mean(dim=(2, 3, 4))))),
                             dim=1))


class Encoder(nn.Module):
    """-> (A-VID embedding, RSP embedding), each [B, dim], unit rows."""

    def __init__(self, backbone: nn.Module, dim: int):
        super().__init__()
        self.encoder = backbone
        self.fc1 = Head(backbone.feature_dim, dim)
        self.fc2 = Head(backbone.feature_dim, dim)

    def forward(self, clips_ndhwc):
        feat = self.encoder.features(clips_ndhwc.permute(0, 4, 1, 2, 3))
        return self.fc1(feat), self.fc2(feat)

    def set_quant(self, quant: Quant) -> None:
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant


def available() -> List[str]:
    """The arch names of the backbone files, sorted."""
    return sorted(p.stem for p in BACKBONE_DIR.glob("*.py"))


@functools.cache
def _load(path: Path) -> ModuleType:
    # by path: arch names hold "-", which no import statement takes
    spec = importlib.util.spec_from_file_location(
        "benchmark_backbone_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(arch: str, dim: int) -> Encoder:
    if arch not in available():
        raise ValueError(f"the reference has no backbone {arch!r}; "
                         f"available: {available()}")
    return Encoder(_load(BACKBONE_DIR / f"{arch}.py").build(), dim)
