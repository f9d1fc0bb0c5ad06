"""C3D-BN backbone in torch (port of rspnet_tpu/models/c3d.py).

Eight 3^3 convolutions with a bias, each followed by BN (eps 1e-5, torch
momentum 0.1) and a ReLU; max pools (through K1/K2) after ``conv1``
(spatial only, (1,2,2) stride (1,2,2)) and after ``conv2``, ``conv3b`` and
``conv4b`` ((2,2,2) stride (2,2,2)), all unpadded; a 512-d global average
pool and an optional ``linear`` head. Module names are the reference
torch model's (rspnet_tpu/models/torch_bridge.py:_c3d_mapping): ``conv1``,
``bn1``, ..., ``conv5b``, ``bn5b``, ``linear``. ``dtype`` is the compute
dtype (models/common.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import (BatchNorm, conv_bn, dense, global_avg_pool, make_conv,
                     max_pool3d)

_STAGES = ["conv1", "conv2", "conv3a", "conv3b", "conv4a", "conv4b",
           "conv5a", "conv5b"]
_WIDTH = {"conv1": 64, "conv2": 128, "conv3a": 256, "conv3b": 256,
          "conv4a": 512, "conv4b": 512, "conv5a": 512, "conv5b": 512}
# the pool after each of these convs; pool1 is spatial only
_POOL_AFTER = {"conv1": (1, 2, 2), "conv2": (2, 2, 2), "conv3b": (2, 2, 2),
               "conv4b": (2, 2, 2)}


class C3D(nn.Module):
    feature_dim = 512

    def __init__(self, num_classes: int = 101, with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for name in _STAGES:
            setattr(self, name, make_conv(cin, _WIDTH[name], 3, 1, 1,
                                          use_bias=True))
            setattr(self, "bn" + name[4:], BatchNorm(_WIDTH[name],
                                                     dtype=dtype))
            cin = _WIDTH[name]
        self.linear = (nn.Linear(self.feature_dim, num_classes)
                       if with_classifier else None)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> feature map [B, 512, t, h, w]."""
        for name in _STAGES:
            x = conv_bn(getattr(self, name), getattr(self, "bn" + name[4:]),
                        x, self.dtype)
            if name in _POOL_AFTER:
                k = _POOL_AFTER[name]
                x = max_pool3d(x, k, k)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NDHWC clip [B, T, H, W, 3] -> pooled features [B, 512], or the
        logits with the ``linear`` head."""
        out = global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))
        if self.linear is not None:
            out = dense(out, self.linear, self.dtype)
        return out
