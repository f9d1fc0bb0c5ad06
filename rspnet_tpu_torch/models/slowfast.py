"""SlowFast networks in torch (port of rspnet_tpu/models/slowfast.py):
every spec of its ``SPECS`` table (SlowFast R50 / R101 in the
``_50_50`` / ``_50_101`` / ``_101_101`` variants, with and without
non-local blocks, and the single-pathway Slow, C2D and I3D), the
pyslowfast YAMLs (``spec_from_yaml``, through ``config/yaml_subset.py``:
no PyYAML), non-local blocks and ``SubBatchNorm``.

One clip [B, T, H, W, 3] goes in. The fast pathway sees all T frames, the
slow one the frames ``np.linspace(0, T - 1, T // alpha)`` (the reference's
index_select, slowfast.py:466: for T = 16 and alpha = 8 the frames 0 and
15, not ``::alpha``). Each pathway is a stem (conv, BN, ReLU and a
(1,3,3)/(1,2,2)/(0,1,1) max pool through K1/K2) and four stages of
bottlenecks whose last BN starts at zero; C2D and I3D max-pool T by 2
after res2 (K1/K2). ``FuseFastToSlow`` convs ((k,1,1), temporal stride
alpha) concatenate the fast features after the slow ones before each slow
stage. A non-local block pools its input (1,2,2)/(1,2,2) (K1/K2), takes
theta from the input and phi and g from the pooled map (1^3 convs with a
bias), attends by softmax of theta phi^T scaled by inner^-1/2 (C2D, I3D)
or by theta phi^T over the number of keys (``dot_product``), then ``out``
(1^3, bias) and a zero-initialised BN, added to its input.

Module names follow the JAX tree (no reference torch names exist):
``slow.stem.{conv,bn}``, ``slow.s2_b0.conv{1,2,3}.{conv,bn}``,
``slow.s3_b0.downsample``, ``slow.nl_s3_b1.{theta,phi,g,out,bn}``,
``fast...``, ``fuse_stem.conv_f2s.{conv,bn}``, ``fuse_s{2,3,4}``,
``head_fc``. Activations are NCDHW views in channels-last memory;
``dtype`` is the compute dtype (models/common.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import yaml_subset
from ..framework import tracing
from .common import (ConvNorm, conv3d, dense, global_avg_pool, make_conv,
                     make_norm, max_pool3d, mean_dim, softmax_last)

_R50 = (3, 4, 6, 3)
_R101 = (3, 4, 23, 3)
_NL_STD = ((), (1, 3), (1, 3, 5), ())   # the standard NLN placement

# stem tk + per-stage per-block temporal kernel basis (slowfast.py:55)
_TK = {
    "slow": (1, ((1,), (1,), (3,), (3,))),
    "c2d": (1, ((1,), (1,), (1,), (1,))),
    "i3d": (5, ((3,), (3, 1), (3, 1), (1, 3))),
    "slowfast_slow": (1, ((1,), (1,), (3,), (3,))),
    "slowfast_fast": (5, ((3,), (3,), (3,), (3,))),
}
# temporal pool after res2 (slowfast.py:63)
_POOL1 = {"slow": 1, "c2d": 2, "c2d_nopool": 1, "i3d": 2, "i3d_nopool": 1,
          "slowfast": 1}


@dataclass(frozen=True)
class SlowFastSpec:
    name: str
    two_pathway: bool
    alpha: int = 8                    # fast/slow frame-rate ratio
    beta_inv: int = 8                 # slow/fast channel ratio
    fusion_kernel: int = 5
    fusion_ratio: int = 2
    depths: Tuple[int, ...] = _R50
    slow_stem_tk: int = 1
    slow_tk: Tuple[Tuple[int, ...], ...] = _TK["slow"][1]
    fast_stem_tk: int = 5
    fast_tk: Tuple[Tuple[int, ...], ...] = _TK["slowfast_fast"][1]
    # blocks per stage that carry a temporal kernel (NUM_BLOCK_TEMP_KERNEL)
    nbtk_slow: Tuple[int, ...] = _R50
    nbtk_fast: Tuple[int, ...] = _R50
    temporal_pool1: int = 1           # c2d/i3d: max-pool T by 2 after res2
    # non-local block indices per stage, slow/single pathway
    nl_blocks: Tuple[Tuple[int, ...], ...] = ((), (), (), ())
    nl_instantiation: str = "dot_product"   # | "softmax"
    norm_type: str = "batchnorm"            # | "sub_batchnorm"
    bn_num_splits: int = 1


def _sf(name, alpha, fk, depths=_R50, nbtk_slow=None, nbtk_fast=None,
        nl=((), (), (), ())):
    return SlowFastSpec(
        name, True, alpha=alpha, fusion_kernel=fk, depths=depths,
        slow_stem_tk=_TK["slowfast_slow"][0], slow_tk=_TK["slowfast_slow"][1],
        fast_stem_tk=_TK["slowfast_fast"][0], fast_tk=_TK["slowfast_fast"][1],
        nbtk_slow=nbtk_slow or depths, nbtk_fast=nbtk_fast or depths,
        nl_blocks=nl)


def _single(name, kind, depths=_R50, nl=((), (), (), ()),
            nl_inst="dot_product", pool_kind=None):
    stem_tk, tk = _TK[kind]
    return SlowFastSpec(
        name, False, depths=depths, slow_stem_tk=stem_tk, slow_tk=tk,
        nbtk_slow=depths, temporal_pool1=_POOL1[pool_kind or kind],
        nl_blocks=nl, nl_instantiation=nl_inst)


# the JAX package's table (slowfast.py:111), held equal to it field by
# field by tests/test_torch_slowfast.py
SPECS = {
    "SLOWFAST_4x16_R50": _sf("SLOWFAST_4x16_R50", alpha=8, fk=5),
    "SLOWFAST_8x8_R50": _sf("SLOWFAST_8x8_R50", alpha=4, fk=7),
    "SLOWFAST_NLN_4x16_R50": _sf("SLOWFAST_NLN_4x16_R50", alpha=8, fk=5,
                                 nl=_NL_STD),
    "SLOWFAST_NLN_8x8_R50": _sf("SLOWFAST_NLN_8x8_R50", alpha=4, fk=5,
                                nl=_NL_STD),
    "SLOWFAST_8x8_R101_50_50": _sf("SLOWFAST_8x8_R101_50_50", alpha=4, fk=5,
                                   depths=_R101, nbtk_slow=_R50,
                                   nbtk_fast=_R50),
    "SLOWFAST_8x8_R101_50_101": _sf("SLOWFAST_8x8_R101_50_101", alpha=4,
                                    fk=5, depths=_R101, nbtk_slow=_R50,
                                    nbtk_fast=_R101),
    "SLOWFAST_8x8_R101_101_101": _sf("SLOWFAST_8x8_R101_101_101", alpha=4,
                                     fk=5, depths=_R101, nbtk_slow=_R101,
                                     nbtk_fast=_R101),
    "SLOWFAST_16x8_R101_50_50": _sf("SLOWFAST_16x8_R101_50_50", alpha=4,
                                    fk=5, depths=_R101, nbtk_slow=_R50,
                                    nbtk_fast=_R50),
    "SLOWFAST_NLN_16x8_R101_50_50": _sf(
        "SLOWFAST_NLN_16x8_R101_50_50", alpha=4, fk=5, depths=_R101,
        nbtk_slow=_R50, nbtk_fast=_R50, nl=((), (), (6, 13, 20), ())),
    "SLOW_4x16_R50": _single("SLOW_4x16_R50", "slow"),
    "SLOW_8x8_R50": _single("SLOW_8x8_R50", "slow"),
    "SLOW_NLN_4x16_R50": _single("SLOW_NLN_4x16_R50", "slow", nl=_NL_STD),
    "SLOW_NLN_8x8_R50": _single("SLOW_NLN_8x8_R50", "slow", nl=_NL_STD),
    "C2D_8x8_R50": _single("C2D_8x8_R50", "c2d", nl_inst="softmax"),
    "C2D_NLN_8x8_R50": _single("C2D_NLN_8x8_R50", "c2d", nl=_NL_STD,
                               nl_inst="softmax"),
    "C2D_NOPOOL_8x8_R50": _single("C2D_NOPOOL_8x8_R50", "c2d",
                                  nl_inst="softmax",
                                  pool_kind="c2d_nopool"),
    "I3D_8x8_R50": _single("I3D_8x8_R50", "i3d", nl_inst="softmax"),
    "I3D_NLN_8x8_R50": _single("I3D_NLN_8x8_R50", "i3d", nl=_NL_STD,
                               nl_inst="softmax"),
    "I3D_8x8_R101": _single("I3D_8x8_R101", "i3d", depths=_R101,
                            nl_inst="softmax"),
    "I3D_NLN_8x8_R101": _single("I3D_NLN_8x8_R101", "i3d", depths=_R101,
                                nl=_NL_STD, nl_inst="softmax"),
}


def spec_from_yaml_dict(d: dict, name: str) -> SlowFastSpec:
    """pyslowfast-style YAML dict -> SlowFastSpec (slowfast.py:155): only
    the model-architecture groups are read."""
    arch = d.get("MODEL", {}).get("ARCH", "slowfast")
    # the c2 NOPOOL configs keep ARCH c2d and say MODEL_NAME ResNet_nopool
    if (d.get("MODEL", {}).get("MODEL_NAME", "").endswith("_nopool")
            and not arch.endswith("_nopool")):
        arch += "_nopool"
    rn = d.get("RESNET", {})
    sf = d.get("SLOWFAST", {})
    nl = d.get("NONLOCAL", {})
    bn = d.get("BN", {})
    depth = rn.get("DEPTH", 50)
    try:
        depths = {50: _R50, 101: _R101}[depth]
    except KeyError:
        raise ValueError(f"unsupported RESNET.DEPTH {depth}")
    paths = 2 if arch == "slowfast" else 1
    nbtk = rn.get("NUM_BLOCK_TEMP_KERNEL") or [[n] * paths for n in depths]
    loc = nl.get("LOCATION") or [[[]] * paths] * 4
    nl_blocks = tuple(tuple(stage[0]) for stage in loc)
    if any(stage[1] for stage in loc if len(stage) > 1):
        raise NotImplementedError("non-local on the fast pathway")
    common = dict(
        depths=depths,
        nbtk_slow=tuple(s[0] for s in nbtk),
        nl_blocks=nl_blocks,
        nl_instantiation=nl.get("INSTANTIATION", "dot_product"),
        norm_type=bn.get("NORM_TYPE", "batchnorm"),
        bn_num_splits=bn.get("NUM_SPLITS", 1),
    )
    if arch == "slowfast":
        stem_tk, tk = _TK["slowfast_slow"]
        f_stem, f_tk = _TK["slowfast_fast"]
        return SlowFastSpec(
            name, True, alpha=sf.get("ALPHA", 8),
            beta_inv=sf.get("BETA_INV", 8),
            fusion_ratio=sf.get("FUSION_CONV_CHANNEL_RATIO", 2),
            fusion_kernel=sf.get("FUSION_KERNEL_SZ", 5),
            slow_stem_tk=stem_tk, slow_tk=tk,
            fast_stem_tk=f_stem, fast_tk=f_tk,
            nbtk_fast=tuple(s[1] for s in nbtk),
            temporal_pool1=_POOL1["slowfast"], **common)
    if arch in ("slow", "c2d", "i3d", "c2d_nopool", "i3d_nopool"):
        stem_tk, tk = _TK[arch.replace("_nopool", "")]
        return SlowFastSpec(
            name, False, slow_stem_tk=stem_tk, slow_tk=tk,
            temporal_pool1=_POOL1[arch], **common)
    raise ValueError(f"unsupported MODEL.ARCH {arch!r}")


def spec_from_yaml(path: str, name: Optional[str] = None) -> SlowFastSpec:
    """A pyslowfast YAML file -> SlowFastSpec, named after the file."""
    return spec_from_yaml_dict(
        yaml_subset.load(path),
        name or os.path.splitext(os.path.basename(path))[0])


class NonLocal(nn.Module):
    """Non-local block (rspnet_tpu/models/slowfast.py:221), its rounding
    points those of the JAX block in bf16: each 1^3 conv (bias added to
    the rounded product), both attention products, the scale and the
    three of the softmax (``softmax_last``), or the division by the number
    of keys.

    Each forward counts ``backbone.nonlocal_calls``; while the tracer is
    on, the whole block is the device span ``rsp.backbone.nonlocal``
    (framework/tracing.py)."""

    def __init__(self, channels: int, inner: int,
                 instantiation: str = "dot_product", bn_splits: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inner, self.instantiation, self.dtype = inner, instantiation, dtype
        self.theta = make_conv(channels, inner, 1, use_bias=True)
        self.phi = make_conv(channels, inner, 1, use_bias=True)
        self.g = make_conv(channels, inner, 1, use_bias=True)
        self.out = make_conv(inner, channels, 1, use_bias=True)
        self.bn = make_norm(channels, bn_splits, dtype)
        nn.init.zeros_(self.bn.weight)      # the block starts as identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tracing.add("backbone.nonlocal_calls")
        with tracing.device_span("rsp.backbone.nonlocal"):
            return self._attend(x)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        B, _, T, H, W = x.shape
        dt, inner = self.dtype, self.inner
        theta = conv3d(self.theta, x, dt)
        pooled = max_pool3d(x, (1, 2, 2), (1, 2, 2), 0)
        phi = conv3d(self.phi, pooled, dt)
        g = conv3d(self.g, pooled, dt)

        def rows(v):                     # NCDHW -> [B, T*H*W, inner]
            return v.permute(0, 2, 3, 4, 1).reshape(B, -1, inner)

        k = rows(phi)
        attn = torch.bmm(rows(theta), k.transpose(1, 2))
        if self.instantiation == "softmax":
            # the scale rounded to the attention's dtype first, as JAX's
            # weak-typed python float is
            scale = torch.tensor(inner ** -0.5, dtype=attn.dtype).item()
            attn = softmax_last(attn * scale)
        else:                                             # dot_product
            attn = attn / k.shape[1]
        y = torch.bmm(attn, rows(g)).reshape(B, T, H, W, inner)
        out = conv3d(self.out, y.permute(0, 4, 1, 2, 3), dt)
        return x + self.bn(out)


class Bottleneck(nn.Module):
    """(tk,1,1) -> (1,3,3) -> (1,1,1), the last BN's scale at zero
    (RESNET.ZERO_INIT_FINAL_BN), and a 1^3 projection when the shape
    changes (slowfast.py:269)."""

    def __init__(self, in_channels: int, planes: int, out_planes: int,
                 temp_kernel: int = 1, stride: int = 1,
                 needs_proj: bool = False, bn_splits: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(bn_splits=bn_splits, dtype=dtype)
        tk = temp_kernel
        self.conv1 = ConvNorm(in_channels, planes, (tk, 1, 1), 1,
                              (tk // 2, 0, 0), **kw)
        self.conv2 = ConvNorm(planes, planes, (1, 3, 3), (1, stride, stride),
                              (0, 1, 1), **kw)
        self.conv3 = ConvNorm(planes, out_planes, 1, activation=False,
                              zero_bn=True, **kw)
        self.downsample = (
            ConvNorm(in_channels, out_planes, 1, (1, stride, stride), 0,
                     activation=False, **kw) if needs_proj else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x)))
        res = self.downsample(x) if self.downsample is not None else x
        return torch.relu(h + res)


class Pathway(nn.Module):
    """Stem + 4 stages of one pathway (slowfast.py:306); ``width`` is 64
    (slow) or 64 // beta_inv (fast), ``fuse_in`` the lateral channels
    appended before each stage."""

    def __init__(self, width: int, stem_tk: int,
                 stage_tk: Sequence[Sequence[int]], nbtk: Sequence[int],
                 depths: Sequence[int], temporal_pool1: int = 1,
                 nl_blocks: Sequence[Sequence[int]] = ((), (), (), ()),
                 nl_instantiation: str = "dot_product",
                 fuse_in: Sequence[int] = (0, 0, 0, 0), bn_splits: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depths, self.temporal_pool1 = tuple(depths), temporal_pool1
        w = width
        self.stem = ConvNorm(3, w, (stem_tk, 7, 7), (1, 2, 2),
                             (stem_tk // 2, 3, 3), bn_splits=bn_splits,
                             dtype=dtype)
        # per stage, (block name, non-local name or None) in forward order
        self.order = []
        in_ch = w + fuse_in[0]
        for s, depth in enumerate(self.depths):
            inner = w * (2 ** s)
            out_ch = inner * 4
            basis = stage_tk[s]
            stage = []
            for i in range(depth):
                stride = 2 if (s > 0 and i == 0) else 1
                tk = basis[i % len(basis)] if i < nbtk[s] else 1
                name = f"s{s + 2}_b{i}"
                setattr(self, name, Bottleneck(
                    in_ch, inner, out_ch, tk, stride,
                    stride != 1 or in_ch != out_ch, bn_splits, dtype))
                in_ch = out_ch
                nl = None
                if i in nl_blocks[s]:
                    nl = f"nl_s{s + 2}_b{i}"
                    setattr(self, nl, NonLocal(out_ch, out_ch // 2,
                                               nl_instantiation, bn_splits,
                                               dtype))
                stage.append((name, nl))
            self.order.append(stage)
            if s + 1 < len(self.depths):
                in_ch = out_ch + fuse_in[s + 1]

    def stage_io(self, x: torch.Tensor, fuse_feats=None):
        """-> (final map, the stem's pooled map, each stage's map)."""
        x = max_pool3d(self.stem(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        stem_out, feats = x, []
        for s, stage in enumerate(self.order):
            if fuse_feats is not None and fuse_feats[s] is not None:
                x = torch.cat([x, fuse_feats[s]], dim=1)
            for name, nl in stage:
                x = getattr(self, name)(x)
                if nl is not None:
                    x = getattr(self, nl)(x)
            if s == 0 and self.temporal_pool1 > 1:
                tp = self.temporal_pool1
                x = max_pool3d(x, (tp, 1, 1), (tp, 1, 1))
            feats.append(x)
        return x, stem_out, feats


class FuseFastToSlow(nn.Module):
    """(k,1,1) conv with temporal stride alpha, BN and ReLU on a fast map
    (slowfast.py:381)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 alpha: int, bn_splits: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_f2s = ConvNorm(in_channels, out_channels, (kernel, 1, 1),
                                 (alpha, 1, 1), (kernel // 2, 0, 0),
                                 bn_splits=bn_splits, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_f2s(x)


class SlowFast(nn.Module):
    """Two-pathway SlowFast (or single-pathway Slow / C2D / I3D). Input
    and output of ``forward`` are NDHWC; ``features`` takes and gives NCDHW
    channels-last views."""

    def __init__(self, spec: SlowFastSpec = SPECS["SLOWFAST_4x16_R50"],
                 num_classes: int = 400, dropout_rate: float = 0.5,
                 with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        sp = spec
        splits = sp.bn_num_splits if sp.norm_type == "sub_batchnorm" else 1
        base = 64 * (2 ** (len(sp.depths) - 1)) * 4          # 2048
        fast_w = 64 // sp.beta_inv if sp.two_pathway else 0
        self.feature_dim = base + (base // sp.beta_inv if sp.two_pathway
                                   else 0)
        fuse_in = [0, 0, 0, 0]
        if sp.two_pathway:
            fast_out = (fast_w, fast_w * 4, fast_w * 8, fast_w * 16)
            fuse_in = [c * sp.fusion_ratio for c in fast_out]
        self.slow = Pathway(64, sp.slow_stem_tk, sp.slow_tk, sp.nbtk_slow,
                            sp.depths, sp.temporal_pool1, sp.nl_blocks,
                            sp.nl_instantiation, fuse_in, splits, dtype)
        self.fuses = []
        if sp.two_pathway:
            self.fast = Pathway(fast_w, sp.fast_stem_tk, sp.fast_tk,
                                sp.nbtk_fast, sp.depths, bn_splits=splits,
                                dtype=dtype)
            for name, c_in, c_out in zip(
                    ("fuse_stem", "fuse_s2", "fuse_s3", "fuse_s4"),
                    fast_out, fuse_in):
                setattr(self, name, FuseFastToSlow(
                    c_in, c_out, sp.fusion_kernel, sp.alpha, splits, dtype))
                self.fuses.append(name)
        self.drop_prob = dropout_rate if with_classifier else None
        self.head_fc = (nn.Linear(self.feature_dim, num_classes)
                        if with_classifier else None)

    def _pathways(self, x: torch.Tensor):
        """NCDHW clip -> (slow map, fast map or None). While the tracer is
        on, the fast pathway (stem and four stages, not the lateral
        convolutions) is the device span ``rsp.backbone.fast``."""
        if not self.spec.two_pathway:
            return self.slow.stage_io(x)[0], None
        t = x.shape[2]
        idx = np.linspace(0, t - 1, t // self.spec.alpha).astype(np.int64)
        slow_in = x[:, :, torch.from_numpy(idx).to(x.device)].contiguous(
            memory_format=torch.channels_last_3d)
        with tracing.device_span("rsp.backbone.fast"):
            fast_out, fast_stem, fast_feats = self.fast.stage_io(x)
        fuse = [getattr(self, name)(v) for name, v in
                zip(self.fuses, [fast_stem] + fast_feats[:3])]
        return self.slow.stage_io(slow_in, fuse)[0], fast_out

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> one map whose global average is
        the classifier's input: the slow map, then the fast map with its T
        averaged down to the slow grid (slowfast.py:476)."""
        slow_out, fast_out = self._pathways(x)
        if fast_out is None:
            return slow_out
        b, c, tf, h, w = fast_out.shape
        ts = slow_out.shape[2]
        fast_s = mean_dim(fast_out.reshape(b, c, ts, tf // ts, h, w), 3)
        return torch.cat([slow_out, fast_s.contiguous(
            memory_format=torch.channels_last_3d)], dim=1)

    def forward(self, x: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NDHWC clip -> the pooled slow and fast features, concatenated
        [B, feature_dim], or the ``head_fc`` logits; in train mode the
        dropout keeps the features where ``dropout_mask`` is True (drawn
        from ``generator`` when not given), as S3D-G's head does."""
        slow_out, fast_out = self._pathways(x.permute(0, 4, 1, 2, 3))
        out = global_avg_pool(slow_out)
        if fast_out is not None:
            out = torch.cat([out, global_avg_pool(fast_out)], dim=-1)
        if self.head_fc is None:
            return out
        if self.training and self.drop_prob > 0:
            keep = 1.0 - self.drop_prob
            if dropout_mask is None:
                gen_dev = (out.device if generator is None
                           else generator.device)
                dropout_mask = torch.rand(out.shape, generator=generator,
                                          device=gen_dev) < keep
            dropout_mask = dropout_mask.to(out.device, torch.bool)
            out = torch.where(dropout_mask, out / keep, torch.zeros_like(out))
        return dense(out, self.head_fc, self.dtype)


def get_model_class(arch: str, cfg_file=None,
                    variant: str = "SLOWFAST_4x16_R50"):
    """The constructor of a SlowFast spec (slowfast.py:504): ``arch``
    ``slowfast`` with a ``variant`` name or a ``cfg_file`` YAML path, or a
    ``SLOWFAST*`` / ``SLOW_*`` / ``C2D*`` / ``I3D*`` name. A ``cfg_file``
    that is not a string (the ``slowfast`` preset of
    config/lib/models.libsonnet writes a mapping of YAML paths) is passed
    over for ``variant``, as in the JAX package: its default is
    ``SLOWFAST_4x16_R50``."""
    if arch == "slowfast" and isinstance(cfg_file, str):
        spec = spec_from_yaml(cfg_file)
    else:
        name = variant if arch == "slowfast" else arch
        if name not in SPECS:
            raise ValueError(f"Unknown SlowFast variant {name!r}; "
                             f"available: {sorted(SPECS)}")
        spec = SPECS[name]

    def ctor(num_classes: int = 400, **kw) -> SlowFast:
        return SlowFast(spec=spec, num_classes=num_classes, **kw)
    return ctor
