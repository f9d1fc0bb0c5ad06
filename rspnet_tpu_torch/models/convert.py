"""JAX variables <-> the port's ``state_dict`` (port of the S3D-G, C3D,
ResNet-3D and R(2+1)D parts of rspnet_tpu/models/torch_bridge.py, both
ways, and of the TSM and head trees of the JAX modules).

The JAX side is a ``{"params", "batch_stats"}`` pair of trees whose leaves
are numpy arrays (or CPU tensors, as a checkpoint holds them). The model is
a bare backbone (``S3DG``, ``C3D``, ``ResNet3D``, ``R2Plus1DNet``,
``TSM``), with or without its own classifier (``model_type: 1stream``), a
pretraining ``MultiTaskWrapper`` (``encoder`` + ``fc1``/``fc2`` heads of
one ``fc_type``) or a finetuning one (``encoder`` + the ``fc``
classifier). ``state_dict_to_variables`` is the inverse of
``variables_to_state_dict``: the checkpoints of both packages hold its
output.

What the arch name does not fix is read from the source's own names, as
a wrapper's kind is: the heads' ``fc_type`` (``fc1.hidden``: mlp;
``fc1.conv2``: conv; ``fc1.conv1`` alone: convbn; else linear, which
speednet's heads are too), and TSM's blocks (``layer{s}_{i}``, a
``conv3`` for the bottleneck base, ``nl{s}_{i}`` non-local blocks), whose
port names are the JAX tree's.

Tensor conventions:
- flax conv kernel [kt, kh, kw, I, O] <-> torch Conv3d weight
  [O, I, kt, kh, kw]
- flax dense kernel [I, O] <-> torch Linear weight [O, I]
- flax BN {scale, bias} + {mean, var} <-> {weight, bias, running_mean,
  running_var}; BN's ``num_batches_tracked`` has no JAX counterpart

Some tensors of a backbone exist only in some builds of it: a ResNet
block's ``downsample`` (shortcut B, not A) and a bare backbone's own
classifier (``fc``, ``linear``, ``new_fc``). Their entries are skipped
where the source lacks them; ``load_converted`` still requires every
tensor of the module.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Mapping

import numpy as np
import torch

from .resnet3d import DEPTHS, Bottleneck

__all__ = ["variables_to_state_dict", "state_dict_to_variables",
           "load_converted", "load_variables"]


def _conv_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (4, 3, 0, 1, 2))


def _dense_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (1, 0))


def _conv_w_inv(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (2, 3, 4, 1, 0))


# each tensor convention's inverse (the dense one is its own)
_INVERSE = {None: None, _conv_w: _conv_w_inv, _dense_w: _dense_w}


def _bn(prefix_t: str, prefix_f: str):
    return [
        (f"{prefix_t}.weight", ("params", f"{prefix_f}/scale", None)),
        (f"{prefix_t}.bias", ("params", f"{prefix_f}/bias", None)),
        (f"{prefix_t}.running_mean", ("batch_stats", f"{prefix_f}/mean", None)),
        (f"{prefix_t}.running_var", ("batch_stats", f"{prefix_f}/var", None)),
    ]


def _conv_bn(conv_t: str, bn_t: str, prefix_f: str, bias: bool = False):
    m = [(f"{conv_t}.weight", ("params", f"{prefix_f}/conv/kernel", _conv_w))]
    if bias:
        m.append((f"{conv_t}.bias", ("params", f"{prefix_f}/conv/bias", None)))
    return m + _bn(bn_t, f"{prefix_f}/bn")


def _convbn(prefix_t: str, prefix_f: str):
    return _conv_bn(f"{prefix_t}.conv3d", f"{prefix_t}.bn", prefix_f)


def _sepconv_mapping(t: str, f: str, gate: bool) -> list:
    m = _convbn(f"{t}.sep_conv.0", f"{f}/down")
    m += _convbn(f"{t}.sep_conv.1", f"{f}/up")
    if gate:
        m += [(f"{t}.excitation.weight",
               ("params", f"{f}/excitation/kernel", _conv_w)),
              (f"{t}.excitation.bias",
               ("params", f"{f}/excitation/bias", None))]
    return m


def _sepinc_mapping(t: str, f: str, gate: bool) -> list:
    m = _convbn(f"{t}.branch0", f"{f}/branch0")
    m += _convbn(f"{t}.branch1.0", f"{f}/branch1_red")
    m += _sepconv_mapping(f"{t}.branch1.1", f"{f}/branch1_sep", gate)
    m += _convbn(f"{t}.branch2.0", f"{f}/branch2_red")
    m += _sepconv_mapping(f"{t}.branch2.1", f"{f}/branch2_sep", gate)
    m += _convbn(f"{t}.branch3.1", f"{f}/branch3")
    return m


_S3D_INC = [("sepInc_3b", "inc3b"), ("sepInc_3c", "inc3c"),
            ("sepInc_4b", "inc4b"), ("sepInc_4c", "inc4c"),
            ("sepInc_4d", "inc4d"), ("sepInc_4e", "inc4e"),
            ("sepInc_4f", "inc4f"), ("sepInc_5b", "inc5b"),
            ("sepInc_5c", "inc5c")]


def _s3dg_mapping(gate: bool = True) -> list:
    m = _sepconv_mapping("feature.sepConv1", "sepConv1", gate)
    m += _convbn("feature.basicConv3d", "basicConv3d")
    m += _sepconv_mapping("feature.sep_conv2", "sepConv2", gate)
    for t, f in _S3D_INC:
        m += _sepinc_mapping(f"feature.{t}", f, gate)
    return m


def _dense(t: str, f: str) -> list:
    return [(f"{t}.weight", ("params", f"{f}/kernel", _dense_w)),
            (f"{t}.bias", ("params", f"{f}/bias", None))]


def _c3d_mapping() -> list:
    m = []
    for name in ["conv1", "conv2", "conv3a", "conv3b", "conv4a", "conv4b",
                 "conv5a", "conv5b"]:
        m += _conv_bn(name, "bn" + name[4:], name, bias=True)
    return m + _dense("linear", "linear")


def _resnet_mapping(layers, bottleneck: bool) -> list:
    m = _conv_bn("conv1", "bn1", "stem")
    for s, blocks in enumerate(layers):
        for i in range(blocks):
            t, f = f"layer{s + 1}.{i}", f"layer{s + 1}_{i}"
            for c in range(1, (3 if bottleneck else 2) + 1):
                m += _conv_bn(f"{t}.conv{c}", f"{t}.bn{c}", f"{f}/conv{c}")
            # a block whose shape changes has a projection under shortcut B
            if i == 0 and (s > 0 or bottleneck):
                m += _conv_bn(f"{t}.downsample.0", f"{t}.downsample.1",
                              f"{f}/downsample")
    return m + _dense("fc", "fc")


def _stconv_mapping(t: str, f: str) -> list:
    """An R(2+1)D ``SpatioTemporalConv``: the spatial conv and its BN, the
    bare temporal conv (torch_bridge.py:_stconv_mapping)."""
    m = _conv_bn(f"{t}.spatial_conv", f"{t}.bn", f"{f}/spatial")
    return m + [(f"{t}.temporal_conv.weight",
                 ("params", f"{f}/temporal/conv/kernel", _conv_w))]


def _r2plus1d_mapping(layer_sizes) -> list:
    """The reference torch names (torch_bridge.py:_r2plus1d_mapping)."""
    m = _stconv_mapping("conv1", "conv1") + _bn("bn1", "bn1")
    for s, blocks in enumerate(layer_sizes):
        for i in range(blocks):
            t = (f"conv{s + 2}.block1" if i == 0
                 else f"conv{s + 2}.blocks.{i - 1}")
            f = f"conv{s + 2}_{i}"
            for c in (1, 2):
                m += _stconv_mapping(f"{t}.conv{c}", f"{f}/conv{c}")
                m += _bn(f"{t}.bn{c}", f"{f}/bn{c}")
            if s > 0 and i == 0:
                m += _stconv_mapping(f"{t}.downsampleconv",
                                     f"{f}/downsampleconv")
                m += _bn(f"{t}.downsamplebn", f"{f}/downsamplebn")
    return m + _dense("linear", "linear")


def _conv_with_bias(t: str, f: str) -> list:
    return [(f"{t}.weight", ("params", f"{f}/kernel", _conv_w)),
            (f"{t}.bias", ("params", f"{f}/bias", None))]


def _same_name_convbn(t: str, bias: bool = False, bn: bool = True) -> list:
    """A ``ConvNorm`` whose torch names are its JAX path's (``t.conv``,
    ``t.bn``)."""
    f = t.replace(".", "/")
    m = (_conv_with_bias(f"{t}.conv", f"{f}/conv") if bias else
         [(f"{t}.conv.weight", ("params", f"{f}/conv/kernel", _conv_w))])
    return m + (_bn(f"{t}.bn", f"{f}/bn") if bn else [])


def _tsm_mapping(names) -> list:
    """TSM from the blocks its source holds: ``layer{s}_{i}`` (a
    ``conv3``: the bottleneck base) and ``nl{s}_{i}``."""
    tops = {n.split(".")[0] for n in names}
    bottleneck = any(n.startswith("layer1_0.conv3.") for n in names)
    m = _same_name_convbn("stem")
    for s in range(1, 5):
        i = 0
        while f"layer{s}_{i}" in tops:
            b = f"layer{s}_{i}"
            for c in range(1, (3 if bottleneck else 2) + 1):
                m += _same_name_convbn(f"{b}.conv{c}")
            if i == 0 and (s > 1 or bottleneck):
                m += _same_name_convbn(f"{b}.downsample")
            nl = f"nl{s}_{i}"
            if nl in tops:
                for conv in ("theta", "phi", "g", "w"):
                    m += _conv_with_bias(f"{nl}.{conv}", f"{nl}/{conv}")
                m += _bn(f"{nl}.bn", f"{nl}/bn")
            i += 1
    return m + _dense("new_fc", "new_fc")


KEY_MAPPERS = {
    "s3dg": lambda: _s3dg_mapping(True) + _dense("fc", "fc"),
    "s3d": lambda: _s3dg_mapping(False) + _dense("fc", "fc"),
    "c3d": _c3d_mapping,
    "r2plus1d-vcop": lambda: _r2plus1d_mapping((1, 1, 1, 1)),
    "r2plus1d-18": lambda: _r2plus1d_mapping((2, 2, 2, 2)),
    **{arch: partial(_resnet_mapping, layers, block is Bottleneck)
       for arch, (block, layers) in DEPTHS.items()},
}


def _optional(key_t: str) -> bool:
    """A backbone tensor that only some builds have (module docstring)."""
    return ".downsample." in key_t or key_t.split(".")[0] in (
        "fc", "linear", "new_fc")


def _head_mapping(h: str, fc_type: str) -> list:
    """One pretraining head, ``fc1`` or ``fc2`` (rspnet_tpu/moco/
    wrapper.py:21-75); speednet's heads are linear ones."""
    m = []
    if fc_type == "mlp":
        m += _dense(f"{h}.hidden", f"{h}/hidden")
    elif fc_type in ("conv", "convbn"):
        m += _same_name_convbn(f"{h}.conv1", bias=True,
                               bn=fc_type == "convbn")
        if fc_type == "conv":
            m += _same_name_convbn(f"{h}.conv2", bias=True, bn=False)
    return m + _dense(f"{h}.linear", f"{h}/linear")


def _fc_type(names) -> str:
    """The pretraining heads' kind, from the source's names."""
    if any(n.startswith("fc1.hidden.") for n in names):
        return "mlp"
    if any(n.startswith("fc1.conv2.") for n in names):
        return "conv"
    if any(n.startswith("fc1.conv1.") for n in names):
        return "convbn"
    return "linear"


def _model_mapping(arch: str, names):
    """-> (entries, optional keys): (torch key, (collection, JAX path,
    conversion)) of every tensor of the model whose source holds
    ``names`` (dotted: torch keys, or JAX paths joined with "."), and the
    torch keys of the backbone's optional tensors. The model is a
    backbone, or (an ``encoder.`` entry) a ``MultiTaskWrapper`` with the
    classifier (an ``fc.`` entry) or the pretraining heads."""
    wrapper = any(n.startswith("encoder.") for n in names)
    if arch == "tsm":            # its blocks are read from the source
        m = _tsm_mapping([n[len("encoder."):] for n in names
                          if n.startswith("encoder.")] if wrapper
                         else list(names))
    elif arch in KEY_MAPPERS:
        m = KEY_MAPPERS[arch]()
    else:
        raise NotImplementedError(
            f"no port mapping for arch {arch!r} (see ROADMAP.md)")
    optional = {t for t, _ in m if _optional(t)}
    if not wrapper:
        return m, optional
    m = [(f"encoder.{t}", (coll, f"encoder/{f}", conv))
         for t, (coll, f, conv) in m]
    optional = {f"encoder.{t}" for t in optional}
    if any(n.startswith("fc.") for n in names):
        return m + _dense("fc", "fc"), optional
    fc_type = _fc_type(names)
    return m + _head_mapping("fc1", fc_type) + _head_mapping(
        "fc2", fc_type), optional


def _tree_names(tree: Mapping, prefix: str = "") -> list:
    """Dotted paths of a tree's leaves."""
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out += _tree_names(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}")
    return out


def _get_path(tree: Mapping, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _set_path(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def variables_to_state_dict(variables: Mapping, arch: str = "s3dg"
                            ) -> Dict[str, np.ndarray]:
    """JAX variables (numpy or CPU tensor leaves) -> port state_dict
    entries (numpy)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    mapping, optional = _model_mapping(arch, _tree_names(params))
    for key_t, (coll, path_f, conv) in mapping:
        tree = params if coll == "params" else stats
        try:
            v = _numpy(_get_path(tree, path_f))
        except KeyError:
            if key_t in optional:
                continue
            raise
        out[key_t] = conv(v) if conv is not None else v
    return out


def state_dict_to_variables(state_dict: Mapping, arch: str = "s3dg"
                            ) -> Dict[str, dict]:
    """Port state_dict -> JAX ``{"params", "batch_stats"}`` trees of numpy
    arrays, in the tensors' dtype; every entry but BN's
    ``num_batches_tracked`` must be mapped."""
    mapping, optional = _model_mapping(arch, list(state_dict))
    mapped = {key_t for key_t, _ in mapping}
    extra = [k for k in state_dict if k not in mapped
             and not k.endswith("num_batches_tracked")]
    if extra:
        raise KeyError(f"state_dict entries without a JAX name: {extra[:5]}")
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key_t, (coll, path_f, conv) in mapping:
        if key_t in optional and key_t not in state_dict:
            continue
        v = _numpy(state_dict[key_t])
        inv = _INVERSE[conv]
        _set_path(out[coll], path_f, np.ascontiguousarray(
            inv(v) if inv is not None else v))
    return out


def load_converted(module: torch.nn.Module,
                   converted: Mapping[str, np.ndarray]) -> None:
    """Copy converted entries into ``module``; every parameter and buffer
    but BN's ``num_batches_tracked`` must be covered."""
    sd = module.state_dict()
    missing = [k for k in sd if k not in converted
               and not k.endswith("num_batches_tracked")]
    extra = [k for k in converted if k not in sd]
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]} "
                       f"extra {extra[:5]}")
    for k, v in converted.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: {tuple(v.shape)} != {tuple(sd[k].shape)}")
        sd[k] = torch.from_numpy(np.array(v, copy=True)).to(sd[k].dtype)
    module.load_state_dict(sd)


def load_variables(module: torch.nn.Module, variables: Mapping,
                   arch: str = "s3dg") -> None:
    """Load JAX-layout ``{"params", "batch_stats"}`` trees (as a checkpoint
    of either package holds them) into ``module``."""
    load_converted(module, variables_to_state_dict(variables, arch))
