"""JAX variables -> the port's ``state_dict`` (port of the S3D-G part of
rspnet_tpu/models/torch_bridge.py).

The input is a ``{"params", "batch_stats"}`` pair of trees whose leaves are
already numpy arrays. Either a bare backbone (``S3DG``) or a pretraining
``MultiTaskWrapper`` (``encoder`` + ``fc1``/``fc2`` linear heads).

Tensor conventions:
- flax conv kernel [kt, kh, kw, I, O]  ->  torch Conv3d weight [O, I, kt, kh, kw]
- flax dense kernel [I, O]             ->  torch Linear weight [O, I]
- flax BN {scale, bias} + {mean, var}  ->  {weight, bias, running_mean,
  running_var}
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["variables_to_state_dict", "load_converted"]


def _conv_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (4, 3, 0, 1, 2))


def _dense_w(t: np.ndarray) -> np.ndarray:
    return np.transpose(t, (1, 0))


def _bn(prefix_t: str, prefix_f: str):
    return [
        (f"{prefix_t}.weight", ("params", f"{prefix_f}/scale", None)),
        (f"{prefix_t}.bias", ("params", f"{prefix_f}/bias", None)),
        (f"{prefix_t}.running_mean", ("batch_stats", f"{prefix_f}/mean", None)),
        (f"{prefix_t}.running_var", ("batch_stats", f"{prefix_f}/var", None)),
    ]


def _convbn(prefix_t: str, prefix_f: str):
    return ([(f"{prefix_t}.conv3d.weight",
              ("params", f"{prefix_f}/conv/kernel", _conv_w))]
            + _bn(f"{prefix_t}.bn", f"{prefix_f}/bn"))


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


KEY_MAPPERS = {"s3dg": lambda: _s3dg_mapping(True),
               "s3d": lambda: _s3dg_mapping(False)}


def _get_path(tree: Mapping, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def variables_to_state_dict(variables: Mapping, arch: str = "s3dg"
                            ) -> Dict[str, np.ndarray]:
    """JAX variables (numpy leaves) -> port state_dict entries (numpy)."""
    if arch not in KEY_MAPPERS:
        raise NotImplementedError(f"no port mapping for arch {arch!r}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    wrapper = "encoder" in params
    pre_t, pre_f = ("encoder.", "encoder/") if wrapper else ("", "")
    out: Dict[str, np.ndarray] = {}
    for key_t, (coll, path_f, conv) in KEY_MAPPERS[arch]():
        tree = params if coll == "params" else stats
        v = np.asarray(_get_path(tree, pre_f + path_f))
        out[pre_t + key_t] = conv(v) if conv is not None else v
    if wrapper:
        for head in ("fc1", "fc2"):
            lin = params[head]["linear"]
            out[f"{head}.linear.weight"] = _dense_w(np.asarray(lin["kernel"]))
            out[f"{head}.linear.bias"] = np.asarray(lin["bias"])
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
