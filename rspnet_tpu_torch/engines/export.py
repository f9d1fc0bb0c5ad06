"""Export a pretrain checkpoint to the reference torch layout (port of
rspnet_tpu/engines/export.py).

The reference's finetune.py expects flat torch state dicts with
``encoder_q.encoder.*`` / ``encoder_q.fc{1,2}.*`` keys inside ``{'model',
'arch', 'epoch'}`` (reference: finetune.py:277, retrieval.py:88). Both
packages' checkpoints hold the JAX layout (``framework/checkpoint.py``);
the backbone's reference names are those of ``models/convert.py``'s
mappings, which are the port's own ``state_dict`` names. This module adds
the wrapper's prefixes, the heads at the reference's Sequential indices
and the queue buffers.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

from ..framework.checkpoint import load_state, save_state
from ..models import convert

logger = logging.getLogger(__name__)


def _backbone_to_torch(variables: Mapping, arch: str) -> Dict[str, np.ndarray]:
    """A backbone's JAX trees -> its reference torch entries; an entry the
    trees lack is left out (torch_bridge.flax_to_torch)."""
    if arch not in convert.KEY_MAPPERS:
        raise NotImplementedError(
            f"No torch checkpoint mapping for arch {arch!r}; mapped archs: "
            f"{sorted(convert.KEY_MAPPERS)}")
    out = {}
    for key_t, (coll, path_f, conv) in convert.KEY_MAPPERS[arch]():
        try:
            v = convert._numpy(convert._get_path(variables[coll], path_f))
        except KeyError:
            continue
        out[key_t] = conv(v) if conv is not None else v
    return out


def _head_to_torch(head_params: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """A linear or mlp pretraining head -> the reference's Sequential: the
    linear head is Sequential(AvgPool, Flatten, Linear), its Linear at
    index 2 (reference: split_wrapper.py:163-169); the mlp head has its
    Linears at 2 and 4 (:171-179). Other heads are skipped."""
    layers = {frozenset({"linear"}): ("linear",),
              frozenset({"hidden", "linear"}): ("hidden", "linear")}
    names = layers.get(frozenset(head_params))
    if names is None:
        logger.warning("Unrecognized head layout %s; skipping %s",
                       sorted(head_params), prefix)
        return {}
    out = {}
    for index, name in zip((2, 4), names):
        dense = head_params[name]
        out[f"{prefix}.{index}.weight"] = convert._dense_w(
            convert._numpy(dense["kernel"]))
        out[f"{prefix}.{index}.bias"] = convert._numpy(dense["bias"])
    return out


def export_reference_checkpoint(src: Path, dst: Path,
                                arch: str = None) -> dict:
    """Convert a pretrain checkpoint of either package to the reference
    torch format: ``{'epoch', 'arch', 'model': flat state dict with
    encoder_q. / encoder_k. prefixes and the queue buffers, 'best_loss'}``,
    written to ``dst`` and returned."""
    cp = load_state(src)
    if not (isinstance(cp.get("model"), dict) and "params_q" in cp["model"]):
        raise ValueError(f"{src} is not a pretrain checkpoint")
    arch = arch or cp["arch"]
    m = cp["model"]

    flat: Dict[str, np.ndarray] = {}
    for enc, params_key, stats_key in (
            ("encoder_q", "params_q", "batch_stats_q"),
            ("encoder_k", "params_k", "batch_stats_k")):
        variables = {"params": m[params_key]["encoder"],
                     "batch_stats": m[stats_key]["encoder"]}
        for k, v in _backbone_to_torch(variables, arch).items():
            flat[f"{enc}.encoder.{k}"] = v
        for head in ("fc1", "fc2"):
            if head in m[params_key]:
                flat.update(_head_to_torch(m[params_key][head],
                                           f"{enc}.{head}"))

    flat["queue"] = convert._numpy(m["queue"])
    # the reference registers queue_ptr as torch.zeros(1)
    # (moco/builder.py:361): shape (1,) however the checkpoint holds it
    flat["queue_ptr"] = np.reshape(
        convert._numpy(m["queue_ptr"]).astype(np.int64), (1,))

    out = {
        "epoch": cp.get("epoch", 0),
        "arch": arch,
        "model": flat,
        "best_loss": cp.get("best_loss", float("inf")),
    }
    save_state(out, dst)
    logger.info("Exported reference-format checkpoint: %s (%d tensors)",
                dst, len(flat))
    return out
