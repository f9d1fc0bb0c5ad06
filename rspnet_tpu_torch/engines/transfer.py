"""Checkpoint transfer surgery for ``--mc`` (port of
rspnet_tpu/engines/transfer.py; reference: finetune.py:273-310 strips
'encoder_q.', then drops the classifier keys).

``load_pretrained_encoder`` reads three dialects into a ``state_dict`` of
the backbone:

- a pretrain checkpoint of either package: ``model.params_q.encoder`` and
  ``model.batch_stats_q.encoder`` as nested JAX-layout trees, converted by
  ``models/convert.py``;
- a reference MoCo checkpoint: flat torch keys ``encoder_q.encoder.*``.
  The port's backbones carry the reference's module names, so this is a
  prefix strip that drops the classifier keys (``_BLACKLIST``,
  transfer.py:23);
- a third-party torch state dict (``state_dict``, optional ``module.``).

``merge_encoder_into`` loads it into a ``MultiTaskWrapper``'s encoder and
keeps the freshly built model's ``fc`` (transfer.py:70-90).
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..framework.checkpoint import _from_torch_tree, load_state
from ..models.convert import variables_to_state_dict

logger = logging.getLogger(__name__)

_BLACKLIST = ("fc.", "linear", "head", "new_fc", "fc8", "encoder_fuse")


def load_pretrained_encoder(path, arch: str) -> Dict[str, np.ndarray]:
    """-> the backbone's state_dict entries (numpy), no classifier."""
    cp = load_state(path)
    if isinstance(cp, dict) and "model" in cp and "arch" in cp:
        m = cp["model"]
        if isinstance(m, dict) and "params_q" in m:
            logger.info("Loading MoCo checkpoint from %s (epoch %s)", path,
                        cp.get("epoch"))
            return variables_to_state_dict(
                {"params": m["params_q"]["encoder"],
                 "batch_stats": m["batch_stats_q"]["encoder"]}, arch)
        logger.info("Loading reference MoCo checkpoint from %s (epoch %s)",
                    path, cp.get("epoch"))
        return _from_torch_flat(m, prefix="encoder_q.encoder.")
    logger.info("Loading third-party model from %s", path)
    state = cp.get("state_dict", cp) if isinstance(cp, dict) else cp
    first_key = next(iter(state.keys()))
    prefix = "module." if first_key.startswith("module") else ""
    return _from_torch_flat(state, prefix=prefix)


def _from_torch_flat(state: dict, prefix: str) -> Dict[str, np.ndarray]:
    def keep(k: str) -> bool:
        if not k.startswith(prefix):
            return False
        rest = k[len(prefix):]
        return not any(rest.startswith(b) for b in _BLACKLIST)

    stripped = {k[len(prefix):]: _from_torch_tree(v)
                for k, v in state.items() if keep(k)}
    if not stripped:
        raise ValueError(
            f"No backbone weights found under prefix {prefix!r}")
    return stripped


def merge_encoder_into(model: nn.Module, encoder_state: Dict) -> None:
    """Load a backbone state_dict into ``model.encoder`` (a finetune
    ``MultiTaskWrapper``); its ``fc`` stays as built. Backbone entries the
    file lacks keep their fresh values, with a warning (the reference
    loads with strict=False)."""
    enc = model.encoder
    sd = enc.state_dict()
    missing = [k for k in sd if k not in encoder_state
               and not k.endswith("num_batches_tracked")]
    if missing:
        logger.warning("Missing backbone keys: %s", missing)
    unused = [k for k in encoder_state if k not in sd]
    if unused:
        logger.warning("Unused checkpoint keys: %s", unused)
    for k, v in encoder_state.items():
        if k not in sd:
            continue
        v = torch.as_tensor(np.asarray(v))
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: {tuple(v.shape)} != {tuple(sd[k].shape)}")
        sd[k] = v.to(sd[k].dtype)
    enc.load_state_dict(sd)
