"""Checkpoint management with atomic writes (port of
rspnet_tpu/framework/checkpoint.py; reference:
framework/utils/checkpoint.py:13-75).

- the latest checkpoint is written atomically (temp file, then rename)
- ``model_best.pth.tar`` is a hard link to the latest on improvement
- ``checkpoint_epoch_N.pth.tar`` hard links every ``keep_interval`` epochs

Both packages write the same layout: ``model`` holds the JAX package's
nested ``{params, batch_stats}`` trees (``models/convert.py`` turns a
``state_dict`` into them and back), encoded as the JAX package encodes
them (``_to_torch_tree``, rspnet_tpu/framework/checkpoint.py:75-100):
nested dicts of CPU tensors, 0-d leaves kept 0-d. So each package's
``load_state`` reads the other's files. ``optimizer`` stays in the writing
package's own form (a torch ``state_dict`` here, an optax state there).

Reading a file the JAX package wrote never imports JAX: objects of its
classes (the optax state) come back as ``ForeignObject`` tuples, which
the engines refuse to load as an optimizer state.
"""
from __future__ import annotations

import logging
import os
import pickle
import types
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

# top-level modules whose classes are stood in for, never imported
_FOREIGN_ROOTS = {"jax", "jaxlib", "flax", "optax", "chex", "rspnet_tpu"}


def _map_container(obj: Any, fn) -> Any:
    if isinstance(obj, dict):
        return type(obj)((k, fn(v)) for k, v in obj.items())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(fn(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(fn(v) for v in obj)
    return None


def _to_torch_tree(obj: Any) -> Any:
    """numpy leaves -> CPU tensors; ``np.array(copy=True)`` keeps 0-d
    leaves 0-d (``np.ascontiguousarray`` would make them shape (1,))."""
    mapped = _map_container(obj, _to_torch_tree)
    if mapped is not None:
        return mapped
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj, copy=True, order="C"))
    return obj


def _from_torch_tree(obj: Any) -> Any:
    """Tensor leaves -> numpy arrays (the JAX package's view of a file)."""
    mapped = _map_container(obj, _from_torch_tree)
    if mapped is not None:
        return mapped
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


class ForeignObject(tuple):
    """Stands in for an object of a class of JAX, flax, optax or the JAX
    package: its constructor arguments as a tuple, the class's module and
    name as ``foreign_module`` and ``foreign_name``."""
    foreign_module = foreign_name = ""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __init__(self, *args, **kwargs):
        pass


_FOREIGN_CLASSES: Dict[tuple, type] = {}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN_ROOTS:
            key = (module, name)
            if key not in _FOREIGN_CLASSES:
                _FOREIGN_CLASSES[key] = type(
                    name, (ForeignObject,),
                    {"foreign_module": module, "foreign_name": name})
            return _FOREIGN_CLASSES[key]
        return super().find_class(module, name)


# a pickle module for torch.load whose Unpickler stands in for foreign
# classes
_pickle_module = types.ModuleType("rspnet_tpu_torch_pickle")
_pickle_module.__dict__.update(
    {k: getattr(pickle, k) for k in dir(pickle) if not k.startswith("__")})
_pickle_module.Unpickler = _Unpickler


def save_state(state: Dict[str, Any], path: Path) -> None:
    torch.save(_to_torch_tree(state), str(path))


def load_state(path: Path) -> Dict[str, Any]:
    """Load a ``.pth.tar`` onto the CPU (either package's, or the
    reference's); tensors stay tensors."""
    return torch.load(str(path), map_location="cpu", weights_only=False,
                      pickle_module=_pickle_module)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Any,
                         path) -> None:
    """Resume ``optimizer`` from a checkpoint's ``optimizer`` entry; an
    optimizer state that the JAX package wrote raises (a run resumes only
    within the package that wrote it)."""
    if not (isinstance(state, dict) and "param_groups" in state):
        raise ValueError(
            f"{path}: its optimizer state was not written by this package "
            f"(the JAX package writes an optax state); a run resumes only "
            f"within one package. Load its weights with --load-model (or "
            f"--mc for a pretrain checkpoint) instead.")
    optimizer.load_state_dict(state)


class CheckpointManager:
    """Keeps the latest / best / periodic checkpoints for one experiment."""

    def __init__(self, experiment_dir: Path, keep_interval=None,
                 filename: str = "checkpoint.pth.tar", milestone: int = 0):
        self.experiment_dir = Path(experiment_dir)
        self.filename = filename
        self.keep_interval = keep_interval
        self.milestone = milestone

    def save(self, state: Dict[str, Any], is_best: bool, epoch: int) -> None:
        checkpoint_path = self.experiment_dir / self.filename
        temp_path = self.experiment_dir / f".next.{self.filename}"
        logger.info('Saving checkpoint to "%s"', checkpoint_path)
        try:
            save_state(state, temp_path)
        except BaseException:
            if temp_path.exists():
                temp_path.unlink()
            raise
        temp_path.rename(checkpoint_path)

        if is_best:
            best_path = self.experiment_dir / "model_best.pth.tar"
            logger.info('Saving best model to "%s"', best_path)
            if best_path.exists():
                best_path.unlink()
            os.link(checkpoint_path, best_path)

        if (self.keep_interval is not None and epoch % self.keep_interval == 0
                and epoch > self.milestone):
            keep_path = self.experiment_dir / f"checkpoint_epoch_{epoch}.pth.tar"
            logger.info('Keep checkpoint "%s"', keep_path)
            if keep_path.exists():
                keep_path.unlink()
            os.link(checkpoint_path, keep_path)
