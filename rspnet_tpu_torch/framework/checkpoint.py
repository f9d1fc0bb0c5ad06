"""Checkpoint management with atomic writes (port of
rspnet_tpu/framework/checkpoint.py; reference:
framework/utils/checkpoint.py:13-75).

- the latest checkpoint is written atomically (temp file, then rename)
- ``model_best.pth.tar`` is a hard link to the latest on improvement
- ``checkpoint_epoch_N.pth.tar`` hard links every ``keep_interval`` epochs

The files hold plain torch objects (state_dicts, tensors, numbers).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict

import torch

logger = logging.getLogger(__name__)


def save_state(state: Dict[str, Any], path: Path) -> None:
    torch.save(state, str(path))


def load_state(path: Path) -> Dict[str, Any]:
    """Load a ``.pth.tar`` onto the CPU."""
    return torch.load(str(path), map_location="cpu", weights_only=False)


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
