"""CLI arguments and run-directory management (port of
rspnet_tpu/framework/arguments.py, plus ``--device``).

Mirrors the reference CLI contract (reference: framework/arguments.py,
arguments.py): ``-c/-x/-d/-e``, ``--load-checkpoint/--load-model/--validate/
--mc/--seed/--ws/--continue/--no-scale-lr``, run dirs named
``run_<N>_<timestamp>`` under the experiment dir, a ``run.sh`` replay script,
and ``resolve_continue`` picking up the latest run's config + checkpoint.

Implemented on plain argparse (the ``typed_args`` dependency is not used).
"""
from __future__ import annotations

import argparse
import logging
import os
import re
import shutil
import sys
import time
from pathlib import Path
from shlex import quote
from typing import List, Optional

logger = logging.getLogger(__name__)


def get_timestamp(fmt: str = "%Y%m%d_%H%M%S") -> str:
    return time.strftime(fmt, time.localtime())


class BaseArgs:
    """Base experiment arguments (reference: framework/arguments.py:21-100)."""

    RUN_DIR_NAME_REGEX = re.compile(r"^run_(\d+)_")

    def __init__(self):
        self.config: Optional[str] = None
        self.ext_config: List[str] = []
        self.debug: bool = False
        self.experiment_dir: Optional[Path] = None
        self._run_dir: Optional[Path] = None
        self.yes: bool = False

    # -- parser ------------------------------------------------------------
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("-c", "--config", help="path to config")
        parser.add_argument("-x", "--ext-config", nargs="*", default=[],
                            dest="ext_config", help="Extra jsonnet config")
        parser.add_argument("-d", "--debug", action="store_true", help="debug flag")
        parser.add_argument("-e", "--experiment-dir", dest="experiment_dir",
                            nargs=argparse.OPTIONAL, type=Path,
                            const=Path("temp") / get_timestamp(),
                            help="experiment dir")
        parser.add_argument("--run-dir", dest="_run_dir", type=Path)
        parser.add_argument("-y", "--yes", action="store_true",
                            help="assume yes for interactive prompts")

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "BaseArgs":
        parser = argparse.ArgumentParser()
        cls.add_arguments(parser)
        ns = parser.parse_args(argv)
        args = cls()
        for k, v in vars(ns).items():
            setattr(args, k, v)
        return args

    # -- run dir -----------------------------------------------------------
    @property
    def run_dir(self) -> Optional[Path]:
        if self.experiment_dir is not None and self._run_dir is None:
            run_id = -1
            if self.experiment_dir.exists():
                for prev in self.experiment_dir.iterdir():
                    m = self.RUN_DIR_NAME_REGEX.match(prev.name)
                    if m is not None:
                        run_id = max(int(m.group(1)), run_id)
            run_id += 1
            self._run_dir = self.experiment_dir / f"run_{run_id}_{get_timestamp()}"
        return self._run_dir

    def make_run_dir(self) -> None:
        if self.experiment_dir is not None:
            self.experiment_dir.mkdir(parents=True, exist_ok=True)
            if not self._confirm_replace(self.run_dir):
                raise EnvironmentError(f'Run dir "{self.run_dir}" exists')
            self.run_dir.mkdir(parents=True, exist_ok=False)

    def _confirm_replace(self, path: Path) -> bool:
        if not path.exists():
            return True
        if self.yes or not sys.stdin.isatty():
            shutil.rmtree(path)
            return True
        print(f"File exists: {path}\nDo you want to remove it and create a new one?")
        choice = input("Remove older directory? [y]es/[n]o: ")
        if choice in ("y", "yes"):
            shutil.rmtree(path)
            return True
        return False

    def save(self) -> None:
        """Write run.sh so the exact invocation can be replayed
        (reference: framework/arguments.py:50-58)."""
        with open(self.run_dir / "run.sh", "w") as f:
            f.write(f"cd {quote(os.getcwd())}\n")
            for env in ("CUDA_VISIBLE_DEVICES",):
                value = os.environ.get(env)
                if value is not None:
                    f.write(f"export {env}={quote(value)}\n")
            f.write(sys.executable + " " +
                    " ".join(quote(a) for a in sys.argv) + "\n")


class Args(BaseArgs):
    """Workload arguments shared by pretrain/finetune/retrieval entry points
    (reference: arguments.py:25-85)."""

    def __init__(self):
        super().__init__()
        self.load_checkpoint: Optional[Path] = None
        self.load_model: Optional[Path] = None
        self.validate: bool = False
        self.moco_checkpoint: Optional[str] = None
        self.seed: Optional[int] = None
        self.world_size: int = 1
        self.device: str = "cuda"
        self._continue: bool = False
        self.no_scale_lr: bool = False

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        super().add_arguments(parser)
        parser.add_argument("--load-checkpoint", type=Path,
                            help="checkpoint to fully resume from")
        parser.add_argument("--load-model", type=Path,
                            help="checkpoint to load model weights from")
        parser.add_argument("--validate", action="store_true",
                            help="Only run final validate then exit")
        parser.add_argument("--mc", "--moco-checkpoint",
                            dest="moco_checkpoint",
                            help="load moco pretrained checkpoint")
        parser.add_argument("--seed", type=int, help="random seed")
        parser.add_argument("--ws", "--world-size", dest="world_size",
                            type=int, default=1,
                            help="data-parallel ranks: one process per "
                                 "card on cuda (capped at the cards), "
                                 "gloo ranks on cpu; inside a group that "
                                 "the environment describes (WORLD_SIZE, "
                                 "RANK, ...) the process joins it")
        parser.add_argument("--device", choices=("cuda", "cpu"),
                            default="cuda",
                            help="device to train on; cuda raises when no "
                                 "card is present")
        parser.add_argument("--continue", dest="_continue", action="store_true",
                            help="Use previous config and checkpoint")
        parser.add_argument("--no-scale-lr", action="store_true",
                            help="Do not scale lr with global batch size")

    def resolve_continue(self) -> None:
        if not self._continue:
            return
        if not self.experiment_dir.exists():
            raise EnvironmentError(
                f'Experiment directory "{self.experiment_dir}" does not exist.')
        if self.config is None:
            run_id = -1
            for run in self.experiment_dir.iterdir():
                m = self.RUN_DIR_NAME_REGEX.match(run.name)
                if m is not None and run.is_dir():
                    this_id = int(m.group(1))
                    cfg_path = run / "config.json"
                    if this_id > run_id and cfg_path.exists():
                        run_id = this_id
                        self.config = str(cfg_path)
            if self.config is None:
                raise EnvironmentError("No previous run config found")
            logger.info('Continue using previous config: "%s"', self.config)
        if self.load_checkpoint is None:
            ckpt = self.experiment_dir / "checkpoint.pth.tar"
            if ckpt.exists():
                self.load_checkpoint = ckpt
                logger.info('Continue using previous checkpoint: "%s"', ckpt)
            else:
                logger.warning("No previous checkpoint found")
