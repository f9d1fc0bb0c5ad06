"""Logging setup: stderr (tqdm-safe) + per-run experiment.log (copy of
rspnet_tpu/framework/logging.py; reference: framework/logging.py:7-41)."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional


class TqdmHandler(logging.StreamHandler):
    """Routes log records through tqdm.write so progress bars stay intact."""

    def emit(self, record):
        try:
            from tqdm import tqdm
            msg = self.format(record)
            tqdm.write(msg)
            self.flush()
        except Exception:
            try:
                super().emit(record)
            except Exception:
                pass

    def handleError(self, record):
        pass


class _SafeFileHandler(logging.FileHandler):
    """Swallows emit errors after interpreter shutdown closes the stream
    (logs from atexit hooks)."""

    def emit(self, record):
        try:
            super().emit(record)
        except Exception:
            pass

    def handleError(self, record):
        pass


def set_logging_basic_config(
    run_dir: Optional[Path] = None,
    debug: bool = False,
    filename: str = "experiment.log",
    level: Optional[int] = None,
) -> None:
    """stderr, and ``run_dir/filename`` when a run dir is given; ``level``
    overrides DEBUG (``debug``) or INFO (the other ranks of a group log
    warnings only)."""
    fmt = "%(asctime)s|%(levelname)-8s|%(message)s"
    if level is None:
        level = logging.DEBUG if debug else logging.INFO

    handlers = [TqdmHandler()]
    if run_dir is not None:
        handlers.append(_SafeFileHandler(Path(run_dir) / filename))

    logging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)


def summary_writer(logdir):
    """A tensorboardX ``SummaryWriter``, or None with a warning when
    tensorboardX is not installed (each training engine asks once)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logging.getLogger(__name__).warning(
            "tensorboardX is not installed: no TensorBoard scalars are "
            "written")
        return None
    return SummaryWriter(logdir=str(logdir))
