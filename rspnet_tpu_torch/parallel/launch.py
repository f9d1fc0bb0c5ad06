"""``--ws N``: start N ranks of a CLI on this host (the reference spawned
one process per GPU on a free local port, pretrain.py:278-283, 336).

Each rank re-runs the same module with the same arguments and the
standard environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), which ``parallel.init_distributed`` reads. When
that environment is already set (``torchrun``, or a rank of this
launcher), the process joins its group instead of starting ranks.
"""
from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

logger = logging.getLogger(__name__)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranks_to_start(world_size: int, device: str) -> int:
    """``--ws`` capped at the cards on ``cuda`` (as ``mesh_for_args`` caps
    at ``jax.device_count()``); 0 inside a group the environment already
    describes."""
    if "WORLD_SIZE" in os.environ:
        return 0
    n = max(1, int(world_size))
    if device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        if 0 < cards < n:
            logger.warning("--ws %d capped at the %d card(s) of this host",
                           n, cards)
            n = cards
    return n


def spawn(module: str, argv: List[str], n: int) -> int:
    """Run ``python -m module argv`` as ranks 0..n-1 of one group on a free
    port; returns the first failing rank's exit code (0 if all succeed).
    When a rank fails the others are stopped: they would wait in their
    next collective."""
    port = free_port()
    procs = []
    base = dict(os.environ)
    # n processes share the host's cores (torchrun's default is one)
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // n)))
    try:
        for rank in range(n):
            rank_env = dict(base, MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), WORLD_SIZE=str(n),
                            RANK=str(rank), LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=rank_env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launch(module: str, argv: Optional[List[str]]) -> bool:
    """In a CLI's ``main``: with ``--ws N > 1`` outside a group, run the N
    ranks and return True (raising ``SystemExit`` with a failing rank's
    code); otherwise return False and let this process run."""
    from ..framework.arguments import Args

    argv = list(sys.argv[1:] if argv is None else argv)
    args = Args.from_args(argv)
    n = ranks_to_start(args.world_size, args.device)
    if n <= 1:
        return False
    code = spawn(module, argv, n)
    if code:
        raise SystemExit(code)
    return True
