"""Provenance: archive the exact code of a run (copy of
rspnet_tpu/framework/code_pack.py; reference: framework/utils/code_pack.py:
9-24)."""
from __future__ import annotations

import logging
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)


def pack_code(run_dir: Path) -> None:
    """Write code.tar.gz (HEAD) and dirty.patch (uncommitted diff) of the
    git repository of the working directory; outside one only warn."""
    run_dir = Path(run_dir)
    try:
        with open(run_dir / "code.tar.gz", "wb") as f:
            subprocess.run(["git", "archive", "--format=tar.gz", "HEAD"],
                           stdout=f, check=True)
        with open(run_dir / "dirty.patch", "wb") as f:
            subprocess.run(["git", "diff", "HEAD"], stdout=f, check=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("pack_code failed (not a git repo?): %s", e)
