"""Shared CLI bootstrap (port of rspnet_tpu/framework/bootstrap.py): parse
args, prepare the run dir, pack the code into it, load and save the
config, seed the host RNGs.

When --seed is omitted, ONE random seed is drawn here and recorded in
args.seed and the saved config, so the run is reproducible from its
config.json.
"""
from __future__ import annotations

import logging
import random

import numpy as np
import torch

logger = logging.getLogger(__name__)


def initialize_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def bootstrap(argv=None):
    """-> (args, cfg)"""
    from ..config import get_config, save_config
    from .arguments import Args
    from .code_pack import pack_code
    from .environment import ulimit_n_max
    from .logging import set_logging_basic_config

    args = Args.from_args(argv)
    args.resolve_continue()        # --continue can supply the config
    if args.config is None:
        raise SystemExit("a config file is required (-c)")
    args.make_run_dir()
    if args.run_dir is None:
        raise SystemExit("an experiment dir is required (-e)")
    args.save()
    set_logging_basic_config(args.run_dir, debug=args.debug)
    pack_code(args.run_dir)
    ulimit_n_max()

    if args.seed is None:
        args.seed = random.SystemRandom().randrange(2 ** 31)
        logger.info("no --seed given: drew %d (recorded in config.json)",
                    args.seed)

    cfg = get_config(args)
    cfg.put("seed", args.seed)
    save_config(args, cfg)
    initialize_seed(args.seed)
    return args, cfg
