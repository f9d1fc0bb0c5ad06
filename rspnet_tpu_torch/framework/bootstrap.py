"""Shared CLI bootstrap (port of rspnet_tpu/framework/bootstrap.py): parse
args, join the process group, prepare the run dir, pack the code into it,
load and save the config, seed the host RNGs.

When --seed is omitted, ONE random seed is drawn here and recorded in
args.seed and the saved config, so the run is reproducible from its
config.json. Under ``--ws N`` rank 0 draws it and picks the run dir, and
every rank takes both; rank 0 alone writes the run dir (``run.sh``,
``config.json``, the code pack, ``experiment.log``) while the others
wait, and the other ranks log warnings only.
"""
from __future__ import annotations

import logging
import random

import torch.distributed as dist

from .reproduction import initialize_seed

logger = logging.getLogger(__name__)


def bootstrap(argv=None, args_class=None):
    """-> (args, cfg); ``args_class`` parses ``argv`` (default ``Args``)."""
    from ..config import get_config, save_config
    from ..parallel import barrier, get_rank, init_distributed, world_size
    from .arguments import Args
    from .code_pack import pack_code
    from .environment import ulimit_n_max
    from .logging import set_logging_basic_config

    args = (args_class or Args).from_args(argv)
    init_distributed(args.device)
    rank = get_rank()
    args.resolve_continue()        # --continue can supply the config
    if args.config is None:
        raise SystemExit("a config file is required (-c)")
    if args.experiment_dir is None:
        raise SystemExit("an experiment dir is required (-e)")
    drawn = args.seed is None
    if drawn:
        args.seed = random.SystemRandom().randrange(2 ** 31)
    if world_size() > 1:
        shared = [args.run_dir, args.seed]
        dist.broadcast_object_list(shared, src=0)
        args._run_dir, args.seed = shared
    if rank == 0:
        args.make_run_dir()
        args.save()
    barrier()
    set_logging_basic_config(args.run_dir if rank == 0 else None,
                             debug=args.debug,
                             level=None if rank == 0 else logging.WARNING)
    if rank == 0:
        pack_code(args.run_dir)
    ulimit_n_max()
    if drawn:
        logger.info("no --seed given: drew %d (recorded in config.json)",
                    args.seed)

    cfg = get_config(args)
    cfg.put("seed", args.seed)
    if rank == 0:
        save_config(args, cfg)
    barrier()
    initialize_seed(args.seed, rank)
    return args, cfg
