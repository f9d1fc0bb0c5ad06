"""Pretraining CLI of the port: MoCo + relative-speed pretraining
(mirrors the root pretrain.py).

    python -m rspnet_tpu_torch.pretrain -c config/pretrain/s3dg.jsonnet \
        -e EXPDIR [-x EXT ...] [-d] [--device {cuda,cpu}] [--ws N] \
        [--load-checkpoint CKPT] [--load-model CKPT] [--seed N] [--validate]

``--ws N`` runs N data-parallel ranks on this host (``parallel/launch.py``:
one process per card on cuda, gloo ranks on cpu) and returns None; under
``torchrun``, or any group whose environment is set, each process joins
it. A ``parallel: {data: D, model: M}`` block selects the 2-D layout with
the K-sharded queue (D * M ranks).

``--device`` defaults to cuda (bf16 compute) and raises when no card is
present; ``--device cpu`` computes in f32. ``--validate`` loads the
checkpoint or model given, runs one no-grad statistics epoch and returns
without training or writing a checkpoint.
"""
import logging
import sys

logger = logging.getLogger(__name__)


def main(argv=None):
    """Run pretraining, or with ``--validate`` one statistics epoch; returns
    the engine (its ``step_times``, state and meters)."""
    from rspnet_tpu_torch.parallel import launch
    if launch("rspnet_tpu_torch.pretrain", argv):   # --ws N: the N ranks ran
        return None
    from rspnet_tpu_torch.framework import bootstrap
    args, cfg = bootstrap(argv)

    from rspnet_tpu_torch.engines.pretrain import PretrainEngine
    engine = PretrainEngine(args, cfg)
    if args.load_checkpoint:
        engine.load_checkpoint(args.load_checkpoint)
    elif args.load_model:
        engine.load_checkpoint(args.load_model, model_only=True)

    if args.validate:
        logger.info("--validate: running a single no-grad statistics epoch")
        try:
            engine.validate_epoch()
        finally:
            engine.close()
        return engine

    engine.run()
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
