"""Pretraining CLI of the port: MoCo + relative-speed pretraining on one
card (mirrors the root pretrain.py).

    python -m rspnet_tpu_torch.pretrain -c config/pretrain/s3dg.jsonnet \
        -e EXPDIR [-x EXT ...] [-d] [--device {cuda,cpu}] \
        [--load-checkpoint CKPT] [--load-model CKPT] [--seed N] [--validate]

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
