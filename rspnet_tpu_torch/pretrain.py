"""Pretraining CLI of the port: MoCo + relative-speed pretraining on one
card (mirrors the root pretrain.py).

    python -m rspnet_tpu_torch.pretrain -c config/pretrain/s3dg.jsonnet \
        -e EXPDIR [-x EXT ...] [-d] [--device {cuda,cpu}] \
        [--load-checkpoint CKPT] [--load-model CKPT] [--seed N]

``--device`` defaults to cuda and raises when no card is present.
"""
import logging
import sys

logger = logging.getLogger(__name__)


def main(argv=None):
    """Run pretraining; returns the engine (its ``step_times`` and state)."""
    from rspnet_tpu_torch.framework import bootstrap
    args, cfg = bootstrap(argv)
    if args.validate:
        raise NotImplementedError("--validate is not ported yet "
                                  "(see ROADMAP.md)")

    from rspnet_tpu_torch.engines.pretrain import PretrainEngine
    engine = PretrainEngine(args, cfg)
    if args.load_checkpoint:
        engine.load_checkpoint(args.load_checkpoint)
    elif args.load_model:
        engine.load_checkpoint(args.load_model, model_only=True)
    engine.run()
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
