"""Finetune CLI of the port: supervised training of a classifier (mirrors
the root finetune.py); ``--ws N`` runs N data-parallel ranks (as the
pretrain CLI) and returns None.

    python -m rspnet_tpu_torch.finetune \
        -c config/finetune/ucf101_s3dg.jsonnet -e EXPDIR [-x EXT ...] [-d] \
        [--device {cuda,cpu}] [--mc PRETRAIN_CKPT] [--load-checkpoint CKPT] \
        [--load-model CKPT] [--seed N] [--validate]

Trains (from a pretrain checkpoint of either package with ``--mc``),
validates every epoch, then runs a final multi-crop validation
(``final_n_crop`` crops) on ``model_best.pth.tar`` in a fresh engine.
``--validate`` runs only the final validation, on ``--load-checkpoint``,
``--load-model`` or ``--mc``. ``--device`` defaults to cuda (bf16 compute)
and raises when no card is present; ``--device cpu`` computes in f32.
"""
import logging
import sys

logger = logging.getLogger(__name__)


def main(argv=None):
    """Train and validate; returns (the training engine, or None under
    ``--validate``; the final validation's metrics)."""
    from rspnet_tpu_torch.parallel import launch
    if launch("rspnet_tpu_torch.finetune", argv):   # --ws N: the N ranks ran
        return None
    from rspnet_tpu_torch.framework import bootstrap
    args, cfg = bootstrap(argv)

    from rspnet_tpu_torch.engines.finetune import FinetuneEngine

    engine = None
    if not args.validate:
        engine = FinetuneEngine(args, cfg, final_validate=False)
        if args.load_checkpoint:
            engine.load_checkpoint(args.load_checkpoint)
        elif args.load_model:
            engine.load_model_only(args.load_model)
        elif args.moco_checkpoint:
            engine.load_moco_checkpoint(args.moco_checkpoint)
        best_acc1 = engine.run()
        logger.info("Training finished. best_acc1=%.2f", best_acc1)

    # final multi-crop validation on the best model (fresh engine,
    # final_n_crop loaders)
    final = FinetuneEngine(args, cfg, final_validate=True)
    best_path = args.experiment_dir / "model_best.pth.tar"
    if args.validate and args.load_checkpoint:
        final.load_model_only(args.load_checkpoint)
    elif args.validate and args.load_model:
        final.load_model_only(args.load_model)
    elif best_path.exists():
        final.load_model_only(best_path)
    elif args.validate and args.moco_checkpoint:
        # validate-only on a pretrained backbone (the classifier is random)
        final.load_moco_checkpoint(args.moco_checkpoint)
        logger.warning("--validate with --mc: classifier head is untrained")
    elif args.validate:
        raise SystemExit(
            "--validate needs a checkpoint: pass --load-checkpoint/"
            f"--load-model/--mc or train first ({best_path} missing)")
    else:
        logger.warning("No checkpoint for final validation (%s)", best_path)
    try:
        result = final.validate_epoch(final.current_epoch, prefix="final")
    finally:
        final.close()
    logger.info("Final validate: acc1=%.2f acc5=%.2f", result["acc1"],
                result["acc5"])
    return engine, result


if __name__ == "__main__":
    main(sys.argv[1:])
