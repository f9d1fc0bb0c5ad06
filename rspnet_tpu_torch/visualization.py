"""CAM visualization CLI of the port on one card (mirrors the root
visualization.py).

    python -m rspnet_tpu_torch.visualization \
        -c config/pretrain/s3dg.jsonnet -e EXPDIR [-x EXT ...] [-d] \
        [--device {cuda,cpu}] [--mc PRETRAIN_CKPT] [--seed N]

Renders the class activation maps of both pretext heads for the query and
key clips of a pretrain checkpoint of either package (``--mc``) into
``cam/*.png`` in the run dir. Computes in f32 on either device;
``--device`` defaults to cuda and raises when no card is present.
"""
import logging
import sys

logger = logging.getLogger(__name__)


def main(argv=None):
    """-> the engine, after it rendered its batches (``engine.n_saved``
    PNGs)."""
    from rspnet_tpu_torch.framework import bootstrap
    args, cfg = bootstrap(argv)

    from rspnet_tpu_torch.engines.visualization import VisualizationEngine
    engine = VisualizationEngine(args, cfg)
    if args.moco_checkpoint:
        engine.load_moco_checkpoint(args.moco_checkpoint)
    engine.n_saved = engine.visual_epoch()
    logger.info("CAM visualization done (%d images)", engine.n_saved)
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
