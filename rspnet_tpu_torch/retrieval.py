"""Retrieval CLI of the port: frozen-feature video retrieval (mirrors the
root retrieval.py); ``--ws N`` extracts on N ranks (as the pretrain CLI)
and returns None.

    python -m rspnet_tpu_torch.retrieval \
        -c config/retrieval/ucf101_c3d.jsonnet -e EXPDIR [-x EXT ...] [-d] \
        [--device {cuda,cpu}] [--mc PRETRAIN_CKPT | --load-model CKPT] \
        [--seed N]

Extracts the features of the train and test splits with the backbone of a
pretrain checkpoint of either package (``--mc``) or a finetune checkpoint
(``--load-model``), writes them and ``topk_correct.json`` (R@{1,5,10,20,50})
into the run dir and prints the recalls. ``--device`` defaults to cuda
(bf16 compute) and raises when no card is present; ``--device cpu``
computes in f32.
"""
import logging
import sys

logger = logging.getLogger(__name__)


def main(argv=None):
    """-> (the engine, the recalls)"""
    from rspnet_tpu_torch.parallel import launch
    if launch("rspnet_tpu_torch.retrieval", argv):   # --ws N: the N ranks ran
        return None
    from rspnet_tpu_torch.framework import bootstrap
    args, cfg = bootstrap(argv)

    from rspnet_tpu_torch.engines.retrieval import RetrievalEngine
    engine = RetrievalEngine(args, cfg)
    if args.moco_checkpoint:
        engine.load_moco_checkpoint(args.moco_checkpoint)
    elif args.load_model:
        engine.load_model_checkpoint(args.load_model)
    results = engine.run()
    print(results)
    return engine, results


if __name__ == "__main__":
    main(sys.argv[1:])
