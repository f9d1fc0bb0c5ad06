"""Frozen-feature video retrieval on one card (port of
rspnet_tpu/engines/retrieval.py; reference: retrieval.py:36-185).

Extract the backbone's global-average-pooled features of the train and test
splits (each clip the mean over its ``final_n_crop`` temporal crops), save
them as ``.npy`` and compute R@{1,5,10,20,50} by cosine similarity: a test
clip is a hit at k if one of its k nearest train clips shares its label.

  host loader (decode [+ geometry], uint8, ``final_n_crop`` crops in time)
    -> ``ops.augment.eval_preprocess`` (crop box, bilinear resize,
       normalize; no colour jitter in either split, the JAX engine's
       stated deviation from the reference)
    -> ``crop_features``: the backbone in eval mode (K1 at every pool),
       global average pool, crop mean
    -> ``topk_retrieval`` in numpy on the host

With ``device_geometry`` the train split's crop boxes are Inception crops
drawn from ``np.random.default_rng(seed or 0)`` by ``sample_crop_box``,
clip by clip, as the JAX engine draws them, so one seed gives both packages
the same boxes; the test split takes the centre max crop.

Compute dtype from the device (``framework/environment.py:
resolve_runtime``), as the JAX engine takes it from its platform
(retrieval.py:45-47): bf16 on the card, f32 on the CPU. In bf16
the pooled features and their crop mean are rounded to bf16 where
``jnp.mean`` rounds them. Deviation (file dtype only): the JAX engine on
its accelerator saves those bf16 arrays and ranks them in numpy as bf16;
this engine saves and ranks them as f32 arrays, which hold the same values
exactly.

``model_type`` ``multitask`` takes the features of the wrapper's
encoder, ``1stream`` those of the bare backbone (its classifier unused),
as the JAX engine's ``method="features"`` does (retrieval.py:93).

More than one card (``--ws N``): each rank extracts its rows of every
global batch (``batch_multiplier = world``), and the features, the masks
and the labels come back to every rank through ``fetch_global`` in rank
order (retrieval.py:160-171), so R@k is the same on every rank; rank 0
writes the files. The train split's crop boxes are drawn for the whole
global batch on every rank and each takes its rows, so a run's boxes do
not depend on the number of ranks (the JAX engine's one-process mesh).

``cache_device`` (``data/device_cache.py``) serves both splits' clips
from the card. Not ported (raises NotImplementedError): the 2-D
``parallel:`` layout.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ConfigTree
from ..data.device_cache import clip_to_device
from ..data.pipeline import build_loader
from ..framework import load_state
from ..framework.environment import resolve_runtime
from ..models.common import global_avg_pool
from ..models.convert import load_variables
from ..moco import MultiTaskWrapper
from ..ops.augment import eval_preprocess, sample_crop_box
from ..parallel import fetch_global, mesh_for_args
from .classifier import _mean
from .finetune import _unsupported, build_classifier_model
from .geometry import clip_geometry
from .normalization import dataset_normalization
from .transfer import load_pretrained_encoder, merge_encoder_into

logger = logging.getLogger(__name__)

TOPK = (1, 5, 10, 20, 50)


@torch.no_grad()
def crop_features(model, clips: torch.Tensor, n_crop: int) -> torch.Tensor:
    """[B, n_crop*T, S, S, 3] -> [B, feature_dim]: the backbone's feature
    map per crop (the model in eval mode; a ``MultiTaskWrapper``'s
    encoder, or the ``1stream`` backbone itself), its global average, the
    mean over crops, in the compute dtype (retrieval.py:85-97)."""
    B = clips.shape[0]
    x = clips
    if n_crop > 1:
        T = clips.shape[1] // n_crop
        x = clips.reshape((B * n_crop, T) + tuple(clips.shape[2:]))
    backbone = model.encoder if isinstance(model, MultiTaskWrapper) else model
    f = global_avg_pool(backbone.features(x.permute(0, 4, 1, 2, 3)))
    if n_crop > 1:
        f = _mean(f.reshape(B, n_crop, -1), dim=1)
    return f


def topk_retrieval(train_feats, train_labels, test_feats, test_labels,
                   topk=TOPK) -> dict:
    """Cosine retrieval R@k in percent (retrieval.py:190-208, numpy on the
    host; ties in similarity take ``np.argsort``'s order, as there)."""
    def norm(x):
        return x / np.maximum(
            np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    sim = norm(test_feats) @ norm(train_feats).T   # [n_test, n_train]
    order = np.argsort(-sim, axis=1)
    results = {}
    hits = np.zeros(len(test_labels), bool)
    prev = 0
    for k in sorted(topk):
        newcols = train_labels[order[:, prev:k]]
        hits |= (newcols == test_labels[:, None]).any(axis=1)
        results[f"R@{k}"] = float(hits.mean() * 100.0)
        prev = k
    return results


class RetrievalEngine:
    def __init__(self, args, cfg: ConfigTree):
        self.args = args
        self.cfg = cfg
        self.debug = bool(getattr(args, "debug", False))
        _unsupported(cfg, args)
        self.device, self.dtype = resolve_runtime(
            getattr(args, "device", "cuda"))
        # the train split's crop boxes under device geometry
        # (retrieval.py:42-43)
        self._crop_rng = np.random.default_rng(
            getattr(args, "seed", None) or 0)

        self.mesh = mesh_for_args(args)
        torch.manual_seed(cfg.get_int("seed", 0))
        model, self.model_type = build_classifier_model(cfg, self.dtype)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last_3d).eval()
        self.arch = cfg.get_string("model.arch")

        # EvenNCrop(final_n_crop) on both splits (force_n_crop)
        world = self.mesh.size
        self.train_loader = build_loader(cfg, "train", final_validate=True,
                                         batch_multiplier=world,
                                         device=self.device)
        self.test_loader = build_loader(cfg, "val", final_validate=True,
                                        batch_multiplier=world,
                                        device=self.device)
        tt = cfg.get_config("temporal_transforms")
        self.n_crop = tt.get_int("validate.final_n_crop", 10)
        self.size = cfg.get_int("spatial_transforms.size")
        # the classification pipeline normalizes under --debug too
        self.normalize = dataset_normalization(cfg)
        # host-clock ms of each extraction batch, ended by the copy of its
        # features to the host
        self.batch_times = []

    def load_moco_checkpoint(self, path) -> None:
        """``--mc``: the backbone from a pretrain checkpoint of either
        package or of the reference; the classifier stays as built
        (unused)."""
        merge_encoder_into(self.model, load_pretrained_encoder(path,
                                                               self.arch),
                           self.model_type)

    def load_model_checkpoint(self, path) -> None:
        """``--load-model``: a finetune checkpoint of either package."""
        m = load_state(path)["model"]
        load_variables(self.model, {"params": m["params"],
                                    "batch_stats": m["batch_stats"]},
                       self.arch)

    def _boxes(self, loader, B: int, H: int, W: int) -> np.ndarray:
        """Crop boxes of this rank's B rows (retrieval.py:143-161)."""
        geom = clip_geometry(loader.cfg, (B, H, W), self.size)
        if not (geom.on_device and loader.cfg.train):
            return geom.eval_boxes()
        boxes = np.stack([np.asarray(
            sample_crop_box(self._crop_rng, H, W, geom.crop_area),
            np.float32) for _ in range(B * self.mesh.size)])
        r = self.mesh.rank
        return boxes[r * B:(r + 1) * B]

    def extract_features(self, loader, name: str):
        """-> (features [n, feature_dim] f32, labels [n]) of the split's
        unpadded clips."""
        feats, labels = [], []
        t0 = time.perf_counter()
        mean, std = self.normalize
        it = iter(loader)
        try:
            for i, batch in enumerate(it):
                t_batch = time.perf_counter()
                clip_u8 = batch["clips"][0]
                B, _, H, W, _ = clip_u8.shape
                clips = eval_preprocess(
                    clip_to_device(clip_u8, self.device),
                    self._boxes(loader, B, H, W),
                    size=(self.size, self.size), mean=mean, std=std)
                f = crop_features(self.model, clips, self.n_crop)
                # every rank's rows, on every rank
                f = fetch_global(f.float(), self.mesh)
                self.batch_times.append(
                    (time.perf_counter() - t_batch) * 1000.0)
                mask = fetch_global(batch["mask"], self.mesh)
                feats.append(f[mask])
                labels.append(fetch_global(batch["labels"], self.mesh)[mask])
                if self.debug and i >= 2:
                    break
        finally:
            # an early break must not leave the loader's worker pool
            # suspended
            close = getattr(it, "close", None)
            if close is not None:
                close()
        feats = np.concatenate(feats)
        labels = np.concatenate(labels)
        logger.info("%s features: %s in %.1fs", name, feats.shape,
                    time.perf_counter() - t0)
        return feats, labels

    def save_features(self, out_dir: Path, feats, labels, split: str):
        """The reference's names ({split}_fold{fold}_feats.npy,
        {split}_fold{fold}_labels.npy) and the JAX package's aliases
        ({split}_feature.npy, {split}_class.npy) (retrieval.py:177-188)."""
        out_dir = Path(out_dir)
        fold = self.cfg.get_int("dataset.fold", 1)
        np.save(out_dir / f"{split}_fold{fold}_feats.npy", feats)
        np.save(out_dir / f"{split}_fold{fold}_labels.npy", labels)
        np.save(out_dir / f"{split}_feature.npy", feats)
        np.save(out_dir / f"{split}_class.npy", labels)

    def run(self) -> dict:
        train_f, train_l = self.extract_features(self.train_loader, "train")
        test_f, test_l = self.extract_features(self.test_loader, "test")
        results = topk_retrieval(train_f, train_l, test_f, test_l)
        if self.mesh.rank == 0:
            out_dir = Path(self.args.run_dir)
            self.save_features(out_dir, train_f, train_l, "train")
            self.save_features(out_dir, test_f, test_l, "test")
            with open(out_dir / "topk_correct.json", "w") as f:
                json.dump(results, f, indent=2)
        logger.info("Retrieval: %s", results)
        return results
