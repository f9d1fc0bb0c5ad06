"""Supervised finetune engine on one card (port of
rspnet_tpu/engines/finetune.py; reference: finetune.py:149-472).

Train and per-epoch validation, then (the CLI) a final multi-crop
validation on ``model_best``. The hot loop:

  host loader (decode [+ geometry], uint8)
    -> device augment (ops.augment.augment_batch: crop_resize + kernel K3,
       gray before the jitter, no blur)
    -> classifier train step (engines.classifier: S3D-G through K1/K2)

Validation: the centre crop and normalize (ops.augment.eval_preprocess,
plain torch) and the eval step (K1 only); multi-crop clips arrive
time-concatenated and the step averages the logits over crops.

Compute dtype from the device, as in engines/pretrain.py: bf16 on the
card (the JAX engine's choice on its accelerator, finetune.py:65-67), f32
on the CPU. Parameters, BN statistics, the optimizer state and the
checkpoints stay f32.

Checkpoints: ``epoch, arch, model {params, batch_stats}, best_acc1,
optimizer, scheduler``, the JAX engine's layout (finetune.py:373-384)
with the torch optimizer state, so the JAX package's ``load_model_only``
reads them; this engine reads the JAX package's files the same way.

``model_type`` ``multitask`` trains a ``MultiTaskWrapper`` (backbone and
``fc``), ``1stream`` the backbone with its own classifier; S3D-G's dropout
draws its masks from the engine's ``torch.Generator`` (seed + 1).

More than one card (``--ws N``, rspnet_tpu/engines/finetune.py:62-126):
the 1-D data mesh; each rank trains on its rows of the global batch
(``batch_multiplier = world``), the gradients, the loss and the metrics
averaged over the group, every ``BatchNorm`` with cross-replica moments
(precise-BN included). The lr is not scaled with the world, as in the
JAX engine. Validation shards each global batch over the ranks and sums
the masked sums, so the padded tail of the last batch counts nowhere
(:313-330). Each rank draws its augment parameters from seed + rank and
its dropout masks from seed + 1 + rank; ``--mc`` and every checkpoint
load on every rank; rank 0 alone writes checkpoints and TensorBoard.

``cache_device`` (``data/device_cache.py``) serves the clips from the
card, as in the pretrain engine. Not ported (raises NotImplementedError):
the 2-D ``parallel:`` layout (the JAX engine builds a 1-D mesh).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import ConfigTree
from ..data.device_cache import clip_to_device
from ..data.pipeline import build_loader, prefetch_iterator
from ..framework import CheckpointManager, MeterGroup, MetricSpool, load_state
from ..framework.checkpoint import load_optimizer_state
from ..framework.logging import summary_writer
from ..framework.lr_schedule import (build_optimizer, build_scheduler,
                                     set_opt_lr)
from ..models import get_model_class
from ..models.common import set_bn_process_group
from ..models.convert import load_variables, state_dict_to_variables
from ..moco import MultiTaskWrapper
from ..ops.augment import (augment_batch, center_crop_params, eval_preprocess,
                           sample_train_params)
from ..parallel import barrier, mesh_for_args
from . import classifier
from .normalization import dataset_normalization
from .pretrain import resolve_device
from .transfer import load_pretrained_encoder, merge_encoder_into

logger = logging.getLogger(__name__)

TRAIN_KEYS = ("loss", "acc1", "acc5")
SUM_KEYS = ("loss_sum", "correct1", "correct5", "count")


def build_classifier_model(cfg: ConfigTree, dtype=None):
    """-> (model, model_type) (rspnet_tpu/engines/finetune.py:36-51):
    ``1stream`` is the backbone with its own classifier (S3D-G's dropout
    and ``fc``, C3D's and R(2+1)D's ``linear``, ResNet's ``fc``, TSM's
    per-segment ``new_fc``), ``multitask`` a ``MultiTaskWrapper`` with the
    ``fc`` classifier. Every ``model.*`` key goes to the backbone."""
    model_cfg = cfg.get_config("model").as_plain_dict()
    factory = get_model_class(model_cfg.pop("arch"), **model_cfg)
    num_classes = cfg.get_int("dataset.num_classes")
    model_type = cfg.get_string("model_type", "1stream")
    if model_type == "1stream":
        return factory(num_classes=num_classes, with_classifier=True,
                       dtype=dtype), model_type
    if model_type == "multitask":
        return MultiTaskWrapper(factory(dtype=dtype),
                                num_classes=num_classes, dtype=dtype,
                                finetune=True), model_type
    raise ValueError(f'Unrecognized model_type "{model_type}"')


def _unsupported(cfg: ConfigTree, args) -> None:
    def nope(what):
        raise NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")

    if cfg.get("parallel", None) is not None:
        nope("the 2-D `parallel:` layout")


class FinetuneEngine:
    def __init__(self, args, cfg: ConfigTree, final_validate: bool = False):
        self.args = args
        self.cfg = cfg
        self.debug = bool(getattr(args, "debug", False))
        self.final_validate = final_validate
        _unsupported(cfg, args)
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        logger.info("Device %s; compute dtype %s", self.device,
                    self.dtype or torch.float32)

        # the 1-D data mesh (one process: no group, no collective)
        self.mesh = mesh_for_args(args)
        self.group = self.mesh.group
        self.world_size = self.mesh.size
        rank = self.mesh.rank
        seed = cfg.get_int("seed", 0)
        torch.manual_seed(seed)
        model, self.model_type = build_classifier_model(cfg, self.dtype)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last_3d)
        set_bn_process_group(self.model, self.group)
        self.arch = cfg.get_string("model.arch")
        # S3D-G's 1stream dropout masks, this rank's
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1 + rank)
        # the linear probe: the train step freezes the backbone
        self.only_train_fc = cfg.get_bool("only_train_fc", False)
        if self.only_train_fc and not any(
                name.split(".")[0] in classifier.PROBE_NAMES
                for name, _ in self.model.named_parameters()):
            logger.warning(
                "only_train_fc: no classifier head named %s in %s (%s); "
                "nothing trains", "/".join(classifier.PROBE_NAMES),
                self.arch, self.model_type)
        # precise-BN batches before the first epoch of a fresh run
        self.bn_recalibrate = cfg.get_int("bn_recalibrate", 0)

        self.learning_rate = cfg.get_float("optimizer.lr")
        self.num_epochs = cfg.get_int("num_epochs")
        self.optimizer = build_optimizer(cfg.get_config("optimizer"),
                                         self.model.parameters(),
                                         self.learning_rate)
        self.scheduler = build_scheduler(
            cfg.get_string("optimizer.schedule", "none"), self.learning_rate,
            num_epochs=self.num_epochs,
            milestones=cfg.get_list("optimizer.milestones", []),
            patience=cfg.get_int("optimizer.patience", 10),
            # reference finetune cosine floors at lr/1000 (finetune.py:228)
            eta_min=self.learning_rate / 1000.0)

        if not final_validate:
            self.train_loader = build_loader(
                cfg, "train", debug=self.debug,
                batch_multiplier=self.world_size, device=self.device)
        self.validate_loader = build_loader(
            cfg, "val", final_validate=final_validate,
            batch_multiplier=self.world_size, device=self.device)

        tt = cfg.get_config("temporal_transforms")
        self.n_crop = (tt.get_int("validate.final_n_crop") if final_validate
                       else tt.get_int("validate.n_crop", 1))
        self.size = cfg.get_int("spatial_transforms.size")

        self.checkpoint_manager = CheckpointManager(args.experiment_dir,
                                                    keep_interval=None)
        self.log_interval = cfg.get_int("log_interval", 10)
        self.best_acc1 = 0.0
        self.current_epoch = 0
        self.rng = np.random.default_rng(seed + rank)
        self.writer = None
        if (args.experiment_dir is not None and not final_validate
                and rank == 0):
            self.writer = summary_writer(args.experiment_dir)

        st = cfg.get_config("spatial_transforms")
        self.aug = dict(
            gray_p=st.get_float("gray_scale", 0.0),
            jitter=(st.get_float("color_jitter.brightness", 0.0),
                    st.get_float("color_jitter.contrast", 0.0),
                    st.get_float("color_jitter.saturation", 0.0),
                    st.get_float("color_jitter.hue", 0.0)),
            h_flip=st.get_float("h_flip", 0.5))
        # the classification pipeline normalizes under --debug too
        # (reference :222-227)
        self.normalize = dataset_normalization(cfg)
        # per-step host-clock times (ms), each ended by a device sync; the
        # last epoch's train meters and validation metrics
        self.step_times = []
        self.train_meters = None
        self.validation = {}

    # -- device preprocessing ---------------------------------------------
    # Device-geometry loaders ship decode-resolution clips and the crop box
    # is applied here; host-geometry clips arrive cropped (identity boxes).
    def _train_augment(self, clip_u8) -> torch.Tensor:
        B, _, H, W, _ = clip_u8.shape
        dev_geom = getattr(self.train_loader.cfg, "device_geometry", False)
        p = sample_train_params(
            self.rng, B, [(H, W)],
            crop_area=self.train_loader.cfg.crop_area if dev_geom
            else (1.0, 1.0),
            h_flip=self.aug["h_flip"], gray_p=self.aug["gray_p"],
            jitter=self.aug["jitter"])
        if not dev_geom:
            p.boxes[:] = [0, 0, H, W]
        mean, std = self.normalize
        return augment_batch(
            clip_to_device(clip_u8, self.device), p,
            size=(self.size, self.size), mean=mean, std=std,
            gray_before_jitter=True, use_blur=False,
            identity_geometry=not dev_geom and (H, W) == (self.size,
                                                          self.size))

    def _eval_preprocess(self, clip_u8) -> torch.Tensor:
        B, _, H, W, _ = clip_u8.shape
        p = center_crop_params(B, [(H, W)])
        if not getattr(self.validate_loader.cfg, "device_geometry", False):
            p.boxes[:] = [0, 0, H, W]
        mean, std = self.normalize
        return eval_preprocess(clip_to_device(clip_u8, self.device),
                               p.boxes, size=(self.size, self.size),
                               mean=mean, std=std)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loading ----------------------------------------------------------
    def load_moco_checkpoint(self, path) -> None:
        """``--mc``: the backbone from a pretrain checkpoint of either
        package or of the reference; the classifier stays as built."""
        merge_encoder_into(self.model, load_pretrained_encoder(path,
                                                               self.arch),
                           self.model_type)

    def load_checkpoint(self, path) -> None:
        """Resume (``--load-checkpoint``): model, optimizer, scheduler,
        epoch and best_acc1; the optimizer state must be this package's."""
        states = load_state(path)
        if states["arch"] != self.arch:
            raise ValueError(
                f'Checkpoint arch {states["arch"]!r} != {self.arch!r}')
        load_optimizer_state(self.optimizer, states["optimizer"], path)
        self._load_model(states["model"])
        self.scheduler.load_state_dict(states["scheduler"])
        self.current_epoch = int(states["epoch"])
        self.best_acc1 = float(states["best_acc1"])
        logger.info("Loaded checkpoint %s (epoch %d)", path,
                    self.current_epoch)

    def load_model_only(self, path) -> None:
        """The classifier's weights and BN statistics from a finetune
        checkpoint of either package."""
        self._load_model(load_state(path)["model"])

    def _load_model(self, m) -> None:
        load_variables(self.model, {"params": m["params"],
                                    "batch_stats": m["batch_stats"]},
                       self.arch)

    def recalibrate_bn(self) -> None:
        """Precise-BN over ``bn_recalibrate`` augmented train batches
        (engines/precise_bn.py), with the augment stream pinned to
        seed + 3 so that every run sees the same calibration batches
        (rspnet_tpu/engines/finetune.py:253-258); the training stream is
        restored afterwards."""
        n = self.bn_recalibrate
        if not n:
            return
        from .precise_bn import recalibrate_bn_stats

        def batch_iter():
            count = epoch = 0
            while count < n:
                if len(self.train_loader) == 0:
                    raise ValueError(
                        "bn_recalibrate: train loader yields no batches "
                        f"({self.train_loader.num_samples} samples < "
                        "batch?)")
                self.train_loader.set_epoch(10_000 + epoch)
                epoch += 1
                it = iter(self.train_loader)
                try:
                    for b in it:
                        if count >= n:
                            break
                        yield self._train_augment(b["clips"][0])
                        count += 1
                finally:
                    it.close()

        saved_rng, self.rng = self.rng, np.random.default_rng(
            self.cfg.get_int("seed", 0) + 3)
        logger.info("Precise-BN: recalibrating BN statistics over %d "
                    "batches", n)
        t0 = time.perf_counter()
        try:
            recalibrate_bn_stats(self.model, batch_iter())
        finally:
            self.rng = saved_rng
        logger.info("Precise-BN done in %.1fs", time.perf_counter() - t0)

    # -- epochs -----------------------------------------------------------
    def train_epoch(self, epoch: int) -> MeterGroup:
        meters = MeterGroup(TRAIN_KEYS)
        self.train_loader.set_epoch(epoch)
        n_batches = len(self.train_loader)
        t_epoch = time.perf_counter()
        spool = MetricSpool()
        for i, batch in enumerate(prefetch_iterator(iter(self.train_loader))):
            t0 = time.perf_counter()
            clips = self._train_augment(batch["clips"][0])
            labels = torch.from_numpy(batch["labels"]).to(self.device)
            metrics = classifier.train_step(
                self.model, self.optimizer, clips, labels,
                only_train_fc=self.only_train_fc, generator=self.generator,
                group=self.group)
            spool.append(torch.stack([metrics[k].float()
                                      for k in TRAIN_KEYS]),
                         n=batch["labels"].shape[0])
            self._sync()
            self.step_times.append((time.perf_counter() - t0) * 1000.0)
            if i % self.log_interval == 0:
                logger.info("Train [%d/%d][%d/%d]\t%s step=%.1fms", epoch,
                            self.num_epochs, i, n_batches,
                            "\t".join(f"{k}={v:.4f}" for k, v in
                                      zip(TRAIN_KEYS, spool.last())),
                            self.step_times[-1])
            if self.debug and i >= 2:
                break
        for row, n in spool.rows():
            meters.update(dict(zip(TRAIN_KEYS, row)), n=n)
        logger.info("Train epoch %d done in %.1fs", epoch,
                    time.perf_counter() - t_epoch)
        if self.writer is not None:
            for k in TRAIN_KEYS:
                self.writer.add_scalar(f"train/{k}", meters[k].avg, epoch)
            self.writer.add_scalar("train/lr", self.scheduler.lr, epoch)
        return meters

    def validate_epoch(self, epoch: int, prefix: str = "val") -> dict:
        self.validate_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        spool = MetricSpool()
        for i, batch in enumerate(prefetch_iterator(
                iter(self.validate_loader))):
            clips = self._eval_preprocess(batch["clips"][0])
            labels = torch.from_numpy(batch["labels"]).to(self.device)
            mask = torch.from_numpy(batch["mask"]).to(self.device)
            sums = classifier.eval_step(self.model, clips, labels, mask,
                                        n_crop=self.n_crop, group=self.group)
            spool.append(torch.stack([sums[k].float() for k in SUM_KEYS]))
            if self.debug and i >= 2:
                break
        totals = dict(zip(SUM_KEYS, np.sum([row for row, _ in spool.rows()],
                                           axis=0)))
        count = max(float(totals["count"]), 1.0)
        loss = float(totals["loss_sum"]) / count
        acc1 = float(totals["correct1"]) / count * 100.0
        acc5 = float(totals["correct5"]) / count * 100.0
        logger.info("Validate epoch %d: loss=%.4f acc1=%.2f acc5=%.2f "
                    "(%d samples, %.1fs)", epoch, loss, acc1, acc5,
                    int(count), time.perf_counter() - t0)
        if self.writer is not None:
            self.writer.add_scalar(f"{prefix}/loss", loss, epoch)
            self.writer.add_scalar(f"{prefix}/acc1", acc1, epoch)
            self.writer.add_scalar(f"{prefix}/acc5", acc5, epoch)
        return {"loss": loss, "acc1": acc1, "acc5": acc5,
                "count": int(count)}

    def run(self) -> float:
        num_epochs = 1 if self.debug else self.num_epochs
        try:
            if self.current_epoch == 0:  # a fresh run, not a resume
                self.recalibrate_bn()
            for epoch in range(self.current_epoch + 1, num_epochs + 1):
                self.current_epoch = epoch
                self.train_meters = self.train_epoch(epoch)
                val = self.validation = self.validate_epoch(epoch)
                # every scheduler takes (and the non-plateau ones ignore)
                # the metric
                set_opt_lr(self.optimizer, self.scheduler.step(val["loss"]))
                is_best = val["acc1"] > self.best_acc1
                self.best_acc1 = max(self.best_acc1, val["acc1"])
                self.save_checkpoint(epoch, is_best)
        finally:
            self.close()
        return self.best_acc1

    def close(self) -> None:
        """Release the TensorBoard writer (its thread and file)."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def save_checkpoint(self, epoch: int, is_best: bool) -> None:
        """Rank 0 writes; the other ranks wait for the file."""
        if self.mesh.rank != 0:
            barrier()
            return
        variables = state_dict_to_variables(self.model.state_dict(),
                                            self.arch)
        self.checkpoint_manager.save({
            "epoch": epoch,
            "arch": self.arch,
            "model": {"params": variables["params"],
                      "batch_stats": variables["batch_stats"]},
            "best_acc1": self.best_acc1,
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
        }, is_best, epoch)
        barrier()
