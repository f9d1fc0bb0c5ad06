"""MoCo + RSP pretraining engine on one card (port of
rspnet_tpu/engines/pretrain.py; reference: pretrain.py:33-260).

The hot loop:

  host loader (decode [+ geometry], uint8)
    -> device augment (ops.augment.augment_batch: crop_resize + kernel K3)
    -> train step (moco.step.train_step: S3D-G through kernels K1/K2)

``validate_epoch`` (``--validate``) runs the same loader and augment into
``moco.step.eval_step``: metrics only, nothing updated.

Options, as the JAX engine takes them: ``moco.aug_plus`` (jitter (0.4, 0.4,
0.4, 0.1) drawn with probability 0.8, gray after it, gaussian blur on half
the clips, rspnet_tpu/engines/pretrain.py:193-198); exact multi-speed
(``len(moco.diff_speed) > 1``: a speed drawn each step, train and
validate, from its own stream seeded seed + 0x5BEE, and the step's
single-speed branch at T // s, :108-123, :160-166); ``moco.packed_frames``
(the loader ships the packed union, ``moco.step.packed_frame_subset``).
TensorBoard scalars per epoch (``train/clips_per_sec``, the meters,
``train/lr``) when tensorboardX is installed (:144-151, :282-291).

Run-dir artifacts: checkpoint.pth.tar (epoch / arch / model / best_loss /
optimizer / scheduler) and the model_best.pth.tar hard link. ``model`` is
in the JAX engine's layout (``save_checkpoint``), so the JAX package's
``load_pretrained_encoder`` and ``load_checkpoint(model_only=True)`` read
it, and this engine reads the JAX engine's files.

Compute dtype and matmul precision: ``framework/environment.py:
resolve_runtime`` (bf16 on the card, f32 on the CPU). Parameters, BN
statistics, the optimizer state, the EMA, the queue and the checkpoints
stay f32; K3's output is f32 and the stem conv casts it.

More than one card (``--ws N``, rspnet_tpu/engines/pretrain.py:48-77):
each rank trains on its rows of the global batch (batch x world, the
loader built with ``batch_multiplier = world`` yields rows [rB, (r+1)B),
F1); the lr scales with the world; K is trimmed to a multiple of the
global batch x M; every ``BatchNorm`` takes its moments over the group;
the step takes the mesh's layout (``moco.layout_for``: 1-D, or the 2-D
``parallel: {data, model}`` layout with the K-sharded queue). Each rank
draws its augment parameters from seed + rank and its permutations from
seed + 1 + rank; the queue is rank 0's. Rank 0 alone writes the
checkpoint (the dense queue) and TensorBoard; the others wait for it.

``cache_device`` (``data/device_cache.py``) serves the clips from the
card: the loader's batches then hold uint8 tensors on the engine's
device, which the augment takes without a copy. One process only.
"""
from __future__ import annotations

import itertools
import logging
import time
from contextlib import closing
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ConfigTree
from ..data.device_cache import clip_to_device
from ..data.pipeline import build_loader, prefetch_iterator
from ..framework import CheckpointManager, MeterGroup, load_state, tracing
from ..framework.checkpoint import load_optimizer_state
from ..framework.environment import resolve_runtime, scale_learning_rate
from ..framework.logging import summary_writer
from ..framework.lr_schedule import build_optimizer, build_scheduler, set_opt_lr
from ..models.common import set_bn_process_group
from ..models.convert import load_variables, state_dict_to_variables
from ..moco import (METRIC_KEYS, build_moco_model, eval_step,
                    gather_queue_2d, init_moco_state, layout_for,
                    shard_queue_2d, speed_branch_config, train_step)
from ..parallel import barrier, broadcast_, mesh_for_config
from ..ops.augment import augment_batch
from ..utils.moco import replace_moco_k_in_config
from .geometry import clip_geometry
from .normalization import dataset_normalization

logger = logging.getLogger(__name__)


class PretrainEngine:
    def __init__(self, args, cfg: ConfigTree):
        self.args = args
        self.cfg = cfg
        self.debug = bool(getattr(args, "debug", False))
        self.device, self.dtype = resolve_runtime(
            getattr(args, "device", "cuda"))

        # the 1-D data mesh, or the 2-D one of a `parallel:` block; one
        # process has no group and takes no collective
        self.mesh = mesh_for_config(cfg, args)
        self.world_size = self.mesh.size
        self.layout = layout_for(self.mesh)
        rank = self.mesh.rank
        if self.world_size > 1:
            logger.info("Mesh: rank %d of %s", rank, self.mesh.shape)
        # global batch = per-rank batch x ranks (the batch shards over both
        # axes of a 2-D mesh)
        self.batch_size = cfg.get_int("batch_size")
        self.global_batch = self.batch_size * self.world_size
        replace_moco_k_in_config(cfg, self.global_batch,
                                 model_parallel=self.mesh.model)
        seed = cfg.get_int("seed", 0)
        torch.manual_seed(seed)
        model, self.moco_cfg = build_moco_model(cfg, dtype=self.dtype)
        model = model.to(self.device, memory_format=torch.channels_last_3d)
        self.arch = cfg.get_string("model.arch")

        lr = cfg.get_float("optimizer.lr")
        if not getattr(args, "no_scale_lr", False):
            lr = scale_learning_rate(lr, self.world_size, self.batch_size)
            logger.info("Scaled lr: %f", lr)
        self.num_epochs = cfg.get_int("num_epochs")
        self.scheduler = build_scheduler(
            cfg.get_string("optimizer.schedule", "cosine"), lr,
            num_epochs=self.num_epochs,
            milestones=cfg.get_list("optimizer.milestones", []),
            patience=cfg.get_int("optimizer.patience", 10),
            # reference pretrain cosine floors at lr/1000 (pretrain.py:75-79)
            eta_min=lr / 1000.0)
        optimizer = build_optimizer(cfg.get_config("optimizer"),
                                    model.parameters(), lr)

        self.train_loader = build_loader(cfg, "train", vid=True,
                                         debug=self.debug,
                                         batch_multiplier=self.world_size,
                                         device=self.device)
        self.size = cfg.get_int("spatial_transforms.size")

        # the permutation of each rank's rows
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1 + rank)
        self.state = init_moco_state(model, self.moco_cfg, optimizer,
                                     self.generator)
        if self.mesh.group is not None:
            # after the key encoder's deep copy (a group does not copy)
            set_bn_process_group(self.state.model_q, self.mesh.group)
            set_bn_process_group(self.state.model_k, self.mesh.group)
            broadcast_(self.state.queue, self.mesh.group)
        if self.mesh.is_2d:
            self.state.queue = shard_queue_2d(self.state.queue, self.mesh)

        self.checkpoint_manager = CheckpointManager(
            args.experiment_dir,
            keep_interval=cfg.get_int("checkpoint_interval", None))
        self.meters = MeterGroup(METRIC_KEYS)
        self.log_interval = cfg.get_int("log_interval", 10)
        self.best_loss = float("inf")
        self.current_epoch = 1
        # this rank's augment parameters
        self.rng = np.random.default_rng(seed + rank)
        # exact multi-speed: the speed of each step, from a stream of its
        # own, the same on every rank (the JAX engine's draw,
        # rspnet_tpu/engines/pretrain.py:121)
        self.speed_rng = np.random.default_rng(seed + 0x5BEE)
        # the speed of each step of this run
        self.speeds = []
        self.writer = (summary_writer(args.experiment_dir)
                       if args.experiment_dir is not None and rank == 0
                       else None)
        self.aug_plus = cfg.get_bool("moco.aug_plus", False)
        # dataset.mean/std; debug disables normalization in the VID
        # pipeline (reference :152-162)
        self.normalize = dataset_normalization(cfg, vid_debug=self.debug)
        # per-step host-clock times (ms), each ended by a device sync
        self.step_times = []
        self._step_watch = tracing.Stopwatch("rsp.engine.step")
        # the meter averages of the last validate_epoch
        self.validation = {}

    # -- device-side augmentation of a uint8 batch ----------------------------
    # the VID crop_area (0.4, 1.0) on device-geometry clips
    # (``engines/geometry.py``)
    def _augment_clip(self, clip_u8) -> torch.Tensor:
        with tracing.phase("rsp.augment"):
            B, _, H, W, _ = clip_u8.shape
            geom = clip_geometry(self.train_loader.cfg, (B, H, W), self.size)
            if self.aug_plus:
                p = geom.train_params(
                    self.rng, h_flip=0.5, gray_p=0.2,
                    jitter=(0.4, 0.4, 0.4, 0.1), jitter_p=0.8, blur_p=0.5)
            else:
                p = geom.train_params(self.rng, h_flip=0.5, gray_p=0.2,
                                      jitter=(0.4, 0.4, 0.4, 0.4))
            mean, std = self.normalize
            batch = clip_to_device(clip_u8, self.device)
            return augment_batch(
                batch, p, size=(self.size, self.size), mean=mean, std=std,
                gray_before_jitter=not self.aug_plus, use_blur=self.aug_plus,
                identity_geometry=geom.identity)

    def _step_config(self):
        """The step's MoCo config: with more than one speed, the branch of
        a speed drawn from ``speed_rng`` (recorded in ``speeds``)."""
        ds = self.moco_cfg.diff_speed
        if len(ds) == 1:
            return self.moco_cfg
        speed = int(ds[int(self.speed_rng.integers(len(ds)))])
        self.speeds.append(speed)
        return speed_branch_config(self.moco_cfg, speed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- epochs ---------------------------------------------------------------
    def train_epoch(self, epoch: int, max_steps: Optional[int] = None) -> None:
        """One epoch over the train loader, or its first ``max_steps``
        steps (3 with ``--debug``). Spans (``framework/tracing.py``, while
        a profiler runs): ``rsp.engine.epoch`` the call; ``rsp.engine.iter``
        a loop turn, data wait in it; ``rsp.loader.next`` the wait;
        ``rsp.engine.step`` the interval ``step_times`` records, with
        ``rsp.engine.sync`` in it; ``rsp.engine.drain`` the epoch's end."""
        if self.debug:
            max_steps = 3 if max_steps is None else min(max_steps, 3)
        with tracing.span("rsp.engine.epoch"):
            self.meters.reset()
            self.train_loader.set_epoch(epoch)
            n_batches = len(self.train_loader)
            t_epoch = time.perf_counter()
            samples = 0
            rows = []
            turns = (itertools.count() if max_steps is None
                     else range(max_steps))
            with closing(prefetch_iterator(iter(self.train_loader))) as it:
                for i in turns:
                    tracing.begin_step(self.state.step, self.device)
                    with tracing.span("rsp.engine.iter"):
                        with tracing.span("rsp.loader.next"):
                            batch = next(it, None)
                        if batch is None:
                            break
                        with self._step_watch:
                            clip_q = self._augment_clip(batch["clips"][0])
                            clip_k = self._augment_clip(batch["clips"][1])
                            metrics = train_step(self.state, clip_q, clip_k,
                                                 self._step_config(),
                                                 generator=self.generator,
                                                 layout=self.layout)
                            rows.append(torch.stack([metrics[k]
                                                     for k in METRIC_KEYS]))
                            with tracing.span("rsp.engine.sync"):
                                self._sync()
                        self.step_times.append(self._step_watch.ms)
                        samples += batch["labels"].shape[0] * self.world_size
                        if i % self.log_interval == 0:
                            vals = rows[-1].tolist()
                            logger.info(
                                "Epoch %d [%d/%d] %s lr=%.5f step=%.1fms",
                                epoch, i, n_batches,
                                "\t".join(f"{k}={v:.4f}" for k, v in
                                          zip(METRIC_KEYS, vals)),
                                self.scheduler.lr, self.step_times[-1])
            with tracing.span("rsp.engine.drain"):
                for row in torch.stack(rows).cpu().tolist():
                    self.meters.update(dict(zip(METRIC_KEYS, row)))
                dt = time.perf_counter() - t_epoch
                logger.info("Epoch %d done in %.1fs (%.1f clips/s)", epoch,
                            dt, samples / max(dt, 1e-9))
                if self.writer is not None:
                    self.writer.add_scalar("train/clips_per_sec",
                                           samples / max(dt, 1e-9), epoch)
                    for k in METRIC_KEYS:
                        self.writer.add_scalar(f"train/{k}",
                                               self.meters[k].avg, epoch)
                    self.writer.add_scalar("train/lr", self.scheduler.lr,
                                           epoch)

    def validate_epoch(self) -> dict:
        """One no-grad statistics epoch over the train loader at the current
        epoch (port of rspnet_tpu/engines/pretrain.py:293); returns the
        meters' averages, weighted by batch, and keeps them in
        ``validation``."""
        meters = MeterGroup(METRIC_KEYS)
        self.train_loader.set_epoch(self.current_epoch)
        rows, sizes = [], []
        for i, batch in enumerate(prefetch_iterator(iter(self.train_loader))):
            tracing.begin_step(self.state.step, self.device)
            clip_q = self._augment_clip(batch["clips"][0])
            clip_k = self._augment_clip(batch["clips"][1])
            metrics = eval_step(self.state, clip_q, clip_k,
                                self._step_config(),
                                generator=self.generator,
                                layout=self.layout)
            rows.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
            sizes.append(batch["labels"].shape[0])
            if self.debug and i >= 2:
                break
        for row, n in zip(torch.stack(rows).cpu().tolist(), sizes):
            meters.update(dict(zip(METRIC_KEYS, row)), n=n)
        logger.info("Validate statistics: %s", meters)
        self.validation = {k: meters[k].avg for k in METRIC_KEYS}
        return self.validation

    def profile_steps(self, n_steps: int) -> Path:
        """One warm step, then ``n_steps`` steps of the current epoch
        under ``torch.profiler``: the Chrome trace, with the ``rsp.`` spans
        in it, into ``run_dir/profile/trace.json``, and one log line per
        span name and the counters the steps moved (``--profile-steps``;
        the port of the JAX engine's ``profile_steps``)."""
        from torch.profiler import ProfilerActivity, profile
        out = Path(self.args.run_dir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        self.train_epoch(self.current_epoch, max_steps=1)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        before = tracing.counters()
        with profile(activities=activities) as prof:
            self.train_epoch(self.current_epoch, max_steps=n_steps)
        after = tracing.counters()
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in
                 {"loader.h2d_calls", "loader.h2d_bytes", *after}}
        for name, count, host_ms, device_ms in tracing.summarize(
                tracing.spans()):
            logger.info("%s: %d spans, host %.3f ms%s in all", name, count,
                        host_ms, "" if device_ms is None
                        else f", device {device_ms:.3f} ms")
        logger.info("counters: %s", " ".join(
            f"{k}={v}" for k, v in sorted(moved.items())))
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("Profiler trace written to %s", path)
        return path

    def run(self) -> None:
        num_epochs = 1 if self.debug else self.num_epochs
        try:
            for epoch in range(self.current_epoch, num_epochs + 1):
                self.current_epoch = epoch
                self.train_epoch(epoch)
                lr = self.scheduler.step(self.meters["loss"].avg)
                set_opt_lr(self.state.optimizer, lr)
                loss_avg = self.meters["loss"].avg
                is_best = loss_avg < self.best_loss
                self.best_loss = min(self.best_loss, loss_avg)
                self.save_checkpoint(epoch, is_best)
        finally:
            self.close()

    def close(self) -> None:
        """Release the TensorBoard writer (its thread and file)."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, epoch: int, is_best: bool) -> None:
        """The JAX engine's layout (rspnet_tpu/engines/pretrain.py:388-402):
        both encoders as JAX ``params``/``batch_stats`` trees, the queue
        and its pointer; ``step`` beside them (the JAX package reads past
        it); the torch optimizer state under ``optimizer``. Every rank takes
        part (the 2-D queue is gathered dense); rank 0 writes."""
        s = self.state
        queue = s.queue
        if self.mesh.is_2d:
            queue = gather_queue_2d(queue, self.mesh)
        if self.mesh.rank != 0:
            barrier()
            return
        q = state_dict_to_variables(s.model_q.state_dict(), self.arch)
        k = state_dict_to_variables(s.model_k.state_dict(), self.arch)
        state = {
            "epoch": epoch,
            "arch": self.arch,
            "model": {
                "params_q": q["params"],
                "params_k": k["params"],
                "batch_stats_q": q["batch_stats"],
                "batch_stats_k": k["batch_stats"],
                "queue": queue.detach().cpu(),
                "queue_ptr": np.asarray(s.queue_ptr, np.int32),
                "step": np.asarray(s.step, np.int64),
            },
            "best_loss": self.best_loss,
            "optimizer": s.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
        }
        self.checkpoint_manager.save(state, is_best, epoch)
        barrier()

    def load_checkpoint(self, path, model_only: bool = False) -> None:
        """Either package's pretrain checkpoint; a full resume needs this
        package's optimizer state."""
        ckpt = load_state(path)
        if ckpt.get("arch") != self.arch:
            raise ValueError(
                f"Checkpoint arch {ckpt.get('arch')!r} != {self.arch!r}")
        s = self.state
        if not model_only:
            load_optimizer_state(s.optimizer, ckpt["optimizer"], path)
        m = ckpt["model"]
        s.step = int(m.get("step", 0))
        for model, which in ((s.model_q, "q"), (s.model_k, "k")):
            load_variables(model, {"params": m[f"params_{which}"],
                                   "batch_stats": m[f"batch_stats_{which}"]},
                           self.arch)
            # the JAX layout has no BN batch counters: each encoder's BNs
            # run once in train mode per step
            for mod in model.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.num_batches_tracked.fill_(s.step)
        queue = torch.as_tensor(np.asarray(m["queue"]))
        if self.mesh.is_2d:    # a dense queue, sharded over K
            queue = shard_queue_2d(queue, self.mesh)
        s.queue.copy_(queue)
        s.queue_ptr = int(m["queue_ptr"])
        if not model_only:
            self.scheduler.load_state_dict(ckpt["scheduler"])
            self.current_epoch = int(ckpt["epoch"]) + 1
            self.best_loss = float(ckpt.get("best_loss", float("inf")))
        logger.info("Loaded checkpoint from %s (epoch %s)", path,
                    ckpt.get("epoch"))
