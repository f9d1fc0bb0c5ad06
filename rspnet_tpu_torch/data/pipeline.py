"""Host-side video input pipeline: decode workers + prefetch (port of
rspnet_tpu/data/pipeline.py).

Replaces the reference's torch DataLoader + MainProcessCollateWrapper
(reference: datasets/classification/__init__.py:22-149). Differences, by
design:

- Workers are threads (decode backends release the GIL in C); a bounded
  in-flight window gives prefetch overlap with the device step.
- Temporal selection happens in the worker on uint8. With
  ``device_geometry`` the worker ships decode-resolution windows and the
  spatial crop+resize runs on the card (ops.augment.crop_resize); otherwise
  the worker crops and resizes with OpenCV (imported lazily). All float
  pixel math (colour jitter, flip, normalize) runs on the card.
- Validation pads the tail batch and returns a mask instead of shipping a
  ragged batch (replaces num_valid_samples tail-cutting, reference
  :16-19,44-50).
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..framework import tracing
from ..ops.augment import center_max_box, sample_crop_box
from . import transforms_temporal as T
from .video_reader import open_video

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    # temporal
    clip_len: int                       # frames per clip fed to the model
    frame_rate: Optional[float] = None  # fps retarget (None = native)
    strides: Sequence[dict] = field(
        default_factory=lambda: [{"stride": 1, "weight": 1}])
    temporal_type: str = "clip"         # 'clip' | 'cover'
    n_crop: int = 1                     # eval multi-crop count
    eval_stride: int = 1
    force_n_crop: bool = False          # retrieval: EvenNCrop in train split
    # spatial
    out_size: int = 112
    crop_area: Tuple[float, float] = (0.25, 1.0)
    # device geometry: workers return clips at DECODE resolution and the
    # spatial crop+resize runs on the card (ops.augment.crop_resize). This
    # removes the per-frame cv2.resize loop from the host hot path at the
    # price of shipping decode-res pixels to the card. Requires every
    # video in the dataset to decode to ONE fixed (H, W) (synthetic, a
    # fixed-size transcode, or decode_size below); np.stack raises
    # otherwise.
    device_geometry: bool = False
    # decode-time scaling: (H, W) every clip is resized to DURING decode
    # (the native decoder's sws_scale converts YUV->RGB and resizes in the
    # same pass — free). This makes device_geometry work on variable-size
    # datasets (the reference transcode recipe scale=w=-2:h=256 yields
    # variable widths) without the per-frame host resize. Note: fixed
    # (H, W) from variable-aspect sources distorts aspect slightly; the
    # Inception-style crop's aspect jitter (3/4..4/3) dwarfs it.
    decode_size: Optional[Tuple[int, int]] = None
    # packed loading: the positions WITHIN the temporal window to decode
    # and ship (moco.step.packed_frame_subset), e.g. 48 of 64 for the
    # exact multi-speed union of diff_speed (4, 2); the train step's gather
    # addresses the packed positions
    frame_subset: Optional[Sequence[int]] = None
    # pipeline
    num_clips: int = 1                  # clips per sample (2 for MoCo)
    batch_size: int = 16
    train: bool = True
    num_workers: int = 4
    seed: int = 0
    drop_last: Optional[bool] = None    # default: train
    # process workers sidestep the GIL for Python-heavy sample paths;
    # threads suffice for real video (C decode releases the GIL)
    use_processes: bool = False
    # multi-process: each process loads only its slice of every global
    # batch (replaces the reference's DistributedSampler sharding,
    # datasets/classification/__init__.py:130). The epoch permutation is
    # computed identically on every host (same seed), so shards are
    # disjoint and exhaustive by construction.
    process_index: int = 0
    process_count: int = 1


def _sample_seed(seed: int, epoch: int, k: int) -> int:
    return hash((seed, epoch, k)) & 0x7FFFFFFF


def _build_temporal_for(cfg: "PipelineConfig", rng):
    c = cfg
    if c.train and not c.force_n_crop:
        if c.temporal_type == "clip":
            return T.RandomStrideCrop(c.clip_len, c.strides, rng=rng)
        if c.temporal_type == "cover":
            return T.Cover(c.clip_len, rng=rng)
        raise ValueError(f"Unknown temporal type {c.temporal_type!r}")
    if c.temporal_type == "clip":
        return T.EvenNCrop(c.clip_len, stride=c.eval_stride, n=c.n_crop)
    if c.temporal_type == "cover":
        return T.Cover(c.clip_len, n_crop=c.n_crop)
    raise ValueError(f"Unknown temporal type {c.temporal_type!r}")


def _load_one(catalog, cfg: "PipelineConfig", index: int,
              rng: np.random.Generator):
    """Decode + temporal select + crop + resize for one sample (runs in a
    worker thread or process)."""
    c = cfg
    sample = catalog[index]
    with open_video(sample.video_path) as vr:
        num_frames = vr.num_frames
        if num_frames <= 0:
            raise IOError(f"Empty video: {sample.video_path}")
        frame_indices = np.arange(num_frames)
        if c.frame_rate is not None:
            frame_indices = T.resample_index(frame_indices, vr.fps,
                                             c.frame_rate)
        temporal = _build_temporal_for(c, rng)
        clip_indices = [temporal(frame_indices) for _ in range(c.num_clips)]
        if c.frame_subset is not None:
            sub = np.asarray(c.frame_subset)
            clip_indices = [ci[sub] for ci in clip_indices]
        all_idx = np.concatenate(clip_indices)
        out_wh = None
        if c.decode_size is not None:
            out_wh = (int(c.decode_size[1]), int(c.decode_size[0]))  # (w, h)
        # one decode pass (reference :75); resize rides the decode when
        # decode_size is set
        frames = vr.get_batch(all_idx, out_wh=out_wh)

    clips = []
    ofs = 0
    S = c.out_size
    for ci in clip_indices:
        clip = frames[ofs:ofs + len(ci)]
        ofs += len(ci)
        if c.device_geometry:
            # geometry moves on-device: ship the decode-res window as-is;
            # the engine samples crop boxes (same distribution) and the
            # fused augment does crop+resize in one gather
            clips.append(np.ascontiguousarray(clip))
            continue
        import cv2  # only the host-geometry path needs OpenCV; the
        # device_geometry path must not require it
        h, w = clip.shape[1:3]
        if c.train:
            i, j, bh, bw = sample_crop_box(rng, h, w, c.crop_area)
        else:
            i, j, bh, bw = center_max_box(h, w, 1.0)
        cropped = clip[:, i:i + bh, j:j + bw]
        out = np.empty((cropped.shape[0], S, S, 3), np.uint8)
        for t in range(cropped.shape[0]):
            out[t] = cv2.resize(cropped[t], (S, S),
                                interpolation=cv2.INTER_LINEAR)
        clips.append(out)
    return clips, sample.class_index


# -- multiprocessing support --------------------------------------------------
# one (catalog, cfg, indices, epoch) snapshot per worker process; a fresh
# pool is created per epoch so the snapshot stays consistent
_PROC_STATE: dict = {}


def _proc_init(catalog, cfg, indices, epoch):
    _PROC_STATE["args"] = (catalog, cfg, indices, epoch)


def _proc_job(k: int):
    catalog, cfg, indices, epoch = _PROC_STATE["args"]
    idx = int(indices[k % len(indices)])
    rng = np.random.default_rng(_sample_seed(cfg.seed, epoch, k))
    return _load_one(catalog, cfg, idx, rng), k < len(indices)


class VideoDataLoader:
    """Iterates dicts: {'clips': [uint8 [B,T,S,S,3]] * num_clips,
    'labels': int32 [B], 'mask': bool [B]}."""

    def __init__(self, catalog, cfg: PipelineConfig):
        self.catalog = catalog
        self.cfg = cfg
        self.epoch = 0
        self._drop_last = cfg.drop_last if cfg.drop_last is not None else cfg.train
        self._build_temporal(None)  # validate config eagerly

    # -- temporal transform selection (reference get_temporal_transform,
    #    datasets/classification/__init__.py:268-313). Built PER SAMPLE with
    #    that sample's RNG — worker threads must not share one stateful
    #    transform (a shared np.random.Generator is not thread-safe and the
    #    rebinding pattern races).
    def _build_temporal(self, rng):
        return _build_temporal_for(self.cfg, rng)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def num_samples(self) -> int:
        return len(self.catalog)

    def __len__(self) -> int:
        n = len(self.catalog)
        if self._drop_last:
            return n // self.cfg.batch_size
        return (n + self.cfg.batch_size - 1) // self.cfg.batch_size

    # -- per-sample work (worker thread) ------------------------------------
    def _load_sample(self, index: int, rng: np.random.Generator):
        with tracing.span("rsp.loader.decode"):
            return _load_one(self.catalog, self.cfg, index, rng)

    # -- iteration ----------------------------------------------------------
    def _epoch_indices(self) -> np.ndarray:
        n = len(self.catalog)
        if self.cfg.train:
            rng = np.random.default_rng(self.cfg.seed * 100003 + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[dict]:
        c = self.cfg
        indices = self._epoch_indices()
        B = c.batch_size
        n_batches = len(self)

        # multi-host shard: of every global batch [b*B, (b+1)*B), this host
        # assembles rows [pi*B_local, (pi+1)*B_local). Sample seeds key off
        # the GLOBAL position k, so the data is identical to a 1-host run.
        if B % c.process_count != 0:
            raise ValueError(
                f"global batch {B} not divisible by process_count "
                f"{c.process_count}")
        b_local = B // c.process_count
        lo = c.process_index * b_local

        if c.use_processes:
            import functools
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            # fork: workers inherit catalog/cfg cheaply (matches the
            # reference's fork context, classification/__init__.py:139-147)
            pool_cls = functools.partial(
                ProcessPoolExecutor, mp_context=mp.get_context("fork"),
                initializer=_proc_init,
                initargs=(self.catalog, c, indices, self.epoch))
            job = _proc_job
        else:
            def job(k: int):
                idx = int(indices[k % len(indices)])
                rng = np.random.default_rng(
                    _sample_seed(c.seed, self.epoch, k))
                return self._load_sample(idx, rng), k < len(indices)
            pool_cls = ThreadPoolExecutor

        local_ks = [b * B + lo + j
                    for b in range(n_batches) for j in range(b_local)]
        with pool_cls(max_workers=max(1, c.num_workers)) as pool:
            depth = max(2 * c.num_workers, b_local)
            futures = {p: pool.submit(job, local_ks[p])
                       for p in range(min(depth, len(local_ks)))}
            batch_clips: List[List[np.ndarray]] = [[] for _ in range(c.num_clips)]
            labels: List[int] = []
            mask: List[bool] = []
            for p in range(len(local_ks)):
                (clips, label), valid = futures.pop(p).result()
                nxt = p + len(futures) + 1
                if nxt < len(local_ks):
                    futures[nxt] = pool.submit(job, local_ks[nxt])
                for ci, clip in enumerate(clips):
                    batch_clips[ci].append(clip)
                labels.append(label)
                mask.append(valid)
                if len(labels) == b_local:
                    yield {
                        "clips": [np.stack(bc) for bc in batch_clips],
                        "labels": np.asarray(labels, np.int32),
                        "mask": np.asarray(mask, bool),
                    }
                    batch_clips = [[] for _ in range(c.num_clips)]
                    labels, mask = [], []

    def num_valid_samples(self) -> int:
        """Total non-padded samples across the epoch (reference :44-50)."""
        if self._drop_last:
            return len(self) * self.cfg.batch_size
        return len(self.catalog)


def build_loader(cfg_tree, split: str, *, vid: bool = False,
                 final_validate: bool = False, debug: bool = False,
                 catalog=None, batch_multiplier: int = 1, device=None):
    """ConfigTree -> VideoDataLoader (reference DataLoaderFactoryV3.build,
    datasets/classification/__init__.py:64-149), or the
    ``DeviceCachedLoader`` around it on ``device`` that ``cache_device``
    asks for."""
    from .catalogs import build_catalog

    tt = cfg_tree.get_config("temporal_transforms")
    st = cfg_tree.get_config("spatial_transforms")
    train = split == "train"

    # config batch sizes are per-replica (reference: one DataLoader per GPU
    # process); multiply by the mesh size to get the global batch
    if train:
        batch_size = cfg_tree.get_int("batch_size")
    elif final_validate:
        batch_size = cfg_tree.get_int("final_validate.batch_size")
    else:
        batch_size = cfg_tree.get_int("validate.batch_size")
    batch_size *= batch_multiplier

    n_crop = 1
    force_n_crop = False
    if not train:
        n_crop = tt.get_int("validate.final_n_crop") if final_validate \
            else tt.get_int("validate.n_crop", 1)
    elif (tt.get_bool("force_n_crop", False)
          and tt.get_string("type", "clip") == "clip"):
        # retrieval train-split extraction uses the final multi-crop
        # (reference: get_temporal_transform, classification/__init__.py:
        # 274-282 — force_n_crop -> EvenNCrop(final_n_crop), checked ONLY
        # in the 'clip' branch: a 'cover' train split always gets the
        # random-phase Cover, so don't read final_n_crop there either)
        force_n_crop = True
        n_crop = tt.get_int("validate.final_n_crop")

    frame_subset = None
    if vid and cfg_tree.get_bool("moco.packed_frames", False):
        from ..moco.step import packed_frame_subset
        speeds = tuple(cfg_tree.get_list("moco.diff_speed"))
        # multi-speed trains each step at its own T // s (exact mode,
        # engines/pretrain.py): pack the union every branch can address
        frame_subset = packed_frame_subset(tt.get_int("size"), speeds,
                                           exact=len(speeds) > 1)

    cfg = PipelineConfig(
        clip_len=tt.get_int("size"),
        frame_subset=frame_subset,
        frame_rate=tt.get("frame_rate", None),
        strides=[s.as_plain_dict() if hasattr(s, "as_plain_dict") else s
                 for s in tt.get_list("strides", [{"stride": 1, "weight": 1}])],
        temporal_type=tt.get_string("type", "clip"),
        n_crop=n_crop,
        eval_stride=tt.get_int("validate.stride", 1),
        force_n_crop=force_n_crop,
        out_size=st.get_int("size"),
        crop_area=((0.4, 1.0) if vid else
                   (st.get_float("crop_area.min", 0.25),
                    st.get_float("crop_area.max", 1.0))),
        num_clips=2 if vid else 1,
        batch_size=batch_size,
        train=train,
        num_workers=cfg_tree.get_int("num_workers", 4),
        seed=cfg_tree.get_int("seed", 0),
        use_processes=cfg_tree.get_bool("use_process_workers", False),
        device_geometry=cfg_tree.get_bool("device_geometry", False),
        decode_size=(tuple(cfg_tree.get_list("decode_size"))
                     if "decode_size" in cfg_tree else None),
    )
    # multi-process: shard every global batch across the torch.distributed
    # ranks when a process group is up (the reference's DistributedSampler,
    # classification/__init__.py:130); one process otherwise
    cfg.process_index, cfg.process_count = _process_index_count()

    catalog = catalog or build_catalog(cfg_tree, split)
    loader = VideoDataLoader(catalog, cfg)
    # cache_device: true caches every split; "train" only the train split
    # (an n_crop-expanded final validate can exceed the device's budget).
    # One-time host-to-device materialization, then every epoch is served
    # from device memory (batch-axis index_select): data/device_cache.py
    cache = cfg_tree.get("cache_device", False)
    if cache is True or (cache == "train" and train):
        if device is None:
            raise ValueError("cache_device needs the engine's device")
        from .device_cache import DeviceCachedLoader
        loader = DeviceCachedLoader(loader, device)
    elif cache not in (False, None, "train"):
        raise ValueError(f"cache_device must be true/false/'train', "
                         f"got {cache!r}")
    return loader


def _process_index_count() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def prefetch_iterator(iterable, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue.

    Overlaps host batch assembly (decode pool + np.stack) with device work:
    while the step runs asynchronously, the next batch is already being
    built (the reference gets this from torch DataLoader's worker
    prefetching). On single-CPU hosts the producer thread starves the
    consumer instead of overlapping with it, so prefetching auto-disables
    there. Override with RSPNET_PREFETCH=<depth> (0 disables everywhere).
    """
    import os
    import queue
    import threading

    env_depth = os.environ.get("RSPNET_PREFETCH")
    if env_depth is not None:
        depth = int(env_depth)
    elif (os.cpu_count() or 1) < 2:
        depth = 0
    if depth <= 0:
        yield from iterable
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def produce():
        try:
            it = iter(iterable)
            while not stop.is_set():
                try:
                    # one batch: the cache's gather, or the decode pool
                    # and the stack
                    with tracing.span("rsp.loader.produce"):
                        item = next(it)
                except StopIteration:
                    item = _END
                # bounded put so a consumer that exits early (debug-mode
                # break, exception in the step body) can't strand this
                # thread in q.put forever — that pinned the suspended
                # loader generator and leaked its worker pool every
                # epoch)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item is _END:
                    return
        except BaseException as e:  # surface worker errors in the consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
