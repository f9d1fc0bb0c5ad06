"""CAM visualization of the pretext heads on one card (port of
rspnet_tpu/engines/visualization.py; reference: visualization.py:52-111,
moco/builder_diffspeed_diffloss.py:449-490).

For each (query, key) clip pair and each head (A-VID ``fc1``, RSP ``fc2``)
a class activation map projects the other clip's pooled feature through
both heads' weights onto the feature map:

  M_q = ((w_head_k @ gap(k_F)) @ w_head_q) . q_F   summed over channels

The maps are min-max normalized, resized, JET-coloured and blended onto the
denormalized frames; each is saved as a strip of its first 8 frames,
``cam/sample{batch}_{b}_{qA,qM,kA,kM}.png`` in the run dir.

  host loader (uint8 q and k clips, VID pipeline)
    -> ``eval_preprocess`` with the centre max box, then the dual-speed
       pairing of training (``moco.step.diff_speed_gather``)
    -> the query encoder on q, the key encoder on k (K1 at every pool)
    -> ``cam_maps`` (plain torch: a small product, outside any kernel in
       the JAX package too) -> the host: ``utils/image.py`` for the resize,
       the colour map and the PNG

Each clip frame is blended with the map frame that covers it in time
(``align_frames``; the JAX engine broadcasts and raises where the map
keeps two or more frames but fewer than the clip, fault F10).

The JAX visualization builds its model without a compute dtype
(rspnet_tpu/moco/__init__.py:18, :89 of the engine), so this engine
computes in f32 on the card too: K1 runs its f32 instance here. The speed
pairing is drawn from a ``torch.Generator`` seeded from ``seed``, so two
runs with one seed write the same PNG bytes; a caller may pass the draws
in (``speed_draws``), as the parity tests pass the JAX engine's.
"""
from __future__ import annotations

import copy
import logging
from pathlib import Path

import numpy as np
import torch

from ..config import ConfigTree
from ..data.device_cache import clip_to_device
from ..data.pipeline import build_loader
from ..framework import load_state
from ..framework.environment import resolve_runtime
from ..models.convert import load_variables
from ..moco import build_moco_model, diff_speed_gather
from ..ops.augment import center_max_box, eval_preprocess
from ..utils.image import apply_jet, resize_linear_u8, write_png
from .finetune import _unsupported
from .normalization import dataset_normalization
from .transfer import load_pretrained_encoder, merge_encoder_into

logger = logging.getLogger(__name__)


def cam_maps(feat_q, feat_k, w_a_q, w_a_k, w_m_q, w_m_k):
    """feat_*: NDHWC [B, T, H, W, C]; w_*: [dim, C]. -> the four maps
    (qA, qM, kA, kM), each [B, T, H, W] (visualization.py:32-49)."""
    def gap(f):
        return f.mean(dim=(1, 2, 3))                      # [B, C]

    def project(w_src, x_src, w_dst, f_dst):
        b_n = torch.einsum("nc,bc->bn", w_src, x_src)     # [B, dim]
        b_c = torch.einsum("bn,nc->bc", b_n, w_dst)       # [B, C]
        return torch.einsum("bc,bthwc->bthw", b_c, f_dst)

    q_x, k_x = gap(feat_q), gap(feat_k)
    return (project(w_a_k, k_x, w_a_q, feat_q),
            project(w_m_k, k_x, w_m_q, feat_q),
            project(w_a_q, q_x, w_a_k, feat_k),
            project(w_m_q, q_x, w_m_k, feat_k))


def cam_rgbmask(cam: np.ndarray, out_hw) -> np.ndarray:
    """[T, h, w] -> uint8 RGB heatmaps [T, H, W, 3] (visualization.py:
    52-63, with OpenCV's resize and JET table from utils/image.py)."""
    t = cam.shape[0]
    lo, hi = cam.min(), cam.max()
    norm = (cam - lo) / max(hi - lo, 1e-12)
    out = np.empty((t, out_hw[0], out_hw[1], 3), np.uint8)
    for i in range(t):
        out[i] = apply_jet(resize_linear_u8(
            (norm[i] * 255).astype(np.uint8), out_hw))
    return out


def mask_clip(clip: np.ndarray, mask_rgb: np.ndarray, mean: np.ndarray,
              std: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend the heatmap onto the denormalized clip [T, H, W, 3] -> uint8
    (visualization.py:66-74); mean and std are the loader's."""
    frames = np.clip(clip * std + mean, 0, 1)
    blend = (1 - alpha) * frames + alpha * (mask_rgb.astype(np.float32) / 255)
    return (np.clip(blend, 0, 1) * 255).astype(np.uint8)


def align_frames(heat: np.ndarray, t: int) -> np.ndarray:
    """[t_map, H, W, 3] -> [t, H, W, 3]: each of the clip's t frames takes
    the map frame that covers it in time (nearest below). Repair of a JAX
    engine fault (F10, ROADMAP.md): there ``mask_clip`` broadcasts the map
    against the clip, which holds only for a one-frame map (or t_map = t);
    S3D-G and C3D at 16 frames give two-frame maps and raise. For a
    one-frame map this is that broadcast."""
    return heat[np.arange(t) * heat.shape[0] // t]


def save_strip(path: Path, frames: np.ndarray) -> None:
    """Save the first 8 frames of [T, H, W, 3] as one horizontal strip."""
    write_png(path, np.concatenate(list(frames[:8]), axis=1))


def _head_weights(model):
    """The linear heads' weights [dim, C]: A-VID (fc1), RSP (fc2)."""
    return model.fc1.linear.weight.detach(), model.fc2.linear.weight.detach()


class VisualizationEngine:
    def __init__(self, args, cfg: ConfigTree):
        self.args = args
        self.debug = bool(getattr(args, "debug", False))
        _unsupported(cfg, args)
        if int(getattr(args, "world_size", 1)) > 1:
            raise NotImplementedError(
                "CAM visualization on more than one card (--ws > 1) is not "
                "ported (see ROADMAP.md)")
        if cfg.get_string("moco.fc_type", "linear") != "linear":
            raise NotImplementedError(
                "CAM visualization requires linear heads (reference "
                "_get_fc_weight indexes the linear layer)")
        # the model stays f32 (the module's docstring)
        self.device, _ = resolve_runtime(getattr(args, "device", "cuda"))
        logger.info("CAM visualization computes in float32")
        # the VID pipeline's dataset.mean/std, identity under --debug
        self.normalize = dataset_normalization(cfg, vid_debug=self.debug)
        self._mean_np = np.array(self.normalize[0], np.float32)
        self._std_np = np.array(self.normalize[1], np.float32)

        self.seed = cfg.get_int("seed", 0)
        torch.manual_seed(self.seed)
        model, self.moco_cfg = build_moco_model(cfg, dtype=None)
        self.model_q = model.to(self.device,
                                memory_format=torch.channels_last_3d).eval()
        # the key side uses the query encoder until a MoCo checkpoint
        # gives the momentum encoder (visualization.py:112-115)
        self.model_k = self.model_q
        self.arch = cfg.get_string("model.arch")
        self.size = cfg.get_int("spatial_transforms.size")
        self.loader = build_loader(cfg, "train", vid=True, debug=self.debug,
                                   device=self.device)

    def load_moco_checkpoint(self, path) -> None:
        """A pretrain checkpoint of either package: the query side from
        ``params_q``, the key side from ``params_k``; any other file
        (reference, third party): its backbone on both sides, heads as
        built (visualization.py:117-133)."""
        cp = load_state(path)
        m = cp.get("model") if isinstance(cp, dict) else None
        if isinstance(m, dict) and "params_q" in m:
            load_variables(self.model_q, {"params": m["params_q"],
                                          "batch_stats": m["batch_stats_q"]},
                           self.arch)
            self.model_k = copy.deepcopy(self.model_q)
            load_variables(self.model_k, {"params": m["params_k"],
                                          "batch_stats": m["batch_stats_k"]},
                           self.arch)
        else:
            merge_encoder_into(self.model_q,
                               load_pretrained_encoder(path, self.arch))
            self.model_k = self.model_q
        logger.info("Loaded checkpoint %s", path)

    @torch.no_grad()
    def _features(self, model, clip: torch.Tensor) -> torch.Tensor:
        """NDHWC clip -> NDHWC feature map, eval mode."""
        fmap = model.encoder.features(clip.permute(0, 4, 1, 2, 3))
        return fmap.permute(0, 2, 3, 4, 1)

    def visual_epoch(self, max_batches: int = 4, speed_draws=None) -> int:
        """Render up to ``max_batches`` batches (one under ``--debug``);
        returns the number of PNGs written. ``speed_draws(batch_index,
        batch_size) -> (perm, speed_index)`` replaces the generator's
        draws of the speed pairing."""
        out_dir = Path(self.args.run_dir) / "cam"
        out_dir.mkdir(parents=True, exist_ok=True)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)
        n_saved = 0
        it = iter(self.loader)
        try:
            for bi, batch in enumerate(it):
                if bi >= max_batches:
                    break
                n_saved += self._visual_batch(bi, batch, out_dir, generator,
                                              speed_draws)
                if self.debug:
                    break
        finally:
            # an early break must not leave the loader's worker pool
            # suspended
            close = getattr(it, "close", None)
            if close is not None:
                close()
        logger.info("Saved %d CAM strips to %s", n_saved, out_dir)
        return n_saved

    def _visual_batch(self, bi, batch, out_dir, generator, speed_draws):
        qs, ks = batch["clips"][0], batch["clips"][1]
        B = qs.shape[0]
        # the centre max box: the geometry the encoder saw in training
        # (identity when the worker already resized to S x S)
        i0, j0, bh, bw = center_max_box(qs.shape[2], qs.shape[3], 1.0)
        boxes = np.array([[i0, j0, bh, bw]] * B, np.float32)
        mean, std = self.normalize
        clip_q, clip_k = (eval_preprocess(
            clip_to_device(c, self.device), boxes,
            size=(self.size, self.size), mean=mean, std=std)
            for c in (qs, ks))
        # the dual-speed pairing of training, q and k at matched speeds
        # (visualization.py:199-202)
        perm, speed_index = (speed_draws(bi, B) if speed_draws is not None
                             else (None, None))
        clip_q, clip_k, _ = diff_speed_gather(
            clip_q, clip_k, self.moco_cfg, perm=perm,
            speed_index=speed_index, generator=generator)
        w_a_q, w_m_q = _head_weights(self.model_q)
        w_a_k, w_m_k = _head_weights(self.model_k)
        maps = cam_maps(self._features(self.model_q, clip_q),
                        self._features(self.model_k, clip_k),
                        w_a_q, w_a_k, w_m_q, w_m_k)
        maps = [m.cpu().numpy() for m in maps]
        clips = {"q": clip_q.cpu().numpy(), "k": clip_k.cpu().numpy()}
        n_saved = 0
        for b in range(B):
            for name, cam in zip(("qA", "qM", "kA", "kM"), maps):
                clip = clips[name[0]][b]
                heat = cam_rgbmask(cam[b], (self.size, self.size))
                blended = mask_clip(clip, align_frames(heat, clip.shape[0]),
                                    self._mean_np, self._std_np)
                save_strip(out_dir / f"sample{bi}_{b}_{name}.png", blended)
                n_saved += 1
        return n_saved
