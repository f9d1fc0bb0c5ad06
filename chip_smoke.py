#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card: name and power limit (nvidia-smi);
  1. build every CUDA kernel of rspnet_tpu_torch/csrc (one nvcc per source,
     all at once), with the build time;
  2. each kernel against its plain-torch version on the card:
     K1/K2 (max pool fwd/bwd) at the 13 S3D-G pool sites (batch cut to 4)
     and at small shapes no site has (the generic instances, the
     one-channel path, the compile-time instances at other paddings and
     planes and, for K2's tiled instances, at C = 8 and 16 and the 7²
     non-local pool; for K1's, at (1,2,2)/(1,2,2) and (2,1,1)/(2,1,1), a
     tall C = 8 stem and a frame walk split into chunks), f32 and bf16,
     with and without ties, both
     bit-equal; K1/K2 (both builds) on inputs that hold NaN and -inf, and
     K2 on inputs whose corner windows are all -inf, NaN where the plain
     version has NaN and bit-equal elsewhere; K1/K2 on two tensors of over
     2^31 elements (the 64-bit index plans); K2 on views that start two
     elements into their storage (the plan's alignment check takes V = 1
     there); K3 (colour augment) over all
     24 op orders x gray on/off x flip on/off x gray before/after, uint8
     and f32 input, at [8, 32, 224, 224, 3], at the main path's batch 64,
     at four ragged shapes, at a clip too large for the resident instance
     (the generic one takes it) and through the color_augment_generic
     build; two K3 calls at the main shapes bit-identical;
  3. timing with CUDA events at the main path's shapes, beside the bound,
     the plain version and the library; K1/K2 in f32 and in bf16 (the
     main path's dtype), each also held bit-equal to its plain version
     there (K1 at the fused key pass's batch 128 too: f32 checked, bf16
     checked and timed beside batch 64), and their compile-time instances
     are timed against their generic instances (the max_pool3d_generic
     build), K1 also against F.max_pool3d (a ``K1<=lib`` flag a site, and
     where a tiled instance takes the site, ``tile<=1.05 generic``, from
     the kernels' device times in a CUDA graph where a call takes under
     50 us and is host-bound; each
     K1 line names its launch, ``fwd_plan``, and a last line counts the
     sites where either flag is False), K2 against aten's backward (a
     ``K2<=aten`` flag a site); K1's host time a call at a 7^2 site with
     the device idle, beside F.max_pool3d's; K3's resident instance
     against its generic one (the color_augment_generic build), u8 and
     f32, with its grid, and where its time goes clip by clip (the
     color_augment_timeline build, ``ops/k3_timeline.py``);
  4. the main path: ``rspnet_tpu_torch.pretrain.main`` on
     config/pretrain/s3dg.jsonnet with synthetic data and device geometry,
     3 steps (``-d``), counting kernel launches; the engine computes in
     bf16 on the card, so every K1/K2 launch must be bf16;
  5. ``--validate`` from phase 4's checkpoint: K1 and K3 launched, K2 not,
     finite metrics, and the model, its BN statistics and the queue equal
     to the checkpoint's bit for bit afterwards (the checkpoint holds the
     JAX package's layout, read back through ``models/convert.py``);
  6. the finetune path: ``rspnet_tpu_torch.finetune.main`` on
     config/finetune/ucf101_s3dg.jsonnet (S3D-G, 101 classes, 64 frames at
     224², batch 4) with synthetic data and device geometry, ``--mc`` from
     phase 4's checkpoint, one precise-BN batch, 3 bf16 train steps (``-d``),
     one validation batch and the final 10-crop validation of one batch
     (40 clips), counting kernel launches; then ``--validate`` from its
     checkpoint (the final 10-crop validation alone: K1 launched, K2 and
     K3 not). Before it, phases 2 and 3 hold K1/K2 bit-equal to their plain
     versions at the finetune path's 13 pool sites in bf16 (batch 4, and
     K1 at the final validation's batch 40) and time them, and hold K3 to
     its plain version on [4, 64, 224, 224, 3] clips (u8 and f32), which
     the generic instance takes, and time it.
  7. the C3D and ResNet-18 pretrain legs: ``rspnet_tpu_torch.pretrain.main``
     on config/pretrain/{c3d,resnet18}.jsonnet (published widths, batch 32
     and 64, 112², 32 -> 16 frames, K 16384), synthetic data, device
     geometry, 3 bf16 steps (``-d``): K1/K2 all bf16, K3 once per q and k
     clip in its resident instance;
  8. retrieval: ``rspnet_tpu_torch.retrieval.main`` on
     config/retrieval/ucf101_{c3d,resnet18}.jsonnet with ``--mc`` from
     phase 7's checkpoints, 24 synthetic clips per split (3 batches of 8
     clips x 10 crops, ``-d``): K1 all bf16, K2 and K3 not launched,
     finite [24, 512] features, every artifact, R@k monotone;
  9. CAM visualization: ``rspnet_tpu_torch.visualization.main`` on
     config/pretrain/s3dg.jsonnet with ``--mc`` from phase 4's checkpoint,
     batch cut to 8 (``-d``: one batch), twice: K1 all f32, K2 and K3 not
     launched, the 4 x 8 PNGs by the reference's names, each decoded with
     zlib to 224 x (224 * 8) RGB, and the second run's bytes equal to the
     first's. Before them, phases 2 and 3 hold K1/K2 bit-equal to their
     plain versions in bf16 at C3D's and ResNet-18's pool sites at the
     pretrain batches (K1 also at the fused key batch and at retrieval's
     batch 80) and K1 in f32 at the visualization's S3D-G sites (batch
     8), and time them, and time K3 on the zoo's pretrain clips.
 10. the R(2+1)D and TSM legs, bf16 at the published widths: 3 steps each
     of ``rspnet_tpu_torch.pretrain.main`` on config/pretrain/tsm-r18.jsonnet
     (TSM on resnet18, batch 64, 112², 16 -> 8 frames: K1 twice and K2
     once a step, all bf16, at the stem pool; K3 once per q and k clip)
     and on config/pretrain/r2plus1d.jsonnet (r2plus1d-vcop, batch 32,
     112², 32 -> 16 frames: K3 only); then ``rspnet_tpu_torch.finetune``
     on config/finetune/ucf101_r2plus1d.jsonnet with ``--mc`` from the
     R(2+1)D leg (batch 8 of 16 frames, 24 train clips: 3 steps, one
     validation batch, a final 10-crop validation of 8 clips, 80 clip
     forwards in one batch: K3 only), as published (multitask) and with
     ``model_type: '1stream'``. Before them, phases 2 and 3 hold K1/K2
     bit-equal to their plain versions in bf16 at TSM's stem pool site,
     [B, 8, 56, 56, 64] (1,3,3)/(1,2,2)/(0,1,1), at batch 64 and at the
     key pass's 128, and time them; and time K3 on the two legs' f32
     clips, [64, 16, 112, 112, 3] and [32, 32, 112, 112, 3], naming the
     instance that takes each.
 11. the rest of the zoo, bf16 at the published widths: 3 steps each of
     ``rspnet_tpu_torch.pretrain.main`` on config/pretrain/moco-train-base
     .jsonnet with ``arch: "slowfast"`` and the cfg_file
     config/slowfast-configs/Kinetics/SLOWFAST_NLN_4x16_R50.yaml (read by
     the port's YAML reader; batch 64, 112², 32 -> 16 frames, K 16384: K1
     14 and K2 7 a step, the two stem pools and the five non-local pools
     of the q pass and K1's of the fused key pass, all bf16; K3 once per q
     and k clip) and with ``arch: "mfnet"`` (K1 2, K2 1 a step at its stem
     pool); then ``rspnet_tpu_torch.finetune`` on
     config/finetune/ucf101_resnet18.jsonnet ``-x add.r18k400``
     (torchvision's r3d_18, random weights, the ``pretrain: true``
     warning; batch 32 of 16 frames at 112², 96 train clips: 3 steps, one
     validation batch of 8 clips, a final 10-crop validation of 8 clips:
     K3 only). Before them, phases 2 and 3 hold K1/K2 bit-equal to their
     plain versions in bf16 at each new pool site (SlowFast's slow stem
     [B, 2, 56, 56, 64] and fast stem [B, 16, 56, 56, 8], its non-local
     pools (1,2,2)/(1,2,2) on [B, 2, 14, 14, 512] and [B, 2, 7, 7, 1024],
     whose last row and column lie in no window and take exactly 0 from
     K2, MFNet's stem pool [B, 16, 56, 56, 16], C2D / I3D's (2,1,1)
     temporal pool [B, 8, 28, 28, 256]) at batch 64 (K1 also at 128), and
     time them.
 12. the pretrain engine's options, bf16 at the published widths: 3 steps
     of ``rspnet_tpu_torch.pretrain.main`` on config/pretrain/s3dg.jsonnet
     (batch 64, 224², K 16384) with ``moco+: {aug_plus: true, diff_speed:
     [4, 2], packed_frames: true}`` and the Adam preset of
     config/lib/optim.libsonnet: 64 loaded frames, the exact union of 48
     shipped, a speed drawn each step (4, 2, 2 from seed 0: T_real 16,
     then 32), K3 with gray after the jitter, mean 0 and std 1 before the
     gaussian blur of half the clips; K1 26 and K2 13 a step, all bf16, K3
     once per q and k clip; then ``--validate`` from its checkpoint (both
     speeds drawn again, K2 not launched). Before it, phase 2 holds K3 to
     its plain version in this mode on [64, 48, 224, 224, 3] (about 20%
     rows unjittered) and phases 2/3 hold K1/K2 bit-equal at the speed-2
     branch's 13 sites (32 frames; batch 64, K1 also 128) and time them,
     time K3 in this mode, and time the blur alone, checked against the
     CPU.
 13. more than one rank, on the one card (two processes share it: the
     numbers measure the collectives' overhead, not scaling), at full
     width (config/pretrain/s3dg.jsonnet, 224², T 32 -> 16, K 16384,
     global batch 64 = 2 ranks x 32): (a) two ranks of
     ``chip_smoke.py --multirank`` in one gloo group, 1-D layout: one f32
     step held to the one-rank f32 step on the global batch with the same
     draws (limits ``P13_TOL``), then 3 bf16 steps from uint8 clips (K1
     26, K2 13 calls, K3 2 a step a rank, exactly; the all-reduces
     counted), the ranks' parameters, BN statistics, queue and pointer
     bit-equal after each; (b) the same ranks in the 2-D layout
     ``parallel: {data: 1, model: 2}``, one f32 step held to the same
     one-rank step (the queue gathered dense); (c) an NCCL group of one
     rank: one bf16 step through every collective equals the step without
     a group bit for bit, and 3 bf16 steps of one process at the per-rank
     batch are timed with the BNs' moments over that group (the
     cross-replica BN's cost a rank) beside 3 without a group; (d) phase
     4 runs the CLI with ``--ws 1``: no group, no collective. Phases 2/3
     hold K1/K2 bit-equal at the per-rank q batch (32, bf16) and K3 to
     its plain version on its clips, and time them.
 14. the device-resident dataset cache (``cache_device``,
     rspnet_tpu_torch/data/device_cache.py) and the native decoder, run
     after phase 12 while phases 4-9's checkpoints exist: (a) phase 4's
     run with ``cache_device: true``: the 256 synthetic samples cached on
     the card (two uint8 clips of 32 x 128 x 171 each, ``P14_BYTES``), the
     build timed, 3 bf16 steps with the launches of phase 4 (K1 26, K2 13,
     K3 2 a step, all bf16) and no clip copied from the host; (b) every
     cached sample bit-equal to the uncached loader's clip, and a batch of
     epoch 1 equal to the rows its order names; (c) phase 6's finetune,
     phase 8's ResNet-18 retrieval and phase 9's CAM run with
     ``cache_device: true``: the launches of their uncached runs, no clip
     copied, retrieval's test features equal to phase 8's bit for bit;
     (d) the native FFmpeg decoder builds with g++ (or its build error is
     printed: the loader decodes with OpenCV then); when built, an MJPG
     that the ffmpeg program writes decodes bit-equal across two calls,
     and within 2 levels of OpenCV where OpenCV exists. The cached runs'
     launches join the JSON line.
 15. the RGB stems, after phase 3: each convolution with fewer than 8
     input channels of each backbone of ``STEM_ARCHS`` (S3D-G, ResNet-3D,
     C3D, R(2+1)D, TSM, SlowFast's two, MFNet, r3d_18), read from the built
     model, at its pretrain clip, bf16 from an f32 clip and weight as the backbones cast them:
     the plain ``F.conv3d`` beside ``models/common.py:conv3d``, which runs
     the stride-2 stems as ``SpaceToDepthConv3d`` (2x2 pixel blocks folded
     into 16 channels), the forward timed at the fused key pass's batch 128
     and the forward and weight gradient at the q batch 64, the kernels of
     each named, output and weight gradient held to the f32 convolution of
     the same bf16 values; no packed stem may be slower than its plain
     call. Phases 4, 7, 10 and 11 count 2 packed stem forwards a step (4
     on SlowFast, 0 on C3D), phase 9 (f32) none.
 16. the temporal convolutions, after phase 15: each (kt, 1, 1)
     convolution with kt > 1 of R(2+1)D-10, S3D-G, SlowFast
     (SLOWFAST_NLN_4x16_R50) and MFNet (none: its temporal kernels are
     3^3), as a bf16 forward of one clip on the card reaches it, in bf16
     channels-last memory at the pretrain clip: ``F.conv3d`` beside
     ``models/common.py:temporal_conv2d`` (a 2-D convolution with a (kt,
     1) kernel on the free [N, C, T, H*W] view), the forward timed at the
     fused key pass's batch and the forward, input gradient and weight
     gradient at the q batch (32 on R(2+1)D, else 64), by the device ms
     of their kernels, twice in turns (and once by CUDA events), the
     kernels of each named, the output and both gradients held to the f32
     convolution of the same bf16 values. No f32 kernel may remain at
     R(2+1)D's three 56² sites, and no site ``temporal_as_2d`` takes may be
     slower in the 2-D form, fwd + bwd, by more than the timings' spread
     (``TEMPORAL_NOISE`` at least). Sites the rule leaves to the 3-D
     call (more than 128 outputs) are timed in both forms too. Phases 4,
     7, 10 and 11 count the 2-D forms a step
     (``backbone.temporal_2d_calls``: 22 on S3D-G, 10 on R(2+1)D, 38 on
     SlowFast, 0 on C3D, ResNet-18, TSM and MFNet), phase 9 (f32) none.
Then one JSON line with the kernels, the card line again, and the result
line ``{"ok": true, "device": {...}}`` last. Any failure exits non-zero
before the result line. Imports nothing of JAX or of rspnet_tpu.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores

# (site, per-clip input [T, H, W, C], kernel, stride, padding) of S3D-G at a
# [B, 16, 224, 224, 3] input (rspnet_tpu_torch/models/s3dg.py)
POOL_SITES = [
    ("maxPool1", (8, 112, 112, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("maxPool2", (8, 56, 56, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("sepInc_3b.branch3", (8, 28, 28, 192), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_3c.branch3", (8, 28, 28, 256), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxPool_sepInc_4b", (8, 28, 28, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("sepInc_4b.branch3", (4, 14, 14, 480), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4c.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4d.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4e.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4f.branch3", (4, 14, 14, 528), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxPool_sepInc_5b", (4, 14, 14, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ("sepInc_5b.branch3", (2, 7, 7, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_5c.branch3", (2, 7, 7, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
]
# (name, [T, H, W, C], kernel, stride, padding) that no S3D-G site has: the
# kernels' one-channel-per-thread path (C % 4 != 0) and their generic
# instances (C % 4 == 0, a geometry without a compile-time instance), over
# the pooling suite's odd geometries and k = 2, p = 1 (an output longer
# than its input); and the compile-time instances (C % 4 == 0, S3D-G's
# geometries) at paddings and planes S3D-G does not have: K1's floor tail,
# a frame walk from t = -1, no padding, ragged tiles and a partial
# channel chunk
EXTRA_POOL_SITES = [
    ("odd.floor_tail", (8, 15, 15, 5), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("odd.window_eq_stride", (5, 9, 9, 2), (3, 3, 3), (3, 3, 3), (0, 0, 0)),
    ("odd.branch3", (8, 14, 14, 6), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("odd.c3d_pool1", (16, 16, 16, 3), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("odd.k2_p1", (3, 5, 5, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1)),
    ("generic.c3d_pool1", (16, 16, 16, 8), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("generic.window_eq_stride", (5, 9, 9, 8), (3, 3, 3), (3, 3, 3),
     (0, 0, 0)),
    ("generic.k2_p1", (3, 5, 5, 4), (2, 2, 2), (1, 1, 1), (1, 1, 1)),
    ("generic.mixed", (6, 9, 10, 12), (3, 2, 3), (2, 1, 3), (1, 0, 1)),
    ("tile.floor_tail", (8, 15, 15, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("tile.k2_p1", (3, 5, 5, 4), (2, 2, 2), (2, 2, 2), (1, 1, 1)),
    ("tile.branch3_p0", (5, 9, 11, 8), (3, 3, 3), (1, 1, 1), (0, 0, 0)),
    ("tile.stem_odd", (4, 9, 13, 12), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    # K2's tiled instances where a block trades channel vectors for pixels
    # (C / V of 1 and 2 in bf16), and the (1,2,2) non-local pool at 7²
    # with its floor tail
    ("tile.stem_c8", (4, 28, 28, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("tile.stem_c16", (4, 28, 28, 16), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("tile.branch3_c8", (4, 14, 14, 8), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("tile.nl_7x7", (2, 7, 7, 64), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    # K1's tiled instances at (1,2,2)/(1,2,2) with a floor tail in W, at
    # (2,1,1)/(2,1,1) with one in T, a bf16 C = 8 stem on a tall ragged
    # plane, and a 7^2 frame whose walk is split at the batch of phase 2
    # (To = 2, a chunk a frame)
    ("tile.c3d_pool1_c64", (4, 28, 31, 64), (1, 2, 2), (1, 2, 2),
     (0, 0, 0)),
    ("tile.c2d_pool1", (5, 9, 10, 16), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ("tile.stem_c8_tall", (3, 57, 55, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("tile.split_7x7", (4, 7, 7, 832), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
]
# ([B, T, H, W, C], kernel, stride, padding, dtype) of tensors with 2^31 or
# more elements: the 64-bit index plans of K1 and K2, on the four-channel
# path in f32 (a floor tail on H and W) and the one-channel path in bf16
WIDE_POOL_SITES = [
    ((33, 16, 1023, 1025, 4), (3, 3, 3), (2, 2, 2), (1, 1, 1), "float32"),
    ((43, 16, 1024, 1024, 3), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16"),
]
# sites whose inputs hold NaN and -inf (phase 2): each K1 instance (the
# four S3D-G geometries, also at their edge cases, (1,2,2)/(1,2,2) and
# (2,1,1)/(2,1,1), a C = 8 stem, a split frame walk) and the generic one
# (C % 4 != 0, another geometry); K2's tiled instances at C = 8 and 16
# (bf16: one and two vectors a pixel) and at the non-local pool
NAN_POOL_SITES = ("maxPool1", "sepInc_3b.branch3", "maxPool_sepInc_4b",
                  "maxPool_sepInc_5b", "sepInc_5b.branch3", "odd.floor_tail",
                  "generic.mixed", "tile.floor_tail", "tile.k2_p1",
                  "tile.branch3_p0", "tile.stem_odd", "tile.stem_c8",
                  "tile.stem_c16", "tile.branch3_c8", "tile.nl_7x7",
                  "tile.c3d_pool1_c64", "tile.c2d_pool1",
                  "tile.stem_c8_tall", "tile.split_7x7")
GENERIC = "max_pool3d_generic"   # the build without compile-time instances
K3_TOL = 1e-4
COLOR_CLIP = (32, 224, 224)     # [T, H, W] of a K3 clip on the main path
# (batch, [T, H, W]) of K3 checks off the main path's shape: rows that are
# not multiples of 16 bytes (W % 4 != 0, and u8 rows of 60 bytes), a
# tensor whose byte count is no multiple of 16, a ragged last CTA (371
# rows on 132 or 264 CTAs) and CTAs with no rows
RAGGED_COLOR = [(5, (7, 9, 13)), (3, (3, 100, 101)), (3, (7, 53, 101)),
                (4, (5, 9, 20))]
# a clip whose slices do not fit the co-resident grid: the generic instance
LARGE_COLOR = (2, (64, 480, 640))
MAIN_BATCH = 64                # batch_size of config/pretrain/s3dg.jsonnet
# the finetune path (config/finetune/ucf101_s3dg.jsonnet): batch 4 of 64
# frames, 4x the frames of a pretrain clip after its speed gather, so each
# pool site's input has 4x the frames; the final validation folds 10 crops
# of each of 4 clips into a batch of 40
FT_BATCH, FT_FRAMES, FT_FINAL_BATCH = 4, 64, 40
FT_POOL_SITES = [(name, (4 * t, h, w, c), k, s, p)
                 for name, (t, h, w, c), k, s, p in POOL_SITES]
FT_CONFIG = "config/finetune/ucf101_s3dg.jsonnet"
# the zoo's pool sites ([T, H, W, C] per clip, kernel, stride, padding) at
# a [B, 16, 112, 112, 3] clip: C3D's four (rspnet_tpu_torch/models/c3d.py;
# pool1 has no tile instance, the generic K1 takes it) and ResNet-18's one
# (models/resnet3d.py)
ZOO_POOL_SITES = {
    "c3d": [
        ("c3d.pool1", (16, 112, 112, 64), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
        ("c3d.pool2", (16, 56, 56, 128), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
        ("c3d.pool3", (8, 28, 28, 256), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
        ("c3d.pool4", (4, 14, 14, 512), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ],
    "resnet18": [
        ("resnet18.maxpool", (16, 56, 56, 64), (3, 3, 3), (2, 2, 2),
         (1, 1, 1)),
    ],
}
# the pretrain configs' batches (config/pretrain/{c3d,resnet18}.jsonnet);
# retrieval folds 10 crops of each of 8 clips into one batch
# (config/retrieval/ucf101_*.jsonnet); the visualization path's batch, cut
# from config/pretrain/s3dg.jsonnet's 64
ZOO_BATCH = {"c3d": 32, "resnet18": 64}
RET_BATCH, RET_CLIPS, VIS_BATCH = 80, 24, 8
# phase 10: TSM's stem pool (rspnet_tpu_torch/models/tsm.py) on a
# [B, 8, 112, 112, 3] q clip; the legs' configs, batches and clip frames
# before the speed gather; the R(2+1)D finetune (batch 8 = 16 x its
# bs_factor 0.5; one validation batch; 8 clips x 10 crops in the final
# validation)
TSM_POOL_SITES = [("tsm.stem_pool", (8, 56, 56, 64), (1, 3, 3), (1, 2, 2),
                   (0, 1, 1))]
P10_PRETRAIN = {  # leg -> (config, batch, frames, (K1, K2) calls a step)
    "tsm": ("config/pretrain/tsm-r18.jsonnet", 64, 16, (2, 1)),
    "r2plus1d": ("config/pretrain/r2plus1d.jsonnet", 32, 32, (0, 0)),
}
R21D_FT_CONFIG = "config/finetune/ucf101_r2plus1d.jsonnet"
R21D_FT_BATCH = 8
# phase 11: the new pool sites ([T, H, W, C] per clip at a [B, 16, 112,
# 112, 3] q clip): SlowFast's (rspnet_tpu_torch/models/slowfast.py; the
# slow pathway sees T // alpha = 2 frames, the fast one 64 // beta_inv = 8
# channels; SLOWFAST_NLN_4x16_R50 pools in 2 non-local blocks of res3 at
# 14² and 3 of res4 at 7², where row and column 6 lie in no window),
# MFNet's stem pool (models/mfnet.py) and C2D / I3D's temporal pool after
# res2 (not on a leg of this phase: C2D_8x8_R50's 8 frames, res2's 256
# channels)
P11_POOL_SITES = {
    "slowfast_pretrain": [
        ("slowfast.slow_stem", (2, 56, 56, 64), (1, 3, 3), (1, 2, 2),
         (0, 1, 1)),
        ("slowfast.fast_stem", (16, 56, 56, 8), (1, 3, 3), (1, 2, 2),
         (0, 1, 1)),
        ("slowfast.nl_res3", (2, 14, 14, 512), (1, 2, 2), (1, 2, 2),
         (0, 0, 0)),
        ("slowfast.nl_res4", (2, 7, 7, 1024), (1, 2, 2), (1, 2, 2),
         (0, 0, 0)),
    ],
    "mfnet_pretrain": [
        ("mfnet.stem_pool", (16, 56, 56, 16), (1, 3, 3), (1, 2, 2),
         (0, 1, 1)),
    ],
    "c2d_pool1": [
        ("c2d.pool1", (8, 28, 28, 256), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ],
}
P11_BATCH = 64                 # batch_size of moco-train-base.jsonnet
SLOWFAST_YAML = "config/slowfast-configs/Kinetics/SLOWFAST_NLN_4x16_R50.yaml"
P11_PRETRAIN = {  # leg -> (the -x fields, (K1, K2) calls a step)
    "slowfast": ('arch: "slowfast", model+: {cfg_file: "%s"}'
                 % SLOWFAST_YAML, (14, 7)),
    "mfnet": ('arch: "mfnet"', (2, 1)),
}
R3D18_FT_CONFIG = "config/finetune/ucf101_resnet18.jsonnet"
# batch 32 (64 x its bs_factor 0.5), 3 train steps; 8 validation clips
# (one batch), 8 clips x 10 crops in the final validation
R3D18_FT_BATCH, R3D18_FT_VAL = 32, 8
# phase 12: the pretrain engine's options on config/pretrain/s3dg.jsonnet
# (aug_plus, exact multi-speed with packed frames, config/lib/optim
# .libsonnet's Adam preset); 64 loaded frames, 48 of them packed; the
# speed-2 branch trains on 32-frame clips, so each S3D-G pool site sees
# twice the main path's frames
P12_FIELDS = ('moco+: {aug_plus: true, diff_speed: [4, 2], packed_frames: '
              'true}, optimizer: {type: "adam", lr: 1e-3, eps: 1e-8, '
              'schedule: "none"}')
P12_SPEEDS, P12_LOADED, P12_PACKED = (4, 2), 64, 48
S2_POOL_SITES = [(name, (2 * t, h, w, c), k, s, p)
                 for name, (t, h, w, c), k, s, p in POOL_SITES]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# phase 13: two ranks share the card, per-rank batch 32 of a global 64
P13_RANKS, P13_BATCH = 2, 32
P13_GLOBAL = P13_RANKS * P13_BATCH
P13_TIMEOUT_S = 600
# f32 limits of a multi-rank step against the one-rank step on the same
# global batch and draws. The two differ only in rounding: the gradient
# summed over two halves, BN moments as E[x^2] - E[x]^2 over two halves
# (the JAX package's formula) against cuDNN's, cuDNN's algorithms at batch
# 32 against 64. What the forward computes (BN statistics, keys, loss)
# moves by about 1e-6 of its scale; the update goes through S3D-G's whole
# backward, where one step's f32 rounding alone moves it by up to a few
# percent (rank 0 prints that floor: the one-rank step on the batch with
# its rows reversed). A layout fault moves each by its own size: a
# gradient summed, not averaged, an update error of 1; each rank's own
# gradient, one near 1; BN moments of one rank, statistics off by about
# 1e-1 of their scale; keys out of rank order, a queue error near 1.
P13_TOL = {"update_rel_l2": 0.1, "bn_stats_rel": 1e-3,
           "key_params_rel": 1e-6, "queue_abs": 1e-3, "loss_rel": 1e-3,
           "acc_abs": 100.0 / P13_GLOBAL}
# phase 14: the synthetic dataset's 256 samples cached at decode
# resolution, two uint8 clips of 32 frames of 128 x 171 each
P14_SAMPLES = 256
P14_BYTES = P14_SAMPLES * 2 * 32 * 128 * 171 * 3
# phase 15: arch -> (the model keys of its pretrain config, the clip
# [T, H, W] it sees in pretraining at 112² (S3D-G at 224²)); its stems are
# the built backbone's convolutions with fewer than 8 input channels
# (SlowFast's slow pathway takes T // alpha of the frames), timed at the q
# batch (forward and weight gradient) and the fused key pass's (forward)
STEM_ARCHS = {
    "s3dg": ({}, (16, 224, 224)),
    "resnet18": ({}, (16, 112, 112)),
    "c3d": ({}, (16, 112, 112)),
    "r2plus1d-vcop": ({}, (16, 112, 112)),
    "tsm": ({"base_model": "resnet18", "num_segments": 8}, (8, 112, 112)),
    "slowfast": ({}, (16, 112, 112)),
    "mfnet": ({}, (16, 112, 112)),
    "torchvision-resnet18": ({}, (16, 112, 112)),
}
STEM_BATCH = 64
# phase 16: arch -> (the model keys of its pretrain config, the clip
# [T, H, W] it sees in pretraining, its q batch); the sites are the built
# backbone's (kt, 1, 1) convolutions with kt > 1 as a bf16 forward on the
# card reaches them, timed at the q batch (forward, input and weight
# gradient) and the fused key pass's (forward). MFNet has none: its
# temporal kernels are (3, 3, 3)
TEMPORAL_ARCHS = {
    "r2plus1d-vcop": ({}, (16, 112, 112), 32),
    "s3dg": ({}, (16, 224, 224), 64),
    "slowfast": ({"cfg_file": "config/slowfast-configs/Kinetics/"
                  "SLOWFAST_NLN_4x16_R50.yaml"}, (16, 112, 112), 64),
    "mfnet": ({}, (16, 112, 112), 64),
}
# the convolutions ``models/common.py:temporal_as_2d`` takes in a forward
# of each pretrain leg's backbone on the card (a MoCo step runs two: the
# fused key pass and the query pass)
TEMPORAL_2D_A_FORWARD = {"s3dg": 11, "r2plus1d": 5, "slowfast": 19,
                         "mfnet": 0, "c3d": 0, "resnet18": 0, "tsm": 0}
# the slowest a site's 2-D form may be against its 3-D call, as a share of
# the 3-D call's fwd + bwd device time, where two timings of one form
# differ by less (the profiler's kernel times of 10 calls: on the H100 the
# two turns of a site differed by 0.5% in the median, by 2% at most at 38
# of 41 sites)
TEMPORAL_NOISE = 0.02


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_calls_ms(fn) -> float:
    """time_ms over 20 calls after 5 to warm up (with 5 after 2, the first
    site of a phase ran up to 17% slow, the card coming back from the
    plain version's host-bound calls), or over 200 where a call takes
    under 50 us: there the call's host time is its time, and its noise
    needs more calls to average out."""
    t = time_ms(fn, 20, 5)
    return time_ms(fn, 200, 5) if t < 0.05 else t


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """The device time of one call of fn: ``calls`` calls captured in a
    CUDA graph, replayed ``replays`` times between two events (no host
    time between the kernels)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_pool(dev, batch: int):
    """K1/K2 vs plain at every site; returns the largest f32 abs errors
    (forward, backward)."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_fwd = worst = 0.0
    for name, shape4, k, s, p in POOL_SITES + EXTRA_POOL_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for ties in (False, True):
                x = torch.randn((batch, *shape4), generator=gen, device=dev)
                if ties:
                    x = torch.relu(x)
                x = x.to(dtype)
                out = mp.max_pool3d_fwd(x, k, s, p)
                ref = mp.max_pool3d_fwd_plain(x, k, s, p)
                require(torch.equal(out, ref),
                        f"K1 {name} {dtype} ties={ties}: forward differs")
                worst_fwd = max(worst_fwd,
                                float((out.float() - ref.float()).abs().max()))
                g = torch.randn(out.shape, generator=gen,
                                device=dev).to(dtype)
                dx = mp.max_pool3d_bwd(x, g, k, s, p)
                dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
                torch.cuda.synchronize()
                err = float((dx.float() - dref.float()).abs().max())
                gsum = float(g.double().sum())
                dsum = float(dx.double().sum())
                scale = float(g.double().abs().sum())
                require(torch.equal(dx, dref),
                        f"K2 {name} {dtype} ties={ties}: not bit-equal "
                        f"(max err {err})")
                # bf16 rounds each stage's cotangent, so its sum drifts
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                require(abs(dsum - gsum) <= tol * scale,
                        f"K2 {name} {dtype}: gradient sum {dsum} != {gsum}")
                worst = max(worst, err)
                print(f"check K1/K2 {name:20s} {str(dtype):15s} ties={ties!s:5}"
                      f" fwd=bit-equal bwd_max_abs_err={err:.3g} "
                      f"bwd_bit_equal={torch.equal(dx, dref)}", flush=True)
    return worst_fwd, worst


def check_pool_nan(dev, batch: int) -> None:
    """K1 and K2 (default and generic builds) on inputs with NaN and -inf
    cells, and K2 on inputs whose corner windows are all -inf: the NaN
    masks equal the plain version's, the other values are bit-equal."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    def same(out, ref):
        nan = torch.isnan(ref)
        return (torch.equal(torch.isnan(out), nan)
                and torch.equal(out[~nan], ref[~nan])), int(nan.sum())

    gen = torch.Generator(device=dev).manual_seed(5)
    sites = {name: rest for name, *rest in POOL_SITES + EXTRA_POOL_SITES}
    for name in NAN_POOL_SITES:
        shape4, k, s, p = sites[name]
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("nan", "edge"):
                x = torch.randn((batch, *shape4), generator=gen, device=dev)
                if case == "nan":       # 1% NaN, 1% -inf
                    u = torch.rand(x.shape, generator=gen, device=dev)
                    x = x.masked_fill(u < 0.01, float("nan"))
                    x = x.masked_fill((u >= 0.01) & (u < 0.02),
                                      float("-inf"))
                else:                   # all -inf windows at both corners
                    x[:, :k[0], :k[1], :k[2]] = float("-inf")
                    x[:, -k[0]:, -k[1]:, -k[2]:] = float("-inf")
                x = x.to(dtype)
                ref = mp.max_pool3d_fwd_plain(x, k, s, p)
                g = torch.randn(ref.shape, generator=gen,
                                device=dev).to(dtype)
                dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
                # the cotangent the plain version drops (NaN and pad routes)
                dropped = float(g.double().sum() - dref.double().sum())
                launch = {b: fwd_plan_text(mp.fwd_plan(x.shape, k, s, p,
                                                       dtype, build=b))
                          for b in ("max_pool3d", GENERIC)}
                for build in ("max_pool3d", GENERIC):
                    ok_f, n_f = (same(mp.max_pool3d_fwd(x, k, s, p,
                                                        build=build), ref)
                                 if case == "nan" else (True, 0))
                    ok_b, n_b = same(mp.max_pool3d_bwd(x, g, k, s, p,
                                                       build=build), dref)
                    print(f"check K1/K2 {case:4s} {name:20s} {str(dtype):15s}"
                          f" {build:18s} fwd nan {n_f}/{ref.numel()} same "
                          f"{ok_f} | bwd nan {n_b}, dropped g sum "
                          f"{dropped:.4g}, same NaN mask and values {ok_b}"
                          f" | K1 {launch[build]}", flush=True)
                    require(ok_f and ok_b,
                            f"K1/K2 {case} {name} {dtype} {build}: differs "
                            f"from the plain version (fwd {ok_f}, bwd "
                            f"{ok_b})")


def check_pool_offset(dev) -> None:
    """K2 on x, g whose data start two elements into their storage (4 or 8
    bytes off: the plan's alignment check takes V = 1), at an S3D-G
    geometry, held bit-equal to the plain version."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(7)
    name, shape4, k, s, p = POOL_SITES[2]
    shape = (4, *shape4)
    for dtype in (torch.float32, torch.bfloat16):
        n = math.prod(shape)
        x = torch.randn(n + 2, generator=gen, device=dev).relu_().to(
            dtype)[2:].view(shape)
        oshape = mp._out_shape(shape, k, s, p)
        g = torch.randn(math.prod(oshape) + 2, generator=gen,
                        device=dev).to(dtype)[2:].view(oshape)
        same = torch.equal(mp.max_pool3d_bwd(x, g, k, s, p),
                           mp.max_pool3d_bwd_plain(x, g, k, s, p))
        print(f"check K2 {name} {list(shape)} {dtype} at storage offset "
              f"{x.storage_offset()} ({x.data_ptr() % 16} bytes past 16): "
              f"bit-equal {same}", flush=True)
        require(same, f"K2 on an offset view {dtype}: differs from plain")


def check_pool_wide(dev) -> None:
    """K1/K2 on tensors of 2^31 or more elements (the 64-bit index plans),
    held bit-equal to the plain version clip by clip."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(4)
    for shape, k, s, p, dtype_name in WIDE_POOL_SITES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, generator=gen, device=dev).relu_().to(dtype)
        out = mp.max_pool3d_fwd(x, k, s, p)
        g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        dx = mp.max_pool3d_bwd(x, g, k, s, p)
        require(max(x.numel(), out.numel()) >= 2 ** 31,
                f"wide case {shape} is under 2^31 elements")
        fwd_eq = bwd_eq = True
        for lo in range(0, shape[0], 4):
            xs, gs = x[lo:lo + 4], g[lo:lo + 4]
            fwd_eq &= torch.equal(out[lo:lo + 4],
                                  mp.max_pool3d_fwd_plain(xs, k, s, p))
            bwd_eq &= torch.equal(dx[lo:lo + 4],
                                  mp.max_pool3d_bwd_plain(xs, gs, k, s, p))
        what = f"K1/K2 64-bit plan {list(shape)} k={k} s={s} p={p} {dtype_name}"
        print(f"check {what}: {x.numel()} elements, fwd bit-equal {fwd_eq}, "
              f"bwd bit-equal {bwd_eq}", flush=True)
        require(fwd_eq and bwd_eq, f"{what}: differs from the plain version")
        del x, out, g, dx
        torch.cuda.empty_cache()


def _color_args(rng, n):
    import numpy as np
    return np.stack([rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
                     rng.uniform(0.6, 1.4, n), rng.uniform(-0.4, 0.4, n)],
                    1).astype(np.float32)


def _color_input(gen, dev, shape, in_u8: bool):
    import torch
    if in_u8:
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
    return torch.rand(shape, generator=gen, device=dev)


def color_plan_line(shape, in_u8: bool, build: str = "color_augment") -> str:
    from rspnet_tpu_torch.ops import color_augment as ca
    p = ca.launch_plan(shape, in_u8, build=build)
    if not p["resident"]:
        return f"generic instance, {p['ctas']} blocks per clip"
    return (f"resident instance, {p['ctas']} CTAs ({p['ctas_per_sm']} per "
            f"SM), {p['rows_per_cta']} rows per CTA in {p['chunks']} chunks "
            f"of {p['rows_per_chunk']}, a ring of {p['slots']} slots, "
            f"{p['smem_bytes']} B shared memory")


def check_color(dev, batch: int, clip, resident: bool = True,
                build: str = "color_augment") -> float:
    """K3 vs plain over every order x gray x flip x gray-before, u8 and f32
    input, on clips [T, H, W] in batches of ``batch``; the instance the
    plan takes must be the resident one iff ``resident``. Returns the
    largest abs error on the normalized output."""
    import itertools

    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    combos = [(o, gr, fl) for o in itertools.permutations(range(4))
              for gr in (False, True) for fl in (False, True)]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for in_u8 in (True, False):
        shape = (batch, *clip, 3)
        plan = ca.launch_plan(shape, in_u8, build=build)
        line = color_plan_line(shape, in_u8, build)
        require(bool(plan["resident"]) == resident,
                f"K3 {build} {list(shape)} u8={in_u8}: {line}, expected the "
                f"{'resident' if resident else 'generic'} instance")
        for gray_first in (True, False):
            err_case = 0.0
            for lo in range(0, len(combos), batch):
                part = combos[lo:lo + batch]
                n = len(part)
                order = np.asarray([c[0] for c in part], np.int32)
                gray = np.asarray([c[1] for c in part])
                flip = np.asarray([c[2] for c in part])
                x = _color_input(gen, dev, (n, *clip, 3), in_u8)
                kw = dict(mean=(0.485, 0.456, 0.406),
                          std=(0.229, 0.224, 0.225),
                          gray_before_jitter=gray_first)
                factors = _color_args(rng, n)
                out = ca.color_augment(x, order, factors, gray, flip,
                                       build=build, **kw)
                ref = ca.color_augment_plain(x, order, factors, gray, flip,
                                             **kw)
                err_case = max(err_case, float((out - ref).abs().max()))
                del x, out, ref
            print(f"check K3 {build} [{batch},{','.join(map(str, clip))},3] "
                  f"gray_before={gray_first!s:5} input="
                  f"{'u8' if in_u8 else 'f32'} max_abs_err={err_case:.3g} "
                  f"(limit {K3_TOL}); {line}", flush=True)
            require(err_case <= K3_TOL, f"K3 error {err_case} > {K3_TOL}")
            worst = max(worst, err_case)
    torch.cuda.empty_cache()
    return worst


def check_color_repeat(dev, batch: int, clip) -> None:
    """Two K3 calls on the same inputs give the same bits (the clip mean is
    summed in a fixed order, no atomics on floats)."""
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    order = np.stack([rng.permutation(4) for _ in range(batch)]).astype(
        np.int32)
    gray, flip = rng.random(batch) < 0.5, rng.random(batch) < 0.5
    factors = _color_args(rng, batch)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    for in_u8 in (False, True):
        x = _color_input(gen, dev, (batch, *clip, 3), in_u8)
        a = ca.color_augment(x, order, factors, gray, flip, **kw)
        b = ca.color_augment(x, order, factors, gray, flip, **kw)
        same = torch.equal(a, b)
        print(f"check K3 repeat [{batch},{','.join(map(str, clip))},3] "
              f"input={'u8' if in_u8 else 'f32'}: two calls bit-identical "
              f"{same}", flush=True)
        require(same, "K3: two calls on the same inputs differ")
        del x, a, b
    torch.cuda.empty_cache()


def _aug_plus_args(rng, batch: int):
    """The engine's aug_plus draw (jitter (0.4, 0.4, 0.4, 0.1) with
    probability 0.8, gray 0.2, flip 0.5): order, factors (unjittered rows
    (1, 1, 1, 0)), gray, flip."""
    from rspnet_tpu_torch.ops.augment import sample_train_params
    p = sample_train_params(rng, batch, [(1, 1)], crop_area=(1.0, 1.0),
                            h_flip=0.5, gray_p=0.2,
                            jitter=(0.4, 0.4, 0.4, 0.1), jitter_p=0.8,
                            blur_p=0.5)
    return p.order, p.jitter, p.gray, p.flip


def check_color_aug_plus(dev, batch: int, clip) -> float:
    """K3 against its plain version in the aug_plus mode of phase 12: gray
    after the jitter, about 20% unjittered rows, mean 0 and std 1 (the
    blur and the normalize follow outside K3), f32 input as the device
    geometry gives it. Returns the largest abs error."""
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    order, factors, gray, flip = _aug_plus_args(np.random.default_rng(12),
                                                batch)
    identity = int((factors == (1.0, 1.0, 1.0, 0.0)).all(axis=1).sum())
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.rand((batch, *clip, 3), generator=gen, device=dev)
    kw = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
              gray_before_jitter=False)
    out = ca.color_augment(x, order, factors, gray, flip, **kw)
    ref = ca.color_augment_plain(x, order, factors, gray, flip, **kw)
    err = float((out - ref).abs().max())
    print(f"check K3 aug_plus [{batch},{','.join(map(str, clip))},3] f32 "
          f"gray after jitter, mean 0 std 1, {identity} of {batch} rows "
          f"unjittered, {int(gray.sum())} gray, {int(flip.sum())} flipped: "
          f"max_abs_err={err:.3g} (limit {K3_TOL}); "
          f"{color_plan_line(tuple(x.shape), False)}", flush=True)
    require(err <= K3_TOL, f"K3 aug_plus error {err} > {K3_TOL}")
    require(0 < identity < batch, f"K3 aug_plus: {identity} unjittered rows")
    del x, out, ref
    torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# phase 3: timing at the main path's shapes
# ---------------------------------------------------------------------------

def check_pool_fwd(dev, batch: int, sites=POOL_SITES,
                   dtypes=("float32", "bfloat16")) -> None:
    """K1 (default and generic builds) bit-equal to the plain version at
    every site at a main-path batch that time_pool does not take (the
    fused key pass pools 2B clips; the finetune path's final validation
    pools 10 crops of each clip)."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(6)
    for dtype in (getattr(torch, d) for d in dtypes):
        for name, shape4, k, s, p in sites:
            x = torch.relu(torch.randn((batch, *shape4), generator=gen,
                                       device=dev)).to(dtype)
            ref = mp.max_pool3d_fwd_plain(x, k, s, p)
            eq = torch.equal(mp.max_pool3d_fwd(x, k, s, p), ref)
            eq_gen = torch.equal(
                mp.max_pool3d_fwd(x, k, s, p, build=GENERIC), ref)
            print(f"check K1 {name:20s} [{batch},{','.join(map(str, shape4))}]"
                  f" {dtype} bit-equal to plain: K1 {eq} K1 generic "
                  f"{eq_gen}", flush=True)
            require(eq and eq_gen, f"K1 {name} {dtype} at batch {batch}: "
                                   f"differs from the plain version (K1 "
                                   f"{eq}, generic {eq_gen})")
            del x, ref
    torch.cuda.empty_cache()


def fwd_plan_text(plan: dict) -> str:
    """K1's launch (ops/max_pool3d.py:fwd_plan) in words."""
    if not plan["rows"]:
        return f"generic instance, V {plan['vec']}"
    return (f"tiled, V {plan['vec']}, {plan['rows']} rows a thread, CVr "
            f"{1 << plan['cvl']}, {plan['chunks']} frame chunks of "
            f"{plan['frames_per_chunk']}, grid {plan['grid_x']}x"
            f"{plan['grid_y']}x{plan['grid_z']}")


def time_pool(dev, batch: int, dtype_name: str, sites=POOL_SITES,
              backward: bool = True) -> dict:
    """K1 (and K2 unless not ``backward``) at every site of ``sites`` (the
    main path's by default) in one dtype: timed beside the bound, the plain
    version, the library and the generic instances, and held bit-equal to
    the plain version on the same inputs."""
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.ops import max_pool3d as mp

    keys = ("fwd", "fwd_again", "fwd_generic", "fwd_plain", "fwd_lib",
            "fwd_bound")
    if backward:
        keys += ("bwd", "bwd_again", "bwd_generic", "bwd_plain", "bwd_lib",
                 "bwd_bound")
    tot = {k: 0.0 for k in keys}
    # K1's sites: how many, at how many it is slower than F.max_pool3d,
    # how many a tiled instance takes, at how many of those it is slower
    # than 1.05 times the generic instance
    flags = {"sites": 0, "slower_than_lib": 0, "tiled_sites": 0,
             "tile_over_1.05_generic": 0}
    by = {}
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(2)
    generic = GENERIC
    for name, shape4, k, s, p in sites:
        x = torch.relu(torch.randn((batch, *shape4), generator=gen,
                                   device=dev)).to(dtype)
        out = mp.max_pool3d_fwd(x, k, s, p)
        fref = mp.max_pool3d_fwd_plain(x, k, s, p)
        eq = {"K1": torch.equal(out, fref),
              "K1 generic": torch.equal(
                  mp.max_pool3d_fwd(x, k, s, p, build=generic), fref)}
        del fref
        xn = x.permute(0, 4, 1, 2, 3)          # NCDHW view, channels-last
        # the compile-time instance, the generic one, the library, each
        # twice in turns (time_calls_ms)
        f = time_calls_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
        fg = time_calls_ms(lambda: mp.max_pool3d_fwd(x, k, s, p,
                                                     build=generic))
        fl = time_calls_ms(lambda: F.max_pool3d(xn, k, s, p))
        f2 = time_calls_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
        fg = min(fg, time_calls_ms(lambda: mp.max_pool3d_fwd(
            x, k, s, p, build=generic)))
        fl = min(fl, time_calls_ms(lambda: F.max_pool3d(xn, k, s, p)))
        fp = time_ms(lambda: mp.max_pool3d_fwd_plain(x, k, s, p), 2, 1)
        window = k[0] * k[1] * k[2]
        esize = x.element_size()
        fb, fby = bound((x.numel() + out.numel()) * esize,
                        out.numel() * window)
        by["fwd"] = fby
        times = {"fwd": f, "fwd_again": f2, "fwd_generic": fg,
                 "fwd_plain": fp, "fwd_lib": fl, "fwd_bound": fb}
        # K1's launch here, and its time against F.max_pool3d and (a tiled
        # instance) against its generic instance. Where a call takes under
        # 50 us it is host-bound: its time is the wrapper's host time,
        # which both instances share (10-19 us a call on the card
        # machine, same build, same site, from one turn to the next), so
        # the instances are compared by their kernels' device times
        plan = mp.fwd_plan(x.shape, k, s, p, dtype)
        k1 = min(f, f2)
        flags["sites"] += 1
        flags["slower_than_lib"] += k1 > fl
        versus = ""
        if plan["rows"]:
            tile_ok = k1 <= 1.05 * fg
            if k1 < 0.05:
                kd = graph_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
                gd = graph_ms(lambda: mp.max_pool3d_fwd(x, k, s, p,
                                                        build=generic))
                tile_ok = kd <= 1.05 * gd
                versus = (f", device time {kd * 1e3:.2f} us, the generic "
                          f"instance's {gd * 1e3:.2f}")
            flags["tiled_sites"] += 1
            flags["tile_over_1.05_generic"] += not tile_ok
            versus += f", tile<=1.05 generic {tile_ok}"
        line = (f"K1 {f:.4f} ms (again {f2:.4f}, generic instance {fg:.4f}, "
                f"bound {fb:.4f}, plain {fp:.3f}, F.max_pool3d {fl:.4f}, "
                f"K1<=lib {k1 <= fl}, {fwd_plan_text(plan)}{versus})")
        if backward:
            g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
            eq["K2"] = torch.equal(mp.max_pool3d_bwd(x, g, k, s, p), dref)
            eq["K2 generic"] = torch.equal(
                mp.max_pool3d_bwd(x, g, k, s, p, build=generic), dref)
            del dref
            _, idx = F.max_pool3d(xn, k, s, p, return_indices=True)
            gn = g.permute(0, 4, 1, 2, 3)
            b = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p))
            bg = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p,
                                                   build=generic))
            b2 = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p))
            bp = time_ms(lambda: mp.max_pool3d_bwd_plain(x, g, k, s, p), 2, 1)
            bl = time_ms(
                lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                    gn, xn, list(k), list(s), list(p), [1, 1, 1], False,
                    idx))
            bb, bby = bound((2 * x.numel() + g.numel()) * esize,
                            x.numel() * 4 * (k[0] + k[1] + k[2]))
            by["bwd"] = bby
            times.update({"bwd": b, "bwd_again": b2, "bwd_generic": bg,
                          "bwd_plain": bp, "bwd_lib": bl, "bwd_bound": bb})
            line += (f" | K2 {b:.4f} ms (again {b2:.4f}, generic instance "
                     f"{bg:.4f}, bound {bb:.4f}, plain {bp:.3f}, aten bwd "
                     f"{bl:.4f}, K2<=aten {min(b, b2) <= bl})")
            del g, idx
        for key, v in times.items():
            tot[key] += v
        print(f"time {name:20s} [{batch},{','.join(map(str, shape4))}] "
              f"{dtype_name} {line} | bit-equal to plain: "
              f"{' '.join(f'{n} {v}' for n, v in eq.items())}", flush=True)
        require(all(eq.values()),
                f"{name} {dtype_name} at batch {batch}: a kernel differs "
                f"from its plain version ({eq})")
        del x, out
    print(f"time K1 over the {len(sites)} sites at batch {batch}, "
          f"{dtype_name}: "
          f"{tot['fwd']:.4f} ms, "
          f"again {tot['fwd_again']:.4f}, generic instance "
          f"{tot['fwd_generic']:.4f}, F.max_pool3d {tot['fwd_lib']:.4f}, "
          f"bound {tot['fwd_bound']:.4f}", flush=True)
    if backward:
        print(f"time K2 over the {len(sites)} sites at batch {batch}, "
              f"{dtype_name}: "
              f"{tot['bwd']:.4f} ms, "
              f"again {tot['bwd_again']:.4f}, generic instance "
              f"{tot['bwd_generic']:.4f}, aten bwd {tot['bwd_lib']:.4f}, "
              f"bound {tot['bwd_bound']:.4f}", flush=True)
    torch.cuda.empty_cache()
    tot["by"] = by
    tot["k1_flags"] = flags
    return tot


def time_host(dev) -> None:
    """K1's host time a call at a 7^2 site with the device idle (its kernel
    is shorter than the call, so the host clock over back-to-back calls is
    the call's host time: the floor of a small pool), beside
    F.max_pool3d's, at the visualization's f32 and the main path's bf16
    batch."""
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.ops import max_pool3d as mp

    def host_us(fn, n: int = 2000) -> float:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    name, shape4, k, s, p = POOL_SITES[-1]
    for batch, dtype in ((VIS_BATCH, torch.float32),
                         (MAIN_BATCH, torch.bfloat16)):
        x = torch.randn((batch, *shape4), device=dev).to(dtype)
        xn = x.permute(0, 4, 1, 2, 3)
        k1 = host_us(lambda: mp.max_pool3d_fwd(x, k, s, p))
        lib = host_us(lambda: F.max_pool3d(xn, k, s, p))
        print(f"time K1 host a call, {name} [{batch},"
              f"{','.join(map(str, shape4))}] {dtype}, device idle: "
              f"{k1:.2f} us (F.max_pool3d {lib:.2f} us)", flush=True)


def ptxas_lines(log: str, entry: str):
    """ptxas's register and spill lines of the entry functions whose
    mangled names hold ``entry``."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and entry in name and ("registers" in line
                                         or "spill" in line):
            out.append(f"{name[-40:]}: {line.strip()}")
    return out


def time_color(dev, batch: int, frames: int, size: int,
               aug_plus: bool = False) -> dict:
    """K3's resident instance, its generic instance (the
    color_augment_generic build) and the plain version at the main path's
    shapes, f32 and u8 input, beside the bound; ``aug_plus``: in phase
    12's mode (``check_color_aug_plus``)."""
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import _build
    from rspnet_tpu_torch.ops import color_augment as ca

    for line in ptxas_lines(_build.build_logs.get("color_augment", ""),
                            "augment_resident"):
        print(f"ptxas K3 resident {line}", flush=True)

    rng = np.random.default_rng(3)
    if aug_plus:
        order, factors, gray, _ = _aug_plus_args(rng, batch)
        kw = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                  gray_before_jitter=False)
    else:
        order = np.stack([rng.permutation(4) for _ in range(batch)]).astype(
            np.int32)
        factors = _color_args(rng, batch)
        gray = rng.random(batch) < 0.2
        kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                  gray_before_jitter=True)
    flip = np.zeros(batch, bool)
    x = torch.rand((batch, frames, size, size, 3), device=dev)
    res = {}
    for name, xin in (("f32", x), ("u8", (x * 255).to(torch.uint8))):
        def run(build):
            return ca.color_augment(xin, order, factors, gray, flip,
                                    build=build, **kw)
        t = time_ms(lambda: run("color_augment"), 20, 3)
        tg = time_ms(lambda: run("color_augment_generic"), 20, 3)
        t2 = time_ms(lambda: run("color_augment"), 20, 3)
        tp = time_ms(lambda: ca.color_augment_plain(xin, order, factors,
                                                    gray, flip, **kw), 1, 1)
        # the function's operations: the chain once per pixel (the hue
        # round trip ~45, the blends ~8 each, luma 5, the normalize 6)
        ops = x.numel() / 3 * (45 + 3 * 8 + 5 + 6)
        b, by = bound(xin.numel() * xin.element_size() + x.numel() * 4, ops)
        print(f"time K3 [{batch},{frames},{size},{size},3] {name} in"
              f"{' aug_plus' if aug_plus else ''}: "
              f"{t:.4f} ms (again {t2:.4f}, generic instance {tg:.4f}, "
              f"bound {b:.4f} by {by}, plain {tp:.2f}); "
              f"{color_plan_line(tuple(xin.shape), name == 'u8')}",
              flush=True)
        res[name] = {"ms": t, "again_ms": t2, "generic_ms": tg,
                     "plain_ms": tp, "bound_ms": b, "bound_by": by}
        del xin
    del x
    torch.cuda.empty_cache()
    f = res["f32"]
    return {"ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"]}


def time_blur(dev, clips: int, frames: int, size: int) -> dict:
    """The aug_plus gaussian blur (ops/color.py:gaussian_blur, a depthwise
    3x3 ``F.conv2d``, not a TPU kernel) alone on ``clips`` f32 clips, half
    of phase 12's batch, beside its bound; one clip held to the same
    function on the CPU (1e-6)."""
    import torch
    from rspnet_tpu_torch.ops import color

    x = torch.rand((clips, frames, size, size, 3), device=dev)
    out = color.gaussian_blur(x[:1])
    err = float((out.cpu() - color.gaussian_blur(x[:1].cpu())).abs().max())
    t = time_ms(lambda: color.gaussian_blur(x), 10, 2)
    # each input read once, each output written once; 9 multiply-adds a
    # value
    b, by = bound(2 * x.numel() * 4, 18 * x.numel())
    print(f"time blur [{clips},{frames},{size},{size},3] f32: {t:.4f} ms "
          f"(bound {b:.4f} by {by}); one clip against the CPU "
          f"max_abs_err={err:.3g} (limit 1e-6)", flush=True)
    require(err <= 1e-6, f"blur on the card differs from the CPU: {err}")
    del x, out
    torch.cuda.empty_cache()
    return {"ms": t, "bound_ms": b, "bound_by": by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 15: the RGB stems, plain against packed
# ---------------------------------------------------------------------------

def _max_err(got, ref) -> float:
    return float((got.detach().float() - ref).abs().max())


def stem_sites():
    """(name, conv, clip) of each RGB stem of the backbones of
    ``STEM_ARCHS``, the conv on the CPU with the model's initial weight."""
    from torch import nn
    from rspnet_tpu_torch.models import get_model_class
    for arch, (keys, (t, h, w)) in STEM_ARCHS.items():
        model = get_model_class(arch, **keys)()
        for name, conv in model.named_modules():
            if isinstance(conv, nn.Conv3d) and conv.in_channels < 8:
                frames = (t // model.spec.alpha if name.startswith("slow.")
                          else t)
                yield f"{arch}.{name}", conv, (frames, h, w)


def time_stems(dev) -> dict:
    """Phase 15: each stem of ``stem_sites()`` as the backbones run it in
    bf16, from an f32 NDHWC clip and an f32 weight: the plain
    ``F.conv3d`` against ``models/common.py:conv3d``, which runs the stems
    ``packs_stem`` picks as ``SpaceToDepthConv3d``. Times the forward at
    the fused key pass's batch (2 x ``STEM_BATCH``, no gradient) and the
    forward and the weight gradient at the q batch; names the kernels of
    each; holds the output and the weight gradient to the f32 convolution
    of the same bf16 values (TF32 off), within an ulp of their largest
    element or the plain call's own error. A ``packed<=plain`` flag a
    packed site compares the three times' sum; no packed stem may be
    slower."""
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.framework import tracing
    from rspnet_tpu_torch.models.common import conv3d, packs_stem

    bf = torch.bfloat16
    out = {}
    for name, conv, clip in stem_sites():
        conv = conv.to(dev)
        w, stride, pad = conv.weight, conv.stride, conv.padding
        gen = torch.Generator(device=dev).manual_seed(0)
        x_key = torch.rand((2 * STEM_BATCH, *clip, 3), device=dev,
                           generator=gen).permute(0, 4, 1, 2, 3)
        x = x_key[:STEM_BATCH]
        packed = packs_stem(conv, x, bf)
        calls = {"plain": lambda xx: F.conv3d(xx.to(bf), w.to(bf), None,
                                              stride, pad)}
        if packed:
            calls["packed"] = lambda xx: conv3d(conv, xx, bf)
        # the yardstick: the f32 convolution of the bf16 values
        xb = x.to(bf).float()
        wb = w.detach().to(bf).float().requires_grad_()
        y32 = F.conv3d(xb, wb, None, stride, pad)
        g = torch.randn(y32.shape, device=dev, generator=gen).to(bf)
        gw32, = torch.autograd.grad(y32, wb, g.float())
        y32 = y32.detach()
        y_scale, gw_scale = float(y32.abs().max()), float(gw32.abs().max())
        del xb, wb
        rows = {}
        for label, call in calls.items():
            y = call(x)
            gw, = torch.autograd.grad(y, w, g, retain_graph=True)

            def key_fwd():
                with torch.no_grad():
                    call(x_key)

            def wgrad():
                torch.autograd.grad(y, w, g, retain_graph=True)

            rows[label] = {
                "key_fwd_ms": time_calls_ms(key_fwd),
                "q_fwd_ms": time_calls_ms(lambda: call(x)),
                "wgrad_ms": time_calls_ms(wgrad),
                "err_y": _max_err(y, y32), "err_w": _max_err(gw, gw32),
                "fwd_kernels": tracing.device_kernels(key_fwd),
                "wgrad_kernels": tracing.device_kernels(wgrad)}
            rows[label]["sum_ms"] = sum(rows[label][f"{p}_ms"] for p in (
                "key_fwd", "q_fwd", "wgrad"))
            del y, gw
        plain = rows["plain"]
        for lab, r in rows.items():
            flag = (f" packed<={r['sum_ms'] <= plain['sum_ms']}"
                    if lab == "packed" else "" if packed
                    else " (not packed: the plain call is conv3d's)")
            print(f"stem {name} {lab}: key fwd [{2 * STEM_BATCH}] "
                  f"{r['key_fwd_ms']:.3f} ms, q fwd [{STEM_BATCH}] "
                  f"{r['q_fwd_ms']:.3f}, wgrad {r['wgrad_ms']:.3f}, "
                  f"sum {r['sum_ms']:.3f}; max err out {r['err_y']:.3g} "
                  f"(scale {y_scale:.3g}), wgrad {r['err_w']:.3g} (scale "
                  f"{gw_scale:.3g}){flag}", flush=True)
            for what in ("fwd_kernels", "wgrad_kernels"):
                print(f"stem {name} {lab} {what[:-8]}: " + "; ".join(
                    f"{ms:.3f} ms {key[:100]}" for ms, key in r[what][:4]),
                    flush=True)
            # an ulp of the largest element: 2^-8 of it in bf16
            require(r["err_y"] <= max(plain["err_y"], y_scale / 256),
                    f"stem {name} {lab}: output off by {r['err_y']}")
            require(r["err_w"] <= max(plain["err_w"], gw_scale / 256),
                    f"stem {name} {lab}: weight gradient off by "
                    f"{r['err_w']}")
        out[name] = {lab: {key: r[key] for key in (
            "key_fwd_ms", "q_fwd_ms", "wgrad_ms", "sum_ms")}
            for lab, r in rows.items()}
        del x_key, x, conv, w, y32, g, gw32
        torch.cuda.empty_cache()
    slower = [n for n, r in out.items() if "packed" in r
              and r["packed"]["sum_ms"] > r["plain"]["sum_ms"]]
    print(f"stems over {len(out)} sites: packed at "
          f"{sum('packed' in r for r in out.values())}, slower than the "
          f"plain call at {len(slower)} {slower}", flush=True)
    require(not slower, f"the packed stem is slower at {slower}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the temporal convolutions, 3-D against the 2-D view
# ---------------------------------------------------------------------------

def temporal_sites(dev):
    """(arch, names, conv, per-clip input [C, T, H, W], q batch, taken) of
    each (kt, 1, 1) convolution with kt > 1 of the backbones of
    ``TEMPORAL_ARCHS``, as a bf16 forward of one clip on the card reaches
    it (the conv with the model's initial weight; ``taken``: whether
    ``temporal_as_2d`` takes it there). Convolutions of one arch with the
    same geometry and input shape are one site, under all their names."""
    import torch
    from rspnet_tpu_torch.models import common, get_model_class

    rule = common.temporal_as_2d
    for arch, (keys, (t, h, w), batch) in TEMPORAL_ARCHS.items():
        model = get_model_class(arch, **keys)(dtype=torch.bfloat16)
        model = model.to(dev).eval()
        names = {id(m): n for n, m in model.named_modules()}
        sites = {}

        def record(conv, x, dt):
            taken = rule(conv, x, dt)
            if conv.kernel_size[0] > 1 and conv.kernel_size[1:] == (1, 1):
                key = (conv.in_channels, conv.out_channels, conv.kernel_size,
                       conv.stride, conv.padding, conv.groups,
                       tuple(x.shape[1:]))
                site = sites.setdefault(key, [[], conv, set()])
                site[0].append(names[id(conv)])
                site[2].add(taken)
            return taken

        common.temporal_as_2d = record
        try:
            with torch.no_grad():
                model(torch.rand((1, t, h, w, 3), device=dev))
        finally:
            common.temporal_as_2d = rule
        for key, (site_names, conv, taken) in sites.items():
            require(len(taken) == 1, f"{arch} {site_names}: taken {taken}")
            yield arch, site_names, conv, key[-1], batch, taken.pop()
        del model
        torch.cuda.empty_cache()


def _device_ms(fn, calls: int = 10):
    """(device ms a call, [(ms a call, kernel)] longest first) of ``fn``:
    the kernels of ``calls`` calls in one profiler session, summed, over
    ``calls`` (no host time between the kernels counted)."""
    from rspnet_tpu_torch.framework import tracing

    def run():
        for _ in range(calls):
            fn()
    kernels = [(ms / calls, key) for ms, key in tracing.device_kernels(run)]
    return sum(ms for ms, _ in kernels), kernels


def time_temporal(dev) -> dict:
    """Phase 16: each site of ``temporal_sites`` in bf16 and channels-last
    memory, as ``F.conv3d`` and as ``models/common.py:temporal_conv2d``
    (the [N, C, T, H*W] view): the forward at the fused key pass's batch
    (2 x the q batch, no gradient), and the forward, the input gradient
    (dgrad) and the weight gradient (wgrad) at the q batch, from a
    channels-last output gradient as the backward gets it. Each is timed
    on the card's clock, the device ms of its kernels over 10 calls
    (``_device_ms``; the small sites' calls take less device time than
    host time), twice in turns, and once with CUDA events around 20 calls
    (host time included where it is the longer); its kernels are named.
    Output and both gradients are held to the f32 ``F.conv3d`` of the
    same bf16 values (TF32 off), within an ulp of their largest element
    or the 3-D call's own error. At R(2+1)D's three 56² sites the rule
    must take the 2-D form and no f32 kernel may remain in it; at every
    site ``temporal_as_2d`` takes, the 2-D form's device ms (fwd + bwd)
    may not exceed the 3-D call's by more than the larger of the two
    turns' spread and ``TEMPORAL_NOISE``. Sites the rule leaves to the
    3-D call are timed in both forms too: they show why."""
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.models.common import temporal_conv2d

    bf, cl = torch.bfloat16, torch.channels_last_3d
    phases = ("key_fwd", "q_fwd", "dgrad", "wgrad")
    out, slower, ffma = {}, [], []
    for arch, names, conv, shape, batch, taken in temporal_sites(dev):
        stride, pad, groups = conv.stride, conv.padding, conv.groups
        name = f"{arch}.{names[0]}" + (f" (+{len(names) - 1})"
                                       if len(names) > 1 else "")
        gen = torch.Generator(device=dev).manual_seed(0)
        x_key = torch.randn((2 * batch, *shape[1:], shape[0]), device=dev,
                            generator=gen, dtype=bf).permute(0, 4, 1, 2, 3)
        x = x_key[:batch].clone().requires_grad_()
        w = conv.weight.detach().to(dev, bf).requires_grad_()
        forms = {
            "3d": lambda xx: F.conv3d(xx, w, None, stride, pad,
                                      groups=groups),
            "2d": lambda xx: temporal_conv2d(xx, w, stride, pad, groups)}
        # the yardstick: the f32 convolution of the same bf16 values
        x32 = x.detach().float().requires_grad_()
        w32 = w.detach().float().requires_grad_()
        y32 = F.conv3d(x32, w32, None, stride, pad, groups=groups)
        g = torch.randn(y32.shape, device=dev, generator=gen).to(bf)
        g = g.contiguous(memory_format=cl)
        dx32, dw32 = torch.autograd.grad(y32, (x32, w32), g.float())
        ref = {"y": y32.detach(), "dx": dx32, "dw": dw32}
        scale = {k: float(v.abs().max()) for k, v in ref.items()}
        del x32, w32, y32
        rows = {}
        for label, call in forms.items():
            y = call(x)
            require(y.is_contiguous(memory_format=cl),
                    f"temporal {name} {label}: output not channels-last")
            dx, dw = torch.autograd.grad(y, (x, w), g, retain_graph=True)
            err = {"y": _max_err(y, ref["y"]), "dx": _max_err(dx, ref["dx"]),
                   "dw": _max_err(dw, ref["dw"])}
            del dx, dw

            def key_fwd(call=call):
                with torch.no_grad():
                    call(x_key)

            def q_fwd(call=call):
                call(x)

            def dgrad(y=y):
                torch.autograd.grad(y, x, g, retain_graph=True)

            def wgrad(y=y):
                torch.autograd.grad(y, w, g, retain_graph=True)

            fns = dict(zip(phases, (key_fwd, q_fwd, dgrad, wgrad)))
            rows[label] = {"y": y, "fns": fns, "err": err, "sums": [],
                           "event_ms": {p: time_calls_ms(fn)
                                        for p, fn in fns.items()}}
        for _ in range(2):          # the two forms in turns, twice
            for r in rows.values():
                timed = {p: _device_ms(fn) for p, fn in r["fns"].items()}
                r["ms"] = {p: ms for p, (ms, _) in timed.items()}
                r["kernels"] = {p: k for p, (_, k) in timed.items()}
                r["sums"].append(sum(r["ms"].values()))
        d3, d2 = rows["3d"], rows["2d"]
        noise = max(max(abs(r["sums"][0] - r["sums"][1]) for r in
                        rows.values()), TEMPORAL_NOISE * min(d3["sums"]))
        mean = {k: sum(r["sums"]) / 2 for k, r in rows.items()}
        ok = mean["2d"] <= mean["3d"] + noise
        for label, r in rows.items():
            flag = ("" if label == "3d" else
                    f"; 2d<=3d+noise {ok} (noise {noise:.3f})"
                    + ("" if taken else " (not taken: the 3-D call is "
                       "conv3d's)"))
            print(f"temporal {name} {label}: [{batch}, {shape[0]}, "
                  f"{', '.join(map(str, shape[1:]))}] -> "
                  f"{conv.out_channels} k{conv.kernel_size[0]} "
                  f"s{stride[0]} p{pad[0]} g{groups}: device ms "
                  + ", ".join(f"{p} {r['ms'][p]:.3f}" for p in phases)
                  + f", sums {r['sums'][0]:.3f} / {r['sums'][1]:.3f}; "
                  "events " + ", ".join(f"{r['event_ms'][p]:.3f}"
                                        for p in phases)
                  + "; max err " + ", ".join(
                      f"{k} {r['err'][k]:.3g} (scale {scale[k]:.3g})"
                      for k in ("y", "dx", "dw")) + flag, flush=True)
            for p in ("key_fwd", "dgrad", "wgrad"):
                print(f"temporal {name} {label} {p}: " + "; ".join(
                    f"{ms:.3f} ms {key[:90]}"
                    for ms, key in r["kernels"][p][:3]), flush=True)
            for k in ("y", "dx", "dw"):
                require(r["err"][k] <= max(d3["err"][k], scale[k] / 256),
                        f"temporal {name} {label}: {k} off by "
                        f"{r['err'][k]}")
        f32 = {label: any("f32f32_f32f32" in key for p in phases
                          for _, key in r["kernels"][p])
               for label, r in rows.items()}
        if arch == "r2plus1d-vcop" and shape[2] * shape[3] == 56 * 56:
            require(taken, f"temporal {name}: not taken at 56²")
            ffma.extend(names if f32["2d"] else [])
        if taken and not ok:
            slower.append(name)
        out[name] = {"taken": taken, "noise_ms": noise, **{
            label: {"ms": r["ms"], "sums": r["sums"],
                    "event_ms": r["event_ms"], "err": r["err"],
                    "f32_kernel": f32[label]}
            for label, r in rows.items()}}
        del rows, x_key, x, w, g, ref, forms
        torch.cuda.empty_cache()
    f32_sites = {k: [n for n, r in out.items() if r[k]["f32_kernel"]]
                 for k in ("3d", "2d")}
    left = [n for n, r in out.items() if not r["taken"]]
    left_slower = [n for n in left if sum(out[n]["2d"]["sums"])
                   > sum(out[n]["3d"]["sums"]) + 2 * out[n]["noise_ms"]]
    print(f"temporal over {len(out)} sites: taken at {len(out) - len(left)}; "
          f"an f32 kernel in the 3-D call at {len(f32_sites['3d'])} "
          f"{f32_sites['3d']}, in the 2-D form at {len(f32_sites['2d'])} "
          f"{f32_sites['2d']}; the 2-D form slower where taken at "
          f"{len(slower)} {slower}; left to the 3-D call at {len(left)}, "
          f"where the 2-D form would be slower at {len(left_slower)} "
          f"{left_slower}", flush=True)
    require(not ffma, f"an f32 kernel remains at R(2+1)D's 56² sites {ffma}")
    require(not slower, f"the 2-D form is slower at {slower}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

KERNELS = ("max_pool3d_fwd", "max_pool3d_bwd", "color_augment")


def _counters() -> dict:
    """The port's counters (``framework/tracing.py``) so far."""
    from rspnet_tpu_torch.framework import tracing
    return tracing.counters()


def _moved(before: dict):
    """What the counters moved since ``before`` (a ``_counters()``):
    (launches by kernel, K1/K2 launches by dtype, plain-version calls on
    CUDA tensors, packed stem forwards, host-to-device clip copies)."""
    now = _counters()

    def moved(name):
        return now.get(name, 0) - before.get(name, 0)

    by_dtype = {f"{k}.{t}": moved(f"kernels.{k}.{t}")
                for k in KERNELS[:2] for t in ("float32", "bfloat16")}
    counts = {k: by_dtype[f"{k}.float32"] + by_dtype[f"{k}.bfloat16"]
              for k in KERNELS[:2]}
    counts["color_augment"] = (moved("kernels.color_augment.uint8")
                               + moved("kernels.color_augment.float32"))
    plain = {k: moved(f"kernels.{k}.plain_on_cuda") for k in KERNELS}
    copies = {"calls": moved("loader.h2d_calls"),
              "bytes": moved("loader.h2d_bytes")}
    return counts, by_dtype, plain, moved("backbone.stem_pad_calls"), copies


def _temporal_moved(before: dict) -> int:
    """The temporal convolutions run as 2-D ones since ``before``."""
    key = "backbone.temporal_2d_calls"
    return _counters().get(key, 0) - before.get(key, 0)


def _main_argv(exp: str, *more: str,
               config: str = "config/pretrain/s3dg.jsonnet", fields=""):
    ext = ('{dataset+: {name: "synthetic"}, device_geometry: true%s}'
           % (", " + fields if fields else ""))
    return ["-c", config, "-e", exp, "-x", ext, "-d", "--seed", "0",
            "--device", "cuda", *more]


def main_path(batch: int, exp: str) -> dict:
    """Phase 4: 3 train steps through the CLI entry point with ``--ws 1``
    (also phase 13 (d): one process, no group, no collective); returns the
    launches, step times, peak memory and the checkpoint it wrote."""
    import torch
    import torch.distributed as dist
    from rspnet_tpu_torch import pretrain

    argv = _main_argv(exp, "--ws", "1")
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, pads, _ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = engine.meters["loss"].avg
    ckpt = os.path.join(exp, "checkpoint.pth.tar")
    steps = engine.step_times
    print(f"main path: batch {batch}, compute dtype {engine.dtype}, "
          f"{len(steps)} steps, step ms {[round(t, 1) for t in steps]}, "
          f"wall {wall:.1f} s, peak memory {peak:.2f} GiB, loss {loss:.4f}, "
          f"launches {counts}, K1/K2 launches by dtype {by_dtype}, plain "
          f"calls on cuda {plain}, checkpoint {os.path.exists(ckpt)}",
          flush=True)
    require(math.isfinite(loss), f"main path loss {loss} is not finite")
    require(len(steps) == 3, f"main path ran {len(steps)} steps, not 3")
    require(engine.dtype == torch.bfloat16,
            f"main path computes in {engine.dtype}, not bf16")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the main path was not launched: {counts}")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"K1/K2 launched off bf16 on the main path: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(os.path.exists(ckpt), "checkpoint.pth.tar was not written")
    require(not dist.is_initialized() and engine.mesh.group is None,
            "main path: --ws 1 made a process group")
    temporal = _temporal_moved(before)
    print(f"main path: {pads} packed stem forwards, {temporal} temporal "
          f"convolutions as 2-D ones", flush=True)
    require(pads == 2 * len(steps), f"main path: {pads} packed stem "
            f"forwards, not 2 a step (key pass and q pass)")
    want = 2 * TEMPORAL_2D_A_FORWARD["s3dg"] * len(steps)
    require(temporal == want, f"main path: {temporal} temporal "
            f"convolutions as 2-D ones, not {want}")
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak,
            "checkpoint": ckpt}


def validate_path(exp: str, ckpt: str) -> dict:
    """Phase 5: ``--validate`` from phase 4's checkpoint. K1 and K3 run,
    K2 does not; the metrics are finite; the model (BN statistics
    included) and the queue equal the checkpoint's afterwards."""
    import torch
    from rspnet_tpu_torch import pretrain
    from rspnet_tpu_torch.framework import load_state
    from rspnet_tpu_torch.models import convert

    before = _counters()
    t0 = time.perf_counter()
    engine = pretrain.main(_main_argv(exp, "--validate", "--load-checkpoint",
                                      ckpt))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    saved = load_state(ckpt)["model"]
    s = engine.state

    def same_model(model, which):
        want = convert.variables_to_state_dict(
            {"params": saved[f"params_{which}"],
             "batch_stats": saved[f"batch_stats_{which}"]})
        sd = model.state_dict()
        return (set(want) <= set(sd) and all(
            torch.equal(sd[k].cpu(), torch.from_numpy(v))
            for k, v in want.items()))

    same = {
        "model_q": same_model(s.model_q, "q"),
        "model_k": same_model(s.model_k, "k"),
        "queue": (torch.equal(s.queue.cpu(), saved["queue"].cpu())
                  and s.queue_ptr == int(saved["queue_ptr"])),
    }
    metrics = engine.validation
    print(f"validate: wall {wall:.1f} s, metrics "
          f"{ {k: round(v, 4) for k, v in metrics.items()} }, launches "
          f"{counts}, K1/K2 launches by dtype {by_dtype}, plain calls on "
          f"cuda {plain}, state equal to the checkpoint {same}", flush=True)
    require(metrics and all(math.isfinite(v) for v in metrics.values()),
            f"validate metrics not finite: {metrics}")
    require(counts["max_pool3d_fwd"] > 0 and counts["color_augment"] > 0,
            f"validate did not launch K1 and K3: {counts}")
    require(counts["max_pool3d_bwd"] == 0,
            f"validate launched K2: {counts}")
    require(by_dtype["max_pool3d_fwd.float32"] == 0,
            f"validate launched K1 off bf16: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(all(same.values()), f"validate changed the state: {same}")
    return {"launches": counts}

# ---------------------------------------------------------------------------
# phase 6: the finetune path
# ---------------------------------------------------------------------------

def _finetune_argv(exp: str, *more: str, config: str = FT_CONFIG,
                   ext: str = None, mixins=()):
    # 12 train clips (3 steps of 4), 4 validation clips (one batch; 40
    # clips in the final 10-crop validation)
    ext = ext or ('{dataset+: {name: "synthetic", num_samples: 12, '
                  'val_num_samples: 4}, device_geometry: true, '
                  'bn_recalibrate: 1}')
    return ["-c", config, "-e", exp, "-x", *mixins, ext, "-d", "--seed",
            "0", "--device", "cuda", *more]


def finetune_path(exp: str, pretrained: str) -> dict:
    """Phase 6: ``--mc`` from phase 4's checkpoint, one precise-BN batch,
    3 train steps, one validation batch and the final 10-crop validation,
    through the CLI entry point; returns the launches and the times."""
    import torch
    from rspnet_tpu_torch import finetune

    argv = _finetune_argv(exp, "--mc", pretrained)
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine, final = finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = engine.step_times
    train = {k: engine.train_meters[k].avg for k in ("loss", "acc1", "acc5")}
    val = engine.validation
    best = os.path.exists(os.path.join(exp, "model_best.pth.tar"))
    print(f"finetune path: batch {FT_BATCH}, {FT_FRAMES} frames, compute "
          f"dtype {engine.dtype}, {len(steps)} steps, step ms "
          f"{[round(t, 1) for t in steps]}, wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GiB, train loss {train['loss']:.4f} acc1 "
          f"{train['acc1']:.2f} acc5 {train['acc5']:.2f}, validation "
          f"{ {k: round(v, 4) for k, v in val.items()} }, model_best "
          f"{best}, final {FT_FINAL_BATCH // FT_BATCH}-crop validation "
          f"{ {k: round(v, 4) for k, v in final.items()} }, launches "
          f"{counts}, K1/K2 launches by dtype {by_dtype}, plain calls on "
          f"cuda {plain}", flush=True)
    require(all(math.isfinite(v) for v in train.values()),
            f"finetune train metrics not finite: {train}")
    require(len(steps) == 3, f"finetune ran {len(steps)} steps, not 3")
    require(engine.dtype == torch.bfloat16,
            f"finetune computes in {engine.dtype}, not bf16")
    require(val["count"] == FT_BATCH and math.isfinite(val["loss"]),
            f"finetune validation: {val}")
    require(final["count"] == FT_BATCH and math.isfinite(final["loss"]),
            f"final validation: {final}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the finetune path was not launched: {counts}")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"K1/K2 launched off bf16 on the finetune path: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak,
            "checkpoint": os.path.join(exp, "checkpoint.pth.tar")}


def finetune_validate_path(exp: str, ckpt: str) -> dict:
    """Phase 6, second leg: ``--validate --load-checkpoint``, the final
    10-crop validation of the trained weights alone: K1 launched, K2 and
    K3 not."""
    import torch
    from rspnet_tpu_torch import finetune

    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine, final = finetune.main(_finetune_argv(
        exp, "--validate", "--load-checkpoint", ckpt))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"finetune validate: {FT_FINAL_BATCH} clips of {FT_FRAMES} frames "
          f"in one batch, wall {wall:.1f} s, peak memory {peak:.2f} GiB, "
          f"metrics { {k: round(v, 4) for k, v in final.items()} }, "
          f"launches {counts}, K1/K2 launches by dtype {by_dtype}, plain "
          f"calls on cuda {plain}", flush=True)
    require(engine is None and final["count"] == FT_BATCH
            and math.isfinite(final["loss"]), f"final validation: {final}")
    require(counts["max_pool3d_fwd"] > 0, f"K1 not launched: {counts}")
    require(counts["max_pool3d_bwd"] == 0 and counts["color_augment"] == 0,
            f"the final validation launched K2 or K3: {counts}")
    require(by_dtype["max_pool3d_fwd.float32"] == 0,
            f"K1 launched off bf16: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts, "wall_s": wall, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase 7: the C3D and ResNet-18 pretrain legs
# ---------------------------------------------------------------------------

def zoo_pretrain_path(arch: str, exp: str, config: str = None,
                      batch: int = None, frames: int = 32, pool_calls=None,
                      fields: str = "") -> dict:
    """Phase 7 (and 10, 11): 3 bf16 train steps of
    ``config/pretrain/{arch}.jsonnet`` (or ``config`` with the -x
    ``fields``; published widths and batch, 112², ``frames`` -> half as
    many, K 16384) through the CLI; every K1/K2 launch bf16, K3 on each q
    and k clip. ``pool_calls`` (K1, K2) a step, when given, are the exact
    launches; else both must be launched."""
    import torch
    from rspnet_tpu_torch import pretrain

    batch = batch or ZOO_BATCH[arch]
    config = config or f"config/pretrain/{arch}.jsonnet"
    plan = color_plan_line((batch, frames, 112, 112, 3), False)
    argv = _main_argv(exp, config=config, fields=fields)
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, pads, _ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = engine.meters["loss"].avg
    steps = engine.step_times
    ckpt = os.path.join(exp, "checkpoint.pth.tar")
    print(f"{arch} pretrain: batch {batch}, encoder "
          f"{type(engine.state.model_q.encoder).__name__}, compute dtype "
          f"{engine.dtype}, "
          f"{len(steps)} steps, step ms {[round(t, 1) for t in steps]}, "
          f"wall {wall:.1f} s, peak memory {peak:.2f} GiB, loss {loss:.4f}, "
          f"launches {counts}, K1/K2 launches by dtype {by_dtype}, plain "
          f"calls on cuda {plain}, K3 [{batch},{frames},112,112,3] f32: "
          f"{plan}, checkpoint {os.path.exists(ckpt)}", flush=True)
    require(math.isfinite(loss), f"{arch} pretrain loss {loss} not finite")
    require(len(steps) == 3, f"{arch} pretrain ran {len(steps)} steps")
    require(engine.dtype == torch.bfloat16 and engine.batch_size == batch,
            f"{arch} pretrain: {engine.dtype}, batch {engine.batch_size}")
    if pool_calls is None:
        require(counts["max_pool3d_fwd"] > 0
                and counts["max_pool3d_bwd"] > 0,
                f"{arch} pretrain did not launch K1 and K2: {counts}")
    else:
        want = (pool_calls[0] * len(steps), pool_calls[1] * len(steps))
        require((counts["max_pool3d_fwd"], counts["max_pool3d_bwd"])
                == want, f"{arch} pretrain: K1/K2 launched "
                f"{counts['max_pool3d_fwd']}/{counts['max_pool3d_bwd']} "
                f"times, not {want[0]}/{want[1]}")
    require(counts["color_augment"] == 2 * len(steps),
            f"{arch} pretrain: K3 launched {counts['color_augment']} times, "
            f"not once per q and k clip")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"K1/K2 launched off bf16 in {arch} pretrain: {by_dtype}")
    require(plan.startswith("resident"),
            f"K3 on the {arch} clips: {plan}, expected the resident instance")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(os.path.exists(ckpt), f"{arch}: no checkpoint.pth.tar")
    # SlowFast has a stem on each pathway; C3D's stride-1 stem is not packed
    want = 2 * len(steps) * {"slowfast": 2, "c3d": 0}.get(arch, 1)
    require(pads == want, f"{arch} pretrain: {pads} packed stem forwards, "
            f"not {want}")
    temporal = _temporal_moved(before)
    want = 2 * len(steps) * TEMPORAL_2D_A_FORWARD[arch]
    print(f"{arch} pretrain: {pads} packed stem forwards, {temporal} "
          f"temporal convolutions as 2-D ones", flush=True)
    require(temporal == want, f"{arch} pretrain: {temporal} temporal "
            f"convolutions as 2-D ones, not {want}")
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak,
            "checkpoint": ckpt}


# ---------------------------------------------------------------------------
# phases 10 and 11: the R(2+1)D and r3d_18 finetune legs (the pretrain legs
# are zoo_pretrain_path's)
# ---------------------------------------------------------------------------

def finetune_leg(label: str, exp: str, pretrained, model_type: str,
                 config: str = R21D_FT_CONFIG, batch: int = R21D_FT_BATCH,
                 val_clips: int = R21D_FT_BATCH, mixins=()) -> dict:
    """Phases 10 and 11: ``config`` (with the -x ``mixins``), from
    ``pretrained`` by ``--mc`` when given, as ``model_type``: 3 bf16 train
    steps of ``batch`` clips, one validation batch of ``val_clips`` clips,
    the final 10-crop validation of ``val_clips`` clips in one batch. K3
    on each train batch; no pool."""
    import torch
    from rspnet_tpu_torch import finetune

    ext = ('{dataset+: {name: "synthetic", num_samples: %d, '
           'val_num_samples: %d}, device_geometry: true, model_type: "%s"}'
           % (3 * batch, val_clips, model_type))
    more = ("--mc", pretrained) if pretrained else ()
    argv = _finetune_argv(exp, *more, config=config, ext=ext, mixins=mixins)
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine, final = finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = engine.step_times
    train = {k: engine.train_meters[k].avg for k in ("loss", "acc1", "acc5")}
    val = engine.validation
    print(f"{label} finetune {model_type}: batch {batch}, 16 "
          f"frames, compute dtype {engine.dtype}, model "
          f"{type(engine.model).__name__}, {len(steps)} steps, step ms "
          f"{[round(t, 1) for t in steps]}, wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GiB, train loss {train['loss']:.4f} acc1 "
          f"{train['acc1']:.2f}, validation "
          f"{ {k: round(v, 4) for k, v in val.items()} }, final "
          f"10-crop validation of {val_clips} clips "
          f"{ {k: round(v, 4) for k, v in final.items()} }, launches "
          f"{counts}, plain calls on cuda {plain}", flush=True)
    require(engine.model_type == model_type,
            f"finetune built {engine.model_type}, not {model_type}")
    require(all(math.isfinite(v) for v in train.values()),
            f"{label} finetune train metrics not finite: {train}")
    require(len(steps) == 3, f"{label} finetune ran {len(steps)} steps")
    require(engine.dtype == torch.bfloat16,
            f"{label} finetune computes in {engine.dtype}, not bf16")
    require(val["count"] == val_clips and math.isfinite(val["loss"]),
            f"{label} finetune validation: {val}")
    require(final["count"] == val_clips and math.isfinite(final["loss"]),
            f"{label} final validation: {final}")
    require(counts["color_augment"] == len(steps),
            f"K3 launched {counts['color_augment']} times, not once a step")
    require(counts["max_pool3d_fwd"] == 0 and counts["max_pool3d_bwd"] == 0,
            f"{label} has no max pool, yet K1/K2 launched: {counts}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak}


def check_floor_tail(dev, batch: int) -> None:
    """K2 at SlowFast's res4 non-local pool, (1,2,2)/(1,2,2)/0 on a 7²
    map: row and column 6 lie in no window, so their gradient is exactly
    0 (and bit-equal to the plain version's everywhere)."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    name, shape4, k, s, p = P11_POOL_SITES["slowfast_pretrain"][3]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((batch, *shape4), generator=gen, device=dev).to(
        torch.bfloat16)
    out = mp.max_pool3d_fwd(x, k, s, p)
    g = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
    dx = mp.max_pool3d_bwd(x, g, k, s, p)
    tail = torch.cat([dx[:, :, 6].flatten(), dx[:, :, :, 6].flatten()])
    same = torch.equal(dx, mp.max_pool3d_bwd_plain(x, g, k, s, p))
    print(f"check K2 {name} floor tail [{batch},{','.join(map(str, shape4))}]"
          f" bf16: out {list(out.shape)}, row and column 6 all zero "
          f"{bool((tail == 0).all())}, bit-equal to plain {same}",
          flush=True)
    require(out.shape[2] == 3 and bool((tail == 0).all()) and same,
            f"K2 at {name}: the uncovered tail is not 0 or differs")


# ---------------------------------------------------------------------------
# phase 8: retrieval
# ---------------------------------------------------------------------------

def retrieval_path(arch: str, exp: str, pretrained: str) -> dict:
    """Phase 8: ``rspnet_tpu_torch.retrieval`` on
    config/retrieval/ucf101_{arch}.jsonnet with ``--mc`` from phase 7:
    3 batches of 8 clips x 10 crops per split (``-d``), bf16; K1 only."""
    import numpy as np
    import torch
    from rspnet_tpu_torch import retrieval

    ext = ('{dataset+: {name: "synthetic", num_samples: %d, '
           'val_num_samples: %d}, device_geometry: true}'
           % (RET_CLIPS, RET_CLIPS))
    argv = ["-c", f"config/retrieval/ucf101_{arch}.jsonnet", "-e", exp,
            "-x", ext, "-d", "--seed", "0", "--device", "cuda", "--mc",
            pretrained]
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine, results = retrieval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run_dir = engine.args.run_dir
    feats = {split: np.load(run_dir / f"{split}_fold1_feats.npy")
             for split in ("train", "test")}
    names = [f"{split}_{n}.npy" for split in ("train", "test")
             for n in ("fold1_feats", "fold1_labels", "feature", "class")]
    written = all((run_dir / n).exists() for n in names) and (
        run_dir / "topk_correct.json").exists()
    recalls = [results[f"R@{k}"] for k in (1, 5, 10, 20, 50)]
    batch_ms = engine.batch_times
    print(f"retrieval {arch}: {len(batch_ms)} batches of "
          f"{RET_BATCH // engine.n_crop} clips x {engine.n_crop} crops, "
          f"compute dtype {engine.dtype}, batch ms "
          f"{[round(t, 1) for t in batch_ms]}, wall {wall:.1f} s, peak "
          f"memory {peak:.2f} GiB, features "
          f"{ {k: list(v.shape) for k, v in feats.items()} }, recalls "
          f"{results}, launches {counts}, K1/K2 launches by dtype "
          f"{by_dtype}, plain calls on cuda {plain}, artifacts {written}",
          flush=True)
    require(engine.dtype == torch.bfloat16, f"retrieval {engine.dtype}")
    require(engine.n_crop * engine.test_loader.cfg.batch_size == RET_BATCH,
            f"retrieval batch: {engine.test_loader.cfg.batch_size} clips x "
            f"{engine.n_crop} crops")
    require(all(v.shape == (RET_CLIPS, 512) and np.isfinite(v).all()
                for v in feats.values()), "retrieval features")
    require(written, "retrieval did not write every artifact")
    require(recalls == sorted(recalls), f"R@k not monotone: {results}")
    require(counts["max_pool3d_fwd"] > 0, f"K1 not launched: {counts}")
    require(counts["max_pool3d_bwd"] == 0 and counts["color_augment"] == 0,
            f"retrieval launched K2 or K3: {counts}")
    require(by_dtype["max_pool3d_fwd.float32"] == 0,
            f"retrieval launched K1 off bf16: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts, "batch_ms": batch_ms, "peak_gib": peak,
            "run_dir": run_dir}


# ---------------------------------------------------------------------------
# phase 9: CAM visualization
# ---------------------------------------------------------------------------

def png_size(path) -> tuple:
    """(height, width) of an 8-bit RGB PNG, decoded with zlib: the
    signature, every chunk's CRC and the inflated rows' length are
    checked."""
    import struct
    import zlib
    data = open(path, "rb").read()
    require(data[:8] == PNG_MAGIC, f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        require(zlib.crc32(kind + body) & 0xFFFFFFFF == crc,
                f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    require(depth == 8 and color == 2, f"{path}: not RGB8 ({hdr})")
    require(len(zlib.decompress(idat)) == h * (1 + 3 * w),
            f"{path}: pixel rows do not match {w}x{h}")
    return h, w


def visualization_path(exp: str, pretrained: str) -> dict:
    """Phase 9: ``rspnet_tpu_torch.visualization`` on
    config/pretrain/s3dg.jsonnet with ``--mc`` from phase 4's checkpoint,
    batch cut to 8 (``-d``: one batch), twice with one seed; f32, K1
    only."""
    import torch
    from rspnet_tpu_torch import visualization

    ext = ('{dataset+: {name: "synthetic"}, batch_size: %d, '
           'device_geometry: true}' % VIS_BATCH)
    runs = []
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    for name in ("a", "b"):
        engine = visualization.main(
            ["-c", "config/pretrain/s3dg.jsonnet", "-e",
             os.path.join(exp, name), "-x", ext, "-d", "--seed", "0",
             "--device", "cuda", "--mc", pretrained])
        cam = engine.args.run_dir / "cam"
        runs.append({p.name: p.read_bytes() for p in sorted(cam.iterdir())})
        if name == "a":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, by_dtype, plain, *_ = _moved(before)
            sizes = {png_size(p) for p in sorted(cam.iterdir())}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {f"sample0_{b}_{n}.png" for b in range(VIS_BATCH)
            for n in ("qA", "qM", "kA", "kM")}
    size = engine.size
    print(f"visualization: batch {VIS_BATCH}, {len(runs[0])} PNGs of "
          f"{sorted(sizes)} (height, width), first run wall {wall:.1f} s, "
          f"peak memory {peak:.2f} GiB, launches {counts}, K1/K2 launches "
          f"by dtype {by_dtype}, plain calls on cuda {plain}, second run "
          f"byte-identical {runs[0] == runs[1]}", flush=True)
    require(set(runs[0]) == want, f"CAM names: {sorted(runs[0])}")
    require(sizes == {(size, 8 * size)}, f"CAM strips of {sizes}")
    require(runs[0] == runs[1], "two runs with one seed differ")
    require(counts["max_pool3d_fwd"] > 0, f"K1 not launched: {counts}")
    require(counts["max_pool3d_bwd"] == 0 and counts["color_augment"] == 0,
            f"visualization launched K2 or K3: {counts}")
    require(by_dtype["max_pool3d_fwd.bfloat16"] == 0,
            f"visualization launched K1 off f32: {by_dtype}")
    require(_moved(before)[3] == 0,
            "visualization (f32) ran the packed stem")
    require(_temporal_moved(before) == 0,
            "visualization (f32) ran a temporal convolution as a 2-D one")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts, "wall_s": wall, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase 12: aug_plus, exact multi-speed with packed frames, Adam
# ---------------------------------------------------------------------------

def _record_t_real():
    """Wrap the train and eval steps' speed gather to record each call's
    T_real; returns (the list, a function that restores the gather)."""
    from rspnet_tpu_torch.moco import step
    seen, gather = [], step.diff_speed_gather

    def recording(*a, **kw):
        out = gather(*a, **kw)
        seen.append(int(out[0].shape[1]))
        return out

    step.diff_speed_gather = recording
    return seen, lambda: setattr(step, "diff_speed_gather", gather)


def aug_plus_path(exp: str) -> dict:
    """Phase 12: 3 bf16 train steps of the S3D-G pretrain with aug_plus,
    diff_speed [4, 2], packed frames and Adam; both speeds drawn, each
    step at T_real = 64 // speed; K1 26, K2 13 a step, all bf16; K3 once
    per q and k clip."""
    import torch
    from rspnet_tpu_torch import pretrain

    plan = color_plan_line((MAIN_BATCH, P12_PACKED, 224, 224, 3), False)
    argv = _main_argv(exp, fields=P12_FIELDS)
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t_real, restore = _record_t_real()
    t0 = time.perf_counter()
    try:
        engine = pretrain.main(argv)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = engine.meters["loss"].avg
    steps, speeds = engine.step_times, engine.speeds
    ckpt = os.path.join(exp, "checkpoint.pth.tar")
    subset = engine.train_loader.cfg.frame_subset
    by_speed = {s: [round(t, 1) for t, v in zip(steps, speeds) if v == s]
                for s in P12_SPEEDS}
    for i, (s, t, ms) in enumerate(zip(speeds, t_real, steps)):
        print(f"aug_plus multi-speed step {i}: speed {s}, T_real {t}, "
              f"{ms:.1f} ms", flush=True)
    print(f"aug_plus multi-speed pretrain: batch {engine.batch_size}, "
          f"{engine.cfg.get_int('temporal_transforms.size')} loaded frames, "
          f"{len(subset)} packed, optimizer "
          f"{type(engine.state.optimizer).__name__}, compute dtype "
          f"{engine.dtype}, speeds {speeds}, T_real {t_real}, step ms by "
          f"speed {by_speed}, wall {wall:.1f} s, peak memory {peak:.2f} GiB, "
          f"loss {loss:.4f}, launches {counts}, K1/K2 launches by dtype "
          f"{by_dtype}, plain calls on cuda {plain}, K3 "
          f"[{MAIN_BATCH},{P12_PACKED},224,224,3] f32: {plan}, checkpoint "
          f"{os.path.exists(ckpt)}", flush=True)
    require(math.isfinite(loss), f"phase 12 loss {loss} not finite")
    require(len(steps) == 3 and sorted(set(speeds)) == [2, 4],
            f"phase 12: {len(steps)} steps at speeds {speeds}, not 3 steps "
            f"at both speeds")
    require(t_real == [P12_LOADED // s for s in speeds],
            f"phase 12: T_real {t_real} for speeds {speeds}")
    require(engine.cfg.get_int("temporal_transforms.size") == P12_LOADED
            and len(subset) == P12_PACKED,
            f"phase 12 loads {len(subset)} packed frames, not {P12_PACKED}")
    require(isinstance(engine.state.optimizer, torch.optim.Adam)
            and engine.aug_plus, "phase 12 runs without Adam or aug_plus")
    require(engine.dtype == torch.bfloat16 and engine.batch_size
            == MAIN_BATCH, f"phase 12: {engine.dtype}, batch "
            f"{engine.batch_size}")
    want = {"max_pool3d_fwd": 26 * 3, "max_pool3d_bwd": 13 * 3,
            "color_augment": 2 * 3}
    require(counts == want, f"phase 12 launches {counts}, not {want}")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"K1/K2 launched off bf16 in phase 12: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(os.path.exists(ckpt), "phase 12: no checkpoint.pth.tar")
    return {"launches": counts, "steps_ms": steps, "speeds": speeds,
            "peak_gib": peak, "checkpoint": ckpt}


def aug_plus_validate_path(exp: str, ckpt: str) -> dict:
    """Phase 12's ``--validate`` from its checkpoint: both speeds drawn
    again (the stream starts anew), K1 and K3 launched, K2 not."""
    import torch
    from rspnet_tpu_torch import pretrain

    before = _counters()
    t_real, restore = _record_t_real()
    t0 = time.perf_counter()
    try:
        engine = pretrain.main(_main_argv(exp, "--validate",
                                          "--load-checkpoint", ckpt,
                                          fields=P12_FIELDS))
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts, by_dtype, plain, *_ = _moved(before)
    metrics = engine.validation
    print(f"aug_plus multi-speed validate: wall {wall:.1f} s, speeds "
          f"{engine.speeds}, T_real {t_real}, metrics "
          f"{ {k: round(v, 4) for k, v in metrics.items()} }, launches "
          f"{counts}, K1/K2 launches by dtype {by_dtype}, plain calls on "
          f"cuda {plain}", flush=True)
    require(metrics and all(math.isfinite(v) for v in metrics.values()),
            f"phase 12 validate metrics not finite: {metrics}")
    require(sorted(set(engine.speeds)) == [2, 4]
            and t_real == [P12_LOADED // s for s in engine.speeds],
            f"phase 12 validate: speeds {engine.speeds}, T_real {t_real}")
    require(counts["max_pool3d_fwd"] > 0 and counts["max_pool3d_bwd"] == 0
            and counts["color_augment"] > 0,
            f"phase 12 validate launches {counts}")
    require(by_dtype["max_pool3d_fwd.float32"] == 0,
            f"phase 12 validate launched K1 off bf16: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return {"launches": counts}


# ---------------------------------------------------------------------------
# phase 13: two ranks on one card (the collectives' overhead, not scaling)
# ---------------------------------------------------------------------------

def _p13_state(dtype, mesh=None):
    """A fresh MoCo state of config/pretrain/s3dg.jsonnet at full width (K
    16384), weights and queue from seed 0 / 1 on every rank, the BNs over
    ``mesh``'s group, the queue sharded on a 2-D mesh; the lr of a global
    batch of 64."""
    import torch
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.framework.environment import scale_learning_rate
    from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
    from rspnet_tpu_torch.models.common import set_bn_process_group
    from rspnet_tpu_torch.moco import (build_moco_model, init_moco_state,
                                       shard_queue_2d)
    cfg = load_config("config/pretrain/s3dg.jsonnet", [])
    torch.manual_seed(0)
    model, mcfg = build_moco_model(cfg, dtype=dtype)
    model = model.cuda().to(memory_format=torch.channels_last_3d)
    lr = scale_learning_rate(cfg.get_float("optimizer.lr"), 1, P13_GLOBAL)
    opt = build_optimizer(cfg.get_config("optimizer"), model.parameters(),
                          lr)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = init_moco_state(model, mcfg, opt, gen)
    if mesh is not None and mesh.group is not None:
        set_bn_process_group(state.model_q, mesh.group)
        set_bn_process_group(state.model_k, mesh.group)
        if mesh.is_2d:
            state.queue = shard_queue_2d(state.queue, mesh)
    return state, mcfg, cfg


def _p13_snapshot(state, metrics, mesh=None) -> dict:
    """The state after a step on the host: both encoders' parameters and
    buffers, the dense queue, the pointer, the metrics."""
    from rspnet_tpu_torch.moco import gather_queue_2d
    queue = state.queue
    if mesh is not None and mesh.is_2d:
        queue = gather_queue_2d(queue, mesh)
    return {"q": {k: v.detach().cpu().clone()
                  for k, v in state.model_q.state_dict().items()},
            "k": {k: v.detach().cpu().clone()
                  for k, v in state.model_k.state_dict().items()},
            "queue": queue.detach().cpu().clone(), "ptr": state.queue_ptr,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _p13_inputs(rank: int):
    """The f32 global batch (64 normalized clips of 32 frames at 224², q
    and k, from seed 2 on the card), this rank's rows of it, the per-rank
    permutations (seed 3 + r) and the one-rank permutation with the same
    fast half."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    shape = (P13_GLOBAL, 32, 224, 224, 3)
    q = torch.randn(shape, generator=g, device="cuda")
    k = q + 0.1 * torch.randn(shape, generator=g, device="cuda")
    perms = []
    for r in range(P13_RANKS):
        g.manual_seed(3 + r)
        perms.append(torch.randperm(P13_BATCH, generator=g, device="cuda"))
    half = P13_BATCH // 2
    glob = torch.cat([perms[r][:half] + r * P13_BATCH
                      for r in range(P13_RANKS)]
                     + [perms[r][half:] + r * P13_BATCH
                        for r in range(P13_RANKS)])
    rows = slice(rank * P13_BATCH, (rank + 1) * P13_BATCH)
    return q, k, q[rows].clone(), k[rows].clone(), perms[rank], glob


def _p13_f32_step(mesh, q, k, perm) -> dict:
    import torch
    from rspnet_tpu_torch.moco import layout_for, train_step
    state, mcfg, _ = _p13_state(None, mesh)
    before = {n: p.detach().cpu().clone()
              for n, p in state.model_q.named_parameters()}
    metrics = train_step(state, q, k, mcfg, perm=perm, speed_index=0,
                         layout=layout_for(mesh))
    snap = _p13_snapshot(state, metrics, mesh)
    snap["before"] = before
    del state
    torch.cuda.empty_cache()
    return snap


def _p13_errors(got: dict, ref: dict) -> dict:
    """Errors of a multi-rank f32 step against the one-rank step: the
    parameter update's relative L2 error, the largest relative error of
    a BN statistic and of the key encoder, the queue's largest absolute
    error, the loss's relative error and the largest accuracy error."""
    import torch
    num = den = 0.0
    for name, p0 in ref["before"].items():
        d_ref = ref["q"][name].double() - p0.double()
        d_got = got["q"][name].double() - p0.double()
        num += float(((d_got - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))
    stats = max(rel(got[w][n], ref[w][n]) for w in ("q", "k")
                for n in ref[w] if n.endswith(("running_mean",
                                               "running_var")))
    key_params = max(rel(got["k"][n], ref["k"][n]) for n in ref["k"]
                     if not n.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")))
    mg, mr = got["metrics"], ref["metrics"]
    return {"update_rel_l2": math.sqrt(num / den), "bn_stats_rel": stats,
            "key_params_rel": key_params,
            "queue_abs": float((got["queue"] - ref["queue"]).abs().max()),
            "loss_rel": abs(mg["loss"] - mr["loss"]) / abs(mr["loss"]),
            "acc_abs": max(abs(mg[n] - mr[n]) for n in mr
                           if n.startswith("acc")),
            "ptr": (got["ptr"], ref["ptr"]),
            "counters": all(torch.equal(got[w][n], ref[w][n])
                            for w in ("q", "k") for n in ref[w]
                            if n.endswith("num_batches_tracked"))}


def _p13_check(what: str, err: dict) -> None:
    print(f"multi-rank {what} f32 step against one rank: "
          f"{json.dumps(err)}", flush=True)
    for key, limit in P13_TOL.items():
        require(err[key] <= limit,
                f"phase 13 {what}: {key} {err[key]} above {limit}")
    require(err["ptr"][0] == err["ptr"][1] and err["counters"],
            f"phase 13 {what}: pointer or BN counters differ: {err}")


def _p13_digest(state) -> str:
    """sha256 of both encoders' parameters and buffers, the queue and the
    pointer, in one order on every rank."""
    import hashlib
    h = hashlib.sha256()
    for net in (state.model_q, state.model_k):
        for name, t in net.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(state.queue.detach().cpu().numpy().tobytes())
    h.update(str(state.queue_ptr).encode())
    return h.hexdigest()


def multirank_worker(out_dir: str) -> int:
    """One rank of phase 13 (chip_smoke.py --multirank OUT_DIR, two of
    them on one card through gloo): (a) one f32 step in the 1-D layout,
    (b) one in the 2-D layout ``parallel: {data: 1, model: 2}``, both held
    by rank 0 against the one-rank f32 step on the global batch, then 3
    bf16 steps in the 1-D layout from uint8 clips (K3, K1, K2 counted),
    the ranks' states bit-equal after each."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from rspnet_tpu_torch.engines.normalization import dataset_normalization
    from rspnet_tpu_torch.moco import layout_for, train_step
    from rspnet_tpu_torch.ops.augment import augment_batch, sample_train_params
    from rspnet_tpu_torch.parallel import (barrier, collectives, create_mesh,
                                           create_mesh_2d, local_rank)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # gloo on the card, which both ranks share (NCCL wants a card a rank)
    torch.cuda.set_device(local_rank())
    dist.init_process_group("gloo", init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    rank = dist.get_rank()
    mesh = create_mesh()
    q, k, q_loc, k_loc, perm, glob = _p13_inputs(rank)
    if rank:
        del q, k
    t0 = time.perf_counter()
    got_1d = _p13_f32_step(mesh, q_loc, k_loc, perm)          # (a)
    t_1d = time.perf_counter() - t0
    mesh_2d = create_mesh_2d(1, P13_RANKS)
    t0 = time.perf_counter()
    got_2d = _p13_f32_step(mesh_2d, q_loc, k_loc, perm)       # (b)
    t_2d = time.perf_counter() - t0
    del q_loc, k_loc
    torch.cuda.empty_cache()
    result = {"rank": rank, "f32_step_s": {"1d": t_1d, "2d": t_2d}}
    if rank == 0:
        from rspnet_tpu_torch.parallel import Mesh
        ref = _p13_f32_step(Mesh(), q, k, glob)
        # the rounding floor: the same step on the rows reversed
        flipped = _p13_f32_step(Mesh(), q.flip(0), k.flip(0),
                                P13_GLOBAL - 1 - glob)
        # its keys were enqueued in reversed order
        flipped["queue"][:, :P13_GLOBAL] = \
            flipped["queue"][:, :P13_GLOBAL].flip(1)
        del q, k
        torch.cuda.empty_cache()
        result["errors"] = {"1d": _p13_errors(got_1d, ref),
                            "2d": _p13_errors(got_2d, ref),
                            "rows_reversed": _p13_errors(flipped, ref)}
        print(f"multi-rank f32 rounding floor (one rank, rows reversed): "
              f"{json.dumps(result['errors']['rows_reversed'])}",
              flush=True)
        _p13_check("1-D", result["errors"]["1d"])
        _p13_check("2-D", result["errors"]["2d"])
    barrier()

    # 3 bf16 steps from uint8 clips, the engine's augment and draws
    state, mcfg, cfg = _p13_state(torch.bfloat16, mesh)
    layout = layout_for(mesh)
    mean, std = dataset_normalization(cfg)
    rng = np.random.default_rng(rank)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1 + rank)
    g_u8 = torch.Generator(device="cuda")
    rows = slice(rank * P13_BATCH, (rank + 1) * P13_BATCH)
    # every collective is one all-reduce (parallel/collectives.py),
    # counted where it is called
    reduces = collectives.all_reduces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    reduces.update(calls=0, bytes=0)
    steps, digests = [], []
    for i in range(3):
        g_u8.manual_seed(100 + i)
        clips = [torch.randint(0, 256, (P13_GLOBAL, 32, 128, 171, 3),
                               generator=g_u8, device="cuda",
                               dtype=torch.uint8)[rows] for _ in range(2)]
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug = []
        for c in clips:
            p = sample_train_params(rng, P13_BATCH, [(128, 171)],
                                    crop_area=(0.4, 1.0), h_flip=0.5,
                                    gray_p=0.2, jitter=(0.4, 0.4, 0.4, 0.4))
            aug.append(augment_batch(c, p, size=(224, 224), mean=mean,
                                     std=std))
        metrics = train_step(state, aug[0], aug[1], mcfg, generator=gen,
                             layout=layout)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1000.0)
        require(math.isfinite(loss), f"phase 13 rank {rank} loss {loss}")
        digests.append(_p13_digest(state))
        del clips, aug
    counts, by_dtype, plain, *_ = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    every = [None] * P13_RANKS
    dist.all_gather_object(every, digests)
    result.update(steps_ms=steps, peak_gib=peak, launches=counts,
                  all_reduces_per_step=reduces["calls"] / 3,
                  all_reduce_mib_per_step=reduces["bytes"] / 3 / 2 ** 20,
                  by_dtype=by_dtype, plain=plain, loss=loss,
                  ranks_equal=[len(set(d)) == 1 for d in zip(*every)])
    print(f"multi-rank rank {rank}: 3 bf16 steps (1-D), per-rank batch "
          f"{P13_BATCH}, step ms {[round(t, 1) for t in steps]}, "
          f"all-reduces {reduces['calls'] / 3:.0f} a step summing "
          f"{reduces['bytes'] / 3 / 2 ** 20:.2f} MiB, peak memory "
          f"{peak:.2f} GiB, loss {loss:.4f}, "
          f"launches {counts}, "
          f"K1/K2 by dtype {by_dtype}, plain calls on cuda {plain}, state "
          f"bit-equal across ranks after each step "
          f"{result['ranks_equal']}", flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def multirank_path() -> dict:
    """Phase 13 (a), (b): two ranks of ``multirank_worker`` share the card
    through gloo; every rank's launches and the checks of rank 0."""
    from rspnet_tpu_torch.parallel.launch import free_port
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for rank in range(P13_RANKS):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(P13_RANKS),
                       RANK=str(rank), LOCAL_RANK="0")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multirank",
                 out], env=env))
        try:
            t_end = time.monotonic() + P13_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                require(time.monotonic() < t_end,
                        f"phase 13 ranks ran past {P13_TIMEOUT_S} s")
                require(all(p.poll() in (None, 0) for p in procs),
                        f"a phase 13 rank failed: "
                        f"{[p.poll() for p in procs]}")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        require(all(p.returncode == 0 for p in procs),
                f"a phase 13 rank failed: {[p.returncode for p in procs]}")
        ranks = []
        for rank in range(P13_RANKS):
            with open(os.path.join(out, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    want = {"max_pool3d_fwd": 26 * 3, "max_pool3d_bwd": 13 * 3,
            "color_augment": 2 * 3}
    for r in ranks:
        require(r["launches"] == want,
                f"phase 13 rank {r['rank']} launches {r['launches']}, not "
                f"{want}")
        require(not any(n for key, n in r["by_dtype"].items()
                        if not key.endswith(".bfloat16")),
                f"phase 13: K1/K2 launched off bf16: {r['by_dtype']}")
        require(not any(r["plain"].values()),
                f"phase 13: plain versions ran on CUDA tensors: "
                f"{r['plain']}")
        require(all(r["ranks_equal"]),
                f"phase 13: ranks differ after a bf16 step: "
                f"{r['ranks_equal']}")
    return {"ranks": ranks}


def _p13_timed_steps(q, k, bn_group) -> dict:
    """3 bf16 steps of one process at the per-rank batch, the BNs' moments
    over ``bn_group`` (None: cuDNN's BN): step ms and peak GiB."""
    import torch
    from rspnet_tpu_torch.models.common import set_bn_process_group
    from rspnet_tpu_torch.moco import train_step
    state, mcfg, _ = _p13_state(torch.bfloat16)
    set_bn_process_group(state.model_q, bn_group)
    set_bn_process_group(state.model_k, bn_group)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(state, q, k, mcfg, generator=gen)["loss"]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1000.0)
        require(math.isfinite(float(loss)),
                f"phase 13 (c) loss {float(loss)} is not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    torch.cuda.empty_cache()
    return {"steps_ms": steps, "peak_gib": peak}


def nccl_world1_path() -> dict:
    """Phase 13 (c): one NCCL group of one rank; one bf16 step of the 1-D
    layout through it (every collective on the card) equals the step with
    no group bit for bit (cuDNN's deterministic algorithms in both). Then
    the cross-replica BN's cost a rank: 3 steps with the BNs' moments over
    that group (its kernels and all-reduces, no other rank to wait for)
    beside 3 with cuDNN's BN, one process at the per-rank batch."""
    import torch
    import torch.distributed as dist
    from rspnet_tpu_torch.moco import data_parallel_layout, train_step
    from rspnet_tpu_torch.parallel.launch import free_port

    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    shape = (P13_BATCH, 32, 224, 224, 3)
    q = torch.randn(shape, generator=g, device="cuda")
    k = torch.randn(shape, generator=g, device="cuda")
    perm = torch.randperm(P13_BATCH, generator=g, device="cuda")
    alone = _p13_timed_steps(q, k, None)
    deterministic = torch.backends.cudnn.deterministic
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        torch.backends.cudnn.deterministic = True
        digests = []
        for layout in (None, data_parallel_layout(dist.group.WORLD)):
            state, mcfg, _ = _p13_state(torch.bfloat16)
            train_step(state, q, k, mcfg, perm=perm, speed_index=0,
                       layout=layout)
            torch.cuda.synchronize()
            digests.append(_p13_digest(state))
            del state
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = deterministic
        backend = dist.get_backend()
        synced = _p13_timed_steps(q, k, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    print(f"multi-rank NCCL world 1 ({backend}): one bf16 step, batch "
          f"{P13_BATCH}, equal to the step without a group: "
          f"{digests[0] == digests[1]}", flush=True)
    print(f"one process, batch {P13_BATCH}, 3 bf16 steps: cuDNN's BN step "
          f"ms {[round(t, 1) for t in alone['steps_ms']]}, peak "
          f"{alone['peak_gib']:.2f} GiB; the cross-replica BN over the "
          f"NCCL group of one step ms "
          f"{[round(t, 1) for t in synced['steps_ms']]}, peak "
          f"{synced['peak_gib']:.2f} GiB", flush=True)
    require(backend == "nccl" and digests[0] == digests[1],
            "phase 13 (c): the NCCL world-1 step differs from the step "
            "without a group")
    return {"equal": True, "alone": alone, "cross_replica_bn": synced}


# ---------------------------------------------------------------------------
# phase 14: the device-resident dataset cache and the native decoder
# ---------------------------------------------------------------------------

def cached_pretrain_path(exp: str, uncached: dict) -> dict:
    """Phase 14 (a): phase 4's run with ``cache_device: true``: the 256
    synthetic samples cached on the card at epoch 0, 3 bf16 steps served
    from there; per step K1 26, K2 13, K3 2, all bf16, as phase 4; no clip
    copied from the host after the build."""
    import torch
    from rspnet_tpu_torch import pretrain
    from rspnet_tpu_torch.data.device_cache import DeviceCachedLoader

    argv = _main_argv(exp, fields="cache_device: true")
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    t0 = time.perf_counter()
    engine = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the build copies the cache itself (not through clip_to_device): any
    # copy counted here is a step's
    counts, by_dtype, plain, _, copies = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loader = engine.train_loader
    require(isinstance(loader, DeviceCachedLoader),
            f"phase 14: the loader is a {type(loader).__name__}")
    steps, loss = engine.step_times, engine.meters["loss"].avg
    devices = sorted({str(c.device) for c in loader._cache})
    print(f"cached pretrain: batch {MAIN_BATCH}, compute dtype "
          f"{engine.dtype}, {loader.num_samples} samples cached on "
          f"{devices}, {loader.nbytes} bytes (expected {P14_BYTES}), built "
          f"in {loader.build_s:.2f} s, {len(steps)} steps, step ms "
          f"{[round(t, 1) for t in steps]} (phase 4, uncached: "
          f"{[round(t, 1) for t in uncached['steps_ms']]}), wall {wall:.1f} "
          f"s, peak memory {peak:.2f} GiB (phase 4: "
          f"{uncached['peak_gib']:.2f}), loss {loss:.4f}, launches {counts} "
          f"(phase 4: {uncached['launches']}), K1/K2 launches by dtype "
          f"{by_dtype}, plain calls on cuda {plain}, host-to-device clip "
          f"copies in the steps {copies}", flush=True)
    require(math.isfinite(loss), f"phase 14 loss {loss} is not finite")
    require(len(steps) == 3, f"phase 14 ran {len(steps)} steps, not 3")
    require(engine.dtype == torch.bfloat16, f"phase 14: {engine.dtype}")
    require(devices == ["cuda:0"], f"phase 14 cache on {devices}")
    require(loader.nbytes == P14_BYTES,
            f"phase 14 cached {loader.nbytes} bytes, not {P14_BYTES}")
    require(counts == uncached["launches"],
            f"phase 14 launches {counts}, phase 4's {uncached['launches']}")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"K1/K2 launched off bf16 in phase 14: {by_dtype}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(copies == {"calls": 0, "bytes": 0},
            f"phase 14 copied clips from the host: {copies}")
    return {"engine": engine, "launches": counts, "steps_ms": steps,
            "peak_gib": peak, "bytes": loader.nbytes,
            "build_s": loader.build_s}


def check_cache_exact(engine) -> None:
    """Phase 14 (b): every cached sample bit-equal to the uncached loader's
    clip (the loader the cache wraps, iterated anew at epoch 0), and one
    batch of the cache's iteration equal to the rows its order names."""
    import numpy as np
    import torch

    loader = engine.train_loader
    inner, B = loader._inner, loader.cfg.batch_size
    inner.set_epoch(0)
    equal = total = 0
    for b, batch in enumerate(inner):
        for c, clip in enumerate(batch["clips"]):
            rows = loader._cache[c][b * B:(b + 1) * B]
            want = torch.from_numpy(clip).to(rows.device)
            equal += sum(bool(torch.equal(rows[i], want[i]))
                         for i in range(len(rows)))
            total += len(rows)
        require(np.array_equal(loader._labels[b * B:(b + 1) * B],
                               batch["labels"]), "phase 14 labels differ")
    loader.set_epoch(1)
    first = next(iter(loader))
    order = loader._epoch_order()[:B]
    served = all(torch.equal(first["clips"][c],
                             loader._cache[c][torch.from_numpy(order).cuda()])
                 for c in range(len(loader._cache)))
    print(f"cached clips bit-equal to the uncached loader's: {equal} of "
          f"{total} (sample, clip) pairs; an epoch-1 batch equal to the rows "
          f"of its order: {served}", flush=True)
    require(total == P14_SAMPLES * 2 and equal == total,
            f"phase 14: {total - equal} of {total} cached clips differ")
    require(served, "phase 14: a cached batch is not its order's rows")


def cached_finetune_path(exp: str, pretrained: str, uncached: dict) -> dict:
    """Phase 14 (c): phase 6's finetune with ``cache_device: true`` (both
    splits cached): the launches of phase 6, no clip copied."""
    import torch
    from rspnet_tpu_torch import finetune
    from rspnet_tpu_torch.data.device_cache import DeviceCachedLoader

    ext = ('{dataset+: {name: "synthetic", num_samples: 12, '
           'val_num_samples: 4}, device_geometry: true, bn_recalibrate: 1, '
           'cache_device: true}')
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    engine, final = finetune.main(_finetune_argv(exp, "--mc", pretrained,
                                                 ext=ext))
    torch.cuda.synchronize()
    counts, by_dtype, plain, _, copies = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = engine.step_times
    cached = [isinstance(ld, DeviceCachedLoader)
              for ld in (engine.train_loader, engine.validate_loader)]
    print(f"cached finetune: step ms {[round(t, 1) for t in steps]} (phase "
          f"6: {[round(t, 1) for t in uncached['steps_ms']]}), peak memory "
          f"{peak:.2f} GiB (phase 6: {uncached['peak_gib']:.2f}), final "
          f"validation { {k: round(v, 4) for k, v in final.items()} }, "
          f"train and val splits cached {cached}, launches {counts} (phase "
          f"6: {uncached['launches']}), K1/K2 launches by dtype {by_dtype}, "
          f"host-to-device clip copies {copies}", flush=True)
    require(all(cached), f"phase 14 finetune caches {cached}")
    require(len(steps) == 3 and math.isfinite(final["loss"]),
            f"phase 14 finetune: {len(steps)} steps, {final}")
    require(counts == uncached["launches"],
            f"phase 14 finetune launches {counts}")
    require(not any(n for key, n in by_dtype.items()
                    if not key.endswith(".bfloat16")),
            f"phase 14 finetune K1/K2 off bf16: {by_dtype}")
    require(not any(plain.values()), f"plain calls on cuda: {plain}")
    require(copies["calls"] == 0, f"phase 14 finetune copied {copies}")
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak}


def cached_retrieval_path(exp: str, pretrained: str, uncached: dict) -> dict:
    """Phase 14 (c): phase 8's ResNet-18 retrieval with ``cache_device:
    true``: the launches of phase 8, the test split's features equal to
    phase 8's bit for bit, no clip copied."""
    import numpy as np
    import torch
    from rspnet_tpu_torch import retrieval

    ext = ('{dataset+: {name: "synthetic", num_samples: %d, '
           'val_num_samples: %d}, device_geometry: true, cache_device: '
           'true}' % (RET_CLIPS, RET_CLIPS))
    torch.cuda.reset_peak_memory_stats()
    before = _counters()
    engine, results = retrieval.main(
        ["-c", "config/retrieval/ucf101_resnet18.jsonnet", "-e", exp, "-x",
         ext, "-d", "--seed", "0", "--device", "cuda", "--mc", pretrained])
    torch.cuda.synchronize()
    counts, by_dtype, plain, _, copies = _moved(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run_dir = engine.args.run_dir
    same = {n: bool(np.array_equal(np.load(run_dir / n),
                                   np.load(uncached["run_dir"] / n)))
            for n in ("test_fold1_feats.npy", "test_fold1_labels.npy")}
    builds = [round(ld.build_s, 2) for ld in (engine.train_loader,
                                              engine.test_loader)]
    print(f"cached retrieval resnet18: caches built in {builds} s, batch ms "
          f"{[round(t, 1) for t in engine.batch_times]} (phase 8: "
          f"{[round(t, 1) for t in uncached['batch_ms']]}), peak memory "
          f"{peak:.2f} GiB (phase 8: {uncached['peak_gib']:.2f}), test "
          f"split equal to phase 8's {same}, recalls {results}, launches "
          f"{counts} (phase 8: {uncached['launches']}), K1/K2 launches by "
          f"dtype {by_dtype}, host-to-device clip copies {copies}",
          flush=True)
    require(all(same.values()), f"phase 14 retrieval test split: {same}")
    require(counts == uncached["launches"],
            f"phase 14 retrieval launches {counts}")
    require(by_dtype["max_pool3d_fwd.float32"] == 0,
            f"phase 14 retrieval K1 off bf16: {by_dtype}")
    require(not any(plain.values()), f"plain calls on cuda: {plain}")
    require(copies["calls"] == 0, f"phase 14 retrieval copied {copies}")
    return {"launches": counts, "batch_ms": engine.batch_times,
            "peak_gib": peak}


def cached_visualization_path(exp: str, pretrained: str,
                              uncached: dict) -> dict:
    """Phase 14 (c): phase 9's CAM run with ``cache_device: true`` (16
    samples cached, one batch of 8): the launches of phase 9's run, its
    32 PNGs, no clip copied."""
    import torch
    from rspnet_tpu_torch import visualization

    ext = ('{dataset+: {name: "synthetic", num_samples: 16}, batch_size: '
           '%d, device_geometry: true, cache_device: true}' % VIS_BATCH)
    before = _counters()
    engine = visualization.main(
        ["-c", "config/pretrain/s3dg.jsonnet", "-e", exp, "-x", ext, "-d",
         "--seed", "0", "--device", "cuda", "--mc", pretrained])
    torch.cuda.synchronize()
    counts, by_dtype, plain, _, copies = _moved(before)
    pngs = sorted((engine.args.run_dir / "cam").iterdir())
    print(f"cached visualization: {len(pngs)} PNGs, launches {counts} "
          f"(phase 9: {uncached['launches']}), K1/K2 launches by dtype "
          f"{by_dtype}, host-to-device clip copies {copies}", flush=True)
    require(len(pngs) == 4 * VIS_BATCH and all(
        png_size(p) == (engine.size, 8 * engine.size) for p in pngs),
        "phase 14 CAM strips")
    require(counts == uncached["launches"],
            f"phase 14 visualization launches {counts}")
    require(not any(plain.values()), f"plain calls on cuda: {plain}")
    require(copies["calls"] == 0, f"phase 14 visualization copied {copies}")
    return {"launches": counts}


def _write_test_video(path: str, frames: int, w: int, h: int) -> bool:
    """An MJPG video of a moving ramp, written by the ffmpeg program;
    False where there is none."""
    import shutil
    import numpy as np
    if shutil.which("ffmpeg") is None:
        return False
    ramp = np.zeros((h, w, 3), np.uint8)
    ramp[..., 1] = np.arange(w, dtype=np.uint8)[None] * 2
    raw = b"".join(np.roll(ramp, 3 * t, axis=1).tobytes()
                   for t in range(frames))
    subprocess.run(["ffmpeg", "-loglevel", "error", "-y", "-f", "rawvideo",
                    "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", "25", "-i",
                    "-", "-c:v", "mjpeg", path], input=raw, check=True,
                   timeout=60)
    return True


def native_decoder_check(exp: str) -> dict:
    """Phase 14 (d): the native FFmpeg decoder builds (or its build error
    is printed: the loader then decodes with OpenCV); when built, an MJPG
    written by the ffmpeg program decodes bit-equal across two calls, and
    within the JAX package's limits of OpenCV where OpenCV exists."""
    import numpy as np
    from rspnet_tpu_torch.native import video_decode

    t0 = time.perf_counter()
    built = video_decode.is_available()
    build_s = time.perf_counter() - t0
    print(f"native decoder: built {built}, {video_decode.library_path()}, "
          f"{build_s:.1f} s" + ("" if built else
                                 f", build error: {video_decode.build_error}"),
          flush=True)
    if not built:
        return {"built": False}
    path = os.path.join(exp, "ramp.avi")
    if not _write_test_video(path, 40, 170, 96):
        print("native decoder: no ffmpeg program to write a test video",
              flush=True)
        return {"built": True}
    idx = [0, 17, 39, 5, 60]
    with video_decode.RspVideoReader(path) as r:
        first, again = r.get_batch(idx), r.get_batch(idx)
        scaled = r.get_batch(idx, (85, 48))
    same = bool(np.array_equal(first, again))
    diff = None
    try:
        from rspnet_tpu_torch.data.video_reader import CvVideoReader
        c = CvVideoReader(path)
        diff = int(np.abs(first[:3].astype(int)
                          - c.get_batch(idx[:3]).astype(int)).max())
        c.close()
    except ImportError:
        pass
    print(f"native decoder: MJPG 170x96, frames {idx}: shape "
          f"{list(first.shape)}, scaled {list(scaled.shape)}, two calls "
          f"bit-equal {same}, max abs against OpenCV {diff} (limit 2)",
          flush=True)
    require(same and first.shape == (5, 96, 170, 3)
            and scaled.shape == (5, 48, 85, 3), "phase 14 native decoder")
    require(diff is None or diff <= 2,
            f"native decoder against OpenCV: {diff}")
    return {"built": True, "bit_equal": same, "opencv_max_abs": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multirank", metavar="OUT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase 13
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.multirank:
        return multirank_worker(args.multirank)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from rspnet_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)                            # phase 0

    t0 = time.perf_counter()                                      # phase 1
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                        "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err_fwd, err_bwd = check_pool(dev, batch=4)                   # phase 2
    check_pool_nan(dev, batch=4)
    check_pool_offset(dev)
    check_pool_wide(dev)
    err_color = max(
        check_color(dev, 8, COLOR_CLIP),
        check_color(dev, MAIN_BATCH, COLOR_CLIP),
        check_color(dev, P13_BATCH, COLOR_CLIP),      # phase 13's clips
        *(check_color(dev, b, clip) for b, clip in RAGGED_COLOR),
        check_color(dev, *LARGE_COLOR, resident=False),
        check_color(dev, 8, COLOR_CLIP, resident=False,
                    build="color_augment_generic"),
        # the finetune path's clips: their 64 frames do not fit the
        # resident instance in f32 or u8 (PERF.md §6)
        check_color(dev, FT_BATCH, (FT_FRAMES, 224, 224), resident=False))
    check_color_repeat(dev, MAIN_BATCH, COLOR_CLIP)

    check_pool_fwd(dev, 2 * MAIN_BATCH, dtypes=("float32",))      # phase 3
    pool = {d: time_pool(dev, MAIN_BATCH, d) for d in ("float32", "bfloat16")}
    # K1 at the fused key pass's shapes (2B clips), the other half of its
    # main-path launches
    pool_key = time_pool(dev, 2 * MAIN_BATCH, "bfloat16", backward=False)
    print(f"time K1 bf16 over the {len(POOL_SITES)} S3D-G sites: batch "
          f"{MAIN_BATCH} {pool['bfloat16']['fwd']:.4f} ms (bound "
          f"{pool['bfloat16']['fwd_bound']:.4f}), batch {2 * MAIN_BATCH} (the "
          f"fused key pass) {pool_key['fwd']:.4f} ms (bound "
          f"{pool_key['fwd_bound']:.4f})", flush=True)
    time_host(dev)
    color = time_color(dev, batch=MAIN_BATCH, frames=32, size=224)
    torch.cuda.empty_cache()
    from rspnet_tpu_torch.ops import k3_timeline
    k3_timeline.main(["--batch", str(MAIN_BATCH)])
    torch.cuda.empty_cache()
    # the finetune path's shapes: K1 at the final validation's batch, K1/K2
    # timed at the train step's, K3 on its clips
    check_pool_fwd(dev, FT_FINAL_BATCH, sites=FT_POOL_SITES,
                   dtypes=("bfloat16",))
    pool_ft = time_pool(dev, FT_BATCH, "bfloat16", sites=FT_POOL_SITES)
    color_ft = time_color(dev, batch=FT_BATCH, frames=FT_FRAMES, size=224)
    torch.cuda.empty_cache()
    # the zoo's paths, bf16: K1/K2 at each pretrain q batch, K1 at its
    # fused key batch and at retrieval's 80 clips; the visualization path's
    # K1 in f32 at S3D-G's sites, batch 8
    pool_zoo = {}
    for arch, sites in ZOO_POOL_SITES.items():
        b = ZOO_BATCH[arch]
        check_pool_fwd(dev, 2 * b, sites=sites, dtypes=("bfloat16",))
        pool_zoo[f"{arch}_pretrain"] = time_pool(dev, b, "bfloat16",
                                                 sites=sites)
        pool_zoo[f"retrieval_{arch}"] = time_pool(
            dev, RET_BATCH, "bfloat16", sites=sites, backward=False)
    pool_zoo["visualization"] = time_pool(dev, VIS_BATCH, "float32",
                                          backward=False)
    # K3 on the zoo's pretrain clips, f32 [B, 32, 112, 112, 3]
    color_zoo = {arch: time_color(dev, batch=b, frames=32, size=112)
                 for arch, b in ZOO_BATCH.items()}
    # phase 10's sites: K1/K2 bf16 at TSM's stem pool (the q batch; K1 also
    # at the fused key batch), K3 on the TSM and R(2+1)D clips
    check_pool_fwd(dev, 2 * P10_PRETRAIN["tsm"][1], sites=TSM_POOL_SITES,
                   dtypes=("bfloat16",))
    pool_zoo["tsm_pretrain"] = time_pool(dev, P10_PRETRAIN["tsm"][1],
                                         "bfloat16", sites=TSM_POOL_SITES)
    for leg, (_, b, frames, _) in P10_PRETRAIN.items():
        color_zoo[leg] = time_color(dev, batch=b, frames=frames, size=112)
    # phase 11's sites: K1/K2 bf16 at the q batch (K1 also at the fused key
    # batch), K2's zero tail at the 7² non-local pool; K3's clip on both
    # pretrain legs is ResNet-18's, [64, 32, 112, 112, 3], timed above
    for site, sites in P11_POOL_SITES.items():
        check_pool_fwd(dev, 2 * P11_BATCH, sites=sites, dtypes=("bfloat16",))
        pool_zoo[site] = time_pool(dev, P11_BATCH, "bfloat16", sites=sites)
    check_floor_tail(dev, P11_BATCH)
    for leg in P11_PRETRAIN:
        color_zoo[leg] = color_zoo["resnet18"]
    # phase 12's shapes: K3 in aug_plus mode on the packed clips, K1/K2
    # bf16 at the speed-2 branch's 32-frame sites (the q batch; K1 also at
    # the fused key batch), the blur alone on half the batch
    err_color = max(err_color, check_color_aug_plus(
        dev, MAIN_BATCH, (P12_PACKED, 224, 224)))
    color_zoo["s3dg_aug_plus"] = time_color(dev, MAIN_BATCH, P12_PACKED,
                                            224, aug_plus=True)
    check_pool_fwd(dev, 2 * MAIN_BATCH, sites=S2_POOL_SITES,
                   dtypes=("bfloat16",))
    pool_zoo["s3dg_speed2"] = time_pool(dev, MAIN_BATCH, "bfloat16",
                                        sites=S2_POOL_SITES)
    blur = time_blur(dev, MAIN_BATCH // 2, P12_PACKED, 224)
    # phase 13's shapes a rank: K1/K2 bf16 at the q batch (K1 at the fused
    # key batch is the main path's 64), K3 on the rank's clips
    pool_zoo["multirank"] = time_pool(dev, P13_BATCH, "bfloat16")
    color_zoo["multirank"] = time_color(dev, P13_BATCH, 32, 224)
    flags = {}
    for tot in (*pool.values(), pool_key, pool_ft, *pool_zoo.values()):
        for key, n in tot["k1_flags"].items():
            flags[key] = flags.get(key, 0) + n
    print(f"K1 over phase 3's {flags['sites']} timed sites: slower than "
          f"F.max_pool3d at {flags['slower_than_lib']}; a tiled instance "
          f"at {flags['tiled_sites']}, slower than 1.05 times the generic "
          f"instance at {flags['tile_over_1.05_generic']}", flush=True)
    time_stems(dev)                                               # phase 15
    time_temporal(dev)                                            # phase 16

    with tempfile.TemporaryDirectory() as exp:
        trained = main_path(MAIN_BATCH, os.path.join(exp, "train"))  # 4
        torch.cuda.empty_cache()
        validate_path(os.path.join(exp, "validate"),                 # 5
                      trained["checkpoint"])
        torch.cuda.empty_cache()
        finetuned = finetune_path(os.path.join(exp, "finetune"),      # 6
                                  trained["checkpoint"])
        torch.cuda.empty_cache()
        finetune_validate_path(os.path.join(exp, "finetune_validate"),
                               finetuned["checkpoint"])
        torch.cuda.empty_cache()
        paths, zoo_ckpts, retrieved = {}, {}, {}
        for arch in ZOO_POOL_SITES:                                   # 7
            leg = zoo_pretrain_path(arch, os.path.join(exp, arch))
            paths[f"{arch}_pretrain"] = leg["launches"]
            zoo_ckpts[arch] = leg["checkpoint"]
            torch.cuda.empty_cache()
            retrieved[arch] = retrieval_path(                         # 8
                arch, os.path.join(exp, f"retrieval_{arch}"),
                leg["checkpoint"])
            paths[f"retrieval_{arch}"] = retrieved[arch]["launches"]
            torch.cuda.empty_cache()
        visualized = visualization_path(                              # 9
            os.path.join(exp, "visualization"), trained["checkpoint"])
        paths["visualization"] = visualized["launches"]
        torch.cuda.empty_cache()
        legs = {}
        for leg, (config, b, frames, calls) in P10_PRETRAIN.items():  # 10
            gc.collect()    # each leg's peak memory is its own
            legs[leg] = zoo_pretrain_path(
                leg, os.path.join(exp, leg), config=config, batch=b,
                frames=frames, pool_calls=calls)
            paths[f"{leg}_pretrain"] = legs[leg]["launches"]
            torch.cuda.empty_cache()
        for model_type in ("multitask", "1stream"):
            gc.collect()
            ft = finetune_leg(
                "r2plus1d", os.path.join(exp, f"r2plus1d_ft_{model_type}"),
                legs["r2plus1d"]["checkpoint"], model_type)
            paths[f"r2plus1d_finetune_{model_type}"] = ft["launches"]
            torch.cuda.empty_cache()
        for leg, (fields, calls) in P11_PRETRAIN.items():              # 11
            gc.collect()
            legs[leg] = zoo_pretrain_path(
                leg, os.path.join(exp, leg),
                config="config/pretrain/moco-train-base.jsonnet",
                batch=P11_BATCH, pool_calls=calls, fields=fields)
            paths[f"{leg}_pretrain"] = legs[leg]["launches"]
            torch.cuda.empty_cache()
        gc.collect()
        paths["r3d18_finetune"] = finetune_leg(
            "r3d18", os.path.join(exp, "r3d18_ft"), None, "multitask",
            config=R3D18_FT_CONFIG, batch=R3D18_FT_BATCH,
            val_clips=R3D18_FT_VAL, mixins=("add.r18k400",))["launches"]
        torch.cuda.empty_cache()
        gc.collect()                                                  # 12
        leg12 = aug_plus_path(os.path.join(exp, "aug_plus"))
        paths["s3dg_aug_plus_multispeed"] = leg12["launches"]
        torch.cuda.empty_cache()
        paths["s3dg_aug_plus_validate"] = aug_plus_validate_path(
            os.path.join(exp, "aug_plus_validate"),
            leg12["checkpoint"])["launches"]
        torch.cuda.empty_cache()
        gc.collect()                                                  # 14
        cached = cached_pretrain_path(os.path.join(exp, "cached"), trained)
        check_cache_exact(cached.pop("engine"))
        paths["s3dg_cached"] = cached["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        paths["finetune_cached"] = cached_finetune_path(
            os.path.join(exp, "finetune_cached"), trained["checkpoint"],
            finetuned)["launches"]
        torch.cuda.empty_cache()
        paths["retrieval_resnet18_cached"] = cached_retrieval_path(
            os.path.join(exp, "retrieval_cached"), zoo_ckpts["resnet18"],
            retrieved["resnet18"])["launches"]
        torch.cuda.empty_cache()
        paths["visualization_cached"] = cached_visualization_path(
            os.path.join(exp, "visualization_cached"),
            trained["checkpoint"], visualized)["launches"]
        torch.cuda.empty_cache()
        native_decoder_check(exp)
    gc.collect()                                                      # 13
    torch.cuda.empty_cache()
    multirank = multirank_path()
    nccl_world1_path()
    torch.cuda.empty_cache()
    launches, launches_ft = trained["launches"], finetuned["launches"]
    print(f"blur: {json.dumps(blur)}", flush=True)

    def path_keys(name, key):
        """The kernel's launches on phases 7-11's paths and its times at
        their sites (bf16; the visualization's in f32)."""
        out = {f"launches_{path}": counts[name]
               for path, counts in paths.items()}
        for site, tot in pool_zoo.items():
            if f"{key}_bound" in tot:
                out.update({f"ms_{site}": tot[key],
                            f"plain_ms_{site}": tot[f"{key}_plain"],
                            f"bound_ms_{site}": tot[f"{key}_bound"],
                            f"bound_by_{site}": tot["by"][key],
                            f"library_ms_{site}": tot[f"{key}_lib"]})
        return out

    def rank_keys(name):
        """The kernel's launches on each rank of phase 13's bf16 steps."""
        return {f"launches_multirank_rank{r['rank']}": r["launches"][name]
                for r in multirank["ranks"]}

    def pool_row(name, key, replaces, err):
        # the main path's dtype (bf16) first, the f32 times beside it
        bf, f32 = pool["bfloat16"], pool["float32"]
        return {"name": name, "route": "cuda",
                "source": "rspnet_tpu_torch/csrc/max_pool3d.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "dtype": "bfloat16",
                "ms": bf[key], "plain_ms": bf[f"{key}_plain"],
                "bound_ms": bf[f"{key}_bound"], "bound_by": bf["by"][key],
                "library_ms": bf[f"{key}_lib"], "ms_f32": f32[key],
                "plain_ms_f32": f32[f"{key}_plain"],
                "bound_ms_f32": f32[f"{key}_bound"],
                "library_ms_f32": f32[f"{key}_lib"],
                # the finetune path: its launches, its bf16 shapes
                "launches_finetune": launches_ft[name],
                "ms_finetune": pool_ft[key],
                "plain_ms_finetune": pool_ft[f"{key}_plain"],
                "bound_ms_finetune": pool_ft[f"{key}_bound"],
                "bound_by_finetune": pool_ft["by"][key],
                "library_ms_finetune": pool_ft[f"{key}_lib"],
                **path_keys(name, key), **rank_keys(name)}

    kernels = [
        pool_row("max_pool3d_fwd", "fwd", "rspnet_tpu/ops/pallas_pool.py:152",
                 err_fwd),
        pool_row("max_pool3d_bwd", "bwd", "rspnet_tpu/ops/pallas_pool.py:159",
                 err_bwd),
        {"name": "color_augment", "route": "cuda",
         "source": "rspnet_tpu_torch/csrc/color_augment.cu",
         "replaces": "rspnet_tpu/ops/pallas_augment.py:51",
         "launches": launches["color_augment"], "max_abs_err": err_color,
         "dtype": "float32", "ms": color["ms"],
         "plain_ms": color["plain_ms"], "bound_ms": color["bound_ms"],
         "bound_by": color["bound_by"], "library_ms": None,
         "launches_finetune": launches_ft["color_augment"],
         "ms_finetune": color_ft["ms"], "plain_ms_finetune":
         color_ft["plain_ms"], "bound_ms_finetune": color_ft["bound_ms"],
         "bound_by_finetune": color_ft["bound_by"],
         "library_ms_finetune": None, **path_keys("color_augment", None),
         **rank_keys("color_augment"),
         **{f"{k}_{arch}_pretrain": v for arch, c in color_zoo.items()
            for k, v in c.items()},
         **{f"library_ms_{arch}_pretrain": None for arch in color_zoo}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
