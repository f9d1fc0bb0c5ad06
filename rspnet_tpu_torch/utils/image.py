"""Image helpers of the CAM visualization without OpenCV (the card machine
has none): OpenCV's JET colour map, its bilinear resize of a uint8 map and
a PNG writer.

The JAX engine (rspnet_tpu/engines/visualization.py:52-60, :229) calls
``cv2.resize``, ``cv2.applyColorMap(..., COLORMAP_JET)`` and
``cv2.imwrite``. Here:

- ``JET_RGB`` is OpenCV's 256-entry JET table (RGB rows), as
  ``cv2.applyColorMap`` maps the values 0..255;
- ``resize_linear_u8`` is ``cv2.resize(m, (w, h))`` (INTER_LINEAR) of a
  one-channel uint8 map in OpenCV's fixed-point arithmetic: 11-bit
  weights, the horizontal pass into an int row clamped at the edges, the
  vertical pass from row weights that are not clamped (only the row index
  is) with OpenCV's ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)
  + 2) >> 2`` rounding;
- ``write_png`` writes an RGB8 image: one IDAT of zlib-compressed rows,
  each with filter 0.

tests/test_torch_visualization.py holds the table and the resize bit-equal
to OpenCV's, and reads every written PNG back with ``cv2.imread``.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"),
    np.uint8).reshape(256, 3)

_COEF_SCALE = 2048          # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps(dst: int, src: int, clamp: bool):
    """OpenCV's source positions and 11-bit weights of each output position
    along one axis: ``fx = (d + 0.5) * scale - 0.5`` in float32, weights
    ``round(2048 * (1 - fx))`` and ``round(2048 * fx)``. ``clamp``: outside
    the source, the weight goes to the edge position (OpenCV does this for
    columns, not rows)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a uint8 map [H, W], bit for bit."""
    h, w = out_hw
    H, W = img.shape
    x0, x1, a0, a1 = _linear_taps(w, W, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, H, clamp=False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1         # [H, w], scaled 2^11
    out = (((b0[:, None] * (rows[y0] >> 4)) >> 16)
           + ((b1[:, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def apply_jet(img: np.ndarray) -> np.ndarray:
    """uint8 [...] -> RGB uint8 [..., 3] through OpenCV's JET table."""
    return JET_RGB[img]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image [H, W, 3] as an 8-bit PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b""))
