"""ctypes binding for the C++ FFmpeg decoder (port of
rspnet_tpu/native/video_decode.py).

The library is built from ``video_decode.cpp`` with ``g++`` at first use
into ``build/rspnet_tpu_torch/native/`` under the checkout, with the
source's content hash in the file name so an edited source is rebuilt
(the JAX package builds into its package directory with ``make``). When
the build or the load fails (no compiler, no FFmpeg development files),
the error is logged, kept in ``build_error``, and ``is_available()`` is
False: ``data/video_reader.py:open_video`` then decodes with OpenCV. This
is a host decoder, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().with_name("video_decode.cpp")
BUILD_DIR = SOURCE.parents[2] / "build" / "rspnet_tpu_torch" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_lib = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None   # why the decoder is unavailable


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"librspnet_video_{digest}.so"


def _build(so: Path) -> None:
    """Compile to a temporary name and rename, so a concurrent loader
    never sees a partial library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o",
           str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(proc.stderr.strip() or
                           f"{cmd[0]} exited with {proc.returncode}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vr_open.restype = ctypes.c_void_p
    lib.vr_open.argtypes = [ctypes.c_char_p]
    lib.vr_error.restype = ctypes.c_char_p
    lib.vr_error.argtypes = [ctypes.c_void_p]
    lib.vr_num_frames.restype = ctypes.c_long
    lib.vr_num_frames.argtypes = [ctypes.c_void_p]
    lib.vr_fps.restype = ctypes.c_double
    lib.vr_fps.argtypes = [ctypes.c_void_p]
    lib.vr_width.restype = ctypes.c_int
    lib.vr_width.argtypes = [ctypes.c_void_p]
    lib.vr_height.restype = ctypes.c_int
    lib.vr_height.argtypes = [ctypes.c_void_p]
    lib.vr_get_batch.restype = ctypes.c_int
    lib.vr_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte)]
    lib.vr_get_batch_scaled.restype = ctypes.c_int
    lib.vr_get_batch_scaled.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
    lib.vr_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None (once, with the error
    logged) where it cannot be built or loaded."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        try:
            if not so.exists():
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        except (RuntimeError, OSError) as e:
            build_error = str(e)
            logger.warning("native decoder unavailable, decoding with "
                           "OpenCV: %s", build_error)
        return _lib


def is_available() -> bool:
    return _load() is not None


class RspVideoReader:
    """decord-contract reader backed by the C++ extension."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {build_error}")
        self._lib = lib
        self._h = lib.vr_open(path.encode())
        if not self._h:
            raise IOError(f"vr_open returned null for {path}")
        err = lib.vr_error(self._h)
        if err:
            msg = err.decode()
            lib.vr_close(self._h)
            self._h = None
            raise IOError(f"Cannot open video {path}: {msg}")
        self.path = path
        self.num_frames = int(lib.vr_num_frames(self._h))
        self.fps = float(lib.vr_fps(self._h))
        self.width = int(lib.vr_width(self._h))
        self.height = int(lib.vr_height(self._h))

    def get_batch(self, indices: Sequence[int],
                  out_wh: Optional[tuple] = None) -> np.ndarray:
        """Decode frames; with ``out_wh=(w, h)`` the sws_scale pass that
        converts YUV to RGB also resizes (bilinear), so no host resize
        follows."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        if out_wh is None:
            out = np.empty((n, self.height, self.width, 3), np.uint8)
            ret = self._lib.vr_get_batch(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        else:
            w, h = int(out_wh[0]), int(out_wh[1])
            out = np.empty((n, h, w, 3), np.uint8)
            ret = self._lib.vr_get_batch_scaled(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h)
        if ret != 0:
            err = self._lib.vr_error(self._h)
            raise IOError(f"decode failed for {self.path}: "
                          f"{err.decode() if err else 'unknown'}")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
