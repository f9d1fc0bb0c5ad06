"""Build and load the hand-written CUDA kernels in ``rspnet_tpu_torch/csrc``.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, into
``build/rspnet_tpu_torch/`` under the checkout, with the source's content hash
in the file name so an edited source is rebuilt. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "rspnet_tpu_torch"
SOURCES = {"max_pool3d": "max_pool3d.cu", "color_augment": "color_augment.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# argtypes of every C entry point (all return an int: cudaGetLastError()
# or, for *_nblocks, a count)
PROTOTYPES = {
    "max_pool3d": {
        "rsp_maxpool3d_fwd": [_P, _P, _I, ctypes.POINTER(_I64),
                              ctypes.POINTER(_I), _P],
        "rsp_maxpool3d_bwd": [_P, _P, _P, _P, _P, _P, _P, _I,
                              ctypes.POINTER(_I64), ctypes.POINTER(_I), _P],
    },
    "color_augment": {
        "rsp_color_augment_nblocks": [_I64],
        "rsp_color_augment": [_P, _I, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                              _I64, _I, ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(ctypes.c_float), _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of the last build, per kernel file
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin); the CUDA kernels need it")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every (or the named) kernel source that has no current
    library yet, all nvcc processes at once. Raises on any failure."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in PROTOTYPES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
