"""Build the CUDA sources of ``ops/csrc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds) and compiles on its own into
``build/adaptpoint_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags. Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises when it
is not ``cudaSuccess``. A missing ``nvcc`` or a failed build raises.

``build_all()`` starts one ``nvcc`` per source at once and waits for all.
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

__all__ = ["SOURCES", "build_all", "load", "check", "check_int32",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adaptpoint_tpu_torch"
SOURCES = ("fps", "ballgroup", "ballgroup_bwd", "ballgroup_max", "gather",
           "saeval", "sa_train_bwd", "attention", "knn", "fpinterp",
           "satrainbn", "window")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check_int32(what: str, **elements: int) -> None:
    """Raise before a launch where a tensor's element count (``name=count``)
    reaches 2**31: the kernels index within a tensor in 32-bit ints."""
    big = {k: int(v) for k, v in elements.items() if int(v) >= 2 ** 31}
    if big:
        raise ValueError(f"{what}: element counts past the kernels' 32-bit "
                         f"indexing: {big}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.apt_error_string.argtypes = [ctypes.c_int]
        lib.apt_error_string.restype = ctypes.c_char_p
        msg = lib.apt_error_string(ctypes.c_int(err)).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err} "
                           f"({msg})")
