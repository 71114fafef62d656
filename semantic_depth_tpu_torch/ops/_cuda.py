"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one shared
library with a plain C interface under ``_build/``, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
The library is bound with ``ctypes``: every pointer and the stream go as
``c_void_p``. No PyTorch headers are compiled, which keeps the build to
seconds. Nothing outside the repository's sources is compiled.

Results depend on IEEE ``sqrtf`` and division, so the flags never include
``--use_fast_math``.

Each kernel is a PyTorch dispatcher op (``torch.library.custom_op``) under
``NAMESPACE``, defined beside its plain version in ``knn_grid.py``,
``mad.py``, ``radius.py`` and ``exact_knn.py``: the CPU implementation is
the plain version, the CUDA implementation checks its arguments (data
pointers included) and launches chunk by chunk through ``launch_chunks``,
and a fake implementation gives the output's shape and dtype.
``launch_chunks`` alone counts the launches, in ``launches`` (the
process's ``runtime.launches``) under ``knn_grid``, ``knn_grid.general``,
``mad``, ``radius``, ``exact_knn`` and ``exact_knn.large_k``. An exported program
(``export.py``) holds the ops as calls, so it launches the same kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..runtime import launches

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

NAMESPACE = "sd_torch"  # the dispatcher ops' namespace: torch.ops.sd_torch.*
SMEM_OPTIN_BYTES = 227 * 1024  # an H100's opt-in shared memory a block, where the card cannot say

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
_SIGNATURES = {
    "sd_knn_grid": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sd_knn_grid_general": [_P, _P, _P, _P] + [_I] * 10 + [_P],
    "sd_mad_keep": [_P, _P, _P, _F, _F, _I, _P, _I, _I, _P],
    "sd_radius_counts": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "sd_exact_knn": [_P, _P, _P, _P] + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsd_kernels_{h.hexdigest()[:16]}.so"


def build(log=None) -> Path:
    """Compile the kernels if the library for these sources is missing.
    ``log`` (a callable) receives the compiler's output, ptxas register and
    shared-memory lines included. Returns the library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if log is not None and out:
                log(f"[nvcc {src.name}]\n{out.rstrip()}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a concurrent build never sees half a file
    if log is not None:
        log(f"[nvcc] built {so.name} in {time.time() - t0:.1f} s")
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes bound."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sd_error_string.argtypes = [ctypes.c_int]
    lib.sd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def smem_limit(device: torch.device) -> int:
    """The bytes of shared memory a block may opt in to on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN_BYTES))


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, for the launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if err != 0:
        msg = library().sd_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """The wrappers' argument check: a contiguous CUDA tensor of ``dtype``
    (and ``shape`` where given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_chunks(n: int, limit: int, *keys: str):
    """``(start, count)`` of each chunk of ``n`` items, at most ``limit`` a
    launch. Each chunk whose body finished without raising counts once in
    ``launches`` under each of ``keys``."""
    for start in range(0, n, limit):
        yield start, min(limit, n - start)
        launches.update(keys)
