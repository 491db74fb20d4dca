"""Build, load and count the hand-written CUDA kernels.

Each ``rtfs_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``rtfs_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``. A library's file name carries a hash of its source, so an edited
source is rebuilt. ``build_all`` starts one ``nvcc`` per source at once.

``LAUNCHES`` counts, per kernel, the launches that the wrappers made;
each wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
SOURCES = ("sru_fused", "convt_tm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points per library: (pointer args, int args); every function
# also takes the stream last and returns cudaGetLastError(). A pointer may
# be None (NULL) where the source says so (the forwards' c outputs).
_SIGNATURES = {
    "sru_fused": {
        "sru_dual_recurrence_fwd": (7, 3),
        "sru_dual_recurrence_bwd": (10, 3),
        "sru_hidden_layer_fwd": (8, 4),
        "sru_hidden_layer_bwd": (12, 4),
    },
    "convt_tm": {
        "convt1d_ola_tm_fwd": (3, 5),
        "convt1d_ola_tm_bwd": (5, 6),
    },
}

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (name, process or None, temporary output path)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return name, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, tmp


def _finish_build(name: str, proc, tmp: str) -> str:
    """Wait for one build, keep its compiler log, move the library in place."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _lib_path(name)
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every kernel library in parallel; returns {name: (seconds,
    compiler log)} for the ones built now (the log holds ptxas's register
    and shared-memory report)."""
    t0 = time.perf_counter()
    started = [_start_build(n) for n in SOURCES]
    report = {}
    for name, proc, tmp in started:
        log = _finish_build(name, proc, tmp)
        report[name] = (time.perf_counter() - t0, log)
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    _finish_build(*_start_build(name))
    lib = ctypes.CDLL(_lib_path(name))
    for fn, (n_ptr, n_int) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return lib


def launch(lib_name: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of library ``lib_name`` on ``device``'s current stream
    and count the launch; raises on a non-zero launch status."""
    kernel = getattr(library(lib_name), fn)
    with torch.cuda.device(device):
        status = kernel(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {status}")
    LAUNCHES[fn] += 1


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
