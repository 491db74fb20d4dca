"""Build, load and count the hand-written CUDA kernels.

Each ``rtfs_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``rtfs_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``. A library's file name carries a hash of its source and of the
``csrc/`` headers it includes (``tf32x3.cuh``, ``sru_scan.cuh``), so an
edit to either is rebuilt. ``build_all`` starts one ``nvcc`` per source
at once.

``LAUNCHES`` counts, per kernel, the launches that the wrappers made;
each wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
SOURCES = ("sru_fused", "convt_tm", "packed_tf", "sru_pallas")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points per library: (pointer args, int args); every function
# also takes the stream last and returns cudaGetLastError(). A pointer may
# be None (NULL) where the source says so (the forwards' c outputs, the
# packed kernels' bias, K3's partials of an unsplit reduction). The
# weight-gradient entries take a scratch buffer for their per-block
# partials, and K3 one for the partials of a split reduction, which the
# wrapper allocates.
_SIGNATURES = {
    "sru_fused": {
        "sru_dual_recurrence_fwd": (7, 5),
        "sru_dual_recurrence_bwd": (10, 5),
        "sru_hidden_layer_fwd": (8, 6),
        "sru_hidden_layer_bwd": (15, 6),
        "sru_dual_recurrence_fwd_bf16": (7, 5),
        "sru_hidden_layer_fwd_bf16": (8, 7),
        "sru_dual_recurrence_bwd_bf16": (10, 5),
        "sru_hidden_layer_bwd_bf16": (15, 7),
    },
    "convt_tm": {
        "convt1d_ola_tm_fwd": (4, 7),
        "convt1d_ola_tm_bwd": (7, 8),
        "convt1d_ola_tm_fwd_bf16": (4, 9),
        "convt1d_ola_tm_bwd_bf16": (7, 6),
    },
    "packed_tf": {
        "dw_conv_packed_fwd": (4, 16),
        "pw_proj_packed_fwd": (4, 7),
        "pw_unproj_packed_fwd": (4, 7),
        "spatial_down_packed_fwd": (6, 8),
        "spatial_up_packed_fwd": (7, 9),
        "dw_conv_packed_wgrad": (4, 15),
        "pw_packed_wgrad": (4, 7),
        "dw_conv_packed_fwd_bf16": (4, 16),
        "pw_proj_packed_fwd_bf16": (4, 6),
        "pw_unproj_packed_fwd_bf16": (4, 6),
        "spatial_down_packed_fwd_bf16": (6, 8),
        "spatial_up_packed_fwd_bf16": (8, 12),
        "dw_conv_packed_wgrad_bf16": (4, 15),
        "pw_packed_wgrad_bf16": (4, 7),
    },
    "sru_pallas": {
        "sru_recurrence_fwd": (5, 6),
        "sru_recurrence_bwd": (8, 6),
        "sru_recurrence_fwd_bf16": (5, 6),
        "sru_recurrence_bwd_bf16": (8, 6),
    },
}

LAUNCHES: collections.Counter = collections.Counter()

# the H100 SXM: streaming multiprocessors, the shared memory one block may
# use and one SM holds (bytes; each block also takes 1 KB of the SM's)
SMS = 132
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472


def split_k(n_cols: int, tiles: int, stage: int) -> tuple:
    """(columns per chunk, chunks) of a split-K product that reduces over
    ``n_cols`` columns into ``tiles`` output tiles: about two blocks an SM,
    each chunk a multiple of ``stage`` columns. Chunk c reduces the columns
    [c * cols, min((c + 1) * cols, n_cols)) into its own partial."""
    want = max(1, 2 * SMS // max(tiles, 1))
    cols = -(-n_cols // want)
    cols = max(stage, -(-cols // stage) * stage)
    return cols, -(-n_cols // cols)


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    quotes, directly or through another header, in the order met."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source and the headers
    it includes, so that an edit to either rebuilds it."""
    digest = hashlib.sha1()
    for path in _sources(name):
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


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


@functools.cache
def _function(lib_name: str, fn: str):
    return getattr(library(lib_name), fn)


def launch(lib_name: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of library ``lib_name`` on ``device``'s current stream
    and count the launch; raises on a non-zero launch status. The ctypes
    function is looked up once; ``device`` is made current only when it is
    not already."""
    kernel = _function(lib_name, fn)
    if device.index is None or device.index == torch.cuda.current_device():
        status = kernel(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            status = kernel(*args,
                            torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {status}")
    LAUNCHES[fn] += 1


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes: tuple = (torch.float32,)) -> torch.dtype:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    all of one dtype among ``dtypes`` (the ones the op's kernels take);
    returns that dtype."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dtype or t.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: {names} only, got "
                            f"{sorted({str(u.dtype) for u in tensors})}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dtype


def entry(fn: str, dtype: torch.dtype) -> str:
    """The C entry ``fn`` for storage ``dtype``: its ``_bf16`` form for
    bf16."""
    return fn + "_bf16" if dtype == torch.bfloat16 else fn


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it where its data does not start on a
    16-byte boundary (the bf16 kernels' 16-byte copies need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
