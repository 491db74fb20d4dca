#!/usr/bin/env python3
"""Split a launch of the first bf16 K1-K4 and pw-wgrad kernels into phases.

The kernels are ``sru_hid_fwd_bf16_kernel<false>`` (K2) and
``convt1d_tm_fwd_bf16_kernel<8>`` (K3) as a tree had them before their
redesign (``--tree``, e.g. a ``git archive`` of that commit). A copy of
the tree's ``csrc/`` gets ``%globaltimer`` stamps written into the two
kernels' loops: thread 0 of each block adds the nanoseconds between
stamps to one sum a phase, and adds its sums to device counters when
the block ends. The copy is built into a directory of its own and runs
through the tree's own wrappers at the six RTFS-Net-4 forward sites (H
32; freq L 57 over B 125 bs, time L 118 over B 64 bs; bs 1, 4, 8; K3 2H
64 -> 64 channels, 8 taps). Per site it prints the mean over blocks of
each phase (us a block) beside the kernel's device time a launch with
the stamps in (the profiler).

K2's phases, a chunk at a time: ``issue`` (the next chunk's copies),
``product`` (U of the chunk), ``wait`` (``cp.async.wait_all`` and the
barrier) and ``scan``; before the loop ``prologue`` (W_d and the first
chunk copied and waited for). ``--scan-only`` builds a second copy whose
chunk loop only scans (no copy, no product: U and X as the shared memory
holds them), the recurrence's floor with U given, and prints its device
time a launch.

K3's phases: ``prologue`` (W_flat and the first window copied and waited
for), then a pass at a time ``issue`` (the next pass's rows), ``passes``
(the products), ``stores`` and ``wait``.

``--probe NAME ..`` also times the redesigned K2 with one part of a
chunk's work taken out (``_K2_PROBES``: the h stores but the last step's,
the MUFU ops of the gates, the copies after the prologue, the product,
the scan),
device us a launch at the six sites: what each part costs on the chain.

``--redesigned`` stamps the redesigned kernels instead
(the tree's own): K2's producer thread 0 (its EMPTY wait, its copies'
wait and barrier, the issue, the realign, the product, and the
prologue's issue) and scan thread 0 (its FULL wait and the scan), K3's
thread 0 (a segment's issue, a pass's wait and barrier, realign, issue,
product and stores).

``--k1`` splits K1's bf16 kernels instead, at the six sites (forward
serving, backward on the tree's own training forward's c): the first
ones (``sru_lay0_fwd_bf16_kernel``, the scan ``sru_scan_bwd_kernel<11>``;
a tree before their redesign) by thread 0's stamps, per step: wait,
read, issue, gates (and chain), chain or stores; with ``--redesigned`` the
redesigned ones (``sru_lay0_fwd16_kernel``, ``sru_lay0_bwd16_kernel``),
per group: wait and meeting, issue, reads, gates, chain and stores. Each
run also times the kernels as built, and ``--probe`` launches with one
part taken out (``_K1_PROBES``: the copies after the prologue, the
stores, ``sigmoid_f`` folded to ex2 / rcp, the scan's word reads) or
with a loop that holds the carry's chain alone on registers
(``fwd-chain``, ``fwd-chain-fold``, ``scan-chain``): the floor of a
step. Per site it prints the device us a launch and ns a step (us / T);
every variant's library is built at once, then timed alone.

``--k4`` splits K4's first bf16 forward (``sru_rec_fwd_kernel<bf16>``,
a tree before its redesign) at the six uni sites (freq L 57 over B 125
bs, time L 118 over B 64 bs; bs 1, 4, 8; serving and with c): thread
0's stamps a step (wait, read, gates and chain, stores, issue) and
``--probe`` launches (``_K4_PROBES``: the copies after the prologue, the
stores, ``sigmoid_f`` folded, the chain alone on registers). ``--pw16``
splits pw-wgrad's first bf16 kernel (``pw_wgrad_bf16_kernel``) at K6's
and K7's dW, bs 1, 4 and 8: as built with L2 warm and cold (a 256 MB
fill before each call), thread 0's stamps a stage (wait and barrier,
issue, product, flush; the epilogue), ``--probe`` launches
(``_PW16_PROBES``: the fragments from registers, the planar rows' end
blocks not copied, no per-stage flush) and the library yardsticks
(``library_rows``: one bf16 ``einsum``, and ``baddbmm`` for K7 bf16, by
``chip_smoke._library_device_us`` in turns with the kernels). Either
mode's as-built run also prints the device time and an output hash of
the kernels it leaves as they are (K4's float32 forward and the scan
``<14>`` on given c; the float32 pw-wgrad), the same inputs in either
tree. ``--base-only`` times the kernels as built and nothing else:
with ``--tree`` a parent and this tree in turns, the A/B of a redesign
(the as-built run times whichever kernel the tree's wrapper launches).

The stamps cost a few instructions of thread 0 between phases; the
device time beside them is the stamped kernel's. Usage::

    python3 tools/phase_split.py --tree _scratch/parent [--scan-only]
    python3 tools/phase_split.py --tree . --redesigned
    python3 tools/phase_split.py --k1 --tree _scratch/parent \
        [--probe fwd-chain-fold scan-chain ...]
    python3 tools/phase_split.py --k1 --tree . --redesigned
    python3 tools/phase_split.py --k4 --tree _scratch/parent \
        [--probe k4-nocopy k4-nostore k4-fold k4-chain k4-chain-fold]
    python3 tools/phase_split.py --pw16 --tree _scratch/parent \
        [--probe pw16-nofrag pw16-noends pw16-noflush]
    python3 tools/phase_split.py --k4 | --pw16 --base-only --tree <tree>
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, C_OUT, TAPS = 32, 64, 8
SITES = {"freq": (57, 125), "time": (118, 64)}

_STAMP_HEAD = r"""
__device__ unsigned long long g_split_sum[16];
__device__ unsigned long long g_split_blocks[2];
__device__ __forceinline__ unsigned long long split_stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""

_STAMP_MACRO = r"""
#define SPL(i) { const unsigned long long s1_ = split_stamp(); \
  ph[i] += s1_ - s0; s0 = s1_; }
"""

_STAMP_TAIL = r"""
extern "C" int phase_split_read(void* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_split_sum, sizeof(g_split_sum));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol((char*)dst + sizeof(g_split_sum),
                                   g_split_blocks, sizeof(g_split_blocks));
}
extern "C" int phase_split_clear() {
  static const unsigned long long z[18] = {0};
  cudaError_t e = cudaMemcpyToSymbol(g_split_sum, z, sizeof(g_split_sum));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_split_blocks, z + 16,
                                 sizeof(g_split_blocks));
}
"""

# (kernel's defining text, [(anchor after it, replacement)]): K2's
# counters 0-4, K3's 8-12
_K2_LOOP = """    for (int n = 0; n < n_chunks; ++n) {
      if (n + 1 < n_chunks) load_x(x_s + ((n + 1) & 1) * k16 * xs, n + 1, 0,
                                   k16);
      hk::cp_async_commit();
      project(n);
      hk::cp_async_wait_all();
      __syncthreads();
      if (live) scan(n);
    }
"""
_K2_PRO = """    load_x(x_s, 0, 0, k16);  // with W_d
"""
_K2_STAMPED = """    unsigned long long ph[5] = {0, 0, 0, 0, 0};
    unsigned long long s0 = split_stamp(), s1;
    ph[0] = s0 - k_start;
    for (int n = 0; n < n_chunks; ++n) {
      if (n + 1 < n_chunks) load_x(x_s + ((n + 1) & 1) * k16 * xs, n + 1, 0,
                                   k16);
      hk::cp_async_commit();
      s1 = split_stamp(); ph[1] += s1 - s0; s0 = s1;
      project(n);
      s1 = split_stamp(); ph[2] += s1 - s0; s0 = s1;
      hk::cp_async_wait_all();
      __syncthreads();
      s1 = split_stamp(); ph[3] += s1 - s0; s0 = s1;
      if (live) scan(n);
      s1 = split_stamp(); ph[4] += s1 - s0; s0 = s1;
    }
    if (tid == 0) {
      for (int i = 0; i < 5; ++i) atomicAdd(&g_split_sum[i], ph[i]);
      atomicAdd(&g_split_blocks[0], 1ull);
    }
"""
_K2_SCAN_ONLY = """    for (int n = 0; n < n_chunks; ++n) {
      __syncthreads();
      if (live) scan(n);
    }
"""
_K3_PRO = """  for (int r = t0 - K + 1; r < t0 + kFwdPass; ++r) load_row(r);
  hk::cp_async_commit();
  hk::cp_async_wait_all();
  __syncthreads();
"""
_K3_COPIES = """    if (t + kFwdPass < t1)
      for (int r = t + kFwdPass; r < t + 2 * kFwdPass; ++r) load_row(r);
    hk::cp_async_commit();
"""
_K3_STORES = """      const int c = b0 + n0 + 2 * q;
"""
_K3_END = """    hk::cp_async_wait_all();
    __syncthreads();
  }
}
"""


def _patch(src: str, start: str, edits) -> str:
    """Each (anchor, replacement) of ``edits`` applied once, at the first
    occurrence of the anchor after ``start``'s."""
    at = src.index(start)
    for anchor, repl in edits:
        i = src.index(anchor, at)
        src = src[:i] + repl + src[i + len(anchor):]
        at = i + len(repl)
    return src


def patched_csrc(tree: str, out: str, scan_only: bool) -> str:
    """A copy of ``tree``'s csrc/ with the stamps (or, ``scan_only``, K2's
    scan alone) in; returns its path."""
    csrc = os.path.join(out, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "rtfs_tpu_torch", "csrc"), csrc)
    start = "extern __shared__ float4 smem4[];\n"
    stamp0 = start + "  const unsigned long long k_start = split_stamp();\n"
    path = os.path.join(csrc, "sru_fused.cu")
    with open(path) as f:
        src = f.read()
    head = "namespace {\n"
    src = src.replace(head, _STAMP_HEAD + head, 1)
    k2 = "sru_hid_fwd_bf16_kernel(const __nv_bfloat16*"
    if scan_only:
        src = _patch(src, k2, [(_K2_PRO, _K2_PRO), (_K2_LOOP, _K2_SCAN_ONLY)])
    else:
        src = _patch(src, k2, [(start, stamp0), (_K2_LOOP, _K2_STAMPED)])
    with open(path, "w") as f:
        f.write(src + _STAMP_TAIL)
    path = os.path.join(csrc, "convt_tm.cu")
    with open(path) as f:
        src = f.read()
    src = src.replace(head, _STAMP_HEAD + head, 1)
    k3 = "convt1d_tm_fwd_bf16_kernel(const __nv_bfloat16*"
    src = _patch(src, k3, [
        (start, stamp0 + "  unsigned long long ph[5] = {0, 0, 0, 0, 0}, "
                         "s0, s1;\n"),
        (_K3_PRO, _K3_PRO + "  s0 = split_stamp(); ph[0] = s0 - k_start;\n"),
        (_K3_COPIES, _K3_COPIES
         + "    s1 = split_stamp(); ph[1] += s1 - s0; s0 = s1;\n"),
        (_K3_STORES, "      s1 = split_stamp(); ph[2] += s1 - s0; s0 = s1;\n"
         + _K3_STORES),
        (_K3_END, "    s1 = split_stamp(); ph[3] += s1 - s0; s0 = s1;\n"
         "    hk::cp_async_wait_all();\n    __syncthreads();\n"
         "    s1 = split_stamp(); ph[4] += s1 - s0; s0 = s1;\n  }\n"
         "  if (tid == 0) {\n"
         "    for (int i = 0; i < 5; ++i) atomicAdd(&g_split_sum[8 + i], "
         "ph[i]);\n    atomicAdd(&g_split_blocks[1], 1ull);\n  }\n}\n")])
    with open(path, "w") as f:
        f.write(src + _STAMP_TAIL)
    return csrc


# the redesigned kernels: (anchor, text before it, text after it),
# each anchor the first after the previous one; SPL(i) adds the time since
# the last stamp to phase i
_K2_NEW = [
    ("extern __shared__ float4 smem4[];\n", "",
     "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n"),
    ("    for (int n = 0; n < kFwd16Ahead; ++n) issue(n);  // W_d with chunk "
     "0\n", "", "    SPL(5)\n"),
    ("      if (n >= 2) hk::bar_sync(kBarEmpty + (n & 1), n_all);\n", "",
     "      SPL(0)\n"),
    ("      hk::bar_sync(kBarProd, n_prod);  // everyone's; chunk n - 1 "
     "projected\n", "", "      SPL(1)\n"),
    ("      issue(n + kFwd16Ahead);\n", "", "      SPL(2)\n"),
    ("      project(n);\n", "      SPL(3)\n", "      SPL(4)\n"),
    ("    hk::cp_async_wait_all();\n  } else {",
     "    if (tid == 0) {\n      for (int i = 0; i < 6; ++i) "
     "atomicAdd(&g_split_sum[i], ph[i]);\n      atomicAdd(&g_split_blocks[0], "
     "1ull);\n    }\n", ""),
    ("      hk::bar_sync(kBarFull + (n & 1), n_all);\n", "",
     "      SPL(6)\n"),
    ("      if (n + 2 < n_chunks) hk::bar_arrive(kBarEmpty + (n & 1), n_all);"
     "\n    }\n", "      SPL(7)\n",
     "    if (tid == n_prod) {\n      atomicAdd(&g_split_sum[6], ph[6]);\n"
     "      atomicAdd(&g_split_sum[7], ph[7]);\n    }\n"),
]
_K3_NEW = [
    ("extern __shared__ float4 smem4[];\n", "",
     "  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n"),
    ("      if (p0 + d < p1) load_rows((p0 + d) * P, (p0 + d + 1) * P, b0);\n"
     "      hk::cp_async_commit();\n    }\n", "", "    SPL(0)\n"),
    ("      __syncthreads();  // everyone's; pass - 1 is done with its rows\n",
     "", "      SPL(1)\n"),
    ("      const int ahead = pass + kFwd16Stages - 1;\n", "      SPL(2)\n",
     ""),
    ("      if (!computes || m0 >= co_n) continue;  // uniform over the warp"
     "\n", "      SPL(3)\n", ""),
    ("      // D (row o, column): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3"
     "\n      if (split) {", "      SPL(4)\n", ""),
    ("        __syncwarp();\n      }\n", "", "      SPL(5)\n"),
    ("  hk::cp_async_wait_all();\n}\n",
     "  if (tid == 0) {\n    for (int i = 0; i < 6; ++i) "
     "atomicAdd(&g_split_sum[8 + i], ph[i]);\n    atomicAdd(&g_split_blocks[1],"
     " 1ull);\n  }\n", ""),
]
# what the redesigned kernels' stamps measure, per counter
_NEW_NAMES = {
    "K2": ("producer EMPTY wait", "producer copy wait + barrier",
           "producer issue", "producer realign", "producer product",
           "prologue issue", "scan FULL wait", "scan"),
    "K3": ("segment issue", "pass wait + barrier", "realign", "issue",
           "product", "stores"),
}


def _insert(src: str, start: str, edits) -> str:
    """Each (anchor, before, after) of ``edits`` at the first occurrence of
    its anchor after the previous one's, from ``start``'s on."""
    at = src.index(start)
    for anchor, before, after in edits:
        i = src.index(anchor, at)
        src = src[:i] + before + anchor + after + src[i + len(anchor):]
        at = i + len(before) + len(anchor) + len(after)
    return src


# probes of the redesigned K2 (``--probe``): each takes one part of a
# chunk's work out, (anchor, replacement) in sru_hid_fwd_bf16_kernel
_K2_PROBES = {
    # h stored at the last step only (the chain kept)
    "nostore": [("            h[t * row + col0] = __float2bfloat16_rn(",
                 "            if (i == T - 1) h[t * row + col0] = "
                 "__float2bfloat16_rn(")],
    # the gates linear instead of sigmoids (no MUFU op on the chain)
    "nomufu": [("hk::rcp_approx(", "0.25f * ("), ("hk::ex2_approx(", "("),
               ("hk::rcp_approx(", "0.25f * ("), ("hk::ex2_approx(", "(")],
    # no copies after the prologue's (X as the ring holds it)
    "nocopy": [("      issue(n + kFwd16Ahead);\n",
                "      hk::cp_async_commit();\n")],
    # no product (U as its slots hold it)
    "noproduct": [("      project(n);\n", "")],
    # no scan (the slots still handed over)
    "noscan": [("      if (live) {\n        const float* u = u_s",
                "      if (false) {\n        const float* u = u_s")],
}


def probe_csrc(tree: str, out: str, probe: str) -> str:
    """A copy of ``tree``'s csrc/ with one ``_K2_PROBES`` edit in the
    redesigned K2 forward; returns its path."""
    csrc = os.path.join(out, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "rtfs_tpu_torch", "csrc"), csrc)
    path = os.path.join(csrc, "sru_fused.cu")
    with open(path) as f:
        src = f.read()
    src = _patch(src, "sru_hid_fwd_bf16_kernel(const __nv_bfloat16*",
                 _K2_PROBES[probe])
    with open(path, "w") as f:
        f.write(src)
    return csrc


def redesigned_csrc(tree: str, out: str) -> str:
    """A copy of ``tree``'s csrc/ with stamps in the redesigned bf16 K2 and
    K3 forwards (``_K2_NEW``, ``_K3_NEW``); returns its path."""
    csrc = os.path.join(out, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "rtfs_tpu_torch", "csrc"), csrc)
    for name, start, edits in (
            ("sru_fused.cu", "sru_hid_fwd_bf16_kernel(const __nv_bfloat16*",
             _K2_NEW),
            ("convt_tm.cu", "convt1d_tm_fwd_bf16_kernel(const __nv_bfloat16*",
             _K3_NEW)):
        path = os.path.join(csrc, name)
        with open(path) as f:
            src = f.read()
        src = src.replace("namespace {\n",
                          _STAMP_HEAD + _STAMP_MACRO + "namespace {\n", 1)
        with open(path, "w") as f:
            f.write(_insert(src, start, edits) + _STAMP_TAIL)
    return csrc


# ------------------------------------------------------------------ K1
# K1's bf16 forward (``sru_lay0_fwd_bf16_kernel``) and the bf16 adjoint
# scan (``sru_scan_bwd_kernel<11>``) as a tree had them before their
# redesign: counters 0-4 the forward's, 8-12 the scan's. SPLV(i, v) stamps
# only once v is computed (the timer read predicated on it), so a phase
# that ends in arithmetic holds that arithmetic's latency.
_STAMP_AFTER = r"""
__device__ __forceinline__ unsigned long long split_stamp_after(float v) {
  unsigned long long t;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.eq.f32 p, %1, %1;\n\t"
               "@p mov.u64 %0, %%globaltimer;\n\t"
               "@!p mov.u64 %0, %%globaltimer;\n}"
               : "=l"(t) : "f"(v) : "memory");
  return t;
}
#define SPLV(i, v) { const unsigned long long s1_ = split_stamp_after(v); \
  ph[i] += s1_ - s0; s0 = s1_; }
"""
_K1F_START = "sru_lay0_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ u_f,"
_K1F_LOOP = """  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    hk::cp_async_wait<kLay0Ahead - 1>();  // step i's group is in
    __syncwarp();                          // and the other lanes'
"""
_K1F_READ_END = """    __syncwarp();           // every lane has read the slot
"""
_K1F_ISSUE = """    issue(i + kLay0Ahead);  // into the slot just read
"""
_K1F_GATES = """    const float r = sigmoid_f(a[2] + v_r * c + b_r);
"""
_K1F_END = """      if (cs) cs[(long long)t * row + col + lane] = __float2bfloat16_rn(c);
    }
"""
_K1F_STAMPS = [
    (_K1F_LOOP, "  unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", "    SPL(0)\n"),
    (_K1F_READ_END, "", "    SPL(1)\n"),
    (_K1F_ISSUE, "", "    SPL(2)\n"),
    (_K1F_GATES, "", "    SPLV(3, r * c)\n"),
    (_K1F_END, "", "    SPL(4)\n"),
    ("}\n\n__host__ __device__ __forceinline__ int round_up(",
     "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 5; ++k) "
     "atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd(&g_split_blocks[0], "
     "1ull);\n  }\n", ""),
]
_K1B_START = "sru_scan_bwd_kernel(ScanIOT<typename ScanTypes<Kernel>::TU,"
_K1B_LOOP = """    for (int i0 = 0; i0 < T; i0 += kScanGroup) {
      // the groups of steps i0 .. i0 + kScanGroup - 1 are in; the compiler
      // barriers keep the slots' reads between the wait and the refill
      hk::cp_async_wait<kScanAhead - kScanGroup>();
      asm volatile("" ::: "memory");
"""
_K1B_READ_END = """      asm volatile("" ::: "memory");
#pragma unroll
      for (int s = 0; s < kScanGroup; ++s) issue();  // i0 + kScanAhead + s
"""
_K1B_GATES = """      // the chain in dc
"""
_K1B_CHAIN = """      c_t = cp[kScanGroup - 1];
"""
_K1B_END = """    hk::cp_async_wait_all();  // the zero-fill copies past the end
"""
_K1B_STAMPS = [
    (_K1B_LOOP, "    unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "    unsigned long long s0 = split_stamp();\n", "      SPLV(0, 0.f)\n"),
    (_K1B_READ_END, "      SPLV(1, u0[0] + u1[0] + u2[0] + hw[0] + g[0] + "
     "cp[0] + u0[1] + u1[1] + u2[1] + hw[1] + g[1] + cp[1])\n",
     "      SPL(2)\n"),
    (_K1B_GATES, "      SPLV(3, f[0] + r[0] + dm[0] + f[1] + r[1] + dm[1])\n",
     ""),
    (_K1B_CHAIN, "      SPLV(4, dc)\n", ""),
    (_K1B_END, "", "    if (Kernel == 11 && tid == 0) {\n      for (int k "
     "= 0; k < 5; ++k) atomicAdd(&g_split_sum[8 + k], ph[k]);\n      "
     "atomicAdd(&g_split_blocks[1], 1ull);\n    }\n"),
]
_K1_NAMES = {"fwd": ("wait", "read", "issue", "gates and chain", "stores"),
             "scan": ("wait", "read", "issue", "gates", "chain and stores")}
_NEG_LOG2E = "-1.4426950408889634f"


def _fold(v: str, c: str, u: str, bias: str) -> str:
    """The folded sigmoid(u + v c + b) of K2's bf16 forward: ex2
    and rcp, -log2(e) (u + b) off the chain."""
    return (f"hk::rcp_approx(1.f + hk::ex2_approx(fmaf({_NEG_LOG2E} * {v}, "
            f"{c}, {_NEG_LOG2E} * ({u} + {bias}))))")


# probes of the first K1 bf16 kernels (``--k1 --probe``): (kernel, edits)
# with each edit (anchor, replacement) in that kernel
_K1_PROBES = {
    # the forward's copies after the prologue taken out
    "fwd-nocopy": ("fwd", [(_K1F_ISSUE, "    hk::cp_async_commit();\n")]),
    # h and c stored at the last step only (the chain kept)
    "fwd-nostore": ("fwd", [("    if (b < B) {\n      h[(long long)t",
                             "    if (b < B && i == T - 1) {\n      h["
                             "(long long)t")]),
    # sigmoid_f replaced by the folded ex2 / rcp sigmoid
    "fwd-fold": ("fwd", [(
        """    const float f = sigmoid_f(a[1] + v_f * c + b_f);
    c = f * c + (1.f - f) * a[0];
    const float r = sigmoid_f(a[2] + v_r * c + b_r);
""", f"""    const float f = {_fold("v_f", "c", "a[1]", "b_f")};
    c = fmaf(f, c - a[0], a[0]);
    const float r = {_fold("v_r", "c", "a[2]", "b_r")};
""")]),
    # the loop holds the carry's chain alone on values in registers (no
    # copy, read or store but the last), with sigmoid_f or folded
    "fwd-chain": ("fwd", [(_K1F_LOOP, """  float c = 0.f;
  const float q0 = 0.01f * lane, q1 = 0.3f - q0;
  for (int i = 0; i < T; ++i) {
    const float f = sigmoid_f(q1 + v_f * c + b_f);
    c = f * c + (1.f - f) * q0;
  }
  if (b < B) h[col + lane] = __float2bfloat16_rn(c);
  hk::cp_async_wait_all();
  return;
  for (int i = 0; i < T; ++i) {
    hk::cp_async_wait<kLay0Ahead - 1>();
    __syncwarp();
""")]),
    "fwd-chain-fold": ("fwd", [(_K1F_LOOP, f"""  float c = 0.f;
  const float q0 = 0.01f * lane, q1 = 0.3f - q0;
  for (int i = 0; i < T; ++i) {{
    const float f = {_fold("v_f", "c", "q1", "b_f")};
    c = fmaf(f, c - q0, q0);
  }}
  if (b < B) h[col + lane] = __float2bfloat16_rn(c);
  hk::cp_async_wait_all();
  return;
  for (int i = 0; i < T; ++i) {{
    hk::cp_async_wait<kLay0Ahead - 1>();
    __syncwarp();
""")]),
    # the scan's copies after the prologue taken out
    "scan-nocopy": ("scan", [(
        "      for (int s = 0; s < kScanGroup; ++s) issue();  // i0 + "
        "kScanAhead + s\n",
        "      for (int s = 0; s < kScanGroup; ++s) "
        "hk::cp_async_commit();\n")]),
    # du and dhw stored at the last step only
    "scan-nostore": ("scan", [("        TU* dut = io.du + od;\n",
                               "        TU* dut = io.du + od;\n"
                               "        if (i0 + s == T - 1) {\n"),
                              ("        store_value(io.dhw + ow, g[s] * (1.f "
                               "- r[s]));\n",
                               "        store_value(io.dhw + ow, g[s] * (1.f "
                               "- r[s]));\n        }\n")]),
    # the gates' sigmoid_f replaced by the folded one
    "scan-fold": ("scan", [(
        """        f[s] = sigmoid_f(u1[s] + v_f * cp[s] + b_f);
        r[s] = sigmoid_f(u2[s] + v_r * ct[s] + b_r);
""", f"""        f[s] = {_fold("v_f", "cp[s]", "u1[s]", "b_f")};
        r[s] = {_fold("v_r", "ct[s]", "u2[s]", "b_r")};
""")]),
    # the word reads (and their halves) replaced by values in registers
    # (the copies kept)
    "scan-noword": ("scan", [(
        """        u0[s] = slot_value<TU>(d, upper_half(io.u, ou0, su, i));
        u1[s] = slot_value<TU>(d + nt, upper_half(io.u, ou0 + hb, su, i));
        u2[s] = slot_value<TU>(d + 2 * nt,
                               upper_half(io.u, ou0 + 2 * hb, su, i));
        hw[s] = slot_value<TS>(d + 3 * nt, upper_half(io.xhw, ox0, sx, i));
        g[s] = slot_value<TS>(d + 4 * nt, upper_half(io.dh, og0, dt, i));
        cp[s] = slot_value<TS>(d + 5 * nt, upper_half(io.c, og0 + dt, dt, i));
""", """        (void)d;
        const float z = 1e-3f * (float)i;
        u0[s] = z; u1[s] = z + v_f; u2[s] = z + v_r; hw[s] = z + b_f;
        g[s] = z + b_r; cp[s] = 0.5f - z;
""")]),
    # the loop holds dc's chain alone on values in registers
    # the redesigned kernels (``--k1 --redesigned --probe``): copies after
    # the prologue out, or the stores but the last step's
    "fwd16-nocopy": ("fwd16", [(
        "    issue(n + kL16FwdAhead);  // into group n - 1's slot\n",
        "    hk::cp_async_commit();\n")]),
    "fwd16-nostore": ("fwd16", [
        ("      if (live) *hp = hv;\n",
         "      if (live && n * kL16Group + s == T - 1) *hp = hv;\n"),
        ("        if (live) *cp = cv;\n",
         "        if (live && n * kL16Group + s == T - 1) *cp = cv;\n")]),
    "bwd16-nocopy": ("bwd16", [(
        "      issue(n + kL16BwdAhead);  // into group n - 1's slot\n",
        "      hk::cp_async_commit();\n")]),
    "bwd16-nostore": ("bwd16", [(
        "          if (live) {\n            dup[0] = d0;",
        "          if (live && n * kL16Group + sg + q == T - 1) {\n"
        "            dup[0] = d0;")]),
    "scan-chain": ("scan", [("    float dc = 0.f;\n",
                             "    float dc = 0.f;\n    int i0_end_ = 0;\n"),
                            (_K1B_LOOP, """    {
      const float gr = v_f + b_r, dv = b_f * v_r, kk = 0.2f * v_f;
      const float fv = 0.7f;
      for (int i = 0; i < T; ++i) {
        dc = gr + dv + dc;
        const float da = dc * kk;
        dc = dc * fv + da * v_f;
      }
      store_value(io.du + od, dc);
      i0_end_ = T;
    }
    for (int i0 = i0_end_; i0 < T; i0 += kScanGroup) {
      hk::cp_async_wait<kScanAhead - kScanGroup>();
      asm volatile("" ::: "memory");
""")]),
}


# the redesigned K1 bf16 kernels' stamps (``--k1 --redesigned``): the
# forward's counters 0-3, the backward's 8-12, a group at a time
_K1F_NEW_START = "sru_lay0_fwd16_kernel(const __nv_bfloat16* __restrict__ u_f,"
_K1F_NEW = [  # in the order of the source
    ("  float c = 0.f;\n  // group n's steps from its slot; kFull: all "
     "kL16Group of them\n", "  unsigned long long ph[4] = {0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", ""),
    ("#pragma unroll\n    for (int s = 0; s < kL16Group; ++s) {\n"
     "      if (!kFull && s >= steps) break;\n",
     "    SPLV(2, a0[0] + x1[0] + x2[0] + a3[0])\n", ""),
    ("  };\n  const int groups = (T + kL16Group - 1) / kL16Group;\n",
     "    SPLV(3, c)\n", ""),
    ("    __syncwarp();  // the warp's; and every lane is past group n - 1's "
     "reads\n", "", "    SPL(0)\n"),
    ("    issue(n + kL16FwdAhead);  // into group n - 1's slot\n", "",
     "    SPL(1)\n"),
    ("  hk::cp_async_wait_all();\n}\n",
     "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 4; ++k) "
     "atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd(&g_split_blocks[0], "
     "1ull);\n  }\n", ""),
]
_K1B_NEW_START = "sru_lay0_bwd16_kernel(const __nv_bfloat16* __restrict__ u_f,"
_K1B_NEW = [  # in the order of the source
    ("    float dc = 0.f;\n    // group n's steps", "    unsigned long long "
     "ph[5] = {0, 0, 0, 0, 0};\n    unsigned long long s0 = split_stamp();\n",
     ""),
    ("        // the gates, off the chain\n",
     "        SPLV(2, u0[0] + g[0] + cp[0])\n", ""),
    ("        // the chain in dc\n", "        SPLV(3, f[0] + r[0] + dm[0])\n",
     ""),
    ("        c_t = cp[kSub - 1];\n", "", "        SPLV(4, dc)\n"),
    ("      __syncwarp();  // the warp's; every lane is past group n - 1's "
     "reads\n", "", "      SPL(0)\n"),
    ("      issue(n + kL16BwdAhead);  // into group n - 1's slot\n", "",
     "      SPL(1)\n"),
    ("    hk::cp_async_wait_all();\n  }\n",
     "    if (tid == 0) {\n      for (int k = 0; k < 5; ++k) "
     "atomicAdd(&g_split_sum[8 + k], ph[k]);\n      atomicAdd("
     "&g_split_blocks[1], 1ull);\n    }\n", ""),
]
_K1_NEW_NAMES = {"fwd": ("wait and meeting", "issue", "reads",
                         "chain and stores"),
                 "scan": ("wait and meeting", "issue", "reads", "gates",
                          "chain and stores")}


# the K1 kernels' names as the profiler shows them, before and after their
# redesign
K1_KERNELS = {"fwd": ("sru_lay0_fwd_bf16_kernel", "sru_lay0_fwd16_kernel"),
              "scan": ("sru_scan_bwd_kernel<11>", "sru_lay0_bwd16_kernel")}


def k1_csrc(tree: str, out: str, variant: str) -> str:
    """A copy of ``tree``'s csrc/ for a K1 ``variant``: "k1base" (as it
    is), "k1stamps" (the first kernels stamped), "k1redesigned" (the
    redesigned ones stamped) or "k1probe:NAME" (one ``_K1_PROBES`` edit);
    returns its path."""
    csrc = os.path.join(out, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "rtfs_tpu_torch", "csrc"), csrc)
    fused, scan = (os.path.join(csrc, n) for n in ("sru_fused.cu",
                                                   "sru_scan.cuh"))
    srcs = {}
    for path in (fused, scan):
        with open(path) as f:
            srcs[path] = f.read()
    if variant == "k1base":
        return csrc
    if variant.startswith("k1probe:"):
        kernel, edits = _K1_PROBES[variant[8:]]
        path, start = {"fwd": (fused, _K1F_START), "scan": (scan, _K1B_START),
                       "fwd16": (fused, _K1F_NEW_START),
                       "bwd16": (fused, _K1B_NEW_START)}[kernel]
        srcs[path] = _patch(srcs[path], start, edits)
    else:
        new = variant == "k1redesigned"
        srcs[scan] = srcs[scan].replace(
            "namespace {\n", _STAMP_HEAD + _STAMP_MACRO + _STAMP_AFTER
            + "namespace {\n", 1)
        for path, start, edits in (
                (fused, _K1F_NEW_START if new else _K1F_START,
                 _K1F_NEW if new else _K1F_STAMPS),
                (scan if not new else fused,
                 _K1B_NEW_START if new else _K1B_START,
                 _K1B_NEW if new else _K1B_STAMPS)):
            srcs[path] = _insert(srcs[path], start, edits)
        srcs[fused] += _STAMP_TAIL
    for path, src in srcs.items():
        with open(path, "w") as f:
            f.write(src)
    return csrc


def worker_k1(tree: str, variant: str, build_only: bool = False) -> dict:
    """Build the K1 ``variant`` (``k1_csrc``) through the tree's
    kernel_lib and run K1's bf16 forward (serving, no c) and backward at
    the six sites; {site: {phase: us a block, "device_us": .., "ns_step":
    ..}}."""
    sys.path.insert(0, tree)
    from rtfs_tpu_torch.ops import kernel_lib, sru_fused

    assert kernel_lib.__file__.startswith(tree), kernel_lib.__file__
    out = os.path.join(HERE, "rtfs_tpu_torch", "_build", "split",
                       variant.replace(":", "_"))
    kernel_lib.CSRC_DIR = k1_csrc(tree, out, variant)
    kernel_lib.BUILD_DIR = os.path.join(out, "lib")
    if build_only:
        kernel_lib.library("sru_fused")
        return {}
    spec = importlib.util.spec_from_file_location(
        "profile_backward", os.path.join(HERE, "tools", "profile_backward.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    rng = np.random.default_rng(0)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).to(bf)

    vb = t((8, H), 0.3)
    stamped = variant in ("k1stamps", "k1redesigned")
    kind = (_K1_PROBES[variant[8:]][0] if variant.startswith("k1probe:")
            else None)
    only = {"fwd16": "fwd", "bwd16": "scan"}.get(kind, kind)
    lib = kernel_lib.library("sru_fused")
    res = {}
    for bs in (1, 4, 8):
        for site, (length, per) in SITES.items():
            bsz = bs * per
            u_f, u_r = t((length, 4 * H, bsz)), t((length, 4 * H, bsz))
            dh_f, dh_r = t((length, H, bsz), 0.1), t((length, H, bsz), 0.1)
            with torch.no_grad():
                c = sru_fused._k1_forward(u_f, u_r, vb, with_c=True)[2:]
            ops = {"fwd": lambda: sru_fused._k1_forward(u_f, u_r, vb, False),
                   "scan": lambda: sru_fused._k1_backward(
                       u_f, u_r, vb, *c, dh_f, dh_r)}
            for name, fn in ops.items():
                if only not in (None, name):
                    continue
                base = 0 if name == "fwd" else 8
                fn()
                torch.cuda.synchronize()
                iters = 20
                buf = (ctypes.c_ulonglong * 18)()
                if stamped:
                    assert lib.phase_split_clear() == 0
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                    assert lib.phase_split_read(ctypes.byref(buf)) == 0
                for _ in range(3):  # the profiler can drop every launch
                    us, n, _ = pb.device_us(fn, K1_KERNELS[name])
                    if n:
                        break
                us = us / n if n else float("nan")
                row = {"device_us": round(us, 3),
                       "ns_step": round(us * 1e3 / length, 1)}
                if stamped:
                    blocks = buf[16 + base // 8]
                    for i, ph in enumerate(_K1_NAMES[name] if variant ==
                                           "k1stamps" else
                                           _K1_NEW_NAMES[name]):
                        row[ph] = round(buf[base + i] / max(blocks, 1) / 1e3,
                                        3)
                    row["blocks"] = blocks // iters
                res[f"K1 {name} bs{bs} {site} L={length} B={bsz}"] = row
    return res


# ------------------------------------------------------------------ K4
# K4's first bf16 forward (``sru_rec_fwd_kernel<E>``, csrc/sru_pallas.cu,
# a tree before its redesign), a step at a time: counters 0-4 (both of
# the template's instances are stamped; only the bf16 one runs)
_K4_START = "sru_rec_fwd_kernel(const E* __restrict__ u, const E* __restrict__ xhw,"
_K4_WAIT = "    hk::cp_async_wait<kRecFwdAhead - 1>();  // step i's group is in\n"
_K4_READ = ("    const float x = slot_value<E>(d + 3 * nt, upper_half(xhw, o, 0, "
            "0));\n")
_K4_GATES = """    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
"""
_K4_STORES = """    store_value(h + o, r * c + (1.f - r) * x);
    if (cs) store_value(cs + o, c);
"""
_K4_REFILL = ("    issue(i + kRecFwdAhead);  // into the slot just read (its "
             "values used)\n")
_K4_LOOP = "  float c = 0.f;\n  for (int i = 0; i < T; ++i) {\n" + _K4_WAIT
_K4_STAMPS = [
    (_K4_LOOP, "  unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", "    SPL(0)\n"),
    (_K4_READ, "", "    SPLV(1, u0 + u1 + u2 + x)\n"),
    (_K4_GATES, "", "    SPLV(2, r * c)\n"),
    (_K4_STORES, "", "    SPL(3)\n"),
    (_K4_REFILL, "", "    SPL(4)\n"),
    ("  }\n", "", "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 5; "
     "++k) atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd("
     "&g_split_blocks[0], 1ull);\n  }\n"),
]
_K4_NAMES = ("wait", "read", "gates and chain", "stores", "issue")


def _k4_chain(fold: bool) -> str:
    """The K4 probe loop that holds the carry's chain alone on registers
    (``sigmoid_f``, or folded to ex2 / rcp), then the kernel's own loop as
    dead code after a return."""
    gate = (_fold("v_f", "c", "q1", "b_f") if fold
            else "sigmoid_f(q1 + v_f * c + b_f)")
    step = ("c = fmaf(f, c - q0, q0);" if fold
            else "c = f * c + (1.f - f) * q0;")
    return (f"""  float c = 0.f;
  const float q0 = 0.01f * (threadIdx.x & 31), q1 = 0.3f - q0;
  for (int i = 0; i < T; ++i) {{
    const float f = {gate};
    {step}
  }}
  store_value(h + (long long)j * B + b, c);
  hk::cp_async_wait_all();
  return;
  for (int i = 0; i < T; ++i) {{
""" + _K4_WAIT)


# probes of the first K4 bf16 forward (``--k4 --probe``): (anchor,
# replacement) edits in ``sru_rec_fwd_kernel``
_K4_PROBES = {
    # the copies after the prologue taken out
    "k4-nocopy": [(_K4_REFILL, "    hk::cp_async_commit();\n")],
    # h and c stored at the last step only (the chain kept)
    "k4-nostore": [(_K4_STORES, "    if (i == T - 1) {\n  " + _K4_STORES.replace(
        "\n    ", "\n      ") + "    }\n")],
    # sigmoid_f replaced by the folded ex2 / rcp sigmoid
    "k4-fold": [(_K4_GATES, f"""    const float f = {_fold("v_f", "c", "u1", "b_f")};
    c = fmaf(f, c - u0, u0);
    const float r = {_fold("v_r", "c", "u2", "b_r")};
""")],
    # the chain alone on registers: the floor of a step
    "k4-chain": [(_K4_LOOP, _k4_chain(False))],
    "k4-chain-fold": [(_K4_LOOP, _k4_chain(True))],
}
# K4's bf16 forward kernels as the profiler names them, before and after
# the redesign (a name holding either part counts)
K4_KERNELS = ("sru_rec_fwd_kernel<__nv_bfloat16>", "sru_rec_fwd16_kernel")


# ------------------------------------------------------------ pw-wgrad
# pw-wgrad's first bf16 kernel (``pw_wgrad_bf16_kernel``, csrc/packed_tf.cu,
# a tree before its redesign), a stage at a time: counters 0-4
_PW16_START = "pw_wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ p,"
_PW16_FLUSH = "    if (++since == kPwFlush || s == ns - 1) {\n"
_PW16_STAMPS = [
    ("  int slot = 0, ld_slot = kPwStages - 1, since = 0;\n",
     "  unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", ""),
    ("    __syncthreads();  // stage s is in; every warp is done with stage "
     "s - 1\n", "", "    SPL(0)\n"),
    ("    if (++ld_slot == kPwStages) ld_slot = 0;\n", "", "    SPL(1)\n"),
    (_PW16_FLUSH, "    SPLV(2, big[0][0][0] + big[1][3][3])\n", ""),
    ("      since = 0;\n    }\n", "", "    SPLV(3, acc[0][0][0])\n"),
    ("                 cq0, transposed);\n", "",
     "  SPL(4)\n  if (threadIdx.x == 0) {\n    for (int k = 0; k < 5; ++k) "
     "atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd(&g_split_blocks[0], "
     "1ull);\n  }\n"),
]
_PW16_NAMES = ("wait and barrier", "issue", "product", "flush", "epilogue")
_PW16_PROBES = {
    # the fragments from registers, not from shared memory
    "pw16-nofrag": [
        ("""        a[mi][0] = hk::pack_bf16(pa[0], pa[1]);
        a[mi][1] = hk::pack_bf16(pa[8 * kPw16PS], pa[8 * kPw16PS + 1]);
        a[mi][2] = hk::pack_bf16(pa[8], pa[9]);
        a[mi][3] = hk::pack_bf16(pa[8 * kPw16PS + 8], pa[8 * kPw16PS + 9]);
""", """        (void)pa;
        a[mi][0] = a[mi][1] = a[mi][2] = a[mi][3] =
            0x3c003c00u + (uint32_t)(kk + mi);
"""),
        ("""        bf[nj][0] = hk::pack_bf16(pb[0], pb[kPw16QS]);
        bf[nj][1] = hk::pack_bf16(pb[8 * kPw16QS], pb[9 * kPw16QS]);
""", """        (void)pb;
        bf[nj][0] = bf[nj][1] = 0x3c003c00u + (uint32_t)nj;
""")],
    # the planar rows' end blocks not copied (their values stale)
    "pw16-noends": [("""              dst[8 * j + e] =
                  lo + e < avail ? src[8 * j + e] : (unsigned short)0;
""", "              (void)dst;\n")],
    # the tensor core's sum added to the float32 sum at the chunk's end
    # only
    "pw16-noflush": [(_PW16_FLUSH, "    if (s == ns - 1) {\n")],
}
PW16_KERNELS = ("pw_wgrad_bf16_kernel", "pw_wgrad16_kernel")
T_PK, F_PK, C_PK, CB_PK = 251, 129, 64, 256  # the packed segment (2 s)


# the redesigned kernels (``--k4 | --pw16 --redesigned``): K4's
# ``sru_rec_fwd16_kernel`` a group at a time (counters 0-3), pw-wgrad's
# ``pw_wgrad16_kernel`` a stage at a time and its epilogue (0-6)
_K4N_START = "sru_rec_fwd16_kernel(const __nv_bfloat16* __restrict__ u,"
_K4N_STAMPS = [
    ("  float c = 0.f;\n  // group n's steps from its slot; kFull: all "
     "kRec16Group of them\n", "  unsigned long long ph[4] = {0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", ""),
    ("#pragma unroll\n    for (int s = 0; s < kRec16Group; ++s) {\n"
     "      if (!kFull && s >= steps) break;\n",
     "    SPLV(2, a0[0] + x1[0] + x2[0] + a3[0])\n", ""),
    ("  };\n  const int groups = (T + kRec16Group - 1) / kRec16Group;\n",
     "    SPLV(3, c)\n", ""),
    ("    __syncwarp();  // the warp's; and every lane is past group n - 1's "
     "reads\n", "", "    SPL(0)\n"),
    ("    issue(n + kRec16Ahead);  // into group n - 1's slot\n", "",
     "    SPL(1)\n"),
    ("      group(std::false_type{}, n);\n  }\n", "",
     "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 4; ++k) "
     "atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd(&g_split_blocks[0], "
     "1ull);\n  }\n"),
]
_K4N_NAMES = ("wait and meeting", "issue", "reads", "chain and stores")
_K4N_PROBES = {
    # the copies after the prologue taken out
    "k4n-nocopy": [("    issue(n + kRec16Ahead);  // into group n - 1's slot\n",
                    "    hk::cp_async_commit();\n")],
    # h and c stored at the last step only
    "k4n-nostore": [
        ("      if (live) *hp = hv;\n",
         "      if (live && n * kRec16Group + s == T - 1) *hp = hv;\n"),
        ("        if (live) *cp = cv;\n",
         "        if (live && n * kRec16Group + s == T - 1) *cp = cv;\n")],
}
_PW16N_START = "pw_wgrad16_kernel(const __nv_bfloat16* __restrict__ p,"
_PW16N_FLUSH = ("#pragma unroll\n    for (int mi = 0; mi < 2; ++mi)\n#pragma "
                "unroll\n      for (int nj = 0; nj < 8; ++nj)\n#pragma unroll\n"
                "        for (int v = 0; v < 4; ++v) acc[mi][nj][v] += "
                "big[mi][nj][v];\n")
_PW16N_STAMPS = [
    ("  int slot = 0, ld_slot = kPw16Stages - 1;\n",
     "  unsigned long long ph[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long s0 = split_stamp();\n", ""),
    ("    __syncthreads();  // stage s is in; every warp is done with stage "
     "s - 1\n", "", "    SPL(0)\n"),
    ("    if (++ld_slot == kPw16Stages) ld_slot = 0;\n", "", "    SPL(1)\n"),
    (_PW16N_FLUSH, "    SPLV(2, big[0][0][0] + big[1][7][3])\n",
     "    SPLV(3, acc[0][0][0])\n"),
    ("  cluster.sync();  // every block's tile is in its shared memory\n", "",
     "  SPL(4)\n"),
    ("  cluster.sync();  // no block leaves while its tile is read\n",
     "  SPL(5)\n", "  SPL(6)\n  if (threadIdx.x == 0) {\n    for (int k = 0; "
     "k < 7; ++k) atomicAdd(&g_split_sum[k], ph[k]);\n    atomicAdd("
     "&g_split_blocks[0], 1ull);\n  }\n"),
]
_PW16N_NAMES = ("wait and barrier", "issue", "product", "flush",
                "tile out and meeting", "cluster sum", "last meeting")
_PW16N_PROBES = {
    # the planar copies of the prologue's stages only (later stages stale)
    "pw16n-noplanar": [("        if (ch < rows) {\n",
                        "        if (s < kPw16Stages - 1 && ch < rows) {\n")],
    # the packed copies of the prologue's stages only
    "pw16n-nopacked": [(
        "      for (int e = tid; e < kQRows * kPw16Cols / 8; e += "
        "kPw16Threads) {\n",
        "      for (int e = tid; e < (s < kPw16Stages - 1 ? kQRows * "
        "kPw16Cols / 8 : 0); e += kPw16Threads) {\n")],
    # no product (the fragments still loaded)
    "pw16n-nomma": [(
        "        for (int nj = 0; nj < 8; ++nj) {\n          if (kk == 0)\n"
        "            hk::mma_bf16_zero(big[mi][nj], a[mi], bq[nj]);\n"
        "          else\n            hk::mma_bf16(big[mi][nj], a[mi], "
        "bq[nj]);\n        }\n",
        "        for (int nj = 0; nj < 8; ++nj)\n          big[mi][nj][kk / "
        "16] = __uint_as_float(a[mi][nj & 3] ^ bq[nj][0]);\n")],
    # no cluster sum (no remote read, no partial written)
    "pw16n-nocluster": [(
        "  for (int e = tid; e < kQRowsR * kPw16Cols; e += kPw16Threads) {\n"
        "    const int r = e / kPw16Cols, c = e % kPw16Cols;\n",
        "  for (int e = tid; e < 0; e += kPw16Threads) {\n"
        "    const int r = e / kPw16Cols, c = e % kPw16Cols;\n")],
}
# every --k4 / --pw16 probe: (source, kernel's defining text, edits)
_K4_PW16_PROBES = {
    **{k: ("sru_pallas.cu", _K4_START, v) for k, v in _K4_PROBES.items()},
    **{k: ("sru_pallas.cu", _K4N_START, v) for k, v in _K4N_PROBES.items()},
    **{k: ("packed_tf.cu", _PW16_START, v) for k, v in _PW16_PROBES.items()},
    **{k: ("packed_tf.cu", _PW16N_START, v)
       for k, v in _PW16N_PROBES.items()},
}
# each stamped variant: (source, kernel's defining text, stamps, names)
_K4_PW16_STAMPED = {
    "k4stamps": ("sru_pallas.cu", _K4_START, _K4_STAMPS, _K4_NAMES),
    "k4redesigned": ("sru_pallas.cu", _K4N_START, _K4N_STAMPS, _K4N_NAMES),
    "pw16stamps": ("packed_tf.cu", _PW16_START, _PW16_STAMPS, _PW16_NAMES),
    "pw16redesigned": ("packed_tf.cu", _PW16N_START, _PW16N_STAMPS,
                       _PW16N_NAMES),
}


def k4_pw16_csrc(tree: str, out: str, variant: str) -> str:
    """A copy of ``tree``'s csrc/ for a ``--k4`` / ``--pw16`` variant:
    "k4base" / "pw16base" (as it is), a stamped one
    (``_K4_PW16_STAMPED``: the first or the redesigned kernel) or
    "probe:NAME" (one ``_K4_PW16_PROBES`` edit); returns its path."""
    csrc = os.path.join(out, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "rtfs_tpu_torch", "csrc"), csrc)
    if variant.endswith("base"):
        return csrc
    if variant.startswith("probe:"):
        name, start, edits = _K4_PW16_PROBES[variant[6:]]
    else:
        name, start, edits, _ = _K4_PW16_STAMPED[variant]
    path = os.path.join(csrc, name)
    with open(path) as f:
        src = f.read()
    if variant.startswith("probe:"):
        src = _patch(src, start, edits)
    else:
        src = src.replace("namespace {\n", _STAMP_HEAD + _STAMP_MACRO
                          + _STAMP_AFTER + "namespace {\n", 1)
        src = _insert(src, start, edits) + _STAMP_TAIL
    with open(path, "w") as f:
        f.write(src)
    return csrc


def _sites_k4():
    """The uni sites: (bs, site, T, B)."""
    return [(bs, site, length, bs * per) for bs in (1, 4, 8)
            for site, (length, per) in SITES.items()]


def worker_k4_pw16(tree: str, variant: str, build_only: bool = False,
                   cold: bool = False, library: bool = False) -> dict:
    """Build a ``--k4`` / ``--pw16`` variant (``k4_pw16_csrc``) through
    the tree's kernel_lib and time it: K4's bf16 forward at the six uni
    sites, serving and with c (training), or pw-wgrad on bf16 operands
    at K6's and K7's dW at bs 1, 4 and 8 (``cold``: L2 flushed before
    each call); {site: {"device_us": .., phases: us a block}}; with
    ``library`` also the library yardsticks (``library_rows``)."""
    sys.path.insert(0, tree)
    from rtfs_tpu_torch.ops import kernel_lib, packed_tf, sru_pallas

    assert kernel_lib.__file__.startswith(tree), kernel_lib.__file__
    tag = hashlib.sha1(tree.encode()).hexdigest()[:8]
    out = os.path.join(HERE, "rtfs_tpu_torch", "_build", "split",
                       f"{variant.replace(':', '_')}_{tag}")
    kernel_lib.CSRC_DIR = k4_pw16_csrc(tree, out, variant)
    kernel_lib.BUILD_DIR = os.path.join(out, "lib")
    k4 = variant.startswith("k4") or (
        variant.startswith("probe:")
        and _K4_PW16_PROBES[variant[6:]][0] == "sru_pallas.cu")
    name = "sru_pallas" if k4 else "packed_tf"
    if build_only:
        kernel_lib.library(name)
        return {}
    spec = importlib.util.spec_from_file_location(
        "profile_backward", os.path.join(HERE, "tools", "profile_backward.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = kernel_lib.library(name)
    stamped = variant in _K4_PW16_STAMPED
    rng = np.random.default_rng(0)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).to(bf)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cases, res = [], {}
    if k4:
        vb = t((4, H), 0.3)
        for bs, site, length, bsz in _sites_k4():
            u, x = t((length, 3 * H, bsz)), t((length, H, bsz))
            for with_c in (False, True):
                cases.append((
                    f"K4 fwd bs{bs} {site} L={length} B={bsz}"
                    f"{' with c' if with_c else ''}",
                    (lambda u=u, x=x, w=with_c: sru_pallas._k4_forward(
                        u, x, vb, False, w)), K4_KERNELS, length))
    else:
        for bs in (1, 4, 8):
            x4, gp = t((bs, CB_PK, T_PK, F_PK)), t((bs, T_PK, F_PK * C_PK))
            xq, g4 = t((bs, T_PK, F_PK * C_PK)), t((bs, CB_PK, T_PK, F_PK))
            for what, a, g in (("K6 dW", x4, gp), ("K7 dW", xq, g4)):
                cases.append((f"pw16 bs{bs} {what}",
                              (lambda a=a, g=g: packed_tf.pw_packed_wgrad(
                                  a, g)), PW16_KERNELS, None))
    if variant in ("k4base", "pw16base") and not (cold or library):
        # the kernels this PR leaves as they are, on the same inputs in
        # either tree: K4's float32 forward and bf16 backward (the scan
        # <14>, c given), pw-wgrad's float32 kernel; a hash of their
        # outputs' bits beside their device time
        kept = []
        if k4:
            for bs, site, length, bsz in _sites_k4():
                u, x = t((length, 3 * H, bsz)), t((length, H, bsz))
                c, dh = t((length, H, bsz)), t((length, H, bsz), 0.1)
                w = tuple(a.float() for a in (u, x, vb))
                kept += [
                    (f"K4 fwd float32 bs{bs} {site}",
                     (lambda w=w: sru_pallas._k4_forward(*w, False, True)),
                     ("sru_rec_fwd_kernel",)),
                    (f"K4 bwd bf16 <14> bs{bs} {site}",
                     (lambda u=u, x=x, c=c, dh=dh: sru_pallas._k4_backward(
                         u, x, vb, c, dh, False)),
                     ("sru_scan_bwd_kernel<14>",))]
        else:
            for bs in (1, 4, 8):
                x4 = t((bs, CB_PK, T_PK, F_PK)).float()
                gp = t((bs, T_PK, F_PK * C_PK)).float()
                kept.append((f"pw-wgrad float32 bs{bs} K6 dW",
                             (lambda a=x4, g=gp: packed_tf.pw_packed_wgrad(
                                 a, g)), ("pw_wgrad_kernel",)))
        for label, fn, parts in kept:
            outs = fn()
            outs = outs if isinstance(outs, tuple) else (outs,)
            digest = hashlib.sha1(b"".join(
                o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                for o in outs)).hexdigest()[:12]
            us, n, _ = pb.device_us(fn, parts)
            res[label] = {"device_us": round(us / n if n else float("nan"),
                                             3), "outputs": digest}
    for label, fn, parts, length in cases:
        fn()
        torch.cuda.synchronize()
        iters = 20
        buf = (ctypes.c_ulonglong * 18)()
        if stamped and (not k4 or "with c" in label):
            assert lib.phase_split_clear() == 0
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            assert lib.phase_split_read(ctypes.byref(buf)) == 0

        def call(fn=fn):
            if cold:
                flush.fill_(1)  # evicts the 50 MB L2 before the call
            fn()

        for _ in range(3):  # the profiler can drop every launch
            us, n, _ = pb.device_us(call, parts)
            if n:
                break
        us = us / n if n else float("nan")
        row = {"device_us": round(us, 3)}
        if length:
            row["ns_step"] = round(us * 1e3 / length, 1)
        if stamped and buf[16]:
            for i, ph in enumerate(_K4_PW16_STAMPED[variant][3]):
                row[ph] = round(buf[i] / buf[16] / 1e3, 3)
            row["blocks"] = buf[16] // iters
        res[label + (" (L2 cold)" if cold else "")] = row
    if library:
        res.update(library_rows(tree, t, pb))
    return res


def library_rows(tree: str, t, pb) -> dict:
    """The library yardsticks of pw-wgrad bf16 (one bf16 ``einsum``, K6's
    and K7's dW) and of K7 bf16 (``baddbmm``, its serving site; w (K, N)
    as K6's dx gives it, contiguous, and as the layer's forward does, the
    transposed view of its (N, K) 1x1 conv weight: the kernel reads w
    through its strides, k fastest across the threads), device us
    a call by ``chip_smoke._library_device_us`` at bs 1, 4 and 8, in turns
    with the kernels (3 rounds, the order flipped each round); beside
    them each side's CUDA events us a call over 50 back-to-back calls (an
    upper bound of its device time, whatever the profiler drops)."""
    from rtfs_tpu_torch.ops import packed_tf as P

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = {}
    for bs in (1, 4, 8):
        x4, gp = t((bs, CB_PK, T_PK, F_PK)), t((bs, T_PK, F_PK * C_PK))
        xq, g4 = t((bs, T_PK, F_PK * C_PK)), t((bs, CB_PK, T_PK, F_PK))
        w_po, b_out = t((C_PK, CB_PK), C_PK ** -0.5), t((CB_PK,))
        w_fw = t((CB_PK, C_PK), C_PK ** -0.5).t()
        xp3 = xq.view(bs, T_PK * F_PK, C_PK).transpose(1, 2)

        def k7(w):
            return (lambda: P.pw_unproj_packed(xq, w, b_out, F_PK),
                    ("pw_unproj_bf16_kernel",),
                    lambda: torch.baddbmm(b_out.view(1, CB_PK, 1),
                                          w.t().expand(bs, CB_PK, C_PK),
                                          xp3))

        pairs = {
            "pw-wgrad K6 dW": (
                lambda: P.pw_packed_wgrad(x4, gp), PW16_KERNELS,
                lambda: torch.einsum("bitf,btfo->io", x4,
                                     gp.view(bs, T_PK, F_PK, C_PK))),
            "pw-wgrad K7 dW": (
                lambda: P.pw_packed_wgrad(xq, g4), PW16_KERNELS,
                lambda: torch.einsum("btfi,botf->io",
                                     xq.view(bs, T_PK, F_PK, C_PK), g4)),
            "K7": k7(w_po),
            "K7 (forward's w)": k7(w_fw),
        }
        for what, (kern, parts, lib) in pairs.items():
            runs = {"kernel": [], "library": []}
            for i in range(3):
                order = [("kernel", kern), ("library", lib)]
                for who, fn in (order if i % 2 == 0 else order[::-1]):
                    if who == "kernel":
                        us, n, _ = pb.device_us(fn, parts)
                        runs[who].append(us / n if n else float("nan"))
                    else:
                        runs[who].append(cs._library_device_us(fn)[0])
            res[f"library {what} bs{bs}"] = {
                "kernel_events_us": round(cs.time_cuda(kern, 50) * 1e3, 2),
                "library_events_us": round(cs.time_cuda(lib, 50) * 1e3, 2),
                "kernel_us": [round(v, 2) for v in runs["kernel"]],
                "library_us": [round(v, 2) for v in runs["library"]],
                "kernel_median": round(float(np.median(runs["kernel"])), 2),
                "library_median": round(float(np.median(runs["library"])),
                                        2)}
    return res


def worker(tree: str, variant: str) -> dict:
    """Build the stamped copy (``variant``: "stamps", "scan" or
    "redesigned") through the tree's kernel_lib and run the six sites;
    {site: {phase: us a block, "device_us": ...}}."""
    sys.path.insert(0, tree)
    from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

    assert kernel_lib.__file__.startswith(tree), kernel_lib.__file__
    scan_only = variant == "scan" or variant.startswith("probe:")
    out = os.path.join(HERE, "rtfs_tpu_torch", "_build", "split",
                       variant.replace(":", "_"))
    kernel_lib.CSRC_DIR = (
        redesigned_csrc(tree, out) if variant == "redesigned"
        else probe_csrc(tree, out, variant[6:]) if variant.startswith("probe:")
        else patched_csrc(tree, out, scan_only))
    kernel_lib.BUILD_DIR = os.path.join(out, "lib")
    spec = importlib.util.spec_from_file_location(
        "profile_backward", os.path.join(HERE, "tools", "profile_backward.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    device_us = pb.device_us

    rng = np.random.default_rng(0)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).to(bf)

    wt = t((6 * H, 2 * H), (2 * H) ** -0.5)
    vb = t((8, H), 0.3)
    w3 = t((TAPS, C_OUT, 2 * H), (2 * H * TAPS) ** -0.5)
    res = {}
    for bs in (1, 4, 8):
        for site, (length, per) in SITES.items():
            bsz = bs * per
            x_f, x_r = t((length, H, bsz), 0.5), t((length, H, bsz), 0.5)
            x3 = t((length, 2 * H, bsz))
            ops = {"K2": (lambda: sru_fused.sru_hidden_layer(
                x_f, x_r, wt, vb), "sru_hid_fwd_bf16_kernel", 0),
                   "K3": (lambda: convt_tm.convt1d_ola_tm(x3, w3),
                          "convt1d_tm_fwd_bf16_kernel", 8)}
            for name, (fn, kernel, base) in ops.items():
                if scan_only and name == "K3":
                    continue
                lib = kernel_lib.library("sru_fused" if name == "K2"
                                         else "convt_tm")
                fn()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 18)()
                iters = 20
                if not scan_only:
                    assert lib.phase_split_clear() == 0
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                    assert lib.phase_split_read(ctypes.byref(buf)) == 0
                dev_us = device_us(fn, (kernel,))[0]
                row = {"device_us": round(dev_us, 3)}
                if not scan_only:
                    blocks = buf[16 + base // 8]
                    names = (_NEW_NAMES[name] if variant == "redesigned"
                             else ("prologue", "issue", "product", "wait",
                                   "scan") if name == "K2" else
                             ("prologue", "issue", "passes", "stores",
                              "wait"))
                    for i, ph in enumerate(names):
                        row[ph] = round(buf[base + i] / blocks / 1e3, 3)
                    row["blocks"] = blocks // iters
                res[f"{name} bs{bs} {site} L={length} B={bsz}"] = row
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--scan-only", action="store_true")
    ap.add_argument("--probe", nargs="+",
                    choices=sorted(_K2_PROBES) + sorted(_K1_PROBES)
                    + sorted(_K4_PW16_PROBES),
                    help="also time the redesigned K2 (with --k1: the first "
                         "K1 bf16 kernels) with one part of its work taken "
                         "out")
    ap.add_argument("--k1", action="store_true",
                    help="K1's bf16 forward and the bf16 scan <11> (with "
                         "--redesigned: their redesigned kernels) instead "
                         "of K2 and K3")
    ap.add_argument("--redesigned", action="store_true",
                    help="stamp the redesigned kernels (this repository's "
                         "form) instead of the first ones")
    ap.add_argument("--k4", action="store_true",
                    help="K4's bf16 forward at the six uni sites instead "
                         "(stamps and probes of its first kernel)")
    ap.add_argument("--pw16", action="store_true",
                    help="pw-wgrad on bf16 operands at K6's and K7's dW, bs "
                         "1, 4 and 8, L2 warm and cold, and the library "
                         "yardsticks (stamps and probes of its first kernel)")
    ap.add_argument("--base-only", action="store_true",
                    help="with --k4 / --pw16: time the kernels as built "
                         "only (no stamps, probes or library)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_split: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    if args.worker:
        if args.worker.startswith(("k4", "pw16", "probe:k4", "probe:pw16")):
            variant = {"pw16cold": "pw16base", "pw16lib": "pw16base"}.get(
                args.worker, args.worker)
            print(json.dumps(worker_k4_pw16(
                tree, variant, args.build_only,
                cold=args.worker == "pw16cold",
                library=args.worker == "pw16lib")))
        elif args.worker.startswith("k1"):
            print(json.dumps(worker_k1(tree, args.worker, args.build_only)))
        else:
            print(json.dumps(worker(tree, args.worker)))
        return 0
    probes = set(args.probe or ())
    known, which = ((({**_K4_PROBES, **_K4N_PROBES}), "K4") if args.k4 else
                    ({**_PW16_PROBES, **_PW16N_PROBES}, "pw-wgrad")
                    if args.pw16 else
                    (_K1_PROBES, "K1") if args.k1 else (_K2_PROBES, "K2"))
    if probes - set(known):
        ap.error(f"--probe {sorted(probes)}: not probes of {which}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.k4 or args.pw16:
        kind = "k4" if args.k4 else "pw16"
        variants = [f"{kind}base"]
        if args.pw16:
            variants.append("pw16cold")
        if not args.base_only:
            variants.append(f"{kind}redesigned" if args.redesigned
                            else f"{kind}stamps")
            if args.pw16 and not args.redesigned:
                variants.append("pw16lib")
            variants += [f"probe:{p}" for p in args.probe or []]
    elif args.k1:
        variants = ["k1base",
                    "k1redesigned" if args.redesigned else "k1stamps"]
        variants += [f"k1probe:{p}" for p in args.probe or []]
    else:
        variants = (["redesigned"] if args.redesigned else
                    ["stamps"] + (["scan"] if args.scan_only else []))
        variants += [f"probe:{p}" for p in args.probe or []]
    if args.k1 or args.k4 or args.pw16:
        # every variant's library built at once, then timed alone
        builds = [subprocess.Popen(
            [sys.executable, __file__, "--tree", tree, "--worker", v,
             "--build-only"], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True) for v in variants
            if v not in ("pw16cold", "pw16lib")]
        for v, proc in zip([v for v in variants
                            if v not in ("pw16cold", "pw16lib")], builds):
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{v} build:\n{err[-4000:]}")
    failed = False
    for variant in variants:
        run = subprocess.run([sys.executable, __file__, "--tree", tree,
                              "--worker", variant], capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:  # the other variants still run
            print(f"split {variant} FAILED:\n{run.stderr[-3000:]}")
            failed = True
            continue
        for site, row in json.loads(
                run.stdout.strip().splitlines()[-1]).items():
            label = ("scan alone (U given)" if variant == "scan" else
                     "as built" if variant in ("k1base", "k4base", "pw16base",
                                               "pw16cold", "pw16lib") else
                     f"probe {variant.split(':')[1]}" if ":" in variant
                     else "phases, us a block")
            print(f"split {site} {label}: {row}; {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
