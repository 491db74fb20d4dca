#!/usr/bin/env python3
"""Split a launch of the first bf16 K2 and K3 forward kernels into phases.

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

The stamps cost a few instructions of thread 0 between phases; the
device time beside them is the stamped kernel's. Usage::

    python3 tools/phase_split.py --tree _scratch/parent [--scan-only]
    python3 tools/phase_split.py --tree . --redesigned
"""

from __future__ import annotations

import argparse
import ctypes
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
    ap.add_argument("--probe", nargs="+", choices=sorted(_K2_PROBES),
                    help="also time the redesigned K2 with one part of its "
                         "work taken out")
    ap.add_argument("--redesigned", action="store_true",
                    help="stamp the redesigned kernels (this repository's "
                         "form) instead of the first ones")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_split: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    if args.worker:
        print(json.dumps(worker(tree, args.worker)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    variants = (["redesigned"] if args.redesigned else
                ["stamps"] + (["scan"] if args.scan_only else []))
    variants += [f"probe:{p}" for p in args.probe or []]
    for variant in variants:
        run = subprocess.run([sys.executable, __file__, "--tree", tree,
                              "--worker", variant], capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"{variant}:\n{run.stderr[-4000:]}")
        for site, row in json.loads(
                run.stdout.strip().splitlines()[-1]).items():
            label = ("scan alone (U given)" if variant == "scan" else
                     f"probe {variant[6:]}" if variant.startswith("probe:")
                     else "phases, us a block")
            print(f"split {site} {label}: {row}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
