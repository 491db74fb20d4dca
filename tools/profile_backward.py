#!/usr/bin/env python3
"""Device time of the SRU backward kernels, for the package of a given tree.

Imports ``rtfs_tpu_torch`` from ``--tree`` (default: this checkout),
builds its kernels, and runs the backward wrappers of K1
(``sru_fused._k1_backward``), K2 (``_k2_backward``) and K4
(``sru_pallas._k4_backward``) at the RTFS-Net-4 bs-4 training sites
(freq T 57 over B 500, time T 118 over B 256, H 32) on random inputs, the
cell states from the tree's own training forward. For each it prints the
profiler's device time a launch of the op's kernels and their sum per
bs-4 step (K1 4 calls a site, K2 12, K4 16 in the unidirectional model),
beside the CUDA-event time a call, which also counts the wrapper's host
path. The wrappers' Python signatures are the same in every tree since
K4 was ported, so two trees compare in turns in one call::

    python3 tools/profile_backward.py --tree _scratch/parent
    python3 tools/profile_backward.py
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

SITES = {"freq": (57, 500), "time": (118, 256)}
H = 32
# calls per bs-4 train step at each site: K1 and K2 per repeat (4) of the
# bidirectional model, K4 per repeat and layer (16) of the unidirectional
PER_SITE = {"K1": 4, "K2": 12, "K4": 16}
# the device kernels of each op, as the profiler names them (either
# tree's)
KERNELS = {"K1": ("sru_scan_bwd_kernel<1>",),
           "K2": ("sru_hid_bwd_", "sru_scan_bwd_kernel<2>"),
           "K4": ("sru_rec_bwd_kernel", "sru_scan_bwd_kernel<4>")}


def event_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, parts, iters: int = 20) -> tuple:
    """(device us a call of the kernels whose names hold one of ``parts``,
    their launches a call, their names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    picked = [e for e in prof.key_averages()
              if any(p in e.key for p in parts)
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(float(e.self_device_time_total) for e in picked)
    launches = sum(e.count for e in picked) / iters
    names = sorted({e.key.split("(")[0].split("::")[-1] for e in picked})
    return total / iters, launches, names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_backward: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from rtfs_tpu_torch.ops import kernel_lib, sru_fused, sru_pallas

    assert kernel_lib.__file__.startswith(tree), kernel_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    kernel_lib.build_all()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    step = {op: [0.0, 0.0] for op in PER_SITE}  # device ms, event ms
    for site, (T, B) in SITES.items():
        vb = t((8, H), 0.3)
        u_f, u_r = t((T, 4 * H, B)), t((T, 4 * H, B))
        x_f, x_r = t((T, H, B), 0.5), t((T, H, B), 0.5)
        wt = t((6 * H, 2 * H), (2 * H) ** -0.5)
        dh_f, dh_r = t((T, H, B)), t((T, H, B))
        u4, x4, vb4 = t((T, 3 * H, B)), t((T, H, B)), t((4, H), 0.3)
        with torch.no_grad():
            c1 = sru_fused._k1_forward(u_f, u_r, vb, with_c=True)[2:]
            c2 = sru_fused._k2_forward(x_f, x_r, wt, vb, with_c=True)[2:]
            c4 = sru_pallas._k4_forward(u4, x4, vb4, False, True)[1]
        calls = {
            "K1": lambda: sru_fused._k1_backward(u_f, u_r, vb, *c1, dh_f,
                                                 dh_r),
            "K2": lambda: sru_fused._k2_backward(x_f, x_r, wt, vb, *c2, dh_f,
                                                 dh_r),
            "K4": lambda: sru_pallas._k4_backward(u4, x4, vb4, c4, dh_f,
                                                  False),
        }
        for op, fn in calls.items():
            us, launches, names = device_us(fn, KERNELS[op])
            ms = event_ms(fn)
            n = PER_SITE[op]
            step[op][0] += n * us / 1e3
            step[op][1] += n * ms
            print(f"{op} backward site={site} T={T} B={B}: device "
                  f"{us:.2f} us a call ({launches:g} launches a call of "
                  f"{', '.join(names)}), events {ms * 1e3:.2f} us a call")
    for op, (dev_ms, ev_ms) in step.items():
        print(f"{op} backward per bs-4 step: device {dev_ms:.4f} ms, events "
              f"{ev_ms:.4f} ms ({PER_SITE[op]} calls a site; tree {tree}; "
              f"{card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
