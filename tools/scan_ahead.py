#!/usr/bin/env python3
"""Time the SRU backward adjoint scan at other ring depths, on one GPU.

The scan (``rtfs_tpu_torch/csrc/sru_scan.cuh``) keeps each thread's next
``kScanAhead`` steps of copies in flight and takes ``kScanGroup`` steps a
wait. This script builds ``sru_fused.cu`` and ``sru_pallas.cu`` once for
each (ahead, group) pair given, from a copy of ``csrc/`` with the two
constants replaced, into ``rtfs_tpu_torch/_build/scan_ahead/`` (all nvcc
at once), then times K1 backward (``sru_dual_recurrence_bwd``) and K4
backward (``sru_recurrence_bwd``) with CUDA events at the RTFS-Net-4 bs-4
training sites (freq T 57 over B 500, time T 118 over B 256, H 32) beside
the bytes bound. Each variant runs in a process of its own, held against
the plain versions (1e-4 of each output's max), the variants in turns and
then in reverse order: loaded into one process beside the library built
from the same source, a variant's outputs came out wrong. Usage::

    python3 tools/scan_ahead.py [--ahead 8 12 16] [--group 1 2]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtfs_tpu_torch.ops import kernel_lib, sru_fused  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SITES = {"freq": (57, 500), "time": (118, 256)}
H = 32


def _root(ahead: int, group: int) -> str:
    return os.path.join(kernel_lib.BUILD_DIR, "scan_ahead",
                        f"a{ahead}_g{group}")


def build(ahead: int, group: int) -> list:
    """Start nvcc for both sources of one variant; returns [(process,
    library path)]."""
    root = _root(ahead, group)
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kernel_lib.CSRC_DIR, csrc)
    path = os.path.join(csrc, "sru_scan.cuh")
    with open(path) as f:
        src = f.read()
    for name, value in (("kScanAhead", ahead), ("kScanGroup", group)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    with open(path, "w") as f:
        f.write(src)
    out = []
    for name, lib in variant_libs(ahead, group).items():
        cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-o", lib,
               os.path.join(csrc, f"{name}.cu")]
        out.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib))
    return out


def variant_libs(ahead: int, group: int) -> dict:
    return {name: os.path.join(_root(ahead, group), f"lib{name}.so")
            for name in ("sru_fused", "sru_pallas")}


def load(paths: dict) -> dict:
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn, (n_ptr, n_int) in kernel_lib._SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def calls(libs: dict, rng) -> dict:
    """{(kernel, site): (launch, plain backward, outputs, directions)} for
    one variant's libraries, on random inputs."""
    from rtfs_tpu_torch.ops import sru_pallas

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    out = {}
    for site, (T, B) in SITES.items():
        g1 = sru_fused.scan_bwd_geometry(T, H, B, 2)
        u_f, u_r = t((T, 4 * H, B)), t((T, 4 * H, B))
        vb, c_f, c_r = t((8, H), 0.3), t((T, H, B)), t((T, H, B))
        dh_f, dh_r = t((T, H, B)), t((T, H, B))
        du_f, du_r = torch.empty_like(u_f), torch.empty_like(u_r)
        part1 = torch.empty(g1["parts"], 8, H, device=dev)
        args1 = [a.data_ptr() for a in (u_f, u_r, vb, c_f, c_r, dh_f, dh_r,
                                        du_f, du_r, part1)]

        def k1(args=args1, g=g1, T=T, B=B):
            st = libs["sru_fused"].sru_dual_recurrence_bwd(
                *args, T, H, B, g["cols"], g["units"], stream)
            assert st == 0, st

        plain1 = functools.partial(sru_fused.sru_dual_recurrence_bwd_plain,
                                   u_f, u_r, vb, c_f, c_r, dh_f, dh_r)
        g4 = sru_fused.scan_bwd_geometry(T, H, B, 1)
        u, x, vb4 = t((T, 3 * H, B)), t((T, H, B)), t((4, H), 0.3)
        c, dh = t((T, H, B)), t((T, H, B))
        du, dx = torch.empty_like(u), torch.empty_like(x)
        part4 = torch.empty(g4["parts"], 4, H, device=dev)
        args4 = [a.data_ptr() for a in (u, x, vb4, c, dh, du, dx, part4)]

        def k4(args=args4, g=g4, T=T, B=B):
            st = libs["sru_pallas"].sru_recurrence_bwd(
                *args, T, H, B, 0, g["cols"], g["units"], stream)
            assert st == 0, st

        plain4 = functools.partial(sru_pallas.sru_recurrence_bwd_plain, u, x,
                                   vb4, c, dh)
        out[("K1", site)] = (k1, plain1, lambda o=(du_f, du_r, part1): (
            o[0], o[1], o[2].sum(0)), 2)
        out[("K4", site)] = (k4, plain4, lambda o=(du, dx, part4): (
            o[0], o[1], o[2].sum(0)), 1)
    return out


def event_ms(fn, iters: int = 50) -> float:
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


def worker(ahead: int, group: int) -> None:
    """One variant in this process: its outputs against the plain versions,
    then its time a launch at each site; prints one JSON line."""
    libs = load(variant_libs(ahead, group))
    res = {}
    for (kernel, site), (fn, plain, got, _) in calls(
            libs, np.random.default_rng(0)).items():
        fn()
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got(), plain())):
            err, scale = (g - w).abs().max().item(), w.abs().max().item()
            if not err <= 1e-4 * scale:
                raise AssertionError(f"ahead {ahead} group {group} {kernel} "
                                     f"{site} output {i}: {err} on {scale}")
        res[f"{kernel} {site}"] = event_ms(fn)
    print(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ahead", type=int, nargs="+", default=[8, 12, 16])
    ap.add_argument("--group", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--worker", type=int, nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ahead: needs a CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        worker(*args.worker)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    variants = [(a, g) for a in args.ahead for g in args.group]
    procs = [p for v in variants for p in build(*v)]  # all nvcc at once
    for proc, path in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{log}")
    times = {v: [] for v in variants}
    for order in (variants, variants[::-1]):  # in turns, then back
        for v in order:
            run = subprocess.run([sys.executable, __file__, "--worker",
                                  str(v[0]), str(v[1])], capture_output=True,
                                 text=True, timeout=300)
            if run.returncode != 0:
                raise RuntimeError(f"variant {v}:\n{run.stderr[-3000:]}")
            times[v].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for key in times[variants[0]][0]:
        kernel, site = key.split()
        T, B = SITES[site]
        dirs = 2 if kernel == "K1" else 1
        bound_us = 40 * T * H * B * dirs / HBM_BYTES_PER_S * 1e6
        for v in variants:
            us = [1e3 * run[key] for run in times[v]]
            print(f"scan ahead={v[0]} group={v[1]} {kernel} backward "
                  f"site={site} T={T} B={B}: us a launch "
                  f"{us[0]:.2f} / {us[1]:.2f} (bound {bound_us:.2f}, bytes; "
                  f"held to the plain version; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
