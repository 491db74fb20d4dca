#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtfs_tpu_torch) of RTFS-Net-4 on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one or outside the repository. Phases, any failure of which ends the run:

1. Card: name and power limit from nvidia-smi.
2. Build: nvcc compiles every ``rtfs_tpu_torch/csrc/*.cu`` for sm_90a, in
   parallel.
3. Kernels: each kernel of the serving path (K1 sru_dual_recurrence, K2
   sru_hidden_layer, K3 convt1d_ola_tm) runs at the shapes the RTFS-Net-4
   forward gives it at batch 1 and 8, against its plain PyTorch version on
   the same inputs on the card, and is timed with CUDA events.
4. Serving: the full RTFS-Net-4 (4 repeats, published widths, weights from
   seed 0) answers ``separate_sample`` requests of 2 s at batch 1 and 8 on
   the card. The launch counts of that run must be K1 8 / K2 24 / K3 8 per
   forward, and the output must match the same model on the CPU (where the
   port runs the kernels' plain versions) on the same weights and inputs.

The last lines are the ``kernels`` JSON object, the card line, and
``{"ok": true, "device": {...}}``. TF32 is switched off for cuDNN and
matmuls before any comparison, so every float32 product is full float32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# float32 (non-tensor-core) operations/s. The kernels compute in float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PRESET = "lrs2_RTFSNet_4_layer"
SAMPLES = 32000  # 2 s at 16 kHz
VIDEO_FRAMES = 50
REPEATS = 4

# tolerances, max abs error against the plain version on the same card:
# K1: elementwise gate math only, expf vs torch.sigmoid rounding over T steps
# K2/K3: dot products of 64 / 512 terms summed in another order
TOL = {"sru_dual_recurrence": 1e-5, "sru_hidden_layer": 1e-4,
       "convt1d_ola_tm": 1e-4}
# serving, card vs CPU: every op of the forward runs in another order
# (cuDNN vs CPU convs, kernels vs plain loops); relative to max |output|
SERVE_REL_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_geometry(conf, samples: int = SAMPLES) -> dict:
    """(L, B-per-batch-item) of each DualPathRNN scan in the forward of
    ``samples``-long audio, from the preset: STFT frames, then the TDANet
    pyramid's stride-2 convs (padding (k-1)//2), then the window count of a
    stride-1 scan. tests/test_torch_avnet.py holds it against the shapes a
    forward gives the kernels."""
    a = conf["audionet"]
    edp, ap = a["enc_dec_params"], a["audio_params"]
    t = 1 + samples // edp["hop_length"]
    f = edp["win"] // 2 + 1
    k, s = ap["kernel_size"], ap["stride"]
    for _ in range(ap["upsampling_depth"] - 1):
        t = (t + 2 * ((k - 1) // 2) - k) // s + 1
        f = (f + 2 * ((k - 1) // 2) - k) // s + 1
    lay = ap["layers"]["layer_1"]
    win = lay["kernel_size"]
    return {
        "freq": (f - win + 1, t),  # dim=4: scans F, folds T into batch
        "time": (t - win + 1, f),  # dim=3: scans T, folds F into batch
        "H": lay["hid_chan"], "C": ap["hid_chan"], "k": win,
        "layers": lay["num_layers"],
    }


def check_kernels(geo, rng) -> dict:
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns per kernel the max error and per-forward (batch 8)
    sums of kernel, plain, bound and library times."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    H, C, k = geo["H"], geo["C"], geo["k"]
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    vb = torch.cat([t((2, 2, H), math.sqrt(1.0 / H)), t((2, 2, H), 0.1)],
                   dim=1).reshape(8, H)
    wt = t((6 * H, 2 * H), math.sqrt(1.0 / (2 * H)))
    w3 = t((k, C, 2 * H), math.sqrt(1.0 / (2 * H * k)))
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": None, "bound_by": None}
           for name in TOL}
    per_forward = {"sru_dual_recurrence": REPEATS,
                   "sru_hidden_layer": REPEATS * (geo["layers"] - 1),
                   "convt1d_ola_tm": REPEATS}

    for bs in (1, 8):
        for site in ("freq", "time"):
            length, per_item = geo[site]
            bsz = bs * per_item
            cases = {
                "sru_dual_recurrence": (
                    sru_fused.sru_dual_recurrence,
                    sru_fused.sru_dual_recurrence_plain,
                    (t((length, 4 * H, bsz)), t((length, 4 * H, bsz)), vb),
                    4 * (2 * length * 4 * H * bsz + 2 * length * H * bsz),
                    2 * length * H * bsz * 20, None),
                "sru_hidden_layer": (
                    sru_fused.sru_hidden_layer,
                    sru_fused.sru_hidden_layer_plain,
                    (t((length, H, bsz), 0.5), t((length, H, bsz), 0.5),
                     wt, vb),
                    4 * (4 * length * H * bsz + wt.numel() + vb.numel()),
                    2 * length * bsz * (3 * H * 2 * H * 2 + 20 * H), None),
                "convt1d_ola_tm": (
                    convt_tm.convt1d_ola_tm,
                    convt_tm.convt1d_ola_tm_plain,
                    (t((length, 2 * H, bsz)), w3),
                    4 * (length * 2 * H * bsz + w3.numel()
                         + (length + k - 1) * C * bsz),
                    2 * length * k * 2 * H * C * bsz,
                    "conv_transpose1d"),
            }
            for name, (kern, plain, args, nbytes, nops, lib) in cases.items():
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                got = torch.stack(got) if isinstance(got, tuple) else got
                want = torch.stack(want) if isinstance(want, tuple) else want
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                ms = time_cuda(lambda: kern(*args), 50)
                plain_ms = time_cuda(lambda: plain(*args), 3, warmup=1)
                b_ms, b_by = bound_ms(nbytes, nops)
                lib_ms = None
                if lib:
                    x_lib = args[0].permute(2, 1, 0).contiguous()
                    w_lib = args[1].permute(2, 1, 0).contiguous()
                    lib_ms = time_cuda(
                        lambda: torch.nn.functional.conv_transpose1d(
                            x_lib, w_lib), 50)
                print(f"kernel {name} bs={bs} site={site} L={length} "
                      f"B={bsz}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                      f"(tol {TOL[name]:.0e}) ms={ms:.5f} plain_ms="
                      f"{plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                      f"library_ms={lib_ms}")
                if not err <= TOL[name]:
                    raise AssertionError(
                        f"{name} disagrees with its plain version: "
                        f"{err:.3e} > {TOL[name]:.0e}")
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if bs == 8:  # per-forward sums at batch 8
                    n = per_forward[name]
                    r["ms"] += n * ms
                    r["plain_ms"] += n * plain_ms
                    r["bound_ms"] += n * b_ms
                    r["bound_by"] = b_by
                    if lib_ms is not None:
                        r["library_ms"] = (r["library_ms"] or 0.0) + n * lib_ms
    return res


def serve(conf, rng) -> dict:
    """Phase 4: the port's serving entry on the card, held against the
    same model on the CPU; returns launch counts and end-to-end times."""
    from rtfs_tpu_torch.config import build_avnet
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.utils.separator import separate_sample

    t0 = time.perf_counter()
    model = build_avnet(conf, device="cuda", seed=0)
    cpu_model = build_avnet(conf, device="cpu", seed=0)
    print(f"serving: built RTFS-Net-4 ({REPEATS} repeats, "
          f"{sum(p.numel() for p in model.parameters())} params) on cuda and "
          f"cpu in {time.perf_counter() - t0:.3f} s")
    requests = {}
    for bs in (1, 8):
        wav = (rng.standard_normal((bs, SAMPLES)) * 0.1).astype(np.float32)
        mouth = rng.standard_normal((bs, VIDEO_FRAMES, 512)).astype(np.float32)
        requests[bs] = (wav, mouth)

    # the main path: counts from 0, the batch-1 and batch-8 requests, read
    kernel_lib.reset_launches()
    outs = {bs: separate_sample(model, *requests[bs]) for bs in (1, 8)}
    torch.cuda.synchronize()
    launches = dict(kernel_lib.LAUNCHES)
    n_fwd = len(requests)
    expect = {"sru_dual_recurrence_fwd": 2 * REPEATS,
              "sru_hidden_layer_fwd": 2 * REPEATS * 3,
              "convt1d_ola_tm_fwd": 2 * REPEATS}
    print(f"serving: launches over {n_fwd} forwards: {launches}; per forward "
          f"{ {k: v / n_fwd for k, v in launches.items()} }")
    for name, per in expect.items():
        if launches.get(name, 0) != n_fwd * per:
            raise AssertionError(
                f"{name}: {launches.get(name, 0)} launches, expected "
                f"{n_fwd * per} ({per} per forward)")

    for bs, (wav, mouth) in requests.items():
        got = outs[bs]
        if got.shape != (bs, 1, SAMPLES) or not np.isfinite(got).all():
            raise AssertionError(f"bs {bs}: bad output {got.shape}")
        t0 = time.perf_counter()
        want = separate_sample(cpu_model, wav, mouth)
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        print(f"serving: bs={bs} card vs cpu max_abs_err={err:.3e} "
              f"max|out|={scale:.3e} (tol {SERVE_REL_TOL:.0e} * max|out|); "
              f"cpu forward {cpu_s:.3f} s")
        if not err <= SERVE_REL_TOL * scale:
            raise AssertionError(f"bs {bs}: card and CPU outputs disagree")

    timing = {}
    for bs, iters in ((1, 20), (8, 10)):
        wav, mouth = requests[bs]
        separate_sample(model, wav, mouth)  # warm
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            separate_sample(model, wav, mouth)  # ends in a host copy
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        timing[bs] = med
        print(f"serving: bs={bs} request latency median={med * 1e3:.3f} ms "
              f"min={min(times) * 1e3:.3f} ms max={max(times) * 1e3:.3f} ms "
              f"over {iters}; audio s/s={bs * SAMPLES / 16000 / med:.3f}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from rtfs_tpu_torch.config import load_config
    from rtfs_tpu_torch.ops import kernel_lib

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    report = kernel_lib.build_all()
    print(f"build: {sorted(report)} in {time.perf_counter() - t0:.3f} s")
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off for cuDNN convolutions and matmuls")

    conf = load_config(PRESET)
    geo = main_path_geometry(conf)
    print(f"geometry: {geo}")
    rng = np.random.default_rng(0)
    kernels = check_kernels(geo, rng)
    launches = serve(conf, rng)

    sources = {"sru_dual_recurrence": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                       "rtfs_tpu/ops/sru_fused.py:108",
                                       "sru_dual_recurrence_fwd"),
               "sru_hidden_layer": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                    "rtfs_tpu/ops/sru_fused.py:400",
                                    "sru_hidden_layer_fwd"),
               "convt1d_ola_tm": ("rtfs_tpu_torch/csrc/convt_tm.cu",
                                  "rtfs_tpu/ops/convt_tm.py:38",
                                  "convt1d_ola_tm_fwd")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(fn, 0), **kernels[name],
         "per_forward_at_batch": 8}
        for name, (src, rep, fn) in sources.items()
    ]}
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps(line))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
