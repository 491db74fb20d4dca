#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtfs_tpu_torch) of RTFS-Net-4 on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one or outside the repository. Phases, any failure of which ends the run:

1. Card: name and power limit from nvidia-smi.
2. Build: nvcc compiles every ``rtfs_tpu_torch/csrc/*.cu`` for sm_90a, in
   parallel.
3. Forward kernels: each kernel of the serving path (K1 sru_dual_recurrence,
   K2 sru_hidden_layer, K3 convt1d_ola_tm) runs at the shapes the RTFS-Net-4
   forward gives it at batch 1 and 8, against its plain PyTorch version on
   the same inputs on the card, and is timed with CUDA events.
4. Serving: the full RTFS-Net-4 (4 repeats, published widths, weights from
   seed 0) answers ``separate_sample`` requests of 2 s at batch 1 and 8 on
   the card. The launch counts of that run must be K1 8 / K2 24 / K3 8 per
   forward, and the output must match the same model on the CPU (where the
   port runs the kernels' plain versions) on the same weights and inputs.
5. Backward kernels: at the training shapes (the preset's batch 4, both
   DualPathRNN sites) the training forward of K1/K2 (which keeps the cell
   states c) and the backward kernels of K1, K2 and K3 run against the
   plain forward + plain backward and against torch autograd through the
   plain forward, on the same inputs on the card; the backward is timed
   beside its bound and, for K3, beside autograd of ``conv_transpose1d``.
6. Training: RTFS-Net-4 and the lip backbone are built on the card and on
   the CPU; one ``AVSystem.train_step`` at batch 1 with dropout 0, on the
   card and on the CPU in float32, is held against the same step in
   float64 on the CPU: with cuDNN off, the card's gradients must be as
   close to it as the CPU's float32 step's; with cuDNN, as the main path
   runs, within cuDNN's measured spread; loss and BatchNorm statistics in
   both. Then the
   port's train system (``rtfs_tpu_torch.train.main.build_system``, as the
   train entry builds it, with the preset's dropout) takes steps at batch 4
   on synthetic batches: launches per step must be K1/K2/K3 forward 8/24/8
   and backward 8/24/8, every loss finite and the parameters moved; it
   prints ms per step, peak memory, and one profiled step's device time,
   idle share and top kernels.

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
# backward kernels against the plain backward and autograd, relative to
# each output's max |value|: BPTT through T <= 118 contracting steps and
# reductions (dv, db, dW) over up to T*B = 28,500 terms in another order
BWD_REL_TOL = {"sru_dual_recurrence_bwd": 1e-4, "sru_hidden_layer_bwd": 1e-4,
               "convt1d_ola_tm_bwd": 1e-4}
# training, one step at batch 1, each float32 step held against the same
# step in float64 on the CPU: the loss relative to itself; BatchNorm
# statistics relative to max(1, |stat|); every gradient tensor with 1e-5
# of the largest gradient added (tensors whose true gradient is 0 hold
# only rounding noise). The card with cuDNN off runs the port's own code
# with native convs and is held to TRAIN_GRAD_CPU_FACTOR times the CPU
# float32 step's error on that tensor plus TRAIN_GRAD_REL_TOL of its max
# |grad|: ~100 layers of backward amplify float32 rounding, and no float32
# order does better than the CPU's error says. The card with cuDNN, as
# the main path runs it, is held to TRAIN_GRAD_CUDNN_REL_TOL of each
# tensor's max, against float64 and against the CPU's float32 step:
# cuDNN's engines with TF32 off (FFT among them) came out
# up to 25x the CPU's error from float64 (0.57% of max on the audio
# bottleneck's weight), where the same step with cuDNN off matched the CPU.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_CPU_FACTOR = 3.0
TRAIN_GRAD_REL_TOL = 1e-4
TRAIN_GRAD_CUDNN_REL_TOL = 1e-2
TRAIN_STAT_TOL = 1e-4
TRAIN_BATCH = 4  # the preset's training.batch_size
TRAIN_STEPS = 6


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
    """Phase 3: every forward kernel against its plain version at the main
    path's shapes; returns per kernel the max error and per-forward (batch 8)
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


def _max_err(got, want) -> tuple:
    """(max abs error, max |want|) over paired tensors."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    return err, scale


def check_backward_kernels(geo, rng, fwd_res) -> dict:
    """Phase 5: the training forward (with c) and the backward kernels at
    the training shapes against the plain versions and autograd; returns
    per backward kernel the max error and per-train-step (batch 4) sums of
    kernel, plain, bound and library times. The forward-with-c errors join
    the forward entries' ``max_abs_err`` in ``fwd_res``."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    H, C, k = geo["H"], geo["C"], geo["k"]
    dev = torch.device("cuda")

    def t(shape, scale=1.0, grad=False):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).requires_grad_(grad)

    # launches per train step at each of the two sites
    per_site = {"sru_dual_recurrence_bwd": REPEATS,
                "sru_hidden_layer_bwd": REPEATS * (geo["layers"] - 1),
                "convt1d_ola_tm_bwd": REPEATS}
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": None}
           for name in per_site}
    for site in ("freq", "time"):
        length, per_item = geo[site]
        B = TRAIN_BATCH * per_item
        vb = t((8, H), 0.3, True)
        u = (t((length, 4 * H, B), 1.0, True), t((length, 4 * H, B), 1.0, True))
        x = (t((length, H, B), 0.5, True), t((length, H, B), 0.5, True))
        wt = t((6 * H, 2 * H), math.sqrt(1.0 / (2 * H)), True)
        dh = (t((length, H, B)), t((length, H, B)))
        x3 = t((length, 2 * H, B), 1.0, True)
        w3 = t((k, C, 2 * H), math.sqrt(1.0 / (2 * H * k)), True)
        g3 = t((length + k - 1, C, B))
        d = lambda a: a.detach()  # noqa: E731

        with torch.no_grad():
            f1 = sru_fused._k1_forward(*map(d, u), d(vb), with_c=True)
            f2 = sru_fused._k2_forward(*map(d, x), d(wt), d(vb), with_c=True)
        cases = {
            "sru_dual_recurrence_bwd": (
                "sru_dual_recurrence", f1,
                sru_fused.sru_dual_recurrence_plain(*map(d, u), d(vb), True),
                lambda: sru_fused._k1_backward(*map(d, u), d(vb), f1[2],
                                               f1[3], *dh),
                lambda: sru_fused.sru_dual_recurrence_bwd_plain(
                    *map(d, u), d(vb), f1[2], f1[3], *dh),
                lambda: sru_fused.sru_dual_recurrence_plain(*u, vb),
                (*u, vb), dh,
                # u, c, dh read; du written (both directions); ~30 flops a
                # (step, unit, column, direction)
                4 * (2 * length * 4 * H * B * 2 + 2 * length * H * B * 2
                     + 16 * H),
                2 * length * H * B * 30, None),
            "sru_hidden_layer_bwd": (
                "sru_hidden_layer", f2,
                sru_fused.sru_hidden_layer_plain(*map(d, x), d(wt), d(vb),
                                                 True),
                lambda: sru_fused._k2_backward(*map(d, x), d(wt), d(vb),
                                               f2[2], f2[3], *dh),
                lambda: sru_fused.sru_hidden_layer_bwd_plain(
                    *map(d, x), d(wt), d(vb), f2[2], f2[3], *dh),
                lambda: sru_fused.sru_hidden_layer_plain(*x, wt, vb),
                (*x, wt, vb), dh,
                # x, c, dh read, dx written; wt, vb read, dwt, dvb written;
                # three (3H x 2H) products a (step, column, direction): U
                # recomputed, dx = W du, dW += x du^T; ~30 flops of gates
                4 * (2 * length * H * B * 4 + 2 * (wt.numel() + vb.numel())),
                2 * length * B * (3 * 2 * 3 * H * 2 * H + 30 * H), None),
            "convt1d_ola_tm_bwd": (
                None, None, None,
                lambda: convt_tm._backward(g3, d(x3), d(w3)),
                lambda: convt_tm.convt1d_ola_tm_bwd_plain(g3, d(x3), d(w3)),
                lambda: convt_tm.convt1d_ola_tm_plain(x3, w3),
                (x3, w3), (g3,),
                # g, x read, dx written; w read, dw written; dx and dW each
                # 2 k C_in C_out flops a (step, column)
                4 * ((length + k - 1) * C * B + 2 * length * 2 * H * B
                     + 2 * w3.numel()),
                4 * length * k * 2 * H * C * B, "conv_transpose1d"),
        }
        for name, (fwd_name, fwd_got, fwd_want, kern, plain, plain_fwd, ins,
                   cots, nbytes, nops, lib) in cases.items():
            if fwd_name is not None:
                err, scale = _max_err(fwd_got, fwd_want)
                print(f"kernel {fwd_name} (training forward, with c) "
                      f"site={site} L={length} B={B}: max_abs_err={err:.3e} "
                      f"(tol {TOL[fwd_name]:.0e})")
                if not err <= TOL[fwd_name]:
                    raise AssertionError(f"{fwd_name} with c disagrees with "
                                         f"its plain version: {err:.3e}")
                fwd_res[fwd_name]["max_abs_err"] = max(
                    fwd_res[fwd_name]["max_abs_err"], err)
            got = kern()
            want = plain()
            outs = plain_fwd()
            outs = outs if isinstance(outs, tuple) else (outs,)
            auto = torch.autograd.grad(outs, ins, cots)
            torch.cuda.synchronize()
            tol = BWD_REL_TOL[name]
            worst = 0.0
            for label, ref in (("plain backward", want), ("autograd", auto)):
                for i, (g, w) in enumerate(zip(got, ref)):
                    err = (g - w).abs().max().item()
                    scale = w.abs().max().item()
                    worst = max(worst, err)
                    print(f"kernel {name} site={site} L={length} B={B} "
                          f"output {i} vs {label}: max_abs_err={err:.3e} "
                          f"max|ref|={scale:.3e} (tol {tol:.0e} * max|ref|)")
                    if not err <= tol * scale:
                        raise AssertionError(
                            f"{name} output {i} disagrees with the "
                            f"{label}: {err:.3e} > {tol:.0e} * {scale:.3e}")
            ms = time_cuda(kern, 30)
            plain_ms = time_cuda(plain, 3, warmup=1)
            b_ms, b_by = bound_ms(nbytes, nops)
            lib_ms = None
            if lib:
                x_lib = d(x3).permute(2, 1, 0).contiguous().requires_grad_()
                w_lib = d(w3).permute(2, 1, 0).contiguous().requires_grad_()
                y_lib = torch.nn.functional.conv_transpose1d(x_lib, w_lib)
                g_lib = g3.permute(2, 1, 0).contiguous()
                lib_ms = time_cuda(lambda: torch.autograd.grad(
                    y_lib, (x_lib, w_lib), g_lib, retain_graph=True), 30)
            print(f"kernel {name} site={site} L={length} B={B}: ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                  f"library_ms={lib_ms}")
            r = res[name]
            n = per_site[name]
            r["max_abs_err"] = max(r["max_abs_err"], worst)
            r["ms"] += n * ms
            r["plain_ms"] += n * plain_ms
            r["bound_ms"] += n * b_ms
            r["bound_by"] = b_by
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + n * lib_ms
    return res


def _no_dropout(conf):
    """A copy of ``conf`` with every ``dropout`` rate set to 0."""
    if isinstance(conf, dict):
        return {k: 0.0 if k == "dropout" else _no_dropout(v)
                for k, v in conf.items()}
    return conf


def _train_step_at(conf, batch, dev, dtype, cudnn=True) -> tuple:
    """One train step of a new system (weights from seed 0) on ``dev`` in
    ``dtype``, with cuDNN on or off: (loss, gradients, BatchNorm
    statistics, seconds), the tensors as float64 on the CPU."""
    from rtfs_tpu_torch.train.main import build_system
    from rtfs_tpu_torch.train.system import make_generator

    system = build_system(conf, dev, seed=0)
    system.model.to(dtype)
    system.video_model.to(dtype)
    torch.backends.cudnn.enabled = cudnn
    try:
        t0 = time.perf_counter()
        loss = system.train_step(batch, make_generator(0, dev))["train_loss"]
        loss = loss.item()
        secs = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.enabled = True
    grads = {}
    for n, p in system.model.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{n}: no gradient on {dev}")
        grads[n] = p.grad.to("cpu", torch.float64)
    stats = {n: b.to("cpu", torch.float64)
             for n, b in system.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, stats, secs


def compare_train_step(conf, batch) -> None:
    """One train step at batch 1 with dropout 0 on the card (with cuDNN
    and with it off) and on the CPU in float32, each held against the
    CPU's float64 step, and the card's against the CPU's; a repeat of the
    card step shows its run-to-run spread. The tolerances are at
    ``TRAIN_GRAD_*``."""
    conf0 = _no_dropout(conf)
    runs = {"card": ("cuda", torch.float32, True),
            "card again": ("cuda", torch.float32, True),
            "card, cuDNN off": ("cuda", torch.float32, False),
            "cpu": ("cpu", torch.float32, True),
            "cpu float64": ("cpu", torch.float64, True)}
    res = {}
    for run, (dev, dtype, cudnn) in runs.items():
        res[run] = _train_step_at(conf0, batch, dev, dtype, cudnn)
        print(f"training: {run} step at batch 1 (dropout 0) "
              f"loss={res[run][0]:.9f} in {res[run][3]:.3f} s")
    loss64, g64, stats64, _ = res.pop("cpu float64")
    scale = {n: g.abs().max().item() for n, g in g64.items()}
    g_max = max(scale.values())
    err = {run: {n: (g - g64[n]).abs().max().item()
                 for n, g in r[1].items()} for run, r in res.items()}
    spread = max((g - res["card again"][1][n]).abs().max().item()
                 for n, g in res["card"][1].items())

    for run, r in res.items():
        rel_l2 = statistics.median(
            ((g - g64[n]).norm() / g64[n].norm().clamp(min=1e-300)).item()
            for n, g in r[1].items())
        worst = max(g64, key=lambda n: err[run][n] / (scale[n] + 1e-5 * g_max))
        print(f"training: {run} against float64: loss {r[0]:.9f} / "
              f"{loss64:.9f}; gradients median rel_l2 {rel_l2:.3e}, worst "
              f"{worst} {err[run][worst]:.3e} on max|grad| "
              f"{scale[worst]:.3e}")
        if not abs(r[0] - loss64) <= TRAIN_LOSS_REL_TOL * abs(loss64):
            raise AssertionError(f"train loss {run} {r[0]} vs float64 "
                                 f"{loss64}")
    gates = {
        "card, cuDNN off": (
            lambda n: TRAIN_GRAD_CPU_FACTOR * err["cpu"][n]
            + TRAIN_GRAD_REL_TOL * scale[n] + 1e-5 * g_max,
            f"{TRAIN_GRAD_CPU_FACTOR} * cpu error + {TRAIN_GRAD_REL_TOL:.0e}"
            f" * max|grad| + 1e-5 * {g_max:.3e}"),
        "card": (
            lambda n: TRAIN_GRAD_CUDNN_REL_TOL * scale[n] + 1e-5 * g_max,
            f"{TRAIN_GRAD_CUDNN_REL_TOL:.0e} * max|grad| + 1e-5 * "
            f"{g_max:.3e}"),
    }
    gates["card vs cpu"] = gates["card"]
    err["card vs cpu"] = {n: (g - res["cpu"][1][n]).abs().max().item()
                          for n, g in res["card"][1].items()}
    for run, (tol, text) in gates.items():
        rows = sorted(((err[run][n] / tol(n), n) for n in g64), reverse=True)
        for r, n in rows[:4]:
            print(f"training: {run}: grad {n}: max|grad|={scale[n]:.3e}, max "
                  f"abs error {err[run][n]:.3e} ({r:.3f} of the tolerance); "
                  f"against float64: card {err['card'][n]:.3e}, card with "
                  f"cuDNN off {err['card, cuDNN off'][n]:.3e}, cpu "
                  f"{err['cpu'][n]:.3e}")
        print(f"training: {run}: {len(rows)} gradients, worst at "
              f"{rows[0][0]:.3f} of its tolerance ({text})")
        if rows[0][0] > 1.0:
            raise AssertionError(f"{rows[0][1]}: {run}: gradient error "
                                 f"{err[run][rows[0][1]]:.3e}")
    print(f"training: card vs card max abs {spread:.3e}")
    stat_err = max((((s - stats64[n]).abs() / stats64[n].abs().clamp(min=1.0))
                    .max().item() for n, s in res["card"][2].items()),
                   default=math.inf)
    print(f"training: {len(stats64)} BatchNorm statistics, card against "
          f"float64 max rel error {stat_err:.3e} (tol {TRAIN_STAT_TOL:.0e})")
    if not stat_err <= TRAIN_STAT_TOL:
        raise AssertionError(f"BatchNorm statistics: {len(stats64)} buffers, "
                             f"max rel error {stat_err:.3e}")


def train(conf) -> dict:
    """Phase 6: one train step on the card against float64 on the CPU, then
    the train system's steps at batch 4; returns the launch counts of those
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train.main import build_system
    from rtfs_tpu_torch.train.system import make_generator

    data = SyntheticAVDataset(n_samples=TRAIN_BATCH * TRAIN_STEPS, seed=0)

    compare_train_step(conf, data.collate([data[0]]))

    # the main path: the train system's steps at batch 4, preset dropout
    system = build_system(conf, "cuda", seed=0)
    generator = make_generator(0, "cuda")
    batches = list(data.batches(TRAIN_BATCH, seed=0, epoch=0))
    before = [p.detach().clone() for p in system.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(system.train_step(batch, generator)["train_loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernel_lib.LAUNCHES)
    n = len(batches)
    expect = {"sru_dual_recurrence_fwd": 2 * REPEATS,
              "sru_hidden_layer_fwd": 2 * REPEATS * 3,
              "convt1d_ola_tm_fwd": 2 * REPEATS,
              "sru_dual_recurrence_bwd": 2 * REPEATS,
              "sru_hidden_layer_bwd": 2 * REPEATS * 3,
              "convt1d_ola_tm_bwd": 2 * REPEATS}
    print(f"training: launches over {n} steps: {launches}; per step "
          f"{ {k: v / n for k, v in launches.items()} }")
    for name, per in expect.items():
        if launches.get(name, 0) != n * per:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches "
                                 f"in {n} steps, expected {per} per step")
    losses = [v.item() for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, system.model.parameters()))
    if moved == 0:
        raise AssertionError("no parameter changed in training")
    med = statistics.median(times[1:])
    print(f"training: {n} steps at batch {TRAIN_BATCH}, losses "
          f"{[round(v, 4) for v in losses]}; {moved} of {len(before)} "
          f"parameter tensors moved; ms per step median={med * 1e3:.3f} "
          f"min={min(times[1:]) * 1e3:.3f} max={max(times[1:]) * 1e3:.3f} "
          f"(first step {times[0] * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # one more step under the profiler: device time and idle share
    batch = batches[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.train_step(batch, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)

    kernels = sorted((e for e in prof.key_averages() if dev_us(e) > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=dev_us, reverse=True)
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(f"training: profiled step wall {wall_ms:.3f} ms, device "
          f"{dev_ms:.3f} ms, idle share {max(0.0, 1 - dev_ms / wall_ms):.3f}")
    for e in kernels[:12]:
        print(f"training: top kernel {dev_us(e) / 1e3:9.3f} ms "
              f"{dev_us(e) / 1e3 / dev_ms:6.3f} x{e.count:<5d} {e.key[:90]}")
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
    bwd = check_backward_kernels(geo, rng, kernels)
    train_launches = train(conf)

    sources = {
        "sru_dual_recurrence": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                "rtfs_tpu/ops/sru_fused.py:108",
                                "sru_dual_recurrence_fwd"),
        "sru_hidden_layer": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                             "rtfs_tpu/ops/sru_fused.py:400",
                             "sru_hidden_layer_fwd"),
        "convt1d_ola_tm": ("rtfs_tpu_torch/csrc/convt_tm.cu",
                           "rtfs_tpu/ops/convt_tm.py:38",
                           "convt1d_ola_tm_fwd"),
        "sru_dual_recurrence_bwd": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                    "rtfs_tpu/ops/sru_fused.py:159",
                                    "sru_dual_recurrence_bwd"),
        "sru_hidden_layer_bwd": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                 "rtfs_tpu/ops/sru_fused.py:458",
                                 "sru_hidden_layer_bwd"),
        "convt1d_ola_tm_bwd": ("rtfs_tpu_torch/csrc/convt_tm.cu",
                               "rtfs_tpu/ops/convt_tm.py:59",
                               "convt1d_ola_tm_bwd"),
    }
    line = {"kernels": []}
    for name, (src, rep, fn) in sources.items():
        if name in kernels:  # forward: the serving run, per forward at bs 8
            entry = {"launches": launches.get(fn, 0), **kernels[name],
                     "per_forward_at_batch": 8}
        else:  # backward: the training run, per train step at bs 4
            entry = {"launches": train_launches.get(fn, 0), **bwd[name],
                     "per_train_step_at_batch": TRAIN_BATCH}
        line["kernels"].append({"name": name, "route": "cuda", "source": src,
                                "replaces": rep, **entry})
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps(line))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
