#!/usr/bin/env python3
"""Device time of redesigned kernels, for the package of a given tree.

Imports ``rtfs_tpu_torch`` from ``--tree`` (default: this checkout),
builds its kernels, and runs the backward wrappers of K1
(``sru_fused._k1_backward``), K2 (``_k2_backward``), K3
(``convt_tm._backward``, the DualPathRNN tail: 2H 64 -> 64 channels, 8
taps) and K4 (``sru_pallas._k4_backward``) at the RTFS-Net-4 bs-4
training sites (freq T 57 over B 500, time T 118 over B 256, H 32) on
random inputs, the cell states from the tree's own training forward. For
each it prints the profiler's device time a launch of the op's kernels
and their sum per bs-4 step (K1 and K3 4 calls a site, K2 12, K4 16 in
the unidirectional model),
beside the CUDA-event time a call, which also counts the wrapper's host
path, and a hash of its outputs' bits (the same inputs in either tree).
``--bf16`` runs the same ops on bf16 inputs (their bf16 entries, the bf16
train step's), with the cell states from the tree's bf16 forward.

``--packed`` runs the packed-TF kernels instead: K6 ``pw_proj_packed``
at its serving site (bs 1 and 8: STFT 251 x 129, bottleneck 256 -> 64,
the layer's strided w and a bias), its K7-dx site (bs 4, contiguous w, no
bias) and at a bottleneck of 512 (bs 1; a tree whose K6 refuses it prints
the refusal), K5-wgrad ``dw_conv_packed_wgrad`` at its two bs-4 sites
("same" and pre-select, 4 x 4 taps over 64 channels), pw-wgrad
``pw_packed_wgrad`` at its two bs-4 sites (K6's dW: x4 (4, 256, T, F)
and the packed g; K7's: the packed x and g (4, 256, T, F)), with its sum
apart, K5
``dw_conv_packed`` at its bs-4 training sites (the "same" forward with a
bias, and its dx: the flipped taps, pads (2, 1), no bias) and K7
``pw_unproj_packed`` at its serving site (bs 1 and 8, 64 -> 256, the
layer's strided w and a bias) and as K6's dx (bs 4, w^T of K6's strided
weight, no bias), each held to its plain version and called twice
(bit-identical), with its device time a launch (K5's also a packed bs-4
step's: 16 launches a site). ``--sweep`` (with ``--packed``, this tree's
K5-wgrad launch interface) also launches K5-wgrad's C entry at the bs-4 "same"
site with other positions a thread (``p``) and runs a tile (``runs``)
than ``ops/packed_tf.dw_wgrad_geometry`` picks, each held to the plain
version, beside the picked geometry's device time.

``--packed --bf16`` runs K8 ``spatial_down_packed`` and K9
``spatial_up_packed`` in bf16 storage at their six sites (pool 251 x 129
-> 125 x 64, the stride-2 select 250 x 128 -> 125 x 64, nearest 125 x 64
-> 251 x 129 and the three transposes, each the other kernel's dx) at bs
1, 4 and 8, each against its plain bf16 version (two bf16 ulps) and twice
(bit-identical), with its device time a launch beside the bf16 bound
(bytes: the distinct values read and written, 2 bytes each, and the map)
and the device time of one PyTorch call of the same function in the same
run (``adaptive_avg_pool2d``, a strided slice, ``interpolate``,
``upsample_nearest2d_backward``, ``_adaptive_avg_pool2d_backward``; none
for the transposed select), summed per packed bs-1 and bs-8 forward and
per packed bs-4 step; the float32 K8 and K9 at the same sites (bs 1 and
8), their device time and a hash of their outputs (the same inputs in
either tree); then K6 ``pw_proj_packed`` in bf16 against
``torch.baddbmm`` by device time at bs 1, 4 and 8, in turns over 5
repeats.

``--fwd16`` runs K1 ``sru_dual_recurrence``, K2 ``sru_hidden_layer``
and K3 ``convt1d_ola_tm`` forward in bf16 storage at the six RTFS-Net-4
forward sites (freq L 57 over B 125 bs, time L 118 over B 64 bs, bs 1, 4
and 8), each against its plain bf16 version (two bf16 ulps) and twice
(bit-identical), with its device time a launch (K1 and K2 with ``c``
written, the training forward, too), their sums per bs-1 / 4 / 8
forward (4 K1, 12 K2 and 4 K3 calls a site), and
the float32 kernels at the same sites on the widened values: their device
time and a hash of their outputs (the same inputs in either tree), and
``conv_transpose1d`` in bf16 by device time (every kernel of a call).

The wrappers' Python signatures are the same in every tree since K4 was
ported (the packed weight gradients for ``--packed``), so two trees
compare in turns in one call::

    python3 tools/profile_backward.py [--packed] [--bf16] [--fwd16] \
        --tree _scratch/parent
    python3 tools/profile_backward.py [--packed] [--bf16]
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import torch

SITES = {"freq": (57, 500), "time": (118, 256)}
T_PK, F_PK, C_PK, CB_PK = 251, 129, 64, 256  # the packed segment (2 s)
K_PK = 4  # the packed TDANet block's depthwise taps
H = 32
# calls per bs-4 train step at each site: K1 and K2 per repeat (4) of the
# bidirectional model, K4 per repeat and layer (16) of the unidirectional
PER_SITE = {"K1": 4, "K2": 12, "K3": 4, "K4": 16}
# the device kernels of each op, as the profiler names them (either
# tree's)
KERNELS = {"K1": ("sru_scan_bwd_kernel<1>",),
           "K2": ("sru_hid_bwd_", "sru_scan_bwd_kernel<2>"),
           "K3": ("convt1d_tm_dx_kernel", "convt1d_tm_wgrad_kernel",
                  "convt1d_tm_sum_kernel"),
           "K4": ("sru_rec_bwd_kernel", "sru_scan_bwd_kernel<4>")}
# and in bf16 storage: K1's scan form or its own kernel, the scan's bf16
# forms, K2's products and scan or its fused kernel
# (sru_hid_bwd_bf16_kernel, dx_add, sums), K3's kernels in any tree's form
# (its fused kernel; W', dx and dW apart) and sums
KERNELS_BF16 = {"K1": ("sru_scan_bwd_kernel<11>", "sru_lay0_bwd16_kernel"),
                "K2": ("sru_hid_bwd_", "sru_scan_bwd_kernel<12>"),
                "K3": ("convt1d_tm_bwd_bf16_kernel",
                       "convt1d_tm_wrev_bf16_kernel", "convt1d_tm_dx_",
                       "convt1d_tm_wgrad_", "convt1d_tm_sum_bf16_kernel"),
                "K4": ("sru_rec_bwd_kernel", "sru_scan_bwd_kernel<14>")}


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
    """(device us a call of the kernels whose names hold one of ``parts``
    (a part may be a tuple of strings the name holds all of; None: every
    kernel), their launches a call, their names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def named(key):
        return parts is None or any(
            all(q in key for q in ((p,) if isinstance(p, str) else p))
            for p in parts)

    picked = [e for e in prof.key_averages()
              if named(e.key) and float(e.self_device_time_total) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(float(e.self_device_time_total) for e in picked)
    launches = sum(e.count for e in picked) / iters
    names = sorted({e.key.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0][:60] for e in picked})
    return total / iters, launches, names


def sru_backward(t, tree: str, card: str, bf16: bool = False) -> None:
    """The SRU backward wrappers at the bs-4 sites (the default mode; with
    ``bf16`` on bf16 inputs)."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused, sru_pallas

    if bf16:
        t32 = t

        def t(shape, scale=1.0):  # noqa: F811
            return t32(shape, scale).to(torch.bfloat16)
    kernels = KERNELS_BF16 if bf16 else KERNELS

    step = {op: [0.0, 0.0] for op in PER_SITE}  # device ms, event ms
    for site, (T, B) in SITES.items():
        vb = t((8, H), 0.3)
        u_f, u_r = t((T, 4 * H, B)), t((T, 4 * H, B))
        x_f, x_r = t((T, H, B), 0.5), t((T, H, B), 0.5)
        wt = t((6 * H, 2 * H), (2 * H) ** -0.5)
        dh_f, dh_r = t((T, H, B)), t((T, H, B))
        u4, x4, vb4 = t((T, 3 * H, B)), t((T, H, B)), t((4, H), 0.3)
        x3, w3 = t((T, 2 * H, B)), t((8, 64, 2 * H), (16 * H) ** -0.5)
        g3 = t((T + 7, 64, B))
        with torch.no_grad():
            c1 = sru_fused._k1_forward(u_f, u_r, vb, with_c=True)[2:]
            c2 = sru_fused._k2_forward(x_f, x_r, wt, vb, with_c=True)[2:]
            c4 = sru_pallas._k4_forward(u4, x4, vb4, False, True)[1]
        calls = {
            "K1": lambda: sru_fused._k1_backward(u_f, u_r, vb, *c1, dh_f,
                                                 dh_r),
            "K2": lambda: sru_fused._k2_backward(x_f, x_r, wt, vb, *c2, dh_f,
                                                 dh_r),
            "K3": lambda: convt_tm._backward(g3, x3, w3),
            "K4": lambda: sru_pallas._k4_backward(u4, x4, vb4, c4, dh_f,
                                                  False),
        }
        for op, fn in calls.items():
            us, launches, names = device_us(fn, kernels[op])
            ms = event_ms(fn)
            n = PER_SITE[op]
            step[op][0] += n * us / 1e3
            step[op][1] += n * ms
            print(f"{op} backward site={site} T={T} B={B}: device "
                  f"{us:.2f} us a call ({launches:g} launches a call of "
                  f"{', '.join(names)}), events {ms * 1e3:.2f} us a call, "
                  f"outputs {_digest(fn())}")
    for op, (dev_ms, ev_ms) in step.items():
        print(f"{op} backward{' bf16' if bf16 else ''} per bs-4 step: "
              f"device {dev_ms:.4f} ms, events {ev_ms:.4f} ms "
              f"({PER_SITE[op]} calls a site; tree {tree}; {card})")


def _digest(outs) -> str:
    """A hash of an op's outputs' bits (the same inputs in either tree)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    return hashlib.sha1(b"".join(
        o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        for o in outs)).hexdigest()[:12]


def packed(t, sweep: bool) -> None:
    """K6, K5, K7, K5-wgrad and pw-wgrad at their sites (``--packed``),
    and K5-wgrad's launch geometries (``--sweep``)."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    T, F, C, K = T_PK, F_PK, C_PK, K_PK
    bias = t((C,))
    for bs, site, k_in, strided, with_bias in (
            (1, "projection", CB_PK, True, True),
            (8, "projection", CB_PK, True, True),
            (4, "K7 dx", CB_PK, False, False),
            (1, "K 512", 2 * CB_PK, True, True)):
        x4 = t((bs, k_in, T, F))
        w = t((C, k_in), k_in ** -0.5)
        w = w.t() if strided else w.t().contiguous()
        b = bias if with_bias else None
        fn = lambda: P.pw_proj_packed(x4, w, b)  # noqa: E731
        try:
            P.pw_proj_geometry(bs, T * F, k_in, C)
        except ValueError as e:  # a tree whose K6 refuses this K
            print(f"K6 bs={bs} site={site}: refused ({e})")
            continue
        err = (fn() - P.pw_proj_packed_plain(x4, w, b)).abs().max().item()
        us, n, _ = device_us(fn, ("pw_proj_kernel",))
        print(f"K6 bs={bs} site={site} K={k_in}: device {us:.2f} us a call "
              f"({n:g} launches), events {event_ms(fn) * 1e3:.2f} us, max "
              f"abs err {err:.3e}")
    xp = t((4, T, F * C))
    same = ((K - 1) // 2, K - 1 - (K - 1) // 2)
    pre = ((K - 1) // 2,) * 2
    w_v = t((C, K, K), 1.0 / K).permute(1, 2, 0)  # the layer's view
    dx = (K - 1 - same[0], K - 1 - same[1])
    for site, pads, w, b in (("same", same, w_v, bias),
                             ("same dx", dx, torch.flip(w_v, (0, 1)), None)):
        fn = lambda: P.dw_conv_packed(xp, w, b, F, C, pads, pads)  # noqa
        got = fn()
        err = (got - P.dw_conv_packed_plain(xp, w, b, F, C, pads, pads)
               ).abs().max().item()
        us, n, _ = device_us(fn, ("dw_conv_packed_kernel",))
        print(f"K5 bs=4 site={site}: device {us:.2f} us a call ({n:g} "
              f"launches), {16 * us / 1e3:.4f} ms a packed bs-4 step (16 "
              f"calls), events {event_ms(fn) * 1e3:.2f} us, max "
              f"abs err {err:.3e}, two calls bit-identical "
              f"{torch.equal(got, fn())}")
    w_out = t((CB_PK, C), C ** -0.5).t()  # the layer's (C, Cb) view
    for bs, site, w, b in ((1, "residual", w_out, t((CB_PK,))),
                           (8, "residual", w_out, t((CB_PK,))),
                           (4, "K6 dx", t((C, CB_PK), CB_PK ** -0.5), None)):
        x = xp if bs == 4 else t((bs, T, F * C))
        fn = lambda: P.pw_unproj_packed(x, w, b, F)  # noqa: E731
        got = fn()
        err = (got - P.pw_unproj_packed_plain(x, w, b, F)).abs().max().item()
        us, n, _ = device_us(fn, ("pw_unproj_kernel",))
        print(f"K7 bs={bs} site={site}: device {us:.2f} us a call ({n:g} "
              f"launches), events {event_ms(fn) * 1e3:.2f} us, max abs err "
              f"{err:.3e}, two calls bit-identical {torch.equal(got, fn())}")
    for site, pads in (("same", same), ("pre-select", pre)):
        t_out, f_out = P.dw_geometry(T, F, K, K, pads, pads)
        g = t((4, t_out, f_out * C))
        fn = lambda: P.dw_conv_packed_wgrad(  # noqa: E731
            xp, g, F, C, (K, K), pads, pads)
        want = P.dw_conv_packed_wgrad_plain(xp, g, F, C, (K, K), pads, pads)
        err = (fn() - want).abs().max().item() / want.abs().max().item()
        us, n, _ = device_us(fn, ("dw_wgrad", "sum_partials"))
        print(f"K5-wgrad bs=4 site={site}: device {us:.2f} us a call ({n:g} "
              f"launches, with the sum), events {event_ms(fn) * 1e3:.2f} "
              f"us, max abs err {err:.3e} of max|dW|")
    # pw-wgrad at its two bs-4 sites: K6's dW (x4 rank-4, g packed) and
    # K7's (xp packed, g rank-4), 4 calls a site a packed bs-4 step
    x4, gq = t((4, CB_PK, T, F)), t((4, CB_PK, T, F))
    for site, a, g in (("K6 dW", x4, xp), ("K7 dW", xp, gq)):
        fn = lambda: P.pw_packed_wgrad(a, g)  # noqa: E731
        got = fn()
        want = P.pw_packed_wgrad_plain(a, g)
        err = (got - want).abs().max().item() / want.abs().max().item()
        us, n, _ = device_us(fn, ("pw_wgrad", "sum_partials"))
        part, _, names = device_us(fn, ("pw_wgrad",))
        print(f"pw-wgrad bs=4 site={site}: device {us:.2f} us a call ({n:g} "
              f"launches: {', '.join(names)} {part:.2f} + sum "
              f"{us - part:.2f}), {4 * us / 1e3:.4f} ms a packed bs-4 step "
              f"(4 calls), events {event_ms(fn) * 1e3:.2f} us, max abs err "
              f"{err:.3e} of max|dW|, two calls bit-identical "
              f"{torch.equal(got, fn())}")
    if not sweep:
        return
    dev = xp.device
    t_out, f_out = P.dw_geometry(T, F, K, K, same, same)
    g = t((4, t_out, f_out * C))
    want = P.dw_conv_packed_wgrad_plain(xp, g, F, C, (K, K), same, same)
    picked = P.dw_wgrad_geometry(4, C, t_out, f_out, K, K)
    s = picked["s"]
    for p in (6, 8, 11, 16, 22, 33):
        tiles_f = -(-f_out // (s * p))
        smem = P.dw_wgrad_smem(K, K, picked["qb"], s, p)
        if smem > kernel_lib.SMEM_PER_BLOCK:
            continue
        per_sm = kernel_lib.SMEM_PER_SM // (smem + 1024)
        for per in sorted({1, per_sm}):
            runs = per * kernel_lib.SMS // tiles_f
            ints = (4, T, F, C, t_out, f_out, K, K, same[0], same[0],
                    picked["qb"], s, p, runs, runs * tiles_f)
            part = torch.empty(ints[-1], K * K * C, device=dev)
            out = torch.empty(K, K, C, device=dev)

            def fn():
                kernel_lib.launch(
                    "packed_tf", "dw_conv_packed_wgrad", dev, xp.data_ptr(),
                    g.data_ptr(), part.data_ptr(), out.data_ptr(), *ints)

            fn()
            err = (out - want).abs().max().item() / want.abs().max().item()
            us, _, _ = device_us(fn, ("dw_wgrad", "sum_partials"))
            mark = " (picked)" if (p, runs) == (picked["p"],
                                                picked["runs"]) else ""
            print(f"K5-wgrad sweep site=same p={p} tiles_f={tiles_f} "
                  f"runs={runs} ({per} blocks an SM, {smem} B): device "
                  f"{us:.2f} us a call, max abs err {err:.3e} of max|dW|"
                  f"{mark}")


# K8 / K9 in bf16 storage, as either tree's profiler names them: the
# bf16 kernels, or the float32 kernels templated on bf16 before them
MAP16_KERNELS = {"K8": ("spatial_down_bf16_kernel",
                        ("spatial_down_kernel", "bfloat16")),
                 "K9": ("spatial_up_bf16_kernel",
                        ("spatial_up_kernel", "bfloat16"))}


# calls per forward of K1, K2 and K3 at each site (4 K1, 12 K2, 4 K3: one
# layer-0 and three hidden layers of two DualPathRNNs a repeat, 4 repeats,
# at each site)
FWD_PER_SITE = {"K1": 4, "K2": 12, "K3": 4}
FWD_SITES = {"freq": (57, 125), "time": (118, 64)}


def forward16(t, tree: str, card: str) -> None:
    """K1, K2 and K3 forward in bf16 at the six forward sites
    (``--fwd16``), and their float32 kernels' device time and output
    hashes."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    smoke = _own_smoke()
    bf = torch.bfloat16
    wt = t((6 * H, 2 * H), (2 * H) ** -0.5)
    vb = t((8, H), 0.3)
    w3 = t((8, 64, 2 * H), (16 * H) ** -0.5)
    per = {}
    for bs in (1, 4, 8):
        for site, (T, per_item) in FWD_SITES.items():
            B = bs * per_item
            x_f, x_r = t((T, H, B), 0.5), t((T, H, B), 0.5)
            x3 = t((T, 2 * H, B))
            u_f, u_r = t((T, 4 * H, B)), t((T, 4 * H, B))
            ops = {
                "K1": (lambda a, b, c: sru_fused._k1_forward(
                    a, b, c, with_c=False),
                    sru_fused.sru_dual_recurrence_plain, (u_f, u_r, vb),
                    ("sru_lay0_fwd",)),
                "K1 with c": (lambda a, b, c: sru_fused._k1_forward(
                    a, b, c, with_c=True), functools.partial(
                        sru_fused.sru_dual_recurrence_plain, with_c=True),
                    (u_f, u_r, vb), ("sru_lay0_fwd",)),
                "K2": (lambda a, b, c, d: sru_fused._k2_forward(
                    a, b, c, d, with_c=False), sru_fused.sru_hidden_layer_plain,
                    (x_f, x_r, wt, vb), ("sru_hid_fwd",)),
                "K2 with c": (lambda a, b, c, d: sru_fused._k2_forward(
                    a, b, c, d, with_c=True), functools.partial(
                        sru_fused.sru_hidden_layer_plain, with_c=True),
                    (x_f, x_r, wt, vb), ("sru_hid_fwd",)),
                "K3": (convt_tm._forward, convt_tm.convt1d_ola_tm_plain,
                       (x3, w3), ("convt1d_tm_fwd", "convt1d_tm_sum")),
            }
            for op, (fn, plain, args, parts) in ops.items():
                a16 = tuple(a.to(bf) for a in args)
                got, again = fn(*a16), fn(*a16)
                want = plain(*a16)
                got = got if isinstance(got, tuple) else (got,)
                again = again if isinstance(again, tuple) else (again,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                ratio = max(smoke.bf16_ulps(g, w)[1]
                            for g, w in zip(got, want))
                for _ in range(3):  # the profiler can drop every launch
                    us, launches, names = device_us(lambda: fn(*a16), parts)
                    if launches:
                        break
                digest = _digest(fn(*args))
                for _ in range(3):
                    us32, n32, _ = device_us(lambda: fn(*args), parts)
                    if n32:
                        break
                line = (f"{op} forward bf16 bs={bs} site={site} L={T} B={B}: "
                        f"device {us:.2f} us a call ({launches:g} launches "
                        f"of {', '.join(names)}); against plain bf16 "
                        f"{ratio:.3f} of 2 ulps; two calls "
                        f"{'bit-identical' if same else 'DIFFER'}; float32 "
                        f"kernel {us32:.2f} us, outputs {digest}")
                if op == "K3":
                    lib = functools.partial(
                        torch.nn.functional.conv_transpose1d,
                        a16[0].permute(2, 1, 0).contiguous(),
                        a16[1].permute(2, 1, 0).contiguous())
                    lib_us = device_us(lib, None)[0]
                    line += f"; conv_transpose1d bf16 {lib_us:.2f} us a call"
                    per.setdefault((bs, "library"), 0.0)
                    per[(bs, "library")] += FWD_PER_SITE["K3"] * lib_us
                print(line)
                if ratio > 1.0 or not same:
                    raise AssertionError(line)
                key = op.split()[0]
                if not op.endswith("with c"):
                    per.setdefault((bs, key), 0.0)
                    per[(bs, key)] += FWD_PER_SITE[key] * us
    for bs in (1, 4, 8):
        print(f"bf16 forward bs={bs}: K1 {per[(bs, 'K1')] / 1e3:.4f} ms, "
              f"K2 {per[(bs, 'K2')] / 1e3:.4f} ms, K3 "
              f"{per[(bs, 'K3')] / 1e3:.4f} ms of device a forward "
              f"(conv_transpose1d {per[(bs, 'library')] / 1e3:.4f}); tree "
              f"{tree}; {card}")


def _own_smoke():
    """This checkout's ``chip_smoke`` (its bytes count and memory rate),
    whatever ``--tree``."""
    spec = importlib.util.spec_from_file_location(
        "yardstick_chip_smoke", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def maps_bf16(t) -> None:
    """K8 and K9 in bf16 storage at their six sites and bs 1, 4 and 8
    (``--packed --bf16``), then K6 bf16 against ``baddbmm``."""
    import torch.nn.functional as Fn

    from rtfs_tpu_torch.ops import packed_tf as P

    smoke = _own_smoke()
    bf = torch.bfloat16
    T, F, C, K = T_PK, F_PK, C_PK, K_PK
    T2, F2 = (T - 2) // 2 + 1, (F - 2) // 2 + 1
    pre = ((K - 1) // 2,) * 2
    t_conv, f_conv = P.dw_geometry(T, F, K, K, pre, pre)
    pool = P.cached_map("pool", T, T2, F, F2)
    sel = P.cached_map("select", t_conv, T2, f_conv, F2)
    up = P.cached_map("nearest", T2, T, F2, F)
    aten = torch.ops.aten

    def cl(xp, tt, ff):  # a packed map as the channels-last (B, C, T, F)
        return xp.view(xp.shape[0], tt, ff, C).permute(0, 3, 1, 2)

    # (kernel, site, launches a packed forward, a packed bs-4 step)
    sites = (("K8", "pool", 4, 4), ("K8", "select", 4, 4),
             ("K9", "nearest", 16, 16), ("K8", "transposed nearest", 0, 16),
             ("K9", "transposed pool", 0, 4),
             ("K9", "transposed select", 0, 4))
    total = {}
    for bs in (1, 4, 8):
        xp, xs = t((bs, T, F * C)).to(bf), t((bs, t_conv, f_conv * C)).to(bf)
        x2, g2 = t((bs, C, T2, F2)).to(bf), t((bs, C, T2, F2)).to(bf)
        calls = {
            "pool": (pool, xp, lambda: Fn.adaptive_avg_pool2d(
                cl(xp, T, F), (T2, F2))),
            "select": (sel, xs, lambda: cl(xs, t_conv, f_conv)[
                :, :, ::2, ::2].contiguous()),
            "nearest": (up, x2, lambda: Fn.interpolate(
                x2, size=(T, F), mode="nearest")),
            "transposed nearest": (up.transposed(F2), xp,
                                   lambda: aten.upsample_nearest2d_backward(
                                       cl(xp, T, F), [T, F],
                                       [bs, C, T2, F2])),
            "transposed pool": (pool.transposed(F), g2,
                                lambda: aten._adaptive_avg_pool2d_backward(
                                    g2, cl(xp, T, F))),
            "transposed select": (sel.transposed(f_conv), g2, None),
        }
        for op, site, n_fwd, n_step in sites:
            smap, x, lib = calls[site]
            if op == "K8":
                fn = lambda: P.spatial_down_packed(x, smap, C)  # noqa
                want = P.spatial_down_packed_plain(x, smap, C)
            else:
                fn = lambda: P.spatial_up_packed(x, smap)  # noqa
                want = P.spatial_up_packed_plain(x, smap)
            got = fn()
            g, w = got.float(), want.float()
            ulps = ((g - w).abs() / (2.0 ** -7 * torch.clamp(
                w.abs(), min=2.0 ** -6))).max().item()
            same = torch.equal(got, fn())
            # one launch a call: the time of the launches the profiler saw
            us, n, names = device_us(fn, MAP16_KERNELS[op], 50)
            us = us / n if n else math.nan
            lib_us, lib_n, lib_names = device_us(lib, None, 50) if lib \
                else (math.nan, 0, ["none"])
            lib_ev = event_ms(lib, 200) * 1e3 if lib else math.nan
            bound = (smoke._map_cost(smap, C, bs, elem=2)[0]
                     / smoke.HBM_BYTES_PER_S * 1e6)
            print(f"{op} bf16 bs={bs} site={site}: device {us:.2f} us a "
                  f"launch ({n:g} launches a call of {', '.join(names)}), "
                  f"library {lib_us:.2f} us a call ({lib_n:g} kernels a "
                  f"call: {', '.join(lib_names)}; events over 200 calls "
                  f"{lib_ev:.2f}), bound {bound:.2f} us "
                  f"(bytes), share of bound {bound / us:.3f}; worst "
                  f"{ulps:.3f} of 2 bf16 ulps against plain, two calls "
                  f"bit-identical {same}")
            for key, n_calls in ((f"bs-{bs} forward", n_fwd),
                                 ("bs-4 step", n_step if bs == 4 else 0)):
                if n_calls and not math.isnan(us):
                    agg = total.setdefault((op, key), [0.0, 0.0, 0.0])
                    agg[0] += n_calls * us
                    agg[1] += n_calls * bound
                    agg[2] += n_calls * (0.0 if math.isnan(lib_us)
                                         else lib_us)
    for (op, key), (us, bound, lib_us) in sorted(total.items()):
        print(f"{op} bf16 per packed {key}: device {us / 1e3:.4f} ms, "
              f"bound {bound / 1e3:.4f} ms (share {bound / us:.3f}), "
              f"library {lib_us / 1e3:.4f} ms (the sites that have one)")

    # the float32 K8 / K9 at the same sites: device time, and a hash of
    # the outputs (the inputs come from the same seed in either tree)
    for bs in (1, 8):
        xp, xs = t((bs, T, F * C)), t((bs, t_conv, f_conv * C))
        x2 = t((bs, C, T2, F2))
        ins = {"pool": (pool, xp), "select": (sel, xs), "nearest": (up, x2),
               "transposed nearest": (up.transposed(F2), xp),
               "transposed pool": (pool.transposed(F), x2),
               "transposed select": (sel.transposed(f_conv), x2)}
        for op, site, _, _ in sites:
            smap, x = ins[site]
            if op == "K8":
                fn = lambda: P.spatial_down_packed(x, smap, C)  # noqa
                parts = ("spatial_down_kernel",)
            else:
                fn = lambda: P.spatial_up_packed(x, smap)  # noqa
                parts = ("spatial_up_kernel",)
            digest = hashlib.sha1(fn().cpu().numpy().tobytes()).hexdigest()
            us, n, _ = device_us(fn, parts, 50)
            us = us / n if n else math.nan
            print(f"{op} float32 bs={bs} site={site}: device {us:.2f} us a "
                  f"launch ({n:g} launches a call), output sha1 "
                  f"{digest[:16]}")

    # K6 bf16 against one baddbmm, in turns, 5 repeats a batch
    w = t((C, CB_PK), CB_PK ** -0.5).to(bf).t()  # the layer's view
    b_in = t((C,)).to(bf)
    for bs in (1, 4, 8):
        x4 = t((bs, CB_PK, T, F)).to(bf)
        x3 = x4.view(bs, CB_PK, T * F).transpose(1, 2)
        kern = lambda: P.pw_proj_packed(x4, w, b_in)  # noqa: E731
        lib = lambda: torch.baddbmm(  # noqa: E731
            b_in.view(1, 1, C), x3, w.expand(bs, CB_PK, C))
        runs = {"kernel": [], "baddbmm": []}
        for i in range(5):
            order = (("kernel", kern), ("baddbmm", lib))
            for name, fn in (order if i % 2 == 0 else order[::-1]):
                parts = ("pw_proj_bf16_kernel",) if name == "kernel" else None
                runs[name].append(device_us(fn, parts, 20)[0])
        print(f"K6 bf16 bs={bs}: device us a call in turns, kernel "
              f"{[round(v, 2) for v in runs['kernel']]}, baddbmm "
              f"{[round(v, 2) for v in runs['baddbmm']]}; medians "
              f"{np.median(runs['kernel']):.2f} / "
              f"{np.median(runs['baddbmm']):.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--packed", action="store_true",
                    help="the packed kernels instead of the SRU backward")
    ap.add_argument("--sweep", action="store_true",
                    help="with --packed: K5-wgrad at other geometries")
    ap.add_argument("--fwd16", action="store_true",
                    help="K1, K2 and K3 forward in bf16 at the six "
                         "forward sites, and their float32 kernels")
    ap.add_argument("--bf16", action="store_true",
                    help="the SRU backward on bf16 inputs; with --packed: "
                         "K8 and K9 in bf16, and K6 bf16 against baddbmm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_backward: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from rtfs_tpu_torch.ops import kernel_lib

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

    if args.fwd16:
        forward16(t, tree, card)
    elif args.packed and args.bf16:
        maps_bf16(t)
        print(f"tree {tree}; {card}")
    elif args.packed:
        packed(t, args.sweep)
        print(f"tree {tree}; {card}")
    else:
        sru_backward(t, tree, card, args.bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
