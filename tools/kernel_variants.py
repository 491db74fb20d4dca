#!/usr/bin/env python3
"""Time a hand-written kernel built at other values of its constants, on one GPU.

A kernel's variants are values of the ``constexpr int`` constants that
shape it, given as ``A:B:..`` in the order of its row of ``KERNELS``:

- ``scan``: the SRU backward adjoint scan (``csrc/sru_scan.cuh``), its
  ring depth ``kScanAhead`` and the steps a wait ``kScanGroup``; K1
  backward (``sru_dual_recurrence_bwd``) and K4 backward
  (``sru_recurrence_bwd``) at the RTFS-Net-4 bs-4 training sites (freq T
  57 over B 500, time T 118 over B 256, H 32), held to the plain versions
  (1e-4 of each output's max), beside the bytes bound;
- ``unproj``: K7 (``pw_unproj_kernel`` in ``csrc/packed_tf.cu``), its tile
  of ``kUnprojM`` positions, ring of ``kUnprojStages`` and
  ``kUnprojBlocks`` blocks an SM; the forward at bs 1 and 8 (the layer's
  strided w, a bias) and K6's dx at bs 4 (w^T of K6's weight, no bias),
  STFT 251 x 129, 64 -> 256 channels, held to the plain version (1e-4);
- ``pw_wgrad``: pw-wgrad (``pw_wgrad_kernel`` in ``csrc/packed_tf.cu``),
  its tile of ``kPwRows`` planar channels (256: all of dW at the preset,
  each operand read once; 128 or 64: the 64-channel side read twice or
  four times), its ring of ``kPwStages``, the stages a flush of the big
  products into the float32 sum ``kPwFlush`` (more than a chunk's stages,
  e.g. 100000: they stay in the tensor core's accumulator for the whole
  chunk) and the positions a stage ``kPwK``; K6's and K7's dW at bs 4
  (256 x 64 channels over 4 x 251 x 129 positions) with the sum of the
  partials, held to the plain version (1e-4 of max|dW|) beside the bytes
  bound; then, to show drift, K6's dW of all-positive inputs in one chunk
  a batch row (32,379 positions) held to the plain version in float64;
- ``maps16``: K8 and K9 in bf16 storage (``spatial_down_bf16_kernel``,
  ``spatial_up_bf16_kernel``): K8's output f2 a block ``kDown16F``, its
  threads ``kDown16Threads`` and blocks an SM ``kDown16Blocks``; K9's
  staged chunks a thread at once ``kUp16Items`` and blocks an SM
  ``kUp16Blocks``; the six map sites of the packed TDANet block (pool,
  select, nearest and their transposes at STFT 251 x 129, 64 channels) at
  bs 1 and 8, the launches from the wrappers' plan, held to the plain
  bf16 versions (two bf16 ulps: the error printed is the worst element's
  share of them) and timed by the profiler's device time a launch (CUDA
  events over back-to-back launches of a few-us kernel time the host).

- ``k2fwd16``: K2 forward in bf16 (``sru_hid_fwd_bf16_kernel``), its
  producer warps ``kFwd16Prod`` (the warp roles: copies and the product
  against one scan thread a unit and column) and the chunks its copies
  run ahead ``kFwd16Ahead`` (its ring's depth), then two launch choices
  that ``ops/sru_fused.k2_fwd_bf16_geometry`` otherwise makes, bt (the
  batch columns a block, against the unit split it implies; 0: the
  geometry's) and the chunk's columns (S bt; 0: the geometry's); the
  six RTFS-Net-4 forward sites (bs 1, 4, 8 at freq L 57 over B 125 bs and
  time L 118 over B 64 bs, H 32), serving, held to the plain bf16 version
  (the error printed is the worst element's share of two bf16 ulps) and
  timed by the profiler's device time a launch;
- ``pw16``: pw-wgrad on bf16 operands (``pw_wgrad16_kernel``), its
  positions a stage ``kPw16K``, ring ``kPw16Stages`` and blocks a cluster
  ``kPw16Cluster`` (whose tiles are summed into one partial); K6's and
  K7's dW at bs 1, 4 and 8, held to the plain version (1e-4), timed with
  the partials' sum by the profiler's device time;
- ``k4fwd16``: K4's bf16 forward (``sru_rec_fwd16_kernel``), the groups
  its copies run ahead ``kRec16Ahead`` (at most 3: a block's rings fit
  the default 48 KB of shared memory); the six uni sites with c, as
  ``k2fwd16``;
- ``k3fwd16``: K3 forward in bf16 (``convt1d_tm_fwd_bf16_kernel``), its
  ring depth in passes ``kFwd16Stages``, then the column tile and the
  output channels a block (0: the geometry's,
  ``ops/convt_tm.fwd_bf16_geometry``); the same six sites (2H 64 -> 64
  channels, 8 taps), as ``k2fwd16``.

Each variant is built from a copy of ``csrc/`` with the constants
replaced, into ``rtfs_tpu_torch/_build/variants/`` (every nvcc at once),
then runs in a process of its own (loaded into one process beside the
library built from the same source, a variant's outputs came out wrong):
checked, then timed with CUDA events, the variants in turns and then in
reverse order. Every site prints its error as a fraction of its output's
max (``maps16``: of two bf16 ulps); the run fails if one is above 1e-4
(``maps16``: 1). Usage::

    python3 tools/kernel_variants.py scan [--variants 8:1 8:2 12:2]
    python3 tools/kernel_variants.py unproj [--variants 128:3:1 64:3:2]
    python3 tools/kernel_variants.py pw_wgrad [--variants 128:3:1:64
        128:3:100000:64]
    python3 tools/kernel_variants.py maps16 [--variants 16:128:6:2:6
        16:128:6:4:4]
    python3 tools/kernel_variants.py k2fwd16 [--variants 6:2:0:0 4:2:0:0
        6:3:0:0 6:2:1:0]
    python3 tools/kernel_variants.py k3fwd16 [--variants 3:0:0 2:0:0
        3:32:64 3:16:64]
    python3 tools/kernel_variants.py pw16 [--variants 64:4:2 128:2:2]
    python3 tools/kernel_variants.py k4fwd16 [--variants 3 2 1]
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

from rtfs_tpu_torch.ops import kernel_lib  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
TOL = 1e-4  # of each output's max, every site


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).cuda()


def _err(got, want) -> float:
    """The largest error of the outputs as a fraction of its plain
    version's max."""
    return max((g.double() - w.double()).abs().max().item()
               / w.abs().max().item() for g, w in zip(got, want))


def scan_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of the backward scan: K1 and K4
    backward at the freq and time sites."""
    from rtfs_tpu_torch.ops import sru_fused, sru_pallas

    rng, h = np.random.default_rng(0), 32
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for site, (T, B) in {"freq": (57, 500), "time": (118, 256)}.items():
        g1 = sru_fused.scan_bwd_geometry(T, h, B, 2)
        u_f, u_r = _t(rng, (T, 4 * h, B)), _t(rng, (T, 4 * h, B))
        vb, c_f, c_r = _t(rng, (8, h), 0.3), _t(rng, (T, h, B)), \
            _t(rng, (T, h, B))
        dh_f, dh_r = _t(rng, (T, h, B)), _t(rng, (T, h, B))
        du_f, du_r = torch.empty_like(u_f), torch.empty_like(u_r)
        part1 = torch.empty(g1["parts"], 8, h, device="cuda")
        args1 = [a.data_ptr() for a in (u_f, u_r, vb, c_f, c_r, dh_f, dh_r,
                                        du_f, du_r, part1)]

        def k1(args=args1, g=g1, T=T, B=B):
            st = libs["sru_fused"].sru_dual_recurrence_bwd(
                *args, T, h, B, g["cols"], g["units"], stream)
            assert st == 0, st

        plain1 = functools.partial(sru_fused.sru_dual_recurrence_bwd_plain,
                                   u_f, u_r, vb, c_f, c_r, dh_f, dh_r)
        g4 = sru_fused.scan_bwd_geometry(T, h, B, 1)
        u, x, vb4 = _t(rng, (T, 3 * h, B)), _t(rng, (T, h, B)), \
            _t(rng, (4, h), 0.3)
        c, dh = _t(rng, (T, h, B)), _t(rng, (T, h, B))
        du, dx = torch.empty_like(u), torch.empty_like(x)
        part4 = torch.empty(g4["parts"], 4, h, device="cuda")
        args4 = [a.data_ptr() for a in (u, x, vb4, c, dh, du, dx, part4)]

        def k4(args=args4, g=g4, T=T, B=B):
            st = libs["sru_pallas"].sru_recurrence_bwd(
                *args, T, h, B, 0, g["cols"], g["units"], stream)
            assert st == 0, st

        plain4 = functools.partial(sru_pallas.sru_recurrence_bwd_plain, u, x,
                                   vb4, c, dh)
        for kernel, fn, plain, got, dirs in (
                ("K1", k1, plain1, (du_f, du_r, part1), 2),
                ("K4", k4, plain4, (du, dx, part4), 1)):
            name = f"{kernel} backward {site} T={T} B={B}"
            out[name] = (fn, lambda p=plain, o=got: _err(
                (*o[:-1], o[-1].sum(0)), p()),
                40 * T * h * B * dirs / HBM_BYTES_PER_S * 1e6)
    return out


def unproj_sites(libs, values) -> dict:
    """{site: (launch, check, None)} of K7: the forward at bs 1 and 8, K6's
    dx at bs 4; its blocks from the variant's tile and blocks an SM."""
    from rtfs_tpu_torch.ops import packed_tf as P

    m_tile, _, per_sm = values
    T, F, C, CB = 251, 129, 64, 256
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for site, bs in {"bs1 residual": 1, "bs8 residual": 8,
                     "bs4 K6 dx": 4}.items():
        xp = _t(rng, (bs, T, F * C))
        if site.endswith("dx"):
            w, b = _t(rng, (C, CB), CB ** -0.5), None
        else:
            w, b = _t(rng, (CB, C), C ** -0.5).t(), _t(rng, (CB,))
        o = torch.empty(bs, CB, T, F, device="cuda")
        tiles, n_tiles = bs * -(-(T * F) // m_tile), -(-CB // P.PROJ_N)
        blocks = max(1, min(tiles, per_sm * kernel_lib.SMS // n_tiles))

        def call(xp=xp, w=w, b=b, o=o, bs=bs, blocks=blocks):
            st = libs["packed_tf"].pw_unproj_packed_fwd(
                xp.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), o.data_ptr(), bs,
                T * F, C, CB, *w.stride(), blocks, stream)
            assert st == 0, st

        out[site] = (call, lambda xp=xp, w=w, b=b, o=o: _err(
            (o,), (P.pw_unproj_packed_plain(xp, w, b, F),)), None)
    return out


def pw_wgrad_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of pw-wgrad: K6's dW (x4 planar,
    g packed) and K7's (xp packed, g planar) at bs 4, its chunks from the
    variant's tile; then K6's dW of all-positive inputs, a batch row one
    chunk, against float64."""
    from rtfs_tpu_torch.ops import packed_tf as P

    rows, _, _, k = values
    T, F, C, CB, bs = 251, 129, 64, 256, 4
    m = T * F
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    geo = P.pw_wgrad_geometry(bs, m, CB, C, rows=rows, k=k)
    part = torch.empty(max(geo["parts"], bs), CB * C, device="cuda")
    bound = 4 * bs * m * (CB + C) / HBM_BYTES_PER_S * 1e6
    out = {}
    for site, planar, chunk, parts in (
            ("bs4 K6 dW", True, geo["chunk"], geo["parts"]),
            ("bs4 K7 dW", False, geo["chunk"], geo["parts"]),
            ("bs4 K6 dW positive, a chunk a row", True, -(-m // k) * k, bs)):
        four, packed = _t(rng, (bs, CB, T, F)), _t(rng, (bs, T, F * C))
        if "positive" in site:
            four, packed = four.abs(), packed.abs()
        a, g = (four, packed) if planar else (packed, four)
        o = torch.empty(CB, C, device="cuda") if planar else \
            torch.empty(C, CB, device="cuda")
        ca, cb = o.shape

        def call(a=a, g=g, o=o, ca=ca, cb=cb, planar=planar, chunk=chunk,
                 parts=parts):
            st = libs["packed_tf"].pw_packed_wgrad(
                a.data_ptr(), g.data_ptr(), part.data_ptr(), o.data_ptr(),
                bs, m, ca, cb, int(planar), chunk, parts, stream)
            assert st == 0, st

        out[site] = (call, lambda a=a, g=g, o=o: _err(
            (o,), (P.pw_packed_wgrad_plain(a.double(), g.double()),)), bound)
    return out


def maps16_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of K8 and K9 in bf16 at the six
    map sites, bs 1 and 8, through the C entries with the wrappers' plan;
    the check the worst element's share of two bf16 ulps."""
    from chip_smoke import _map_cost
    from rtfs_tpu_torch.ops import packed_tf as P

    T, F, C, K = 251, 129, 64, 4
    T2, F2 = (T - 2) // 2 + 1, (F - 2) // 2 + 1
    t_conv, f_conv = P.dw_geometry(T, F, K, K, (1, 1), (1, 1))
    pool = P.cached_map("pool", T, T2, F, F2)
    sel = P.cached_map("select", t_conv, T2, f_conv, F2)
    up = P.cached_map("nearest", T2, T, F2, F)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    bf = torch.bfloat16
    out = {}
    for bs in (1, 8):
        for site, up_, smap, shape in (
                ("pool", False, pool, (bs, T, F * C)),
                ("select", False, sel, (bs, t_conv, f_conv * C)),
                ("nearest", True, up, (bs, C, T2, F2)),
                ("transposed nearest", False, up.transposed(F2),
                 (bs, T, F * C)),
                ("transposed pool", True, pool.transposed(F),
                 (bs, C, T2, F2)),
                ("transposed select", True, sel.transposed(f_conv),
                 (bs, C, T2, F2))):
            x = _t(rng, shape).to(bf)
            if up_:
                o = torch.empty(bs, smap.t_out, smap.f_out * C, device=dev,
                                dtype=bf)
                want = P.spatial_up_packed_plain(x, smap)
                ptrs, ints = smap.launch_args(True, C, shape[3], dev, bf, bs)
                fn = libs["packed_tf"].spatial_up_packed_fwd_bf16
            else:
                o = torch.empty(bs, C, smap.t_out, smap.f_out, device=dev,
                                dtype=bf)
                want = P.spatial_down_packed_plain(x, smap, C)
                ptrs, ints = smap.launch_args(False, C, shape[2] // C, dev,
                                              bf)
                fn = libs["packed_tf"].spatial_down_packed_fwd_bf16
            nbytes = _map_cost(smap, C, bs, elem=2)[0]

            def call(fn=fn, x=x, o=o, ptrs=ptrs, ints=ints, bs=bs):
                st = fn(x.data_ptr(), o.data_ptr(), *ptrs, bs, *ints, stream)
                assert st == 0, st

            def check(o=o, want=want):
                g, w = o.float(), want.float()
                return ((g - w).abs() / (2.0 ** -7 * torch.clamp(
                    w.abs(), min=2.0 ** -6))).max().item()

            out[f"bs{bs} {site}"] = (call, check,
                                     nbytes / HBM_BYTES_PER_S * 1e6)
    return out


# the six forward sites of the bf16 K2 and K3: (L, B per batch item)
FWD16_SITES = {"freq": (57, 125), "time": (118, 64)}


def _bf16_ulp_share(got, want) -> float:
    g, w = got.float(), want.float()
    return ((g - w).abs() / (2.0 ** -7 * torch.clamp(
        w.abs(), min=2.0 ** -6))).max().item()


def k2fwd16_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of the bf16 K2 forward at the six
    sites, through its C entry at the variant's bt and chunk columns; the
    check the worst element's share of two bf16 ulps."""
    from rtfs_tpu_torch.ops import sru_fused as S

    prod, ahead, bt, cols = values
    S.FWD16_PROD, S.FWD16_AHEAD = prod, ahead
    h, rng = 32, np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for bs in (1, 4, 8):
        for site, (T, per) in FWD16_SITES.items():
            B = bs * per
            x_f, x_r = (_t(rng, (T, h, B), 0.5).bfloat16() for _ in range(2))
            wt = _t(rng, (6 * h, 2 * h), (2 * h) ** -0.5).bfloat16()
            vb = _t(rng, (8, h), 0.3).bfloat16()
            h_f, h_r = torch.empty_like(x_f), torch.empty_like(x_r)
            geo = S.k2_fwd_bf16_geometry(T, h, B, bt=bt, cols=cols)

            def call(x_f=x_f, x_r=x_r, wt=wt, vb=vb, h_f=h_f, h_r=h_r,
                     geo=geo, T=T, B=B):
                st = libs["sru_fused"].sru_hidden_layer_fwd_bf16(
                    x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(),
                    vb.data_ptr(), h_f.data_ptr(), h_r.data_ptr(), None,
                    None, T, h, B, geo["bt"], geo["steps"], geo["units"], 0,
                    stream)
                assert st == 0, st

            def check(x_f=x_f, x_r=x_r, wt=wt, vb=vb, h_f=h_f, h_r=h_r):
                want = S.sru_hidden_layer_plain(x_f, x_r, wt, vb)
                return max(_bf16_ulp_share(g, w)
                           for g, w in zip((h_f, h_r), want))

            nbytes = 2 * (4 * T * h * B + wt.numel() + vb.numel())
            out[f"bs{bs} {site} L={T} B={B}"] = (
                call, check, nbytes / HBM_BYTES_PER_S * 1e6,
                f"bt {geo['bt']} units {geo['units']} cols {geo['cols']} "
                f"blocks {geo['blocks']}")
    return out


def k3fwd16_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of the bf16 K3 forward at the six
    sites, through its C entry at the variant's ring depth and tile."""
    from rtfs_tpu_torch.ops import convt_tm as K

    stages, nc, mb = values
    K.FWD16_STAGES = stages
    c, k, rng = 64, 8, np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for bs in (1, 4, 8):
        for site, (L, per) in FWD16_SITES.items():
            B = bs * per
            x = _t(rng, (L, c, B)).bfloat16()
            w = _t(rng, (k, c, c), (c * k) ** -0.5).bfloat16()
            o = torch.empty(L + k - 1, c, B, device="cuda",
                            dtype=torch.bfloat16)
            geo = K.fwd_bf16_geometry(L, c, c, k, B, nc, mb)

            def call(x=x, w=w, o=o, geo=geo, L=L, B=B):
                st = libs["convt_tm"].convt1d_ola_tm_fwd_bf16(
                    x.data_ptr(), w.data_ptr(), o.data_ptr(), None, L, c, c,
                    k, B, geo["nc"], geo["mb"], geo["ci_slice"],
                    geo["blocks"], stream)
                assert st == 0, st

            def check(x=x, w=w, o=o):
                return _bf16_ulp_share(o, K.convt1d_ola_tm_plain(x, w))

            nbytes = 2 * (L * c * B + w.numel() + (L + k - 1) * c * B)
            out[f"bs{bs} {site} L={L} B={B}"] = (
                call, check, nbytes / HBM_BYTES_PER_S * 1e6,
                f"nc {geo['nc']} mb {geo['mb']} blocks "
                f"{geo['blocks']}x{geo['grid'][2]}")
    return out


def pw16_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of pw-wgrad on bf16 operands
    (``pw_wgrad16_kernel`` and its sum): K6's dW (x4 planar, g packed) and
    K7's (xp packed, g planar) at bs 1, 4 and 8, the chunks from the
    variant's positions a stage and cluster; held to the plain version
    (1e-4 of max|dW|) beside the bf16 bytes bound."""
    from rtfs_tpu_torch.ops import packed_tf as P

    k, _, cluster = values
    T, F, C, CB = 251, 129, 64, 256
    m = T * F
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for bs in (1, 4, 8):
        geo = P.pw_wgrad16_geometry(bs, m, CB, C, k=k, cluster=cluster)
        part = torch.empty(geo["parts"], CB * C, device="cuda")
        bound = 2 * bs * m * (CB + C) / HBM_BYTES_PER_S * 1e6
        four = _t(rng, (bs, CB, T, F)).to(torch.bfloat16)
        packed = _t(rng, (bs, T, F * C)).to(torch.bfloat16)
        for site, planar in ((f"bs{bs} K6 dW", True),
                             (f"bs{bs} K7 dW", False)):
            a, g = (four, packed) if planar else (packed, four)
            o = torch.empty((CB, C) if planar else (C, CB), device="cuda")
            ca, cb = o.shape

            def call(a=a, g=g, o=o, ca=ca, cb=cb, planar=planar, bs=bs,
                     chunk=geo["chunk"], parts=geo["parts"], part=part):
                st = libs["packed_tf"].pw_packed_wgrad_bf16(
                    a.data_ptr(), g.data_ptr(), part.data_ptr(),
                    o.data_ptr(), bs, m, ca, cb, int(planar), chunk, parts,
                    stream)
                assert st == 0, st

            out[site] = (call, lambda a=a, g=g, o=o: _err(
                (o,), (P.pw_packed_wgrad_plain(a, g),)), bound)
    return out


def k4fwd16_sites(libs, values) -> dict:
    """{site: (launch, check, bound us)} of K4's bf16 forward with c
    (``sru_rec_fwd16_kernel<true>``) at the six uni sites (bs 1, 4, 8;
    freq T 57 over B 125 bs, time T 118 over B 64 bs; H 32), held to the
    plain bf16 version (the worst element's share of two bf16 ulps)."""
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf, hd = torch.bfloat16, 32
    vb = _t(rng, (4, hd), 0.3).to(bf)
    out = {}
    for bs in (1, 4, 8):
        for site, (T, per) in (("freq", (57, 125)), ("time", (118, 64))):
            B = bs * per
            u, x = _t(rng, (T, 3 * hd, B)).to(bf), _t(rng, (T, hd, B)).to(bf)
            h, c = torch.empty_like(x), torch.empty_like(x)
            geo = S.k4_fwd_geometry(T, hd, B, 2)
            want = S.sru_recurrence_plain(u.cpu(), x.cpu(), vb.cpu(),
                                          with_c=True)

            def call(u=u, x=x, h=h, c=c, T=T, B=B, geo=geo):
                st = libs["sru_pallas"].sru_recurrence_fwd_bf16(
                    u.data_ptr(), x.data_ptr(), vb.data_ptr(), h.data_ptr(),
                    c.data_ptr(), T, hd, B, 0, geo["cols"], geo["units"],
                    stream)
                assert st == 0, st

            def check(h=h, c=c, want=want):
                return max(_bf16_ulp_share(g.cpu(), w)
                           for g, w in zip((h, c), want))

            out[f"bs{bs} {site} T={T} B={B}"] = (
                call, check, 2 * T * B * 6 * hd / HBM_BYTES_PER_S * 1e6)
    return out


def device_ms(fn, parts, iters: int = 50) -> float:
    """The profiler's device ms a call of the kernels whose names hold
    one of ``parts``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(float(e.self_device_time_total) for e in prof.key_averages()
             if any(p in e.key for p in parts))
    return us / iters / 1e3


# kernel: (source whose constants change, constants, libraries built from
# the copy, a part of the kernel's name in ptxas' report, the sites,
# default variants, the error a site may have, the kernels' names to time
# by the profiler or None for CUDA events[, launch choices after the
# constants in a variant, passed to the sites only])
KERNELS = {
    "scan": ("sru_scan.cuh", ("kScanAhead", "kScanGroup"),
             ("sru_fused", "sru_pallas"), "sru_scan_bwd", scan_sites,
             ["8:1", "8:2", "12:1", "12:2", "16:1", "16:2"], TOL, None),
    "unproj": ("packed_tf.cu", ("kUnprojM", "kUnprojStages",
                                "kUnprojBlocks"),
               ("packed_tf",), "pw_unproj", unproj_sites,
               ["128:3:1", "128:4:1", "64:3:2", "64:4:2", "32:4:4"], TOL,
               None),
    "pw_wgrad": ("packed_tf.cu", ("kPwRows", "kPwStages", "kPwFlush",
                                  "kPwK"),
                 ("packed_tf",), "pw_wgrad", pw_wgrad_sites,
                 ["128:3:1:64", "128:2:1:64", "128:3:2:64", "128:3:1:32",
                  "64:3:1:64", "256:3:1:32"], TOL, None),
    "maps16": ("packed_tf.cu", ("kDown16F", "kDown16Threads",
                                "kDown16Blocks", "kUp16Items",
                                "kUp16Blocks"),
               ("packed_tf",), "spatial_", maps16_sites,
               ["16:128:6:2:6", "16:128:6:4:4", "32:256:4:2:6",
                "8:64:12:2:6"], 1.0,
               ("spatial_down_bf16_kernel", "spatial_up_bf16_kernel")),
    "k2fwd16": ("sru_fused.cu", ("kFwd16Prod", "kFwd16Ahead"), ("sru_fused",),
                "sru_hid_fwd_bf16_kernel", k2fwd16_sites,
                ["6:2:0:0", "4:2:0:0", "8:2:0:0", "6:3:0:0", "6:2:1:0"], 1.0,
                ("sru_hid_fwd_bf16_kernel",), 2),
    "pw16": ("packed_tf.cu", ("kPw16K", "kPw16Stages", "kPw16Cluster"),
             ("packed_tf",), "pw_wgrad16", pw16_sites,
             ["64:4:2", "64:4:1", "64:4:4", "64:4:8", "64:3:2", "128:2:2",
              "32:8:2"], TOL, ("pw_wgrad16_kernel", "sum_partials_kernel")),
    "k4fwd16": ("sru_pallas.cu", ("kRec16Ahead",), ("sru_pallas",),
                "sru_rec_fwd16", k4fwd16_sites, ["3", "2", "1"], 1.0,
                ("sru_rec_fwd16_kernel",)),
    "k3fwd16": ("convt_tm.cu", ("kFwd16Stages",), ("convt_tm",),
                "convt1d_tm_fwd_bf16", k3fwd16_sites,
                ["3:0:0", "2:0:0", "3:32:64", "3:16:64"], 1.0,
                ("convt1d_tm_fwd_bf16_kernel",), 2),
}


def _root(kernel: str, v: str) -> str:
    return os.path.join(kernel_lib.BUILD_DIR, "variants", kernel,
                        v.replace(":", "_"))


def _launch_choices(kernel: str) -> int:
    row = KERNELS[kernel]
    return row[8] if len(row) > 8 else 0


def _values(kernel: str, v: str) -> tuple:
    values = tuple(int(a) for a in v.split(":"))
    if len(values) != len(KERNELS[kernel][1]) + _launch_choices(kernel):
        raise ValueError(f"{kernel} variant {v}: give "
                         f"{':'.join(KERNELS[kernel][1])} and "
                         f"{_launch_choices(kernel)} launch choices")
    return values


def build(kernel: str, v: str) -> list:
    """Start nvcc for each library of one variant; returns [(process,
    library path)]."""
    source, consts, libs = KERNELS[kernel][:3]
    root = _root(kernel, v)
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kernel_lib.CSRC_DIR, csrc)
    path = os.path.join(csrc, source)
    with open(path) as f:
        src = f.read()
    for name, value in zip(consts, _values(kernel, v)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    with open(path, "w") as f:
        f.write(src)
    out = []
    for name in libs:
        lib = os.path.join(root, f"lib{name}.so")
        cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-o", lib,
               os.path.join(csrc, f"{name}.cu")]
        out.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib))
    return out


def load(kernel: str, v: str) -> dict:
    libs = {}
    for name in KERNELS[kernel][2]:
        lib = ctypes.CDLL(os.path.join(_root(kernel, v), f"lib{name}.so"))
        for fn, (n_ptr, n_int) in kernel_lib._SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def worker(kernel: str, v: str) -> None:
    """One variant in this process: each site checked against the plain
    version, then timed; prints one JSON line {site: [ms, bound us, error
    as a fraction of the output's max]}."""
    sites = KERNELS[kernel][4](load(kernel, v), _values(kernel, v))
    parts = KERNELS[kernel][7]
    res = {}
    for site, (call, check, bound_us, *note) in sites.items():
        call()
        torch.cuda.synchronize()
        err = check()
        ms = event_ms(call) if parts is None else device_ms(call, parts)
        res[site] = [ms, bound_us, err, *note]
    print(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--variants", nargs="+")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        worker(args.kernel, args.worker)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    variants = args.variants or KERNELS[args.kernel][5]
    entry_part = KERNELS[args.kernel][3]
    procs = {v: build(args.kernel, v) for v in variants}  # all nvcc at once
    for v, built in procs.items():
        for proc, path in built:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {path}:\n{log}")
            entry = ""
            for ln in log.splitlines():  # ptxas names the entry, then its use
                if "Compiling entry function" in ln:
                    entry = ln
                elif ("registers" in ln or "spill" in ln) and \
                        entry_part in entry:
                    print(f"variant {v} {os.path.basename(path)}: "
                          f"{ln.split(':', 1)[-1].strip()}")
    times = {v: [] for v in variants}
    for order in (variants, variants[::-1]):  # in turns, then back
        for v in order:
            run = subprocess.run([sys.executable, __file__, args.kernel,
                                  "--worker", v], capture_output=True,
                                 text=True, timeout=300)
            if run.returncode != 0:
                raise RuntimeError(f"variant {v}:\n{run.stderr[-3000:]}")
            times[v].append(json.loads(run.stdout.strip().splitlines()[-1]))
    consts = ":".join(KERNELS[args.kernel][1]
                      + ("launch",) * _launch_choices(args.kernel))
    tol = KERNELS[args.kernel][6]
    failed = 0
    for site in times[variants[0]][0]:
        for v in variants:
            us = " / ".join(f"{1e3 * run[site][0]:.2f}" for run in times[v])
            bound = times[v][0][site][1]
            err = max(run[site][2] for run in times[v])
            failed += not err <= tol
            note = times[v][0][site][3:]
            print(f"{args.kernel} {consts}={v} {site}"
                  + (f" ({note[0]})" if note else "") + f": us a launch {us}"
                  + ("" if bound is None else f" (bound {bound:.2f}, bytes)")
                  + f"; error {err:.3e}, "
                  + ("held" if err <= tol else "FAILS") + f" {tol:.0e}; "
                  + card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
