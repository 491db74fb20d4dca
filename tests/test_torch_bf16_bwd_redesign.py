"""The bf16 backward of K3 and K2 as the redesigned kernels compute it, on
the CPU: the decompositions they rest on, done in plain torch, against the
port's plain bf16 backwards and rtfs_tpu's Pallas VJPs in interpret mode,
and the launch geometries of ``ops/convt_tm.bwd_bf16_geometry`` and
``ops/sru_fused.k2_bwd_bf16_geometry``.

- K3's bf16 backward (``convt1d_tm_bwd_bf16_kernel``) takes dx and dW
  from one window of g rows: dx[l] sums W[j]^T g[l + j] over the block's
  taps and output channels in k16 steps in float32 and rounds once (with
  K or C_out split over the grid, float32 partials summed in order, then
  rounded); dW sums k16 steps of 16 columns of one l (a ragged B
  zero-padded) over a run of l steps for each column tile, in passes added
  to a float32 partial, one partial a (run, tile), the partials in order,
  rounded once.
- K2's bf16 backward (``sru_hid_bwd_bf16_kernel``) walks each direction's
  reverse scan order a chunk of S steps at a time for a tile of bt batch
  columns and a slice of units: U = W_d X, the scan with dc carried from
  chunk to chunk, du in three bf16 parts, each direction's dx rounded
  apart (float32 partials over the unit slices summed first) and the two
  added in bf16, dW's chunk sums added to float32 sums, the batch tiles'
  partials summed in order and rounded once.

The gates are the card tests': two bf16 ulps (|diff| <= 2^-7 max(|ref|,
2^-6 max|ref|), K2's dx scaled by its three roundings) and a flat cosine
above 0.999 against float32. One torch thread; ~15 s alone.
"""

import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rtfs_tpu.ops import convt_tm as jconvt
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(rng, shape, scale=1.0):
    """bf16 values as a numpy bf16 array (JAX's input) and the same bits
    as a torch bf16 tensor (the port's)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _ulp_gate(got, want, what, scale=None):
    """|got - want| <= 2^-7 max(|want|, scale, 2^-6 max|want|) everywhere
    (``chip_smoke.bf16_grad_ulps``)."""
    g = torch.as_tensor(np.asarray(got, dtype=np.float32)).float()
    w = torch.as_tensor(np.asarray(want, dtype=np.float32)).float()
    mag = w.abs() if scale is None else torch.maximum(w.abs(), scale)
    bound = 2.0 ** -7 * torch.clamp(mag, min=2.0 ** -6 * w.abs().max())
    ratio = ((g - w).abs() / bound).max().item()
    assert ratio <= 1.0, (what, ratio)


def _cos(got, want):
    a = torch.cat([t.double().reshape(-1) for t in got])
    b = torch.cat([t.double().reshape(-1) for t in want])
    return (a @ b / (a.norm() * b.norm())).item()


# ---------------------------------------------------------------- K3


def k3_dx_in_windows(g, w, length):
    """K3's bf16 dx as ``convt1d_tm_bwd_bf16_kernel`` sums it: for each
    grid row (DW16_TAPS taps x DW16_OUT output channels), dx[l] = sum over
    its taps j and 16-channel k16 steps of W[j]^T g[l + j] in float32; one
    grid row rounds that once, several write float32 partials that are
    added in order and rounded once."""
    k, c_out, _ = w.shape
    gf, wf = g.float(), w.float()
    parts = []  # grid row y = (o0 / DW16_OUT) tap_tiles + j0 / DW16_TAPS
    for o0 in range(0, c_out, convt_tm.DW16_OUT):
        for j0 in range(0, k, convt_tm.DW16_TAPS):
            acc = 0
            for j in range(j0, min(k, j0 + convt_tm.DW16_TAPS)):
                for ob in range(o0, min(c_out, o0 + convt_tm.DW16_OUT), 16):
                    o = slice(ob, min(c_out, ob + 16))
                    acc = acc + torch.einsum("oi,lob->lib", wf[j, o],
                                             gf[j:j + length, o])
            parts.append(acc)
    geo = convt_tm.bwd_bf16_geometry(length, w.shape[2], c_out, k, g.shape[2])
    assert len(parts) == geo["dx_slices"]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(g.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,c_in,c_out,bsz,k", [(13, 16, 24, 5, 5),
                                                     (4, 8, 72, 3, 10)])
def test_k3_dx_in_windows_matches_plain_and_jax(dtype, length, c_in, c_out,
                                                bsz, k):
    """dx summed as the kernel sums it (one grid row, and C_out and K split
    over the grid) equals dx of the plain backward in float32 and, rounded
    once, in bf16; in bf16 also JAX's VJP (Pallas in interpret mode)."""
    rng = np.random.default_rng(0)
    x, tx = _bf(rng, (length, c_in, bsz))
    w, tw = _bf(rng, (k, c_out, c_in), 0.1)
    g, tg = _bf(rng, (length + k - 1, c_out, bsz), 0.1)
    tx, tw, tg = (t.to(dtype) for t in (tx, tw, tg))
    got = k3_dx_in_windows(tg, tw, length)
    dx = convt_tm.convt1d_ola_tm_bwd_plain(tg, tx, tw)[0]
    assert got.shape == dx.shape and got.dtype == dx.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, dx, atol=1e-5, rtol=0)
        return
    _ulp_gate(got.float(), dx.float(), "K3 dx in windows vs plain")
    _, vjp = jax.vjp(lambda a, b: jconvt.convt1d_ola_tm(a, b, True),
                     jnp.asarray(x), jnp.asarray(w))
    ref = vjp(jnp.asarray(g))[0]
    assert ref.dtype == jnp.bfloat16
    _ulp_gate(got.float(), ref, "K3 dx in windows vs JAX")


def k3_dw_in_k16_steps(g, x, k, lsteps, stage=convt_tm.DW16_PASS):
    """K3's bf16 dW as ``convt1d_tm_wgrad_bf16_kernel`` sums it: for each
    run of ``lsteps`` steps l (outer) and tile of 16 columns (inner), the
    block's k16 steps (16 columns of one l, zero past B) in passes of
    ``stage`` l steps, each pass's sum added to the block's float32
    partial, the partials added in that order and rounded once."""
    length, c_in, bsz = x.shape
    c_out = g.shape[1]
    nb = -(-bsz // 16)
    pad = nb * 16 - bsz
    gp = torch.nn.functional.pad(g.float(), (0, pad))
    xp = torch.nn.functional.pad(x.float(), (0, pad))
    out = torch.zeros(k * c_out, c_in)
    for l0 in range(0, length, lsteps):
        for b in range(nb):
            cols = slice(16 * b, 16 * b + 16)
            part = torch.zeros(k * c_out, c_in)
            for p0 in range(l0, min(l0 + lsteps, length), stage):
                acc = torch.zeros(k * c_out, c_in)
                for l in range(p0, min(p0 + stage, l0 + lsteps, length)):
                    slab = gp[l:l + k, :, cols].reshape(k * c_out, 16)
                    acc += slab @ xp[l, :, cols].T
                part += acc
            out += part
    return out.reshape(k, c_out, c_in).to(torch.bfloat16)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k", [(9, 16, 24, 21, 3),
                                                     (5, 8, 8, 32, 8)])
def test_k3_dw_in_k16_steps_matches_plain_and_jax(length, c_in, c_out, bsz,
                                                  k):
    """The dW decomposition, in the geometry's runs, in runs of one l and
    in one run of all of L, against the plain bf16 dW and JAX's VJP (two
    bf16 ulps)."""
    rng = np.random.default_rng(1)
    x, tx = _bf(rng, (length, c_in, bsz))
    w, tw = _bf(rng, (k, c_out, c_in), 0.1)
    g, tg = _bf(rng, (length + k - 1, c_out, bsz), 0.1)
    want = convt_tm.convt1d_ola_tm_bwd_plain(tg, tx, tw)[1]
    _, vjp = jax.vjp(lambda a, b: jconvt.convt1d_ola_tm(a, b, True),
                     jnp.asarray(x), jnp.asarray(w))
    ref = vjp(jnp.asarray(g))[1]
    geo = convt_tm.bwd_bf16_geometry(length, c_in, c_out, k, bsz)
    for lsteps in (geo["lsteps"], 1, length):
        got = k3_dw_in_k16_steps(tg, tx, k, lsteps, stage=2)
        _ulp_gate(got.float(), want.float(), f"K3 dW runs of {lsteps}")
        _ulp_gate(got.float(), ref, f"K3 dW runs of {lsteps} vs JAX")


# K3 sites: the bs-4 and bs-1 training sites (freq L 57 / B 125 per item,
# time L 118 / B 64), odd and small batches, wide channels on both sides,
# any k
K3_SITES = [(57, 64, 64, 500, 8), (118, 64, 64, 256, 8), (57, 64, 64, 125, 8),
            (118, 64, 64, 64, 8), (13, 32, 48, 17, 5), (57, 160, 64, 125, 8),
            (7, 72, 130, 40, 16), (1, 64, 64, 77, 8), (3, 96, 160, 3, 4)]


@pytest.mark.parametrize("length,c_in,c_out,bsz,k", K3_SITES)
def test_k3_bwd_bf16_geometry_covers_and_fits(length, c_in, c_out, bsz, k):
    """The blocks cover every (l, column tile) once a grid column and row,
    every input channel, tap and output channel once, about one block an
    SM; dx takes one float32 partial a grid row where there are several;
    the shared memory fits a block."""
    geo = convt_tm.bwd_bf16_geometry(length, c_in, c_out, k, bsz)
    nb, lsteps = -(-bsz // 16), geo["lsteps"]
    runs = -(-length // lsteps)
    assert (runs - 1) * lsteps < length <= runs * lsteps
    assert geo["chunks"] == nb * runs
    # every (l, column tile) once, in the partial z = run * nb + tile
    seen = sorted((l, z % nb) for z in range(geo["chunks"])
                  for l in range(z // nb * lsteps,
                                 min(length, (z // nb + 1) * lsteps)))
    assert seen == [(l, b) for l in range(length) for b in range(nb)]
    gx, gy, gz = geo["grid"]
    assert (gx - 1) * convt_tm.DW16_IN < c_in <= gx * convt_tm.DW16_IN
    taps, outs = -(-k // convt_tm.DW16_TAPS), -(-c_out // convt_tm.DW16_OUT)
    assert gy == geo["dx_slices"] == taps * outs
    # grid row y: taps (y % taps) * DW16_TAPS .., outputs (y // taps) * 64 ..
    seen = sorted((j, o) for y in range(gy)
                  for j in range(y % taps * 8, min(k, y % taps * 8 + 8))
                  for o in range(y // taps * 64, min(c_out, y // taps * 64
                                                     + 64)))
    assert seen == [(j, o) for j in range(k) for o in range(c_out)]
    assert gz == geo["chunks"]
    assert geo["dx_part"] == length * c_in * bsz
    # about one block an SM where the columns allow
    assert gx * gy * gz <= kernel_lib.SMS or runs == 1
    assert geo["smem"] == 2 * (16 * (31 * 64 + 24 * 32) + 8 * 64 * 40
                               + 16 * 16 * 24) == 141_312
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK


# ---------------------------------------------------------------- K2


def split3(v: torch.Tensor) -> tuple:
    """``split3`` of csrc/sru_fused.cu: v = hi + mid + lo, each bf16,
    hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)."""
    hi = v.to(torch.bfloat16).float()
    mid = (v - hi).to(torch.bfloat16).float()
    lo = (v - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def test_split3_keeps_float32():
    """The three parts keep a float32 value to 2^-24 of it (the kernel's
    du products: exact in float32 for each part)."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-30, 30, 100_000)))
                         .astype(np.float32))
    hi, mid, lo = split3(v)
    err = ((hi.double() + mid.double() + lo.double()) - v.double()).abs()
    assert (err <= 2.0 ** -24 * v.double().abs()).all()
    for p in (hi, mid, lo):
        assert torch.equal(p, p.to(torch.bfloat16).float())


def k2_bwd_chunked(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r, geo):
    """K2's bf16 backward as ``sru_hid_bwd_bf16_kernel`` decomposes it, in
    plain torch (float32 on the widened bf16 values): per direction, tile
    of ``bt`` batch columns and slice of ``units`` units, the steps in
    reverse scan order in chunks of ``steps``; returns (dx_f, dx_r, dwt,
    dvb) in bf16."""
    t_len, h, bsz = x_f.shape
    xf, xr, w, v, cf, cr, gf, gr = (t.float() for t in (
        x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r))
    x = torch.cat([xf, xr], dim=1)  # (T, 2H, B)
    bt, s_len, units = geo["bt"], geo["steps"], geo["units"]
    tiles, slices = -(-bsz // bt), -(-h // units)
    dxd = torch.zeros(slices, 2, t_len, 2 * h, bsz)
    dw_part = torch.zeros(tiles, 6 * h, 2 * h)
    dvb_part = torch.zeros(tiles, 8, h)
    for d, (cd, gd) in enumerate(((cf, gf), (cr, gr))):
        order = list(range(t_len - 1, -1, -1)) if d == 0 else list(
            range(t_len))
        for tile in range(tiles):
            b = slice(tile * bt, min(bsz, tile * bt + bt))
            for z in range(slices):
                j0 = z * units
                hs = min(units, h - j0)
                js = slice(j0, j0 + hs)
                rows = [(d * 3 + gate) * h + j0 + j for gate in range(3)
                        for j in range(hs)]
                wd = w[rows]  # (3 hs, 2H)
                v_f, v_r, b_f, b_r = (v[d * 4 + k, js, None] for k in range(4))
                dc = torch.zeros(hs, b.stop - b.start)
                acc = torch.zeros(4, hs, b.stop - b.start)
                dw_sum = torch.zeros(3 * hs, 2 * h)
                for n0 in range(0, t_len, s_len):
                    chunk = torch.zeros(3 * hs, 2 * h)
                    for ii in range(n0, min(n0 + s_len, t_len)):
                        t = order[ii]
                        xt = x[t, :, b]
                        u = wd @ xt
                        cp = (cd[order[ii + 1], js, b] if ii + 1 < t_len
                              else torch.zeros_like(dc))
                        ct, g = cd[t, js, b], gd[t, js, b]
                        xhw = x[t, d * h + j0:d * h + j0 + hs, b]
                        f = torch.sigmoid(u[hs:2 * hs] + v_f * cp + b_f)
                        r = torch.sigmoid(u[2 * hs:] + v_r * ct + b_r)
                        dm = g * (ct - xhw) * r * (1.0 - r)
                        dc = g * r + dm * v_r + dc
                        da = dc * (cp - u[:hs]) * f * (1.0 - f)
                        du = torch.cat([dc * (1.0 - f), da, dm])
                        acc += torch.stack([da * cp, dm * ct, da, dm])
                        dc = dc * f + da * v_f
                        parts = split3(du)[::-1]  # lo, mid, hi
                        dx = sum(wd.T @ p for p in parts)
                        dx[d * h + j0:d * h + j0 + hs] += g * (1.0 - r)
                        dxd[z, d, t, :, b] = dx
                        for p in parts:
                            chunk += p @ xt.T
                    dw_sum += chunk
                dw_part[tile, rows] = dw_sum
                dvb_part[tile, d * 4:d * 4 + 4, js] = acc.sum(-1)
    dxdir = dxd[0]
    for z in range(1, slices):
        dxdir = dxdir + dxd[z]
    r = dxdir.to(torch.bfloat16).float()
    dx = (r[0] + r[1]).to(torch.bfloat16)
    dwt, dvb = dw_part[0], dvb_part[0]
    for tile in range(1, tiles):
        dwt, dvb = dwt + dw_part[tile], dvb + dvb_part[tile]
    return (dx[:, :h], dx[:, h:], dwt.to(torch.bfloat16),
            dvb.to(torch.bfloat16))


def _k2_inputs(rng, t_len, h, bsz):
    x_f, tx_f = _bf(rng, (t_len, h, bsz), 0.5)
    x_r, tx_r = _bf(rng, (t_len, h, bsz), 0.5)
    wt, twt = _bf(rng, (6 * h, 2 * h), (2 * h) ** -0.5)
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    dh = [_bf(rng, (t_len, h, bsz), 0.1) for _ in range(2)]
    tvb = sru_fused.vb_pack(tv, tb)
    c = sru_fused.sru_hidden_layer_plain(tx_f, tx_r, twt, tvb, True)[2:]
    args = (tx_f, tx_r, twt, tvb, *c, dh[0][1], dh[1][1])
    return args, (x_f, x_r, wt, v, b, [d[0] for d in dh])


def _hold_k2(got, args, h, what):
    """The card test's gates: two bf16 ulps against the plain bf16
    backward (dx scaled by its three roundings), cosine 0.999 against the
    float32 plain backward on the widened values."""
    want = sru_fused.sru_hidden_layer_bwd_plain(*args)
    dxa, dxb = (t.to(torch.bfloat16).float().abs() for t in
                sru_fused.hidden_bwd_terms(*args)[:2])
    scales = (dxa[:, :h] + dxb[:, :h] + want[0].float().abs(),
              dxa[:, h:] + dxb[:, h:] + want[1].float().abs(), None, None)
    for i, (g, w, sc) in enumerate(zip(got, want, scales)):
        assert g.dtype == w.dtype == torch.bfloat16
        _ulp_gate(g.float(), w.float(), f"{what} output {i}", sc)
    f32 = sru_fused.sru_hidden_layer_bwd_plain(*(a.float() for a in args))
    assert _cos([g.float() for g in got], f32) > 0.999
    return scales


def test_k2_bf16_backward_in_chunks_matches_plain_and_jax():
    """The fused kernel's decomposition at a T over two of JAX's time
    chunks, an odd B over two batch tiles and several scan chunks, against
    the plain bf16 backward and ``jax.vjp`` of the Pallas op in interpret
    mode (dx, dW, d(v, b))."""
    t_len, h, bsz = jfused.T_CHUNK + 9, 8, 11
    rng = np.random.default_rng(3)
    args, (x_f, x_r, wt, v, b, dh) = _k2_inputs(rng, t_len, h, bsz)
    geo = dict(sru_fused.k2_bwd_bf16_geometry(t_len, h, bsz))
    geo.update(bt=8, steps=4)  # two tiles, eleven chunks
    got = k2_bwd_chunked(*args, geo)
    scales = _hold_k2(got, args, h, "K2 chunks")

    def f(x_f, x_r, wt, v, b):
        return jfused.sru_hidden_layer(x_f, x_r, wt, jfused._vb_pack(v, b),
                                       True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x_f, x_r, wt, v, b)))
    ref = vjp(tuple(jnp.asarray(d) for d in dh))
    ref_dvb = sru_fused.vb_pack(
        torch.from_numpy(np.asarray(ref[3], dtype=np.float32)),
        torch.from_numpy(np.asarray(ref[4], dtype=np.float32)))
    for i, (g, r) in enumerate(zip(got, (*ref[:3], ref_dvb))):
        sc = scales[i]
        if sc is not None:
            sc = torch.maximum(sc, torch.from_numpy(
                np.abs(np.asarray(r, dtype=np.float32))))
        _ulp_gate(g.float(), np.asarray(r, dtype=np.float32),
                  f"K2 chunks vs JAX output {i}", sc)


@pytest.mark.parametrize("t_len,h,bsz", [(9, 80, 5), (5, 48, 7)])
def test_k2_bf16_backward_in_unit_slices_matches_plain(t_len, h, bsz):
    """The decomposition with the units split over the grid (H 80: two
    slices, each a float32 partial of dx summed before the per-direction
    rounding) and at H 48 (one slice), in the geometry's tiles and
    chunks, against the plain bf16 backward."""
    rng = np.random.default_rng(4)
    args, _ = _k2_inputs(rng, t_len, h, bsz)
    geo = sru_fused.k2_bwd_bf16_geometry(t_len, h, bsz)
    assert geo["slices"] == (2 if h == 80 else 1)
    _hold_k2(k2_bwd_chunked(*args, geo), args, h, f"K2 H {h}")


# K2 sites: the bs-4 and bs-1 training sites, the card tests' odd and
# small shapes, H 48 / 80 / 300 (held, the units split over the grid), H
# 384 (the widest held), 385, 600 and 1024 (streamed)
K2_SITES = [(57, 32, 500), (118, 32, 256), (57, 32, 125), (118, 32, 64),
            (13, 8, 33), (5, 48, 7), (1, 32, 77), (37, 32, 131),
            (19, 80, 64), (57, 80, 125), (9, 300, 40), (57, 300, 125),
            (3, 384, 8), (3, 385, 8), (5, 600, 20), (3, 1024, 8)]


@pytest.mark.parametrize("t_len,h,bsz", K2_SITES)
def test_k2_bwd_bf16_geometry_covers_and_fits(t_len, h, bsz):
    """The blocks cover every batch column, unit and step once, one scan
    thread a (unit, column), a chunk whole k16 steps, the shared memory
    within a block's."""
    geo = sru_fused.k2_bwd_bf16_geometry(t_len, h, bsz)
    bt, s_len, units = geo["bt"], geo["steps"], geo["units"]
    assert bt in (8, 4, 2, 1) and units * bt <= sru_fused.BWD_THREADS
    assert geo["cols"] == s_len * bt and geo["cols"] in (16, 32, 64)
    assert geo["grid"] == (geo["tiles"], 2, geo["slices"])
    assert (geo["tiles"] - 1) * bt < bsz <= geo["tiles"] * bt
    assert (geo["slices"] - 1) * units < h <= geo["slices"] * units
    assert (geo["chunks"] - 1) * s_len < t_len <= geo["chunks"] * s_len
    assert geo["stream"] == (h > 384)
    assert geo["smem"] == sru_fused.k2_bwd_bf16_smem(h, geo["cols"], units,
                                                     bt, geo["stream"])
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    assert geo["vec"] == sru_fused.k2_bf16_vec(bt, bsz)


def test_k2_bwd_bf16_geometry_fills_the_card_at_the_training_sites():
    """At the bs-4 sites the grid fills the card once: bt 8 at the freq
    site (126 blocks, 8 chunks of 8 steps), bt 4 at the time site (128
    blocks, 8 chunks of 16) where bt 8 would make 64 blocks of 15 chunks;
    H 32 is one slice. Above H 384 not even 8 units' rows of W_d, X's two
    slots and the dW sums fit a block, and the kernel streams: its shared
    memory does not grow with H, so any H takes a geometry."""
    freq = sru_fused.k2_bwd_bf16_geometry(57, 32, 500)
    assert (freq["bt"], freq["grid"], freq["chunks"]) == (8, (63, 2, 1), 8)
    time_ = sru_fused.k2_bwd_bf16_geometry(118, 32, 256)
    assert (time_["bt"], time_["grid"], time_["chunks"]) == (4, (64, 2, 1), 8)
    limit = kernel_lib.SMEM_PER_BLOCK
    assert sru_fused.k2_bwd_bf16_smem(384, 16, 8, 1) <= limit
    assert sru_fused.k2_bwd_bf16_smem(385, 16, 8, 1) > limit
    for h in (385, 1024, 4096):
        geo = sru_fused.k2_bwd_bf16_geometry(3, h, 8)
        assert geo["stream"] and geo["smem"] <= limit
    assert (sru_fused.k2_bwd_bf16_smem(4096, 16, 64, 1, True)
            == sru_fused.k2_bwd_bf16_smem(8, 16, 64, 1, True))


def _source(name):
    with open(os.path.join(kernel_lib.CSRC_DIR, name)) as f:
        return f.read()


def _entry_params(src, fn):
    """(pointers, ints) of the C entry ``fn``, its stream left out."""
    body = src.split(f'extern "C" int {fn}(')[1].split(")")[0]
    params = [p.strip() for p in body.split(",")][:-1]
    return (sum(p.startswith(("const void*", "void*")) for p in params),
            sum(p.startswith("int ") for p in params))


def test_bf16_backward_constants_and_entries_match_the_sources():
    convt = _source("convt_tm.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", convt))
    for name, value in (("kDwTaps", convt_tm.DW16_TAPS),
                        ("kDwOut", convt_tm.DW16_OUT),
                        ("kDwIn", convt_tm.DW16_IN),
                        ("kDwPass", convt_tm.DW16_PASS),
                        ("kDwStages", convt_tm.DW16_STAGES),
                        ("kDwThreads", convt_tm.DW16_THREADS),
                        ("kDwDxRow", convt_tm.DW16_DXROW),
                        ("kFwdCols", convt_tm.FWD_COLS)):
        assert int(consts[name]) == value, name
    assert "constexpr int kDwWRow = kDwIn + 8;" in convt
    # dW: a warp a tap and 32 output channels; dx: a warp a step of the
    # pass and 16 input channels
    assert convt_tm.DW16_THREADS == 32 * convt_tm.DW16_TAPS * (
        convt_tm.DW16_OUT // 32) == 32 * convt_tm.DW16_PASS * (
            convt_tm.DW16_IN // 16)
    fused = _source("sru_fused.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", fused))
    assert int(consts["kBwdThreads"]) == sru_fused.BWD_THREADS
    assert int(consts["kBwdK"]) == sru_fused.BWD_K
    assert int(consts["kBwdStages"]) == sru_fused.BWD_STAGES
    for lib, src, fn in (("convt_tm", convt, "convt1d_ola_tm_bwd_bf16"),
                         ("sru_fused", fused, "sru_hidden_layer_bwd_bf16")):
        assert kernel_lib._SIGNATURES[lib][fn] == _entry_params(src, fn)
    # the launches a profile tells apart
    assert "convt1d_tm_bwd_bf16_kernel<<<" in convt
    assert "sru_hid_bwd_bf16_kernel<true>" in fused
    assert "sru_hid_bwd_bf16_kernel<false>" in fused
