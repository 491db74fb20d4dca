"""K8 ``spatial_down_packed`` and K9 ``spatial_up_packed`` in bf16 storage
(``spatial_{down,up}_bf16_kernel`` of ``csrc/packed_tf.cu``), on the CPU.

The walk: ``ops/packed_tf.map16_geometry`` gives the kernels their plan
(K8: blocks of ``DOWN16_F`` output f2 of one row; K9: ``row_runs``'s runs
split into blocks of ``fb`` output f, each block's staged input chunks
``fr`` and the tile's rows). These tests walk every block's threads as
the kernels do, with the constants parsed from the source, at the six
sites of the preset (251 x 129 x 64: the three maps and their transposes)
and at ragged geometries, and check that every output element is written
exactly once (a row with no source among them), that every tile value a
thread reads was staged and every input value read lies in the input,
that the 16-byte chunks start on 16-byte boundaries where the kernel
takes them whole (else value by value, up to the ragged end), that the
tile's accesses are at most two to a bank, and that the shared memory
fits a block (and a tile that does not is refused).

The sums: each kernel's order of sums, emulated in torch (float32 FMAs
as float64 products rounded once; K8 both sides in float32 and each
output rounded once; K9 the T side in float32, then each F source's term
rounded to bf16 and the terms added in bf16), against the plain bf16
versions at every site and against ``rtfs_tpu``'s ops (and their VJPs for
the transposed sites) in interpret mode at a small size, within two bf16
ulps. Torch runs on one thread; ~13 s alone, a third of it the JAX fixture.
"""

import functools
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops import packed_tf as JP
from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _const(name):
    return _source()[1][name]


def _sites(t, f):
    """The six (name, map, K9?, f_in, t_in) sites of a packed map of T x F
    and its stride-2 k-4 level, as the packed TDANet block builds them."""
    t2, f2 = (t - 2) // 2 + 1, (f - 2) // 2 + 1
    pool = P.cached_map("pool", t, t2, f, f2)
    sel = P.cached_map("select", t - 1, t2, f - 1, f2)
    up = P.cached_map("nearest", t2, t, f2, f)
    return [("pool", pool, False, f), ("select", sel, False, f - 1),
            ("nearest", up, True, f2),
            ("transposed nearest", up.transposed(f2), False, f),
            ("transposed pool", pool.transposed(f), True, f2),
            ("transposed select", sel.transposed(f - 1), True, f2)]


# (T, F, C): the preset (STFT 251 x 129, 64 channels), C and F sides not a
# multiple of 8, C 37, a single-row level
GEOMETRIES = [(251, 129, 64), (13, 7, 6), (21, 18, 37), (3, 5, 4)]
CASES = [(g, i) for g in GEOMETRIES for i in range(6)]
# element offsets of x and out from a 16-byte boundary: aligned, 2 bytes
# off, 8 bytes off (the card tests' inputs)
OFFSETS = (0, 1, 4)


def _ids(case):
    (t, f, c), i = case
    return f"{t}x{f}x{c}-{_sites(t, f)[i][0].replace(' ', '-')}"


def _r8(n):
    return -(-n // 8) * 8


def _cs(c):
    return _r8(c) + _const("kMap16Pad")


def _ways(words, width=1):
    """The most distinct shared words one bank serves in one access of a
    warp whose lanes touch ``words`` (each ``width`` consecutive words;
    16-byte accesses go a quarter warp at a time)."""
    lanes = np.asarray(words)
    phases = [lanes] if width == 1 else [lanes[i:i + 8]
                                         for i in range(0, len(lanes), 8)]
    worst = 0
    for ph in phases:
        w = np.unique((ph[:, None] + np.arange(width)[None, :]).ravel())
        worst = max(worst, np.bincount(w % 32).max())
    return worst


def _warps(n):
    """Items 0..n-1 as the warps that take them: 32 consecutive items."""
    return [slice(i, i + 32) for i in range(0, n, 32)]


def _walk_down(smap, c, f_in, x_off, out_off, check_banks=True):
    """K8 bf16 as spatial_down_bf16_kernel runs it, every block: returns
    the count of writes of every output (c, t2, f2)."""
    geo = P.map_geometry(smap, False, c, f_in, BF)
    fpb = _const("kDown16F")
    cs, cq = _cs(c), -(-c // 8)
    assert geo["smem"] == 4 * fpb * cs <= kernel_lib.SMEM_PER_BLOCK
    assert geo["grid"] == (-(-smap.f_out // fpb), smap.t_out)
    assert fpb % 8 == 0
    ts, tw = smap.compact_t()
    vec_in = c % 8 == 0 and x_off % 8 == 0
    vec_out = smap.f_out % 8 == 0 and out_off % 8 == 0
    written = np.zeros((c, smap.t_out, smap.f_out), np.int64)
    for j in range(geo["grid"][0]):
        f0 = j * fpb
        nfb = min(fpb, smap.f_out - f0)
        # in: item e -> (fl, q), q fastest; the tile's 8 channels at fl
        e = np.arange(nfb * cq)
        fl, q = e // cq, e % cq
        tile = np.zeros((fpb, cs), np.int64)
        for a, b in zip(fl, q):
            tile[a, 8 * b:8 * b + 8] += 1
        assert (tile[:nfb, :_r8(c)] == 1).all() and tile[nfb:].sum() == 0
        if check_banks:  # two float4 stores, a quarter warp at a time
            for w in _warps(len(e)):
                assert _ways(fl[w] * cs + 8 * q[w], 4) <= 2
        for f2 in range(f0, f0 + nfb):
            for u in range(smap.fs.shape[1]):
                if smap.fw[f2, u] != 0:
                    assert 0 <= smap.fs[f2, u] < f_in
        if vec_in:  # chunk (row, fs, q) starts on a 16-byte boundary
            starts = (x_off + (np.arange(smap.t_in)[:, None, None, None]
                               * f_in
                               + smap.fs[None, f0:f0 + nfb, :, None]) * c
                      + 8 * np.arange(cq)[None, None, None, :])
            assert (starts % 8 == 0).all()
        # out: item e -> (channel, chunk p), p fastest
        p8 = -(-nfb // 8)
        e = np.arange(c * p8)
        ch, p = e // p8, e % p8
        for cc, pp in zip(ch, p):
            n = min(8, nfb - 8 * pp)
            assert (tile[8 * pp:8 * pp + n, 8 * (cc // 8)] == 1).all()
            written[cc, :, f0 + 8 * pp:f0 + 8 * pp + n] += 1
            if vec_out:
                assert (out_off + (cc * smap.t_out * smap.f_out + f0
                                   + 8 * pp)) % 8 == 0
        if check_banks:
            for w in _warps(len(e)):
                for k in range(8):
                    assert _ways((8 * p[w] + k) * cs + ch[w]) <= 2
    rows = {int(r) for t2 in range(smap.t_out) for r in ts[t2][tw[t2] != 0]}
    assert all(0 <= r < smap.t_in for r in rows)
    return written


def _walk_up(smap, c, f_in, x_off, out_off, check_banks=True, b=1):
    """K9 bf16 as spatial_up_bf16_kernel runs it at batch ``b``, every
    block: returns the count of writes of every output (t, f, c)."""
    geo = P.map_geometry(smap, True, c, f_in, BF, b)
    cs, cq, nf = _cs(c), -(-c // 8), smap.fs.shape[1]
    rows, fb, fr = geo["rows"], geo["fb"], geo["fr"]
    assert geo["grid"] == (len(fr), len(rows) - 1)
    assert fb * (len(fr) - 1) < smap.f_out <= fb * len(fr)
    # enough blocks to fill the card, or blocks of 8 f at most
    blocks = len(fr) * (len(rows) - 1) * b
    assert blocks >= P.MAP16_BLOCKS or fb <= 8
    # and no more F blocks than that takes: one fewer would fall short
    if len(fr) > 1 and geo["smem"] <= kernel_lib.SMEM_PER_BLOCK // 2:
        assert (len(fr) - 1) * (len(rows) - 1) * b < P.MAP16_BLOCKS
    assert geo["tile_rows"] == 8 * fr[:, 1].max()
    assert geo["smem"] == 4 * (-(-2 * fb * nf // 4) * 4
                               + geo["tile_rows"] * cs)
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    ts, tw = smap.compact_t()
    vec_in = f_in % 8 == 0 and x_off % 8 == 0
    vec_out = c % 8 == 0 and out_off % 8 == 0
    written = np.zeros((smap.t_out, smap.f_out, c), np.int64)
    cg = -(-c // 16)
    for j, (lo, n8) in enumerate(fr):
        f0 = j * fb
        nfb = min(fb, smap.f_out - f0)
        # in: item e -> (channel, chunk p): lanes 16 channels x 2 chunks
        e = np.arange(32 * cg * ((n8 + 1) // 2))
        lane, grp = e & 31, e >> 5
        ch = (grp % cg) * 16 + (lane >> 1)
        p = (grp // cg) * 2 + (lane & 1)
        ok = (ch < c) & (p < n8)
        staged = np.zeros((8 * n8, cs), np.int64)
        for cc, pp in zip(ch[ok], p[ok]):
            staged[8 * pp:8 * pp + 8, cc] += 1
            assert 0 <= 8 * (lo + pp) < f_in  # the chunk starts in the row
            if vec_in:
                assert (x_off + cc * smap.t_in * f_in
                        + 8 * (lo + pp)) % 8 == 0
        assert (staged[:, :c] == 1).all() and staged[:, c:].sum() == 0
        if check_banks:
            for w in _warps(len(e)):
                m = ok[w]
                for k in range(8):
                    assert _ways((8 * p[w][m] + k) * cs + ch[w][m]) <= 2
        # out: item e -> (fl, q), q fastest, to every row of the run
        e = np.arange(nfb * cq)
        fl, q = e // cq, e % cq
        for a, b in zip(fl, q):
            f = f0 + a
            for u in range(nf):
                if smap.fw[f, u] == 0:
                    continue
                row = smap.fs[f, u] - 8 * lo
                assert 0 <= smap.fs[f, u] < f_in and 0 <= row < 8 * n8
                assert (staged[row, 8 * b:min(8 * b + 8, c)] == 1).all()
            if vec_out:
                assert (out_off + (f * c + 8 * b)) % 8 == 0
        if check_banks:  # two float4 reads of each source's row
            for w in _warps(len(e)):
                for u in range(nf):
                    reads = smap.fw[f0 + fl[w], u] != 0
                    src = smap.fs[f0 + fl[w], u][reads] - 8 * lo
                    if reads.any():
                        assert _ways(src * cs + 8 * q[w][reads], 4) <= 2
        for t0, t1 in zip(rows[:-1], rows[1:]):
            written[t0:t1, f0:f0 + nfb, :] += 1
    for t0, t1 in zip(rows[:-1], rows[1:]):
        assert 1 <= t1 - t0 <= P.MAP_ROWS
        for t in range(t0, t1):  # a run's rows share the T terms
            np.testing.assert_array_equal(ts[t], ts[t0])
            np.testing.assert_array_equal(tw[t], tw[t0])
            assert (ts[t][tw[t] != 0] < smap.t_in).all()
    return written


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bf16_blocks_write_every_output_once_from_staged_values(case):
    (t, f, c), i = case
    _, smap, up, f_in = _sites(t, f)[i]
    for k, (x_off, out_off) in enumerate(zip(OFFSETS, OFFSETS[::-1])):
        # the bank walk once
        if up:  # K9's plan at bs 1 and 8 (fewer, wider F blocks)
            for b in (1, 8):
                written = _walk_up(smap, c, f_in, x_off, out_off, k == 0, b)
                assert (written == 1).all()
        else:
            written = _walk_down(smap, c, f_in, x_off, out_off, k == 0)
            assert (written == 1).all()


def test_bf16_preset_plan_fills_the_card_and_fits():
    """At the preset, bs 1: K8 500 blocks, K9 625-750 (its runs split into
    3-5 blocks of output f), 3.7 or more for each of the 132 SMs; at bs 8
    K9 one block a run, all of F; every tile under 20 KB."""
    sites = {name: (smap, up, f_in)
             for name, smap, up, f_in in _sites(251, 129)}
    blocks = {}
    for name, (smap, up, f_in) in sites.items():
        for b in (1, 8):
            geo = P.map_geometry(smap, up, 64, f_in, BF, b)
            blocks[name, b] = geo["grid"][0] * geo["grid"][1] * b
            assert geo["smem"] <= 20_000, name
            if up and b == 8:
                assert geo["grid"][0] == 1 and geo["fb"] == smap.f_out
    assert blocks["pool", 1] == blocks["select", 1] == 4 * 125
    assert blocks["transposed nearest", 1] == 4 * 125
    assert blocks["nearest", 1] == 5 * 125  # 125 runs, fb 26
    assert blocks["transposed pool", 1] == 3 * 249  # runs of one row
    assert min(blocks.values()) >= 3.7 * kernel_lib.SMS
    geo = P.map_geometry(sites["nearest"][0], True, 64, 64, BF)
    assert geo["fb"] == 26 and geo["tile_rows"] == 24
    # the transposed select: rows and f blocks with no source, written 0
    smap = sites["transposed select"][0]
    _, tw = smap.compact_t()
    assert (tw[1::2] == 0).all() and (smap.fw[1::2] == 0).all()


def test_bf16_tiles_that_do_not_fit_are_refused():
    pool = P.cached_map("pool", 2, 1, 2, 1)
    # K8's tile is 16 f2 x C, K9's 8 staged f x C a chunk of sources
    for up, smap, f_in, c in ((False, pool, 2, 3000),
                              (True, pool.transposed(2), 1, 7000)):
        assert P.map_geometry(smap, up, c, f_in, BF)["smem"] <= \
            kernel_lib.SMEM_PER_BLOCK
        with pytest.raises(ValueError, match="shared memory"):
            P.map_geometry(smap, up, 2 * c, f_in, BF)
    # a wide span of sources in one block of output f: 8 f 128 apart
    up = P.cached_map("nearest", 2, 3, 65536, 512)
    with pytest.raises(ValueError, match="shared memory"):
        P.map_geometry(up, True, 64, 65536, BF)


def test_bf16_launch_args_match_the_c_entries_and_are_kept():
    smap = P.cached_map("nearest", 6, 13, 3, 7)
    cpu = torch.device("cpu")
    for up, fn in ((True, "spatial_up_packed_fwd_bf16"),
                   (False, "spatial_down_packed_fwd_bf16")):
        f_in = 3 if up else 7
        ptrs, ints = smap.launch_args(up, 5, f_in, cpu, BF)
        assert smap.launch_args(up, 5, f_in, cpu, BF)[0] is ptrs
        assert smap.launch_args(up, 5, f_in, cpu)[0] is not ptrs  # f32's
        assert (2 + len(ptrs), 1 + len(ints)) == \
            kernel_lib._SIGNATURES["packed_tf"][fn]
        if up:
            geo = P.map_geometry(smap, True, 5, f_in, BF)
            assert ints[-4:] == (len(geo["rows"]) - 1, len(geo["fr"]),
                                 geo["fb"], geo["tile_rows"])


def test_bf16_constants_match_the_source():
    src, consts = _source()
    assert (consts["kDown16F"], consts["kMap16Pad"]) == \
        (P.DOWN16_F, P.MAP16_PAD)
    assert "__launch_bounds__(kDown16Threads, kDown16Blocks)" in src
    assert "__launch_bounds__(kUp16Threads, kUp16Blocks)" in src
    assert "dim3((F_out + kDown16F - 1) / kDown16F, T_out, B)" in src
    assert "dim3(nF, G, B), kUp16Threads" in src
    # the entries launch the new kernels; the float32 ones keep theirs
    down = src.split('extern "C" int spatial_down_packed_fwd_bf16')[1]
    assert down.split("}")[0].count("launch_spatial_down_bf16(") == 1
    up = src.split('extern "C" int spatial_up_packed_fwd_bf16')[1]
    assert up.split("}")[0].count("launch_spatial_up_bf16(") == 1
    assert "spatial_down_kernel<1, 1>" in src and \
        "spatial_up_kernel<1, 1>" in src


# ------------------------------------------------------------- the sums


def _fma(a, b, c):
    """float32 fmaf(a, b, c): the exact product and sum, rounded once (as
    float64 and then float32; a bf16 times float32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _rbf(v):
    return v.to(BF).float()


def emulate_down(xp, smap, c):
    """K8 bf16's sums: for each T term i (weight != 0) s = fma over the F
    terms (weight != 0) from 0, acc = fma(wt, s, acc), rounded once."""
    b, t, n = xp.shape
    x = xp.float().reshape(b, t, n // c, c)
    ts, tw = smap.compact_t()
    fs, fw = torch.from_numpy(smap.fs).long(), torch.from_numpy(smap.fw)
    acc = torch.zeros(b, smap.t_out, smap.f_out, c)
    for i in range(ts.shape[1]):
        wt = torch.from_numpy(tw[:, i])
        rows = x[:, torch.from_numpy(ts[:, i]).long()]  # (b, T_out, F_in, c)
        s = torch.zeros_like(acc)
        for u in range(fs.shape[1]):
            w = fw[:, u]
            v = rows[:, :, fs[:, u]]
            s = torch.where((w != 0)[None, None, :, None],
                            _fma(w[None, None, :, None], v, s), s)
        acc = torch.where((wt != 0)[None, :, None, None],
                          _fma(wt[None, :, None, None], s, acc), acc)
    return acc.permute(0, 3, 1, 2).to(BF)


def emulate_up(x4, smap):
    """K9 bf16's sums: the T side an fma over the terms (weight != 0) from
    0 in float32; then per F term in order s = rbf(s + rbf(wf * v)); rows
    and f with no source 0."""
    b, c = x4.shape[:2]
    x = x4.float()
    ts, tw = smap.compact_t()
    fs, fw = torch.from_numpy(smap.fs).long(), torch.from_numpy(smap.fw)
    y = torch.zeros(b, c, smap.t_out, x.shape[3])
    for i in range(ts.shape[1]):
        wt = torch.from_numpy(tw[:, i])
        v = x[:, :, torch.from_numpy(ts[:, i]).long()]
        y = torch.where((wt != 0)[None, None, :, None],
                        _fma(wt[None, None, :, None], v, y), y)
    s = torch.zeros(b, c, smap.t_out, smap.f_out)
    for u in range(fs.shape[1]):
        w = fw[:, u]
        term = _rbf((w[None, None, None, :] * y[..., fs[:, u]]).float())
        s = torch.where((w != 0)[None, None, None, :], _rbf(s + term), s)
    return s.permute(0, 2, 3, 1).reshape(b, smap.t_out, -1).to(BF)


def _ulps(got, want):
    """|got - want| / (2^-7 max(|want|, 2^-6)), the worst element: <= 1 is
    two bf16 ulps."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (2.0 ** -7 * torch.clamp(w.abs(), min=2.0 ** -6))
            ).max().item()


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF)


@pytest.mark.parametrize("geometry", [(13, 7, 6, 2), (21, 18, 37, 1),
                                      (251, 129, 64, 1)],
                         ids=lambda g: "x".join(map(str, g)))
def test_bf16_sums_match_the_plain_versions(geometry):
    t, f, c, b = geometry
    rng = np.random.default_rng(20)
    for name, smap, up, f_in in _sites(t, f):
        if up:
            x = _bf16(rng, (b, c, smap.t_in, f_in))
            got, want = emulate_up(x, smap), P.spatial_up_packed_plain(x, smap)
        else:
            x = _bf16(rng, (b, smap.t_in, f_in * c))
            got = emulate_down(x, smap, c)
            want = P.spatial_down_packed_plain(x, smap, c)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _ulps(got, want) <= 1.0, name
        if name in ("select", "nearest", "transposed select"):
            assert torch.equal(got, want), name  # one term, weight 1
        if name == "transposed select":  # no source: rows and f written 0
            g = got.view(b, smap.t_out, smap.f_out, c)
            assert (g[:, 1::2] == 0).all() and (g[:, :, 1::2] == 0).all()


JT, JF, JC, JB = 13, 7, 6, 2  # the JAX comparison's packed map and batch


@pytest.fixture(scope="module")
def jax_refs():
    """rtfs_tpu's K8 / K9 in interpret mode on bf16 inputs: the three
    forward maps, and the transposed ones as the VJPs (K8's through K9,
    K9's through K8), each as a torch bf16 tensor in the port's layout."""
    rng = np.random.default_rng(21)
    t2, f2 = (JT - 2) // 2 + 1, (JF - 2) // 2 + 1
    bf = ml_dtypes.bfloat16
    maps = {"pool": JP.adaptive_pool_maps(JT, t2, JF, f2),
            "select": JP.stride2_select_maps(JT - 1, t2, JF - 1, f2),
            "nearest": JP.nearest_up_maps(t2, JT, f2, JF)}
    hm = {k: [JP._hashable(a) for a in v] for k, v in maps.items()}

    def a(shape):
        return rng.standard_normal(shape).astype(np.float32).astype(bf)

    ins = {"pool": a((JB, JT, JF * JC)),
           "select": a((JB, JT - 1, (JF - 1) * JC)),
           "nearest": a((JB, t2, f2, JC)),
           "transposed nearest": a((JB, JT, JF * JC)),
           "transposed pool": a((JB, t2, f2, JC)),
           "transposed select": a((JB, t2, f2, JC))}

    def down(x, k):
        return JP.spatial_down_packed(x, *hm[k], f2, JC, True)

    def up(x):
        return JP.spatial_up_packed(x, *hm["nearest"], JF, True)

    j = jnp.asarray
    out = {"pool": down(j(ins["pool"]), "pool"),
           "select": down(j(ins["select"]), "select"),
           "nearest": up(j(ins["nearest"])),
           "transposed nearest": jax.vjp(up, j(ins["nearest"]))[1](
               j(ins["transposed nearest"]))[0],
           "transposed pool": jax.vjp(lambda x: down(x, "pool"),
                                      j(ins["pool"]))[1](
               j(ins["transposed pool"]))[0],
           "transposed select": jax.vjp(lambda x: down(x, "select"),
                                        j(ins["select"]))[1](
               j(ins["transposed select"]))[0]}

    def port(v):  # bf16 numpy -> torch; rank-4 (B, T, F, C) -> (B, C, T, F)
        t = torch.from_numpy(np.asarray(v, np.float32)).to(BF)
        return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t

    return ({k: port(v) for k, v in ins.items()},
            {k: port(v) for k, v in out.items()})


def test_bf16_sums_match_jax_in_interpret_mode(jax_refs):
    ins, refs = jax_refs
    for name, smap, up, f_in in _sites(JT, JF):
        x = ins[name]
        got = emulate_up(x, smap) if up else emulate_down(x, smap, JC)
        assert got.shape == refs[name].shape, name
        assert _ulps(got, refs[name]) <= 1.0, name
