"""The launch plans of K5 (dw_conv_packed) and K7 (pw_unproj_packed), on
the CPU.

``ops/packed_tf.dw_conv_geometry`` gives ``csrc/packed_tf.cu``'s
``dw_conv_packed_kernel`` its blocks (a run of output rows of one batch
row, an f tile, a block of channels) and threads (a channel quad at one f
position, a 2-D block); ``pw_unproj_geometry`` gives ``pw_unproj_kernel``
its persistent blocks a channel tile and its launches a slice of W. These
tests walk the blocks, threads, rings and epilogue as the kernels do, at
the preset's sites and at ragged shapes: every output is written by
exactly one thread, every input row is handed to the step that takes it
and an output gets its taps in one fixed order; the ring never hands a
step a slot another row took, nor overwrites one a step still reads; K7's
16-byte chunks of a channel's run of positions cover each position once
and line up with out's 16-byte blocks whatever the run's offset. The
constants and the C entries' signatures are held to the source. About 5 s
alone.
"""

import functools
import os
import re

import numpy as np
import pytest

from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P

# (B, T_in, F_in, C, kT, kF, pads_t, pads_f): the four sites at the preset
# (bs 1, 4, 8: "same" and pre-select, and their dx on the cotangent: the
# flipped taps with pads k - 1 - lo / hi), then ragged shapes: C off the
# quads, C over one channel block, taps other than the template's (17 x 17:
# fewer positions a block, so that ring and taps fit), an F over one tile
# of positions
K5 = {**{f"{site}-bs{b}": (b, 251 - (site == "pre dx"),
                           129 - (site == "pre dx"), 64, 4, 4, pads, pads)
         for b in (1, 4, 8)
         for site, pads in (("same", (1, 2)), ("pre", (1, 1)),
                            ("same dx", (2, 1)), ("pre dx", (2, 2)))},
      "c6": (3, 13, 7, 6, 4, 4, (1, 2), (1, 2)),
      "c70": (2, 11, 9, 70, 4, 4, (1, 2), (1, 2)),
      "taps-3x3": (2, 19, 21, 12, 3, 3, (1, 1), (1, 1)),
      "taps-5x5": (1, 23, 17, 64, 5, 5, (2, 2), (2, 2)),
      "taps-17x17": (1, 6, 129, 64, 17, 17, (8, 8), (8, 8)),
      "taps-1x4": (4, 9, 33, 8, 1, 4, (0, 0), (1, 2)),
      "f-300": (1, 4, 300, 4, 4, 4, (1, 2), (1, 2)),
      "rows-long": (30, 12, 1100, 8, 4, 4, (1, 2), (1, 2))}
SMALL = ["c6", "c70", "taps-3x3", "taps-5x5", "taps-1x4", "f-300",
         "same-bs1", "pre dx-bs1"]


def _k5(name):
    b, t_in, f_in, c, kt, kf, pt, pf = K5[name]
    t_out, f_out = P.dw_geometry(t_in, f_in, kt, kf, pt, pf)
    return (b, t_in, f_in, c, kt, kf, pt, pf, t_out, f_out,
            P.dw_conv_geometry(b, c, t_out, f_out, kt, kf))


def _run(t_out, runs, x):
    """Block x's output rows, as the kernel splits T_out over the runs."""
    return t_out * x // runs, t_out * (x + 1) // runs


@pytest.mark.parametrize("name", sorted(K5))
def test_k5_blocks_threads_and_shared_memory(name):
    b, _, _, c, kt, kf, _, _, t_out, f_out, geo = _k5(name)
    qb, ft, runs = geo["qb"], geo["ft"], geo["runs"]
    assert geo["threads"] == qb * ft <= P.DW_THREADS and qb <= P.DW_QUADS
    assert geo["tiles_f"] == -(-f_out // ft)
    assert (geo["tiles_f"] - 1) * ft < f_out  # no empty tile
    assert geo["blocks_c"] == -(-(-(-c // 4)) // qb)
    assert geo["grid"] == (runs, geo["tiles_f"], b * geo["blocks_c"])
    assert 1 <= runs <= t_out
    assert all(_run(t_out, runs, x)[1] > _run(t_out, runs, x)[0]
               for x in range(runs))  # no empty run
    assert geo["fixed"] == ((kt, kf) == P.DW_FIXED)
    assert geo["slots"] == P.DW_AHEAD + (1 if geo["fixed"] else kt)
    assert geo["smem"] == P.dw_conv_smem(kt, kf, qb, ft, geo["fixed"]) \
        <= kernel_lib.SMEM_PER_BLOCK
    # about DW_BLOCKS_PER_SM blocks an SM where the rows allow it
    blocks = runs * geo["tiles_f"] * b * geo["blocks_c"]
    assert blocks <= max(P.DW_BLOCKS_PER_SM * kernel_lib.SMS,
                         geo["tiles_f"] * b * geo["blocks_c"])
    if runs < t_out:
        assert (runs + 1) * geo["tiles_f"] * b * geo["blocks_c"] > \
            P.DW_BLOCKS_PER_SM * kernel_lib.SMS


def test_k5_preset_geometry():
    """At the bs-4 "same" site: 16 quads x 15 positions (240 threads), 9 f
    tiles of 15, 7 runs of ~36 rows, 252 blocks; 26.5 KB of shared memory
    (16 taps and 5 rows of 18 positions, 16 chunks each); at bs 1, 29 runs
    of ~9 rows, and at bs 8, 3 runs."""
    geo = _k5("same-bs4")[-1]
    assert (geo["qb"], geo["ft"], geo["tiles_f"], geo["runs"]) == (16, 15, 9,
                                                                   7)
    assert geo["grid"] == (7, 9, 4) and geo["threads"] == 240
    assert geo["smem"] == 16 * 16 * (16 + 5 * 18) == 27_136
    assert _k5("same-bs1")[-1]["runs"] == 29
    assert _k5("same-bs8")[-1]["runs"] == 3
    pre = _k5("pre-bs4")[-1]  # 128 positions: 8 tiles of 16
    assert (pre["ft"], pre["tiles_f"], pre["threads"]) == (16, 8, 256)


@pytest.mark.parametrize("name", SMALL)
def test_k5_writes_every_output_once(name):
    """Block (x, y, z), thread (quad, p): batch row z // blocks_c, channels
    4 (z % blocks_c) qb + 4 quad .. + 3 below C, position y ft + p below
    F_out, the block's run of rows: every output value exactly once."""
    b, _, _, c, _, _, _, _, t_out, f_out, geo = _k5(name)
    qb, ft, runs, blocks_c = geo["qb"], geo["ft"], geo["runs"], \
        geo["blocks_c"]
    written = np.zeros((b, t_out, f_out, c), np.int32)
    quad, p = np.meshgrid(np.arange(qb), np.arange(ft), indexing="ij")
    for x in range(runs):
        t_lo, t_hi = _run(t_out, runs, x)
        for y in range(geo["tiles_f"]):
            for z in range(b * blocks_c):
                bb, cz = divmod(z, blocks_c)
                f = y * ft + p
                for k in range(4):
                    ch = cz * 4 * qb + 4 * quad + k
                    ok = (f < f_out) & (ch < c)
                    for t in range(t_lo, t_hi):
                        np.add.at(written, (bb, t, f[ok], ch[ok]), 1)
    assert (written == 1).all()


@pytest.mark.parametrize("name", sorted(K5))
def test_k5_steps_hand_each_output_its_taps_in_order(name):
    """Step i of a run takes input row r = t_lo - pt_lo + i (zero off the
    map). With the taps in registers, acc[j] holds output row r + pt_lo -
    kT + 1 + j and gets tap row kT - 1 - j; acc[0] is stored at the step
    (i >= kT - 1) and the accumulators shift. Otherwise the output row of
    step i (i >= kT - 1) is formed from the rows of steps i - kT + 1 .. i,
    tap row dt from the first + dt. Either way each output row of the run
    is stored once, after tap rows 0 .. kT - 1 in that order, tap row dt
    from input row t + dt - pt_lo."""
    _, t_in, _, _, kt, _, pt, _, t_out, _, geo = _k5(name)
    for x in sorted({0, geo["runs"] // 2, geo["runs"] - 1}):
        t_lo, t_hi = _run(t_out, geo["runs"], x)
        steps = t_hi - t_lo + kt - 1
        got = {}  # output row -> [(tap row, input row)] in order
        stored = []
        if geo["fixed"]:
            acc = [None] * kt  # the output row each accumulator holds
            for i in range(steps):
                r = t_lo - pt[0] + i
                for j in range(kt):
                    t = r + pt[0] - kt + 1 + j
                    acc[j] = t
                    got.setdefault(t, []).append((kt - 1 - j, r))
                if i >= kt - 1:
                    stored.append(acc[0])
                acc = acc[1:] + [None]
        else:
            for i in range(kt - 1, steps):
                t = t_lo + i - (kt - 1)
                got[t] = [(dt, t_lo - pt[0] + i - (kt - 1) + dt)
                          for dt in range(kt)]
                stored.append(t)
        assert stored == list(range(t_lo, t_hi))
        for t in stored:
            assert got[t] == [(dt, t + dt - pt[0]) for dt in range(kt)]
        # every input row a stored output reads is a row of the run's steps
        rows = {t + dt - pt[0] for t in stored for dt in range(kt)}
        assert rows <= set(range(t_lo - pt[0], t_lo - pt[0] + steps))
        assert t_in >= 1


@pytest.mark.parametrize("name", sorted(K5))
def test_k5_staged_positions_are_the_taps_inputs(name):
    """Thread (quad, p) copies staged positions p, p + ft, .. (< ft + kF -
    1) of its quad, so each staged chunk is copied once; the staged
    position p + df, read for tap df, holds input f0 - pf_lo + p + df = f +
    df - pf_lo."""
    _, _, _, _, _, kf, _, pf, _, f_out, geo = _k5(name)
    ft = geo["ft"]
    xw = ft + kf - 1
    copied = np.zeros(xw, np.int32)
    for p in range(ft):
        copied[np.arange(p, xw, ft)] += 1
    assert (copied == 1).all()
    for y in range(geo["tiles_f"]):
        f0 = y * ft
        for p in range(ft):
            for df in range(kf):
                assert p + df < xw
                assert f0 - pf[0] + (p + df) == (f0 + p) + df - pf[0]


@pytest.mark.parametrize("fixed,kt", [(True, 4), (False, 1), (False, 3),
                                      (False, 4), (False, 5)])
@pytest.mark.parametrize("steps", [1, 2, 4, 5, 9, 40])
def test_k5_ring_hands_each_step_its_rows(fixed, kt, steps):
    """A run of ``steps`` input rows through NR = DW_AHEAD + (1 with the
    taps in registers, else kT) slots: rows 0 .. DW_AHEAD-1 issued before
    the loop into slots 0 ..; step i waits until at most DW_AHEAD - 1
    groups are pending, a barrier, issues row i + DW_AHEAD into the next
    slot (the counters go round), then reads row i (with the taps in
    registers) or rows i - kT + 1 .. i (otherwise, from step kT - 1 on).
    No copy lands in a slot a step not yet done reads."""
    ahead = P.DW_AHEAD
    nr = ahead + (1 if fixed else kt)
    slot_of, pending = {}, []
    ld = 0

    def issue(i):
        nonlocal ld
        pending.append([(ld, i)] if i < steps else [])
        ld = (ld + 1) % nr

    for i in range(ahead):
        issue(i)
    rd = 0
    for i in range(steps):
        while len(pending) > ahead - 1:  # wait_group DW_AHEAD - 1
            for s, row in pending.pop(0):
                slot_of[s] = row
        issue(i + ahead)
        reads = ({rd: i} if fixed else
                 {(rd - d) % nr: i - d for d in range(kt) if i >= kt - 1})
        for s, _ in pending[-1]:  # the new copy may land at once
            assert s not in reads
        for s, row in reads.items():
            assert slot_of[s] == row
        rd = (rd + 1) % nr


def test_k5_refuses_only_what_no_block_takes():
    with pytest.raises(ValueError):
        P.dw_conv_geometry(1, 64, 10, 10, 400, 400)  # taps alone: 10 MB
    with pytest.raises(ValueError):
        P.dw_conv_geometry(1, 8, 0, 10, 4, 4)
    assert P.dw_conv_geometry(1, 4096, 10, 10, 9, 9)["blocks_c"] == 64
    assert P.dw_conv_geometry(2, 64, 7, 1, 4, 4)["ft"] == 1


@pytest.mark.parametrize("taps, qb, ft", [(17, 16, 13), (24, 11, 3),
                                          (40, 4, 7)])
def test_k5_wide_taps_take_fewer_positions_then_fewer_quads(taps, qb, ft):
    """Where 16 quads at 16 positions would not fit (17 x 17 taps at C 64,
    F 129: 16 * 16 * (289 + 21 * 31) * 4 bytes), a block takes the most
    positions that fit, and below one position, the most quads; the
    smallest fitting block of the next position or quad would not fit."""
    geo = P.dw_conv_geometry(1, 64, 6, 129, taps, taps)
    assert (geo["qb"], geo["ft"]) == (qb, ft)
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    assert P.dw_conv_smem(taps, taps, 16, 16, False) \
        > kernel_lib.SMEM_PER_BLOCK
    nxt = (P.dw_conv_smem(taps, taps, qb, -(-129 // (geo["tiles_f"] - 1)),
                          False) if qb == 16
           else P.dw_conv_smem(taps, taps, qb + 1, 1, False))
    assert nxt > kernel_lib.SMEM_PER_BLOCK
    assert geo["blocks_c"] * geo["qb"] >= 16


@pytest.mark.parametrize("name", sorted(K5))
def test_k5_launch_ints_match_the_c_entry(name):
    b, t_in, f_in, c, kt, kf, pt, pf, t_out, f_out, geo = _k5(name)
    strides = (kf, 1, kt * kf)  # the layer's (kT, kF, C) view
    ints = P.dw_conv_launch_ints(b, t_in, f_in, c, t_out, f_out, (kt, kf),
                                 pt, pf, strides)
    assert (4, len(ints)) == kernel_lib._SIGNATURES["packed_tf"][
        "dw_conv_packed_fwd"]
    assert ints == (b, t_in, f_in, c, t_out, f_out, kt, kf, pt[0], pf[0],
                    *strides, geo["qb"], geo["ft"], geo["runs"])


# ------------------------------------------------------------------- K7

# (B, M, K, N): the serving sites (bs 1, 8) and K6's dx (bs 4), M odd and
# one position past a tile, N 70 (a partial channel tile), K over a slice
# of W, K off 16-byte rows, many tiles a block
K7 = {"bs1": (1, 251 * 129, 64, 256), "bs4": (4, 251 * 129, 64, 256),
      "bs8": (8, 251 * 129, 64, 256), "m-129": (3, 129, 64, 256),
      "n-70": (2, 7 * 129, 64, 70), "k-300": (1, 9 * 43, 300, 40),
      "k-6": (2, 66, 6, 13), "walk": (2, 20 * 129, 64, 256)}


def _k7_tiles(geo, x, m_tiles):
    """Block x's (batch row, first position) tiles, as ProjCursor walks
    them: tiles x, x + blocks, ..."""
    return [divmod(t, m_tiles) for t in range(x, geo["tiles"],
                                              geo["blocks"])]


@pytest.mark.parametrize("name", sorted(K7))
def test_k7_blocks_write_every_output_once(name):
    """Every (batch row, M tile) is walked by one block of each channel
    tile, each of its k stages once a launch, the first launch writing
    bias + sums and each later one adding to them; every (b, n, m) of the
    output is written by one warp row of one block per launch."""
    b, m, k, n = K7[name]
    geo = P.pw_unproj_geometry(b, m, k, n)
    m_tiles = -(-m // P.UNPROJ_M)
    assert geo["tiles"] == b * m_tiles
    assert geo["n_tiles"] == -(-n // P.PROJ_N)
    assert geo["grid"] == (geo["blocks"], geo["n_tiles"])
    assert 1 <= geo["blocks"] <= geo["tiles"]
    per_sm = P.UNPROJ_BLOCKS * kernel_lib.SMS
    assert geo["blocks"] * geo["n_tiles"] <= max(per_sm, geo["n_tiles"])
    if geo["blocks"] < geo["tiles"]:
        assert (geo["blocks"] + 1) * geo["n_tiles"] > per_sm
    assert geo["slices"] == -(-k // P.PROJ_SLICE)
    assert geo["stages"] == -(-k // P.PROJ_K)
    for k0 in range(0, k, P.PROJ_SLICE):
        assert P.pw_unproj_smem(min(k - k0, P.PROJ_SLICE)) <= geo["smem"] \
            <= kernel_lib.SMEM_PER_BLOCK
    seen = np.zeros((b, m_tiles, geo["n_tiles"]), np.int32)
    for y in range(geo["n_tiles"]):
        for x in range(geo["blocks"]):
            for bb, mt in _k7_tiles(geo, x, m_tiles):
                seen[bb, mt, y] += 1
    assert (seen == 1).all()
    # the warp rows of a tile's epilogue: rows r = warp, warp + 16, .. of
    # the channel tile, below N
    rows = np.zeros(n, np.int32)
    for y in range(geo["n_tiles"]):
        for warp in range(P.UNPROJ_THREADS // 32):
            for r in range(warp, P.PROJ_N, P.UNPROJ_THREADS // 32):
                if y * P.PROJ_N + r < n:
                    rows[y * P.PROJ_N + r] += 1
    assert (rows == 1).all()


def test_k7_fragments_cover_the_tile_and_copies_cover_a_stage():
    """UNPROJ_THREADS / 32 warps as UNPROJ_M / 16 (positions) x 2
    (channels), each lane's D elements (position wm 16 + g + 8 (v >> 1),
    channel wn 32 + 8 nb + 2 q + (v & 1), wm = warp % (UNPROJ_M / 16)):
    every (position, channel) of the UNPROJ_M x PROJ_N tile once. A stage's
    copies (position e >> 3, chunk e & 7 for e = tid + i PROJ_THREADS)
    cover its PROJ_M positions' PROJ_K k once. The A fragment reads of a
    warp (rows g, columns q of the x rows of UNPROJ_XS floats) hit 32
    banks."""
    tile = np.zeros((P.UNPROJ_M, P.PROJ_N), np.int32)
    assert P.UNPROJ_THREADS == P.UNPROJ_M // 16 * 2 * 32
    for warp in range(P.UNPROJ_THREADS // 32):
        wm, wn = warp % (P.UNPROJ_M // 16), warp // (P.UNPROJ_M // 16)
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for nb in range(4):
                for v in range(4):
                    tile[wm * 16 + g + 8 * (v >> 1),
                         wn * 32 + nb * 8 + 2 * q + (v & 1)] += 1
    assert (tile == 1).all()
    chunks = P.PROJ_K // 4
    copies = np.zeros((P.UNPROJ_M, chunks), np.int32)
    for tid in range(P.UNPROJ_THREADS):
        for i in range(P.UNPROJ_M * chunks // P.UNPROJ_THREADS):
            e = tid + i * P.UNPROJ_THREADS
            copies[e // chunks, e % chunks] += 1
    assert (copies == 1).all()
    banks = {(g * P.UNPROJ_XS + q) % 32 for g in range(8) for q in range(4)}
    assert len(banks) == 32


@pytest.mark.parametrize("m", [129, 251 * 129, 300, 128, 1, 7])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_k7_epilogue_chunks_line_up_with_out(m, base):
    """Channel row n of a tile at position m0: sh = (base + (b N + n) M +
    m0) mod 4 (base: out's float index mod 4); o_s holds position p at
    column sh + p (< UNPROJ_OS); chunk j of the row (lanes j, j + 32 of
    the warp) is out's float index base + (b N + n) M + m0 - sh + 4 j, a
    16-byte block; its positions 4 j - sh .. + 3 below the span are
    stored, as one 16-byte store where all four are, element by element
    at the run's ends: every position of the span exactly once."""
    b, n = 2, 5
    for bb in range(b):
        for ch in range(n):
            for m0 in range(0, m, P.UNPROJ_M):
                span = min(P.UNPROJ_M, m - m0)
                start = (bb * n + ch) * m + m0
                sh = (base + start) % 4
                assert sh + span - 1 < P.UNPROJ_OS - 1
                chunks = (sh + span + 3) >> 2
                assert chunks <= 33
                hit = np.zeros(span, np.int32)
                for j in range(chunks):
                    assert (base + start - sh + 4 * j) % 4 == 0
                    lo = 4 * j - sh
                    full = lo >= 0 and lo + 4 <= span
                    for e in range(4):
                        if 0 <= lo + e < span:
                            hit[lo + e] += 1
                        else:
                            assert not full
                assert (hit == 1).all()


def test_k7_preset_geometry():
    """At the bs-4 site: 1,012 tiles of 128 positions, 4 channel tiles of
    64, 33 blocks each (132 together), 2 k stages a tile, one launch;
    W's split slice (32 KB), the ring (54 KB) and the output tile (33 KB):
    121,856 bytes of shared memory; a slice of 256 k (K6's) fits too."""
    geo = P.pw_unproj_geometry(4, 251 * 129, 64, 256)
    assert (geo["tiles"], geo["n_tiles"], geo["blocks"]) == (1012, 4, 33)
    assert (geo["stages"], geo["slices"]) == (2, 1)
    assert geo["smem"] == 4 * (64 * 128 + 3 * 128 * 36 + 64 * 132) == 121_856
    assert P.pw_unproj_smem(P.PROJ_SLICE) <= kernel_lib.SMEM_PER_BLOCK
    assert P.pw_unproj_geometry(1, 129, 300, 256)["slices"] == 2
    assert P.pw_unproj_geometry(1, 251 * 129, 64, 256)["blocks"] == 33
    with pytest.raises(ValueError):
        P.pw_unproj_geometry(1, 0, 64, 256)


@pytest.mark.parametrize("name", sorted(K7))
def test_k7_launch_ints_match_the_c_entry(name):
    import torch

    b, m, k, n = K7[name]
    xp = torch.empty(b, 1, m * k)
    w = torch.empty(n, k).t()  # the layer's (K, N) view
    ints = P.pw_unproj_launch_ints(xp, w, m)
    assert (4, len(ints)) == kernel_lib._SIGNATURES["packed_tf"][
        "pw_unproj_packed_fwd"]
    assert ints == (b, m, k, n, 1, k, P.pw_unproj_geometry(b, m, k,
                                                           n)["blocks"])


# -------------------------------------------------------------- sources


@functools.cache
def _source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _entry_counts(src, name):
    entry = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                      re.S).group(1)
    args = [a.strip() for a in entry.split(",")]
    return (sum(a.startswith(("const void*", "void*")) for a in args) - 1,
            sum(a.startswith("int ") for a in args))


def test_constants_and_entries_match_the_source():
    src, consts = _source()
    assert (consts["kDwQuads"], consts["kDwThreads"], consts["kDwAhead"]) \
        == (P.DW_QUADS, P.DW_THREADS, P.DW_AHEAD)
    assert "__launch_bounds__(kDwThreads, 2)" in src
    assert P.DW_BLOCKS_PER_SM == 2
    # the taps as template arguments, for float32 and bf16 storage
    assert "dw_conv_packed_kernel<4, 4, E>" in src and \
        "dw_conv_packed_kernel<0, 0, E>" in src
    assert re.search(r"constexpr int kUnprojXS = kProjK \+ 4;", src)
    assert re.search(r"constexpr int kUnprojOS = kUnprojM \+ 4;", src)
    assert re.search(r"constexpr int kUnprojThreads = kUnprojM / 16 \* 2 "
                     r"\* 32;", src)
    assert (consts["kUnprojM"], consts["kUnprojStages"],
            consts["kUnprojBlocks"]) == (P.UNPROJ_M, P.UNPROJ_STAGES,
                                         P.UNPROJ_BLOCKS)
    assert "__launch_bounds__(kUnprojThreads, kUnprojBlocks)" in src
    assert (P.UNPROJ_XS, P.UNPROJ_OS) == (P.PROJ_K + 4, P.UNPROJ_M + 4)
    # K7: one launch a slice of W, accumulating after the first
    k7 = src.split('extern "C" int pw_unproj_packed_fwd')[1]
    assert "for (int k0 = 0; k0 < K; k0 += kProjSlice)" in k7
    assert "k0 == 0 ? (const float*)bias : nullptr" in k7
    for name in ("dw_conv_packed_fwd", "pw_unproj_packed_fwd",
                 "dw_conv_packed_fwd_bf16", "pw_proj_packed_fwd_bf16",
                 "pw_unproj_packed_fwd_bf16", "spatial_down_packed_fwd_bf16",
                 "spatial_up_packed_fwd_bf16"):
        assert _entry_counts(src, name) == \
            kernel_lib._SIGNATURES["packed_tf"][name]
    # no division in K5's loops: the ring's slots go round by counters
    body = src.split("dw_conv_packed_kernel(const E*")[1].split(
        "hk::cp_async_wait_all();")[0]
    loops = re.findall(r"for \((.*?)\)", body)
    assert loops and not any("/" in lp or "%" in lp for lp in loops)
