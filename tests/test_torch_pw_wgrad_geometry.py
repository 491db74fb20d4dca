"""pw-wgrad (``pw_packed_wgrad``)'s launch plan and numerics, on the CPU.

``ops/packed_tf.pw_wgrad_geometry`` gives ``csrc/packed_tf.cu``'s
``pw_wgrad_kernel`` its grid: each batch row's positions in chunks of a
multiple of PW_WGRAD_K positions (about one wave of one block an SM), and
tiles of PW_WGRAD_ROWS planar x PW_WGRAD_COLS packed channels of dW. These
tests walk the chunks, tiles, stages, copies, fragments and the output
tile as the kernel does, at the preset's sites (bs 1, 4 and 8) and at
ragged B, M and channel counts: every (batch row, position) falls in
exactly one chunk, every element of every partial is written once (in
K6's layout and in K7's transposed one), shared memory fits one block and
the grid fills the SMs; a planar row's 16-byte staging, at every offset
of its start mod 4, lands each position of a stage once in its shifted
column (zeros past the chunk) and reads nothing outside the stage's
positions; the A and B fragment reads hit 32 banks and read the values
they multiply. An emulation of the tensor core's rounding shows why the
big products are added to a float32 sum every few stages. The constants
and the C entry's signature are held to the source and to
``kernel_lib._SIGNATURES``. About 4 s of tests alone (7-8 s with the JAX
import of ``tests/conftest.py``).
"""

import functools
import os
import re

import numpy as np
import pytest

from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P

ROWS, COLS, K = P.PW_WGRAD_ROWS, P.PW_WGRAD_COLS, P.PW_WGRAD_K
PS, QS, OS = P.PW_WGRAD_PS, P.PW_WGRAD_QS, P.PW_WGRAD_OS
THREADS = P.PW_WGRAD_THREADS
BLOCKS = K // 4 + 1  # 16-byte blocks a staged planar row
P_STAGE = ROWS * PS
STAGE = P_STAGE + K * QS
M_PRESET = 251 * 129  # the packed segment's positions (odd)

# (B, M): the preset's sites at bs 1, 4 and 8; ragged: M odd (1 and 3 mod
# 4) and even (0 and 2 mod 4), M below one stage and one position, B 1
SITES = {"bs1": (1, M_PRESET), "bs4": (4, M_PRESET), "bs8": (8, M_PRESET),
         "m-1001": (2, 1001), "m-1003": (3, 1003), "m-1000": (5, 1000),
         "m-998": (1, 998), "m-21": (1, 21), "m-1-b7": (7, 1),
         "b200": (200, 37)}
CHANNELS = (1, 48, 64, 200, 256, 512)


def _staged_row(r: int) -> int:
    """``pw_staged_row``: channel r of a tile staged by class r % 4."""
    return (r & ~63) | ((r & 3) << 4) | ((r & 63) >> 2)


def _channel(t: int, i: int) -> int:
    """The tile's planar channel in row i of m16 tile t."""
    return 64 * (t >> 2) + 4 * i + (t & 3)


def _shift(base4: int, b: int, cp: int, cp0: int, c: int, m: int,
           p_begin: int) -> int:
    """The kernel's ``shift(c)``: the offset in its 16-byte block of a
    planar row of class c's first chunk position, p's float index mod 4
    being ``base4``."""
    return (base4 + (b * cp + cp0 + c) * m + p_begin) % 4


@pytest.mark.parametrize("site", sorted(SITES))
def test_chunks_cover_every_position_once(site):
    """Block (x, y, b) sums positions [x L, min(M, (x + 1) L)) of batch row
    b: over the chunks of every batch row each position is summed once, in
    whole stages of PW_WGRAD_K but the last; the partial rows b chunks + x
    are 0 .. parts - 1, once each."""
    b, m = SITES[site]
    geo = P.pw_wgrad_geometry(b, m, 256, 64)
    L, chunks = geo["chunk"], geo["chunks"]
    assert L % K == 0 and L >= K and chunks == -(-m // L)
    assert geo["grid"] == (chunks, geo["tiles"], b)
    assert geo["parts"] == b * chunks and geo["stages"] == L // K
    hits = np.zeros(m, np.int32)
    for x in range(chunks):
        p_begin, p_end = x * L, min(m, (x + 1) * L)
        assert p_begin < p_end  # no empty block
        ns = -(-(p_end - p_begin) // K)
        for s in range(ns):
            p0 = p_begin + s * K
            hits[p0:min(p0 + K, p_end)] += 1
    assert (hits == 1).all()
    rows = sorted(bb * chunks + x for bb in range(b) for x in range(chunks))
    assert rows == list(range(geo["parts"]))


@pytest.mark.parametrize("cp", CHANNELS)
@pytest.mark.parametrize("cq", CHANNELS)
def test_every_partial_element_is_written_once(cp, cq):
    """The tiles y of one (batch row, chunk), planar tile y // tiles_q and
    packed tile y % tiles_q, write rows min(ROWS, Cp - cp0) x columns
    min(COLS, Cq - cq0) of the partial: each element of the (Cp, Cq) dW
    once at (cp0 + r) Cq + cq0 + c (K6's layout) and of its (Cq, Cp)
    transpose once at (cq0 + c) Cp + cp0 + r (K7's)."""
    geo = P.pw_wgrad_geometry(2, 77, cp, cq)
    tiles_q = -(-cq // COLS)
    assert geo["tiles_p"] == -(-cp // ROWS) and geo["tiles_q"] == tiles_q
    assert geo["tiles"] == geo["tiles_p"] * tiles_q
    k6, k7 = np.zeros(cp * cq, np.int32), np.zeros(cp * cq, np.int32)
    for y in range(geo["tiles"]):
        cp0, cq0 = y // tiles_q * ROWS, y % tiles_q * COLS
        assert cp0 < cp and cq0 < cq
        rows, cols = min(ROWS, cp - cp0), min(COLS, cq - cq0)
        r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        np.add.at(k6, ((cp0 + r) * cq + cq0 + c).ravel(), 1)
        np.add.at(k7, ((cq0 + c) * cp + cp0 + r).ravel(), 1)
    assert (k6 == 1).all() and (k7 == 1).all()


@pytest.mark.parametrize("site", sorted(SITES))
def test_the_grid_fills_the_sms(site):
    """One block an SM (its shared memory): where B times the tiles is at
    most the SMs, the grid is one wave, and its chunk the shortest whole
    number of stages that keeps it one (a stage shorter would need more
    chunks a batch row than the wave holds); at the preset's sites it takes
    at least 95% of the 132 SMs. Where B times the tiles exceeds them, a
    batch row is one chunk."""
    b, m = SITES[site]
    for cp, cq in ((256, 64), (64, 256), (512, 64), (48, 200)):
        geo = P.pw_wgrad_geometry(b, m, cp, cq)
        per_row = max(1, kernel_lib.SMS // (geo["tiles"] * b))
        blocks = geo["chunks"] * geo["tiles"] * b
        if geo["tiles"] * b <= kernel_lib.SMS:
            assert blocks <= kernel_lib.SMS
            assert geo["chunks"] <= per_row
            L = geo["chunk"]
            assert L == K or -(-m // (L - K)) > per_row
        else:
            assert geo["chunks"] == 1 and geo["chunk"] >= m
    for b in (1, 4, 8):
        geo = P.pw_wgrad_geometry(b, M_PRESET, 256, 64)
        blocks = geo["chunks"] * geo["tiles"] * b
        assert 0.95 * kernel_lib.SMS <= blocks <= kernel_lib.SMS
    assert P.pw_wgrad_geometry(4, M_PRESET, 256, 64)["grid"] == (16, 2, 4)


def test_shared_memory_fits_one_block():
    """The ring of 3 stages (128 planar rows of 68 floats, 64 packed
    positions of 72), the (128, 66) output tile reusing it: 159,744 bytes,
    within one block's 227 KB. The default variants of
    tools/kernel_variants.py fit too; all 256 x 64 of dW a block fits at 3
    stages of 32 positions (138,240), not at 3 stages of 64."""
    assert P.pw_wgrad_smem() == 4 * 3 * (128 * 68 + 64 * 72) == 159_744
    assert P.pw_wgrad_smem() <= kernel_lib.SMEM_PER_BLOCK
    assert P.pw_wgrad_smem(256, 3, 32) == \
        4 * 3 * (256 * 36 + 32 * 72) == 138_240
    for rows, stages, k in ((128, 4, 32), (128, 2, 128), (128, 2, 64),
                            (128, 3, 32), (256, 3, 32), (64, 3, 64),
                            (64, 3, 32)):
        assert P.pw_wgrad_smem(rows, stages, k) <= kernel_lib.SMEM_PER_BLOCK
    assert P.pw_wgrad_smem(256, 3, 64) > kernel_lib.SMEM_PER_BLOCK
    assert P.pw_wgrad_smem(128, 1, 32) == 4 * 128 * OS  # the tile's
    for b, m in SITES.values():
        assert P.pw_wgrad_geometry(b, m, 256, 64)["smem"] == P.pw_wgrad_smem()
    # the ring's slots, the packed part and the output tile start on
    # 16-byte (and 32-bank) boundaries; a staged row is whole 16-byte blocks
    assert STAGE % 32 == 0 and P_STAGE % 32 == 0 and (3 * STAGE) % 32 == 0
    assert PS % 4 == 0 and QS % 4 == 0 and OS % 2 == 0


def _stage_planar(base4, b, cp, cp0, cr, m, p_begin, p_end, s):
    """One stage's copies of the planar row of tile channel cr, as thread
    cr issues them: {slot column: the position it holds, or None for a
    zero}, the positions read, and the 16-byte copies' (source float
    index, slot column)."""
    sh = _shift(base4, b, cp, cp0, cr & 3, m, p_begin)
    p0 = p_begin + s * K
    avail = p_end - p0
    row = base4 + (b * cp + cp0 + cr) * m  # float index of position 0
    slot, read, vec = {}, [], []

    def put(col, pos):
        assert col not in slot, "a column written twice"
        slot[col] = pos
        if pos is not None:
            read.append(pos)

    assert cr < ROWS <= THREADS  # a thread a row
    for j in range(BLOCKS):
        lo = 4 * j - sh
        if lo + 4 <= 0 or lo >= K:
            continue
        src = row + p0 - sh + 4 * j
        if lo >= 0 and lo + 4 <= K and lo + 4 <= avail:
            vec.append((src, 4 * j))
            for e in range(4):
                put(4 * j + e, src + e - row)
        else:
            for e in range(4):
                if lo + e < 0 or lo + e >= K:
                    continue
                put(4 * j + e, src + e - row if lo + e < avail else None)
    return sh, slot, read, vec


@pytest.mark.parametrize("m", [M_PRESET, 1001, 1000, 998, 21])
@pytest.mark.parametrize("base4", [0, 1, 2, 3])
def test_planar_staging_lands_each_position_once(m, base4):
    """The planar side (B, Cp, M), p's float index ``base4`` mod 4, Cp 5
    (odd, so rows of every batch row start at every offset): for each
    stage of the first and last chunks of two batch rows, each of 8 tile
    channels (two of each class) holds position p0 + k at column sh + k
    of its staged row, k < PW_WGRAD_K, once, or 0 past the chunk; nothing
    is read outside the stage's positions in the chunk; each 16-byte copy
    starts on a 16-byte block of p and of the slot; sh is the one the
    reading lanes of the row's class use."""
    cp, cp0 = 5, 0
    geo = P.pw_wgrad_geometry(2, m, cp, 64)
    L = geo["chunk"]
    for b in range(2):
        for x in sorted({0, geo["chunks"] - 1}):
            p_begin, p_end = x * L, min(m, (x + 1) * L)
            for s in range(-(-(p_end - p_begin) // K)):
                p0 = p_begin + s * K
                for cr in range(8):
                    sh, slot, read, vec = _stage_planar(
                        base4, b, cp, cp0, cr, m, p_begin, p_end, s)
                    assert 0 <= sh <= 3
                    window = {sh + k: (p0 + k if p0 + k < p_end else None)
                              for k in range(K)}
                    assert {c: slot[c] for c in window} == window
                    assert set(slot) - set(window) == set()
                    assert all(p0 <= pos < min(p0 + K, p_end)
                               for pos in read)
                    for src, col in vec:
                        assert src % 4 == 0 and col % 4 == 0
                    # the same shift for every stage and channels 4 apart
                    assert sh == _shift(base4, b, cp, cp0, (cr + 4) & 3, m,
                                        p_begin)
                    assert (base4 + (b * cp + cr) * m + p0 - sh) % 4 == 0


def test_fragments_read_the_values_they_multiply():
    """Warp (wm, wn), lane (g, q), m16 tile t = 2 wm + mi: the A elements
    at staged rows 16 t + g (+ 8), columns shift(t % 4) + kk + q (+ 4) are
    planar channel 64 (t / 4) + 4 g + t % 4 (+ 32) at position kk + q
    (+ 4) of the stage, the rows its copier staged; the B elements at
    packed position kk + q (+ 4), channel 32 wn + 8 nj + g. Every read of
    a warp hits the 32 banks once."""
    warps_m = ROWS // 32
    assert THREADS == warps_m * 2 * 32
    for t in range(ROWS // 16):
        for i in range(16):
            assert _staged_row(_channel(t, i)) == 16 * t + i
    for sh in range(4):  # one class shift of the tile (all rows of t)
        for warp in range(THREADS // 32):
            wm, wn = warp % warps_m, warp // warps_m
            for mi in range(2):
                t = 2 * wm + mi
                for kk in range(0, K, 8):
                    for d_row, d_col in ((0, 0), (8, 0), (0, 4), (8, 4)):
                        banks = set()
                        for lane in range(32):
                            g, q = lane >> 2, lane & 3
                            off = (16 * t + g) * PS + sh + q + kk
                            off += d_row * PS + d_col
                            row, col = divmod(off, PS)
                            assert _channel(t, row - 16 * t) == \
                                _channel(t, g + d_row)
                            assert col - sh == kk + q + d_col < K
                            banks.add(off % 32)
                        assert len(banks) == 32
            for nj in range(4):
                for kk in range(0, K, 8):
                    for d in (0, 4):
                        banks = set()
                        for lane in range(32):
                            g, q = lane >> 2, lane & 3
                            off = P_STAGE + (kk + q + d) * QS + 32 * wn \
                                + 8 * nj + g
                            pos, ch = divmod(off - P_STAGE, QS)
                            assert (pos, ch) == (kk + q + d,
                                                 32 * wn + 8 * nj + g)
                            banks.add(off % 32)
                        assert len(banks) == 32


def test_lanes_sum_the_output_tile_once_and_flush_without_conflicts():
    """The D elements of every lane (c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8,
    2q), c3 (g + 8, 2q + 1) of m16 tile t, n8 tile nj) are the (ROWS, COLS)
    output tile's elements once, at row 64 (t / 4) + 4 g + t % 4 (+ 32) of
    the tile in channel order (in the ring's place); a half warp's pairs
    of outputs hit the 32 banks once."""
    warps_m = ROWS // 32
    tile = np.zeros((ROWS, COLS), np.int32)
    for warp in range(THREADS // 32):
        wm, wn = warp % warps_m, warp // warps_m
        for mi in range(2):
            t = 2 * wm + mi
            for nj in range(4):
                for half in (0, 1):
                    for d_row in (0, 32):
                        banks = set()
                        for lane in range(16 * half, 16 * half + 16):
                            g, q = lane >> 2, lane & 3
                            row = _channel(t, g) + d_row
                            col = 32 * wn + 8 * nj + 2 * q
                            tile[row, col:col + 2] += 1
                            off = row * OS + col
                            assert off % 2 == 0
                            banks |= {off % 32, (off + 1) % 32}
                        assert len(banks) == 32
    assert (tile == 1).all()


@pytest.mark.parametrize("avail,cq,vec", [(K, 64, True), (5, 64, True),
                                          (K, 200 - 192, True),
                                          (3, 3, False)])
def test_packed_copies_cover_a_stage_once(avail, cq, vec):
    """A stage's packed side: thread tid copies (position e / 16, 16-byte
    chunk e % 16), e = tid + i PW_WGRAD_THREADS: each (position, channel)
    of the stage once, zero past the chunk's positions and past Cq (16-byte
    copies where vec, else four 4-byte ones)."""
    got = np.full((K, COLS), -1, np.int64)
    for tid in range(THREADS):
        for e in range(tid, K * COLS // 4, THREADS):
            pp, c = e // (COLS // 4), 4 * (e % (COLS // 4))
            for k in range(4):
                ok = pp < avail and c + k < cq
                if vec:
                    ok = pp < avail and c < cq
                assert got[pp, c + k] == -1
                got[pp, c + k] = pp * 1000 + c + k if ok else 0
    pos, ch = np.meshgrid(np.arange(K), np.arange(COLS), indexing="ij")
    want = np.where((pos < avail) & (ch < cq), pos * 1000 + ch, 0)
    assert (got == want).all()


def test_the_ring_hands_each_stage_to_its_iteration():
    """Iteration s waits for stage s (all groups but the kPwStages - 2
    newest), then issues stage s + kPwStages - 1 into the slot iteration
    s - 1 read; the prologue issues stages 0 .. kPwStages - 2: stage s
    sits in slot s % kPwStages, never overwritten while an iteration
    reads it."""
    stages = P.PW_WGRAD_STAGES
    for ns in (1, 2, 3, 5, 31, 64):
        slot_of, issued = {}, []
        for s in range(stages - 1):
            slot_of[s] = s
            issued.append(s)
        slot, ld = 0, stages - 1
        for s in range(ns):
            done = issued[:len(issued) - (stages - 2)]
            assert s in done
            assert slot_of.get(s) == slot == s % stages
            nxt = s + stages - 1
            issued.append(nxt)  # an empty group past the last stage
            if nxt < ns:
                assert ld != slot  # not the slot this iteration reads
                slot_of[nxt] = ld
            ld = (ld + 1) % stages
            slot = (slot + 1) % stages


def _tf32(x):
    """float32 -> TF32, round to nearest, ties away (``hk::to_tf32``)."""
    return ((x.view(np.int32) + 0x1000) & -0x2000).view(np.float32)


def _trunc(x):
    """float32 -> TF32 by truncation, as the tensor core reads it."""
    return (x.view(np.int32) & -0x2000).view(np.float32)


def _rz(acc, add):
    """acc + add rounded toward zero to float32, as the tensor core adds a
    step's products to its accumulator."""
    v = acc.astype(np.float64) + add
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_summing_apart_keeps_a_long_positive_sum_from_drifting():
    """64 outputs of dW, each a sum of products of positive a and g over
    the bs-4 site's 129,516 positions, each m16n8k8 step's 8 products
    exact and added to its accumulator rounded toward zero. Kept in one
    tensor-core accumulator (``hk::mma3``) over all positions, the sums
    come out ~7e-4 small, beyond chip_smoke's 1e-4 gate; over a batch
    row's 32,379, ~1.8e-4. As the kernel sums (chunks of 2,048 positions
    of a batch row, zeros past a chunk's end; big products on the tensor
    core for PW_WGRAD_FLUSH stages, then added to a float32 sum; cross
    terms apart; the 64 partials added in float32) the bias stays under
    1e-6."""
    rng = np.random.default_rng(0)
    n_out, m = 64, M_PRESET
    a = np.abs(rng.standard_normal((n_out, 4 * m))).astype(np.float32)
    g = np.abs(rng.standard_normal((n_out, 4 * m))).astype(np.float32)
    exact = (a.astype(np.float64) * g).sum(1)
    ab, gb = _tf32(a), _tf32(g)
    a_s, g_s = _trunc(a - ab), _trunc(g - gb)

    def steps(lo, hi):
        """(big, cross): each k8 step's exact sums over positions [lo,
        hi), zeros past hi."""
        n = -(-(hi - lo) // 8) * 8

        def one(x, y):
            p = np.zeros((n_out, n))
            p[:, :hi - lo] = x[:, lo:hi].astype(np.float64) * y[:, lo:hi]
            return p.reshape(n_out, -1, 8).sum(2)

        return one(ab, gb), one(a_s, gb) + one(ab, g_s)

    def one_accumulator(hi):
        big, cross = steps(0, hi)
        acc = np.zeros(n_out, np.float32)
        for k in range(big.shape[1]):
            acc = _rz(_rz(acc, cross[:, k]), big[:, k])
        ref = (a[:, :hi].astype(np.float64) * g[:, :hi]).sum(1)
        return float(((acc - ref) / ref).mean())

    assert one_accumulator(4 * m) < -5e-4
    assert -2.4e-4 < one_accumulator(m) < -1.2e-4

    geo = P.pw_wgrad_geometry(4, m, 256, 64)
    L, flush = geo["chunk"], P.PW_WGRAD_FLUSH * K // 8  # k8 steps a flush
    got = np.zeros(n_out, np.float32)
    for b in range(4):
        for x in range(geo["chunks"]):
            bigs, cross = steps(b * m + x * L, b * m + min(m, (x + 1) * L))
            total, big, corr = (np.zeros(n_out, np.float32)
                                for _ in range(3))
            for k in range(bigs.shape[1]):
                corr = _rz(corr, cross[:, k])
                big = _rz(big, bigs[:, k])
                if (k + 1) % flush == 0:
                    total, big = total + big, np.zeros(n_out, np.float32)
            got = got + (total + big + corr)  # the partials, in order
    assert abs(float(((got - exact) / exact).mean())) < 1e-6


@functools.cache
def _source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_constants_and_the_entry_match_the_source():
    src, consts = _source()
    assert (consts["kPwRows"], consts["kPwCols"], consts["kPwK"],
            consts["kPwStages"], consts["kPwFlush"]) == (
                ROWS, COLS, K, P.PW_WGRAD_STAGES, P.PW_WGRAD_FLUSH)
    assert "constexpr int kPwThreads = 2 * kPwRows;" in src
    assert "constexpr int kPwPS = kPwK + 4;" in src
    assert "constexpr int kPwQS = kPwCols + 8;" in src
    assert "constexpr int kPwOS = kPwCols + 2;" in src
    assert (PS, QS, OS, THREADS) == (K + 4, COLS + 8, COLS + 2, 2 * ROWS)
    # banks: staged planar rows 4 mod 32, packed positions 8 mod 32, the
    # output tile's rows 2 mod 8
    assert PS % 32 == 4 and QS % 32 == 8 and OS % 8 == 2
    assert "__launch_bounds__(kPwThreads, 1)" in src
    assert "return (r & ~63) | ((r & 3) << 4) | ((r & 63) >> 2);" in src
    entry = re.search(r'extern "C" int pw_packed_wgrad\((.*?)\)', src,
                      re.S).group(1)
    args = [a.strip() for a in entry.split(",")]
    counts = (sum(a.startswith(("const void*", "void*")) for a in args) - 1,
              sum(a.startswith("int ") for a in args))
    assert counts == kernel_lib._SIGNATURES["packed_tf"]["pw_packed_wgrad"]
    assert [a.split()[-1] for a in args if a.startswith("int ")] == \
        ["B", "M", "Ca", "Cb", "a_planar", "L", "n_part"]
    assert "L < 1 || L % kPwK" in src
    # the partials are added by the fixed-order kernel; no float atomics
    body = src.split("pw_wgrad_kernel(const float*")[1].split(
        'extern "C"')[0]
    assert "atomic" not in body
    assert "return launch_sum(partial, out, n_part, Ca * Cb, stream);" in \
        src.split('extern "C" int pw_packed_wgrad')[1]


@pytest.mark.parametrize("a_planar", [True, False])
@pytest.mark.parametrize("shape", [(4, 251, 129, 64, 256), (1, 3, 7, 48, 200),
                                   (2, 9, 13, 512, 64)])
def test_launch_ints_match_the_c_entry(a_planar, shape):
    """``pw_wgrad_launch_ints`` on K6's (x4, packed g) and K7's (packed x,
    g4): B, M, Ca, Cb, a_planar, the geometry's chunk and parts, with the
    planar side as dW's rows."""
    import torch

    b, t, f, c, ci = shape
    four, packed = torch.empty(b, ci, t, f), torch.empty(b, t, f * c)
    a, g = (four, packed) if a_planar else (packed, four)
    ints = P.pw_wgrad_launch_ints(a, g)
    geo = P.pw_wgrad_geometry(b, t * f, ci, c)
    ca, cb = (ci, c) if a_planar else (c, ci)
    assert ints == (b, t * f, ca, cb, int(a_planar), geo["chunk"],
                    geo["parts"])
    assert len(ints) == kernel_lib._SIGNATURES["packed_tf"][
        "pw_packed_wgrad"][1]
    with pytest.raises(ValueError):
        P.pw_wgrad_geometry(0, 5, 1, 1)


def test_the_variant_tools_constants_are_the_sources():
    """``tools/kernel_variants.py pw_wgrad`` rebuilds the kernel at other
    values of the source's constants, one ``A:B:..`` value each."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "kernel_variants.py")
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    _, consts = _source()
    names = kv.KERNELS["pw_wgrad"][1]
    assert all(name in consts for name in names)
    for v in kv.KERNELS["pw_wgrad"][5]:
        assert len(kv._values("pw_wgrad", v)) == len(names)
