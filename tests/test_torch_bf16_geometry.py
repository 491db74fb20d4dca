"""The bf16 forward kernels' geometry, on the CPU.

``csrc/sru_fused.cu`` (``sru_lay0_fwd_bf16_kernel``,
``sru_hid_fwd_bf16_kernel``) and ``csrc/convt_tm.cu``
(``convt1d_tm_fwd_bf16_kernel``) launch with the geometry of
``ops/sru_fused.k1_fwd_geometry`` / ``k2_fwd_geometry`` and
``ops/convt_tm.fwd_geometry`` at element size 2. These tests walk them as
the kernels do:

- K1: each warp's 16-byte copies of its 32 values of a gate row
  (``k1_bf16_copies``) at the batch-minor rows of the two scans, 125 B
  and 64 B for B 1-8 (125 B rows start at every offset mod 8), every
  lane's value found at its shifted place, nothing read past u's end; the
  ring of LAY0_AHEAD steps with copies landing at issue or at the wait;
- K2: its blocks, shared memory, copy widths and X chunk copies, its
  m16n8k16 fragments (each register the two values the tensor core takes
  there) and their banks, and the held kernel's limit (H 536), above
  which it streams;
- K3: its channel split (slices of 16, float32 partials summed in order
  and rounded once), its shared memory, the x ring's swizzle, and its
  fragments and banks;
- K6 and K7's bf16 kernels (``csrc/packed_tf.cu`` ``pw_proj_bf16_kernel``,
  ``pw_unproj_bf16_kernel``): their constants and grid, each fragment
  register read where the kernels read it from the staged tiles, a
  block's tile as its warps form it, and the output tile's room.

A hypothesis property runs them at every width 8-160 the float32
geometry tests take.

- K4's bf16 entries (``csrc/sru_pallas.cu``
  ``sru_rec_fwd_kernel<__nv_bfloat16>`` and the scan's
  ``sru_scan_bwd_kernel<14>``): each value read as the 4-byte word that
  holds it, at rows of 125 B and 64 B values (B odd included), the array
  at a 4-byte and a 2-byte boundary, nothing read past its end;
- pw-wgrad's bf16 kernel (``pw_wgrad_bf16_kernel``): its planar rows
  staged at their offset in a 16-byte block, the copies aligned, and
  every m16n8k16 fragment register read where the kernel reads it.

~7 s alone.
"""

import os
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtfs_tpu_torch.ops import convt_tm, kernel_lib, packed_tf, sru_fused

# (T, B) of the scans at bs 1-8: frequency rows 125 B, time rows 64 B
SCAN_SITES = [(3, 125 * b) for b in range(1, 9)] + [(3, 64 * b)
                                                    for b in range(1, 9)]


def _mma_a(g, q, r, h):
    """(row, k) of A element h of register r of lane 4 g + q, m16n8k16."""
    return g + 8 * (r & 1), 2 * q + h + 8 * (r >> 1)


def _mma_b(g, q, r, h):
    """(k, n) of B element h of register r of lane 4 g + q."""
    return 2 * q + h + 8 * r, g


# ----------------------------------------------------------------- K1


@pytest.mark.parametrize("t_len,bsz", SCAN_SITES)
@pytest.mark.parametrize("hdim", [1, 3])
def test_k1_bf16_copies_land_every_value(t_len, bsz, hdim):
    geo = sru_fused.k1_fwd_geometry(t_len, hdim, bsz, 2)
    cols, units = geo["cols"], geo["units"]
    assert cols % 32 == 0  # a warp: one unit, 32 consecutive columns
    warps = cols * units // 32
    assert geo["smem"] == warps * sru_fused.LAY0_AHEAD * 4 * \
        sru_fused.LAY0_SPAN * 2 <= kernel_lib.SMEM_PER_BLOCK
    row = hdim * bsz
    total = t_len * 4 * row
    u = np.arange(total)  # each element its own index
    shifts = set()
    for bx in range(geo["grid"][0]):
        for w in range(warps):
            b0 = bx * cols + (w * 32) % cols
            for jy in range(geo["grid"][1]):
                j = jy * units + (w * 32) // cols
                if j >= hdim:
                    continue
                for t in range(t_len):
                    for g in range(4):
                        e0 = t * 4 * row + g * row + j * bsz + b0
                        shift, blocks = sru_fused.k1_bf16_copies(e0, total)
                        shifts.add(shift)
                        slot = []
                        for src, nbytes in blocks:
                            assert src % 8 == 0  # 16-byte aligned
                            assert 0 <= nbytes <= 16 and nbytes % 2 == 0
                            # a block wholly past the end reads nothing
                            # (the kernel points it at u itself)
                            assert nbytes == 0 or src + nbytes // 2 <= total
                            got = list(u[src:src + nbytes // 2])
                            slot += got + [-1] * (8 - len(got))
                        assert len(slot) == sru_fused.LAY0_SPAN
                        for lane in range(32):
                            if b0 + lane < bsz:
                                assert shift + lane < sru_fused.LAY0_SPAN
                                assert slot[shift + lane] == e0 + lane
    if bsz % 8:
        assert len(shifts) > 1  # rows start off the 16-byte grid


@pytest.mark.parametrize("land", ["issue", "wait"])
def test_k1_bf16_ring_reads_each_step_once_landed(land):
    """One lane's ring: step i's copies go to slot i % AHEAD; the lane
    waits until at most AHEAD - 1 groups are pending (step i's landed),
    meets the warp, reads, meets it again, then issues step i + AHEAD into
    the slot it read. Copies landing at issue or only at the wait, every
    read finds its own step."""
    ahead, t_len = sru_fused.LAY0_AHEAD, 3 * sru_fused.LAY0_AHEAD + 5
    slots, pending = [None] * ahead, []

    def issue(i):
        if i < t_len:
            if land == "issue":
                slots[i % ahead] = i
            else:
                pending.append(i)

    for i in range(ahead):
        issue(i)
    for i in range(t_len):
        while pending and pending[0] <= i:  # wait_group<AHEAD - 1>
            s = pending.pop(0)
            slots[s % ahead] = s
        assert slots[i % ahead] == i
        issue(i + ahead)


# ----------------------------------------------------------------- K2


def _k2_walk(t_len, hdim, bsz):
    geo = sru_fused.k2_fwd_geometry(t_len, hdim, bsz, 2)
    bt, steps, units = geo["bt"], geo["steps"], geo["units"]
    cols, vec = geo["cols"], geo["vec"]
    assert not geo["stream"]
    assert steps * bt == cols and cols % (16 * sru_fused.FWD_MT) == 0
    assert units * bt <= sru_fused.FWD_THREADS
    assert steps % min(steps, sru_fused.FWD_AHEAD) == 0
    assert geo["smem"] == sru_fused.k2_fwd_smem(hdim, cols, units, 2) \
        <= kernel_lib.SMEM_PER_BLOCK
    # the float32 kernel's unit split where its rows fit; never more
    # slices than it
    if sru_fused.k2_fwd_smem(hdim, 32, 8) <= kernel_lib.SMEM_PER_BLOCK:
        assert geo["slices"] <= sru_fused.k2_fwd_geometry(
            t_len, hdim, bsz)["slices"]
    # copy width: the widest of 8, 4, 2 dividing bt and B, else 1
    assert vec == next((w for w in (8, 4, 2) if bt % w == 0 and
                        bsz % w == 0), 1)
    # one chunk's X copies, vec values each: every (row, column) once, a
    # copy inside one row and one step, source and destination aligned to
    # its bytes
    k16 = -(-2 * hdim // 16) * 16
    xs = cols + 8
    seen = np.zeros((k16, cols), np.int32)
    for e in range(0, k16 * cols, vec):
        r, col = divmod(e, cols)
        s, c = divmod(col, bt)
        assert (col + vec - 1) // bt == s and col + vec <= cols
        seen[r, col:col + vec] += 1
        assert (r * xs + col) % vec == 0
        src = (5 * hdim + r % hdim) * bsz + (bsz // bt // 2) * bt + c
        assert src % vec == 0
    assert (seen == 1).all()
    return geo


@pytest.mark.parametrize("t_len,bsz", SCAN_SITES + [(37, 131), (1, 77)])
@pytest.mark.parametrize("hdim", [32, 48, 80])
def test_k2_bf16_geometry(t_len, bsz, hdim):
    _k2_walk(t_len, hdim, bsz)


@settings(max_examples=60, deadline=None)
@given(hdim=st.integers(1, 20).map(lambda n: 8 * n),
       bsz=st.sampled_from([1, 5, 64, 125, 131, 500, 512, 1000]),
       t_len=st.integers(1, 130))
def test_k2_bf16_geometry_any_width(hdim, bsz, t_len):
    _k2_walk(t_len, hdim, bsz)


def test_k2_bf16_fragments_and_banks():
    """The kernel's reads for one k16 step (A from X's slot [k][column],
    rows of N + 8 values; B from W_d [o][k], rows of 2H' + 8) are the
    elements m16n8k16 wants in each register half; A's 2-byte reads fall
    on 16 distinct banks (two lanes a word), B's 4-byte reads on 32."""
    for cols, hdim in ((64, 32), (32, 48), (64, 8), (32, 268)):
        xs = cols + 8
        ws = -(-2 * hdim // 16) * 16 + 8
        m0, k0, r0 = 16, 16 if hdim > 8 else 0, 8
        a_words, b_words = set(), []
        for g in range(8):
            for q in range(4):
                base = 2 * q * xs + m0 + g + k0 * xs  # xl + k0 xs
                kernel_a = [(base, base + xs), (base + 8, base + xs + 8),
                            (base + 8 * xs, base + 9 * xs),
                            (base + 8 * xs + 8, base + 9 * xs + 8)]
                for r in range(4):
                    for h in range(2):
                        row, kk = _mma_a(g, q, r, h)
                        assert kernel_a[r][h] == (k0 + kk) * xs + m0 + row
                wl = (r0 + g) * ws + 2 * q + k0
                for r in range(2):
                    for h in range(2):
                        kk, n = _mma_b(g, q, r, h)
                        assert wl + 8 * r + h == (r0 + n) * ws + k0 + kk
                assert wl % 2 == 0  # a 4-byte read
                a_words.add(kernel_a[0][0] // 2 % 32)
                b_words.append(wl // 2 % 32)
        assert len(a_words) == 16 and len(set(b_words)) == 32


@pytest.mark.parametrize("bsz", [1, 8, 33, 125])
def test_k2_bf16_limit(bsz):
    """H up to 536 holds 8 units' rows beside X's two slots (the held bf16
    kernel); above, the bf16 kernel streams its reduction: every H up to
    1024 gets a geometry whose streamed shared memory (one float32 U slot
    and a ring of FWD_STAGES bf16 stages, ``hid_fwd_bf16_stream_smem_bytes``)
    fits a block, the held one's does not (so the C entry streams exactly
    there), its stages are whole k16 steps, and the scan threads fit the
    block."""
    limit = kernel_lib.SMEM_PER_BLOCK
    assert sru_fused.k2_fwd_smem(536, 32, 8, 2) <= limit
    assert sru_fused.k2_fwd_smem(537, 32, 8, 2) > limit
    assert not sru_fused.k2_fwd_geometry(3, 536, bsz, 2)["stream"]
    assert sru_fused.FWD_K % 16 == 0 and sru_fused.FWD_K // 2 <= 32
    for h in (537, 600, 777, 1024):
        geo = sru_fused.k2_fwd_geometry(3, h, bsz, 2)
        units, cols = geo["units"], geo["cols"]
        assert geo["stream"] and geo["kslices"] == -(-2 * h // sru_fused.FWD_K)
        assert geo["smem"] == sru_fused.k2_fwd_stream_smem(cols, units, 2)
        assert geo["smem"] <= limit
        assert sru_fused.k2_fwd_smem(h, cols, units, 2) > limit
        assert units * geo["bt"] <= sru_fused.FWD_THREADS
        assert geo["slices"] * units >= h > (geo["slices"] - 1) * units
        rows = -(-3 * units // (8 * sru_fused.FWD_NB)) * 8 * sru_fused.FWD_NB
        assert geo["smem"] == (4 * rows * (cols + 4) + 2 * sru_fused.FWD_STAGES
                               * (sru_fused.FWD_K * (cols + 8)
                                  + rows * (sru_fused.FWD_K + 8)))


# ----------------------------------------------------------------- K3


def _ring16_at(i, c):
    return i * convt_tm.FWD_COLS + (c ^ (((i >> 2) & 1) << 3))


@settings(max_examples=60, deadline=None)
@given(c_in=st.integers(1, 20).map(lambda n: 8 * n),
       c_out=st.sampled_from([16, 20, 48, 64, 130]),
       k=st.sampled_from([3, 5, 8, 16]),
       bsz=st.sampled_from([1, 6, 33, 64, 125, 1000]))
def test_k3_bf16_split_and_partials(c_in, c_out, k, bsz):
    """Input channels in the fewest equal slices of 16 whose bf16 W_flat
    and ring fit a block (all of C_in where they do), output channels in
    blocks of 64; each (t, o, b) gets one float32 partial a slice, summed
    in slice order and rounded to bf16 once."""
    length = 9
    geo = convt_tm.fwd_geometry(length, c_in, c_out, k, bsz, 2)
    limit = kernel_lib.SMEM_PER_BLOCK
    ci = geo["ci_slice"]
    assert ci == c_in or ci % 16 == 0
    assert geo["smem"] == convt_tm.fwd_smem(k, ci, min(c_out, 64), 2) <= limit
    if geo["in_slices"] > 1:
        fewer = -(-(-(-c_in // (geo["in_slices"] - 1))) // 16) * 16
        assert convt_tm.fwd_smem(k, fewer, min(c_out, 64), 2) > limit
    assert geo["in_slices"] == -(-c_in // ci)
    assert geo["vec_x"] == next((w for w in (8, 4, 2) if bsz % w == 0), 1)
    assert geo["vec_w"] == next((w for w in (8, 4, 2) if c_in % w == 0), 1)
    # slices cover every input channel once; a W copy never straddles a
    # slice's last channel
    covered = np.zeros(c_in, np.int32)
    for z in range(geo["in_slices"]):
        ci0 = z * ci
        ci_n = min(ci, c_in - ci0)
        covered[ci0:ci0 + ci_n] += 1
        assert ci0 % 16 == 0 and ci_n % geo["vec_w"] == 0
    assert (covered == 1).all()
    # partials in float32, summed in order, rounded once: the same as one
    # float32 sum over the slices' terms in that order
    rng = np.random.default_rng(c_in + k)
    parts = rng.standard_normal((geo["in_slices"], 7)).astype(np.float32)
    total = np.zeros(7, np.float32)
    for p in parts:
        total = (total + p).astype(np.float32)
    assert total.dtype == np.float32


def test_k3_bf16_ring_and_fragments():
    """The x ring's swizzle keeps each 8-value group (a 16-byte copy)
    together; the kernel's B reads (two 2-byte reads a register, rows i0 +
    2q (+1, +8, +9), column n0 + g) are m16n8k16's B elements and fall on
    16 distinct banks; its A reads (W_flat rows of K C_in' + 8) are one
    aligned 4-byte read a register, on 32 banks."""
    fc = convt_tm.FWD_COLS
    for i in range(64):
        for c0 in (0, 8):
            got = [_ring16_at(i, c0 + c) for c in range(8)]
            assert got == list(range(got[0], got[0] + 8)) and got[0] % 8 == 0
    for k, cp in ((8, 64), (5, 32), (3, 16), (16, 80)):
        ws = k * cp + 8
        for n0 in (0, 8):
            banks = set()
            for g in range(8):
                for q in range(4):
                    xb = [_ring16_at(2 * q, n0 + g), _ring16_at(2 * q + 1, n0 + g),
                          _ring16_at(2 * q + 8, n0 + g),
                          _ring16_at(2 * q + 9, n0 + g)]
                    for r in range(2):
                        for h in range(2):
                            kk, n = _mma_b(g, q, r, h)
                            assert xb[2 * r + h] == _ring16_at(kk, n0 + n)
                    banks.add(xb[0] // 2 % 32)
            assert len(banks) == 16
        words = set()
        for g in range(8):
            for q in range(4):
                ra = (16 + g) * ws + 2 * q + 3 * cp  # wl + j cp, j 3
                for r in range(4):
                    row, kk = _mma_a(g, q, r, 0)
                    off = ra + (8 * ws if r & 1 else 0) + (8 if r >> 1 else 0)
                    assert off == (16 + row) * ws + 3 * cp + kk
                    assert off % 2 == 0
                words.add(ra // 2 % 32)
        assert len(words) == 32
    assert fc == 16


# ---------------------------------------------------------- K6 / K7 bf16


def _packed_source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_k6_k7_bf16_constants_and_grid_match_the_source():
    src, consts = _packed_source()
    assert (consts["kP16M"], consts["kP16N"], consts["kP16K"],
            consts["kP16Threads"]) == (packed_tf.PROJ16_M, packed_tf.PROJ16_N,
                                       packed_tf.PROJ16_K,
                                       packed_tf.PROJ16_THREADS)
    assert "constexpr int kP16XS = kP16M + 8;" in src
    assert "constexpr int kP16KS = kP16K + 8;" in src
    # 4 x 2 warps of 32 x 32
    assert packed_tf.PROJ16_THREADS // 32 == (packed_tf.PROJ16_M // 32) * (
        packed_tf.PROJ16_N // 32)
    geo = packed_tf.pw_proj16_geometry(8, 251 * 129, 256, 64)
    assert geo["grid"] == (-(-251 * 129 // 128), 1, 8) and geo["stages"] == 8
    assert packed_tf.pw_proj16_geometry(1, 32379, 64, 256)["grid"] == (
        253, 4, 1)
    with pytest.raises(ValueError):
        packed_tf.pw_proj16_geometry(70000, 10, 8, 8)
    with pytest.raises(ValueError):
        packed_tf.pw_proj16_geometry(1, 0, 8, 8)


def _p16_tile(a_at, w_at, k_depth):
    """The (128, 64) sums of one block as its 8 warps form them: warp w
    owns positions 32 (w % 4) .. and channels 32 (w / 4) .., m16n8k16
    fragments (``_mma_a`` / ``_mma_b``) over kP16K stages of two k16
    steps; a_at(m, k) and w_at(k, n) as the stage holds them (zero past
    the ends). Returns the float64 sums at the (m, n) each lane's c0-c3
    name (c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1))."""
    out = np.full((128, 64), np.nan)
    for w in range(8):
        wm, wn = (w & 3) * 32, (w >> 2) * 32
        for mt in range(2):
            for nb in range(4):
                acc = np.zeros((32, 4))
                for k0 in range(0, -(-k_depth // 32) * 32, 16):
                    for lane in range(32):
                        g, q = lane >> 2, lane & 3
                        for v in range(4):  # D element v of the lane
                            m = wm + 16 * mt + g + 8 * (v >> 1)
                            n = wn + 8 * nb + 2 * q + (v & 1)
                            acc[lane, v] += sum(
                                a_at(m, k0 + k) * w_at(k0 + k, n)
                                for k in range(16))
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    for v in range(4):
                        m = wm + 16 * mt + g + 8 * (v >> 1)
                        n = wn + 8 * nb + 2 * q + (v & 1)
                        assert np.isnan(out[m, n])  # each output once
                        out[m, n] = acc[lane, v]
    return out


def test_k6_k7_bf16_fragments_read_the_staged_tiles():
    """K6's x stage ([k][m], rows of kP16XS) and K7's ([m][k], rows of
    kP16KS), W's ([n][k]): each register of the m16n8k16 fragments, read
    where the kernels read it, holds the A and B element the tensor core
    takes there (``_mma_a`` / ``_mma_b``), and a block's tile is the
    product; the 8 g x 4 q lanes of each 4-byte read hit distinct banks
    or share a word."""
    xs, ks = packed_tf.PROJ16_M + 8, packed_tf.PROJ16_K + 8
    rng = np.random.default_rng(3)
    k_depth = 40  # a ragged last stage
    x = rng.standard_normal((128, 64))  # (m, k), zero past k_depth
    x[:, k_depth:] = 0
    w = rng.standard_normal((64, 64))   # (k, n)
    w[k_depth:] = 0
    for g in range(8):
        for q in range(4):
            for r in range(4):
                for h in range(2):
                    m, k = _mma_a(g, q, r, h)
                    # K6: pack(p[0], p[xs]) etc. at xs-row 2q (+8) + h
                    k6 = (2 * q + 8 * (r >> 1) + h, g + 8 * (r & 1))
                    assert k6 == (k, m)
                    # K7: a 4-byte read at row g (+8), k 2q (+8), half h
                    k7 = (g + 8 * (r & 1), 2 * q + 8 * (r >> 1) + h)
                    assert k7 == (m, k)
            for r in range(2):
                for h in range(2):
                    assert _mma_b(g, q, r, h) == (2 * q + 8 * r + h, g)
    # banks of the 4-byte reads: K7's A and both kernels' B rows of
    # kP16KS bf16 (20 words), K6's A halves rows 2q apart of kP16XS
    for rows in (ks,):
        words = {(g * rows + 2 * q) // 2 % 32 for g in range(8)
                 for q in range(4)}
        assert len(words) == 32
    k6_words = {((2 * q) * xs + g) // 2 for g in range(8) for q in range(4)}
    assert len({wd % 32 for wd in k6_words}) == len(k6_words)
    tile = _p16_tile(lambda m, k: x[m, k], lambda k, n: w[k, n], k_depth)
    np.testing.assert_allclose(tile, x @ w, rtol=1e-12, atol=1e-12)


def test_k7_bf16_output_tile_fits_the_stages():
    """K7 stages its (64, 136) bf16 output tile in the two stages' shared
    memory, which the last barrier has freed."""
    stages = 2 * (packed_tf.PROJ16_M + packed_tf.PROJ16_N) * (
        packed_tf.PROJ16_K + 8)
    assert packed_tf.PROJ16_N * (packed_tf.PROJ16_M + 8) <= stages
    assert 2 * stages <= 48 * 1024  # static shared memory


# ----------------------------------------------------- K4 and the scan


def _word_reads(base, e, last, ok=True):
    """``copy_value`` of csrc/sru_scan.cuh on bf16: the 4-byte word that
    holds value e of an array at byte address ``base`` (its last value at
    ``last``): (word address, bytes read)."""
    a = base + 2 * e
    ok = np.asarray(ok, dtype=bool)
    n = np.where(~ok, 0, np.where((e == last) & ((a & 2) == 0), 2, 4))
    return a & ~3, n


def _upper_half(base, e0, step, i):
    """``upper_half``: whether value e0 + i step lies in the upper half of
    its word, from parities alone."""
    return ((base >> 1) ^ e0 ^ (i & step)) & 1


def _read(buf, base, e0, step, i, last, ok=True):
    """The float value ``slot_value`` takes from the word ``copy_value``
    copied for value e0 + i step (zero where not ok), checking that no
    byte outside the array is read."""
    e = e0 + i * step
    ok = np.asarray(ok, dtype=bool)
    word, n = _word_reads(base, np.where(ok, e, 0), last, ok)
    assert (word >= base & ~3).all()
    assert (np.where(n > 0, word + n, 0) <= base + 2 * (last + 1)).all()
    lo = buf[(word - (base & ~3)) // 2]
    hi = np.where(n == 4, buf[np.minimum((word - (base & ~3)) // 2 + 1,
                                         len(buf) - 1)], 0)
    up = _upper_half(base, e0, step, i)
    got = np.where(up == 1, hi, lo)
    return np.where(ok, got, 0)


def _array(n, base):
    """An array of n values numbered 1 .. n (as ints, one a bf16 slot) at
    byte address ``base``, in a buffer of 2-byte slots from its first
    word (base & ~3), one slot past its end."""
    pad = (base & 3) // 2
    buf = np.concatenate([np.full(pad, -1), np.arange(1, n + 1),
                          [-2]]).astype(np.int64)
    return buf


# the uni sites: frequency rows of 125 B values, time rows of 64 B, B odd
# (bs 1, 3, 5: the rows start on 2-byte boundaries) and even
K4_WORD_SITES = [(5, 125 * b) for b in (1, 2, 3, 5)] + [
    (5, 64 * b) for b in (1, 3)] + [(3, 7)]


@pytest.mark.parametrize("t_len,bsz", K4_WORD_SITES)
@pytest.mark.parametrize("base", [256, 258])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4_bf16_word_reads_take_every_value(t_len, bsz, base, reverse):
    """K4 forward (``sru_rec_fwd_kernel<__nv_bfloat16>``) and backward
    (``sru_scan_bwd_kernel<14>``) read each bf16 value as the 4-byte word
    that holds it (cp.async has no 2-byte copy): at every (step, unit,
    column) of u (T, 3H, B), xhw, c and dh (T, H, B), for u at a 4-byte
    and at a 2-byte boundary, every value is the one the scan needs, and
    no byte past the array is read (the last value, in a lower half,
    reads 2 bytes)."""
    hdim = 3
    hb = hdim * bsz
    t = np.arange(t_len)[:, None, None]
    j = np.arange(hdim)[None, :, None]
    b = np.arange(bsz)[None, None, :]
    col = j * bsz + b
    # the forward: step i's values at t = i or T-1-i
    u_buf, x_buf = _array(t_len * 3 * hb, base), _array(t_len * hb, base)
    u_last, x_last = t_len * 3 * hb - 1, t_len * hb - 1
    steps = t_len - 1 - t if reverse else t
    eu = steps * 3 * hb + col
    for g in range(3):
        got = _read(u_buf, base, eu + g * hb, 0, 0, u_last)
        np.testing.assert_array_equal(got, eu + g * hb + 1)
    ex = steps * hb + col
    np.testing.assert_array_equal(_read(x_buf, base, ex, 0, 0, x_last),
                                  ex + 1)
    # the backward scan: scan index i, offsets moved by one step each
    t0 = 0 if reverse else t_len - 1
    su, sx = (3 * hb, hb) if reverse else (-3 * hb, -hb)
    i = t  # the scan index
    ou0, ox0, og0 = t0 * 3 * hb + col, t0 * hb + col, t0 * hb + col
    for g in range(3):
        want = ou0 + g * hb + i * su
        np.testing.assert_array_equal(
            _read(u_buf, base, ou0 + g * hb, su, i, u_last), want + 1)
    np.testing.assert_array_equal(_read(x_buf, base, ox0, sx, i, x_last),
                                  ox0 + i * sx + 1)
    s_buf, s_last = _array(t_len * hb, base), t_len * hb - 1
    np.testing.assert_array_equal(_read(s_buf, base, og0, sx, i, s_last),
                                  og0 + i * sx + 1)  # dh
    ok_c = i + 1 < t_len  # c_prev, zero past the scan's end
    np.testing.assert_array_equal(
        _read(s_buf, base, og0 + sx, sx, i, s_last, ok_c),
        np.where(ok_c, og0 + sx + i * sx + 1, 0))


def test_k4_bf16_entries_match_the_source():
    """The bf16 entries of K4 take the float32 entries' arguments, and the
    backward's scan is ScanTypes<14> (bf16 storage, (v, b) sums rounded a
    batch column)."""
    with open(os.path.join(kernel_lib.CSRC_DIR, "sru_pallas.cu")) as f:
        src = f.read()
    with open(os.path.join(kernel_lib.CSRC_DIR, "sru_scan.cuh")) as f:
        scan = f.read()
    sig = kernel_lib._SIGNATURES["sru_pallas"]
    for fn in ("sru_recurrence_fwd", "sru_recurrence_bwd"):
        assert sig[fn + "_bf16"] == sig[fn]
        assert f'extern "C" int {fn}_bf16(' in src
    assert "launch_scan_bwd<14>" in src and "launch_rec_fwd<__nv_bfloat16>" \
        in src
    spec = scan.split("struct ScanTypes<14> {")[1].split("};")[0]
    assert "__nv_bfloat16" in spec and "kRoundParts = true" in spec


# ------------------------------------------------------- pw-wgrad bf16


def _pw16_stage(p_vals, base2, b, cp0, cp, m, p0, avail):
    """pw_wgrad_bf16_kernel's planar side of one stage: the staged rows
    (kPwRows, kPw16PS), as the kernel's threads copy them (16-byte blocks
    of 8 values whole, the window's ends value by value, zero past the
    chunk), and the 16-byte copies' (source, destination) bf16 offsets.
    p_vals(c, pos) the value at planar channel c, position pos; base2 the
    array's address in bf16 units."""
    rows, k = packed_tf.PW_WGRAD_ROWS, packed_tf.PW_WGRAD_K
    ps = packed_tf.PW_WGRAD16_PS
    staged = np.full((rows, ps), np.nan)
    copies = []
    for tid in range(rows):
        if cp0 + tid >= cp:
            continue
        row_e = (b * cp + cp0 + tid) * m  # the channel row's first value
        sh = (base2 + row_e + p0) % 8
        dst = _staged_row(tid)
        for j in range(k // 8 + 1):
            lo = 8 * j - sh
            if lo + 8 <= 0 or lo >= k:
                continue
            whole = lo >= 0 and lo + 8 <= k and lo + 8 <= avail
            if whole:
                copies.append((base2 + row_e + p0 + lo, dst * ps + 8 * j))
            for e in range(8):
                if 0 <= lo + e < k:
                    staged[dst, 8 * j + e] = (
                        p_vals(cp0 + tid, p0 + lo + e) if lo + e < avail
                        else 0.0)
    return staged, copies


def _staged_row(r):
    return (r & ~63) | ((r & 3) << 4) | ((r & 63) >> 2)


@pytest.mark.parametrize("m,base2,p0,avail", [
    (251 * 129, 0, 0, 64), (251 * 129, 0, 128, 64), (251 * 129, 1, 64, 64),
    (251 * 129, 3, 2048, 37), (96, 0, 0, 64), (21, 5, 0, 21)])
def test_pw_wgrad_bf16_staging_and_fragments(m, base2, p0, avail):
    """The bf16 pw-wgrad's stage and fragments: each planar row lands at
    the offset of its first position in its 16-byte block (rows of M =
    251 * 129 values start at every offset mod 8), its whole blocks copied
    16-byte aligned on both sides; every A register (two neighbouring
    positions of one channel, rows g and g + 8 of a tile 32 channels apart
    with one offset) and B register (two neighbouring positions of one
    packed channel) read where the kernel reads it holds the element the
    m16n8k16 product takes there (``_mma_a`` / ``_mma_b``), zero past the
    chunk; the output tile fits the ring's place."""
    rows, k, cols = (packed_tf.PW_WGRAD_ROWS, packed_tf.PW_WGRAD_K,
                     packed_tf.PW_WGRAD_COLS)
    ps, qs = packed_tf.PW_WGRAD16_PS, packed_tf.PW_WGRAD16_QS
    b, cp, cp0 = 1, 256, 128

    def p_vals(c, pos):
        return 1000.0 * c + pos

    staged, copies = _pw16_stage(p_vals, base2, b, cp0, cp, m, p0, avail)
    for src, dst in copies:
        assert src % 8 == 0 and dst % 8 == 0  # 16-byte aligned both sides
    # the packed side: position pp's channels at row pp of kPw16QS
    q_stage = np.array([[pp * 10.0 + n if pp < avail else 0.0
                         for n in range(qs)] for pp in range(k)])

    def shift(c):
        return (base2 + (b * cp + cp0 + c) * m + p0) % 8

    warps_m = rows // 32
    for warp in range(2 * warps_m):
        wm, wn = warp % warps_m, warp // warps_m
        for mi in range(2):
            t = 2 * wm + mi
            for g in range(8):
                ch = 64 * (t >> 2) + 4 * g + (t & 3)
                assert shift(ch + 32) == shift(ch)
                a_off = (16 * t + g) * ps + shift(ch) + 0
                for q in range(4):
                    for kk in range(0, k, 16):
                        pa = a_off + 2 * q + kk
                        regs = [(pa, pa + 1), (pa + 8 * ps, pa + 8 * ps + 1),
                                (pa + 8, pa + 9),
                                (pa + 8 * ps + 8, pa + 8 * ps + 9)]
                        for r, pair in enumerate(regs):
                            for h, off in enumerate(pair):
                                row, kk_ = _mma_a(g, q, r, h)
                                want_c = ch + 32 * (row >= 8)
                                pos = kk + kk_
                                want = (p_vals(cp0 + want_c, p0 + pos)
                                        if pos < avail else 0.0)
                                got = staged.reshape(-1)[off]
                                assert got == want, (t, g, q, r, h)
        for nj in range(4):
            for g in range(8):
                for q in range(4):
                    b_off = 2 * q * qs + 32 * wn + g
                    for kk in range(0, k, 16):
                        pb = b_off + 8 * nj + kk * qs
                        regs = [(pb, pb + qs), (pb + 8 * qs, pb + 9 * qs)]
                        for r, pair in enumerate(regs):
                            for h, off in enumerate(pair):
                                kq, n = _mma_b(g, q, r, h)
                                pp = kk + kq
                                want = (pp * 10.0 + 32 * wn + 8 * nj + n
                                        if pp < avail else 0.0)
                                assert q_stage.reshape(-1)[off] == want
    # no staged column past the row is read: sh + 63 + 9 < kPw16PS
    assert 7 + (k - 16) + 6 + 9 < ps
    assert packed_tf.pw_wgrad16_smem() <= kernel_lib.SMEM_PER_BLOCK


def test_pw_wgrad_bf16_constants_match_the_source():
    src, consts = _packed_source()
    assert "constexpr int kPw16PS = kPwK + 8;" in src
    assert "constexpr int kPw16QS = kPwCols + 8;" in src
    assert (packed_tf.PW_WGRAD16_PS, packed_tf.PW_WGRAD16_QS) == (
        consts["kPwK"] + 8, consts["kPwCols"] + 8)
    # 144-byte rows: 16-byte aligned copies; the B reads' words 8 q + g / 2
    assert 2 * packed_tf.PW_WGRAD16_PS % 16 == 0
    words = {(2 * q * packed_tf.PW_WGRAD16_QS + g) // 2 % 32
             for g in range(8) for q in range(4)}
    assert len(words) == 16  # each word shared by two lanes, none clash
    sig = kernel_lib._SIGNATURES["packed_tf"]
    assert sig["pw_packed_wgrad_bf16"] == sig["pw_packed_wgrad"]
    assert sig["dw_conv_packed_wgrad_bf16"] == sig["dw_conv_packed_wgrad"]
    body = src.split("pw_wgrad_bf16_kernel(const __nv_bfloat16*")[1].split(
        'extern "C"')[0]
    assert "atomic" not in body and "hk::mma_bf16" in body
    assert "if (++since == kPwFlush || s == ns - 1)" in body
