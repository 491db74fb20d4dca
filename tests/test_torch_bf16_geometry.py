"""The bf16 forward kernels' geometry, on the CPU.

``csrc/sru_fused.cu`` (``sru_lay0_fwd16_kernel`` and its backward,
``sru_hid_fwd_bf16_kernel``) and ``csrc/convt_tm.cu``
(``convt1d_tm_fwd_bf16_kernel``) launch with the geometry of
``ops/sru_fused.k1_fwd_geometry`` (element size 2) /
``k2_fwd_bf16_geometry`` and ``ops/convt_tm.fwd_bf16_geometry``. These
tests walk them as the kernels do:

- K1 (``sru_lay0_fwd16_kernel``, ``sru_lay0_bwd16_kernel``): each
  warp's 16-byte copies of a group of steps (``k1_bf16_group_copies``)
  at B 125, 131, 64 and 1000, T 1, 5 and 118, rows H B odd and even,
  every value of u (and of dh and c backward) read once at its lane's
  shifted place, nothing read past an array's end; the ring of AHEAD + 1
  group slots with copies landing at issue or at the wait; the constants
  against the source;
- K2 (``sru_hid_fwd_bf16_kernel``, ``k2_fwd_bf16_geometry``): its
  blocks, shared memory, the candidate it picks, copy widths and X chunk
  copies (or, where B is odd, the words that hold each row), its
  ldmatrix rows as m16n8k16 fragments and their banks, the scan warps'
  banks, and the held kernel's limit, above which it streams;
- K3 (``convt1d_tm_fwd_bf16_kernel``, ``fwd_bf16_geometry``): its tile,
  channel split (slices of 16, float32 partials summed in order and
  rounded once) and shared memory, the x ring's and W_flat's ldmatrix
  rows as fragments and their banks, the output staging tile;
- K6 and K7's bf16 kernels (``csrc/packed_tf.cu`` ``pw_proj_bf16_kernel``,
  ``pw_unproj_bf16_kernel``): their constants and grid, each fragment
  register read where the kernels read it from the staged tiles, a
  block's tile as its warps form it, and the output tile's room.

A hypothesis property runs them at every width 8-160 the float32
geometry tests take.

- K4's bf16 backward (the scan's ``sru_scan_bwd_kernel<14>``): each
  value read as the 4-byte word that holds it, at rows of 125 B and 64 B
  values (B odd included), the array at a 4-byte and a 2-byte boundary,
  nothing read past its end;
- K4's bf16 forward (``csrc/sru_pallas.cu`` ``sru_rec_fwd16_kernel``):
  every warp's copies of a group of steps over u's three gate rows and
  xhw's highway row at H 3, 8, 32, 80, B 125, 131, 64, 1000, T 1, 5, 118,
  both directions, every value read once at its lane's offset (all
  offsets mod 8 where B is odd); the ring of group slots; the constants;
- pw-wgrad's bf16 kernel (``pw_wgrad16_kernel``): each class's shifted
  windows over the chunks (every position once, the packed stage's halo
  zero outside the row) at the packed sites, an emulation of its
  staging in float64 against sum_p a^T g, its ldmatrix fragments and
  banks, the output tile and the cluster's shares, the constants.

~17 s alone (the K4 bf16 walks ~4 s, pw-wgrad's ~3 s).
"""

import os
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtfs_tpu_torch.ops import (convt_tm, kernel_lib, packed_tf, sru_fused,
                                sru_pallas)

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


def _k1_bf16_walk(kind, t_len, hdim, bsz):
    """A K1 bf16 kernel (``sru_lay0_fwd16_kernel`` for ``kind`` "fwd",
    ``sru_lay0_bwd16_kernel`` for "bwd") walked as it runs, every warp of
    every block, both directions: each group's copies
    (``k1_bf16_group_copies``, five 16-byte blocks a row) into a
    slot of element ids, then each live lane's reads of its steps, at the
    kernel's shift. Returns {array: reads of each element} for u, and for
    the backward dh and c (c_t of the scan's first step is read directly,
    not copied)."""
    fwd = kind == "fwd"
    n_rows = 4 if fwd else 6
    geo = (sru_fused.k1_fwd_geometry(t_len, hdim, bsz, 2) if fwd
           else sru_fused.k1_bwd_bf16_geometry(t_len, hdim, bsz))
    cols, units = geo["cols"], geo["units"]
    assert cols % 32 == 0  # a warp: one unit, 32 consecutive columns
    threads = cols * units
    ahead = sru_fused.LAY16_FWD_AHEAD if fwd else sru_fused.LAY16_BWD_AHEAD
    assert geo["ahead"] == ahead
    assert geo["smem"] == (threads // 32) * (ahead + 1) * \
        sru_fused.LAY16_GROUP * n_rows * sru_fused.LAY16_SPAN * 2 \
        <= kernel_lib.SMEM_PER_BLOCK
    if not fwd:
        assert geo["parts"] == geo["grid"][0]
    gx, gy, gz = geo["grid"]
    assert (gx, gy, gz) == (-(-bsz // cols), -(-hdim // units), 2)
    # every warp whose unit is in range: its unit and first column
    js, b0s = [], []
    for x in range(gx):
        for y in range(gy):
            for wi in range(threads // 32):
                jj = y * units + (wi * 32) // cols
                if jj < hdim:
                    js.append(jj)
                    b0s.append(x * cols + (wi * 32) % cols)
    j, b0 = np.array(js, np.int64), np.array(b0s, np.int64)
    row, group, span = hdim * bsz, sru_fused.LAY16_GROUP, sru_fused.LAY16_SPAN
    col = j * bsz + b0
    lanes = np.arange(32)
    live = (b0[:, None] + lanes[None, :]) < bsz
    sizes = {"u": t_len * 4 * row, "dh": t_len * row, "c": t_len * row}
    base = {"u": 0, "dh": 1 << 40, "c": 2 << 40}  # an id: array, element
    reads = {a: np.zeros((2, n), np.int64) for a, n in sizes.items()}
    plan = sru_fused.k1_bf16_group_copies(n_rows)
    # a lane owns one block of one row, copied for each step of the group
    assert sorted(plan) == sorted(
        (lane, s, lane // 5, lane % 5) for lane in range(5 * n_rows)
        for s in range(group))
    assert 5 * n_rows <= 32

    def element(d, i, r):
        """(array, element of each warp's first value) of scan step i's
        row r, or None: the kernels' rows lambdas."""
        if fwd:
            t = i if d == 0 else t_len - 1 - i
            return "u", t * 4 * row + r * row + col
        t = t_len - 1 - i if d == 0 else i
        if r < 4:
            return "u", t * 4 * row + r * row + col
        if r == 4:
            return "dh", t * row + col
        if i + 1 >= t_len:
            return None
        return "c", (t - 1 if d == 0 else t + 1) * row + col

    for d in range(2):
        for n in range(-(-t_len // group)):
            slot = np.full((len(j), group * n_rows, span), -1, np.int64)
            for lane, s, r, k in plan:
                i = n * group + s
                got = element(d, i, r) if i < t_len else None
                if got is None:
                    continue
                arr, e0 = got
                src = e0 - e0 % 8 + 8 * k
                left = sizes[arr] - src
                # 16 bytes, or what is left; no copy at or past the end
                nvals = np.clip(left, 0, 8)
                assert (src % 8 == 0).all()  # 16-byte aligned
                assert ((nvals == 0) | (src + nvals <= sizes[arr])).all()
                for m in range(8):
                    hit = nvals > m
                    slot[hit, s * n_rows + r, 8 * k + m] = (
                        base[arr] + src[hit] + m)
            for s in range(min(group, t_len - n * group)):
                i = n * group + s
                for r in range(n_rows):
                    got = element(d, i, r)
                    if got is None:
                        continue
                    arr, e0 = got
                    # the kernels' shift, worked out once a lane: the
                    # element mod 8 in 32 bits at group 0's step of the
                    # same parity (u's rows) or the same step (dh; c_prev
                    # at the next one's)
                    t0 = ((0 if d == 0 else t_len - 1) if fwd else
                          (t_len - 1 if d == 0 else 0))
                    dt = (1 if d == 0 else -1) if fwd else (
                        -1 if d == 0 else 1)
                    row4, row1 = (np.uint32(4 * row % 2 ** 32),
                                  np.uint32(row % 2 ** 32))
                    c32 = (col % 2 ** 32).astype(np.uint32)
                    if r < 4:
                        tp = np.uint32((t0 + dt * (s & 1)) % 2 ** 32)
                        e = tp * row4 + np.uint32(r) * row1 + c32
                    else:
                        q = s if r == 4 else (s + 1) % group
                        e = np.uint32((t0 + dt * q) % 2 ** 32) * row1 + c32
                    shift = e.astype(np.uint32) & 7
                    assert (shift.astype(np.int64) == e0 % 8).all()
                    pos = shift.astype(np.int64)[:, None] + lanes[None, :]
                    assert (pos < span).all()
                    val = slot[np.arange(len(j))[:, None], s * n_rows + r,
                               pos]
                    want = base[arr] + e0[:, None] + lanes[None, :]
                    assert (val[live] == want[live]).all()
                    np.add.at(reads[arr][d], (e0[:, None] + lanes)[live], 1)
        if not fwd:  # the first step's c_t, read directly
            t0 = t_len - 1 if d == 0 else 0
            np.add.at(reads["c"][d], ((t0 * row + col)[:, None]
                                      + lanes)[live], 1)
    return reads if not fwd else {"u": reads["u"]}


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("t_len", [1, 5, 118])
@pytest.mark.parametrize("bsz", [125, 131, 64, 1000])
@pytest.mark.parametrize("hdim", [3, 8])  # rows H B odd where B is, even
def test_k1_bf16_group_copies_read_every_value_once(kind, t_len, bsz, hdim):
    """Every (t, unit, column, direction) of each row a K1 bf16 kernel
    reads (the forward's u; the backward's u, dh and c) is copied by its
    warp's group, lands at the slot place its lane reads, and is read
    exactly once; no copy reads past its array, and rows start at every
    offset mod 8 where B is odd."""
    reads = _k1_bf16_walk(kind, t_len, hdim, bsz)
    for arr, got in reads.items():
        assert (got == 1).all(), (arr, int((got != 1).sum()))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("t_len", [1, 5, 118])
@pytest.mark.parametrize("land", ["issue", "wait"])
def test_k1_bf16_ring_reads_each_group_once_landed(kind, t_len, land):
    """One lane's ring of AHEAD + 1 group slots: group n's copies go to
    slot n % (AHEAD + 1) as one commit group (empty past T); at group n the
    lane waits until at most AHEAD - 1 groups are pending (n's landed),
    meets its warp, issues group n + AHEAD into the slot of group n - 1
    (read before the meeting), then reads group n. Copies landing at issue
    or only at the wait, every read finds its own group, and no slot is
    refilled before its group is read."""
    ahead = (sru_fused.LAY16_FWD_AHEAD if kind == "fwd"
             else sru_fused.LAY16_BWD_AHEAD)
    n_slots, group = ahead + 1, sru_fused.LAY16_GROUP
    n_groups = -(-t_len // group)
    slots, pending, read = [None] * n_slots, [], []

    def issue(n):
        if n * group >= t_len:  # an empty commit group
            pending.append(None)
        elif land == "issue":
            assert slots[n % n_slots] in (None, *read)
            slots[n % n_slots] = n
            pending.append(None)
        else:
            pending.append(n)

    for n in range(ahead):
        issue(n)
    for n in range(n_groups):
        while len(pending) > ahead - 1:  # wait_group<AHEAD - 1>
            m = pending.pop(0)
            if m is not None:
                assert slots[m % n_slots] in (None, *read)
                slots[m % n_slots] = m
        assert (n + ahead) % n_slots == (n - 1) % n_slots
        issue(n + ahead)
        assert slots[n % n_slots] == n
        read.append(n)
    assert read == list(range(n_groups))


def test_k1_bf16_constants_and_entries():
    """The Python mirrors equal csrc/sru_fused.cu's constants, and the two
    C entries keep their signatures."""
    path = os.path.join(kernel_lib.CSRC_DIR, "sru_fused.cu")
    with open(path) as f:
        src = f.read()
    for name, value in (("kL16Group", sru_fused.LAY16_GROUP),
                        ("kL16FwdAhead", sru_fused.LAY16_FWD_AHEAD),
                        ("kL16BwdAhead", sru_fused.LAY16_BWD_AHEAD),
                        ("kL16Span", sru_fused.LAY16_SPAN),
                        ("kLay0Threads", sru_fused.LAY0_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert sru_fused.LAY16_SPAN == 5 * 8  # 32 values at any offset mod 8
    for copy in ("l16_copy_group<4>", "l16_copy_group<6>"):
        assert copy in src
    sig = kernel_lib._SIGNATURES["sru_fused"]
    assert sig["sru_dual_recurrence_fwd_bf16"] == (7, 5)
    assert sig["sru_dual_recurrence_bwd_bf16"] == (10, 5)


# ----------------------------------------------------------------- K2


def _k2_walk(t_len, hdim, bsz):
    """The bf16 K2 forward's geometry (``k2_fwd_bf16_geometry``) as
    ``sru_hid_fwd_bf16_kernel`` walks it: its blocks and shared memory,
    the candidate it picks, and one chunk's copies of X."""
    geo = sru_fused.k2_fwd_bf16_geometry(t_len, hdim, bsz)
    bt, steps, units = geo["bt"], geo["steps"], geo["units"]
    cols, vec, slices = geo["cols"], geo["vec"], geo["slices"]
    limit = kernel_lib.SMEM_PER_BLOCK
    assert not geo["stream"]
    assert bt in (8, 4, 2, 1) and cols in (16, 32, 64)
    assert steps * bt == cols and geo["chunks"] == -(-t_len // steps)
    assert units * bt <= sru_fused.FWD16_SCAN_MAX
    assert geo["grid"] == (-(-bsz // bt), 2, slices)
    assert (slices - 1) * units < hdim <= slices * units
    assert geo["smem"] == sru_fused.k2_fwd_bf16_smem(hdim, cols, units, bt,
                                                     vec) <= limit
    # copy width: the widest of 8, 4, 2 dividing bt and B, else words
    assert vec == next((w for w in (8, 4, 2) if bt % w == 0 and
                        bsz % w == 0), 1)
    # the pick: bt 8 where B is a multiple of 4 (8- or 16-byte copies)
    # and it fits, else 1; the fewest slices that fit, then more until the
    # grid fills the card where any does; the chunk the widest whose
    # blocks are all resident, where one is
    def fits(u, b, c=16):
        return u * b <= sru_fused.FWD16_SCAN_MAX and sru_fused.k2_fwd_bf16_smem(
            hdim, c, u, b, sru_fused.k2_bf16_vec(b, bsz)) <= limit

    def fill(b, n):
        return -(-bsz // b) * 2 * n >= kernel_lib.SMS

    wide = bsz % 4 == 0 and bsz >= 8 and any(
        fits(-(-hdim // n), 8) for n in range(1, hdim + 1))
    assert bt == (8 if wide else 1)
    first = next(n for n in range(1, hdim + 1) if fits(-(-hdim // n), bt))
    first = -(-hdim // -(-hdim // first))
    if fill(bt, first):
        assert slices == first
    else:
        assert slices >= first and (fill(bt, slices) or not any(
            fill(bt, n) and fits(-(-hdim // n), bt)
            for n in range(first, hdim + 1)))
    if geo["blocks"] <= kernel_lib.SMS * geo["per_sm"]:
        for c in (64, 32):
            if c > cols and fits(units, bt, c):
                wider = sru_fused.k2_fwd_bf16_smem(hdim, c, units, bt, vec)
                assert kernel_lib.SMS * min(
                    kernel_lib.SMEM_PER_SM // (wider + 1024),
                    2048 // geo["threads"], 2) < geo["blocks"]
    # one chunk's X copies at the middle tile and every step: vec values
    # a copy (every (row, column) once, inside one step's columns, source
    # and destination aligned to its bytes), or each (row, step)'s words
    # from the one holding its first value, covering its bt values
    k16 = -(-2 * hdim // 16) * 16
    xs, b0 = cols + 8, (bsz // bt // 2) * bt
    seen = np.zeros((k16, cols), np.int32)
    for t in range(min(t_len, 3)):
        first = (t * hdim + np.arange(k16) % hdim) * bsz + b0
        if vec > 1:
            for e in range(0, k16 * cols, vec):
                r, col = divmod(e, cols)
                c = col % bt
                assert c + vec <= bt and (r * xs + col) % vec == 0
                assert (first[r] + c) % vec == 0
                if t == 0:
                    seen[r, col:col + vec] += 1
        else:
            seg = bt // 2 + 1
            assert (2 * (first >> 1) + 2 * seg >= first + bt).all()
            assert (first - 2 * (first >> 1) <= 1).all()
            seen += 1 if t == 0 else 0
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


def _ldsm(addr, trans):
    """ldmatrix .x4 on an emulated tile: ``addr(lane)`` the element index
    lane gives (matrix lane // 8's row lane % 8); returns, for lane 4 g +
    q, its 4 registers as pairs of element indices (the lower first)."""
    out = {}
    for g in range(8):
        for q in range(4):
            regs = []
            for j in range(4):
                if trans:
                    regs.append((addr(8 * j + 2 * q) + g,
                                 addr(8 * j + 2 * q + 1) + g))
                else:
                    a = addr(8 * j + g) + 2 * q
                    regs.append((a, a + 1))
            out[(g, q)] = regs
    return out


def _ldsm_banks_free(addr):
    """Each of the four matrices' eight 16-byte rows on distinct banks."""
    for j in range(4):
        banks = {(2 * addr(8 * j + r) // 4 + w) % 32 for r in range(8)
                 for w in range(4)}
        if len(banks) != 32 or any(2 * addr(8 * j + r) % 16
                                   for r in range(8)):
            return False
    return True


def test_k2_bf16_fragments_and_banks():
    """The kernel's ldmatrix rows give m16n8k16's fragments: A from W_d's
    [o][k] rows of K + 8 bf16, B (.trans) from X's [k][column] rows of N +
    8, each matrix's 8 rows on distinct banks; the scan warps' reads of U
    (rows of N + max(bt, 2) floats: bt columns of 32 / bt units a warp)
    on distinct banks but at bt 1 (two lanes a bank), and of the highway
    row of X (2-byte reads, rows of N + 8) at most 4 lanes' words a
    bank."""
    for cols, hdim in ((64, 32), (32, 48), (16, 8), (64, 80)):
        k16 = -(-2 * hdim // 16) * 16
        ws, xs = k16 + 8, cols + 8
        o0, k0, n0 = 16, 16 if k16 > 16 else 0, cols - 16
        # the lane's rows: lo = lr + 8 (lm & 1), hi = 8 (lm >> 1)
        lo = lambda l: l % 8 + 8 * ((l // 8) & 1)  # noqa: E731
        hi = lambda l: 8 * (l // 16)  # noqa: E731
        a_at = lambda l: (o0 + lo(l)) * ws + k0 + hi(l)  # noqa: E731
        b_at = lambda l: (k0 + lo(l)) * xs + n0 + hi(l)  # noqa: E731
        a, b = _ldsm(a_at, False), _ldsm(b_at, True)
        for (g, q), regs in a.items():
            for r in range(4):
                for h in range(2):
                    row, kk = _mma_a(g, q, r, h)
                    assert regs[r][h] == (o0 + row) * ws + k0 + kk
        for (g, q), regs in b.items():
            for nt in range(2):
                for r in range(2):
                    for h in range(2):
                        kk, n = _mma_b(g, q, r, h)
                        assert regs[2 * nt + r][h] == \
                            (k0 + kk) * xs + n0 + 8 * nt + n
        assert _ldsm_banks_free(a_at) and _ldsm_banks_free(b_at)
        for bt in (8, 4, 2, 1):
            us = cols + max(bt, 2)
            lanes = [(l // bt, l % bt) for l in range(32)]
            u_banks = [(jl * us + 3 * bt + c) % 32 for jl, c in lanes]
            worst = max(u_banks.count(x) for x in set(u_banks))
            assert worst == (2 if bt == 1 else 1), (cols, bt)
            hw_words = {}
            for jl, c in lanes:
                w = ((7 + jl) * xs + 3 * bt + c) // 2
                hw_words.setdefault(w % 32, set()).add(w)
            assert max(len(v) for v in hw_words.values()) <= 4


@pytest.mark.parametrize("bsz", [1, 8, 33, 125])
def test_k2_bf16_limit(bsz):
    """The held bf16 kernel takes every H up to where not even a slice of
    one unit with chunks of 16 columns fits a block at its bt (its X ring
    grows with H: H 504 where B is a multiple of 4, 272 else); above, the kernel streams its reduction (the float32 kernel's
    streamed blocks, one float32 U slot and a ring of FWD_STAGES bf16
    stages, ``hid_fwd_bf16_stream_smem_bytes``, which does not grow with
    H): every H up to 1024 gets a geometry that fits, the streamed stages
    whole k16 steps, the scan threads inside the block."""
    limit = kernel_lib.SMEM_PER_BLOCK

    def held(h):
        return any(sru_fused.k2_fwd_bf16_smem(
            h, 16, 1, b, sru_fused.k2_bf16_vec(b, bsz)) <= limit
            for b in ((8, 1) if bsz % 4 == 0 and bsz >= 8 else (1,)))

    top = max(h for h in range(8, 1025, 8) if held(h))
    assert all(held(h) for h in range(8, top + 1, 8))
    assert top == (504 if bsz % 4 == 0 and bsz >= 8 else 272)
    assert not sru_fused.k2_fwd_bf16_geometry(3, top, bsz)["stream"]
    assert sru_fused.FWD_K % 16 == 0 and sru_fused.FWD_K // 2 <= 32
    for h in (top + 8, 600, 777, 1024):
        geo = sru_fused.k2_fwd_bf16_geometry(3, h, bsz)
        units, cols = geo["units"], geo["cols"]
        assert geo["stream"] and geo["kslices"] == -(-2 * h // sru_fused.FWD_K)
        assert geo["smem"] == sru_fused.k2_fwd_stream_smem(cols, units, 2)
        assert geo["smem"] <= limit and geo["threads"] == sru_fused.FWD_THREADS
        assert units * geo["bt"] <= sru_fused.FWD_THREADS
        assert geo["slices"] * units >= h > (geo["slices"] - 1) * units
        rows = -(-3 * units // (8 * sru_fused.FWD_NB)) * 8 * sru_fused.FWD_NB
        assert geo["smem"] == (4 * rows * (cols + 4) + 2 * sru_fused.FWD_STAGES
                               * (sru_fused.FWD_K * (cols + 8)
                                  + rows * (sru_fused.FWD_K + 8)))


# ----------------------------------------------------------------- K3


@settings(max_examples=60, deadline=None)
@given(c_in=st.integers(1, 20).map(lambda n: 8 * n),
       c_out=st.sampled_from([16, 20, 48, 64, 130]),
       k=st.sampled_from([3, 5, 8, 16]),
       bsz=st.sampled_from([1, 6, 33, 64, 125, 1000]))
def test_k3_bf16_split_and_partials(c_in, c_out, k, bsz):
    """Input channels in the fewest equal slices of 16 whose bf16 W_flat
    and ring fit a block at the picked tile (all of C_in where they do),
    output channels in blocks of mb; the tile is the first of
    FWD16_TILES whose items over the grid rows fill the card; each (t, o,
    b) gets one float32 partial a slice, summed in slice order and
    rounded to bf16 once."""
    length = 9
    geo = convt_tm.fwd_bf16_geometry(length, c_in, c_out, k, bsz)
    limit = kernel_lib.SMEM_PER_BLOCK
    ci, nc, mb = geo["ci_slice"], geo["nc"], geo["mb"]
    assert (nc, mb) in convt_tm.FWD16_TILES
    assert ci == c_in or ci % 16 == 0
    assert geo["smem"] == convt_tm.fwd_bf16_smem(k, ci, mb, nc) <= limit
    if geo["in_slices"] > 1:
        fewer = -(-(-(-c_in // (geo["in_slices"] - 1))) // 16) * 16
        assert convt_tm.fwd_bf16_smem(k, fewer, mb, nc) > limit
    assert geo["in_slices"] == -(-c_in // ci)
    assert geo["out_slices"] == -(-c_out // mb)
    assert geo["grid"] == (geo["blocks"], 1,
                           geo["in_slices"] * geo["out_slices"])
    assert geo["items"] == -(-bsz // nc) * -(-(length + k - 1) // 8)
    assert 1 <= geo["blocks"] <= geo["items"]
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
    """The x ring's rows ([i][column], nc + 8 bf16) and W_flat's (k C_in' +
    8) give m16n8k16's fragments through ldmatrix (B .trans), every
    matrix's 8 rows on distinct banks; a warp's staging tile (16 rows of
    FWD16_STAGE bf16) takes its 4-byte writes on 32 distinct banks and
    gives each lane an aligned 16-byte chunk; an output chunk starts on a
    16-byte boundary where B is a multiple of 8."""
    lo = lambda l: l % 8 + 8 * ((l // 8) & 1)  # noqa: E731
    hi = lambda l: 8 * (l // 16)  # noqa: E731
    for nc in (16, 32):
        xs = nc + 8
        for i0, n0 in ((0, 0), (16, nc - 16)):
            b_at = lambda l: (i0 + lo(l)) * xs + n0 + hi(l)  # noqa: E731
            regs = _ldsm(b_at, True)
            for (g, q), rr in regs.items():
                for nt in range(2):
                    for r in range(2):
                        for h in range(2):
                            kk, n = _mma_b(g, q, r, h)
                            assert rr[2 * nt + r][h] == \
                                (i0 + kk) * xs + n0 + 8 * nt + n
            assert _ldsm_banks_free(b_at)
    for k, cp in ((8, 64), (5, 32), (3, 16), (16, 80)):
        ws = k * cp + 8
        a_at = lambda l: (16 + lo(l)) * ws + 3 * cp + 16 + hi(l)  # noqa
        if cp < 32:
            a_at = lambda l: (16 + lo(l)) * ws + 2 * cp + hi(l)  # noqa
        regs = _ldsm(a_at, False)
        base = a_at(0) - 16 * ws
        for (g, q), rr in regs.items():
            for r in range(4):
                for h in range(2):
                    row, kk = _mma_a(g, q, r, h)
                    assert rr[r][h] == base + (16 + row) * ws + kk
        assert _ldsm_banks_free(a_at)
    st_ = convt_tm.FWD16_STAGE
    banks = {((g + 8 * h) * st_ + 8 * nt + 2 * q) // 2 % 32
             for g in range(8) for q in range(4) for h in (0,)
             for nt in (0,)}
    assert len(banks) == 32
    for lane in range(32):
        assert (2 * ((lane >> 1) * st_ + 8 * (lane & 1))) % 16 == 0
    for bsz in (64, 512, 1000):
        for t, o, b0 in ((0, 0, 0), (7, 63, 32), (3, 5, 16 + 8)):
            assert 2 * ((t * 64 + o) * bsz + b0) % 16 == 0


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
    """The bf16 word reads of csrc/sru_scan.cuh (``copy_value``,
    ``upper_half``, ``slot_value``), which K4's backward scan
    (``sru_scan_bwd_kernel<14>``) takes, read each bf16 value as the
    4-byte word that holds it (cp.async has no 2-byte copy), at a fixed
    offset (step 0) and moved by the scan's steps: at every (step, unit,
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
    """The bf16 entries of K4 take the float32 entries' arguments, the
    forward launches its own kernel (``launch_rec_fwd16``), and the
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
    assert "launch_scan_bwd<14>" in src and "launch_rec_fwd16(" in src
    assert "launch_rec_fwd<__nv_bfloat16>" not in src
    spec = scan.split("struct ScanTypes<14> {")[1].split("};")[0]
    assert "__nv_bfloat16" in spec and "kRoundParts = true" in spec


# the new K4 bf16 forward (``sru_rec_fwd16_kernel``): a warp's copies a
# group of REC16_GROUP steps at a time over u's three gate rows and xhw's
# highway row, a (step, row) a lane


def _k4_16_warps(hdim, bsz):
    """The live warps of the bf16 K4 forward's grid: (unit j, first
    column b0) arrays, and the geometry."""
    geo = sru_pallas.k4_fwd_geometry(1, hdim, bsz, 2)
    cols, units = geo["cols"], geo["units"]
    assert cols % 32 == 0 and cols * units <= sru_pallas.FWD_THREADS
    js, b0s = [], []
    for x in range(geo["grid"][0]):
        for y in range(geo["grid"][1]):
            for wi in range(cols * units // 32):
                j = y * units + (wi * 32) // cols
                b0 = x * cols + (wi * 32) % cols
                if j < hdim and b0 < bsz:  # else the whole warp returns
                    js.append(j)
                    b0s.append(b0)
    return np.array(js, np.int64), np.array(b0s, np.int64), geo


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [1, 5, 118])
@pytest.mark.parametrize("bsz", [125, 131, 64, 1000])
@pytest.mark.parametrize("hdim", [3, 8, 32, 80])
def test_k4_bf16_group_copies_read_every_value_once(hdim, bsz, t_len,
                                                    reverse):
    """``sru_rec_fwd16_kernel`` walked as it runs, every warp: lane l
    copies row l % 4 (u's gate rows, then xhw's highway) of its group's
    step l // 4 as the REC16_SPAN values from the 16-byte boundary below
    the row's first, five 16-byte copies, or where that would pass the
    array's end its blocks that start inside it (the last cut there);
    each live lane then reads slot row 4 s + r at the offset it worked out
    once from group 0 (the row's first element mod 8 in 32 bits) plus its
    lane. Every (t, row, unit, column) of u and xhw is read exactly once,
    as the value the recurrence needs there, at rows starting at every
    offset mod 8 where B is odd; no copy reads past its array, and every
    copy is 16-byte aligned on both sides."""
    js, b0s, geo = _k4_16_warps(hdim, bsz)
    row = hdim * bsz
    group, span = sru_pallas.REC16_GROUP, sru_pallas.REC16_SPAN
    assert geo["smem"] == geo["cols"] * geo["units"] // 32 * (
        sru_pallas.REC16_AHEAD + 1) * group * 4 * span * 2
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    col = js * bsz + b0s                     # (W,) the warp's first element
    lanes = np.arange(32)
    s_own, r_own = lanes // 4, lanes % 4     # the lane's (step, row)
    stride = np.where(r_own == 3, row, 3 * row)
    size = t_len * stride                    # its array's values
    r_off = np.where(r_own == 3, 0, r_own * row)
    t0, dt = (t_len - 1, -1) if reverse else (0, 1)
    # the read offsets, once a lane: group 0's step s, in 32 bits
    m32 = 2 ** 32
    t_s = (t0 + dt * s_own) % m32
    e32 = (t_s * (stride % m32) + r_off + col[:, None]) % m32
    rd = (e32 & 7)                           # (W, 32) for (s, r) = lane
    seen = set()
    reads = {"u": np.zeros(t_len * 3 * row, np.int8),
             "xhw": np.zeros(t_len * row, np.int8)}
    live = (b0s[:, None] + lanes[None, :]) < bsz  # (W, lane)
    for n in range(-(-t_len // group)):
        i = n * group + s_own                # the copy's scan step
        valid = i < t_len
        t = t_len - 1 - i if reverse else i
        e = t * stride + r_off + col[:, None]    # (W, 32) row's first value
        src = e - e % 8                      # 16-byte aligned both sides
        assert ((4 * s_own + r_own) * span * 2 % 16 == 0).all()
        # copied: [src, min(src + span, size)), five 16-byte blocks
        # where that is all of it; the lane's read of (s, r) at slot place
        # rd + lane holds element src + rd + lane, the value e + lane
        assert (~valid[None, :] | (src + rd == e)).all()
        assert (rd + 31 < span).all()
        seen.update(np.unique(e[:, valid] % 8).tolist())
        for lc in np.flatnonzero(valid):  # each copy's reads, live lanes
            got = (e[:, lc][:, None] + lanes[None, :])[live]
            assert (got < size[lc]).all()
            reads["xhw" if r_own[lc] == 3 else "u"][got] += 1
    for arr, got in reads.items():
        assert (got == 1).all(), (arr, int((got != 1).sum()))
    if bsz % 2 and t_len > 1:
        assert seen == set(range(8))


@pytest.mark.parametrize("t_len", [1, 5, 8, 9, 118])
@pytest.mark.parametrize("land", ["issue", "wait"])
def test_k4_bf16_ring_reads_each_group_once_landed(t_len, land):
    """One lane's ring of REC16_AHEAD + 1 group slots: group n's copies go
    to slot n % (AHEAD + 1) as one commit group (empty past T); at group n
    the lane waits until at most AHEAD - 1 groups are pending (n's
    landed), meets its warp, issues group n + AHEAD into the slot of group
    n - 1 (read before the meeting), then reads group n. Copies landing
    at issue or only at the wait, every read finds its own group, and no
    slot is refilled before its group is read."""
    ahead, group = sru_pallas.REC16_AHEAD, sru_pallas.REC16_GROUP
    n_slots, n_groups = ahead + 1, -(-t_len // group)
    slots, pending, read = [None] * n_slots, [], []

    def issue(n):
        if n * group >= t_len:  # an empty commit group
            pending.append(None)
        elif land == "issue":
            assert slots[n % n_slots] in (None, *read)
            slots[n % n_slots] = n
            pending.append(None)
        else:
            pending.append(n)

    for n in range(ahead):
        issue(n)
    for n in range(n_groups):
        while len(pending) > ahead - 1:  # wait_group<AHEAD - 1>
            m = pending.pop(0)
            if m is not None:
                assert slots[m % n_slots] in (None, *read)
                slots[m % n_slots] = m
        assert (n + ahead) % n_slots == (n - 1) % n_slots
        issue(n + ahead)
        assert slots[n % n_slots] == n
        read.append(n)
    assert read == list(range(n_groups))


def test_k4_bf16_forward_constants_match_the_source():
    """The Python mirrors equal csrc/sru_pallas.cu's constants; a group of
    REC16_GROUP steps of 4 rows is one copy a lane; a slot row covers 32
    values at any offset mod 8 in whole 16-byte blocks."""
    with open(os.path.join(kernel_lib.CSRC_DIR, "sru_pallas.cu")) as f:
        src = f.read()
    for name, value in (("kRec16Group", sru_pallas.REC16_GROUP),
                        ("kRec16Ahead", sru_pallas.REC16_AHEAD),
                        ("kRec16Span", sru_pallas.REC16_SPAN),
                        ("kRecFwdThreads", sru_pallas.FWD_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert sru_pallas.REC16_GROUP * 4 == 32
    assert sru_pallas.REC16_SPAN == 5 * 8 and 7 + 31 < sru_pallas.REC16_SPAN
    # a block's rings fit the default 48 KB (the kernel asks for no more)
    warp = (sru_pallas.REC16_AHEAD + 1) * sru_pallas.REC16_GROUP * 4 * \
        sru_pallas.REC16_SPAN * 2
    assert sru_pallas.FWD_THREADS // 32 * warp <= 48 * 1024
    assert "rec16_warp_smem() <= 48 * 1024" in src
    body = src.split("sru_rec_fwd16_kernel(const __nv_bfloat16*")[1].split(
        "constexpr int rec16_warp_smem()")[0]
    assert "hk::cp_async16(dst + 8 * k, from + 8 * k, true)" in body
    assert "hk::cp_async_wait<kRec16Ahead - 1>()" in body
    assert "sigmoid_f" not in body and "hk::ex2_approx" in body


# ------------------------------------------------------- pw-wgrad bf16
# ``pw_wgrad16_kernel``: a block all PW16_ROWS x PW16_COLS of dW, planar
# rows staged from their 16-byte boundary grouped by class (the first
# position's offset mod 8), each class's window of positions shifted
# down by its class, the packed side's stage 8 positions longer


def _pw16_class(b, c, cp, m, xl):
    """The class of planar channel c of batch row b at chunk start xl: its
    element's offset in a 16-byte block (p aligned)."""
    return ((b * cp + c) * m + xl) % 8


# (B, M, Cp, Cq, chunk): the packed sites (the geometry's chunks at bs 1,
# 4, 8; one chunk a batch row, as the drift test launches it), and small
# ragged ones (M below a stage, M odd, two tiles a side, Cq not a
# multiple of 8)
PW16_SITES = [(1, 32379, 256, 64, None), (4, 32379, 256, 64, None),
              (8, 32379, 256, 64, None), (4, 32379, 256, 64, 32384),
              (2, 323, 48, 200, None), (2, 323, 200, 48, None),
              (1, 21, 256, 64, None), (3, 96, 256, 64, 64)]


@pytest.mark.parametrize("b,m,cp,cq,chunk", PW16_SITES)
def test_pw_wgrad_bf16_chunks_cover_each_position_once_a_class(b, m, cp, cq,
                                                               chunk):
    """Each class d of planar channel covers [x L - d, (x + 1) L - d) in
    chunk x (the last chunk to m, one stage more where d needs it; none
    past it): over a batch row's chunks and stages every position of [0,
    m) once, each stage's window inside the packed stage (8 positions
    before its first on), which holds zeros outside [0, m); the grid
    rounds the chunks up to whole clusters, one partial a cluster."""
    geo = packed_tf.pw_wgrad16_geometry(b, m, cp, cq)
    k, cl = packed_tf.PW16_K, packed_tf.PW16_CLUSTER
    if chunk is None:
        chunk, chunks, gx = geo["chunk"], geo["chunks"], geo["gx"]
        assert geo["grid"][0] * geo["tiles"] * b <= kernel_lib.SMS
        assert geo["parts"] == b * gx // cl
    else:
        chunks = -(-m // chunk)
        gx = -(-chunks // cl) * cl
    assert chunk % k == 0 and gx % cl == 0 and (chunks - 1) * chunk < m
    for d in range(8):
        hits = np.zeros(m + 2 * k + 16, np.int64)  # positions -8 ..
        for x in range(gx):
            ns = packed_tf.pw16_stages(m, chunk, chunks, x)
            assert ns == (0 if x >= chunks else chunk // k if x < chunks - 1
                          else -(-(m - x * chunk + 7) // k))
            for s in range(ns):
                p0 = x * chunk + s * k
                lo = p0 - d   # the class's window, in the packed stage
                assert p0 - 8 <= lo and lo + k <= p0 + k
                hits[lo + 8:lo + k + 8] += 1
        assert (hits[8:m + 8] == 1).all(), d  # [0, m) once
        # past m and before 0 the packed side is zero: anything may be hit


def _pw16_emulate(p, q, b_len, m, cp, cq, chunk, transposed):
    """dW as pw_wgrad16_kernel forms it, in float64: every block (chunk,
    tile, batch row) stages its planar rows from the flat p (16-byte
    blocks from the class's boundary, zeros past p's end) and its packed
    positions p0 - 8 .. p0 + K - 1 (zeros outside [0, m) and past cq),
    warp w multiplies the channels of class w by the packed rows 8 - d_w
    on; the cluster's blocks and the partials are added."""
    k, rows_t, cols_t = packed_tf.PW16_K, packed_tf.PW16_ROWS, \
        packed_tf.PW16_COLS
    flat = p.reshape(-1)
    n_p = flat.size
    chunks = -(-m // chunk)
    gx = -(-chunks // packed_tf.PW16_CLUSTER) * packed_tf.PW16_CLUSTER
    dw = np.zeros((cp, cq))
    for b in range(b_len):
        for cp0 in range(0, cp, rows_t):
            for cq0 in range(0, cq, cols_t):
                rows = min(rows_t, cp - cp0)
                for x in range(gx):
                    xl = x * chunk
                    d = np.array([_pw16_class(b, cp0 + c, cp, m, xl)
                                  for c in range(rows)])
                    # channels 8 apart share a class: a warp's one shift
                    assert all(d[c] == d[c % 8] for c in range(rows))
                    for s in range(packed_tf.pw16_stages(m, chunk, chunks,
                                                         x)):
                        p0 = xl + s * k
                        e = ((b * cp + cp0 + np.arange(rows))[:, None] * m
                             + p0 - d[:, None] + np.arange(k)[None, :])
                        assert ((e - np.arange(k)) % 8 == 0).all()
                        a = np.where(e < n_p, flat[np.minimum(e, n_p - 1)],
                                     0.0)
                        pos = p0 - 8 + np.arange(k + 8)
                        inside = (pos >= 0) & (pos < m)
                        qs = np.zeros((k + 8, cols_t))
                        ncol = min(cols_t, cq - cq0)
                        qs[inside, :ncol] = q[b, pos[inside],
                                              cq0:cq0 + ncol]
                        for w in range(min(8, rows)):
                            ch = np.arange(w, rows, 8)
                            bq = qs[8 - d[w]:8 - d[w] + k]
                            dw[cp0 + ch, cq0:cq0 + ncol] += (
                                a[ch] @ bq)[:, :ncol]
    return dw.T if transposed else dw


@pytest.mark.parametrize("b,m,cp,cq,chunk", [
    (2, 37, 20, 24, 64), (1, 300, 256, 64, 64), (3, 96, 40, 8, 64),
    (2, 200, 300, 70, 128), (2, 251, 16, 64, None), (1, 1000, 64, 64, 192)])
@pytest.mark.parametrize("transposed", [False, True])
def test_pw_wgrad_bf16_emulated_sum_takes_each_product_once(b, m, cp, cq,
                                                           chunk, transposed):
    """The kernel's staging and windows emulated in float64 on random
    data give sum_p a^T g: each (position, planar, packed) product once,
    the values the planar copies read outside a row's chunk (its
    neighbours, zeros past p's end) meeting packed zeros; ragged tiles,
    many chunks and a last chunk that needs one stage more."""
    rng = np.random.default_rng(23)
    if chunk is None:
        chunk = packed_tf.pw_wgrad16_geometry(b, m, cp, cq)["chunk"]
    p = rng.standard_normal((b, cp, m))
    q = rng.standard_normal((b, m, cq))
    want = np.einsum("bcm,bmn->cn", p, q)
    got = _pw16_emulate(p, q, b, m, cp, cq, chunk, transposed)
    np.testing.assert_allclose(got, want.T if transposed else want,
                               rtol=0, atol=1e-9)


def test_pw_wgrad_bf16_ldmatrix_fragments_and_banks():
    """Warp w's ldmatrix reads: A (x4) from staged rows 32 w + 16 mi + the
    lane's row at column kk + 8 (l / 16) give m16n8k16's A fragment of
    the tile's channels w + 8 (16 mi + row) at positions kk + k; B (x4
    .trans) from packed row 8 - d_w + kk + the lane's row, channels 16 np
    + 8 (l / 16), give the B fragments of n8 tiles 2 np and 2 np + 1 at
    the same positions; each matrix's 8 rows on distinct banks, 16-byte
    aligned, for every class d; the planar and packed copies of a
    quarter warp conflict-free."""
    ps, qs = packed_tf.PW16_PS, packed_tf.PW16_QS
    lr = lambda l: (l & 7) + 8 * ((l >> 3) & 1)  # noqa: E731
    lc = lambda l: 8 * (l >> 4)  # noqa: E731
    for w in range(8):
        for mi in range(2):
            for kk in range(0, packed_tf.PW16_K, 16):
                at = lambda l: (32 * w + 16 * mi + lr(l)) * ps + kk + lc(l)  # noqa
                regs = _ldsm(at, False)
                for (g, q), rr in regs.items():
                    for r in range(4):
                        for h in range(2):
                            row, kq = _mma_a(g, q, r, h)
                            assert rr[r][h] == (32 * w + 16 * mi + row) * ps \
                                + kk + kq
                assert _ldsm_banks_free(at)
        for d in range(8):
            for np_ in range(4):
                kk = 16 * (d % 4)
                at = lambda l: (8 - d + kk + lr(l)) * qs + 16 * np_ + lc(l)  # noqa
                regs = _ldsm(at, True)
                for (g, q), rr in regs.items():
                    for nt in range(2):
                        for r in range(2):
                            for h in range(2):
                                kq, n = _mma_b(g, q, r, h)
                                assert rr[2 * nt + r][h] == \
                                    (8 - d + kk + kq) * qs + 16 * np_ \
                                    + 8 * nt + n
                assert _ldsm_banks_free(at)
    # the planar copies: thread t's 16-byte block t % 8 of staged row 32 i
    # + t / 8; a quarter warp's 8 blocks one row, 32 banks
    for i in range(8):
        for quarter in range(32):
            words = {((32 * i + t // 8) * ps + 8 * (t % 8)) // 2 % 32 + v
                     for t in range(8 * quarter % 256, 8 * quarter % 256 + 8)
                     for v in range(4)}
            assert len({x % 32 for x in words}) == 32


@pytest.mark.parametrize("transposed", [False, True])
def test_pw_wgrad_bf16_tile_and_cluster_shares(transposed):
    """Every (planar, packed) channel pair of the tile is one lane's D
    value (warp w, m16 tile mi, n8 tile nj: channel w + 8 (16 mi + g) (+
    64), packed 8 nj + 2 q (+ 1)), written once to the output tile; the
    cluster's ranks each add one share of its rows, read a row at a
    time (a warp's 32 reads one row, 32 banks), together every entry
    once; for the transpose a rank turns its share round in a staging
    tile (a warp's writes down a column and its reads along a row each
    hit 32 banks) and writes rows of dW^T."""
    rows, cols, os_ = (packed_tf.PW16_ROWS, packed_tf.PW16_COLS,
                       packed_tf.PW16_OS)
    hits = np.zeros((rows, cols), np.int64)
    for w in range(8):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            for mi in range(2):
                for nj in range(8):
                    for v in range(4):
                        r = w + 128 * mi + 8 * g + 64 * (v >> 1)
                        c = 8 * nj + 2 * q + (v & 1)
                        hits[r, c] += 1
    assert (hits == 1).all()
    cl, threads = packed_tf.PW16_CLUSTER, packed_tf.PW16_THREADS
    qrows = rows // cl
    got = np.zeros((rows, cols), np.int64)
    for rank in range(cl):
        staged = np.zeros((cols, qrows), np.int64)
        for e0 in range(0, qrows * cols, threads):
            for e in range(e0, e0 + threads):
                r, c = e // cols, e % cols
                got[rank * qrows + r, c] += 1
                staged[c, r] += 1
            for e1 in range(e0, e0 + threads, 32):  # one warp
                reads = {((rank * qrows + e // cols) * os_ + e % cols) % 32
                         for e in range(e1, e1 + 32)}
                writes = {((e % cols) * (qrows + 1) + e // cols) % 32
                          for e in range(e1, e1 + 32)}
                assert len(reads) == 32 and (len(writes) == 32
                                             or not transposed)
        if transposed:
            assert (staged == 1).all()
            for e1 in range(0, qrows * cols, 32):  # the staged rows out
                banks = {((e // qrows) * (qrows + 1) + e % qrows) % 32
                         for e in range(e1, e1 + 32)}
                assert len(banks) == 32
    assert (got == 1).all()


def test_pw_wgrad_bf16_constants_match_the_source():
    """The Python mirrors equal csrc/packed_tf.cu's kPw16* constants and
    shared bytes; the entries keep their signatures; the kernel takes its
    fragments by ldmatrix, adds its stage sums to a float32 sum every
    stage, and uses no atomics."""
    src, consts = _packed_source()
    for name, value in (("kPw16Rows", packed_tf.PW16_ROWS),
                        ("kPw16Cols", packed_tf.PW16_COLS),
                        ("kPw16K", packed_tf.PW16_K),
                        ("kPw16Stages", packed_tf.PW16_STAGES),
                        ("kPw16Cluster", packed_tf.PW16_CLUSTER),
                        ("kPw16Threads", packed_tf.PW16_THREADS)):
        assert consts[name] == value, name
    assert "constexpr int kPw16PS = kPw16K + 8;" in src
    assert "constexpr int kPw16QS = kPw16Cols + 8;" in src
    assert "constexpr int kPw16OS = kPw16Cols + 1;" in src
    assert (packed_tf.PW16_PS, packed_tf.PW16_QS, packed_tf.PW16_OS) == (
        72, 72, 65)
    assert 2 * packed_tf.PW16_PS % 16 == 0 and packed_tf.PW16_OS % 2 == 1
    assert packed_tf.pw_wgrad16_smem() == 188928 <= kernel_lib.SMEM_PER_BLOCK
    assert 4 * (packed_tf.PW16_ROWS * packed_tf.PW16_OS + packed_tf.PW16_COLS
                * (packed_tf.PW16_ROWS // packed_tf.PW16_CLUSTER + 1)) < 188928
    assert packed_tf.PW16_K == packed_tf.PW_WGRAD_K  # the drift test's chunk
    sig = kernel_lib._SIGNATURES["packed_tf"]
    assert sig["pw_packed_wgrad_bf16"] == sig["pw_packed_wgrad"]
    assert sig["dw_conv_packed_wgrad_bf16"] == sig["dw_conv_packed_wgrad"]
    body = src.split("pw_wgrad16_kernel(const __nv_bfloat16*")[1].split(
        'extern "C"')[0]
    assert "atomic" not in body and "hk::ldsm_x4_trans_at" in body
    assert "hk::mma_bf16_zero(big[mi][nj], a[mi], bq[nj])" in body
    assert "acc[mi][nj][v] += big[mi][nj][v]" in body
    assert "pw_wgrad_bf16_kernel" not in src
