"""The launch plans of K5-wgrad, K4 forward and K6's slices of W, on the
CPU.

``ops/packed_tf.dw_wgrad_geometry`` gives ``csrc/packed_tf.cu``'s
``dw_wgrad_kernel`` its blocks (a run of output rows, an f tile, a block
of channels) and threads (a channel quad, a tap row, a group of taps, a
segment of positions); ``ops/sru_pallas.k4_fwd_geometry`` gives
``csrc/sru_pallas.cu``'s ``sru_rec_fwd_kernel`` its blocks of columns x
units; ``pw_proj_geometry`` gives ``pw_proj_kernel`` its launches, one a
slice of W. These
tests walk the blocks and threads as the kernels do, at the preset's sites
and at ragged shapes: every term of dW is summed by exactly one thread of
one block and every partial written once; the staged x value a window
reads is the input value of its tap; the ring of rows never hands a step
a slot that another row took, nor overwrites one a step still reads; K4
forward's threads cover every (unit, column) once; K6's launches
multiply every (tile, k stage) once, the first adding the bias and each
later one adding to the output. The constants and the C entries' signatures
are held to the sources. About 4 s alone.
"""

import functools
import os
import re

import numpy as np
import pytest

from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P
from rtfs_tpu_torch.ops import sru_pallas as S

TAPS = P.WGRAD_TAPS

# (B, T_in, F_in, C, kT, kF, pads_t, pads_f): the bs-4 training sites
# ("same" and pre-select), ragged shapes, C off the quads, C over one
# channel block, a tap count above the window's (three groups)
WGRAD = {"same-bs4": (4, 251, 129, 64, 4, 4, (1, 2), (1, 2)),
         "pre-select-bs4": (4, 251, 129, 64, 4, 4, (1, 1), (1, 1)),
         "ragged": (2, 7, 9, 8, 4, 4, (1, 2), (1, 2)),
         "odd-c": (2, 9, 11, 37, 4, 4, (1, 2), (1, 2)),
         "c-72": (1, 6, 7, 72, 4, 4, (1, 2), (1, 2)),
         "taps-3x5": (1, 5, 6, 6, 3, 5, (1, 1), (2, 2)),
         "taps-2x9": (2, 4, 5, 12, 2, 9, (0, 1), (4, 4))}
SMALL = [n for n in WGRAD if not n.endswith("bs4")]


def _wgrad(name):
    b, t_in, f_in, c, kt, kf, pt, pf = WGRAD[name]
    t_out, f_out = P.dw_geometry(t_in, f_in, kt, kf, pt, pf)
    return (b, t_in, f_in, c, kt, kf, pt, pf, t_out, f_out,
            P.dw_wgrad_geometry(b, c, t_out, f_out, kt, kf))


def _threads(geo, kt, kf):
    """(quad, group, dt, seg) of each thread, as the kernel decomposes its
    index: quad fastest."""
    groups = -(-kf // TAPS)
    tid = np.arange(geo["threads"])
    qb = geo["qb"]
    return (tid % qb, tid // qb % groups, tid // (qb * groups) % kt,
            tid // (qb * groups * kt))


@pytest.mark.parametrize("name", sorted(WGRAD))
def test_wgrad_threads_blocks_and_shared_memory(name):
    b, _, _, c, kt, kf, _, _, t_out, f_out, geo = _wgrad(name)
    quad, grp, dt, seg = _threads(geo, kt, kf)
    groups = -(-kf // TAPS)
    assert geo["threads"] == geo["units"] * geo["s"] <= P.WGRAD_MAX_THREADS
    assert len(set(zip(quad, grp, dt, seg))) == geo["threads"]
    assert seg.max() == geo["s"] - 1 and geo["units"] == geo["qb"] * kt * \
        groups
    assert geo["ft"] == geo["s"] * geo["p"]
    assert geo["tiles_f"] == -(-f_out // geo["ft"])
    assert (geo["tiles_f"] - 1) * geo["ft"] < f_out  # no empty tile
    assert geo["blocks_c"] == -(-(-(-c // 4)) // geo["qb"])
    assert geo["smem"] == P.dw_wgrad_smem(kt, kf, geo["qb"], geo["s"],
                                          geo["p"]) <= kernel_lib.SMEM_PER_BLOCK
    # the end's exchange of 16 sums a thread fits the same bytes
    assert 64 * geo["threads"] <= geo["smem"]
    # one wave: every block resident at once
    per_sm = geo["per_sm"]
    assert per_sm * (geo["smem"] + 1024) <= kernel_lib.SMEM_PER_SM
    assert per_sm * geo["threads"] <= 2048
    blocks = geo["runs"] * geo["tiles_f"] * geo["blocks_c"]
    assert blocks <= per_sm * kernel_lib.SMS
    assert geo["runs"] <= b * t_out and geo["parts"] == geo["runs"] * \
        geo["tiles_f"]


def test_wgrad_preset_geometry():
    """At the bs-4 sites: 16 quads x 4 tap rows x 4 segments of 11
    positions, 3 f tiles of 44, 88 runs of ~11.4 rows, two blocks an SM
    (264 blocks, one wave)."""
    for name in ("same-bs4", "pre-select-bs4"):
        geo = _wgrad(name)[-1]
        assert (geo["qb"], geo["s"], geo["p"], geo["tiles_f"], geo["runs"],
                geo["per_sm"], geo["threads"]) == (16, 4, 11, 3, 88, 2, 256)
        assert geo["smem"] == 4 * ((6 * 47 + 3 * 44) * 64) == 105_984


@pytest.mark.parametrize("name", SMALL)
def test_wgrad_sums_every_term_once(name):
    """Every (b, t, f, c, dt, df) product of dW is taken by exactly one
    (block, thread, step, position), and each partial element (row, dt,
    df, c) is written by exactly one thread of one block."""
    b, t_in, f_in, c, kt, kf, pt, pf, t_out, f_out, geo = _wgrad(name)
    quad, grp, dt, seg = _threads(geo, kt, kf)
    runs, ft, p, qb = geo["runs"], geo["ft"], geo["p"], geo["qb"]
    rows = b * t_out
    hits = np.zeros((b, t_out, f_out, c, kt, kf), np.int32)
    written = np.zeros((geo["parts"], kt, kf, c), np.int32)
    for x in range(runs):
        r0, r1 = rows * x // runs, rows * (x + 1) // runs
        for y in range(geo["tiles_f"]):
            for z in range(geo["blocks_c"]):
                for th in range(geo["threads"]):
                    ch = z * 4 * qb + 4 * quad[th] + np.arange(4)
                    ch = ch[ch < c]
                    taps = TAPS * grp[th] + np.arange(TAPS)
                    taps = taps[taps < kf]
                    pos = y * ft + seg[th] * p + np.arange(p)
                    pos = pos[pos < f_out]
                    for r in range(r0, r1):
                        bb, t = divmod(r, t_out)
                        for df in taps:
                            np.add.at(hits, (bb, t, pos[:, None], ch[None],
                                             dt[th], df), 1)
                    if seg[th] == 0:
                        for df in taps:
                            written[y * runs + x, dt[th], df, ch] += 1
    assert (hits == 1).all()
    assert (written == 1).all()


@pytest.mark.parametrize("name", sorted(WGRAD))
def test_wgrad_window_reads_the_tap_input(name):
    """A thread's window value j at its position pp sits at staged
    position seg p + pp + TAPS group + j of the tile's x row, whose input
    f is f0 - pf_lo + that: f + df - pf_lo, the tap's input; the staged
    row (ft + TAPS G - 1 positions) holds every such position."""
    _, _, _, _, kt, kf, _, pf, _, f_out, geo = _wgrad(name)
    quad, grp, dt, seg = _threads(geo, kt, kf)
    groups = -(-kf // TAPS)
    xw = geo["ft"] + TAPS * groups - 1
    for y in range(geo["tiles_f"]):
        f0 = y * geo["ft"]
        for pp in range(geo["p"]):
            for j in range(TAPS):
                staged = seg * geo["p"] + pp + TAPS * grp + j
                assert staged.max() < xw
                f = f0 + seg * geo["p"] + pp
                assert ((f0 - pf[0] + staged)
                        == f + TAPS * grp + j - pf[0]).all()


@pytest.mark.parametrize("kt", [1, 2, 4, 7])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 12])
def test_wgrad_ring_hands_each_step_its_rows(kt, n):
    """A run of n steps: group i brings x rows j (i = 0: 0 .. kt-1; else
    i + kt - 1) into slot j % (kt + 2) and g row i into slot i % 3; the
    prologue issues groups 0 and 1, step i waits until group i is in
    (``cp_async_wait<1>``), a barrier, issues group i + 2, then reads x
    rows i .. i + kt - 1 and g row i. No copy lands in a slot that a step
    not yet done reads."""
    nx = kt + 2
    x_slot, g_slot = {}, {}
    pending = []

    def issue(i):
        group = []
        if i < n:
            for j in (range(kt) if i == 0 else [i + kt - 1]):
                group.append(("x", j % nx, j))
            group.append(("g", i % 3, i))
        pending.append(group)

    def land(group):
        for kind, slot, row in group:
            (x_slot if kind == "x" else g_slot)[slot] = row

    issue(0)
    issue(1)
    for i in range(n):
        while len(pending) > 1:  # wait_group 1
            land(pending.pop(0))
        issue(i + 2)
        # the new copies may land at once: step i still reads its rows
        for kind, slot, _ in pending[-1]:
            reads = ({(i + d) % nx for d in range(kt)} if kind == "x"
                     else {i % 3})
            assert slot not in reads
        assert all(x_slot[(i + d) % nx] == i + d for d in range(kt))
        assert g_slot[i % 3] == i


@pytest.mark.parametrize("name", sorted(WGRAD))
def test_wgrad_launch_ints_match_the_c_entry(name):
    b, t_in, f_in, c, kt, kf, pt, pf, t_out, f_out, geo = _wgrad(name)
    ints = P.dw_wgrad_launch_ints(b, t_in, f_in, c, t_out, f_out, (kt, kf),
                                  pt, pf)
    assert (4, len(ints)) == kernel_lib._SIGNATURES["packed_tf"][
        "dw_conv_packed_wgrad"]
    assert ints == (b, t_in, f_in, c, t_out, f_out, kt, kf, pt[0], pf[0],
                    geo["qb"], geo["s"], geo["p"], geo["runs"],
                    geo["parts"])


def test_wgrad_refuses_only_taps_no_block_takes():
    with pytest.raises(ValueError):
        P.dw_wgrad_geometry(1, 8, 10, 10, 1100, 1)
    with pytest.raises(ValueError):
        P.dw_wgrad_geometry(1, 8, 0, 10, 4, 4)
    assert P.dw_wgrad_geometry(1, 4096, 10, 10, 9, 9)["blocks_c"] == 64


# ------------------------------------------------------------- K4 forward

# (T, H, B): the serving sites at bs 1 and 8, the bs-4 training sites, H
# 80 (the route wider than the fused stack), ragged, blocks of two units
K4 = [(57, 32, 125), (118, 32, 64), (57, 32, 1000), (118, 32, 512),
      (57, 32, 500), (118, 32, 256), (57, 80, 1000), (9, 8, 37),
      (5, 300, 33), (1, 1, 1)]


@pytest.mark.parametrize("t_len,h,bsz", K4)
def test_k4_forward_blocks_cover_every_unit_and_column_once(t_len, h, bsz):
    geo = S.k4_fwd_geometry(t_len, h, bsz)
    cols, units = geo["cols"], geo["units"]
    assert cols % 32 == 0 and cols * units <= S.FWD_THREADS
    assert geo["grid"] == (-(-bsz // cols), -(-h // units))
    assert geo["smem"] == 4 * S.FWD_AHEAD * 4 * cols * units <= 48 * 1024
    hits = np.zeros((h, bsz), np.int32)
    tid = np.arange(cols * units)
    for bx in range(geo["grid"][0]):
        for by in range(geo["grid"][1]):
            b = bx * cols + tid % cols
            j = by * units + tid // cols
            ok = (b < bsz) & (j < h)
            np.add.at(hits, (j[ok], b[ok]), 1)
    assert (hits == 1).all()
    blocks = geo["grid"][0] * geo["grid"][1]
    assert blocks >= kernel_lib.SMS or cols * units == 32


def test_k4_forward_preset_geometry():
    """The uni bs-8 sites: 128-column blocks at the freq site (B 1000, 256
    blocks), 64 at the time site (B 512, 256 blocks)."""
    assert S.k4_fwd_geometry(57, 32, 1000)["grid"] == (8, 32)
    assert S.k4_fwd_geometry(118, 32, 512)["cols"] == 64
    assert S.k4_fwd_geometry(57, 32, 125)["cols"] == 32


@pytest.mark.parametrize("t_len", [1, 3, 8, 9, 57])
def test_k4_forward_ring_hands_each_step_its_slot(t_len):
    """Steps 0 .. FWD_AHEAD-1 issued before the loop; step i waits until at
    most FWD_AHEAD - 1 groups are pending (its own is in), reads slot i %
    FWD_AHEAD, then issues step i + FWD_AHEAD into that slot."""
    ahead = S.FWD_AHEAD
    slot, pending = {}, []

    def issue(i):
        pending.append([(i % ahead, i)] if i < t_len else [])

    for i in range(ahead):
        issue(i)
    for i in range(t_len):
        while len(pending) > ahead - 1:
            for s, step in pending.pop(0):
                slot[s] = step
        assert slot[i % ahead] == i
        issue(i + ahead)
        for s, _ in pending[-1]:
            assert s == i % ahead  # the slot just read, nothing else


# ------------------------------------------------------------- K6 slices


def _proj_launches(k):
    """The K6 entry's launches, as ``pw_proj_packed_fwd`` loops: (first k
    row, depth, bias passed, accumulate) a slice of PROJ_SLICE k."""
    return [(k0, min(k - k0, P.PROJ_SLICE), k0 == 0, k0 > 0)
            for k0 in range(0, k, P.PROJ_SLICE)]


def _proj_walk(tiles, blocks, ks, x):
    """Block x's stage sequence in one launch, as ``ProjCursor.next``
    steps it: (tile, k stage)."""
    return [(t, kst) for t in range(x, tiles, blocks) for kst in range(ks)]


@pytest.mark.parametrize("b,m,k,n", [(1, 251 * 129, 512, 64),
                                     (1, 251 * 129, 256, 64),
                                     (2, 300, 300, 70), (3, 1000, 520, 8),
                                     (1, 128, 800, 64)])
def test_k6_blocks_walk_every_slice_of_every_tile_once(b, m, k, n):
    """One launch a slice of PROJ_SLICE k: each block of a launch
    multiplies every k stage of its slice for every tile it owns once, the
    first launch writing bias + sums and each later one adding its sums to
    them (no bias); x rows are read at the slice's offset with the whole
    tensor's K a batch row, so every (batch row, k row) of x is read by
    exactly one launch; every launch fits the first one's shared memory."""
    geo = P.pw_proj_geometry(b, m, k, n)
    tiles, blocks = geo["tiles"], geo["blocks"]
    launches = _proj_launches(k)
    assert len(launches) == geo["slices"] == -(-k // P.PROJ_SLICE)
    assert [(bias, acc) for _, _, bias, acc in launches] == [
        (True, False)] + [(False, True)] * (len(launches) - 1)
    seen = np.zeros((tiles, geo["stages"]), np.int32)
    rows = np.zeros((b, k), np.int32)
    for k0, depth, _, _ in launches:
        assert P.pw_proj_smem(depth) <= geo["smem"] <= \
            kernel_lib.SMEM_PER_BLOCK
        ks = -(-depth // P.PROJ_K)
        for x in range(blocks):
            for t, kst in _proj_walk(tiles, blocks, ks, x):
                seen[t, k0 // P.PROJ_K + kst] += 1
        for bb in range(b):
            # row r of the launch's batch row bb: (bb * k + k0 + r) * m
            starts = [(bb * k + k0 + r) for r in range(depth)]
            for s in starts:
                rows[s // k, s % k] += 1
    assert (seen == 1).all() and (rows == 1).all()


@functools.cache
def _constants(name):
    with open(os.path.join(kernel_lib.CSRC_DIR, name)) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_constants_and_entries_match_the_sources():
    src, consts = _constants("packed_tf.cu")
    assert (consts["kWgThreads"], consts["kWgMaxThreads"],
            consts["kWgTaps"], consts["kProjSlice"]) == (
        P.WGRAD_THREADS, P.WGRAD_MAX_THREADS, P.WGRAD_TAPS, P.PROJ_SLICE)
    assert "dw_wgrad_kernel<4, 4>" in src and "dw_wgrad_kernel<0, 0>" in src
    # K6: one kernel body, launched once a slice, accumulating after the
    # first
    assert "template <bool" not in src.split("pw_proj_kernel(")[0][-200:]
    assert re.search(r"for \(int k0 = 0; k0 < K; k0 \+= kProjSlice\)", src)
    assert "k0 == 0 ? (const float*)bias : nullptr" in src
    assert "K, k0 > 0);" in src
    entry = re.search(r'extern "C" int dw_conv_packed_wgrad\((.*?)\)', src,
                      re.S).group(1)
    args = [a.strip() for a in entry.split(",")]
    assert (sum(a.startswith(("const void*", "void*")) for a in args) - 1,
            sum(a.startswith("int ") for a in args)) == \
        kernel_lib._SIGNATURES["packed_tf"]["dw_conv_packed_wgrad"]
    src, consts = _constants("sru_pallas.cu")
    assert (consts["kRecFwdThreads"], consts["kRecFwdAhead"]) == (
        S.FWD_THREADS, S.FWD_AHEAD)
    entry = re.search(r'extern "C" int sru_recurrence_fwd\((.*?)\)', src,
                      re.S).group(1)
    args = [a.strip() for a in entry.split(",")]
    assert (sum(a.startswith(("const void*", "void*")) for a in args) - 1,
            sum(a.startswith("int ") for a in args)) == \
        kernel_lib._SIGNATURES["sru_pallas"]["sru_recurrence_fwd"]
