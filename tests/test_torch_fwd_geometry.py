"""The K1, K2 and K3 forward kernels' geometry and numerics, on the CPU.

``ops/sru_fused.k1_fwd_geometry``, ``k2_fwd_geometry`` and
``ops/convt_tm.fwd_geometry`` size the grids, blocks, chunks and shared
memory that ``csrc/sru_fused.cu`` and ``csrc/convt_tm.cu`` launch their
forwards with. These tests walk the blocks as the kernels do and check
that every output is written exactly once, in the scan order the
recurrence needs (K1: through its ring of loads ahead of the chain), and
that the shared memory fits one Hopper block. They also emulate the kernels' 3xTF32 products
(``csrc/tf32x3.cuh``) in plain torch and hold them to the gates the card
runs under, and check that a library is rebuilt when a header it
includes changes. About 12 s alone.
"""

import os

import numpy as np
import pytest
import torch

from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

# (T or L, B) of the two DualPathRNN sites at the preset's bs 4, ragged,
# single-step and single-column cases, and bs 1 and 8 of both serving
# sites
SITES = [(57, 500), (118, 256), (37, 131), (1, 77), (5, 1),
         (57, 125), (118, 64), (57, 1000), (118, 512)]


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("hdim", [32, 48, 64, 8, 80, 128])
def test_k2_forward_geometry(t_len, bsz, hdim):
    geo = sru_fused.k2_fwd_geometry(t_len, hdim, bsz)
    bt, steps, units = geo["bt"], geo["steps"], geo["units"]
    n_tiles, n_dirs, n_slices = geo["grid"]
    assert n_dirs == 2 and n_tiles == -(-bsz // bt)
    assert n_slices == geo["slices"] == -(-hdim // units)
    # the kernel's requirements (the C entry refuses anything else)
    assert steps * bt == geo["cols"]
    assert geo["cols"] % (16 * sru_fused.FWD_MT) == 0
    assert units * bt <= sru_fused.FWD_THREADS
    assert steps % min(steps, sru_fused.FWD_AHEAD) == 0
    assert geo["smem"] == sru_fused.k2_fwd_smem(hdim, geo["cols"], units)
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    # all of H in one block where it fits (every H up to 68), else the
    # fewest equal slices that do
    if hdim <= 68:
        assert units == hdim
    else:
        fewer = -(-hdim // (n_slices - 1))
        assert sru_fused.k2_fwd_smem(hdim, 32, fewer) > \
            kernel_lib.SMEM_PER_BLOCK
    # the grid fills the card where B allows, with the widest tile that
    # does; where none does, one column a block
    allowed = [w for w in (8, 4, 2, 1) if units * w <= sru_fused.FWD_THREADS]
    if 2 * n_slices * n_tiles < kernel_lib.SMS:
        assert bt == 1
    for wider in (w for w in allowed if w > bt):
        assert 2 * n_slices * -(-bsz // wider) < kernel_lib.SMS
    # walk every block's chunks and scan threads: each (step, unit,
    # column, direction) is written once, and each direction's steps come
    # in its scan order (t ascending forward, descending reverse); block
    # z's threads p < units * bt scan unit z units + p // bt of its slice
    written = np.zeros((t_len, hdim, bsz, 2), dtype=np.int64)
    for d in range(2):
        for tile in range(n_tiles):
            b0 = tile * bt
            order = []
            for n in range(geo["chunks"]):
                for s in range(steps):
                    i = n * steps + s
                    if i >= t_len:
                        break
                    order.append(i if d == 0 else t_len - 1 - i)
            want = list(range(t_len)) if d == 0 else list(
                range(t_len - 1, -1, -1))
            assert order == want
            cols = [b0 + c for c in range(bt) if b0 + c < bsz]
            assert cols  # no empty block
            for z in range(n_slices):
                j0 = z * units
                hs = min(units, hdim - j0)
                assert hs > 0  # no empty slice
                # W_d's rows the block keeps: gate g, unit jl at g units
                # + jl, each W_d row g H + j0 + jl once
                rows = [g * hdim + j0 + jl for g in range(3)
                        for jl in range(hs)]
                assert len(set(rows)) == 3 * hs
                assert 3 * units <= -(-3 * units // (
                    8 * sru_fused.FWD_NB)) * 8 * sru_fused.FWD_NB
                for p in range(hs * bt):
                    j, b = j0 + p // bt, b0 + p % bt
                    if b < bsz:
                        written[order, j, b, d] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("hdim", [8, 32, 48, 64])
def test_k1_forward_geometry(t_len, bsz, hdim):
    """K1 forward's blocks (``k1_fwd_geometry``): every (unit, column,
    direction) gets one thread; each thread's ring of LAY0_AHEAD slots in
    shared memory hands the chain every step in its scan order, copied
    before it is read and not overwritten until it is; the block is the
    largest that fills the card, and at the bs-1 sites no block is more
    than half idle."""
    geo = sru_fused.k1_fwd_geometry(t_len, hdim, bsz)
    cols, units, ahead = geo["cols"], geo["units"], geo["ahead"]
    threads = cols * units
    assert cols % 32 == 0 and threads in (32, 64, 128)
    assert threads <= sru_fused.LAY0_THREADS and ahead == sru_fused.LAY0_AHEAD
    assert cols == min(threads, -(-bsz // 32) * 32)
    gx, gy, gz = geo["grid"]
    assert (gx, gy, gz) == (-(-bsz // cols), -(-hdim // units), 2)
    n_blocks = gx * gy * gz
    assert n_blocks >= kernel_lib.SMS or threads == 32
    if threads < sru_fused.LAY0_THREADS:  # a larger block would not fill
        wider = 2 * threads
        wc = min(wider, -(-bsz // 32) * 32)
        assert -(-bsz // wc) * -(-hdim // (wider // wc)) * 2 < kernel_lib.SMS
    # thread tid of block (x, y, z): column x * cols + tid % cols, unit
    # y * units + tid / cols; live where both are in range
    tid = np.arange(threads)
    visited = np.zeros((hdim, bsz, 2), np.int64)
    for x in range(gx):
        for y in range(gy):
            b, j = x * cols + tid % cols, y * units + tid // cols
            live = (b < bsz) & (j < hdim)
            assert live.any()
            if (t_len, bsz) in ((57, 125), (118, 64)):  # bs-1 sites
                assert 2 * live.sum() >= threads
            for z in range(gz):
                np.add.at(visited, (j[live], b[live], z), 1)
    assert (visited == 1).all()
    assert geo["smem"] == 4 * ahead * 4 * threads <= 48 * 1024
    # one thread's ring: step i is copied into slot i % ahead as one commit
    # group (groups past T empty); at step i the thread waits until at most
    # ahead - 1 groups are pending (step i's is in), reads the slot, and
    # after the step has used the values copies step i + ahead into it
    for d in range(2):
        groups = list(range(ahead))  # the prologue's: steps 0 .. ahead-1
        slots = {i % ahead: i for i in range(min(ahead, t_len))}
        order = []
        for i in range(t_len):
            done = groups[:len(groups) - (ahead - 1)]
            assert i in done and slots.pop(i % ahead) == i
            if i + ahead < t_len:
                slots[i % ahead] = i + ahead
            groups.append(i + ahead)
            order.append(i if d == 0 else t_len - 1 - i)
        assert not slots
        assert order == (list(range(t_len)) if d == 0
                         else list(range(t_len - 1, -1, -1)))


def test_k1_forward_constants_and_entry():
    path = os.path.join(kernel_lib.CSRC_DIR, "sru_fused.cu")
    with open(path) as f:
        src = f.read()
    assert f"constexpr int kLay0Ahead = {sru_fused.LAY0_AHEAD};" in src
    # pointers u_f, u_r, vb, h_f, h_r, c_f, c_r; T, H, B, cols, units
    assert kernel_lib._SIGNATURES["sru_fused"]["sru_dual_recurrence_fwd"] \
        == (7, 5)
    # the serving sites at bs 1: 32-thread blocks over 128 and 256 SMs'
    # worth of blocks; at bs 8: 128 threads, whole column tiles
    assert sru_fused.k1_fwd_geometry(118, 32, 64)["grid"] == (2, 32, 2)
    assert sru_fused.k1_fwd_geometry(57, 32, 125)["cols"] == 32
    assert sru_fused.k1_fwd_geometry(118, 32, 512)["cols"] == 128
    assert sru_fused.k1_fwd_geometry(57, 32, 1000)["grid"] == (8, 32, 2)
    with pytest.raises(ValueError):
        sru_fused.k1_fwd_geometry(0, 32, 64)


@pytest.mark.parametrize("hdim", [4, 8, 20, 32, 48, 64])
def test_k2_forward_takes_every_h_up_to_64(hdim):
    geo = sru_fused.k2_fwd_geometry(118, hdim, 512)
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    # the product's jobs (16 FWD_MT columns x 8 FWD_NB rows of U) cover U
    rows = -(-3 * hdim // (8 * sru_fused.FWD_NB)) * 8 * sru_fused.FWD_NB
    assert rows >= 3 * hdim and geo["cols"] % (16 * sru_fused.FWD_MT) == 0


def test_k2_forward_preset_geometry():
    """H 32: two blocks an SM (W_d, two X and two U slots of 64 columns),
    bt 8 where B allows the card to fill, narrower at the time site."""
    geo = sru_fused.k2_fwd_geometry(57, 32, 1000)
    assert (geo["bt"], geo["steps"], geo["grid"]) == (8, 8, (125, 2, 1))
    assert geo["smem"] == 4 * (96 * 68 + 2 * 64 * 72 + 2 * 96 * 68)
    # an SM's 228 KB of shared memory holds two such blocks, 1 KB each
    # besides
    assert 2 * (geo["smem"] + 1024) <= 228 * 1024 < 3 * (geo["smem"] + 1024)
    assert sru_fused.k2_fwd_geometry(118, 32, 512)["bt"] == 4
    assert sru_fused.k2_fwd_geometry(118, 32, 64)["bt"] == 1


# K2 forward's held geometry (W_d's rows of a slice of units and X's two
# slots in one block) before the streamed path came: (T, H, B) -> (units,
# slices, bt, cols, shared bytes); the held path keeps every one
HELD_K2 = {(57, 32, 500): (32, 1, 4, 64, 115_200),
           (57, 48, 500): (48, 1, 4, 64, 191_232),
           (57, 64, 500): (64, 1, 4, 32, 197_632),
           (57, 80, 500): (40, 2, 4, 32, 164_480),
           (57, 128, 500): (32, 4, 8, 32, 209_408),
           (57, 268, 500): (8, 34, 8, 32, 230_272),
           (57, 32, 1000): (32, 1, 8, 64, 115_200),
           (118, 32, 64): (32, 1, 1, 64, 115_200)}


def test_k2_forward_refuses_h_above_the_limit():
    """H 268 is the held path's limit, where even a slice of 8 units (24
    rows of W_d) no longer fits beside X's two slots. Above it K2 forward
    is no longer refused: H 269, 300, 512 and 1024 stream the projection's
    reduction, within one block's shared memory; H up to 268 keeps the
    held geometry it had (H 80, once refused, two slices of 40)."""
    for (t_len, hdim, bsz), held in HELD_K2.items():
        geo = sru_fused.k2_fwd_geometry(t_len, hdim, bsz)
        assert not geo["stream"]
        assert (geo["units"], geo["slices"], geo["bt"], geo["cols"],
                geo["smem"]) == held
    assert sru_fused.k2_fwd_smem(268, 32, 8) <= kernel_lib.SMEM_PER_BLOCK
    for hdim in (269, 300, 512, 1024):
        assert sru_fused.k2_fwd_smem(hdim, 32, 8) > kernel_lib.SMEM_PER_BLOCK
        geo = sru_fused.k2_fwd_geometry(57, hdim, 500)
        assert geo["stream"] and geo["smem"] <= kernel_lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("hdim", [269, 300, 512, 1024])
def test_k2_forward_streamed_geometry(t_len, bsz, hdim):
    """Above H 268: the fewest equal slices of units whose U slot and ring
    (``k2_fwd_stream_smem``, independent of H) fit one block; the C entry
    streams exactly there (the held layout's bytes exceed a block's); the
    launch rules of the held path (bt, cols, S) otherwise; every (step,
    unit, column, direction) is scanned by one thread of one block."""
    geo = sru_fused.k2_fwd_geometry(t_len, hdim, bsz)
    bt, steps, units = geo["bt"], geo["steps"], geo["units"]
    limit = kernel_lib.SMEM_PER_BLOCK
    assert geo["stream"]
    assert sru_fused.k2_fwd_smem(hdim, geo["cols"], units) > limit
    assert geo["smem"] == sru_fused.k2_fwd_stream_smem(geo["cols"], units) \
        <= limit
    assert geo["kslices"] == -(-2 * hdim // sru_fused.FWD_K)
    slices = geo["slices"]
    assert slices == -(-hdim // units) and units <= sru_fused.FWD_THREADS
    if slices > 1:
        fewer = -(-hdim // (slices - 1))
        assert fewer > sru_fused.FWD_THREADS or \
            sru_fused.k2_fwd_stream_smem(32, fewer) > limit
    assert steps * bt == geo["cols"] and geo["cols"] % (
        16 * sru_fused.FWD_MT) == 0
    assert units * bt <= sru_fused.FWD_THREADS
    assert steps % min(steps, sru_fused.FWD_AHEAD) == 0
    n_tiles = geo["grid"][0]
    written = np.zeros((hdim, bsz), dtype=np.int64)
    for tile in range(n_tiles):
        for z in range(slices):
            j0 = z * units
            hs = min(units, hdim - j0)
            assert hs > 0
            for p in range(hs * bt):
                j, b = j0 + p // bt, tile * bt + p % bt
                if b < bsz:
                    written[j, b] += 1
    assert (written == 1).all()  # each step of the chunks, both directions


@pytest.mark.parametrize("hdim,units", [(300, 100), (12, 12), (512, 103),
                                        (1024, 114), (20, 8)])
def test_k2_streamed_stages_and_w_rows(hdim, units):
    """A chunk's reduction in stages of FWD_K rows: every row of X (2H)
    once a chunk, rows past 2H zero; the warp-row walk of W_d's slice, (gate,
    jl) stepped without division, is divmod(o, units) and reads each W_d
    row gate H + j0 + jl of the block's units once; W_d's slice rows of 36
    floats and X's rows put a fragment's lanes on 32 banks."""
    ksl = -(-2 * hdim // sru_fused.FWD_K)
    rows_seen = np.zeros(ksl * sru_fused.FWD_K, np.int32)
    for kk in range(ksl):
        rows_seen[kk * sru_fused.FWD_K:(kk + 1) * sru_fused.FWD_K] += 1
    assert (rows_seen == 1).all() and ksl * sru_fused.FWD_K >= 2 * hdim
    rows = -(-3 * units // (8 * sru_fused.FWD_NB)) * 8 * sru_fused.FWD_NB
    warps = sru_fused.FWD_THREADS // 32
    for j0 in range(0, hdim, units):
        hs = min(units, hdim - j0)
        got = []
        for warp in range(warps):
            gate, jl = warp // units, warp % units
            for o in range(warp, rows, warps):
                assert (gate, jl) == divmod(o, units)
                if gate < 3 and jl < hs:
                    got.append(gate * hdim + j0 + jl)
                jl += warps
                while jl >= units:
                    jl -= units
                    gate += 1
        assert sorted(got) == sorted(g * hdim + j0 + jl for g in range(3)
                                     for jl in range(hs))
    kws = sru_fused.FWD_K + 4
    assert len({(g * kws + q) % 32 for g in range(8) for q in range(4)}) == 32


@pytest.mark.parametrize("n_chunks,ksl", [(1, 1), (1, 19), (2, 17), (3, 2),
                                          (4, 64), (5, 1)])
def test_k2_streamed_ring_and_u_slot(n_chunks, ksl):
    """The streamed stage sequence: stage st = (chunk st // ksl, slice st %
    ksl) into ring slot st % FWD_STAGES; stages 0 .. FWD_STAGES - 2 issued
    before the loop; iteration st waits until FWD_STAGES - 2 groups are
    pending, a barrier, issues stage st + FWD_STAGES - 1, projects stage st
    into the U slot (from 0 at a chunk's first slice), and after a chunk's
    last slice a barrier, then the scan of the chunk. No copy lands in a
    slot a stage not yet done reads; every chunk's U is whole, from its own
    slices in order, when scanned; the next write of U comes after the
    barrier that follows the scan."""
    stages = sru_fused.FWD_STAGES
    total = n_chunks * ksl
    slot_of, pending = {}, []
    u = []  # the slices summed into the U slot since it was last reset
    events = []  # ("barrier" | "scan n" | "write")

    def issue(st):
        pending.append([(st % stages, st)] if st < total else [])

    for st in range(stages - 1):
        issue(st)
    for st in range(total):
        while len(pending) > stages - 2:
            for s, stage in pending.pop(0):
                slot_of[s] = stage
        events.append("barrier")
        issue(st + stages - 1)
        for s, _ in pending[-1]:
            assert s != st % stages
        assert slot_of[st % stages] == st
        n, kk = divmod(st, ksl)
        if kk == 0:
            u = []
        events.append("write")
        u.append(st)
        if kk == ksl - 1:
            events.append("barrier")
            assert u == list(range(n * ksl, (n + 1) * ksl))
            events.append(f"scan {n}")
    # each scan is followed by a barrier before the next write of U
    for i, e in enumerate(events):
        if e.startswith("scan"):
            nxt = events[i + 1:]
            if "write" in nxt:
                assert "barrier" in nxt[:nxt.index("write")]


def test_k2_streamed_constants_match_the_source():
    path = os.path.join(kernel_lib.CSRC_DIR, "sru_fused.cu")
    with open(path) as f:
        src = f.read()
    assert f"constexpr int kFwdK = {sru_fused.FWD_K};" in src
    assert f"constexpr int kFwdStages = {sru_fused.FWD_STAGES};" in src
    assert "constexpr long long kMaxSmem = 227 * 1024;" in src
    assert 227 * 1024 == kernel_lib.SMEM_PER_BLOCK
    assert "sru_hid_fwd_kernel<true>" in src and \
        "sru_hid_fwd_kernel<false>" in src
    # pointers x_f, x_r, wt, vb, h_f, h_r, c_f, c_r; T, H, B, bt, S, units
    assert kernel_lib._SIGNATURES["sru_fused"]["sru_hidden_layer_fwd"] == \
        (8, 6)


@pytest.mark.parametrize("length,bsz", SITES)
@pytest.mark.parametrize("c_in,c_out,k", [(64, 64, 8), (32, 48, 5),
                                          (12, 20, 3), (96, 64, 8),
                                          (160, 64, 8), (72, 130, 8)])
def test_k3_forward_geometry(length, bsz, c_in, c_out, k):
    geo = convt_tm.fwd_geometry(length, c_in, c_out, k, bsz)
    steps, (tiles, runs, nz) = geo["steps"], geo["grid"]
    ci_slice, n_in = geo["ci_slice"], geo["in_slices"]
    assert nz == n_in * geo["out_slices"]
    assert geo["out_slices"] == -(-c_out // convt_tm.MAX_OUT)
    assert n_in == -(-c_in // ci_slice)
    if n_in > 1:  # a multiple of 8 (W's 16-byte copies stay aligned)
        assert ci_slice % 8 == 0
    # block z: input channels (z % n_in) ci_slice .., output channels
    # (z // n_in) MAX_OUT ..; each (input, output) channel pair once
    pairs = np.zeros((c_in, c_out), dtype=np.int64)
    for z in range(nz):
        i0, o0 = z % n_in * ci_slice, z // n_in * convt_tm.MAX_OUT
        assert i0 < c_in and o0 < c_out
        pairs[i0:i0 + ci_slice, o0:o0 + convt_tm.MAX_OUT] += 1
    assert (pairs == 1).all()
    t_out = length + k - 1
    written = np.zeros((t_out, bsz), dtype=np.int64)
    for tile in range(tiles):
        for run in range(runs):
            t0, t1 = run * steps, min(t_out, (run + 1) * steps)
            b0, b1 = tile * convt_tm.FWD_COLS, min(
                bsz, (tile + 1) * convt_tm.FWD_COLS)
            assert t0 < t1 and b0 < b1  # no empty block
            written[t0:t1, b0:b1] += 1
            # the ring of k + 2P - 1 slots: rows t0-k+1 .. t0+P-1 first,
            # then P rows a pass, each once; pass t's window t-k+1 ..
            # t+P-1 is in the ring while the next pass's rows load
            p_, n_slots = convt_tm.FWD_PASS, k + 2 * convt_tm.FWD_PASS - 1
            first = list(range(t0 - k + 1, t0 + p_))
            slots = {(r + n_slots) % n_slots: r for r in first}
            assert len(slots) == len(first)
            loaded = list(first)
            for t in range(t0, t1, p_):
                nxt = (list(range(t + p_, t + 2 * p_)) if t + p_ < t1
                       else [])
                loading = {(r + n_slots) % n_slots for r in nxt}
                for j in range(k):
                    for p in range(p_):
                        s = (t + p - j + n_slots) % n_slots
                        assert slots[s] == t + p - j and s not in loading
                for r in nxt:
                    slots[(r + n_slots) % n_slots] = r
                loaded += nxt
            assert len(set(loaded)) == len(loaded)  # each row read once
    assert (written == 1).all()
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK
    assert geo["part"] == t_out * c_out * bsz
    if tiles * nz <= kernel_lib.SMS:
        assert tiles * runs * nz <= kernel_lib.SMS  # one block an SM


def test_k3_forward_shared_memory_at_the_preset():
    """W_flat (64 rows of 8 * 64 + 4 floats) and the ring of 23 x rows of
    64 x 16: 226,304 of the 232,448 bytes a block may use, one slice; C_in
    72 at k 8 no longer fits one block and takes two slices of 40; C_in 32
    at k 16 fits one."""
    geo = convt_tm.fwd_geometry(57, 64, 64, 8, 1000)
    assert geo["smem"] == 4 * (64 * 516 + 23 * 64 * 16) == 226_304
    assert geo["grid"][2] == 1 and geo["ci_slice"] == 64
    assert geo["steps"] % convt_tm.FWD_PASS == 0
    assert convt_tm.fwd_smem(8, 72, 64) > kernel_lib.SMEM_PER_BLOCK
    wide = convt_tm.fwd_geometry(57, 72, 64, 8, 1000)
    assert (wide["ci_slice"], wide["in_slices"]) == (40, 2)
    assert wide["smem"] <= kernel_lib.SMEM_PER_BLOCK
    assert convt_tm.fwd_geometry(57, 32, 64, 16, 1000)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK


# ------------------------------------------------------------ numerics


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by round to nearest, ties away from zero (the
    rounding of ``cvt.rna.tf32.f32``, as ``tf32x3.cuh`` writes it): add
    half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by truncation, as the tensor core reads an operand
    whose low 13 bits are set."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: each operand split into big =
    tf32(x) and small = x - big (which the tensor core truncates), three
    products accumulated in float32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = trunc(a - a_big), trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in single-pass TF32."""
    return tf32(a) @ tf32(b)


def _k2(x_f, x_r, wt, vb, mm):
    h = x_f.shape[1]
    x = torch.cat([x_f, x_r], dim=1)  # (T, 2H, B)
    u = torch.stack([mm(wt, x[t]) for t in range(x.shape[0])])
    return torch.stack([
        sru_fused.scan_direction(u[:, :3 * h], x_f, vb[0:4], False),
        sru_fused.scan_direction(u[:, 3 * h:], x_r, vb[4:8], True)])


def _k3(x, w, mm):
    length, k = x.shape[0], w.shape[0]
    out = x.new_zeros(length + k - 1, w.shape[1], x.shape[2])
    for t in range(out.shape[0]):
        for j in range(k):
            if 0 <= t - j < length:
                out[t] += mm(w[j], x[t - j])
    return out


def _inputs(which):
    rng = np.random.default_rng(7)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    if which == "k2":  # T 118, B 64, H 32: chip_smoke's phase 3 scales
        h, t_len, bsz = 32, 118, 64
        vb = torch.cat([t((2, 2, h), h ** -0.5), t((2, 2, h), 0.1)],
                       dim=1).reshape(8, h)
        return (t((t_len, h, bsz), 0.5), t((t_len, h, bsz), 0.5),
                t((6 * h, 2 * h), (2 * h) ** -0.5), vb), _k2
    # L 118, C 64, k 8, B 64
    return (t((118, 64, 64)), t((8, 64, 64), (64 * 8) ** -0.5)), _k3


@pytest.fixture
def one_thread():
    """One torch thread for the test (the suite runs six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("which", ["k2", "k3"])
def test_3xtf32_holds_the_gates_and_single_pass_tf32_does_not(which,
                                                               one_thread):
    """Through the emulated split, K2's and K3's forwards stay within
    chip_smoke's TOL (1e-4) of the plain float32 versions and within 1e-5
    of their max of float64; single-pass TF32 breaks that bound."""
    args, fn = _inputs(which)
    exact = fn(*(a.double() for a in args), lambda a, b: a @ b)
    plain = (sru_fused.sru_hidden_layer_plain(*args) if which == "k2"
             else convt_tm.convt1d_ola_tm_plain(*args))
    plain = torch.stack(plain) if which == "k2" else plain
    scale = exact.abs().max().item()
    got = fn(*args, mm3)
    assert (got - plain).abs().max().item() <= 1e-4
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    one = fn(*args, mm1)
    assert (one.double() - exact).abs().max().item() > 1e-5 * scale


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's ulp at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 4, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert ((big.view(torch.int32) & 0x1fff) == 0).all()
    assert ((y - big).abs() <= big.abs() * 2.0 ** -11).all()
    rest = y - big - trunc(y - big)
    assert (rest.abs() <= y.abs() * 2.0 ** -21).all()


# ------------------------------------------------------------ kernel_lib


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and the csrc/ headers it
    includes: an edit to the header alone names a new library, so it is
    rebuilt; a header it does not include changes nothing."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n// one\n')
    (tmp_path / "g.cuh").write_text("// nested\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(kernel_lib, "CSRC_DIR", str(tmp_path))
    assert kernel_lib._sources("k") == ["k.cu", "h.cuh", "g.cuh"]
    first = kernel_lib._lib_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert kernel_lib._lib_path("k") == first
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n// two\n')
    second = kernel_lib._lib_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// nested, edited\n")
    assert kernel_lib._lib_path("k") not in (first, second)


def test_the_two_sources_include_the_shared_header():
    for name in ("sru_fused", "convt_tm"):
        assert "tf32x3.cuh" in kernel_lib._sources(name)
    assert os.path.exists(os.path.join(kernel_lib.CSRC_DIR, "tf32x3.cuh"))
