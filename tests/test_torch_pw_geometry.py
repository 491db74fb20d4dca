"""K6 ``pw_proj_packed``'s launch plan and numerics, on the CPU.

``ops/packed_tf.pw_proj_geometry`` gives ``csrc/packed_tf.cu``'s
``pw_proj_kernel`` its persistent blocks (one an SM, each walking the
(batch row, 128 positions) tiles ``blocks`` apart) and its shared memory
(W's (K, 64) slice split into B fragments, a ring of (32 k rows x 128
positions) stages of x, the (128, 64) output tile), and refuses a K whose
slice does not fit one Hopper block. These tests walk the blocks, the
stages' 16-byte copies, the fragments and the epilogue as the kernel does,
at the serving shapes (bs 1, 4 and 8) and at ragged ones, x aligned and
not: every output element is written exactly once, every value a fragment
reads from shared memory is the x or W value it multiplies (a row of x
lands shifted by its start's offset in a 16-byte block), a stage is in
before it is read and not overwritten while it is, the fragment reads hit
each bank at most twice, the layout fits 227 KB and the launch arguments
match the C entry. They emulate the kernel's 3xTF32 product
(``csrc/tf32x3.cuh``) in plain torch at K 256, N 64, for both stride
patterns of w, and hold it to chip_smoke's 1e-4 gate, and show why K6
sums its big products apart from the tensor core's accumulator (that
accumulator's rounding toward zero biases a long sum). About 11 s alone.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P
from test_torch_fwd_geometry import mm1, mm3
from test_torch_fwd_geometry import tf32 as _tf32
from test_torch_fwd_geometry import trunc as _trunc

THREADS, WARPS = P.PROJ_THREADS, P.PROJ_THREADS // 32
XS = P.PROJ_M + P.PROJ_PAD  # a staged x row
WS = P.PROJ_N + P.PROJ_PAD  # a row of the output tile
CHUNKS = P.PROJ_M // 4 + 1  # 16-byte blocks a staged row

# (B, M, K, N): the serving site (STFT 251 x 129, bottleneck 256 -> hid 64)
# at bs 1 and 8, the K7-dx site at bs 4, M / K / N off every tile, and M a
# multiple of 4 (the 16-byte path) with two N tiles
SHAPES = {"serving-bs1": (1, 251 * 129, 256, 64),
          "k7-dx-bs4": (4, 251 * 129, 256, 64),
          "serving-bs8": (8, 251 * 129, 256, 64),
          "ragged": (2, 13 * 7, 6, 4),
          "vec-two-n-tiles": (2, 144, 40, 70)}


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3  # g, q


def _warp_tile(warp):
    return (warp & 7) * 16, (warp >> 3) * 32  # positions, channels


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_blocks_write_every_output_once(shape):
    b, m, k, n = SHAPES[shape]
    geo = P.pw_proj_geometry(b, m, k, n)
    blocks, n_tiles = geo["grid"]
    m_tiles = -(-m // P.PROJ_M)
    assert geo["tiles"] == b * m_tiles
    assert blocks == min(geo["tiles"], kernel_lib.SMS)
    assert n_tiles == -(-n // P.PROJ_N)
    # the blocks' walks: tile x, x + blocks, ... of every N tile; their
    # counts differ by at most one
    written = np.zeros((b, m, n_tiles), np.int32)
    counts = []
    for x in range(blocks):
        mine = range(x, geo["tiles"], blocks)
        counts.append(len(mine))
        for tile in mine:
            bb, mt = divmod(tile, m_tiles)
            written[bb, mt * P.PROJ_M:(mt + 1) * P.PROJ_M] += 1
    assert (written == 1).all() and max(counts) - min(counts) <= 1
    # inside a tile: every accumulator element lands on its own (position,
    # channel) of the output tile, and the epilogue's 16-byte chunks store
    # each of the tile's elements once
    g, q = _lanes()
    hits = np.zeros((P.PROJ_M, P.PROJ_N), np.int32)
    for warp in range(WARPS):
        r0, c0 = _warp_tile(warp)
        for nb in range(4):
            for v in range(4):
                np.add.at(hits, (r0 + g + 8 * (v >> 1),
                                 c0 + nb * 8 + 2 * q + (v & 1)), 1)
    assert (hits == 1).all()
    e = np.arange(P.PROJ_M * P.PROJ_N // 4)
    stored = np.zeros((P.PROJ_M, P.PROJ_N), np.int32)
    for j in range(4):
        np.add.at(stored, (e // (P.PROJ_N // 4), 4 * (e % (P.PROJ_N // 4))
                           + j), 1)
    assert (stored == 1).all()


def _copies():
    """The (row, block) pairs each thread copies every stage: item e =
    tid + i * THREADS < PROJ_K * CHUNKS is (e // CHUNKS, e % CHUNKS)."""
    e = np.arange(-(-P.PROJ_K * CHUNKS // THREADS) * THREADS)
    e = e[e < P.PROJ_K * CHUNKS]
    return e // CHUNKS, e % CHUNKS


def _staged(b, m, k, tile, k0, x_off):
    """The flat x index (b * K + k) * M + position that a stage's copies
    put in each float of a ring slot (PROJ_K, XS), for x starting x_off
    floats past a 16-byte boundary; -2 where nothing is copied. Row r (k =
    k0 + r < K) is copied as the 16-byte blocks from the one holding
    position m0 that hold a needed position (m0 .. min(m0 + PROJ_M, M)),
    block c to the slot's row r at 4 c."""
    bb, m0 = divmod(tile, -(-m // P.PROJ_M))
    m0 *= P.PROJ_M
    span = min(P.PROJ_M, m - m0)
    slot = np.full((P.PROJ_K, XS), -2, np.int64)
    rows, blocks = _copies()
    for r, c in zip(rows, blocks):
        if k0 + r >= k:
            continue
        p = (bb * k + k0 + r) * m + m0  # the row's position m0
        lo = p - (x_off + p) % 4        # its 16-byte block's start
        src = lo + 4 * c
        if src < p + span:
            assert (slot[r, 4 * c:4 * c + 4] == -2).all()  # copied once
            slot[r, 4 * c:4 * c + 4] = src + np.arange(4)
    return slot


@pytest.mark.parametrize("x_off", [0, 1, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fragments_read_the_staged_values(shape, x_off):
    """For the first, a middle and the last tile, every stage: each A
    fragment element, read at its row's shift, is the x value of its (k,
    position) where both are in range; each B fragment element is the W
    value of its (k, channel), or 0 past K and N; an A fragment read hits
    a bank at most twice (rows 4 apart share a shift, rows 1 apart may
    not), a B fragment read is one 16-byte load a lane."""
    b, m, k, n = SHAPES[shape]
    geo = P.pw_proj_geometry(b, m, k, n)
    g, q = _lanes()
    kp = geo["stages"] * P.PROJ_K
    for tile in sorted({0, geo["tiles"] // 2, geo["tiles"] - 1}):
        bb, m0 = divmod(tile, -(-m // P.PROJ_M))
        m0 *= P.PROJ_M
        for st in range(geo["stages"]):
            k0 = st * P.PROJ_K
            flat = _staged(b, m, k, tile, k0, x_off).reshape(-1)
            shift = (x_off + (bb * k + k0 + q) * m + m0) % 4  # a lane's
            for warp in range(WARPS):
                r0, _ = _warp_tile(warp)
                for kk in range(0, P.PROJ_K, 8):
                    for reg in range(4):
                        kr = kk + q + 4 * (reg >> 1)
                        pos = r0 + g + 8 * (reg & 1)
                        off = kr * XS + shift + pos
                        assert np.bincount(off % 32).max() <= 2
                        ok = (k0 + kr < k) & (m0 + pos < m)
                        want = (bb * k + k0 + kr) * m + m0 + pos
                        assert (flat[off][ok] == want[ok]).all()
    # W's split slice of N tile y: entry e = (k step, n8 tile, lane) holds
    # (W[k][n], W[k + 4][n]), k = 8 step + q, n = 8 tile + g; warp (wm,
    # wn) reads entry (step, 4 wn + nb, lane) for its n8 tile nb
    e = np.arange(kp // 8 * (P.PROJ_N // 8) * 32)
    lane, tile8, step = e & 31, (e >> 5) % (P.PROJ_N // 8), \
        (e >> 5) // (P.PROJ_N // 8)
    ek, en = 8 * step + (lane & 3), 8 * tile8 + (lane >> 2)
    for warp in range(WARPS):
        _, c0 = _warp_tile(warp)
        for st in range(kp // 8):
            for nb in range(4):
                idx = (st * (P.PROJ_N // 8) + c0 // 8 + nb) * 32 + \
                    np.arange(32)
                assert (ek[idx] == 8 * st + q).all()
                assert (en[idx] == c0 + nb * 8 + g).all()
    # the epilogue's float2 writes: 16 different 8-byte slots a half warp
    for warp in range(WARPS):
        r0, c0 = _warp_tile(warp)
        off = (r0 + g) * WS + c0 + 2 * q
        for half in (slice(0, 16), slice(16, 32)):
            assert len(set((off[half] // 2) % 16)) == 16


def test_each_copy_is_one_threads_and_fits_its_slot():
    rows, blocks = _copies()
    assert len(rows) == P.PROJ_K * CHUNKS == len(set(zip(rows, blocks)))
    assert 4 * CHUNKS <= XS  # 33 blocks: 128 positions from any offset


@pytest.mark.parametrize("stages", [1, 2, 7, 16])
def test_ring_never_overwrites_or_reads_a_stage_too_early(stages):
    """The stage sequence of a block with ``stages`` stages in all: at
    iteration s, ``cp.async.wait_group(PROJ_STAGES - 2)`` has stage s in
    (its group, s, is older than the PROJ_STAGES - 2 newest), and the slot
    that stage s + PROJ_STAGES - 1 goes into holds no stage still to be
    read."""
    ns = P.PROJ_STAGES
    groups = list(range(ns - 1))  # the prologue's groups: stages 0 .. ns-2
    slots = {st % ns: st for st in range(min(ns - 1, stages))}
    for s in range(stages):
        done = groups[:len(groups) - (ns - 2)]
        assert s in done and slots[s % ns] == s
        nxt = s + ns - 1
        assert nxt % ns not in {(s + j) % ns for j in range(ns - 1)}
        if nxt < stages:
            slots[nxt % ns] = nxt
        groups.append(nxt)


def test_shared_memory_fits_one_block_and_refuses_larger_k():
    """The layout fits one block an SM at K 256, and a larger K, which K6
    once refused, now fits the same bytes: W is held PROJ_SLICE k at a
    time, so nothing is refused (the name is the test's from then)."""
    geo = P.pw_proj_geometry(1, 251 * 129, 256, 64)
    assert geo["smem"] == 4 * (256 * 128 + 3 * 32 * 136 + 128 * 72) == 220_160
    # one block an SM: two would need more than the SM's 228 KB
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK < 2 * geo["smem"]
    assert geo["grid"] == (132, 1) and geo["tiles"] == 253
    assert geo["slices"] == 1
    assert P.pw_proj_geometry(8, 251 * 129, 256, 64)["tiles"] == 2024
    for k, slices in ((257, 2), (512, 2), (513, 3), (4096, 16)):
        big = P.pw_proj_geometry(1, 100, k, 64)
        assert big["smem"] == P.pw_proj_smem(256) == 220_160
        assert (big["slices"], big["stages"]) == (slices, -(-k // P.PROJ_K))
    # the same call's plain version on the CPU
    x4 = torch.zeros(1, 257, 2, 3)
    assert P.pw_proj_packed(x4, torch.zeros(257, 5), None).shape == (1, 2, 15)


def test_launch_ints_match_the_c_entry():
    x4 = torch.zeros(2, 256, 5, 7)
    for w, strides in ((torch.zeros(64, 256).t(), (1, 256)),
                       (torch.zeros(256, 64), (64, 1))):
        ints = P.pw_proj_launch_ints(x4, w)
        assert (4, len(ints)) == kernel_lib._SIGNATURES["packed_tf"][
            "pw_proj_packed_fwd"]
        assert ints == (2, 35, 256, 64, *strides, 2)


@functools.cache
def _source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_python_constants_match_the_source():
    consts = _source()
    assert (consts["kProjThreads"], consts["kProjM"], consts["kProjN"],
            consts["kProjK"], consts["kProjStages"], consts["kProjPad"]) \
        == (P.PROJ_THREADS, P.PROJ_M, P.PROJ_N, P.PROJ_K, P.PROJ_STAGES,
            P.PROJ_PAD)
    # padded rows of 8 mod 32 floats: the 8 g x 4 q lanes of an unshifted
    # read hit 32 banks
    assert XS % 32 == 8 and WS % 32 == 8


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("contiguous_w", [False, True],
                         ids=["serving-view", "k7-dx-contiguous"])
def test_3xtf32_holds_the_gate_and_single_pass_tf32_does_not(contiguous_w,
                                                              one_thread):
    """K 256, N 64 on chip_smoke's scales (x N(0, 1), w N(0, 1/256), bias
    N(0, 1)): the emulated 3xTF32 product, out = bias + x^T w, stays within
    PACKED_TOL (1e-4) of the plain float32 version and within 1e-5 of its
    max of float64; single-pass TF32 does not hold 1e-4."""
    rng = np.random.default_rng(9)
    x4 = torch.from_numpy(rng.standard_normal((1, 256, 20, 129)).astype(
        np.float32))
    w_t = torch.from_numpy((rng.standard_normal((64, 256)) / 16).astype(
        np.float32))
    w = w_t.t().contiguous() if contiguous_w else w_t.t()
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    a = x4[0].reshape(256, -1).t()  # (M, K): position-major
    plain = P.pw_proj_packed_plain(x4, w, bias).reshape(-1, 64)
    exact = a.double() @ w.double() + bias.double()
    got = mm3(a, w) + bias
    assert (got - plain).abs().max().item() <= 1e-4
    assert (got.double() - exact).abs().max().item() <= \
        1e-5 * exact.abs().max().item()
    assert (mm1(a, w) + bias - plain).abs().max().item() > 1e-4


def _rz(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor core rounds
    its sums."""
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def test_summing_apart_removes_the_tensor_cores_drift(one_thread):
    """The 3xTF32 product of K 256, N 64 on N(0, 1) x and N(0, 1/256) w,
    each m16n8k8 step's sum (its 8 products exact, the accumulator added)
    rounded toward zero: kept in one tensor-core accumulator over all of K
    (``hk::mma3``), the outputs drift toward zero, a signed bias of about
    1.6e-6 against float32's ~1e-9; with the big products summed on the
    tensor core a stage (32 k) at a time and the stages added in float32,
    the cross terms apart (``hk::mma3_apart``, K6), the bias falls below
    1e-7, under float32's random error (rms ~3e-7)."""
    rng = np.random.default_rng(0)
    m_, k_, n_ = 4096, 256, 64
    x = torch.from_numpy(rng.standard_normal((m_, k_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k_, n_)) / 16).astype(
        np.float32))
    exact = x.double() @ w.double()
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _trunc(x - xb), _trunc(w - wb)

    def step(acc, a, b, k0):  # one k8 step on the tensor core
        return _rz(acc.double() + a[:, k0:k0 + 8].double()
                   @ b[k0:k0 + 8].double())

    one = torch.zeros(m_, n_)
    acc, part, corr = (torch.zeros(m_, n_) for _ in range(3))
    for k0 in range(0, k_, 8):
        for a, b in ((xs, wb), (xb, ws), (xb, wb)):
            one = step(one, a, b, k0)
        corr = step(step(corr, xs, wb, k0), xb, ws, k0)
        part = step(part, xb, wb, k0)
        if (k0 + 8) % P.PROJ_K == 0:
            acc, part = acc + part, torch.zeros(m_, n_)
    sign = exact.sign()
    bias_one = ((one.double() - exact) * sign).mean().item()
    apart = acc + corr
    bias_apart = ((apart.double() - exact) * sign).mean().item()
    plain = x @ w
    assert -2e-6 < bias_one < -1.2e-6
    assert abs(bias_apart) < 1e-7
    assert (apart.double() - exact).pow(2).mean().sqrt() < \
        (plain.double() - exact).pow(2).mean().sqrt()
