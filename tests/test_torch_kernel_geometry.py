"""The launch geometry of the K2 and K3 backward kernels, on the CPU
(the forwards' is in ``test_torch_fwd_geometry.py``).

The wrappers (``ops/sru_fused.k2_bwd_geometry``, ``ops/convt_tm.
bwd_geometry``, ``ops/kernel_lib.split_k``) size the grids, the split-K
chunks and the scratch that ``csrc/sru_fused.cu`` and ``csrc/convt_tm.cu``
launch with. These tests walk the blocks as the kernels do and check that
every (step, column) is reduced or written exactly once, that the tiles
cover every output, and that the shared memory fits one Hopper block; and
that the Python constants equal the sources'.
"""

import os
import re

import numpy as np
import pytest

from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

# (T or L, B) of the two DualPathRNN sites at the preset's bs 4, and
# ragged, single-step and single-column cases
SITES = [(57, 500), (118, 256), (37, 131), (1, 77), (5, 1)]


def _split_k_columns(n_cols, cols, chunks, stage):
    """The columns each chunk's block reduces, stage by stage and lane by
    lane, as the wgrad kernels walk them."""
    seen = np.zeros(n_cols, dtype=np.int64)
    for c in range(chunks):
        c0, c1 = c * cols, min((c + 1) * cols, n_cols)
        for s0 in range(c0, c1, stage):
            lanes = s0 + np.arange(stage)
            seen[lanes[lanes < c1]] += 1
    return seen


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("tiles", [1, 3, 4, 200])
def test_split_k_reduces_every_column_once(t_len, bsz, tiles):
    n_cols = t_len * bsz
    cols, chunks = kernel_lib.split_k(n_cols, tiles, 32)
    assert cols % 32 == 0 and chunks >= 1
    assert (chunks - 1) * cols < n_cols <= chunks * cols  # no empty chunk
    assert tiles * chunks <= max(tiles, 2 * kernel_lib.SMS)
    seen = _split_k_columns(n_cols, cols, chunks, 32)
    assert (seen == 1).all()
    # each column splits into one (t, b), and every (t, b) is met once
    t, b = np.divmod(np.arange(n_cols), bsz)
    pairs = np.zeros((t_len, bsz), dtype=np.int64)
    np.add.at(pairs, (t, b), seen)
    assert (pairs == 1).all()


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("hdim", [32, 48, 8])
def test_k2_backward_geometry(t_len, bsz, hdim):
    geo = sru_fused.k2_bwd_geometry(t_len, hdim, bsz)
    tile = sru_fused.GEMM_TILE
    # U (6H x B per step) and dx (2H x B per step): tiles cover every
    # output, and no tile starts past the edge
    for name, rows in (("u_grid", 6 * hdim), ("dx_grid", 2 * hdim)):
        nx, ny, nz = geo[name]
        assert nz == t_len
        assert (nx - 1) * tile < bsz <= nx * tile
        assert (ny - 1) * tile < rows <= ny * tile
    nx, ny, nz = geo["wgrad_grid"]
    assert (ny - 1) * tile < 6 * hdim <= ny * tile
    assert (nx - 1) * tile < 2 * hdim <= nx * tile
    assert nz == geo["chunks"]
    seen = _split_k_columns(t_len * bsz, geo["cols"], geo["chunks"],
                            sru_fused.WGRAD_COLS)
    assert (seen == 1).all()
    # the scan (csrc/sru_scan.cuh): one (v, b) partial a block of
    # columns, as its geometry has them (tests/test_torch_scan_geometry.py)
    cols = geo["scan"]["cols"]
    assert geo["scan"] == sru_fused.scan_bwd_geometry(t_len, hdim, bsz, 2)
    assert (geo["scan_blocks"] - 1) * cols < bsz <= geo["scan_blocks"] * cols
    # static shared memory, under the 48 KB a block gets without opting in
    assert geo["gemm_smem"] <= 48 * 1024 and geo["wgrad_smem"] <= 48 * 1024


@pytest.mark.parametrize("length,bsz", SITES)
@pytest.mark.parametrize("c_in,c_out,k", [(64, 64, 8), (32, 48, 5),
                                          (96, 64, 8), (160, 130, 8)])
def test_k3_backward_geometry(length, bsz, c_in, c_out, k):
    geo = convt_tm.bwd_geometry(length, c_in, c_out, k, bsz)
    steps, (tiles, runs, nz) = geo["steps"], geo["dx_grid"]
    co_slice, n_in = geo["co_slice"], geo["in_slices"]
    assert n_in == -(-c_in // convt_tm.MAX_IN)
    assert nz == n_in * geo["out_slices"]
    assert geo["out_slices"] == -(-c_out // co_slice)
    # block z: dx rows (z % n_in) MAX_IN .., summed over output channels
    # (z // n_in) co_slice ..; each (input, output) pair once
    pairs = np.zeros((c_in, c_out), dtype=np.int64)
    for z in range(nz):
        i0, o0 = z % n_in * convt_tm.MAX_IN, z // n_in * co_slice
        assert i0 < c_in and o0 < c_out
        pairs[i0:i0 + convt_tm.MAX_IN, o0:o0 + co_slice] += 1
    assert (pairs == 1).all()
    assert geo["dx_smem"] == convt_tm.dx_smem(k, co_slice)
    # every (l, b) of dx is written by exactly one block, and no block is
    # empty
    written = np.zeros((length, bsz), dtype=np.int64)
    for tile in range(tiles):
        for run in range(runs):
            l0, l1 = run * steps, min(length, (run + 1) * steps)
            b0, b1 = tile * convt_tm.DX_COLS, min(
                bsz, (tile + 1) * convt_tm.DX_COLS)
            assert l0 < l1 and b0 < b1
            written[l0:l1, b0:b1] += 1
    assert (written == 1).all()
    # the dx blocks (one an SM: W alone is k * C_out * 256 bytes) fill the
    # card once where the columns allow it
    assert geo["dx_smem"] <= kernel_lib.SMEM_PER_BLOCK
    if tiles * nz <= kernel_lib.SMS:
        assert tiles * runs * nz <= kernel_lib.SMS
    nx, ny, nz = geo["wgrad_grid"]
    assert (ny - 1) * convt_tm.WGRAD_ROWS < k * c_out <= ny * convt_tm.WGRAD_ROWS
    assert (nx - 1) * convt_tm.MAX_IN < c_in <= nx * convt_tm.MAX_IN
    assert nz == geo["chunks"]
    seen = _split_k_columns(length * bsz, geo["cols"], geo["chunks"],
                            convt_tm.WGRAD_COLS)
    assert (seen == 1).all()


def test_k3_dx_shared_memory_at_the_preset():
    """All of W (8 x 64 x 64 floats), the ring of 9 g rows of 64 x 32 and
    three tap groups' exchange tiles of 64 x 32: 229,376 of the 232,448
    bytes a block may use."""
    geo = convt_tm.bwd_geometry(57, 64, 64, 8, 500)
    assert geo["dx_smem"] == 4 * (8 * 64 * 64 + 9 * 64 * 32 + 3 * 64 * 32)
    assert geo["dx_smem"] == 229_376 <= kernel_lib.SMEM_PER_BLOCK


def _constants(name):
    path = os.path.join(kernel_lib.CSRC_DIR, f"{name}.cu")
    with open(path) as f:
        src = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("source,pairs", [
    ("sru_fused", {"kLay0Threads": sru_fused.LAY0_THREADS,
                   "kTile": sru_fused.GEMM_TILE,
                   "kStage": sru_fused.GEMM_STAGE,
                   "kWgCols": sru_fused.WGRAD_COLS,
                   "kFwdThreads": sru_fused.FWD_THREADS,
                   "kFwdMT": sru_fused.FWD_MT,
                   "kFwdNB": sru_fused.FWD_NB,
                   "kFwdAhead": sru_fused.FWD_AHEAD}),
    ("convt_tm", {"kDxCols": convt_tm.DX_COLS, "kMaxIn": convt_tm.MAX_IN,
                  "kDxGroups": convt_tm.DX_GROUPS,
                  "kWgRows": convt_tm.WGRAD_ROWS,
                  "kWgCols": convt_tm.WGRAD_COLS,
                  "kMaxOut": convt_tm.MAX_OUT,
                  "kFwdCols": convt_tm.FWD_COLS,
                  "kFwdPass": convt_tm.FWD_PASS}),
])
def test_python_constants_match_the_sources(source, pairs):
    consts = _constants(source)
    for name, value in pairs.items():
        assert consts[name] == value, name
