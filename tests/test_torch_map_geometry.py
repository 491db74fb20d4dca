"""The launch plan of K8 ``spatial_down_packed`` and K9
``spatial_up_packed``, on the CPU.

The wrappers (``ops/packed_tf.map_geometry``, ``row_runs``, ``map_smem``,
``SpatialMap.launch_args``) give ``csrc/packed_tf.cu`` its blocks (one
output row each for K8; for K9 the runs of rows that share their T row),
the shared-memory bytes and the map's launch arguments, and refuse a tile
that does not fit one Hopper block. These tests walk the blocks and the
threads' items as the two kernels do, at the six sites of the preset
(the three maps and their transposes) and at ragged ones, and check that
every output (row, f, channel) is written exactly once, that every value a
block reads from its tile was staged there, that K9's runs share their
source rows and K8 reads only the column blocks its map names, that the
tile fits at the preset, and that the Python constants equal the
source's.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from rtfs_tpu_torch.ops import kernel_lib
from rtfs_tpu_torch.ops import packed_tf as P



@functools.cache
def _source():
    with open(os.path.join(kernel_lib.CSRC_DIR, "packed_tf.cu")) as f:
        src = f.read()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _const(name):
    """A constant of csrc/packed_tf.cu: kThreads, kK8Items, kK9Items."""
    return _source()[1][name]


def _sites(t, f):
    """The six (name, map, K9?, f_in) sites of a packed map of T x F and its
    stride-2 k-4 level, as the packed TDANet block builds them."""
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
# multiple of 4, and a single-row level
GEOMETRIES = [(251, 129, 64), (13, 7, 6), (21, 18, 37), (3, 5, 4)]
CASES = [(g, i) for g in GEOMETRIES for i in range(6)]


def _ids(case):
    (t, f, c), i = case
    return f"{t}x{f}x{c}-{_sites(t, f)[i][0].replace(' ', '-')}"


def _visits(n, items=1):
    """Each item e < n a block's threads visit, once per visit: the loop
    ``for (e0 = tid; e0 < n; e0 += items * kThreads)`` over ``e = e0 + u *
    kThreads``, u < items, with ``e < n``."""
    threads = _const("kThreads")
    tid = np.arange(threads)
    e0 = tid[None, :] + items * threads * np.arange(
        -(-n // (items * threads)))[:, None]
    e = e0[:, :, None] + threads * np.arange(items)[None, None, :]
    return e[(e0[:, :, None] < n) & (e < n)]


def _planar(e, rows):
    """``planar_item``: lanes of 4 chunks x 8 rows."""
    lane, grp, groups = e & 31, e >> 5, (rows + 7) >> 3
    return (grp % groups) * 8 + (lane >> 2), (grp // groups) * 4 + (lane & 3)


def _planar_items(rows, chunks):
    return 32 * ((rows + 7) >> 3) * ((chunks + 3) >> 2)


def _chunk_cols(q, c):
    """The channels (or f) of chunk q of a side of c."""
    return [4 * q + k for k in range(4) if 4 * q + k < c]


def _smem(tile_rows, c, smap):
    ts, _ = smap.compact_t()
    cs = -(-c // 4) * 4 + P.MAP_PAD
    tile = 4 * tile_rows * cs
    return tile + 4 * (2 * smap.fs.size + 2 * ts.shape[1])


def _walk_up(smap, c, f_in):
    """K9 as spatial_up_kernel runs it: per block, the tile entries phase A
    stages, the tile entries phase B reads, the outputs it writes."""
    geo = P.map_geometry(smap, True, c, f_in)
    rows = geo["rows"]
    ts, tw = smap.compact_t()
    fp, cq = -(-f_in // 4), -(-c // 4)
    assert geo["tile_rows"] == 4 * fp
    assert geo["smem"] == _smem(4 * fp, c, smap)

    # phase A, the same items in every block that has a source
    staged = np.zeros((4 * fp, 4 * cq), np.int64)
    e = _visits(_planar_items(c, fp), _const("kK9Items"))
    cc, p = _planar(e, c)
    ok = (cc < c) & (p < fp)
    for k in range(4):
        np.add.at(staged, (4 * p[ok] + k, cc[ok]), 1)
    assert staged[:, :c].max() == 1 and staged[:, c:].sum() == 0
    assert (staged[:, :c] == 1).all()  # every (f_in, channel), padding rows too

    # phase B: chunk (f, q) of every row of the run
    chunks = np.zeros((smap.f_out, c), np.int64)
    for e in _visits(smap.f_out * cq):
        f, q = divmod(int(e), cq)
        cols = _chunk_cols(q, c)
        chunks[f, cols] += 1
        for j in range(smap.fs.shape[1]):
            if smap.fw[f, j] != 0:  # read only what phase A staged
                assert smap.fs[f, j] < f_in
                assert (staged[smap.fs[f, j], cols] == 1).all()
    assert (chunks == 1).all()

    written = np.zeros(smap.t_out, np.int64)
    for t0, t1 in zip(rows[:-1], rows[1:]):
        assert 1 <= t1 - t0 <= P.MAP_ROWS
        # the run's rows share the source rows the block stages once
        for t in range(t0, t1):
            np.testing.assert_array_equal(ts[t], ts[t0])
            np.testing.assert_array_equal(tw[t], tw[t0])
            assert (ts[t][tw[t] != 0] < smap.t_in).all()
        written[t0:t1] += 1
    assert rows[0] == 0 and rows[-1] == smap.t_out
    assert (written == 1).all()  # with chunks: every (t, f, c) once
    return geo


def _walk_down(smap, c, f_in):
    """K8 as spatial_down_kernel runs it: phase A's tile chunks and the
    (source row, column block) pairs a block reads, phase B's outputs."""
    geo = P.map_geometry(smap, False, c, f_in)
    np.testing.assert_array_equal(geo["rows"], np.arange(smap.t_out + 1))
    ts, tw = smap.compact_t()
    fq, cq = -(-smap.f_out // 4), -(-c // 4)
    assert geo["tile_rows"] == 4 * fq
    assert geo["smem"] == _smem(4 * fq, c, smap)

    # phase A: chunk (f2, q) of the tile, from the blocks fs names
    tile = np.zeros((4 * fq, 4 * cq), np.int64)
    blocks = set()
    for e in _visits(smap.f_out * cq, _const("kK8Items")):
        f2, q = divmod(int(e), cq)
        tile[f2, 4 * q:4 * q + 4] += 1
        for j in range(smap.fs.shape[1]):
            if smap.fw[f2, j] != 0:
                assert smap.fs[f2, j] < f_in
                blocks.add(int(smap.fs[f2, j]))
    assert (tile[:smap.f_out] == 1).all() and (tile[smap.f_out:] == 0).all()

    # phase B: chunk (c, p) of every channel's output row, from the tile
    out = np.zeros((c, smap.f_out), np.int64)
    e = _visits(_planar_items(c, fq))
    cc, p = _planar(e, c)
    ok = (cc < c) & (p < fq)
    for k in range(4):
        valid = ok & (4 * p + k < smap.f_out)
        assert (tile[4 * p[valid] + k, cc[valid]] == 1).all()
        np.add.at(out, (cc[valid], 4 * p[valid] + k), 1)
    assert (out == 1).all()  # with one row a block: every (c, t2, f2) once

    rows = {int(r) for t2 in range(smap.t_out) for r in ts[t2][tw[t2] != 0]}
    assert all(r < smap.t_in for r in rows)
    return geo, rows, blocks


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_blocks_write_every_output_once_from_staged_values(case):
    (t, f, c), i = case
    _, smap, up, f_in = _sites(t, f)[i]
    if up:
        _walk_up(smap, c, f_in)
    else:
        _walk_down(smap, c, f_in)


def test_preset_sites_fit_and_k9_stages_each_source_row_once_a_run():
    sites = {name: (smap, up, f_in)
             for name, smap, up, f_in in _sites(251, 129)}
    for name, (smap, up, f_in) in sites.items():
        geo = P.map_geometry(smap, up, 64, f_in)
        assert geo["smem"] <= 20_000 < kernel_lib.SMEM_PER_BLOCK, name
    # nearest 125 -> 251: rows 0-2 read source row 0, then pairs
    runs = P.map_geometry(sites["nearest"][0], True, 64, 64)["rows"]
    assert len(runs) - 1 == 125 and list(runs[:4]) == [0, 3, 5, 7]
    # the transposed select: one row a block, every other one with no source
    smap = sites["transposed select"][0]
    runs = P.map_geometry(smap, True, 64, 64)["rows"]
    assert len(runs) - 1 == 250
    _, tw = smap.compact_t()
    assert (tw[1::2] == 0).all() and (tw[0::2] != 0).all()
    assert (smap.fw[1::2] == 0).all()  # and every other f block


def test_k8_select_reads_half_the_rows_and_every_other_block():
    _, sel, _, f_in = _sites(251, 129)[1]
    _, rows, blocks = _walk_down(sel, 64, f_in)
    assert rows == set(range(0, 250, 2))
    assert blocks == set(range(0, 128, 2))


def test_tiles_that_do_not_fit_are_refused():
    up = P.cached_map("nearest", 2, 3, 800, 800)
    assert P.map_geometry(up, True, 64, 800)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK
    up = P.cached_map("nearest", 2, 3, 1024, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        P.map_geometry(up, True, 64, 1024)
    pool = P.cached_map("pool", 2, 1, 2048, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        P.map_geometry(pool, False, 64, 2048)
    # the same calls take the plain versions on the CPU
    assert P.spatial_up_packed(torch.zeros(1, 64, 2, 1024), up).shape == \
        (1, 3, 1024 * 64)


def test_launch_args_match_the_c_entries_and_are_kept():
    smap = P.cached_map("nearest", 6, 13, 3, 7)
    cpu = torch.device("cpu")
    for up, fn in ((True, "spatial_up_packed_fwd"),
                   (False, "spatial_down_packed_fwd")):
        f_in = 3 if up else 7
        ptrs, ints = smap.launch_args(up, 5, f_in, cpu)
        assert smap.launch_args(up, 5, f_in, cpu)[0] is ptrs  # kept
        # x and out, the map's pointers; B, then the map's ints
        assert (2 + len(ptrs), 1 + len(ints)) == \
            kernel_lib._SIGNATURES["packed_tf"][fn]
        ts, _ = smap.compact_t()
        want = [smap.t_in, f_in, 5, smap.t_out, smap.f_out, ts.shape[1],
                smap.fs.shape[1]]
        if up:
            want.append(len(P.row_runs(*smap.compact_t())) - 1)
        assert list(ints) == want


def test_python_constants_match_the_source():
    src, consts = _source()
    assert consts["kMapPad"] == P.MAP_PAD
    max_smem = re.search(r"kMaxSmem = (\d+) \* (\d+);", src)
    assert int(max_smem[1]) * int(max_smem[2]) == kernel_lib.SMEM_PER_BLOCK
