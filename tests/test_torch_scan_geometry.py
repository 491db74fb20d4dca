"""The SRU backward adjoint scan's geometry and ring, on the CPU.

``ops/sru_fused.scan_bwd_geometry`` sizes the blocks, grid and shared
memory with which ``csrc/sru_scan.cuh`` runs K1's, K2's and K4's backward
scans, and the wrappers size the (v, b) partial buffers from it. These
tests walk the blocks as the kernel does: every (unit, column, direction)
gets one thread, every (v, b) partial is written once and holds its
block's columns of one unit, the grid fills the SMs where B allows, and
the ring fits shared memory. They emulate one thread's ring of copies
step by step, the copies landing at the wait that covers them or as soon
as they are issued: each step reaches the chain in its scan order, copied
before it is read and not overwritten before it is used, and no copy
reads a row of u that a step has already written over (K2 writes du over
U). They also hold the Python constants and the C entries' signatures to
the sources. About 3 s alone.
"""

import os
import re

import numpy as np
import pytest

from rtfs_tpu_torch.ops import kernel_lib, sru_fused

AHEAD, GROUP = sru_fused.SCAN_AHEAD, sru_fused.SCAN_GROUP

# (T, B): the bs-4 training sites, the bs-1 and bs-8 sites, ragged B, one
# step, and T shorter than the ring, as long, one step longer
SITES = [(57, 500), (118, 256), (57, 125), (118, 64), (57, 1000), (118, 512),
         (37, 131), (21, 77), (13, 1), (1, 77), (AHEAD // 2, 200),
         (AHEAD, 64), (AHEAD + 1, 131)]


def _source(name):
    with open(os.path.join(kernel_lib.CSRC_DIR, name)) as f:
        return f.read()


@pytest.mark.parametrize("t_len,bsz", SITES)
@pytest.mark.parametrize("hdim", [8, 32, 48])
@pytest.mark.parametrize("dirs", [1, 2])
def test_scan_backward_geometry(t_len, bsz, hdim, dirs):
    geo = sru_fused.scan_bwd_geometry(t_len, hdim, bsz, dirs)
    cols, units = geo["cols"], geo["units"]
    threads = cols * units
    # the kernel's block shapes (the C entries refuse any other)
    assert cols % 32 == 0 and threads in (32, 64, 128)
    assert threads <= sru_fused.SCAN_THREADS
    assert cols == min(threads, -(-bsz // 32) * 32)
    gx, gy, gz = geo["grid"]
    assert (gx, gy, gz) == (-(-bsz // cols), -(-hdim // units), dirs)
    assert geo["parts"] == gx
    # the grid fills the card where B allows, with the largest block that
    # does
    assert gx * gy * gz >= kernel_lib.SMS or threads == 32
    if threads < sru_fused.SCAN_THREADS:
        wider = 2 * threads
        wc = min(wider, -(-bsz // 32) * 32)
        assert -(-bsz // wc) * -(-hdim // (wider // wc)) * dirs \
            < kernel_lib.SMS
    # the ring: six floats a step, AHEAD steps a thread
    assert geo["ahead"] == AHEAD
    assert geo["smem"] == 4 * AHEAD * 6 * threads <= kernel_lib.SMEM_PER_BLOCK
    # walk the blocks: thread tid of block (x, y, z) takes column x * cols
    # + tid % cols and unit y * units + tid / cols of direction z; each
    # warp's sums are shuffled together, then thread tid < 4 units writes
    # sum k = tid % 4 of unit tid / 4 over its cols / 32 warps
    rng = np.random.default_rng(t_len * bsz + hdim)
    terms = rng.standard_normal((dirs, 4, hdim, bsz))  # a thread's sums
    visited = np.zeros((hdim, bsz, dirs), np.int64)
    written = np.zeros((gx, dirs, 4, hdim), np.int64)
    part = np.zeros((gx, dirs, 4, hdim))
    tid = np.arange(threads)
    for x in range(gx):
        for y in range(gy):
            b, j = x * cols + tid % cols, y * units + tid // cols
            live = (b < bsz) & (j < hdim)
            assert live.any()
            if (t_len, bsz) in ((57, 125), (118, 64)):  # bs-1 sites
                assert 2 * live.sum() >= threads
            for z in range(gz):
                np.add.at(visited, (j[live], b[live], z), 1)
                acc = np.zeros((threads, 4))
                acc[live] = terms[z][:, j[live], b[live]].T
                warp_sums = acc.reshape(threads // 32, 32, 4).sum(1)
                per = cols // 32
                for w in range(min(threads, 4 * units)):
                    u, k = w // 4, w % 4
                    if y * units + u < hdim:
                        written[x, z, k, y * units + u] += 1
                        part[x, z, k, y * units + u] = warp_sums[
                            u * per:(u + 1) * per, k].sum()
    assert (visited == 1).all()
    assert (written == 1).all()
    # each partial holds its block's columns of its unit; their sum over
    # the blocks is the (v, b) gradient's
    for x in range(gx):
        want = terms[:, :, :, x * cols:(x + 1) * cols].sum(-1)
        np.testing.assert_allclose(part[x], want, atol=1e-9)


def _ring(t_len, reverse, eager):
    """One thread's walk, as ``sru_scan_bwd_kernel`` makes it: copies of
    scan step k (u, the highway, dh at t(k); c_prev at t(k + 1), zero past
    the end) into slot k % AHEAD as one commit group, AHEAD in flight; per
    GROUP steps a wait until at most AHEAD - GROUP groups are pending, the
    slots read, refilled with the next steps, then the steps' stores. A
    copy lands when issued (``eager``) or at the wait that covers it.
    Returns the (t, c_t, c_prev) the chain saw, in order."""
    time_of = (lambda i: i) if reverse else (lambda i: t_len - 1 - i)
    slots, pending, written = {}, [], set()
    issued = 0

    def land(group):
        for k, slot in group:
            t = time_of(k) if k < t_len else None
            # no row of u read here has been written over (u = du in K2)
            assert t is None or t not in written
            tp = time_of(k + 1) if k + 1 < t_len else None
            slots[slot] = (t, tp)

    def issue():
        nonlocal issued
        k, issued = issued, issued + 1
        group = [(k, k % AHEAD)]
        if eager:
            land(group)
        else:
            pending.append(group)

    for _ in range(AHEAD):
        issue()
    seen = []
    c_t = time_of(0)
    for i0 in range(0, t_len, GROUP):
        while len(pending) > AHEAD - GROUP:
            land(pending.pop(0))
        got = [slots[(i0 + s) % AHEAD] for s in range(GROUP)]
        for s in range(GROUP):
            issue()
        for s, (t, tp) in enumerate(got):
            if i0 + s >= t_len:
                break
            assert t == time_of(i0 + s)  # this step's copy, not another's
            ct = c_t if s == 0 else got[s - 1][1]
            seen.append((t, ct, tp))
            written.add(t)  # the step's stores
        c_t = got[-1][1]
    while pending:  # the copies past the end, waited for at exit
        land(pending.pop(0))
    return seen


@pytest.mark.parametrize("t_len", sorted({1, 2, AHEAD - 1, AHEAD, AHEAD + 1,
                                          2 * AHEAD + 3, 57, 118}))
@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("eager", [False, True])
def test_scan_ring_hands_the_chain_every_step_in_order(t_len, reverse,
                                                       eager):
    seen = _ring(t_len, reverse, eager)
    order = list(range(t_len)) if reverse else list(range(t_len - 1, -1, -1))
    assert [t for t, _, _ in seen] == order
    for i, (t, c_t, c_prev) in enumerate(seen):
        assert c_t == t  # c_t carried from the last step's c_prev
        assert c_prev == (order[i + 1] if i + 1 < t_len else None)


def test_k2_and_wrappers_size_the_partials_from_the_scan():
    for t_len, bsz in SITES:
        geo = sru_fused.k2_bwd_geometry(t_len, 32, bsz)
        assert geo["scan"] == sru_fused.scan_bwd_geometry(t_len, 32, bsz, 2)
        assert geo["scan_blocks"] == geo["scan"]["parts"]
    with pytest.raises(ValueError):
        sru_fused.scan_bwd_geometry(0, 32, 256, 1)
    with pytest.raises(ValueError):
        sru_fused.scan_bwd_geometry(57, 32, 256, 3)


def _entry_params(src, fn):
    """(pointer, int) parameter counts of ``extern "C" int fn(...)``,
    without the stream."""
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    params = params[:-1]
    n_ptr = sum("void*" in p for p in params)
    assert all("void*" in p or p.startswith("int ") for p in params)
    return n_ptr, len(params) - n_ptr


def test_scan_constants_entries_and_sources():
    header = _source("sru_scan.cuh")
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", header)}
    assert consts == {"kScanThreads": sru_fused.SCAN_THREADS,
                      "kScanAhead": AHEAD, "kScanGroup": GROUP}
    # every entry that launches the scan, its C signature as kernel_lib
    # calls it: (pointers, ints) with cols and units last
    for lib, fn, want in (
            ("sru_fused", "sru_dual_recurrence_bwd", (10, 5)),
            ("sru_fused", "sru_hidden_layer_bwd", (15, 6)),
            ("sru_pallas", "sru_recurrence_bwd", (8, 6))):
        assert kernel_lib._SIGNATURES[lib][fn] == want
        assert _entry_params(_source(f"{lib}.cu"), fn) == want
        # the scan is the header's: a header edit rebuilds both libraries
        assert "sru_scan.cuh" in kernel_lib._sources(lib)
    for lib, kernel in (("sru_fused", "launch_scan_bwd<1>"),
                        ("sru_fused", "launch_scan_bwd<2>"),
                        ("sru_pallas", "launch_scan_bwd<4>")):
        assert kernel in _source(f"{lib}.cu")
    # one scan: neither source keeps a backward scan of its own
    for lib in ("sru_fused", "sru_pallas"):
        src = _source(f"{lib}.cu")
        assert "sru_rec_bwd_kernel" not in src and "block_sum" not in src
        assert "__global__ void sru_scan_bwd_kernel" not in src
