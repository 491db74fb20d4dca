"""The redesigned bf16 forwards of K2 and K3, on the CPU: their order of
sums done in plain torch against the port's plain bf16 versions and
rtfs_tpu's Pallas ops in interpret mode, their launch geometries walked as
the kernels walk them, and their constants and C entries against the
sources.

- K2 (``sru_hid_fwd_bf16_kernel``): a block owns one direction, bt batch
  columns and a slice of units, and walks chunks of S steps: X's chunk
  staged (vec-value copies, or where B is odd the words that hold each
  (row, step) realigned), U = W_d X in k16 steps into float32, the scan
  over the chunk with c carried, the highway term read from the staged
  chunk, h and c rounded once. Its producer and scan warps hand over
  slots by named barriers: a random interleaving of the two programs
  shows every slot written only when its last readers are done and read
  only when it holds the chunk wanted.
- K3 (``convt1d_tm_fwd_bf16_kernel``): a block holds W_flat's rows of its
  output channels and walks its run of items (a pass of 8 steps of one
  column tile) through a ring of x rows, out[t] summed over k16 steps of
  the input channels (outer) and taps (inner) in float32, rounded once
  (float32 partials of split input channels summed in order, then
  rounded); every row read is in its slot, every output written once;
  where B is odd each channel row is staged as its aligned 16-byte blocks
  and realigned in place.

The gates are the card tests': two bf16 ulps (|diff| <= 2^-7 max(|ref|,
2^-6)) against the plain bf16 version and JAX. One torch thread; ~20 s
alone.
"""

import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rtfs_tpu.ops import convt_tm as jconvt
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

BF16 = ml_dtypes.bfloat16
# the main path's six forward sites: (L, B) at bs 1, 4 and 8, freq L 57
# over B 125 bs and time L 118 over B 64 bs
SITES = [(t, per * bs) for bs in (1, 4, 8) for t, per in ((57, 125),
                                                          (118, 64))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(rng, shape, scale=1.0):
    """bf16 values as a numpy bf16 array (JAX's input) and the same bits
    as a torch bf16 tensor (the port's)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _ulp_gate(got, want, what):
    g = torch.as_tensor(np.asarray(got, dtype=np.float32)).float()
    w = torch.as_tensor(np.asarray(want, dtype=np.float32)).float()
    bound = 2.0 ** -7 * torch.clamp(w.abs(), min=2.0 ** -6)
    ratio = ((g - w).abs() / bound).max().item()
    assert ratio <= 1.0, (what, ratio)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's values as a flat array of their bit patterns."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16).ravel()


def _values(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.int16)).view(
        torch.bfloat16).float()


def _words(bits, first, n_words):
    """The 4-byte copies of the words from the one holding element
    ``first`` on (an array of ``first``'s shape, n_words words each, two
    values a word, the lower element first); a word reads only the values
    inside the array (0, 2 or 4 bytes), the rest zero, as the kernels'
    ``cp.async`` of 4 bytes with its read size."""
    w = (first >> 1)[..., None] + np.arange(n_words)
    lo, hi = 2 * w, 2 * w + 1
    out = np.zeros(w.shape + (2,), np.uint16)
    out[..., 0] = np.where(lo < bits.size, bits[np.minimum(lo, bits.size - 1)], 0)
    out[..., 1] = np.where(hi < bits.size, bits[np.minimum(hi, bits.size - 1)], 0)
    return out.reshape(w.shape[:-1] + (2 * n_words,))


# ---------------------------------------------------------------- K2


def k2_stage(xf_bits, xr_bits, shape, geo, dirn, tile, n):
    """Chunk n's X slot ([k][column], bit patterns) of a block of
    direction ``dirn`` and batch tile ``tile``, as the kernel stages it:
    vec values a copy (each inside one step's bt columns, source and
    destination aligned to its bytes), or where vec is 1 each (row, step)'s
    bt // 2 + 1 words from the one holding its first value, realigned
    (zero past 2H, T and B)."""
    t_len, h, bsz = shape
    bt, s_len, cols, vec = geo["bt"], geo["steps"], geo["cols"], geo["vec"]
    k16, xs, b0 = -(-2 * h // 16) * 16, cols + 8, tile * bt
    k, col = np.meshgrid(np.arange(k16), np.arange(cols), indexing="ij")
    s, c = col // bt, col % bt
    ii = n * s_len + s
    t = ii if dirn == 0 else t_len - 1 - ii
    first = (t * h + np.where(k < h, k, k - h)) * bsz + b0  # (k, s)'s
    on = (k < 2 * h) & (ii < t_len)
    ok = on & (b0 + c < bsz)
    src = np.where(k < h, 0, 1)
    if vec > 1:
        starts = col % vec == 0
        # a copy stays in its step's columns; both ends aligned
        assert ((c[starts] + vec) <= bt).all()
        assert ((k * xs + col)[starts] % vec == 0).all()
        assert ((first + c)[starts & on] % vec == 0).all()
        # a copy is wholly inside B or wholly outside
        grp = ok.reshape(k16, cols // vec, vec)
        assert (grp.all(-1) | ~grp.any(-1)).all()
        flat = np.clip(first + c, 0, xf_bits.size - 1)
        val = np.where(src == 0, xf_bits[flat], xr_bits[flat])
    else:
        seg = bt // 2 + 1
        fs = np.clip(first[:, ::bt], 0, None)  # (k, s)
        raw = np.where(src[:, ::bt, None] == 0, _words(xf_bits, fs, seg),
                       _words(xr_bits, fs, seg))  # (k, S, 2 seg)
        # the words cover the segment's bt values
        assert (2 * (fs >> 1) + 2 * seg >= fs + bt).all()
        sh = (fs & 1)[:, :, None] + np.arange(bt)  # (k, S, bt)
        val = np.take_along_axis(raw, sh, axis=2).reshape(k16, cols)
    slot = np.zeros((k16, xs), np.uint16)
    slot[:, :cols] = np.where(ok, val, 0)
    return slot


def k2_fwd16_emulated(x_f, x_r, wt, vb, geo, with_c=False):
    """K2's bf16 forward as ``sru_hid_fwd_bf16_kernel`` computes it, block
    by block (direction, unit slice, batch tile) and chunk by chunk: X
    staged (``k2_stage``), U = W_d X summed over k16 steps in float32, the
    scan from U and the staged highway row, h and c rounded once. Also
    returns how often each (step, unit, column) of each direction was
    scanned."""
    t_len, h, bsz = x_f.shape
    bt, s_len, units = geo["bt"], geo["steps"], geo["units"]
    cols, slices = geo["cols"], geo["slices"]
    k16 = -(-2 * h // 16) * 16
    rows = -(-3 * units // 16) * 16
    xf_bits, xr_bits = _bits(x_f), _bits(x_r)
    outs = [torch.full((t_len, h, bsz), float("nan")) for _ in range(4)]
    seen = np.zeros((2, t_len, h, bsz), np.int32)
    wtf, vbf = wt.float(), vb.float()
    for dirn in (0, 1):
        v_f, v_r, b_f, b_r = vbf[4 * dirn:4 * dirn + 4]
        for z in range(slices):
            j0 = z * units
            hs = min(units, h - j0)
            wd = torch.zeros(rows, k16)
            for gate in range(3):
                r0 = (3 * dirn + gate) * h + j0
                wd[gate * units:gate * units + hs, :2 * h] = wtf[r0:r0 + hs]
            js = torch.arange(j0, j0 + units).clamp(max=h - 1)
            for tile in range(geo["grid"][0]):
                b0 = tile * bt
                c = torch.zeros(units, bt)
                for n in range(geo["chunks"]):
                    x = _values(k2_stage(xf_bits, xr_bits, x_f.shape, geo,
                                         dirn, tile, n))
                    u = torch.zeros(rows, cols)
                    for k0 in range(0, k16, 16):
                        u = u + wd[:, k0:k0 + 16] @ x[k0:k0 + 16, :cols]
                    for s in range(min(s_len, t_len - n * s_len)):
                        i = n * s_len + s
                        t = i if dirn == 0 else t_len - 1 - i
                        sl = slice(s * bt, s * bt + bt)
                        hw = x[dirn * h + js, sl]
                        f = torch.sigmoid(u[units:2 * units, sl]
                                          + v_f[js, None] * c + b_f[js, None])
                        c = f * c + (1 - f) * u[:units, sl]
                        r = torch.sigmoid(u[2 * units:3 * units, sl]
                                          + v_r[js, None] * c + b_r[js, None])
                        hv = r * c + (1 - r) * hw
                        nb = min(bt, bsz - b0)
                        outs[dirn][t, j0:j0 + hs, b0:b0 + nb] = hv[:hs, :nb]
                        outs[2 + dirn][t, j0:j0 + hs, b0:b0 + nb] = c[:hs, :nb]
                        seen[dirn, t, j0:j0 + hs, b0:b0 + nb] += 1
    outs = [o.to(torch.bfloat16) for o in outs]
    return (tuple(outs) if with_c else tuple(outs[:2])), seen


def _k2_inputs(rng, t_len, h, bsz):
    x_f, tx_f = _bf(rng, (t_len, h, bsz), 0.5)
    x_r, tx_r = _bf(rng, (t_len, h, bsz), 0.5)
    wt, twt = _bf(rng, (6 * h, 2 * h), (2 * h) ** -0.5)
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    return (tx_f, tx_r, twt, sru_fused.vb_pack(tv, tb)), (x_f, x_r, wt, v, b)


# (T, H, B, bt forced or 0, with c): B odd with bt 8 (five-word segments)
# and bt 1, B a multiple of 4 (8-byte copies) over a ragged T (13 steps in
# chunks of 16), five chunks through the rings, H 48 over two unit slices
# (bt 8: 48 units' scan threads would not fit), with c
K2_CASES = [(13, 8, 11, 8, True), (13, 8, 11, 1, False),
            (13, 8, 12, 4, False), (37, 8, 16, 8, True),
            (7, 48, 10, 8, True)]


@pytest.mark.parametrize("t_len,h,bsz,bt,with_c", K2_CASES)
def test_k2_fwd16_order_of_sums_matches_plain_and_jax(t_len, h, bsz, bt,
                                                      with_c):
    """The kernel's staging, k16 sums and scan, block by block, against the
    plain bf16 forward and the Pallas op in interpret mode (h); every
    (step, unit, column) scanned once."""
    rng = np.random.default_rng(t_len + h + bsz)
    args, (x_f, x_r, wt, v, b) = _k2_inputs(rng, t_len, h, bsz)
    geo = sru_fused.k2_fwd_bf16_geometry(t_len, h, bsz, bt=bt)
    if h == 48:
        assert geo["slices"] >= 2
    got, seen = k2_fwd16_emulated(*args, geo, with_c)
    assert (seen == 1).all()
    want = sru_fused.sru_hidden_layer_plain(*args, with_c)
    for i, (g, w) in enumerate(zip(got, want)):
        _ulp_gate(g.float(), w.float(), f"K2 output {i} vs plain")
    vb = jfused._vb_pack(jnp.asarray(v), jnp.asarray(b))
    ref = jfused.sru_hidden_layer(jnp.asarray(x_f), jnp.asarray(x_r),
                                  jnp.asarray(wt), vb, True)
    for i in range(2):
        _ulp_gate(got[i].float(), ref[i], f"K2 h {i} vs JAX")


def _k2_pipeline(n_chunks, words, rng):
    """The producer and scan warps' programs of ``sru_hid_fwd_bf16_kernel``
    run in a random interleaving. A copy lands as early as it may (at its
    issue): its slot must then hold nothing a reader still needs. Checks
    every read sees the chunk it wants, no counted barrier takes a second
    arrival before its phase completes, and nothing deadlocks."""
    ahead = sru_fused.FWD16_AHEAD
    xs_n, raw_n = ahead + 2, ahead + 1
    x_slot, raw_slot, u_slot = [None] * xs_n, [None] * raw_n, [None] * 2
    done = {"product": set(), "scan": set(), "realign": set()}
    full, empty = [[0, 0], [0, 0]], [[0, 0], [0, 0]]  # [arrived, synced]

    def issue(m):
        if m >= n_chunks:
            return
        if words:
            old = raw_slot[m % raw_n]
            assert old is None or old in done["realign"], (m, old)
            raw_slot[m % raw_n] = m
        else:
            old = x_slot[m % xs_n]
            assert old is None or (old in done["product"]
                                   and old in done["scan"]), (m, old)
            x_slot[m % xs_n] = m

    def producer():
        for m in range(ahead):
            issue(m)
        for n in range(n_chunks):
            if n >= 2:
                b = n & 1
                while empty[b][0] <= empty[b][1]:
                    yield
                empty[b][1] += 1
            yield  # the copies' wait and the producers' barrier
            issue(n + ahead)
            if words:
                assert raw_slot[n % raw_n] == n
                old = x_slot[n % xs_n]
                assert old is None or (old in done["product"]
                                       and old in done["scan"]), (n, old)
                x_slot[n % xs_n] = n
                done["realign"].add(n)
                yield
            assert x_slot[n % xs_n] == n
            old = u_slot[n & 1]
            assert old is None or old in done["scan"], (n, old)
            u_slot[n & 1] = n
            done["product"].add(n)
            assert full[n & 1][0] == full[n & 1][1]
            full[n & 1][0] += 1
            yield

    def scan():
        for n in range(n_chunks):
            b = n & 1
            while full[b][0] <= full[b][1]:
                yield
            full[b][1] += 1
            assert u_slot[b] == n and x_slot[n % xs_n] == n
            yield  # the scan reads them for its S steps
            assert u_slot[b] == n and x_slot[n % xs_n] == n
            done["scan"].add(n)
            if n + 2 < n_chunks:
                assert empty[b][0] == empty[b][1]
                empty[b][0] += 1
            yield

    progs = [producer(), scan()]
    live = [True, True]
    while any(live):
        order = [i for i in range(2) if live[i]]
        i = order[rng.integers(len(order))]
        try:
            next(progs[i])
        except StopIteration:
            live[i] = False
    assert done["scan"] == set(range(n_chunks))
    assert full[0][0] == full[0][1] and full[1][0] == full[1][1]
    assert empty[0][0] == empty[0][1] and empty[1][0] == empty[1][1]


@pytest.mark.parametrize("words", [False, True])
def test_k2_fwd16_slots_are_read_only_when_staged(words):
    """The hand-over of X's ring, the word copies' ring and U's two slots
    between the producer and scan warps, over 1-15 chunks (the sites walk
    8 and 15), in 40 random interleavings each."""
    rng = np.random.default_rng(int(words))
    for n_chunks in range(1, 16):
        for _ in range(40):
            _k2_pipeline(n_chunks, words, rng)


K2_WALK = [(t, 32, b) for t, b in SITES] + [(37, 32, 131), (1, 32, 77),
                                            (23, 48, 131), (19, 80, 64),
                                            (9, 80, 125), (5, 268, 20)]


@pytest.mark.parametrize("t_len,h,bsz", K2_WALK)
def test_k2_fwd16_geometry_covers_fits_and_fills(t_len, h, bsz):
    """The blocks, scan threads and chunks cover every (step, unit,
    column) of each direction once; the shared memory is the source's
    layout within a block's; at the main-path sites the grid fills the
    card's SMs with bt 8."""
    geo = sru_fused.k2_fwd_bf16_geometry(t_len, h, bsz)
    bt, s_len, units = geo["bt"], geo["steps"], geo["units"]
    assert not geo["stream"]
    assert geo["cols"] == s_len * bt and geo["cols"] in (16, 32, 64)
    assert units * bt <= sru_fused.FWD16_SCAN_MAX
    assert geo["threads"] == 32 * (sru_fused.FWD16_PROD + -(-units * bt // 32))
    assert geo["smem"] == sru_fused.k2_fwd_bf16_smem(
        h, geo["cols"], units, bt, geo["vec"]) <= kernel_lib.SMEM_PER_BLOCK
    seen = np.zeros((2, t_len, h, bsz), np.int32)
    tiles, _, slices = geo["grid"]
    for dirn in (0, 1):
        for z in range(slices):
            for tile in range(tiles):
                for n in range(geo["chunks"]):
                    p = np.arange(units * bt)  # the scan threads
                    jl, cc = p // bt, p % bt
                    j, b = z * units + jl, tile * bt + cc
                    live = (jl < min(units, h - z * units)) & (b < bsz)
                    for s in range(s_len):
                        i = n * s_len + s
                        if i >= t_len:
                            break
                        t = i if dirn == 0 else t_len - 1 - i
                        np.add.at(seen[dirn, t], (j[live], b[live]), 1)
    assert (seen == 1).all()
    if (t_len, bsz) in SITES and h == 32:
        # the card filled in one wave: every block resident at once
        assert geo["blocks"] == tiles * 2 * slices >= kernel_lib.SMS
        assert geo["blocks"] <= kernel_lib.SMS * geo["per_sm"]
        assert geo["per_sm"] * (geo["smem"] + 1024) <= \
            kernel_lib.SMEM_PER_SM


def test_k2_fwd16_stages_odd_rows_and_unaligned_words():
    """The staging itself, against X's values read directly: B odd (rows
    starting at either half of a word) with bt 8 and bt 1, the last
    tile's columns and the last steps past T zero, the array's last
    word half outside it."""
    rng = np.random.default_rng(9)
    for t_len, h, bsz, bt in ((5, 8, 13, 8), (3, 8, 7, 1), (4, 8, 20, 4)):
        _, tx_f = _bf(rng, (t_len, h, bsz))
        _, tx_r = _bf(rng, (t_len, h, bsz))
        geo = sru_fused.k2_fwd_bf16_geometry(t_len, h, bsz, bt=bt)
        xf, xr = _bits(tx_f), _bits(tx_r)
        x = torch.cat([tx_f, tx_r], 1).float()
        for dirn in (0, 1):
            for tile in range(geo["grid"][0]):
                for n in range(geo["chunks"]):
                    got = _values(k2_stage(xf, xr, tx_f.shape, geo, dirn,
                                           tile, n))[:2 * h, :geo["cols"]]
                    want = torch.zeros_like(got)
                    for s in range(geo["steps"]):
                        i = n * geo["steps"] + s
                        if i >= t_len:
                            continue
                        t = i if dirn == 0 else t_len - 1 - i
                        b0 = tile * bt
                        nb = min(bt, bsz - b0)
                        want[:, s * bt:s * bt + nb] = x[t, :, b0:b0 + nb]
                    assert torch.equal(got, want)


# ---------------------------------------------------------------- K3


def _blocks16(bits, first, n_blocks):
    """The 16-byte copies of the aligned blocks from the one holding
    element ``first`` on (n_blocks of 8 values each), reading only the
    values inside the array, the rest zero, as the kernel's ``cp.async``
    of 16 bytes with its read size."""
    v = (first & ~7)[..., None] + np.arange(8 * n_blocks)
    return np.where(v < bits.size, bits[np.minimum(v, bits.size - 1)], 0)


def k3_stage_row(x_bits, shape, r, ci0, cp, ci_n, b0, nc, vec):
    """x row r's slot ([i][column] bit patterns, columns b0 .. b0 + nc - 1
    of input channels ci0 .. ci0 + ci_n - 1, zero outside [0, L), past
    the slice and past B) as the kernel stages it: vec-value copies, or
    where vec is 1 each channel row's nc // 8 + 1 aligned 16-byte blocks
    from the one holding its first value, realigned in place 8 values at
    a time."""
    length, c_in, bsz = shape
    i, c = np.meshgrid(np.arange(cp), np.arange(nc), indexing="ij")
    on = (0 <= r < length) & (i < ci_n)
    first = (r * c_in + ci0 + i[:, 0]) * bsz + b0
    if vec > 1:
        assert (first[on[:, 0]] % vec == 0).all() and nc % vec == 0
        val = x_bits[np.clip(first[:, None] + c, 0, x_bits.size - 1)]
    else:
        fs = np.clip(first, 0, None)
        raw = _blocks16(x_bits, fs, nc // 8 + 1)
        assert raw.shape[1] == nc + 8  # the slot's row
        val = np.take_along_axis(raw, (fs & 7)[:, None] + c, axis=1)
    return np.where(on & (b0 + c < bsz), val, 0)


def k3_fwd16_emulated(x, w, geo):
    """K3's bf16 forward as ``convt1d_tm_fwd_bf16_kernel`` computes it:
    each grid row (slice of input channels, block of output channels)
    and block walks its run of items, a segment of passes of one tile at
    a time, through a ring of staged rows (each read checked to be in its
    slot); out[t] of a pass summed over k16 steps of the channels (outer)
    and taps (inner) in float32; one slice rounds once, several write
    float32 partials summed in order, then rounded. Also returns how often
    each output was written."""
    length, c_in, bsz = x.shape
    k, c_out, _ = w.shape
    nc, mb, ci_slice = geo["nc"], geo["mb"], geo["ci_slice"]
    p_len, n_in = convt_tm.FWD16_PASS, geo["in_slices"]
    t_out, passes, blocks = length + k - 1, geo["passes"], geo["blocks"]
    slots = k - 1 + convt_tm.FWD16_STAGES * p_len
    tiles = -(-bsz // nc)
    assert geo["items"] == tiles * passes
    x_bits = _bits(x)
    wf = w.float()
    parts = torch.full((n_in, t_out, c_out, bsz), float("nan"))
    seen = np.zeros((n_in, t_out, c_out, bsz), np.int32)
    for z in range(geo["grid"][2]):
        zi, zo = z % n_in, z // n_in
        ci0, co0 = zi * ci_slice, zo * mb
        ci_n, co_n = min(ci_slice, c_in - ci0), min(mb, c_out - co0)
        cp = -(-ci_n // 16) * 16
        wflat = torch.zeros(mb, k, cp)
        wflat[:co_n, :, :ci_n] = wf[:, co0:co0 + co_n,
                                    ci0:ci0 + ci_n].permute(1, 0, 2)
        for bx in range(blocks):
            it, it1 = bx * geo["items"] // blocks, (bx + 1) * geo["items"] // blocks
            while it < it1:
                tile, p0 = divmod(it, passes)
                p1 = min(passes, p0 + it1 - it)
                it += p1 - p0
                b0 = tile * nc
                ring = {}  # slot -> row

                def stage(r0, r1):
                    for r in range(r0, r1):
                        ring[r % slots] = (r, _values(k3_stage_row(
                            x_bits, x.shape, r, ci0, cp, ci_n, b0, nc,
                            geo["vec_x"])))

                depth = convt_tm.FWD16_STAGES
                stage(p0 * p_len - k + 1, p0 * p_len + p_len)
                for d in range(1, depth - 1):
                    if p0 + d < p1:
                        stage((p0 + d) * p_len, (p0 + d + 1) * p_len)
                for ps in range(p0, p1):
                    t = ps * p_len
                    # pass ps + depth - 1's rows are issued before pass ps
                    # reads: they may land first
                    ahead = ps + depth - 1
                    if ahead < p1:
                        stage(ahead * p_len, ahead * p_len + p_len)
                    acc = [torch.zeros(mb, nc) for _ in range(p_len)]
                    for i0 in range(0, cp, 16):
                        for j in range(k):
                            for p in range(p_len):
                                r = t + p - j
                                row, xv = ring[r % slots]
                                assert row == r, (row, r)
                                acc[p] = acc[p] + wflat[:, j, i0:i0 + 16] \
                                    @ xv[i0:i0 + 16]
                    nb = min(nc, bsz - b0)
                    for p in range(p_len):
                        if t + p >= t_out:
                            break
                        parts[zi, t + p, co0:co0 + co_n, b0:b0 + nb] = \
                            acc[p][:co_n, :nb]
                        seen[zi, t + p, co0:co0 + co_n, b0:b0 + nb] += 1
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(torch.bfloat16), seen


# (L, C_in, C_out, B, k, (nc, mb) forced or None): B odd (words), a
# multiple of 8 and of 4, several items a block over two tiles, C_out
# over blocks of 16 and 32, C_in 96 over two slices (partials)
K3_CASES = [(9, 32, 24, 11, 3, None), (9, 32, 24, 16, 8, (32, 16)),
            (12, 16, 64, 12, 8, (16, 64)), (20, 16, 40, 21, 5, (16, 32)),
            (7, 96, 16, 6, 8, None)]


@pytest.mark.parametrize("length,c_in,c_out,bsz,k,tile", K3_CASES)
def test_k3_fwd16_order_of_sums_matches_plain_and_jax(length, c_in, c_out,
                                                      bsz, k, tile):
    """The kernel's runs, ring, k16 and tap sums and slices against the
    plain bf16 forward and the Pallas op in interpret mode; every output
    written once a slice; every row read found in its slot."""
    rng = np.random.default_rng(length + c_in + bsz)
    x, tx = _bf(rng, (length, c_in, bsz))
    w, tw = _bf(rng, (k, c_out, c_in), (c_in * k) ** -0.5)
    geo = convt_tm.fwd_bf16_geometry(length, c_in, c_out, k, bsz,
                                     *(tile or (0, 0)))
    if c_in == 96:
        assert geo["in_slices"] == 2
    got, seen = k3_fwd16_emulated(tx, tw, geo)
    assert (seen == 1).all()
    _ulp_gate(got.float(), convt_tm.convt1d_ola_tm_plain(tx, tw).float(),
              "K3 vs plain")
    ref = jconvt.convt1d_ola_tm(jnp.asarray(x), jnp.asarray(w), True)
    _ulp_gate(got.float(), ref, "K3 vs JAX")


@pytest.mark.parametrize("length,bsz", SITES)
def test_k3_fwd16_geometry_covers_fits_and_fills(length, bsz):
    """At the six main-path sites (2H 64 -> 64 channels, 8 taps) the
    blocks' runs cover every item once, a run's ring holds every row a
    pass reads when it reads it, the shared memory fits, and the grid
    fills the card's SMs."""
    k, c = 8, 64
    geo = convt_tm.fwd_bf16_geometry(length, c, c, k, bsz)
    assert geo["smem"] == convt_tm.fwd_bf16_smem(
        k, c, geo["mb"], geo["nc"]) <= kernel_lib.SMEM_PER_BLOCK
    assert geo["blocks"] * geo["grid"][2] >= kernel_lib.SMS
    solo = 2 * (geo["smem"] + 1024) > kernel_lib.SMEM_PER_SM
    assert geo["threads"] == 32 * max(
        convt_tm.FWD16_SOLO_WARPS if solo else convt_tm.FWD16_MIN_WARPS,
        geo["mb"] // 16 * geo["nc"] // 16)
    assert geo["per_sm"] == (1 if solo else 2)
    p_len, depth = convt_tm.FWD16_PASS, convt_tm.FWD16_STAGES
    slots = k - 1 + depth * p_len
    seen = np.zeros(geo["items"], np.int32)
    for bx in range(geo["blocks"]):
        it0 = bx * geo["items"] // geo["blocks"]
        it1 = (bx + 1) * geo["items"] // geo["blocks"]
        seen[it0:it1] += 1
        it = it0
        while it < it1:
            _, p0 = divmod(it, geo["passes"])
            p1 = min(geo["passes"], p0 + it1 - it)
            it += p1 - p0
            last = min(p1, p0 + depth - 1) * p_len
            ring = {r % slots: r for r in range(p0 * p_len - k + 1, last)}
            for ps in range(p0, p1):
                t = ps * p_len
                ahead = ps + depth - 1
                if ahead < p1:  # issued before this pass reads
                    ring.update({r % slots: r for r in range(
                        ahead * p_len, ahead * p_len + p_len)})
                for r in range(t - k + 1, t + p_len):
                    assert ring[r % slots] == r
    assert (seen == 1).all()


def test_k3_fwd16_realigns_words_in_place():
    """The odd-B staging's in-place realignment, 8 values at a time in
    order (each reads the five words from the one holding value c8 + sh
    before writing four): the same as reading the row at its offset, at
    every offset 0-7 in its 16-byte block, with the tile's last columns
    past B zero."""
    rng = np.random.default_rng(11)
    for nc in (16, 32):
        for sh in range(8):
            # the slot's row: nc / 8 + 1 blocks, nc + 8 values
            words = rng.integers(0, 2 ** 32, nc // 2 + 4, dtype=np.uint64)
            row = list(int(v) for v in words)
            vals = [(v >> (16 * h)) & 0xffff for v in row for h in (0, 1)]
            valid = nc - 3  # columns inside B
            for c8 in range(0, nc, 8):
                v = row[(c8 + sh) // 2:(c8 + sh) // 2 + 5]
                out = []
                for m in range(4):
                    pair = (((v[m + 1] << 32) | v[m]) >> 16) & 0xffffffff \
                        if sh & 1 else v[m]
                    c = c8 + 2 * m
                    if c >= valid:
                        pair = 0
                    elif c + 1 >= valid:
                        pair &= 0xffff
                    out.append(pair)
                row[c8 // 2:c8 // 2 + 4] = out
            got = [(v >> (16 * h)) & 0xffff for v in row[:nc // 2]
                   for h in (0, 1)]
            want = [vals[c + sh] if c < valid else 0 for c in range(nc)]
            assert got == want


# ---------------------------------------------------------------- sources


def _source(name):
    with open(os.path.join(kernel_lib.CSRC_DIR, name)) as f:
        return f.read()


def _entry_params(src, fn):
    """(pointers, ints) of the C entry ``fn``, its stream left out."""
    body = src.split(f'extern "C" int {fn}(')[1].split(")")[0]
    params = [p.strip() for p in body.split(",")][:-1]
    return (sum(p.startswith(("const void*", "void*")) for p in params),
            sum(p.startswith("int ") for p in params))


def test_fwd16_constants_and_entries_match_the_sources():
    fused = _source("sru_fused.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", fused))
    for name, value in (("kFwd16Prod", sru_fused.FWD16_PROD),
                        ("kFwd16ScanMax", sru_fused.FWD16_SCAN_MAX),
                        ("kFwd16Ahead", sru_fused.FWD16_AHEAD)):
        assert int(consts[name]) == value, name
    assert "constexpr int kFwd16XSlots = kFwd16Ahead + 2;" in fused
    assert "constexpr int kFwd16RawSlots = kFwd16Ahead + 1;" in fused
    # a block's threads fit the launch bounds, two blocks an SM
    assert ("__launch_bounds__(kFwd16Prod * 32 + kFwd16ScanMax, 2)"
            in fused)
    convt = _source("convt_tm.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", convt))
    for name, value in (("kFwd16Pass", convt_tm.FWD16_PASS),
                        ("kFwd16Stages", convt_tm.FWD16_STAGES),
                        ("kFwd16Cols", convt_tm.FWD16_COLS),
                        ("kFwd16Stage", convt_tm.FWD16_STAGE),
                        ("kFwd16MinWarps", convt_tm.FWD16_MIN_WARPS),
                        ("kFwd16SoloWarps", convt_tm.FWD16_SOLO_WARPS),
                        ("kThreads", 256)):
        assert int(consts[name]) == value, name
    assert max(nc * mb for nc, mb in convt_tm.FWD16_TILES) // 8 == 256
    assert max(nc for nc, _ in convt_tm.FWD16_TILES) == convt_tm.FWD16_COLS
    for lib, src, fn in (("convt_tm", convt, "convt1d_ola_tm_fwd_bf16"),
                         ("sru_fused", fused, "sru_hidden_layer_fwd_bf16")):
        assert kernel_lib._SIGNATURES[lib][fn] == _entry_params(src, fn)
    # the launches a profile tells apart
    assert "sru_hid_fwd_bf16_kernel<<<" in fused
    assert "sru_hid_fwd_bf16_stream_kernel<<<" in fused
    assert "convt1d_tm_fwd_bf16_kernel<8><<<" in convt
