"""Fused bidirectional SRU stack: kernels K1 and K2 and the stack driver.

Counterpart of ``rtfs_tpu/ops/sru_fused.py``, forward and backward:

- ``sru_dual_recurrence`` (K1): the layer-0 recurrence of both directions
  over a precomputed U = [x~, f, r, highway]; CUDA kernels
  ``csrc/sru_fused.cu:sru_dual_recurrence_fwd`` (its loads kept
  LAY0_AHEAD steps ahead of the chain through a cp.async ring, blocks
  from ``k1_fwd_geometry``) and ``..._bwd`` (the adjoint scan of
  ``csrc/sru_scan.cuh``, shared with K2's backward and K4's, blocks from
  ``scan_bwd_geometry``); in bf16 storage a kernel each way in which a
  warp copies its rows' 16-byte blocks a group of LAY16_GROUP steps at a
  time (``k1_bf16_group_copies``).
- ``sru_hidden_layer`` (K2): one hidden layer (k = 3, highway = input); the
  forward kernel projects U = W^T [h_f; h_r] a chunk of steps at a time on
  the tensor cores (3xTF32) into shared memory and scans the chunk from
  there (``k2_fwd_geometry``); the backward is split at the recurrence
  into U, the adjoint scan, dx and a split-K dW, launched by one C entry
  on scratch the wrapper allocates; CUDA kernels ``csrc/sru_fused.cu:
  sru_hidden_layer_fwd`` and ``..._bwd``. The bf16 backward is one fused
  kernel instead (``k2_bwd_bf16_geometry``): U, the scan, dx and dW a
  chunk of steps at a time in shared memory, on bf16 tensor cores; the
  bf16 forward's producer warps copy and project a chunk while its scan
  warps walk the one before (``k2_fwd_bf16_geometry``).
- ``sru_stack``: layer 0's projection as a windowed ``conv1d`` over the raw
  sequence, one entry transpose to time-major, K1, then K2 per hidden layer,
  with the (h_f, h_r) pair chained in (T, H, B).

Each op keeps the Pallas op's boundary layout, time-major with the folded
batch last. When autograd records (grad enabled and an input requires
grad) it runs through a ``torch.autograd.Function`` whose forward also
keeps the cell states c and whose backward is the BPTT kernel; otherwise
(serving) the forward skips c. The device picks the implementation: on a
CPU tensor the plain PyTorch versions below run (forward and backward), on
a CUDA tensor the kernels launch or the call raises.

Both ops also take bf16 storage, forward and backward (the Pallas
kernels run in the caller's dtype): u, x, W^T, vb, h, c and the gradients
in bf16, the arithmetic, U, du of K2 and the carries in float32, only the
stored values rounded, where the Pallas kernels and their VJPs round
(CUDA entries ``sru_dual_recurrence_{fwd,bwd}_bf16`` and
``sru_hidden_layer_{fwd,bwd}_bf16``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import kernel_lib

# ``kLay0Threads`` in csrc/sru_fused.cu: the K1 forward's blocks are at
# most this size (``k1_fwd_geometry``)
LAY0_THREADS = 128
# ``kLay0Ahead``: steps whose loads the K1 forward keeps in flight ahead
# of its recurrence, each thread in its own ring of shared memory
LAY0_AHEAD = 8
# the backward adjoint scan of K1, K2 and K4 (csrc/sru_scan.cuh):
# ``kScanThreads``, its blocks' size at most; ``kScanAhead``, the steps
# whose six loads each thread keeps in flight in its ring of shared
# memory; ``kScanGroup``, the steps it takes per wait
SCAN_THREADS = 128
SCAN_AHEAD = 8
SCAN_GROUP = 2
# K1's bf16 kernels (``sru_lay0_fwd16_kernel``, ``sru_lay0_bwd16_kernel``):
# ``kL16Group``, steps a group (one commit group, one wait);
# ``kL16FwdAhead`` / ``kL16BwdAhead``, groups in flight ahead of the one
# read, in a ring of that many + 1 group slots a warp; ``kL16Span``, a
# row's slot: the five 16-byte blocks (8 bf16 each) that cover 32 values
# at any offset
LAY16_GROUP = 8
LAY16_FWD_AHEAD = 3
LAY16_BWD_AHEAD = 2
LAY16_SPAN = 40


def vb_pack(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, 2, H) v and b -> (8, H) rows, per direction [v_f, v_r, b_f, b_r]
    (``_vb_pack`` without its lane replication)."""
    return torch.cat([v, b], dim=1).reshape(-1, v.shape[-1])


def _gates(u0, u1, u2, xhw, c, v_f, v_r, b_f, b_r):
    f = torch.sigmoid(u1 + v_f * c + b_f)
    c = f * c + (1.0 - f) * u0
    r = torch.sigmoid(u2 + v_r * c + b_r)  # reads the UPDATED cell
    return c, r * c + (1.0 - r) * xhw


def scan_direction(u, xhw, vb_d, reverse, with_c=False):
    """Plain recurrence of one direction.

    u: (T, >= 3H, B) with rows [x~, f, r, ...]; xhw: (T, H, B) highway.
    ``reverse`` walks t = T-1 .. 0. Returns h (T, H, B), and with
    ``with_c`` also the cell states c (T, H, B).
    """
    t_len, h = xhw.shape[0], xhw.shape[1]
    v_f, v_r, b_f, b_r = (vb_d[i][:, None] for i in range(4))
    c = torch.zeros_like(xhw[0])
    out = torch.empty_like(xhw)
    cs = torch.empty_like(xhw) if with_c else None
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        u_t = u[t]
        c, out[t] = _gates(u_t[:h], u_t[h:2 * h], u_t[2 * h:3 * h], xhw[t],
                           c, v_f, v_r, b_f, b_r)
        if with_c:
            cs[t] = c
    return (out, cs) if with_c else out


def scan_direction_bwd(u, xhw, vb_d, c, dh, reverse, columns=False):
    """Plain BPTT of one direction (the adjoints of ``_lay0_bwd_kernel`` /
    ``_hid_bwd_kernel``), walking time in reverse scan order.

    u: (T, >= 3H, B); xhw, c, dh: (T, H, B). Returns du (T, 3H, B) for the
    rows [x~, f, r], d(highway) (T, H, B) and d(v_f, v_r, b_f, b_r) (4, H),
    or with ``columns`` its sums of each batch column apart, (4, H, B).
    """
    t_len, h = xhw.shape[0], xhw.shape[1]
    v_f, v_r, b_f, b_r = (vb_d[i][:, None] for i in range(4))
    du = torch.empty(t_len, 3 * h, xhw.shape[2], dtype=xhw.dtype,
                     device=xhw.device)
    dhw = torch.empty_like(xhw)
    acc = torch.zeros(4, *xhw.shape[1:], dtype=xhw.dtype, device=xhw.device)
    dc = torch.zeros_like(xhw[0])
    for t in (range(t_len) if reverse else range(t_len - 1, -1, -1)):
        tp = t + 1 if reverse else t - 1
        c_prev = c[tp] if 0 <= tp < t_len else torch.zeros_like(dc)
        c_t, g, u_t = c[t], dh[t], u[t]
        f = torch.sigmoid(u_t[h:2 * h] + v_f * c_prev + b_f)
        r = torch.sigmoid(u_t[2 * h:3 * h] + v_r * c_t + b_r)
        dm = g * (c_t - xhw[t]) * r * (1.0 - r)
        dc = g * r + dm * v_r + dc
        da = dc * (c_prev - u_t[:h]) * f * (1.0 - f)
        du[t, :h] = dc * (1.0 - f)
        du[t, h:2 * h] = da
        du[t, 2 * h:] = dm
        dhw[t] = g * (1.0 - r)
        acc += torch.stack([da * c_prev, dm * c_t, da, dm])
        dc = dc * f + da * v_f
    return du, dhw, acc if columns else acc.sum(-1)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def arithmetic_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic dtype of a storage dtype: float32 for bf16, as the
    Pallas kernels keep their carries and products in float32."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _grad(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


# ---------------------------------------------------------------------------
# K1: layer-0 recurrence, both directions
# ---------------------------------------------------------------------------


def sru_dual_recurrence_plain(u_f, u_r, vb, with_c=False):
    """K1's plain version: (h_f, h_r), and with ``with_c`` (h_f, h_r, c_f,
    c_r). In bf16 storage the scan runs in float32 on the widened inputs
    and only its outputs are rounded."""
    dt, h = u_f.dtype, u_f.shape[1] // 4
    u_f, u_r, vb = (t.to(arithmetic_dtype(dt)) for t in (u_f, u_r, vb))
    out_f = scan_direction(u_f, u_f[:, 3 * h:], vb[0:4], False, with_c)
    out_r = scan_direction(u_r, u_r[:, 3 * h:], vb[4:8], True, with_c)
    if with_c:
        outs = (out_f[0], out_r[0], out_f[1], out_r[1])
    else:
        outs = (out_f, out_r)
    return tuple(o.to(dt) for o in outs)


def sru_dual_recurrence_bwd_plain(u_f, u_r, vb, c_f, c_r, dh_f, dh_r):
    """K1 backward's plain version: (du_f, du_r) (T, 4H, B) and dvb (8, H).
    In bf16 storage the scan runs in float32 on the widened values; du is
    rounded once and dvb summed in float32 and rounded once
    (``_lay0_bwd_kernel``, ``_lay0_vjp_bwd``)."""
    dt, h = u_f.dtype, u_f.shape[1] // 4
    u_f, u_r, vb, c_f, c_r, dh_f, dh_r = (
        t.to(arithmetic_dtype(dt))
        for t in (u_f, u_r, vb, c_f, c_r, dh_f, dh_r))
    du_f, dhw_f, dvb_f = scan_direction_bwd(u_f, u_f[:, 3 * h:], vb[0:4],
                                            c_f, dh_f, False)
    du_r, dhw_r, dvb_r = scan_direction_bwd(u_r, u_r[:, 3 * h:], vb[4:8],
                                            c_r, dh_r, True)
    return (torch.cat([du_f, dhw_f], dim=1).to(dt),
            torch.cat([du_r, dhw_r], dim=1).to(dt),
            torch.cat([dvb_f, dvb_r]).to(dt))


def _spread_blocks(hdim: int, bsz: int, dirs: int, most: int) -> tuple:
    """(cols, units, grid) of a scan with one thread per (column, unit,
    direction): blocks of ``cols`` batch columns x ``units`` units,
    ``cols`` a multiple of 32; the largest of ``most``, ``most // 2`` and
    32 threads whose grid (ceil(B / cols), ceil(H / units), dirs) has at
    least one block an SM, or 32 threads where none does, so that the few
    threads of a small batch spread over many SMs; ``cols`` =
    min(threads, round_up(B, 32)) leaves no block more than half idle
    where B >= 32."""
    for threads in (most, most // 2, 32):
        cols = min(threads, _round_up(bsz, 32))
        units = threads // cols
        grid = (-(-bsz // cols), -(-hdim // units), dirs)
        if grid[0] * grid[1] * grid[2] >= kernel_lib.SMS:
            break
    return cols, units, grid


@functools.lru_cache(maxsize=None)
def k1_fwd_geometry(t_len: int, hdim: int, bsz: int, elem: int = 4) -> dict:
    """K1 forward's launch geometry, as ``sru_dual_recurrence_fwd``
    launches it: blocks from ``_spread_blocks`` (both directions in the
    grid's z, at most LAY0_THREADS threads; 4,096 threads at the bs-1
    time site spread over many SMs). Each thread walks its T steps with
    the copies of the next LAY0_AHEAD steps in flight in its own ring of
    shared memory (``smem`` bytes a block).

    ``elem`` 2 (bf16, ``sru_dual_recurrence_fwd_bf16``): the same blocks;
    each warp (one unit, 32 columns) has a ring of LAY16_FWD_AHEAD + 1
    group slots, each LAY16_GROUP steps of 4 gate rows of LAY16_SPAN
    values, filled by the copies of ``k1_bf16_group_copies``."""
    if min(t_len, hdim, bsz) < 1 or elem not in (2, 4):
        raise ValueError(f"sru_dual_recurrence: T {t_len}, H {hdim}, "
                         f"B {bsz}, element size {elem}")
    cols, units, grid = _spread_blocks(hdim, bsz, 2, LAY0_THREADS)
    smem = (4 * LAY0_AHEAD * 4 * cols * units if elem == 4
            else k1_bf16_ring_bytes(cols * units // 32, 4, LAY16_FWD_AHEAD))
    return {"cols": cols, "units": units, "grid": grid,
            "ahead": LAY0_AHEAD if elem == 4 else LAY16_FWD_AHEAD,
            "smem": smem}


def k1_bf16_ring_bytes(warps: int, rows: int, ahead: int) -> int:
    """Shared memory of a K1 bf16 block: ``warps`` rings of ``ahead`` + 1
    group slots, each LAY16_GROUP steps of ``rows`` rows of LAY16_SPAN
    bf16 values."""
    return warps * (ahead + 1) * LAY16_GROUP * rows * LAY16_SPAN * 2


@functools.lru_cache(maxsize=None)
def k1_bwd_bf16_geometry(t_len: int, hdim: int, bsz: int) -> dict:
    """K1 backward's launch geometry in bf16 storage, as
    ``sru_dual_recurrence_bwd_bf16`` launches ``sru_lay0_bwd16_kernel``:
    the bf16 forward's blocks; each warp has a ring of LAY16_BWD_AHEAD + 1
    group slots of 6 rows a step (u0, u1, u2, the highway term, dh and
    c_prev). Each block writes the (v, b) sums of its ``cols`` columns for
    each of its units: ``parts`` = grid[0] float32 partials a unit and
    direction, which the caller adds in order."""
    if min(t_len, hdim, bsz) < 1:
        raise ValueError(f"sru_dual_recurrence backward: T {t_len}, H "
                         f"{hdim}, B {bsz}")
    cols, units, grid = _spread_blocks(hdim, bsz, 2, LAY0_THREADS)
    return {"cols": cols, "units": units, "grid": grid, "parts": grid[0],
            "ahead": LAY16_BWD_AHEAD,
            "smem": k1_bf16_ring_bytes(cols * units // 32, 6,
                                       LAY16_BWD_AHEAD)}


def k1_bf16_group_copies(rows: int) -> list:
    """Which copies each lane of a warp issues for a group of K1's bf16
    kernels (``l16_copy_group``), ``rows`` rows a step (4 forward, 6
    backward): [(lane, step in the group, row, block)]. A row's 32 values
    starting at element e0 are covered by the five 16-byte blocks from
    element e0 - e0 % 8 on (the slot row; lane l reads value e0 % 8 + l of
    it); a block past the array's end reads what is left of it, or is not
    copied. Lane l < 5 rows owns block l % 5 of row l // 5 and copies it
    for each of the group's LAY16_GROUP steps, into the group slot's row
    step x rows + row at value 8 block; the other lanes copy nothing."""
    return [(lane, s, lane // 5, lane % 5) for lane in range(5 * rows)
            for s in range(LAY16_GROUP)]


@functools.lru_cache(maxsize=None)
def scan_bwd_geometry(t_len: int, hdim: int, bsz: int, dirs: int) -> dict:
    """The backward adjoint scan's launch geometry (``launch_scan_bwd`` in
    csrc/sru_scan.cuh), for K1 and K2 (``dirs`` 2) and K4 (1): blocks
    from ``_spread_blocks`` of at most SCAN_THREADS threads (at the K4
    bs-4 time site, H 32 over B 256, 32-thread blocks: 256 blocks, not
    64); each thread keeps the copies of its next SCAN_AHEAD steps (six
    floats each) in flight in its own ring of shared memory (``smem``
    bytes a block). Each block writes the (v, b) partial sums of its
    ``cols`` columns for each of its units: ``parts`` = grid[0] partials
    a unit and direction, which the caller adds in order."""
    if min(t_len, hdim, bsz) < 1 or dirs not in (1, 2):
        raise ValueError(f"SRU backward scan: T {t_len}, H {hdim}, "
                         f"B {bsz}, directions {dirs}")
    cols, units, grid = _spread_blocks(hdim, bsz, dirs, SCAN_THREADS)
    return {"cols": cols, "units": units, "grid": grid, "parts": grid[0],
            "ahead": SCAN_AHEAD, "smem": 4 * SCAN_AHEAD * 6 * cols * units}


_BF16 = (torch.float32, torch.bfloat16)


def _k1_forward(u_f, u_r, vb, with_c):
    if u_f.device.type == "cpu":
        return sru_dual_recurrence_plain(u_f, u_r, vb, with_c)
    dt = kernel_lib.check_cuda("sru_dual_recurrence", u_f, u_r, vb,
                               dtypes=_BF16)
    t_len, gh, bsz = u_f.shape
    if min(u_f.shape) == 0:
        raise ValueError("sru_dual_recurrence: empty input")
    bf16 = dt == torch.bfloat16
    if bf16:
        u_f, u_r = kernel_lib.aligned16(u_f), kernel_lib.aligned16(u_r)
    geo = k1_fwd_geometry(t_len, gh // 4, bsz, u_f.element_size())
    outs = [torch.empty(t_len, gh // 4, bsz, device=u_f.device, dtype=dt)
            for _ in range(4 if with_c else 2)]
    c_ptrs = ((outs[2].data_ptr(), outs[3].data_ptr()) if with_c
              else (None, None))
    kernel_lib.launch(
        "sru_fused",
        "sru_dual_recurrence_fwd_bf16" if bf16 else "sru_dual_recurrence_fwd",
        u_f.device,
        u_f.data_ptr(), u_r.data_ptr(), vb.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), *c_ptrs, t_len, gh // 4, bsz, geo["cols"],
        geo["units"],
    )
    return tuple(outs)


def _k1_backward(u_f, u_r, vb, c_f, c_r, dh_f, dh_r):
    if u_f.device.type == "cpu":
        return sru_dual_recurrence_bwd_plain(u_f, u_r, vb, c_f, c_r, dh_f,
                                             dh_r)
    dt = kernel_lib.check_cuda("sru_dual_recurrence backward", u_f, u_r, vb,
                               c_f, c_r, dh_f, dh_r, dtypes=_BF16)
    t_len, gh, bsz = u_f.shape
    if dt == torch.bfloat16:
        u_f, u_r, c_f, c_r, dh_f, dh_r = (kernel_lib.aligned16(t) for t in (
            u_f, u_r, c_f, c_r, dh_f, dh_r))
        geo = k1_bwd_bf16_geometry(t_len, gh // 4, bsz)
    else:
        geo = scan_bwd_geometry(t_len, gh // 4, bsz, 2)
    du_f, du_r = torch.empty_like(u_f), torch.empty_like(u_r)
    dvb_part = torch.empty(geo["parts"], 8, gh // 4, device=u_f.device)
    kernel_lib.launch(
        "sru_fused",
        "sru_dual_recurrence_bwd_bf16" if dt == torch.bfloat16
        else "sru_dual_recurrence_bwd",
        u_f.device,
        u_f.data_ptr(), u_r.data_ptr(), vb.data_ptr(), c_f.data_ptr(),
        c_r.data_ptr(), dh_f.data_ptr(), dh_r.data_ptr(), du_f.data_ptr(),
        du_r.data_ptr(), dvb_part.data_ptr(), t_len, gh // 4, bsz,
        geo["cols"], geo["units"],
    )
    return du_f, du_r, dvb_part.sum(0).to(dt)


class _DualRecurrence(torch.autograd.Function):
    """K1 with its BPTT backward (``_lay0_vjp_fwd`` / ``_lay0_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, u_f, u_r, vb):
        h_f, h_r, c_f, c_r = _k1_forward(u_f, u_r, vb, with_c=True)
        ctx.save_for_backward(u_f, u_r, vb, c_f, c_r)
        return h_f, h_r

    @staticmethod
    def backward(ctx, dh_f, dh_r):
        u_f, u_r, vb, c_f, c_r = ctx.saved_tensors
        return _k1_backward(u_f, u_r, vb, c_f, c_r, _grad(dh_f, c_f),
                            _grad(dh_r, c_r))


def sru_dual_recurrence(u_f: torch.Tensor, u_r: torch.Tensor,
                        vb: torch.Tensor):
    """Both directions of one k = 4 SRU layer.

    Args:
      u_f, u_r: (T, 4H, B) per-direction [x~, f, r, highway]; u_r is NOT
        flipped (the reverse direction walks it back to front).
      vb: (8, H) from ``vb_pack``.

    Returns:
      (h_f, h_r), each (T, H, B).
    """
    t_len, gh, bsz = u_f.shape
    hdim = gh // 4
    if u_r.shape != u_f.shape or gh != 4 * hdim or vb.shape != (8, hdim):
        raise ValueError(
            f"sru_dual_recurrence: u_f {tuple(u_f.shape)}, u_r "
            f"{tuple(u_r.shape)}, vb {tuple(vb.shape)}"
        )
    if _records(u_f, u_r, vb):
        return _DualRecurrence.apply(u_f, u_r, vb)
    return _k1_forward(u_f, u_r, vb, with_c=False)


# ---------------------------------------------------------------------------
# K2: hidden layer, projection + recurrence, both directions
# ---------------------------------------------------------------------------


def sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c=False):
    """K2's plain version: (h_f, h_r), and with ``with_c`` (h_f, h_r, c_f,
    c_r). In bf16 storage U = W^T x is formed in float32 from the widened
    bf16 values (their products exact), the scan runs in float32 and only
    its outputs are rounded."""
    dt, h = x_f.dtype, x_f.shape[1]
    x_f, x_r, wt, vb = (t.to(arithmetic_dtype(dt)) for t in (x_f, x_r, wt, vb))
    x = torch.cat([x_f, x_r], dim=1)  # (T, 2H, B)
    u = torch.einsum("oi,tib->tob", wt, x)  # (T, 6H, B)
    out_f = scan_direction(u[:, :3 * h], x_f, vb[0:4], False, with_c)
    out_r = scan_direction(u[:, 3 * h:], x_r, vb[4:8], True, with_c)
    if with_c:
        outs = (out_f[0], out_r[0], out_f[1], out_r[1])
    else:
        outs = (out_f, out_r)
    return tuple(o.to(dt) for o in outs)


def hidden_bwd_terms(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    """K2 backward in the arithmetic dtype (float32 for bf16 storage), before
    any rounding: each direction's dx (W_d du_d plus its highway term on
    its own input's rows, (T, 2H, B) each), dwt (6H, 2H) and dvb (8, H).
    U is recomputed from x, as the kernel does; du is never rounded."""
    dt, h = x_f.dtype, x_f.shape[1]
    x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r = (
        t.to(arithmetic_dtype(dt))
        for t in (x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r))
    x = torch.cat([x_f, x_r], dim=1)
    u = torch.einsum("oi,tib->tob", wt, x)
    du_f, dhw_f, dvb_f = scan_direction_bwd(u[:, :3 * h], x_f, vb[0:4], c_f,
                                            dh_f, False)
    du_r, dhw_r, dvb_r = scan_direction_bwd(u[:, 3 * h:], x_r, vb[4:8], c_r,
                                            dh_r, True)
    dxa = torch.einsum("oi,tob->tib", wt[:3 * h], du_f)  # (T, 2H, B)
    dxb = torch.einsum("oi,tob->tib", wt[3 * h:], du_r)
    dxa[:, :h] += dhw_f
    dxb[:, h:] += dhw_r
    du = torch.cat([du_f, du_r], dim=1)  # (T, 6H, B)
    return dxa, dxb, torch.einsum("tob,tib->oi", du, x), torch.cat(
        [dvb_f, dvb_r])


def sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    """K2 backward's plain version: dx_f, dx_r (T, H, B), dwt (6H, 2H) and
    dvb (8, H) from ``hidden_bwd_terms``: each direction's dx rounded to
    the storage dtype, then the two added in it (``_hid_bwd_kernel``'s dxa
    and dxb, ``_hid_vjp_bwd``'s ``dxa + dxb``), dW and dvb rounded once."""
    dt, h = x_f.dtype, x_f.shape[1]
    dxa, dxb, dwt, dvb = hidden_bwd_terms(x_f, x_r, wt, vb, c_f, c_r, dh_f,
                                          dh_r)
    dx = dxa.to(dt) + dxb.to(dt)
    return dx[:, :h], dx[:, h:], dwt.to(dt), dvb.to(dt)


# K2 forward, ``kFwdThreads``, ``kFwdMT``, ``kFwdNB`` and ``kFwdAhead`` in
# csrc/sru_fused.cu: threads a block (one scan thread a unit and column);
# a warp's job in the product, m16 tiles of a chunk's columns by n8 tiles
# of U's rows; scan steps whose highway loads go together
FWD_THREADS = 256
FWD_MT = 2
FWD_NB = 3
FWD_AHEAD = 8
# the streamed K2 forward (H above 268), ``kFwdK`` and ``kFwdStages``: the
# projection's reduction FWD_K rows of X and columns of W_d a stage, in a
# ring of FWD_STAGES
FWD_K = 32
FWD_STAGES = 3


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def k2_fwd_smem(hdim: int, cols: int, units: int | None = None) -> int:
    """K2 forward's dynamic shared memory in bytes (``hid_fwd_smem_floats``
    in csrc/sru_fused.cu) at ``cols`` = S * bt columns a chunk and
    ``units`` units a block (all of H by default): the rows of W_d that
    project onto them, two X slots, two U slots, rows padded for
    conflict-free fragments."""
    units = hdim if units is None else units
    rows = _round_up(3 * units, 8 * FWD_NB)
    k8 = _round_up(2 * hdim, 8)
    return 4 * (rows * (k8 + 4) + 2 * k8 * (cols + 8)
                + 2 * rows * (cols + 4))


def k2_fwd_stream_smem(cols: int, units: int, elem: int = 4) -> int:
    """The streamed K2 forward's dynamic shared memory in bytes
    (``hid_fwd_stream_smem_floats``): one U slot and the ring of
    FWD_STAGES stages, each FWD_K rows of X's chunk and those columns of
    W_d's rows of the block's units. It does not depend on H. ``elem`` 2
    (bf16, ``hid_fwd_bf16_stream_smem_bytes``): X and W_d in bf16, W_d's
    rows of FWD_K + 8; U stays float32."""
    rows = _round_up(3 * units, 8 * FWD_NB)
    if elem == 2:
        return (4 * rows * (cols + 4)
                + 2 * FWD_STAGES * (FWD_K * (cols + 8) + rows * (FWD_K + 8)))
    return 4 * (rows * (cols + 4)
                + FWD_STAGES * (FWD_K * (cols + 8) + rows * (FWD_K + 4)))


def k2_bf16_vec(bt: int, bsz: int) -> int:
    """The values a copy of the bf16 K2 kernels' X chunk: the largest of 8,
    4, 2 dividing both ``bt`` and B (16-, 8-, 4-byte cp.async), else 1 (B
    odd or bt 1: cp.async has no 2-byte copy)."""
    return next((w for w in (8, 4, 2) if bt % w == 0 and bsz % w == 0), 1)


def _k2_fwd_blocks(hdim: int, bsz: int, smem) -> tuple:
    """(units, slices, bt, cols) of the float32 K2 forward's blocks (and of
    the streamed bf16 one) on the shared memory ``smem(cols, units)``: the
    fewest equal slices of H whose scan threads and 32-column chunks fit a
    block, the largest bt of 8, 4, 2, 1 (at most FWD_THREADS // units)
    whose grid fills the card's SMs, else 1, and chunks of 64 columns, or
    32 where 64 do not fit."""
    limit = kernel_lib.SMEM_PER_BLOCK
    for slices in range(1, hdim + 1):
        units = -(-hdim // slices)
        if units <= FWD_THREADS and smem(32, units) <= limit:
            break
    slices = -(-hdim // units)
    choices = [bt for bt in (8, 4, 2, 1) if bt <= FWD_THREADS // units]
    bt = next((bt for bt in choices
               if 2 * slices * -(-bsz // bt) >= kernel_lib.SMS), choices[-1])
    cols = next(c for c in (64, 32) if smem(c, units) <= limit)
    return units, slices, bt, cols


@functools.lru_cache(maxsize=None)
def k2_fwd_geometry(t_len: int, hdim: int, bsz: int) -> dict:
    """K2 forward's launch geometry, as ``sru_hidden_layer_fwd`` launches it.

    A block owns one direction, ``units`` units and ``bt`` batch columns
    and walks T in chunks of ``steps`` (S) steps, S * bt = ``cols``
    columns a chunk (a multiple of 16 * FWD_MT: the product's m16 tiles
    run over (step, column) pairs). ``units`` is all of H where one scan
    thread a unit fits the block and W_d with chunks of 32 columns fits its
    shared memory (H up to 68, every preset), else the fewest equal
    ``slices`` of H that do, each block keeping W_d's rows of its slice
    alone. ``bt`` is the largest of 8, 4, 2, 1 whose grid (ceil(B / bt)
    tiles x 2 directions x the slices) fills the card's SMs, or 1 where
    none does, and at most ``FWD_THREADS // units``; ``cols`` 64, or 32
    where 64 does not fit a block's shared memory.

    Where not even a slice of 8 units fits beside X's two slots (H above
    268), ``stream``: the kernel streams the projection's reduction
    (``kslices`` stages of FWD_K rows a chunk) and keeps one U slot, and
    ``units`` is the fewest equal slices whose U slot and ring fit
    (``k2_fwd_stream_smem``, which does not grow with H), the rest as
    above. The C entry streams exactly where the held geometry's shared
    memory exceeds a block's. ``vec``: the values a copy of X (4 or 1).
    The bf16 kernels' geometry is ``k2_fwd_bf16_geometry``."""
    if min(t_len, hdim, bsz) < 1:
        raise ValueError(f"sru_hidden_layer: T {t_len}, H {hdim}, B {bsz}")
    stream = k2_fwd_smem(hdim, 32, 8) > kernel_lib.SMEM_PER_BLOCK

    def smem(cols, units):
        return (k2_fwd_stream_smem(cols, units) if stream
                else k2_fwd_smem(hdim, cols, units))

    units, slices, bt, cols = _k2_fwd_blocks(hdim, bsz, smem)
    steps = cols // bt
    return {"bt": bt, "steps": steps, "cols": cols, "units": units,
            "slices": slices, "grid": (-(-bsz // bt), 2, slices),
            "chunks": -(-t_len // steps), "stream": stream,
            "kslices": -(-2 * hdim // FWD_K) if stream else 0,
            "smem": smem(cols, units),
            "vec": 4 if bt % 4 == 0 and bsz % 4 == 0 else 1}


# the bf16 K2 forward (``sru_hid_fwd_bf16_kernel``), ``kFwd16Prod``,
# ``kFwd16ScanMax`` and ``kFwd16Ahead`` in csrc/sru_fused.cu: its producer
# warps (copies and the product), the scan threads a block at most (one a
# unit and column), and the chunks its copies run ahead; X's ring holds
# FWD16_AHEAD + 2 chunks, the word copies' (B odd) FWD16_AHEAD + 1
FWD16_PROD = 6
FWD16_SCAN_MAX = 256
FWD16_AHEAD = 2


def k2_fwd_bf16_smem(hdim: int, cols: int, units: int, bt: int,
                     vec: int) -> int:
    """The bf16 K2 forward's dynamic shared memory in bytes
    (``HidFwd16Smem`` in csrc/sru_fused.cu) at ``cols`` = S * bt columns a
    chunk, ``units`` units a block and ``bt`` batch columns: W_d's rows of
    the units (R = 3 units rounded up to 16, of K + 8 bf16, K = 2H rounded
    up to 16), X's ring of FWD16_AHEAD + 2 chunks (K rows of cols + 8
    bf16), where ``vec`` is 1 the ring of FWD16_AHEAD + 1 word copies (K x
    S segments of bt // 2 + 1 words), and two float32 U slots (R rows of
    cols + max(bt, 2)); each region a multiple of 16 bytes."""
    rows, k = _round_up(3 * units, 16), _round_up(2 * hdim, 16)
    raw = (4 * (FWD16_AHEAD + 1) * k * (cols // bt) * (bt // 2 + 1)
           if vec == 1 else 0)
    return sum(_align16(n) for n in (
        2 * rows * (k + 8), 2 * (FWD16_AHEAD + 2) * k * (cols + 8), raw,
        4 * 2 * rows * (cols + max(bt, 2))))


@functools.lru_cache(maxsize=None)
def k2_fwd_bf16_geometry(t_len: int, hdim: int, bsz: int, bt: int = 0,
                         cols: int = 0) -> dict:
    """The bf16 K2 forward's launch geometry, as
    ``sru_hidden_layer_fwd_bf16`` launches it.

    Held (``sru_hid_fwd_bf16_kernel``): a block owns one direction,
    ``units`` units and ``bt`` batch columns, and walks T in chunks of
    ``steps`` (S) steps, ``cols`` = S * bt columns a chunk (64, else 32,
    else 16: whole m16 tiles of the product); its ``threads`` are
    FWD16_PROD producer warps and one scan thread a unit and column. What
    bounds the copies of X is their count of requests, not their bytes: a
    row of a step is bt contiguous values, so ``bt`` is 8 (a copy of 8 or
    16 bytes) where B is a multiple of 4, else 1 (a word a row and step,
    B odd). ``units`` is all of H where one block holds it (H * bt <=
    FWD16_SCAN_MAX and the shared memory of ``k2_fwd_bf16_smem`` at 16
    columns within a block's), else the fewest equal ``slices`` that fit,
    and more slices (each block copying all of X for fewer units) until
    the grid (ceil(B / bt) tiles x 2 directions x the slices) fills the
    card's SMs: bs 8 freq (B 1000) 32 units, 250 blocks; bs 8 time (B 512)
    16, 256; bs 4 16 / 11, 252 / 192; bs 1 freq (B 125) bt 1, 32 units,
    250 blocks; bs 1 time (B 64) 3, 176.
    ``cols`` is the widest chunk whose blocks all fit the card at once
    (``per_sm`` blocks an SM by shared memory and threads, at most the
    kernel's launch bounds' 2): 64 columns, 32 at bs 1. ``vec``: the
    values a copy of X (``k2_bf16_vec``; 1 where B is odd or
    bt is 1: the kernel copies words and realigns them). ``bt`` and
    ``cols`` force those choices (a variant).

    Where no held plan fits a block (H above 504 where B is a multiple of
    4, above 272 otherwise), ``stream``: the streamed kernel
    (``sru_hid_fwd_bf16_stream_kernel``) on the float32 kernel's streamed
    blocks (``_k2_fwd_blocks`` on ``k2_fwd_stream_smem(..., elem=2)``);
    ``stream`` is passed to the C entry, which launches by it."""
    if min(t_len, hdim, bsz) < 1:
        raise ValueError(f"sru_hidden_layer: T {t_len}, H {hdim}, B {bsz}")
    limit = kernel_lib.SMEM_PER_BLOCK

    def chunks(units, b):
        """The chunk widths whose scan threads and shared memory fit."""
        vec = k2_bf16_vec(b, bsz)
        return [c for c in ((cols,) if cols else (64, 32, 16))
                if c >= b and units * b <= FWD16_SCAN_MAX and
                k2_fwd_bf16_smem(hdim, c, units, b, vec) <= limit]

    def fill(b, slices):
        return -(-bsz // b) * 2 * slices >= kernel_lib.SMS

    held = [s for s in range(1, hdim + 1)
            if s == -(-hdim // -(-hdim // s))]  # slice counts, each distinct
    # the columns a block: 8 where a copy of X is then 8 or 16 bytes (B a
    # multiple of 4), else 1 (B odd or 2 mod 4: a word a row and step)
    bts = ((bt,) if bt else (8,) if bsz % 4 == 0 and bsz >= 8 else (1,))
    plan = next(((-(-hdim // s), s) for s in held
                 if any(chunks(-(-hdim // s), b) for b in bts)), None)
    if plan is None and not bt:
        bts = (1,)
        plan = next(((-(-hdim // s), s) for s in held
                     if chunks(-(-hdim // s), 1)), None)
    if plan is not None:
        units, slices = plan
        b = bts[0]
        if not fill(b, slices):
            # more slices until the grid fills the card
            units, slices = next(((-(-hdim // s), s) for s in held
                                  if s > slices and fill(b, s)
                                  and chunks(-(-hdim // s), b)),
                                 (units, slices))
        vec, blocks = k2_bf16_vec(b, bsz), -(-bsz // b) * 2 * slices
        threads = 32 * (FWD16_PROD + -(-units * b // 32))
        # the widest chunk whose blocks all fit the card at once (shared
        # memory, threads, registers at the kernel's launch bounds)
        per_sm = {c: min(kernel_lib.SMEM_PER_SM // (k2_fwd_bf16_smem(
            hdim, c, units, b, vec) + 1024), 2048 // threads, 2)
            for c in chunks(units, b)}
        c = next((c for c, n in per_sm.items()
                  if kernel_lib.SMS * n >= blocks), max(per_sm,
                                                        key=per_sm.get))
        return {"bt": b, "steps": c // b, "cols": c, "units": units,
                "slices": slices, "grid": (-(-bsz // b), 2, slices),
                "blocks": blocks, "chunks": -(-t_len // (c // b)),
                "threads": threads, "per_sm": per_sm[c],
                "stream": False, "kslices": 0, "vec": vec,
                "smem": k2_fwd_bf16_smem(hdim, c, units, b, vec)}

    def smem(c, u):
        return k2_fwd_stream_smem(c, u, 2)

    units, slices, b, c = _k2_fwd_blocks(hdim, bsz, smem)
    return {"bt": b, "steps": c // b, "cols": c, "units": units,
            "slices": slices, "grid": (-(-bsz // b), 2, slices),
            "blocks": -(-bsz // b) * 2 * slices,
            "chunks": -(-t_len // (c // b)), "threads": FWD_THREADS,
            "stream": True, "kslices": -(-2 * hdim // FWD_K),
            "vec": k2_bf16_vec(b, bsz), "smem": smem(c, units)}


# K2 backward's products, ``kTile``, ``kStage`` and ``kWgCols`` in
# csrc/sru_fused.cu: output tiles of 64 x 64, U and dx stages of 16
# reduction rows, dW stages of 32 (t, b) columns
GEMM_TILE = 64
GEMM_STAGE = 16
WGRAD_COLS = 32


def k2_bwd_geometry(t_len: int, hdim: int, bsz: int) -> dict:
    """K2 backward's launch geometry, as ``sru_hidden_layer_bwd`` launches
    it: the (column, row, step) tiles of the U and dx products, the dW
    split-K over the T*B columns (``cols`` a chunk, one partial each), the
    adjoint scan's geometry (``scan``, ``scan_bwd_geometry`` over both
    directions; ``scan_blocks`` (v, b) partials a unit and direction) and
    the products' static shared memory in bytes."""
    tiles = lambda n: -(-n // GEMM_TILE)  # noqa: E731
    wgrad_tiles = tiles(6 * hdim) * tiles(2 * hdim)
    cols, chunks = kernel_lib.split_k(t_len * bsz, wgrad_tiles, WGRAD_COLS)
    scan = scan_bwd_geometry(t_len, hdim, bsz, 2)
    return {
        "u_grid": (tiles(bsz), tiles(6 * hdim), t_len),
        "dx_grid": (tiles(bsz), tiles(2 * hdim), t_len),
        "wgrad_grid": (tiles(2 * hdim), tiles(6 * hdim), chunks),
        "cols": cols, "chunks": chunks,
        "scan": scan, "scan_blocks": scan["parts"],
        "gemm_smem": 4 * GEMM_STAGE * (2 * GEMM_TILE + 4),
        "wgrad_smem": 4 * 2 * WGRAD_COLS * (GEMM_TILE + 4),
    }


# K2's bf16 backward (``sru_hid_bwd_bf16_kernel``), ``kBwdThreads``: threads
# a block (one scan thread a unit and batch column of the block); streamed
# (above H 384), ``kBwdK`` and ``kBwdStages``: X's rows and W_d's columns
# a stage, stages in the ring
BWD_THREADS = 512
BWD_K = 32
BWD_STAGES = 3


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def k2_bwd_bf16_smem(hdim: int, cols: int, units: int, bt: int,
                     stream: bool = False) -> int:
    """The bf16 K2 backward's dynamic shared memory in bytes (``HidBwdSmem``
    in csrc/sru_fused.cu) at ``cols`` = S * bt columns a chunk, ``units``
    units a block and ``bt`` batch columns: W_d's rows of the units (R =
    3 units rounded up to 16, of K + 8 bf16, K = 2H rounded up to 16), two
    X slots (K rows of cols + 8 bf16), two slots of c (S + 1 steps) and dh,
    U (R rows of cols + 8 floats), du's three bf16 parts, the highway term
    (float32) and the dW sums (R rows of K + 8 floats); each region a
    multiple of 16 bytes. ``stream``: no W_d, X or dW sums held; two slots
    of the highway rows and the ring of BWD_STAGES stages (BWD_K rows of X
    of cols + 8 and R rows of W_d's BWD_K columns of BWD_K + 8, bf16): it
    does not grow with H."""
    rows, k = _round_up(3 * units, 16), _round_up(2 * hdim, 16)
    common = (2 * 2 * units * (cols + bt), 2 * 2 * units * cols,
              4 * rows * (cols + 8), 2 * 3 * rows * (cols + 8),
              4 * units * cols)
    if stream:
        extra = (2 * 2 * units * cols,
                 2 * BWD_STAGES * (BWD_K * (cols + 8) + rows * (BWD_K + 8)))
    else:
        extra = (2 * rows * (k + 8), 2 * 2 * k * (cols + 8),
                 4 * rows * (k + 8))
    return sum(_align16(n) for n in common + extra)


@functools.lru_cache(maxsize=None)
def k2_bwd_bf16_geometry(t_len: int, hdim: int, bsz: int) -> dict:
    """The bf16 K2 backward's launch geometry, as ``sru_hidden_layer_bwd_bf16``
    launches it (``sru_hid_bwd_bf16_kernel``).

    A block owns one direction, ``units`` units and ``bt`` batch columns
    and walks T in chunks of ``steps`` (S) steps in its reverse scan order,
    ``cols`` = S * bt columns a chunk (64, else 32, else 16: a multiple of
    the k16 step of the dW product). ``units`` is all of H where a block
    holds it (one scan thread a unit and column, the shared memory of
    ``k2_bwd_bf16_smem`` within a block's at 16 columns), else the fewest
    equal ``slices`` of H that fit; each slice then writes a float32
    partial of dx (``dxd`` float32 (slices, 2, T, 2H, B)), else bf16 (2, T,
    2H, B). Where not even 8 units fit (H above 384), ``stream``: the
    kernel streams X and W_d's columns through a ring and keeps its dW sums
    in its partial, and ``units`` is the fewest equal slices whose streamed
    shared memory (which does not grow with H) fits. ``bt`` (8, 4, 2 or 1,
    at most BWD_THREADS // units) minimizes waves x chunks, the waves of
    ceil(B / bt) x 2 x slices blocks at the blocks an SM that the shared
    memory allows (at most 2), the chunks ceil(T / S) a block walks in
    turn; a tie takes the larger bt (fewer blocks reload W_d): at the bs-4
    freq site (B 500) bt 8, 126 blocks, 8 chunks; at the time site (B 256)
    bt 4, 128 blocks, 8 chunks. ``tiles`` = ceil(B / bt) dW and (v, b)
    partials, summed in order. ``stream`` is passed to the C entry, which
    launches the streamed kernel by it and checks that the layout fits."""
    if min(t_len, hdim, bsz) < 1:
        raise ValueError(f"sru_hidden_layer backward: T {t_len}, H {hdim}, "
                         f"B {bsz}")
    limit = kernel_lib.SMEM_PER_BLOCK
    stream = k2_bwd_bf16_smem(hdim, 16, 8, 1) > limit

    def smem(cols, units, bt):
        return k2_bwd_bf16_smem(hdim, cols, units, bt, stream)

    for slices in range(1, hdim + 1):
        units = -(-hdim // slices)
        if units <= BWD_THREADS and smem(16, units, 1) <= limit:
            break
    slices = -(-hdim // units)
    best = None
    for bt in (8, 4, 2, 1):
        if bt * units > BWD_THREADS:
            continue
        cols = next((c for c in (64, 32, 16)
                     if smem(c, units, bt) <= limit), None)
        if cols is None:
            continue
        per_sm = max(1, min(2, kernel_lib.SMEM_PER_SM
                            // (smem(cols, units, bt) + 1024)))
        blocks = -(-bsz // bt) * 2 * slices
        waves = -(-blocks // (kernel_lib.SMS * per_sm))
        cost = waves * -(-t_len // (cols // bt))
        if best is None or cost < best[0]:
            best = (cost, bt, cols)
    _, bt, cols = best
    tiles = -(-bsz // bt)
    return {"bt": bt, "steps": cols // bt, "cols": cols, "units": units,
            "slices": slices, "grid": (tiles, 2, slices), "tiles": tiles,
            "chunks": -(-t_len // (cols // bt)), "stream": stream,
            "smem": smem(cols, units, bt), "vec": k2_bf16_vec(bt, bsz)}


def _k2_forward(x_f, x_r, wt, vb, with_c):
    if x_f.device.type == "cpu":
        return sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c)
    dt = kernel_lib.check_cuda("sru_hidden_layer", x_f, x_r, wt, vb,
                               dtypes=_BF16)
    t_len, hdim, bsz = x_f.shape
    if min(x_f.shape) == 0:
        raise ValueError("sru_hidden_layer: empty input")
    bf16 = dt == torch.bfloat16
    if bf16:
        x_f, x_r, wt = (kernel_lib.aligned16(t) for t in (x_f, x_r, wt))
        geo = k2_fwd_bf16_geometry(t_len, hdim, bsz)
        extra = (int(geo["stream"]),)
    else:
        geo, extra = k2_fwd_geometry(t_len, hdim, bsz), ()
    outs = [torch.empty_like(x_f) for _ in range(4 if with_c else 2)]
    c_ptrs = ((outs[2].data_ptr(), outs[3].data_ptr()) if with_c
              else (None, None))
    kernel_lib.launch(
        "sru_fused",
        "sru_hidden_layer_fwd_bf16" if bf16 else "sru_hidden_layer_fwd",
        x_f.device,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), *c_ptrs,
        t_len, hdim, bsz, geo["bt"], geo["steps"], geo["units"], *extra,
    )
    return tuple(outs)


def _k2_backward(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    if x_f.device.type == "cpu":
        return sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, c_f, c_r, dh_f,
                                          dh_r)
    dt = kernel_lib.check_cuda("sru_hidden_layer backward", x_f, x_r, wt,
                               vb, c_f, c_r, dh_f, dh_r, dtypes=_BF16)
    t_len, hdim, bsz = x_f.shape
    if min(x_f.shape) == 0:
        raise ValueError("sru_hidden_layer backward: empty input")
    if dt == torch.bfloat16:
        return _k2_backward_bf16(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r)
    geo = k2_bwd_geometry(t_len, hdim, bsz)
    dev = x_f.device
    dx_f, dx_r = torch.empty_like(x_f), torch.empty_like(x_r)
    dwt, dvb = torch.empty_like(wt), torch.empty_like(vb)
    ud = torch.empty(t_len, 6 * hdim, bsz, device=dev)  # U, then du
    dw_part = torch.empty(geo["chunks"], 6 * hdim, 2 * hdim, device=dev)
    dvb_part = torch.empty(geo["scan_blocks"], 8, hdim, device=dev)
    kernel_lib.launch(
        "sru_fused", "sru_hidden_layer_bwd", dev,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        c_f.data_ptr(), c_r.data_ptr(), dh_f.data_ptr(), dh_r.data_ptr(),
        dx_f.data_ptr(), dx_r.data_ptr(), dwt.data_ptr(), dvb.data_ptr(),
        ud.data_ptr(), dw_part.data_ptr(), dvb_part.data_ptr(),
        t_len, hdim, bsz, geo["cols"], geo["scan"]["cols"],
        geo["scan"]["units"],
    )
    return dx_f, dx_r, dwt, dvb


def _k2_backward_bf16(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    t_len, hdim, bsz = x_f.shape
    geo = k2_bwd_bf16_geometry(t_len, hdim, bsz)
    dev = x_f.device
    x_f, x_r, wt, c_f, c_r, dh_f, dh_r = (
        kernel_lib.aligned16(t) for t in (x_f, x_r, wt, c_f, c_r, dh_f, dh_r))
    dx_f, dx_r = torch.empty_like(x_f), torch.empty_like(x_r)
    dwt, dvb = torch.empty_like(wt), torch.empty_like(vb)
    # each direction's dx: rounded to bf16 at one slice, else float32
    # partials of the slices
    dxd = (torch.empty(2, t_len, 2 * hdim, bsz, device=dev, dtype=x_f.dtype)
           if geo["slices"] == 1 else
           torch.empty(geo["slices"], 2, t_len, 2 * hdim, bsz, device=dev))
    dw_part = torch.empty(geo["tiles"], 6 * hdim, 2 * hdim, device=dev)
    dvb_part = torch.empty(geo["tiles"], 8, hdim, device=dev)
    kernel_lib.launch(
        "sru_fused", "sru_hidden_layer_bwd_bf16", dev,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        c_f.data_ptr(), c_r.data_ptr(), dh_f.data_ptr(), dh_r.data_ptr(),
        dx_f.data_ptr(), dx_r.data_ptr(), dwt.data_ptr(), dvb.data_ptr(),
        dxd.data_ptr(), dw_part.data_ptr(), dvb_part.data_ptr(),
        t_len, hdim, bsz, geo["bt"], geo["steps"], geo["units"],
        int(geo["stream"]),
    )
    return dx_f, dx_r, dwt, dvb


class _HiddenLayer(torch.autograd.Function):
    """K2 with its BPTT backward (``_hid_vjp_fwd`` / ``_hid_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x_f, x_r, wt, vb):
        h_f, h_r, c_f, c_r = _k2_forward(x_f, x_r, wt, vb, with_c=True)
        ctx.save_for_backward(x_f, x_r, wt, vb, c_f, c_r)
        return h_f, h_r

    @staticmethod
    def backward(ctx, dh_f, dh_r):
        x_f, x_r, wt, vb, c_f, c_r = ctx.saved_tensors
        return _k2_backward(x_f, x_r, wt, vb, c_f, c_r, _grad(dh_f, c_f),
                            _grad(dh_r, c_r))


def sru_hidden_layer(x_f: torch.Tensor, x_r: torch.Tensor, wt: torch.Tensor,
                     vb: torch.Tensor):
    """One hidden SRU layer (projection + both directions).

    Args:
      x_f, x_r: (T, H, B) previous layer's per-direction outputs.
      wt: (6H, 2H) = W^T, per direction the rows [x~, f, r] x H.
      vb: (8, H) from ``vb_pack``.

    Returns:
      (h_f, h_r), each (T, H, B).
    """
    t_len, hdim, bsz = x_f.shape
    if (x_r.shape != x_f.shape or wt.shape != (6 * hdim, 2 * hdim)
            or vb.shape != (8, hdim)):
        raise ValueError(
            f"sru_hidden_layer: x {tuple(x_f.shape)}/{tuple(x_r.shape)}, wt "
            f"{tuple(wt.shape)}, vb {tuple(vb.shape)}"
        )
    if _records(x_f, x_r, wt, vb):
        return _HiddenLayer.apply(x_f, x_r, wt, vb)
    return _k2_forward(x_f, x_r, wt, vb, with_c=False)


# ---------------------------------------------------------------------------
# Stack driver
# ---------------------------------------------------------------------------


def layer0_projection(x, w0, window):
    """Layer-0 U in time-major (L', dirs*4H, B).

    x: (B, L, D) raw sequence; with ``window = (k, s)`` the projection of
    the unfolded windows runs as a ``conv1d`` (unfold feature c*k + j ->
    conv weight [out, c, j]), so the unfolded tensor is never built. x is
    cast to the weight's dtype first (bf16 serving: a bf16 conv, as JAX's).
    """
    x = x.to(w0.dtype)
    if window is None:
        return torch.einsum("bld,dk->lkb", x, w0)
    kernel, stride = window
    w_conv = w0.reshape(w0.shape[0] // kernel, kernel, -1).permute(2, 0, 1)
    u = F.conv1d(x.transpose(1, 2), w_conv, stride=stride)  # (B, 8H, L')
    return u.permute(2, 1, 0)


def sru_stack(x, weights, weight_cs, biases, hidden, window=None,
              time_major=False):
    """Bidirectional multi-layer SRU through K1 and K2.

    Args:
      x: (B, L, D) (the raw sequence when ``window`` is set).
      weights / weight_cs / biases: per layer, weight (D_in, 2*k*H),
        weight_c / bias (2, 2, H) (``ops.sru.SRU`` layout).
      hidden: H.

    Returns:
      (B, L', 2H), or time-major (L', 2H, B) with ``time_major`` (the layout
      the ConvTranspose kernel K3 reads).
    """
    u = layer0_projection(x, weights[0], window)
    if u.shape[1] != 8 * hidden:
        raise NotImplementedError(
            "sru_stack needs a projected highway on layer 0 (k = 4)"
        )
    h_f, h_r = sru_dual_recurrence(
        u[:, :4 * hidden].contiguous(), u[:, 4 * hidden:].contiguous(),
        vb_pack(weight_cs[0], biases[0]).contiguous(),
    )
    for layer in range(1, len(weights)):
        h_f, h_r = sru_hidden_layer(
            h_f, h_r, weights[layer].t().contiguous(),
            vb_pack(weight_cs[layer], biases[layer]).contiguous(),
        )
    h = torch.cat([h_f, h_r], dim=1)
    return h if time_major else h.permute(2, 0, 1)
