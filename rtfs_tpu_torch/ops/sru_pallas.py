"""Gen-1 SRU recurrence (kernel K4) and the layer functions that reach it.

Counterpart of ``rtfs_tpu/ops/sru_pallas.py``, forward and backward:

- ``sru_recurrence`` (K4): one direction of one SRU layer over a
  precomputed projection u (T, 3H, B) = [x~, f, r] and highway xhw
  (T, H, B); CUDA kernels ``csrc/sru_pallas.cu:sru_recurrence_fwd`` (its
  loads kept FWD_AHEAD steps ahead of the chain through a cp.async ring,
  blocks from ``k4_fwd_geometry``; in bf16 ``sru_rec_fwd16_kernel``, a
  warp's copies a group of REC16_GROUP steps at a time) and
  ``..._bwd`` (the adjoint scan of
  ``csrc/sru_scan.cuh``, shared with the fused stack's backwards, blocks
  from ``sru_fused.scan_bwd_geometry``).
  ``reverse=True`` walks t = T-1 .. 0 (the kernel's flag), where the JAX
  layers flip u, xhw and h in memory around the call.
- ``sru_layer_tpu`` / ``sru_layer_tpu_windowed``: one SRU layer, the
  projection (``matmul``, or for layer 0 over the raw sequence a windowed
  ``conv1d``, ``sru_fused.layer0_projection``) outside the kernel as JAX
  leaves it to XLA, then K4 per direction.

Every SRU that the fused stack (``ops.sru_fused``) does not take runs here:
unidirectional, or bidirectional with input width 2H on layer 0.

Layout: the layer functions are time-major, (L, D, B) in and (L, dirs*H, B)
out, where JAX's take and return (B, L, D) and transpose around every
call; ``ops.sru.SRU`` transposes once into the stack and once out of it.
The windowed one takes the raw sequence batch-major (B, T, C), as
``layer0_projection`` does.

When autograd records (grad enabled and an input requires grad) K4 runs
through a ``torch.autograd.Function`` whose forward also keeps the cell
states c and whose backward is the BPTT kernel; otherwise (serving) the
forward writes no c. On a CPU tensor the plain versions below run, forward
and backward, through the same Function; on a CUDA tensor the kernels
launch or the call raises.

K4 also takes bf16 storage, forward and backward (a bf16 model's U takes
the compute dtype, and the Pallas kernels run in it): u, xhw, vb, h, c and
the gradients bf16, the arithmetic and the carries float32, only the
stored values rounded (CUDA entries ``sru_recurrence_{fwd,bwd}_bf16``;
the forward asks for 16-byte aligned u and xhw, and the wrapper copies an
unaligned view).
d(v, b) is rounded as JAX's backward rounds it: one bf16 partial a batch
column, those added in float32 and the sum rounded once. u, xhw and vb are
of one dtype (a mixed call raises on the card).
"""

from __future__ import annotations

import functools

import torch

from . import kernel_lib
from .sru_fused import (_BF16, _grad, _records, _spread_blocks,
                        arithmetic_dtype, layer0_projection,
                        scan_bwd_geometry, scan_direction, scan_direction_bwd)

# ``kRecFwdThreads`` and ``kRecFwdAhead`` in csrc/sru_pallas.cu: the K4
# forward's blocks are at most FWD_THREADS threads, and each thread keeps
# the loads of its next FWD_AHEAD steps in flight in its own ring
FWD_THREADS = 128
FWD_AHEAD = 8
# the bf16 forward's (``kRec16*``): a warp's ring of REC16_AHEAD + 1 group
# slots, each REC16_GROUP steps of 4 rows of REC16_SPAN values (the five
# 16-byte blocks that cover a row's 32)
REC16_GROUP = 8
REC16_AHEAD = 3
REC16_SPAN = 40


def sru_recurrence_plain(u, xhw, vb, reverse=False, with_c=False):
    """K4's plain version: h (T, H, B), and with ``with_c`` (h, c). In bf16
    storage the scan runs in float32 on the widened inputs, its carry never
    rounded, and only h and c are rounded (``_fwd_kernel``)."""
    dt = u.dtype
    ad = arithmetic_dtype(dt)
    out = scan_direction(u.to(ad), xhw.to(ad), vb.to(ad), reverse, with_c)
    if dt == ad:
        return out
    return tuple(o.to(dt) for o in out) if with_c else out.to(dt)


def sru_recurrence_bwd_plain(u, xhw, vb, c, dh, reverse=False):
    """K4 backward's plain version: du (T, 3H, B), dxhw (T, H, B) and
    d(v_f, v_r, b_f, b_r) (4, H). In bf16 storage the scan runs in float32
    on the widened values and du, dxhw are rounded once; d(v, b) is each
    batch column's float32 sum rounded to bf16, those added in float32 and
    rounded once (``_bwd_kernel`` writes a bf16 partial a column, which
    ``jnp.sum`` widens, adds and rounds)."""
    dt = u.dtype
    ad = arithmetic_dtype(dt)
    if dt == ad:
        return scan_direction_bwd(u, xhw, vb, c, dh, reverse)
    du, dxhw, cols = scan_direction_bwd(
        *(t.to(ad) for t in (u, xhw, vb, c, dh)), reverse, columns=True)
    return du.to(dt), dxhw.to(dt), cols.to(dt).to(ad).sum(-1).to(dt)


@functools.lru_cache(maxsize=None)
def k4_fwd_geometry(t_len: int, hdim: int, bsz: int, elem: int = 4) -> dict:
    """K4 forward's launch geometry, as ``sru_recurrence_fwd`` launches
    it: K1 forward's (``sru_fused.k1_fwd_geometry``) over one direction,
    blocks of ``cols`` columns x ``units`` units from
    ``sru_fused._spread_blocks`` (at most FWD_THREADS threads; 4,000
    threads at the bs-1 freq site spread over many SMs); each thread walks
    its T steps with the copies of the next FWD_AHEAD steps (u's three gate
    rows and the highway) in flight in its own ring of shared memory
    (``smem`` bytes a block).

    ``elem`` 2 (bf16, ``sru_rec_fwd16_kernel``): the same blocks; each
    warp (one unit, 32 columns) has a ring of REC16_AHEAD + 1 group slots,
    each REC16_GROUP steps of 4 rows of REC16_SPAN values, a group's 32
    (step, row) copies one a lane (five 16-byte cp.async)."""
    if min(t_len, hdim, bsz) < 1 or elem not in (2, 4):
        raise ValueError(f"sru_recurrence: T {t_len}, H {hdim}, B {bsz}, "
                         f"element size {elem}")
    cols, units, grid = _spread_blocks(hdim, bsz, 1, FWD_THREADS)
    warp = (REC16_AHEAD + 1) * REC16_GROUP * 4 * REC16_SPAN * 2
    return {"cols": cols, "units": units, "grid": grid[:2],
            "ahead": FWD_AHEAD if elem == 4 else REC16_AHEAD,
            "smem": (4 * FWD_AHEAD * 4 * cols * units if elem == 4
                     else cols * units // 32 * warp)}


def _k4_forward(u, xhw, vb, reverse, with_c):
    if u.device.type == "cpu":
        return sru_recurrence_plain(u, xhw, vb, reverse, with_c)
    dt = kernel_lib.check_cuda("sru_recurrence", u, xhw, vb, dtypes=_BF16)
    t_len, gh, bsz = u.shape
    if min(u.shape) == 0:
        raise ValueError("sru_recurrence: empty input")
    if dt == torch.bfloat16:
        u, xhw = kernel_lib.aligned16(u), kernel_lib.aligned16(xhw)
    geo = k4_fwd_geometry(t_len, gh // 3, bsz, dt.itemsize)
    h = torch.empty_like(xhw)
    c = torch.empty_like(xhw) if with_c else None
    kernel_lib.launch(
        "sru_pallas", kernel_lib.entry("sru_recurrence_fwd", dt), u.device,
        u.data_ptr(), xhw.data_ptr(), vb.data_ptr(), h.data_ptr(),
        c.data_ptr() if with_c else None, t_len, gh // 3, bsz, int(reverse),
        geo["cols"], geo["units"],
    )
    return (h, c) if with_c else h


def _k4_backward(u, xhw, vb, c, dh, reverse):
    if u.device.type == "cpu":
        return sru_recurrence_bwd_plain(u, xhw, vb, c, dh, reverse)
    dt = kernel_lib.check_cuda("sru_recurrence backward", u, xhw, vb, c, dh,
                               dtypes=_BF16)
    t_len, gh, bsz = u.shape
    geo = scan_bwd_geometry(t_len, gh // 3, bsz, 1)
    du, dxhw = torch.empty_like(u), torch.empty_like(xhw)
    dvb_part = torch.empty(geo["parts"], 4, gh // 3, device=u.device)
    kernel_lib.launch(
        "sru_pallas", kernel_lib.entry("sru_recurrence_bwd", dt), u.device,
        u.data_ptr(), xhw.data_ptr(), vb.data_ptr(), c.data_ptr(),
        dh.data_ptr(), du.data_ptr(), dxhw.data_ptr(), dvb_part.data_ptr(),
        t_len, gh // 3, bsz, int(reverse), geo["cols"], geo["units"],
    )
    return du, dxhw, dvb_part.sum(0).to(dt)


class _Recurrence(torch.autograd.Function):
    """K4 with its BPTT backward (``_sru_vjp_fwd`` / ``_sru_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, u, xhw, vb, reverse):
        h, c = _k4_forward(u, xhw, vb, reverse, with_c=True)
        ctx.save_for_backward(u, xhw, vb, c)
        ctx.reverse = reverse
        return h

    @staticmethod
    def backward(ctx, dh):
        u, xhw, vb, c = ctx.saved_tensors
        return (*_k4_backward(u, xhw, vb, c, _grad(dh, c), ctx.reverse),
                None)


def sru_recurrence(u: torch.Tensor, xhw: torch.Tensor, v: torch.Tensor,
                   b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """SRU recurrence, one direction.

    Args:
      u: (T, 3H, B) gate pre-activations [x~, f, r].
      xhw: (T, H, B) highway input.
      v, b: (2, H) recurrence vectors [v_f, v_r] and biases [b_f, b_r].
      reverse: walk t = T-1 .. 0.

    Returns:
      h (T, H, B); its gradients reach u, xhw, v and b.
    """
    t_len, gh, bsz = u.shape
    hdim = gh // 3
    if (gh != 3 * hdim or xhw.shape != (t_len, hdim, bsz)
            or v.shape != (2, hdim) or b.shape != (2, hdim)):
        raise ValueError(
            f"sru_recurrence: u {tuple(u.shape)}, xhw {tuple(xhw.shape)}, "
            f"v {tuple(v.shape)}, b {tuple(b.shape)}"
        )
    vb = torch.cat([v, b]).contiguous()  # (4, H) [v_f, v_r, b_f, b_r]
    if _records(u, xhw, vb):
        return _Recurrence.apply(u, xhw, vb, reverse)
    return _k4_forward(u, xhw, vb, reverse, with_c=False)


def _directions(u, x, weight_c, bias, hidden, dirs, k):
    """K4 per direction over the projection u (L, dirs*k*H, B), highway
    the projection's 4th chunk (k = 4) or the direction's slice of the
    layer input x (L, dirs*H, B) (k = 3); returns (L, dirs*H, B)."""
    outs = []
    for d in range(dirs):
        u_d = u[:, d * k * hidden:(d + 1) * k * hidden]
        x_hw = (u_d[:, 3 * hidden:] if k == 4
                else x[:, d * hidden:(d + 1) * hidden].to(u.dtype))
        outs.append(sru_recurrence(
            u_d[:, :3 * hidden].contiguous(), x_hw.contiguous(),
            weight_c[d], bias[d], reverse=d == 1))
    return torch.cat(outs, dim=1) if dirs > 1 else outs[0]


def sru_layer_tpu(x, weight, weight_c, bias, hidden: int,
                  bidirectional: bool) -> torch.Tensor:
    """One SRU layer through K4, time-major.

    x: (L, D_in, B); weight (D_in, dirs*k*H); weight_c, bias (dirs, 2, H).
    Returns (L, dirs*H, B).
    """
    dirs = 2 if bidirectional else 1
    k = 4 if x.shape[1] != dirs * hidden else 3
    # in the weight's dtype: a bf16 model's U is bf16, as JAX's
    u = torch.matmul(weight.t(), x.to(weight.dtype))  # (L, dirs*k*H, B)
    return _directions(u, x, weight_c, bias, hidden, dirs, k)


def sru_layer_tpu_windowed(x, weight, weight_c, bias, hidden: int,
                           bidirectional: bool, kernel: int,
                           stride: int = 1) -> torch.Tensor:
    """First SRU layer fused with the DualPathRNN window: the projection of
    the unfolded windows as a ``conv1d`` over the raw sequence.

    x: (B, T, C) raw sequence; weight (C*kernel, dirs*4*H).
    Returns (L', dirs*H, B) with L' = (T - kernel) // stride + 1.
    """
    dirs = 2 if bidirectional else 1
    if weight.shape[1] != dirs * 4 * hidden:
        raise ValueError("the windowed SRU layer needs a projected highway "
                         f"(k = 4): weight {tuple(weight.shape)}")
    u = layer0_projection(x, weight, (kernel, stride))
    return _directions(u, None, weight_c, bias, hidden, dirs, 4)
