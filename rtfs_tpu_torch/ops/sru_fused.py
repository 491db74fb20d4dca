"""Fused bidirectional SRU stack: kernels K1 and K2 and the stack driver.

Counterpart of ``rtfs_tpu/ops/sru_fused.py``, forward and backward:

- ``sru_dual_recurrence`` (K1): the layer-0 recurrence of both directions
  over a precomputed U = [x~, f, r, highway]; CUDA kernels
  ``csrc/sru_fused.cu:sru_dual_recurrence_fwd`` and ``..._bwd``.
- ``sru_hidden_layer`` (K2): one hidden layer (k = 3, highway = input) with
  the projection U_t = W^T [h_f; h_r]_t inside the kernel (the backward
  recomputes it there); CUDA kernels ``csrc/sru_fused.cu:
  sru_hidden_layer_fwd`` and ``..._bwd``.
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_lib

# K1 block size, ``kLay0Threads`` in csrc/sru_fused.cu: the backward writes
# one dvb partial a block
LAY0_THREADS = 128


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


def scan_direction_bwd(u, xhw, vb_d, c, dh, reverse):
    """Plain BPTT of one direction (the adjoints of ``_lay0_bwd_kernel`` /
    ``_hid_bwd_kernel``), walking time in reverse scan order.

    u: (T, >= 3H, B); xhw, c, dh: (T, H, B). Returns du (T, 3H, B) for the
    rows [x~, f, r], d(highway) (T, H, B) and d(v_f, v_r, b_f, b_r) (4, H).
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
    return du, dhw, acc.sum(-1)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _grad(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


# ---------------------------------------------------------------------------
# K1: layer-0 recurrence, both directions
# ---------------------------------------------------------------------------


def sru_dual_recurrence_plain(u_f, u_r, vb, with_c=False):
    """K1's plain version: (h_f, h_r), and with ``with_c`` (h_f, h_r, c_f,
    c_r)."""
    h = u_f.shape[1] // 4
    out_f = scan_direction(u_f, u_f[:, 3 * h:], vb[0:4], False, with_c)
    out_r = scan_direction(u_r, u_r[:, 3 * h:], vb[4:8], True, with_c)
    if with_c:
        return out_f[0], out_r[0], out_f[1], out_r[1]
    return out_f, out_r


def sru_dual_recurrence_bwd_plain(u_f, u_r, vb, c_f, c_r, dh_f, dh_r):
    """K1 backward's plain version: (du_f, du_r) (T, 4H, B) and dvb (8, H)."""
    h = u_f.shape[1] // 4
    du_f, dhw_f, dvb_f = scan_direction_bwd(u_f, u_f[:, 3 * h:], vb[0:4],
                                            c_f, dh_f, False)
    du_r, dhw_r, dvb_r = scan_direction_bwd(u_r, u_r[:, 3 * h:], vb[4:8],
                                            c_r, dh_r, True)
    return (torch.cat([du_f, dhw_f], dim=1), torch.cat([du_r, dhw_r], dim=1),
            torch.cat([dvb_f, dvb_r]))


def _k1_forward(u_f, u_r, vb, with_c):
    if u_f.device.type == "cpu":
        return sru_dual_recurrence_plain(u_f, u_r, vb, with_c)
    kernel_lib.check_cuda_f32("sru_dual_recurrence", u_f, u_r, vb)
    t_len, gh, bsz = u_f.shape
    if min(u_f.shape) == 0:
        raise ValueError("sru_dual_recurrence: empty input")
    outs = [torch.empty(t_len, gh // 4, bsz, device=u_f.device)
            for _ in range(4 if with_c else 2)]
    c_ptrs = ((outs[2].data_ptr(), outs[3].data_ptr()) if with_c
              else (None, None))
    kernel_lib.launch(
        "sru_fused", "sru_dual_recurrence_fwd", u_f.device,
        u_f.data_ptr(), u_r.data_ptr(), vb.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), *c_ptrs, t_len, gh // 4, bsz,
    )
    return tuple(outs)


def _k1_backward(u_f, u_r, vb, c_f, c_r, dh_f, dh_r):
    if u_f.device.type == "cpu":
        return sru_dual_recurrence_bwd_plain(u_f, u_r, vb, c_f, c_r, dh_f,
                                             dh_r)
    kernel_lib.check_cuda_f32("sru_dual_recurrence backward", u_f, u_r, vb,
                              c_f, c_r, dh_f, dh_r)
    t_len, gh, bsz = u_f.shape
    n_blocks = -(-bsz // LAY0_THREADS)
    du_f, du_r = torch.empty_like(u_f), torch.empty_like(u_r)
    dvb_part = torch.empty(n_blocks, 8, gh // 4, device=u_f.device)
    kernel_lib.launch(
        "sru_fused", "sru_dual_recurrence_bwd", u_f.device,
        u_f.data_ptr(), u_r.data_ptr(), vb.data_ptr(), c_f.data_ptr(),
        c_r.data_ptr(), dh_f.data_ptr(), dh_r.data_ptr(), du_f.data_ptr(),
        du_r.data_ptr(), dvb_part.data_ptr(), t_len, gh // 4, bsz,
    )
    return du_f, du_r, dvb_part.sum(0)


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
    c_r)."""
    h = x_f.shape[1]
    x = torch.cat([x_f, x_r], dim=1)  # (T, 2H, B)
    u = torch.einsum("oi,tib->tob", wt, x)  # (T, 6H, B)
    out_f = scan_direction(u[:, :3 * h], x_f, vb[0:4], False, with_c)
    out_r = scan_direction(u[:, 3 * h:], x_r, vb[4:8], True, with_c)
    if with_c:
        return out_f[0], out_r[0], out_f[1], out_r[1]
    return out_f, out_r


def sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    """K2 backward's plain version: dx_f, dx_r (T, H, B), dwt (6H, 2H) and
    dvb (8, H). U is recomputed from x, as the kernel does."""
    h = x_f.shape[1]
    x = torch.cat([x_f, x_r], dim=1)
    u = torch.einsum("oi,tib->tob", wt, x)
    du_f, dhw_f, dvb_f = scan_direction_bwd(u[:, :3 * h], x_f, vb[0:4], c_f,
                                            dh_f, False)
    du_r, dhw_r, dvb_r = scan_direction_bwd(u[:, 3 * h:], x_r, vb[4:8], c_r,
                                            dh_r, True)
    du = torch.cat([du_f, du_r], dim=1)  # (T, 6H, B)
    dx = torch.einsum("oi,tob->tib", wt, du)
    dwt = torch.einsum("tob,tib->oi", du, x)
    return (dx[:, :h] + dhw_f, dx[:, h:] + dhw_r, dwt,
            torch.cat([dvb_f, dvb_r]))


def hidden_tile(hdim: int) -> int:
    """Batch columns per K2 block: (tile x H) threads, about 256."""
    return max(1, min(32, 256 // hdim))


def _k2_forward(x_f, x_r, wt, vb, with_c):
    if x_f.device.type == "cpu":
        return sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c)
    kernel_lib.check_cuda_f32("sru_hidden_layer", x_f, x_r, wt, vb)
    t_len, hdim, bsz = x_f.shape
    tile = hidden_tile(hdim)
    if min(x_f.shape) == 0 or tile * hdim > 1024:
        raise ValueError(f"sru_hidden_layer: unsupported shape {x_f.shape}")
    outs = [torch.empty_like(x_f) for _ in range(4 if with_c else 2)]
    c_ptrs = ((outs[2].data_ptr(), outs[3].data_ptr()) if with_c
              else (None, None))
    kernel_lib.launch(
        "sru_fused", "sru_hidden_layer_fwd", x_f.device,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), *c_ptrs,
        t_len, hdim, bsz, tile,
    )
    return tuple(outs)


def _k2_backward(x_f, x_r, wt, vb, c_f, c_r, dh_f, dh_r):
    if x_f.device.type == "cpu":
        return sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, c_f, c_r, dh_f,
                                          dh_r)
    kernel_lib.check_cuda_f32("sru_hidden_layer backward", x_f, x_r, wt, vb,
                              c_f, c_r, dh_f, dh_r)
    t_len, hdim, bsz = x_f.shape
    tile = hidden_tile(hdim)
    if -(-6 * hdim * hdim // (tile * hdim)) > 32:
        raise ValueError(f"sru_hidden_layer backward: H {hdim} > 32 is not "
                         "supported (dW registers)")
    n_blocks = -(-bsz // tile)
    dx = torch.empty(2, t_len, 2 * hdim, bsz, device=x_f.device)
    dwt_part = torch.empty(n_blocks, 6 * hdim, 2 * hdim, device=x_f.device)
    dvb_part = torch.empty(n_blocks, 8, hdim, device=x_f.device)
    kernel_lib.launch(
        "sru_fused", "sru_hidden_layer_bwd", x_f.device,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        c_f.data_ptr(), c_r.data_ptr(), dh_f.data_ptr(), dh_r.data_ptr(),
        dx[0].data_ptr(), dx[1].data_ptr(), dwt_part.data_ptr(),
        dvb_part.data_ptr(), t_len, hdim, bsz, tile,
    )
    dx = dx[0] + dx[1]  # the two directions' parts, as ``dxa + dxb``
    return dx[:, :hdim], dx[:, hdim:], dwt_part.sum(0), dvb_part.sum(0)


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
    conv weight [out, c, j]), so the unfolded tensor is never built.
    """
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
