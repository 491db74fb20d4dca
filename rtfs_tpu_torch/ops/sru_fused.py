"""Fused bidirectional SRU stack: kernels K1 and K2 and the stack driver.

Counterpart of ``rtfs_tpu/ops/sru_fused.py`` (forward only, serving):

- ``sru_dual_recurrence`` (K1): the layer-0 recurrence of both directions
  over a precomputed U = [x~, f, r, highway]; CUDA kernel
  ``csrc/sru_fused.cu:sru_dual_recurrence_fwd``.
- ``sru_hidden_layer`` (K2): one hidden layer (k = 3, highway = input) with
  the projection U_t = W^T [h_f; h_r]_t inside the kernel; CUDA kernel
  ``csrc/sru_fused.cu:sru_hidden_layer_fwd``.
- ``sru_stack``: layer 0's projection as a windowed ``conv1d`` over the raw
  sequence, one entry transpose to time-major, K1, then K2 per hidden layer,
  with the (h_f, h_r) pair chained in (T, H, B).

Each wrapper keeps the Pallas op's boundary layout, time-major with the
folded batch last. On a CPU tensor it runs the plain PyTorch version
beside it; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_lib


def vb_pack(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, 2, H) v and b -> (8, H) rows, per direction [v_f, v_r, b_f, b_r]
    (``_vb_pack`` without its lane replication)."""
    return torch.cat([v, b], dim=1).reshape(-1, v.shape[-1])


def _gates(u0, u1, u2, xhw, c, v_f, v_r, b_f, b_r):
    f = torch.sigmoid(u1 + v_f * c + b_f)
    c = f * c + (1.0 - f) * u0
    r = torch.sigmoid(u2 + v_r * c + b_r)  # reads the UPDATED cell
    return c, r * c + (1.0 - r) * xhw


def scan_direction(u, xhw, vb_d, reverse):
    """Plain recurrence of one direction.

    u: (T, >= 3H, B) with rows [x~, f, r, ...]; xhw: (T, H, B) highway.
    ``reverse`` walks t = T-1 .. 0. Returns h (T, H, B).
    """
    t_len, h = xhw.shape[0], xhw.shape[1]
    v_f, v_r, b_f, b_r = (vb_d[i][:, None] for i in range(4))
    c = torch.zeros_like(xhw[0])
    out = torch.empty_like(xhw)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        u_t = u[t]
        c, out[t] = _gates(u_t[:h], u_t[h:2 * h], u_t[2 * h:3 * h], xhw[t],
                           c, v_f, v_r, b_f, b_r)
    return out


# ---------------------------------------------------------------------------
# K1: layer-0 recurrence, both directions
# ---------------------------------------------------------------------------


def sru_dual_recurrence_plain(u_f, u_r, vb):
    h = u_f.shape[1] // 4
    return (scan_direction(u_f, u_f[:, 3 * h:], vb[0:4], False),
            scan_direction(u_r, u_r[:, 3 * h:], vb[4:8], True))


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
    if u_f.device.type == "cpu":
        return sru_dual_recurrence_plain(u_f, u_r, vb)
    kernel_lib.check_cuda_f32("sru_dual_recurrence", u_f, u_r, vb)
    if min(u_f.shape) == 0:
        raise ValueError("sru_dual_recurrence: empty input")
    h_f = torch.empty(t_len, hdim, bsz, device=u_f.device)
    h_r = torch.empty_like(h_f)
    kernel_lib.launch(
        "sru_fused", "sru_dual_recurrence_fwd", u_f.device,
        u_f.data_ptr(), u_r.data_ptr(), vb.data_ptr(), h_f.data_ptr(),
        h_r.data_ptr(), t_len, hdim, bsz,
    )
    return h_f, h_r


# ---------------------------------------------------------------------------
# K2: hidden layer, projection + recurrence, both directions
# ---------------------------------------------------------------------------


def sru_hidden_layer_plain(x_f, x_r, wt, vb):
    h = x_f.shape[1]
    x = torch.cat([x_f, x_r], dim=1)  # (T, 2H, B)
    u = torch.einsum("oi,tib->tob", wt, x)  # (T, 6H, B)
    return (scan_direction(u[:, :3 * h], x_f, vb[0:4], False),
            scan_direction(u[:, 3 * h:], x_r, vb[4:8], True))


def hidden_tile(hdim: int) -> int:
    """Batch columns per K2 block: (tile x H) threads, about 256."""
    return max(1, min(32, 256 // hdim))


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
    if x_f.device.type == "cpu":
        return sru_hidden_layer_plain(x_f, x_r, wt, vb)
    kernel_lib.check_cuda_f32("sru_hidden_layer", x_f, x_r, wt, vb)
    tile = hidden_tile(hdim)
    if min(x_f.shape) == 0 or tile * hdim > 1024:
        raise ValueError(f"sru_hidden_layer: unsupported shape {x_f.shape}")
    h_f = torch.empty_like(x_f)
    h_r = torch.empty_like(x_f)
    kernel_lib.launch(
        "sru_fused", "sru_hidden_layer_fwd", x_f.device,
        x_f.data_ptr(), x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(),
        h_f.data_ptr(), h_r.data_ptr(), t_len, hdim, bsz, tile,
    )
    return h_f, h_r


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
