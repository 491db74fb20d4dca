"""Time-major ConvTranspose1d for the DualPathRNN tail: kernel K3.

Counterpart of ``rtfs_tpu/ops/convt_tm.py``, forward and backward. It
reads the SRU stack's native time-major ``(L, C_in, B)`` output and writes
``(L + k - 1, C_out, B)``:

  out[t] = sum_j 1[0 <= t-j < L] x[t-j] @ W[j]^T

with W stored ``(k, C_out, C_in)`` (not flipped), stride 1, padding 0. The
bias is added by the caller. CUDA kernels ``csrc/convt_tm.cu:
convt1d_ola_tm_fwd`` and ``..._bwd`` (dx by the mirrored stencil, dW as
per-block partials); when autograd records, the op runs through a
``torch.autograd.Function`` whose backward is the kernel. On a CPU tensor
the plain versions below run, forward and backward.
"""

from __future__ import annotations

import torch

from . import kernel_lib


def convt1d_ola_tm_plain(x_tm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shifted-sum form: one (C_out x C_in) product per tap."""
    length, _, bsz = x_tm.shape
    k, c_out, _ = w.shape
    out = x_tm.new_zeros(length + k - 1, c_out, bsz)
    for j in range(k):
        out[j:j + length] += torch.einsum("oi,lib->lob", w[j], x_tm)
    return out


def convt1d_ola_tm_bwd_plain(g: torch.Tensor, x_tm: torch.Tensor,
                             w: torch.Tensor):
    """K3 backward's plain version, tap by tap: dx[l] = sum_j W[j]^T g[l+j]
    and dW[j] = sum_{l, b} g[l+j] x[l]^T. Returns (dx, dw)."""
    length = x_tm.shape[0]
    dx = torch.zeros_like(x_tm)
    dw = torch.empty_like(w)
    for j in range(w.shape[0]):
        g_j = g[j:j + length]
        dx += torch.einsum("oi,lob->lib", w[j], g_j)
        dw[j] = torch.einsum("lob,lib->oi", g_j, x_tm)
    return dx, dw


def _check(x_tm, w):
    if x_tm.shape[1] != w.shape[2]:
        raise ValueError(f"convt1d_ola_tm: x {tuple(x_tm.shape)} vs w "
                         f"{tuple(w.shape)}")


def _forward(x_tm, w):
    if x_tm.device.type == "cpu":
        return convt1d_ola_tm_plain(x_tm, w)
    kernel_lib.check_cuda_f32("convt1d_ola_tm", x_tm, w)
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    if min(x_tm.shape) == 0 or k == 0 or c_out > 64:
        raise ValueError(f"convt1d_ola_tm: unsupported shape x "
                         f"{tuple(x_tm.shape)}, w {tuple(w.shape)}")
    out = torch.empty(length + k - 1, c_out, bsz, device=x_tm.device)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_fwd", x_tm.device,
        x_tm.data_ptr(), w.data_ptr(), out.data_ptr(),
        length, c_in, c_out, k, bsz,
    )
    return out


def dw_steps_per_block(length: int, k: int) -> int:
    """Steps of L per dW block: about 256 blocks over (steps, taps)."""
    chunks = max(1, min(length, 256 // max(k, 1)))
    return -(-length // chunks)


def _backward(g, x_tm, w):
    if g.device.type == "cpu":
        return convt1d_ola_tm_bwd_plain(g, x_tm, w)
    kernel_lib.check_cuda_f32("convt1d_ola_tm backward", g, x_tm, w)
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    if c_in > 64 or c_out > 64:
        raise ValueError(f"convt1d_ola_tm backward: channels {c_in}, {c_out} "
                         "> 64 are not supported")
    steps = dw_steps_per_block(length, k)
    dx = torch.empty_like(x_tm)
    dw_part = torch.empty(-(-length // steps), k, c_out, c_in,
                          device=x_tm.device)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_bwd", x_tm.device,
        g.data_ptr(), w.data_ptr(), x_tm.data_ptr(), dx.data_ptr(),
        dw_part.data_ptr(), length, c_in, c_out, k, bsz, steps,
    )
    return dx, dw_part.sum(0)


class _ConvTranspose(torch.autograd.Function):
    """K3 with its backward (``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x_tm, w):
        ctx.save_for_backward(x_tm, w)
        return _forward(x_tm, w)

    @staticmethod
    def backward(ctx, g):
        x_tm, w = ctx.saved_tensors
        return _backward(g.contiguous(), x_tm, w)


def convt1d_ola_tm(x_tm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose1d (stride 1) on time-major data.

    Args:
      x_tm: (L, C_in, B).
      w: (k, C_out, C_in); from a torch ``(C_in, C_out, k)`` weight,
        ``w.permute(2, 1, 0)``.

    Returns:
      (L + k - 1, C_out, B).
    """
    _check(x_tm, w)
    if torch.is_grad_enabled() and (x_tm.requires_grad or w.requires_grad):
        return _ConvTranspose.apply(x_tm, w)
    return _forward(x_tm, w)
