"""Time-major ConvTranspose1d for the DualPathRNN tail: kernel K3.

Counterpart of ``rtfs_tpu/ops/convt_tm.py``, forward and backward. It
reads the SRU stack's native time-major ``(L, C_in, B)`` output and writes
``(L + k - 1, C_out, B)``:

  out[t] = sum_j 1[0 <= t-j < L] x[t-j] @ W[j]^T

with W stored ``(k, C_out, C_in)`` (not flipped), stride 1, padding 0. The
bias is added by the caller. CUDA kernels ``csrc/convt_tm.cu:
convt1d_ola_tm_fwd`` (W resident in shared memory, a ring of x rows, the
product on the tensor cores in 3xTF32) and ``..._bwd`` (dx with W resident
in shared memory and a ring of g rows, dW as a split-K product whose
partials are summed in a fixed order); when autograd records, the op runs
through a ``torch.autograd.Function`` whose backward is the kernel. On a
CPU tensor the plain versions below run, forward and backward.
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


# K3 forward's geometry, the constants of csrc/convt_tm.cu: C_out <= 64
# (``kMaxOut``, four m16 tiles), blocks of 16 batch columns
# (``kFwdCols``, also an x row's stride in shared memory) and 8 output
# steps a pass (``kFwdPass``)
MAX_OUT = 64
FWD_COLS = 16
FWD_PASS = 8


def fwd_geometry(length: int, c_in: int, c_out: int, k: int,
                 bsz: int) -> dict:
    """K3 forward's launch geometry, as ``convt1d_ola_tm_fwd`` launches it:
    the blocks (column tiles x runs of ``steps`` consecutive output steps,
    a multiple of ``FWD_PASS``, one wave over the card's SMs) and their
    dynamic shared memory in bytes (W_flat, its C_out padded to 16 rows of
    k * C_in' + 4 floats with C_in' = C_in padded to 8, and the ring of
    k + 2 FWD_PASS - 1 x rows)."""
    t_out = length + k - 1
    col_tiles = -(-bsz // FWD_COLS)
    runs = max(1, min(t_out, kernel_lib.SMS // col_tiles))  # one block an SM
    steps = -(-t_out // runs)
    steps = -(-steps // FWD_PASS) * FWD_PASS
    c_pad = -(-c_in // 8) * 8
    return {
        "grid": (col_tiles, -(-t_out // steps)), "steps": steps,
        "smem": 4 * (-(-c_out // 16) * 16 * (k * c_pad + 4)
                     + (k + 2 * FWD_PASS - 1) * c_pad * FWD_COLS),
    }


def _forward(x_tm, w):
    if x_tm.device.type == "cpu":
        return convt1d_ola_tm_plain(x_tm, w)
    kernel_lib.check_cuda_f32("convt1d_ola_tm", x_tm, w)
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    geo = fwd_geometry(length, c_in, c_out, k, bsz)
    if (min(x_tm.shape) == 0 or k == 0 or c_out > MAX_OUT
            or geo["smem"] > kernel_lib.SMEM_PER_BLOCK):
        raise ValueError(f"convt1d_ola_tm: unsupported shape x "
                         f"{tuple(x_tm.shape)}, w {tuple(w.shape)}")
    out = torch.empty(length + k - 1, c_out, bsz, device=x_tm.device)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_fwd", x_tm.device,
        x_tm.data_ptr(), w.data_ptr(), out.data_ptr(),
        length, c_in, c_out, k, bsz, geo["steps"],
    )
    return out


# K3 backward's geometry, the constants of csrc/convt_tm.cu: dx blocks of
# 32 batch columns (``kDxCols``) in 4 tap groups (``kDxGroups``) and C_in
# <= 64 (``kMaxIn``, also W's row stride in shared memory); dW tiles of
# 128 x 64 (``kWgRows`` x ``kMaxIn``), stages of 32 columns (``kWgCols``)
DX_COLS = 32
DX_GROUPS = 4
MAX_IN = 64
WGRAD_ROWS = 128
WGRAD_COLS = 32


def bwd_geometry(length: int, c_in: int, c_out: int, k: int,
                 bsz: int) -> dict:
    """K3 backward's launch geometry, as ``convt1d_ola_tm_bwd`` launches it:
    the dx blocks (column tiles x runs of ``steps`` consecutive steps, one
    wave over the card's SMs), their dynamic shared memory in bytes (all
    of W, the ring of k+1 g rows, the tap groups' exchange tiles), and the
    dW split-K over the L*B columns (``cols`` a chunk, one partial each)."""
    col_tiles = -(-bsz // DX_COLS)
    runs = max(1, min(length, kernel_lib.SMS // col_tiles))  # one block an SM
    steps = -(-length // runs)
    wgrad_tiles = -(-k * c_out // WGRAD_ROWS) * -(-c_in // MAX_IN)
    cols, chunks = kernel_lib.split_k(length * bsz, wgrad_tiles, WGRAD_COLS)
    return {
        "dx_grid": (col_tiles, -(-length // steps)), "steps": steps,
        "dx_smem": 4 * (k * c_out * MAX_IN + (k + 1) * c_out * DX_COLS
                        + (DX_GROUPS - 1) * MAX_IN * DX_COLS),
        "wgrad_grid": (-(-c_in // MAX_IN), -(-k * c_out // WGRAD_ROWS),
                       chunks),
        "cols": cols, "chunks": chunks,
    }


def _backward(g, x_tm, w):
    if g.device.type == "cpu":
        return convt1d_ola_tm_bwd_plain(g, x_tm, w)
    kernel_lib.check_cuda_f32("convt1d_ola_tm backward", g, x_tm, w)
    length, c_in, bsz = x_tm.shape
    k, c_out, _ = w.shape
    geo = bwd_geometry(length, c_in, c_out, k, bsz)
    if (min(x_tm.shape) == 0 or k == 0 or c_in > MAX_IN
            or geo["dx_smem"] > kernel_lib.SMEM_PER_BLOCK):
        raise ValueError(f"convt1d_ola_tm backward: unsupported shape x "
                         f"{tuple(x_tm.shape)}, w {tuple(w.shape)}")
    dx = torch.empty_like(x_tm)
    dw = torch.empty_like(w)
    dw_part = torch.empty(geo["chunks"], k, c_out, c_in, device=x_tm.device)
    kernel_lib.launch(
        "convt_tm", "convt1d_ola_tm_bwd", x_tm.device,
        g.data_ptr(), w.data_ptr(), x_tm.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dw_part.data_ptr(), length, c_in, c_out, k, bsz,
        geo["steps"], geo["cols"],
    )
    return dx, dw


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
