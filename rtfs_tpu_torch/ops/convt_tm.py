"""Time-major ConvTranspose1d for the DualPathRNN tail: kernel K3.

Counterpart of ``rtfs_tpu/ops/convt_tm.py`` (forward only, serving). It
reads the SRU stack's native time-major ``(L, C_in, B)`` output and writes
``(L + k - 1, C_out, B)``:

  out[t] = sum_j 1[0 <= t-j < L] x[t-j] @ W[j]^T

with W stored ``(k, C_out, C_in)`` (not flipped), stride 1, padding 0. The
bias is added by the caller. CUDA kernel
``csrc/convt_tm.cu:convt1d_ola_tm_fwd``; on a CPU tensor the wrapper runs
the plain version below.
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


def convt1d_ola_tm(x_tm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose1d (stride 1) on time-major data.

    Args:
      x_tm: (L, C_in, B).
      w: (k, C_out, C_in); from a torch ``(C_in, C_out, k)`` weight,
        ``w.permute(2, 1, 0)``.

    Returns:
      (L + k - 1, C_out, B).
    """
    length, c_in, bsz = x_tm.shape
    k, c_out, c_in_w = w.shape
    if c_in_w != c_in:
        raise ValueError(f"convt1d_ola_tm: x {tuple(x_tm.shape)} vs w "
                         f"{tuple(w.shape)}")
    if x_tm.device.type == "cpu":
        return convt1d_ola_tm_plain(x_tm, w)
    kernel_lib.check_cuda_f32("convt1d_ola_tm", x_tm, w)
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
