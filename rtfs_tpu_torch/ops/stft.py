"""STFT / iSTFT with the reference's ``torch.stft`` / ``torch.istft`` settings.

Counterpart of ``rtfs_tpu/ops/stft.py``: ``center=True``, reflect padding,
periodic Hann window, onesided, ``length=`` on the inverse. The JAX package
returns (..., T, F); torch, and so this module, returns (..., F, T).
"""

from __future__ import annotations

import torch


def hann_window(win: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(win)``)."""
    return torch.hann_window(win, periodic=True, device=device, dtype=dtype)


def stft(x: torch.Tensor, n_fft: int, hop: int,
         window: torch.Tensor) -> torch.Tensor:
    """(..., L) real -> (..., F, T) complex, F = n_fft // 2 + 1."""
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop, window=window,
        center=True, pad_mode="reflect", normalized=False, onesided=True,
        return_complex=True,
    )
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
          length: int) -> torch.Tensor:
    """(..., F, T) complex -> (..., length) real."""
    lead = spec.shape[:-2]
    wav = torch.istft(
        spec.reshape(-1, *spec.shape[-2:]), n_fft, hop_length=hop,
        window=window, center=True, length=length,
    )
    return wav.reshape(*lead, length)
