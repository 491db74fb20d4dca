"""Convolution / resize primitives with the reference's torch semantics.

Counterpart of ``rtfs_tpu/ops/convops.py``, channels-first: 1-D maps
(B, C, T), 2-D maps (B, C, T, F). Weights keep torch's layouts: conv
(C_out, C_in/groups, *k), transposed conv (C_in, C_out/groups, *k).

- ``conv``: torch ``padding="same"`` with the asymmetric split for even
  kernels (left = total // 2), integer or explicit (lo, hi) padding.
- ``interp_nearest``: ``F.interpolate(mode="nearest")``.
- ``adaptive_avg_pool``: torch adaptive-pool bucket boundaries.
- ``unfold_1d``: ``nn.Unfold((k, 1))`` channel-major feature order.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d}


def same_pads(kernel: Sequence[int], dilation: Sequence[int]):
    """torch padding='same' (lo, hi) pairs per spatial dim."""
    pads = []
    for k, d in zip(kernel, dilation):
        total = d * (k - 1)
        pads.append((total // 2, total - total // 2))
    return pads


def _tuple(v, nd):
    return tuple(v) if hasattr(v, "__len__") else (v,) * nd


def conv(x, w, *, stride=1, padding="same", dilation=1, groups=1, bias=None):
    """Grouped N-D (N = 1, 2) convolution.

    padding: "same", an int (symmetric), or explicit (lo, hi) pairs.
    """
    nd = x.ndim - 2
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    kernel = w.shape[2:]
    if padding == "same":
        pads = same_pads(kernel, dilation)
    elif isinstance(padding, int):
        pads = [(padding, padding)] * nd
    else:
        pads = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    flat = [p for pair in reversed(pads) for p in pair]  # F.pad: last dim first
    if any(flat):
        x = F.pad(x, flat)
    return _CONV[nd](x, w, bias, stride, 0, dilation, groups)


def conv_transpose(x, w, *, stride=1, padding=0, output_padding=0,
                   dilation=1, groups=1, bias=None):
    """torch ConvTranspose1d/2d."""
    nd = x.ndim - 2
    return _CONV_T[nd](x, w, bias, stride, padding, output_padding, groups,
                       dilation)


def interp_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch nearest resize over the spatial dims of (B, C, *spatial)."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def adaptive_avg_pool(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch adaptive average pooling over the spatial dims."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    if x.ndim == 3:
        return F.adaptive_avg_pool1d(x, size)
    return F.adaptive_avg_pool2d(x, size)


def unfold_1d(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """(B, C, T) -> (B, C*k, T'), feature index c*k + j = x[:, c, t*s + j]."""
    b, c, _ = x.shape
    win = x.unfold(-1, kernel, stride)  # (B, C, T', k)
    return win.permute(0, 1, 3, 2).reshape(b, c * kernel, -1)
