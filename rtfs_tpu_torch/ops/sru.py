"""SRU (Simple Recurrent Unit), the RTFS-Net recurrence.

Counterpart of ``rtfs_tpu/ops/sru.py``, ``sru`` package v2.6 semantics.
Per layer and direction, with U = x @ W split into k chunks (k = 4 when the
input width differs from dirs*H, else 3):

    f_t = sigmoid(U1_t + v_f * c_{t-1} + b_f)
    c_t = f_t * c_{t-1} + (1 - f_t) * U0_t
    r_t = sigmoid(U2_t + v_r * c_t + b_r)      # reads the UPDATED c_t
    h_t = r_t * c_t + (1 - r_t) * x_hw_t

with x_hw = U3 (k = 4) or the layer input's slice of the direction (k = 3).

``sru_layer`` is the plain scan, batch-major (B, L, D). The ``SRU`` module
takes the fused stack (``ops.sru_fused``: kernels K1 and K2) whenever it
applies, bidirectional with k = 4 on layer 0, as every RTFS-Net preset is.
Other configurations run the plain scan on the CPU; on the GPU they would
need the gen-1 recurrence kernel, which is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .convops import unfold_1d
from .sru_fused import scan_direction, sru_stack


def sru_layer(x, weight, weight_c, bias, hidden: int, bidirectional: bool):
    """One SRU layer, both directions, plain scan.

    Args:
      x: (B, L, D_in); weight (D_in, dirs*k*H), column order [dir][k][unit];
      weight_c, bias: (dirs, 2, H).

    Returns:
      (B, L, dirs*H).
    """
    dirs = 2 if bidirectional else 1
    bsz, length, d_in = x.shape
    k = 4 if d_in != dirs * hidden else 3
    u = torch.einsum("bld,dk->lkb", x, weight)  # (L, dirs*k*H, B)
    outs = []
    for d in range(dirs):
        u_d = u[:, d * k * hidden:(d + 1) * k * hidden]
        x_hw = (u_d[:, 3 * hidden:] if k == 4
                else x[..., d * hidden:(d + 1) * hidden].permute(1, 2, 0))
        vb_d = torch.cat([weight_c[d], bias[d]], dim=0)  # [v_f, v_r, b_f, b_r]
        outs.append(scan_direction(u_d, x_hw, vb_d, reverse=d == 1))
    return torch.cat(outs, dim=1).permute(2, 0, 1)


class SRU(nn.Module):
    """Multi-layer (bi)directional SRU, batch-major (B, L, D).

    Parameters ``weights.{l}`` (D_in, dirs*k*H), ``weight_cs.{l}`` and
    ``biases.{l}`` (dirs, 2, H): the rtfs layout ``convert_avnet`` reads.
    ``window = (k, s)``: the caller passes the raw sequence and layer 0's
    projection runs as a windowed conv (``nn.Unfold((k, 1))`` semantics).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, highway_bias: float = -1.0,
                 window: Optional[tuple] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.bidirectional = bidirectional
        self.highway_bias = highway_bias
        self.window = window
        dirs = 2 if bidirectional else 1
        d_out = dirs * hidden_size
        self.weights = nn.ParameterList()
        self.weight_cs = nn.ParameterList()
        self.biases = nn.ParameterList()
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else d_out
            k = 4 if d_in != d_out else 3
            self.weights.append(torch.empty(d_in, dirs * k * hidden_size))
            self.weight_cs.append(torch.empty(dirs, 2, hidden_size))
            self.biases.append(torch.empty(dirs, 2, hidden_size))

    def init_weights(self, generator):
        with torch.no_grad():
            for w, wc, b in zip(self.weights, self.weight_cs, self.biases):
                bound = math.sqrt(3.0 / w.shape[0])
                w.uniform_(-bound, bound, generator=generator)
                bound = math.sqrt(3.0 / self.hidden_size)
                wc.uniform_(-bound, bound, generator=generator)
                b.zero_()
                b[:, 1] = self.highway_bias  # reset-gate bias

    @property
    def uses_fused_stack(self) -> bool:
        return self.bidirectional and self.input_size != 2 * self.hidden_size

    def forward(self, x: torch.Tensor, time_major: bool = False):
        """x: (B, L, D). Returns (B, L', dirs*H), or (L', 2H, B) with
        ``time_major`` (fused stack only)."""
        if self.uses_fused_stack:
            return sru_stack(x, list(self.weights), list(self.weight_cs),
                             list(self.biases), self.hidden_size,
                             window=self.window, time_major=time_major)
        if time_major:
            raise ValueError("time_major output needs the fused stack")
        if x.device.type != "cpu":
            raise NotImplementedError(
                "this SRU configuration needs the gen-1 recurrence kernel "
                "(rtfs_tpu/ops/sru_pallas.py), not ported to CUDA yet"
            )
        if self.window is not None:
            x = unfold_1d(x.transpose(1, 2), *self.window).transpose(1, 2)
        for w, wc, b in zip(self.weights, self.weight_cs, self.biases):
            x = sru_layer(x, w, wc, b, self.hidden_size, self.bidirectional)
        return x
