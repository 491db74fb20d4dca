"""DualPathRNN: the windowed SRU scan over one TF axis (RTFS-Net's core).

Counterpart of ``rtfs_tpu/models/rnn_blocks.py`` (``DualPathRNN``, SRU
branch), serving and training alike. Input (B, C, T, F). Pipeline:

  pad -> LN4D -> fold the other axis into batch -> SRU over windows of the
  scan axis (k, stride 1) -> ConvTranspose1d back -> + residual -> crop

With the fused stack (bidirectional SRU, stride 1) the tail stays
time-major: the stack emits (L', 2H, B*other), kernel K3 back-projects it,
the bias is added, and one transpose lands in (B, C, T, F), at any width
(K3 splits wide channels over its grid, ``convt_tm.fwd_geometry``). Every
other SRU (unidirectional: K4 per layer, ``ops.sru_pallas``) emits
(B*other, L', dirs*H) and the tail is the library ConvTranspose1d (dirs*H
-> C), as JAX's non-fused tail. On the CPU the same paths run the kernels'
plain versions. In a bf16 model the fused stack, K3 and the bias add run
in bf16, as JAX's time-major tail does for a bf16 input; off the fused
stack K4 runs in bf16 and the library ConvTranspose1d takes its input in
its bf16 weight's dtype (``layers.ConvTranspose``), as JAX's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convt_tm import convt1d_ola_tm
from ..ops.sru import SRU
from . import layers as L


class DualPathRNN(nn.Module):
    """``dim=3`` scans time (frequency folded into batch); ``dim=4`` scans
    frequency (time folded into batch). Parameter names as the reference:
    ``norm.{gamma,beta}``, ``rnn.*``, ``linear.{weight,bias}``."""

    def __init__(self, in_chan, hid_chan, dim, kernel_size=8, stride=1,
                 rnn_type="SRU", num_layers=1,
                 norm_type="LayerNormalization4D", bidirectional=True,
                 apply_ffn=False):
        super().__init__()
        if rnn_type != "SRU" or apply_ffn:
            raise NotImplementedError(
                f"DualPathRNN: rnn_type={rnn_type}, apply_ffn={apply_ffn} "
                "are not ported (SRU without FFN only)"
            )
        self.dim, self.kernel_size, self.stride = dim, kernel_size, stride
        num_dir = 2 if bidirectional else 1
        self.norm = L.make_norm(norm_type, in_chan, n_freqs=1)
        self.rnn = SRU(in_chan * kernel_size, hid_chan, num_layers=num_layers,
                       bidirectional=bidirectional,
                       window=(kernel_size, stride))
        self.linear = L.ConvTranspose(hid_chan * num_dir, in_chan,
                                      kernel_size, stride=stride, nd=1)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(2, 3)  # the scan axis becomes axis 2
        b, c, old_t, old_f = x.shape
        ks, st = self.kernel_size, self.stride
        new_t = math.ceil((old_t - ks) / st) * st + ks
        new_f = math.ceil((old_f - ks) / st) * st + ks
        x = F.pad(x, (0, new_f - old_f, 0, new_t - old_t))
        residual = x
        x = self.norm(x)
        # fold F into batch: (B*F, T, C), batch-major sequences
        x = x.permute(0, 3, 2, 1).reshape(b * new_f, new_t, c)
        if self.rnn.uses_fused_stack and st == 1:
            h = self.rnn(x, time_major=True)  # (L', 2H, B*F)
            w = self.linear.weight.permute(2, 1, 0).contiguous()  # (k, C, 2H)
            y = convt1d_ola_tm(h, w) + self.linear.bias[None, :, None]
            y = y.reshape(new_t, c, b, new_f).permute(2, 1, 0, 3)
        else:
            h = self.rnn(x)  # (B*F, L', dirs*H)
            y = self.linear(h.transpose(1, 2))  # (B*F, C, T)
            y = y.reshape(b, new_f, c, new_t).permute(0, 2, 3, 1)
        x = (y + residual)[:, :, :old_t, :old_f]
        if self.dim == 4:
            x = x.transpose(2, 3)
        return x
