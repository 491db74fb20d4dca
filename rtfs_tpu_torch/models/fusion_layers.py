"""Fusion cells: TF-AR InjectionMultiSum and the CAF attention fusion cell.

Counterpart of ``rtfs_tpu/models/fusion_layers.py`` (the cells the
RTFS-Net presets use). Layouts: 2-D (B, C, T, F), 1-D (B, C, T); resizes use
torch nearest.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops import convops
from ..ops import packed_tf as P
from . import layers as L


class InjectionMultiSum(nn.Module):
    """TF-AR unit: ``local * sigmoid-gate(global) + global``, resizing the
    smaller side with nearest (reference ``fusion.py:9-69``)."""

    def __init__(self, in_chan, kernel_size, norm_type="gLN", is2d=False):
        super().__init__()

        def dw_conv(act_type=None):
            return L.ConvNormAct(in_chan, in_chan, kernel_size,
                                 groups=in_chan, norm_type=norm_type,
                                 act_type=act_type, bias=False, is2d=is2d)

        self.local_embedding = dw_conv()
        self.global_embedding = dw_conv()
        self.global_gate = dw_conv("Sigmoid")

    def forward(self, local_features, global_features):
        new_shape = local_features.shape[2:]
        local_emb = self.local_embedding(local_features)
        if isinstance(local_features, P.PackedTF):
            # packed full-res local + rank-4 pooled global: embed and gate
            # at the pooled resolution (the reference's prod(new) >
            # prod(old) branch), then nearest-upsample into the packed map
            if math.prod(new_shape) <= math.prod(global_features.shape[2:]):
                raise NotImplementedError(
                    "packed_tf: the global map must be the smaller one")
            global_emb = P.spatial_up_to(
                self.global_embedding(global_features), *new_shape)
            gate = P.spatial_up_to(self.global_gate(global_features),
                                   *new_shape)
            return local_emb * gate + global_emb
        if math.prod(new_shape) > math.prod(global_features.shape[2:]):
            global_emb = convops.interp_nearest(
                self.global_embedding(global_features), new_shape)
            gate = convops.interp_nearest(
                self.global_gate(global_features), new_shape)
        else:
            g = convops.interp_nearest(global_features, new_shape)
            global_emb = self.global_embedding(g)
            gate = self.global_gate(g)
        return local_emb * gate + global_emb


class ATTNFusionCell(nn.Module):
    """CAF cell (reference ``fusion.py:194-274``). ``a`` is the modality
    being refined ((B, Ca, T, F) when ``is2d``), ``b`` the conditioning one
    as a 1-D sequence (B, Cb, T2):

      k1 = key_embed(a) * resize(b)
      k2 = softmax_T2(mean_k(attention_embed(b))) * value_embed(a)

    with both ``b`` paths nearest-resized to ``a``'s time axis.
    """

    def __init__(self, in_chan_a, in_chan_b, kernel_size=1, is2d=False):
        super().__init__()
        self.in_chan_a, self.kernel_size, self.is2d = in_chan_a, kernel_size, is2d
        self.key_embed = L.ConvNormAct(
            in_chan_a, in_chan_a, 1, groups=in_chan_a, norm_type="BatchNorm2d",
            act_type="ReLU", bias=False, is2d=is2d)
        self.value_embed = L.ConvNormAct(
            in_chan_a, in_chan_a, 1, groups=in_chan_a, norm_type="BatchNorm2d",
            bias=False, is2d=is2d)
        self.attention_embed = L.ConvNormAct(
            in_chan_b, kernel_size * in_chan_a, 1, groups=in_chan_a,
            norm_type="gLN")
        self.resize = L.ConvNormAct(in_chan_b, in_chan_a, 1, groups=in_chan_a,
                                    norm_type="gLN")

    def forward(self, a, b):
        time_steps = a.shape[2]
        b_t = convops.interp_nearest(self.resize(b), (time_steps,))
        att = self.attention_embed(b)  # (B, Ca*k, T2), channel ca*k + j
        att = att.reshape(att.shape[0], self.in_chan_a, self.kernel_size, -1)
        att = torch.softmax(att.mean(dim=2), dim=-1)  # over the sequence
        att = convops.interp_nearest(att, (time_steps,))
        if self.is2d:
            b_t, att = b_t[..., None], att[..., None]  # broadcast over F
        return self.key_embed(a) * b_t + att * self.value_embed(a)
