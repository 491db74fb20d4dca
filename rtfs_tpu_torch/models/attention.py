"""Attention layers: 1-D MHSA with the conv FFN, and RTFS's 2-D TF attention.

Counterpart of ``rtfs_tpu/models/attention.py``. Sequences are short (the
pooled TF map, the video frames), so attention is plain matmul + softmax,
as the JAX package computes it outside Pallas. Layouts: 1-D (B, C, T),
2-D (B, C, T, F).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from . import layers as L


def sinusoidal_pe(max_len: int, channels: int) -> np.ndarray:
    """Reference PositionalEncoding table (``attention.py:9-25``)."""
    pe = np.zeros((max_len, channels), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, channels, 2, dtype=np.float32)
        * -(math.log(float(max_len)) / channels)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class TorchMHA(nn.Module):
    """``nn.MultiheadAttention`` parameters (packed QKV) and math, written
    as plain matmul + softmax, with dropout on the attention weights in
    train mode. Input (B, T, C)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = L.Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def init_weights(self, generator):
        c = self.in_proj_weight.shape[1]
        L.uniform_(self.in_proj_weight, math.sqrt(6.0 / (4 * c)), generator)
        L.uniform_(self.out_proj.weight, math.sqrt(1.0 / c), generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, x):
        b, t, c = x.shape
        h = self.num_heads
        qkv = x @ self.in_proj_weight.t() + self.in_proj_bias
        q, k, v = (z.reshape(b, t, h, c // h).transpose(1, 2)
                   for z in qkv.chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c // h), -1)
        out = (self.attn_drop(attn) @ v).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(out)


class MultiHeadSelfAttention(nn.Module):
    """1-D MHSA block: LN -> +PE -> MHA -> dropout + residual -> LN ->
    DropPath + outer residual (reference ``attention.py:28-73``; dropouts as
    ``rtfs_tpu/models/attention.py:75-78,111,113``). Input (B, C, T)."""

    def __init__(self, in_chan, n_head=8, dropout=0.1,
                 positional_encoding=True, max_len=10000):
        super().__init__()
        self.norm1 = nn.LayerNorm(in_chan, eps=1e-5)
        self.attention = TorchMHA(in_chan, n_head, dropout)
        self.dropout = L.Dropout(dropout)
        self.norm2 = nn.LayerNorm(in_chan, eps=1e-5)
        self.drop_path = L.DropPath(dropout)
        self.positional_encoding = positional_encoding
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe(max_len, in_chan)),
            persistent=False,
        )

    def forward(self, x):
        res = x
        x = self.norm1(x.transpose(1, 2))  # (B, T, C)
        if self.positional_encoding:
            x = x + self.pe[: x.shape[1]]
        x = self.norm2(self.dropout(self.attention(x)) + x)
        return self.drop_path(x).transpose(1, 2) + res


class GlobalAttention(nn.Module):
    """MHSA + conv FFN (reference ``attention.py:192-220``), 1-D."""

    def __init__(self, in_chan, hid_chan=None, kernel_size=5, n_head=8,
                 dropout=0.1, pos_enc=True):
        super().__init__()
        hid = hid_chan if hid_chan is not None else 2 * in_chan
        self.MHSA = MultiHeadSelfAttention(in_chan, n_head, dropout, pos_enc)
        self.FFN = L.FeedForwardNetwork(in_chan, hid, kernel_size,
                                        dropout=dropout)

    def forward(self, x):
        return self.FFN(self.MHSA(x))


class _HeadProjection(nn.Module):
    """One head's 1x1 conv -> PReLU -> LN4D over (channels, F)."""

    def __init__(self, in_chan, out_chan, n_freqs, act_type, norm_type):
        super().__init__()
        self.conv = L.Conv(in_chan, out_chan, 1, nd=2)
        self.act = L.make_act(act_type)
        self.norm = L.make_norm(norm_type, out_chan, n_freqs=n_freqs)

    def forward(self, x):
        return self.norm(self.act(self.conv(x)))


class MultiHeadSelfAttention2D(nn.Module):
    """RTFS TF attention (reference ``attention.py:76-189``).

    Per head, Q/K/V come from 1x1 conv + PReLU + LN4D; attention runs over T
    with F folded into the embedding (scores (B*heads, T, T) over E*F).
    ``dim=4`` attends over frequency instead. Input (B, C, T, F).
    """

    def __init__(self, in_chan, n_freqs, n_head=4, hid_chan=4,
                 act_type="PReLU", norm_type="LayerNormalization4D", dim=3):
        super().__init__()
        self.n_head, self.dim = n_head, dim
        ch = in_chan // n_head

        def heads(out_chan):
            return nn.ModuleList(
                _HeadProjection(in_chan, out_chan, n_freqs, act_type, norm_type)
                for _ in range(n_head)
            )

        self.Queries = heads(hid_chan)
        self.Keys = heads(hid_chan)
        self.Values = heads(ch)
        self.attn_concat_proj = _HeadProjection(in_chan, in_chan, n_freqs,
                                                act_type, norm_type)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(2, 3)
        b, c, t, f = x.shape
        residual = x

        def project(mods):
            z = torch.stack([m(x) for m in mods], dim=1)  # (B, nh, o, T, F)
            return z.transpose(2, 3).reshape(b * self.n_head, t, -1)

        q, k, v = project(self.Queries), project(self.Keys), project(self.Values)
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(q.shape[-1]), -1)
        out = (attn @ v).reshape(b, self.n_head, t, c // self.n_head, f)
        out = out.transpose(2, 3).reshape(b, c, t, f)
        x = self.attn_concat_proj(out) + residual
        if self.dim == 4:
            x = x.transpose(2, 3)
        return x
