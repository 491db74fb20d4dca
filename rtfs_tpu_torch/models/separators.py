"""TDANet separator (the RTFS block host) and its globalatt layer registry.

Counterpart of ``rtfs_tpu/models/separators.py`` for the layer types the
RTFS-Net presets use. A ``Separator`` holds one shared block or one per
repeat; the refinement loop drives ``block(i, x)``. Layouts: 2-D (B, C, T, F),
1-D (B, C, T).
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any, Dict

import torch.nn as nn

from ..ops import convops
from ..ops import packed_tf as P
from . import layers as L
from .attention import GlobalAttention, MultiHeadSelfAttention2D
from .fusion_layers import InjectionMultiSum
from .rnn_blocks import DualPathRNN

LAYER_REGISTRY = {
    "DualPathRNN": DualPathRNN,
    "MultiHeadSelfAttention2D": MultiHeadSelfAttention2D,
    "GlobalAttention": GlobalAttention,
}


def build_layer(layer_conf: Dict[str, Any], in_chan: int) -> nn.Module:
    """``get(layer['layer_type'])(in_chan=hid_chan, **layer)`` (reference
    ``tdanet.py:49``), keeping only the keys the layer takes."""
    conf = dict(layer_conf)
    layer_type = conf.pop("layer_type")
    if layer_type not in LAYER_REGISTRY:
        raise NotImplementedError(f"globalatt layer {layer_type} is not ported")
    cls = LAYER_REGISTRY[layer_type]
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: v for k, v in conf.items() if k in params}
    return cls(in_chan=in_chan, **kwargs)


class TDANetBlock(nn.Module):
    """One RTFS/TDA block (reference ``tdanet.py:8-131``): gateway DW conv ->
    1x1 projection -> stride-2 pyramid -> pooled global sum -> globalatt
    stack -> InjectionMultiSum reconstruction -> residual."""

    def __init__(self, in_chan, hid_chan, kernel_size=5, stride=2,
                 norm_type="gLN", act_type="PReLU", upsampling_depth=4,
                 layers=(), is2d=False):
        super().__init__()
        depth = upsampling_depth
        self.kernel_size, self.stride, self.is2d = kernel_size, stride, is2d
        self.gateway = L.ConvNormAct(in_chan, in_chan, 1, groups=in_chan,
                                     act_type=act_type, is2d=is2d)
        self.projection = L.ConvNormAct(in_chan, hid_chan, 1, is2d=is2d)
        self.downsample_layers = nn.ModuleList(
            L.ConvNormAct(hid_chan, hid_chan, kernel_size,
                          stride=1 if i == 0 else stride, groups=hid_chan,
                          norm_type=norm_type, is2d=is2d)
            for i in range(depth)
        )
        self.globalatt = nn.ModuleList(build_layer(c, hid_chan) for c in layers)
        self.fusion_layers = nn.ModuleList(
            InjectionMultiSum(hid_chan, kernel_size, norm_type, is2d)
            for _ in range(depth)
        )
        self.concat_layers = nn.ModuleList(
            InjectionMultiSum(hid_chan, kernel_size, norm_type, is2d)
            for _ in range(depth - 1)
        )
        self.residual_conv = L.ConvNormAct(hid_chan, in_chan, 1, is2d=is2d)

    def forward(self, x):
        residual = self.gateway(x)
        # Packed-TF layout (ops/packed_tf.py), inside AVNet's packed_scope:
        # the full-resolution segment runs on packed (B, T, F*C) maps,
        # entered at the projection, left at the stride-2 downsample, the
        # pool and the residual conv. Parameters are the same.
        packed = (P.packed_enabled() and self.is2d
                  and not isinstance(x, P.PackedTF)
                  and self.kernel_size > 1 and self.stride == 2)
        x_enc = self.projection(P.PackRequest(residual) if packed else residual)
        downsampled = [self.downsample_layers[0](x_enc)]
        for layer in self.downsample_layers[1:]:
            downsampled.append(layer(downsampled[-1]))

        target = downsampled[-1].shape[2:]
        global_features = sum(
            P.adaptive_pool_from(f, *target) if isinstance(f, P.PackedTF)
            else convops.adaptive_avg_pool(f, target) for f in downsampled)
        for layer in self.globalatt:
            global_features = layer(global_features)

        x_fused = [fuse(d, global_features)
                   for fuse, d in zip(self.fusion_layers, downsampled)]
        expanded = (self.concat_layers[-1](x_fused[-2], x_fused[-1])
                    + downsampled[-2])
        for i in range(len(downsampled) - 3, -1, -1):
            expanded = self.concat_layers[i](x_fused[i], expanded) + downsampled[i]
        return self.residual_conv(expanded) + residual


class Separator(nn.Module):
    """Shared or per-repeat TDANet blocks + the residual recursion."""

    def __init__(self, in_chan=-1, hid_chan=-1, kernel_size=5, stride=2,
                 norm_type="gLN", act_type="PReLU", upsampling_depth=4,
                 layers=(), repeats=4, shared=False, is2d=False):
        super().__init__()
        self.repeats, self.shared = repeats, shared
        self.blocks = None
        if in_chan <= 0 or hid_chan <= 0:
            return

        def make():
            return TDANetBlock(in_chan, hid_chan, kernel_size, stride,
                               norm_type, act_type, upsampling_depth, layers,
                               is2d)

        self.blocks = make() if shared else nn.ModuleList(
            make() for _ in range(repeats))

    def block(self, i: int, x):
        if self.blocks is None:
            return x
        return (self.blocks if self.shared else self.blocks[i])(x)

    def forward(self, x):
        residual = x
        for i in range(self.repeats):
            x = self.block(i, x + residual if i > 0 else x)
        return x


def make_separator(params: Dict[str, Any], in_chan: int) -> Separator:
    """Separator from a reference-style config group (``audio_net`` /
    ``video_net`` name, ``layers`` as an ordered dict of dicts)."""
    p = dict(params)
    name = p.pop("audio_net", None) or p.pop("video_net", None)
    if name is None:
        return Separator(in_chan=-1, repeats=p.get("repeats", 0))
    if name != "TDANet":
        raise NotImplementedError(f"separator {name} is not ported")
    layers = p.pop("layers", {})
    layers = tuple(dict(v) for v in (
        layers.values() if isinstance(layers, Mapping) else layers))
    params_ok = inspect.signature(Separator.__init__).parameters
    kwargs = {k: v for k, v in p.items() if k in params_ok}
    return Separator(in_chan=in_chan, layers=layers, **kwargs)
