"""Load the JAX package's variables into the port.

``load_jax_params(model, variables)`` takes the ``{"params", "batch_stats"}``
tree of an ``rtfs_tpu`` module (nested dicts of numpy arrays) and fills the
parameters and buffers of the matching port module. It is the inverse of
``rtfs_tpu/utils/torch_import.py:convert_avnet`` (and, for the lip
backbone, of ``convert_frcnn_video``): the mapping follows the
port's module tree, names the flax path of each tensor, and converts the
layout (flax channels-last kernels -> torch (C_out, C_in/g, *k), and so
on). It raises on any flax leaf left unused and on any port tensor left
unfilled (BatchNorm's ``num_batches_tracked`` counter aside).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from ..models import layers as L
from ..models.attention import (GlobalAttention, MultiHeadSelfAttention,
                                MultiHeadSelfAttention2D, TorchMHA)
from ..models.avnet import ATTNFusion, AVNet, MultiModalFusion
from ..models.fusion_layers import ATTNFusionCell, InjectionMultiSum
from ..models.rnn_blocks import DualPathRNN
from ..models.separators import Separator, TDANetBlock
from ..models.video import FRCNNVideoModel
from ..ops.sru import SRU


def _conv_kernel(w):
    """flax (*k, C_in/g, C_out) -> torch (C_out, C_in/g, *k)."""
    nd = w.ndim - 2
    return w.transpose((nd + 1, nd) + tuple(range(nd)))


def _key(t, name):
    return f"{t}.{name}" if t else name


class _Filler:
    def __init__(self, variables):
        self.params = variables.get("params", {})
        self.stats = variables.get("batch_stats", {})
        self.out = {}
        self.used = set()

    def put(self, key, path, fn=None, stats=False):
        node = self.stats if stats else self.params
        for p in path:
            node = node[p]
        self.used.add((stats, *path))
        value = np.asarray(node, dtype=np.float32)
        self.out[key] = torch.from_numpy(np.array(fn(value) if fn else value,
                                                  dtype=np.float32, order="C"))

    def unused(self):
        def leaves(tree, stats, prefix):
            for k, v in tree.items():
                if isinstance(v, Mapping):
                    yield from leaves(v, stats, prefix + (k,))
                else:
                    yield (stats, *prefix, k)

        every = list(leaves(self.params, False, ())) + list(
            leaves(self.stats, True, ()))
        return [p for p in every if p not in self.used]


def _conv_norm_act(f, mod, path, t):
    """ConvNormAct / ConvActNorm ``full_layer.{slot}`` -> flax children,
    numbered per type in creation order."""
    n = {"gln": 0, "bn": 0, "prelu": 0}
    for slot, m in enumerate(mod.full_layer):
        k = f"{_key(t, 'full_layer')}.{slot}"
        if isinstance(m, L.GlobalLayerNorm):
            name = f"GlobalLayerNorm_{n['gln']}"
            n["gln"] += 1
            f.put(f"{k}.norm.weight", path + [name, "scale"])
            f.put(f"{k}.norm.bias", path + [name, "bias"])
        elif isinstance(m, L.BatchNorm):
            _bn(f, k, path + [f"BatchNorm_{n['bn']}"])
            n["bn"] += 1
        elif isinstance(m, nn.PReLU):
            f.put(f"{k}.weight", path + [f"PReLU_{n['prelu']}", "alpha"])
            n["prelu"] += 1
        elif isinstance(m, L.Conv):
            f.put(f"{k}.weight", path + ["Conv_0", "kernel"], _conv_kernel)
            if m.bias is not None:
                f.put(f"{k}.bias", path + ["Conv_0", "bias"])
        elif isinstance(m, L.LayerNormalization4D):
            _ln4d(f, m, path + ["LayerNormalization4D_0"], k)


def _ln4d(f, mod, path, t):
    """flax (1, 1, F, C) -> torch (1, C, 1, F)."""
    f.put(_key(t, "gamma"), path + ["scale"], lambda g: g.transpose(0, 3, 1, 2))
    f.put(_key(t, "beta"), path + ["bias"], lambda g: g.transpose(0, 3, 1, 2))


def _sru(f, mod, path, t):
    for layer in range(len(mod.weights)):
        f.put(_key(t, f"weights.{layer}"), path + [f"weight_{layer}"])
        f.put(_key(t, f"weight_cs.{layer}"), path + [f"weight_c_{layer}"])
        f.put(_key(t, f"biases.{layer}"), path + [f"bias_{layer}"])


def _dual_path_rnn(f, mod, path, t):
    _ln4d(f, mod.norm, path + ["LayerNormalization4D_0"], _key(t, "norm"))
    _sru(f, mod.rnn, path + ["SRU_0"], _key(t, "rnn"))
    # flax (k, C_out, C_in) -> torch ConvTranspose1d (C_in, C_out, k)
    f.put(_key(t, "linear.weight"), path + ["ConvTranspose_0", "kernel"],
          lambda w: w.transpose(2, 1, 0))
    f.put(_key(t, "linear.bias"), path + ["ConvTranspose_0", "bias"])


def _mhsa2d(f, mod, path, t):
    """flax packs the heads into one conv per Q/K/V; torch keeps per-head
    modules (``torch_import._mhsa2d``)."""
    nh = mod.n_head
    for tname, fconv, fp in (("Queries", "Conv_0", "q"), ("Keys", "Conv_1", "k"),
                             ("Values", "Conv_2", "v")):
        o = getattr(mod, tname)[0].conv.weight.shape[0]
        for h in range(nh):
            k = _key(t, f"{tname}.{h}")
            sl = slice(h * o, (h + 1) * o)
            f.put(f"{k}.conv.weight", path + [fconv, "kernel"],
                  lambda w, sl=sl: _conv_kernel(w[..., sl]))
            f.put(f"{k}.conv.bias", path + [fconv, "bias"],
                  lambda b, sl=sl: b[sl])
            f.put(f"{k}.act.weight", path + [f"{fp}_prelu"],
                  lambda a, h=h: a[h].reshape(1))
            # (nh, 1, F, E) -> per head (1, E, 1, F)
            for tn, fn in (("gamma", "scale"), ("beta", "bias")):
                f.put(f"{k}.norm.{tn}", path + [f"{fp}_ln_{fn}"],
                      lambda g, h=h: g[h].transpose(2, 0, 1)[None])
    k = _key(t, "attn_concat_proj")
    f.put(f"{k}.conv.weight", path + ["Conv_3", "kernel"], _conv_kernel)
    f.put(f"{k}.conv.bias", path + ["Conv_3", "bias"])
    f.put(f"{k}.act.weight", path + ["PReLU_0", "alpha"])
    _ln4d(f, None, path + ["LayerNormalization4D_0"], f"{k}.norm")


def _torch_mha(f, mod, path, t):
    f.put(_key(t, "in_proj_weight"), path + ["in_proj_weight"], np.transpose)
    f.put(_key(t, "in_proj_bias"), path + ["in_proj_bias"])
    f.put(_key(t, "out_proj.weight"), path + ["out_proj_weight"], np.transpose)
    f.put(_key(t, "out_proj.bias"), path + ["out_proj_bias"])


def _mhsa1d(f, mod, path, t):
    for tn, fn in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
        f.put(_key(t, f"{tn}.weight"), path + [fn, "scale"])
        f.put(_key(t, f"{tn}.bias"), path + [fn, "bias"])
    _torch_mha(f, mod.attention, path + ["TorchMHA_0"], _key(t, "attention"))


def _ffn(f, mod, path, t):
    for i, name in enumerate(("encoder", "refiner", "decoder")):
        _conv_norm_act(f, getattr(mod, name), path + [f"ConvNormAct_{i}"],
                       _key(t, name))


def _global_attention(f, mod, path, t):
    _mhsa1d(f, mod.MHSA, path + ["MultiHeadSelfAttention_0"], _key(t, "MHSA"))
    _ffn(f, mod.FFN, path + ["FeedForwardNetwork_0"], _key(t, "FFN"))


def _injection(f, mod, path, t):
    for i, name in enumerate(("local_embedding", "global_embedding",
                              "global_gate")):
        _conv_norm_act(f, getattr(mod, name), path + [f"ConvNormAct_{i}"],
                       _key(t, name))


def _tdanet_block(f, mod, path, t):
    for name in ("gateway", "projection", "residual_conv"):
        _conv_norm_act(f, getattr(mod, name), path + [name], _key(t, name))
    for group in ("downsample_layers", "globalatt", "fusion_layers",
                  "concat_layers"):
        for i, m in enumerate(getattr(mod, group)):
            _fill(f, m, path + [f"{group}_{i}"], _key(t, f"{group}.{i}"))


def _separator(f, mod, path, t):
    if mod.blocks is None:
        return
    if mod.shared:
        _tdanet_block(f, mod.blocks, path + ["blocks"], _key(t, "blocks"))
    else:
        for i, blk in enumerate(mod.blocks):
            _tdanet_block(f, blk, path + [f"blocks_{i}"], _key(t, f"blocks.{i}"))


def _attn_fusion_cell(f, mod, path, t):
    for i, name in enumerate(("key_embed", "value_embed", "attention_embed",
                              "resize")):
        _conv_norm_act(f, getattr(mod, name), path + [f"ConvNormAct_{i}"],
                       _key(t, name))


def _attn_fusion(f, mod, path, t):
    cell = 0
    if mod.video_lstm is not None:
        _attn_fusion_cell(f, mod.video_lstm, path + ["ATTNFusionCell_0"],
                          _key(t, "video_lstm"))
        cell = 1
    _attn_fusion_cell(f, mod.audio_lstm, path + [f"ATTNFusionCell_{cell}"],
                      _key(t, "audio_lstm"))


def _multimodal_fusion(f, mod, path, t):
    if mod.fusion_module is None:
        return
    if mod.fusion_shared:
        _attn_fusion(f, mod.fusion_module, path + ["fusion_module"],
                     _key(t, "fusion_module"))
    else:
        for i, m in enumerate(mod.fusion_module):
            _attn_fusion(f, m, path + [f"fusion_module_{i}"],
                         _key(t, f"fusion_module.{i}"))


def _avnet(f, mod, path, t):
    _conv_norm_act(f, mod.encoder.conv, path + ["encoder", "ConvNormAct_0"],
                   _key(t, "encoder.conv"))
    for name in ("audio_bottleneck", "video_bottleneck"):
        _conv_norm_act(f, getattr(mod, name), path + [name], _key(t, name))
    rm, rp, rt = mod.refinement_module, path + ["refinement_module"], _key(
        t, "refinement_module")
    _separator(f, rm.audio_net, rp + ["audio_net"], _key(rt, "audio_net"))
    _separator(f, rm.video_net, rp + ["video_net"], _key(rt, "video_net"))
    _multimodal_fusion(f, rm.crossmodal_fusion, rp + ["crossmodal_fusion"],
                       _key(rt, "crossmodal_fusion"))
    mg = _key(t, "mask_generator.mask_generator")
    f.put(f"{mg}.0.weight", path + ["mask_generator", "PReLU_0", "alpha"])
    _conv_norm_act(f, mod.mask_generator.mask_generator[1],
                   path + ["mask_generator", "ConvNormAct_0"], f"{mg}.1")
    dec = mod.decoder.decoder
    if isinstance(dec, L.ConvTranspose):
        # flax (kT, kF, C_out, C_in) -> torch (C_in, C_out, kT, kF)
        p = path + ["decoder", "ConvTranspose_0"]
        f.put(_key(t, "decoder.decoder.weight"), p + ["kernel"],
              lambda w: w.transpose(3, 2, 0, 1))
        if dec.bias is not None:
            f.put(_key(t, "decoder.decoder.bias"), p + ["bias"])


def _bn(f, key, path):
    """torch BatchNorm ``key`` <- flax ``L.BatchNorm`` at ``path``."""
    p = path + ["BatchNorm_0"]
    f.put(f"{key}.weight", p + ["scale"])
    f.put(f"{key}.bias", p + ["bias"])
    f.put(f"{key}.running_mean", p + ["mean"], stats=True)
    f.put(f"{key}.running_var", p + ["var"], stats=True)


def _frcnn_video(f, mod, path, t):
    """The inverse of ``torch_import.convert_frcnn_video`` (resnet)."""
    prelu = isinstance(mod.frontend3D[2], nn.PReLU)
    f.put(_key(t, "frontend3D.0.weight"), path + ["frontend_conv"],
          _conv_kernel)
    _bn(f, _key(t, "frontend3D.1"), path + ["BatchNorm_0"])
    if prelu:
        f.put(_key(t, "frontend3D.2.weight"), path + ["ChannelPReLU_0", "alpha"])
    blk = 0
    for n in range(1, 5):
        for i, block in enumerate(getattr(mod.trunk, f"layer{n}")):
            k = _key(t, f"trunk.layer{n}.{i}")
            p = path + ["ResNetTrunk_0", f"BasicBlock_{blk}"]
            f.put(f"{k}.conv1.weight", p + ["Conv_0", "kernel"], _conv_kernel)
            _bn(f, f"{k}.bn1", p + ["BatchNorm_0"])
            f.put(f"{k}.conv2.weight", p + ["Conv_1", "kernel"], _conv_kernel)
            _bn(f, f"{k}.bn2", p + ["BatchNorm_1"])
            if prelu:
                f.put(f"{k}.relu1.weight", p + ["ChannelPReLU_0", "alpha"])
                f.put(f"{k}.relu2.weight", p + ["ChannelPReLU_1", "alpha"])
            if block.downsample is not None:
                f.put(f"{k}.downsample.0.weight",
                      p + ["_ConvBN_0", "Conv_0", "kernel"], _conv_kernel)
                _bn(f, f"{k}.downsample.1", p + ["_ConvBN_0", "BatchNorm_0"])
            blk += 1


_MAPPERS = {
    FRCNNVideoModel: _frcnn_video,
    AVNet: _avnet,
    Separator: _separator,
    TDANetBlock: _tdanet_block,
    MultiModalFusion: _multimodal_fusion,
    ATTNFusion: _attn_fusion,
    ATTNFusionCell: _attn_fusion_cell,
    InjectionMultiSum: _injection,
    DualPathRNN: _dual_path_rnn,
    SRU: _sru,
    MultiHeadSelfAttention2D: _mhsa2d,
    GlobalAttention: _global_attention,
    MultiHeadSelfAttention: _mhsa1d,
    TorchMHA: _torch_mha,
    L.FeedForwardNetwork: _ffn,
    L.ConvNormAct: _conv_norm_act,
    L.ConvActNorm: _conv_norm_act,
}


def _fill(f, mod, path, t):
    if type(mod) not in _MAPPERS:
        raise NotImplementedError(f"no JAX mapping for {type(mod).__name__}")
    _MAPPERS[type(mod)](f, mod, path, t)


def load_jax_params(model: nn.Module, variables) -> nn.Module:
    """Fill ``model`` from the JAX variables of its ``rtfs_tpu`` counterpart.

    Raises ``ValueError`` on a flax leaf left unused, a port tensor left
    unfilled, or a shape mismatch. Returns ``model``.
    """
    f = _Filler(variables)
    _fill(f, model, [], "")
    unused = f.unused()
    if unused:
        raise ValueError(f"unused JAX leaves: {unused[:10]}")
    own = model.state_dict()
    missing = [k for k in own
               if k not in f.out and not k.endswith("num_batches_tracked")]
    extra = [k for k in f.out if k not in own]
    if missing or extra:
        raise ValueError(f"unfilled port tensors {missing[:10]}, "
                         f"unknown keys {extra[:10]}")
    for k, v in f.out.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    own.update(f.out)
    model.load_state_dict(own)
    return model
