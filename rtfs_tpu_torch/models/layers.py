"""Core layers: norms, activations, conv blocks (channels-first).

Counterpart of ``rtfs_tpu/models/layers.py``. Maps are (B, C, T) and
(B, C, T, F). Parameter names are the reference PyTorch names that
``rtfs_tpu/utils/torch_import.py`` reads: a ``ConvNormAct`` holds
``full_layer = Sequential(pre_norm, pre_act, conv, norm, act)`` with
``nn.Identity`` in the empty slots, gLN wraps ``norm = GroupNorm(1, C)``,
LN4D holds ``gamma``/``beta``.

Weights are drawn by ``init_weights(generator)`` on each module that has
random parameters (torch's default schemes, xavier where the reference
asks), so a model is reproducible from one explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import convops


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


# --------------------------------------------------------------------------
# Dropout: masks from the train step's generator
# --------------------------------------------------------------------------

def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every dropout and DropPath of ``model`` draws its masks from
    ``generator`` (the train step's, as ``rngs={"dropout": rng}`` feeds the
    JAX model)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): identity in eval mode. In
    train mode its mask comes from ``self.generator`` (set by
    ``set_dropout_generator``); there is no implicit global generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x):
        return x.shape

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode needs a generator: "
                               "call layers.set_dropout_generator first")
        keep = 1.0 - self.rate
        gen = self.generator
        mask = torch.rand(self.mask_shape(x), generator=gen,
                          device=gen.device) < keep
        return x * mask.to(device=x.device, dtype=x.dtype) / keep


class DropPath(Dropout):
    """timm DropPath (``rtfs_tpu/models/layers.py:DropPath``): drops the
    whole residual branch per sample in train mode."""

    def mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.ndim - 1)


# --------------------------------------------------------------------------
# Normalisations
# --------------------------------------------------------------------------


class GlobalLayerNorm(nn.Module):
    """gLN: GroupNorm with one group (stats over every non-batch axis).

    ``norm`` holds the affine parameters under the reference's names. The
    statistics come from ``torch.var_mean`` over each flattened sample, not
    from ``nn.GroupNorm``'s CUDA kernel, which reduces a whole sample in one
    block (43% of the bs-8 forward on an H100, PERF.md).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.GroupNorm(1, features, eps=eps)

    def forward(self, x):
        var, mean = torch.var_mean(x.reshape(x.shape[0], -1), dim=1,
                                   unbiased=False)
        shape = (-1,) + (1,) * (x.ndim - 1)
        scale = torch.rsqrt(var + self.norm.eps).reshape(shape)
        affine = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean.reshape(shape)) * scale
                * self.norm.weight.reshape(affine)
                + self.norm.bias.reshape(affine))


class LayerNormalization4D(nn.Module):
    """Per-(C, F) affine LayerNorm over (B, C, T, F).

    ``n_freqs == 1``: stats over C, affine (1, C, 1, 1). ``n_freqs > 1``:
    stats over (C, F), affine (1, C, 1, F). Biased variance, eps 1e-5.
    """

    def __init__(self, features: int, n_freqs: int = 1, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.dims = (1, 3) if n_freqs > 1 else (1,)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, n_freqs))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, n_freqs))

    def forward(self, x):
        mean = x.mean(dim=self.dims, keepdim=True)
        var = x.var(dim=self.dims, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over channel axis 1 for any rank >= 2, with flax's
    train-mode update.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch mean and biased variance and moves the running
    statistics as flax's ``nn.BatchNorm(momentum=0.9)`` behind
    ``rtfs_tpu/models/layers.py:BatchNorm`` does: ``running = 0.9 * running
    + 0.1 * batch`` with the BIASED batch variance (torch's own BatchNorm
    puts the unbiased variance into ``running_var``). Names and buffers are
    torch's (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``).
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm expects rank >= 2, got {x.dim()}")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=[0, *range(2, x.ndim)],
                                   unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * scale.reshape(shape)
                + self.bias.reshape(shape))


def make_norm(norm_type: Optional[str], features: int, n_freqs: int = -1):
    """Norm registry; ``None`` -> ``nn.Identity``."""
    if not norm_type:
        return nn.Identity()
    if norm_type == "gLN":
        return GlobalLayerNorm(features)
    if norm_type in ("LayerNormalization4D", "LN4d"):
        return LayerNormalization4D(features, n_freqs=max(n_freqs, 1))
    if norm_type in ("BatchNorm1d", "BatchNorm2d", "BatchNorm3d"):
        return BatchNorm(features)
    raise ValueError(f"Unknown normalization: {norm_type}")


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

_ACTIVATIONS = {
    "ReLU": nn.ReLU,
    "PReLU": nn.PReLU,  # one shared slope, init 0.25
    "Tanh": nn.Tanh,
    "Sigmoid": nn.Sigmoid,
    "GELU": nn.GELU,
    "SiLU": nn.SiLU,
    "Softmax": lambda: nn.Softmax(dim=1),  # over channels
}


def make_act(act_type: Optional[str]) -> nn.Module:
    if not act_type:
        return nn.Identity()
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {act_type}")
    return _ACTIVATIONS[act_type]()


# --------------------------------------------------------------------------
# Conv blocks
# --------------------------------------------------------------------------


def _kernel(ks, nd):
    return tuple(ks) if hasattr(ks, "__len__") else (ks,) * nd


class Conv(nn.Module):
    """Grouped 1-D/2-D conv with torch 'same' padding; weight
    (C_out, C_in/groups, *k)."""

    def __init__(self, in_chan, out_chan, kernel_size, stride=1, groups=1,
                 dilation=1, padding: Any = "same", bias=True,
                 xavier_init=False, nd=1):
        super().__init__()
        k = _kernel(kernel_size, nd)
        self.stride, self.groups = stride, groups
        self.dilation, self.padding = dilation, padding
        self.xavier_init = xavier_init
        self.weight = nn.Parameter(torch.empty(out_chan, in_chan // groups, *k))
        self.bias = nn.Parameter(torch.empty(out_chan)) if bias else None

    def init_weights(self, generator):
        w = self.weight
        receptive = math.prod(w.shape[2:])
        fan_in = w.shape[1] * receptive
        if self.xavier_init:
            bound = math.sqrt(6.0 / (fan_in + w.shape[0] * receptive))
        else:  # kaiming_uniform(a=sqrt(5))
            bound = math.sqrt(1.0 / fan_in)
        uniform_(w, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x):
        return convops.conv(x, self.weight, stride=self.stride,
                            padding=self.padding, dilation=self.dilation,
                            groups=self.groups, bias=self.bias)


class ConvTranspose(nn.Module):
    """torch ConvTranspose1d/2d; weight (C_in, C_out/groups, *k)."""

    def __init__(self, in_chan, out_chan, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, bias=True, xavier_init=False,
                 nd=1):
        super().__init__()
        k = _kernel(kernel_size, nd)
        self.stride, self.padding = stride, padding
        self.output_padding, self.groups = output_padding, groups
        self.xavier_init = xavier_init
        self.weight = nn.Parameter(torch.empty(in_chan, out_chan // groups, *k))
        self.bias = nn.Parameter(torch.empty(out_chan)) if bias else None

    def init_weights(self, generator):
        w = self.weight
        receptive = math.prod(w.shape[2:])
        fan_in = w.shape[1] * receptive  # torch reads dim 1 as fan-in here
        if self.xavier_init:
            bound = math.sqrt(6.0 / (fan_in + w.shape[0] * receptive))
        else:
            bound = math.sqrt(1.0 / fan_in)
        uniform_(w, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x):
        return convops.conv_transpose(
            x, self.weight, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding, groups=self.groups,
            bias=self.bias,
        )


class ConvNormAct(nn.Module):
    """pre_norm -> pre_act -> conv -> norm -> act (reference conv_layers.py:65).

    ``kernel_size <= 0``: the conv is the identity and out_chan := in_chan.
    """

    def __init__(self, in_chan, out_chan, kernel_size, stride=1, groups=1,
                 dilation=1, padding=None, pre_norm_type=None,
                 pre_act_type=None, norm_type=None, act_type=None,
                 xavier_init=False, bias=True, is2d=False):
        super().__init__()
        out_chan = out_chan if kernel_size > 0 else in_chan
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2 if stride > 1 else "same"
        conv = (
            Conv(in_chan, out_chan, kernel_size, stride=stride, groups=groups,
                 dilation=dilation, padding=padding, bias=bias,
                 xavier_init=xavier_init, nd=2 if is2d else 1)
            if kernel_size > 0 else nn.Identity()
        )
        self.full_layer = nn.Sequential(
            make_norm(pre_norm_type, in_chan),
            make_act(pre_act_type),
            conv,
            make_norm(norm_type, out_chan),
            make_act(act_type),
        )

    def forward(self, x):
        return self.full_layer(x)


class ConvActNorm(nn.Module):
    """conv -> act -> norm (reference conv_layers.py:142); stride > 1 means
    padding 0. Not on the RTFS-Net path; kept for the legacy layers."""

    def __init__(self, in_chan, out_chan, kernel_size, stride=1, groups=1,
                 dilation=1, norm_type=None, act_type=None, n_freqs=-1,
                 xavier_init=False, bias=True, is2d=False):
        super().__init__()
        conv = (
            Conv(in_chan, out_chan, kernel_size, stride=stride, groups=groups,
                 dilation=dilation, padding=0 if stride > 1 else "same",
                 bias=bias, xavier_init=xavier_init, nd=2 if is2d else 1)
            if kernel_size > 0 else nn.Identity()
        )
        self.full_layer = nn.Sequential(
            conv, make_act(act_type),
            make_norm(norm_type, out_chan, n_freqs=n_freqs),
        )

    def forward(self, x):
        return self.full_layer(x)


class FeedForwardNetwork(nn.Module):
    """Conv FFN: 1x1 -> depthwise k -> DropPath -> 1x1 -> DropPath,
    residual (conv_layers.py:218; ``rtfs_tpu/models/layers.py:804-810``).
    The DropPaths hold no parameters and are the identity in eval mode."""

    def __init__(self, in_chan, hid_chan, kernel_size=5, norm_type="gLN",
                 act_type="ReLU", dropout=0.0, is2d=False):
        super().__init__()
        self.encoder = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.refiner = ConvNormAct(hid_chan, hid_chan, kernel_size,
                                   groups=hid_chan, act_type=act_type,
                                   is2d=is2d)
        self.decoder = ConvNormAct(hid_chan, in_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.drop_path = DropPath(dropout)

    def forward(self, x):
        y = self.drop_path(self.refiner(self.encoder(x)))
        return self.drop_path(self.decoder(y)) + x
