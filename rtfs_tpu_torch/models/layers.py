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

Dtypes follow JAX's (``utils/precision.py``): a conv casts its input to
its weight's dtype, the norms take float32 statistics and round the
normalised map to the input's dtype before the affine, and everything
else computes in the promotion of its operands, so a bf16 model (its
parameters cast by ``cast_params``) computes in bf16.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import convops
from ..ops import packed_tf as P


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


def _stats_dtype(x: torch.Tensor) -> torch.Tensor:
    """x widened to float32 where it is bf16: the norms take their
    statistics and normalise in float32 (``rtfs_tpu/models/layers.py:
    214-220,236-240,275-285``), then round to x's dtype."""
    return x.float() if x.dtype == torch.bfloat16 else x


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
        if isinstance(x, P.PackedTF):
            return P.PackedTF(P.gln_packed(x.data, self.norm.weight,
                                           self.norm.bias, x.f, self.norm.eps),
                              x.f, x.c)
        xf = _stats_dtype(x)
        var, mean = torch.var_mean(xf.reshape(x.shape[0], -1), dim=1,
                                   unbiased=False)
        shape = (-1,) + (1,) * (x.ndim - 1)
        scale = torch.rsqrt(var + self.norm.eps).reshape(shape)
        affine = (1, -1) + (1,) * (x.ndim - 2)
        norm = ((xf - mean.reshape(shape)) * scale).to(x.dtype)
        return (norm * self.norm.weight.reshape(affine)
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
        xf = _stats_dtype(x)
        mean = xf.mean(dim=self.dims, keepdim=True)
        var = xf.var(dim=self.dims, unbiased=False, keepdim=True)
        norm = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return norm * self.gamma + self.beta


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

    A bf16 input (a bf16 model, ``utils/precision.py``) follows flax: in
    train mode the statistics are taken and the input normalised in
    float32, the result rounded to bf16 once, and the running statistics
    become float32 (flax's update promotes the bf16 ``batch_stats``). In
    eval mode with float32 statistics the input is normalised in float32
    and rounded once; with bf16 statistics (serving) as torch's
    ``batch_norm`` does.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm expects rank >= 2, got {x.dim()}")

    def _normalize(self, x, xf, mean, var):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        return ((xf - mean.reshape(shape)) * scale.reshape(shape)
                + self.bias.to(xf.dtype).reshape(shape)).to(x.dtype)

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            if x.dtype == self.running_mean.dtype:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            dt = torch.promote_types(x.dtype, self.running_mean.dtype)
            return self._normalize(x, x.to(dt), self.running_mean.to(dt),
                                   self.running_var.to(dt))
        xf = _stats_dtype(x)
        var, mean = torch.var_mean(xf, dim=[0, *range(2, x.ndim)],
                                   unbiased=False)
        with torch.no_grad():
            if self.running_mean.dtype == xf.dtype:
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            else:  # bf16 statistics: replaced by float32 ones
                self.running_mean = torch.lerp(
                    self.running_mean.to(xf.dtype), mean, self.momentum)
                self.running_var = torch.lerp(
                    self.running_var.to(xf.dtype), var, self.momentum)
            self.num_batches_tracked.add_(1)
        return self._normalize(x, xf, mean, var)


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
        if isinstance(x, (P.PackedTF, P.PackRequest)):
            return self._packed_call(x)
        return convops.conv(x.to(self.weight.dtype), self.weight,
                            stride=self.stride,
                            padding=self.padding, dilation=self.dilation,
                            groups=self.groups, bias=self.bias)

    def _packed_call(self, x):
        """Packed-TF dispatch (``rtfs_tpu/models/layers.py:_packed_call``):
        the same parameters through the packed kernels, for exactly the
        convs of the RTFS block's full-resolution segment; the input cast
        to the weight's dtype first, as every conv casts it (bf16
        serving)."""
        out_chan, kernel = self.weight.shape[0], tuple(self.weight.shape[2:])
        in_chan = self.weight.shape[1] * self.groups
        stride = self.stride
        stride = stride[0] if hasattr(stride, "__len__") else stride
        if self.dilation not in (1, (1, 1)):
            raise NotImplementedError("packed_tf: dilation unsupported")
        pointwise = (len(kernel) == 2 and self.groups == 1
                     and all(k == 1 for k in kernel) and stride == 1)
        w1x1 = self.weight[:, :, 0, 0].t() if pointwise else None
        if isinstance(x, P.PackRequest):
            # packed-world entry: 1x1 dense projection, emit packed
            if not pointwise:
                raise NotImplementedError(
                    f"packed_tf: a packed projection needs a 2-D 1x1 dense "
                    f"conv, got k={kernel} groups={self.groups}")
            out = P.pw_proj_packed(x.data.to(self.weight.dtype), w1x1,
                                   self.bias)
            return P.PackedTF(out, x.shape[3], out_chan)
        xd = x.data.to(self.weight.dtype)
        if pointwise:
            # 1x1 dense on a packed map: packed-world exit to rank-4
            return P.pw_unproj_packed(xd, w1x1, self.bias, x.f)
        if (self.groups == in_chan == out_chan and len(kernel) == 2
                and all(k > 1 for k in kernel)):
            # depthwise kT x kF conv (stride 1 'same' or stride-2 int pad)
            kt, kf = kernel
            if self.padding == "same":
                pads_t, pads_f = convops.same_pads(kernel, (1, 1))
            elif isinstance(self.padding, int):
                pads_t = pads_f = (self.padding, self.padding)
            else:
                raise NotImplementedError(f"packed_tf: padding {self.padding}")
            out = P.dw_conv_packed(xd, self.weight[:, 0].permute(1, 2, 0),
                                   self.bias, x.f, x.c, pads_t, pads_f)
            _, _, t, f = x.shape
            t_conv, f_conv = P.dw_geometry(t, f, kt, kf, pads_t, pads_f)
            y = P.PackedTF(out, f_conv, x.c)
            if stride == 1:
                return y
            if stride == 2:
                # torch output size, then select conv_s1[2 i]
                return P.dw_stride2_from(y, (t_conv - 1) // 2 + 1,
                                         (f_conv - 1) // 2 + 1)
        raise NotImplementedError(
            f"packed_tf: conv k={kernel} groups={self.groups} "
            f"stride={self.stride} has no packed lowering")


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
            x.to(self.weight.dtype), self.weight, stride=self.stride,
            padding=self.padding,
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
        if not isinstance(x, (P.PackedTF, P.PackRequest)):
            return self.full_layer(x)
        for layer in self.full_layer:
            x = _packed_apply(layer, x)
        return x


# activations that act elementwise, so on a packed map's data directly
_ELEMENTWISE = (nn.ReLU, nn.Tanh, nn.Sigmoid, nn.GELU, nn.SiLU)


def _packed_apply(layer: nn.Module, x):
    """One slot of a ConvNormAct on a packed map or a pack request
    (``rtfs_tpu/models/layers.py:_apply_norm`` / ``_apply_act``): the conv
    and gLN take it, an elementwise activation runs on the data, anything
    else raises. A plain tensor (after a packed-world exit) goes through
    as usual."""
    if not isinstance(x, (P.PackedTF, P.PackRequest)) or isinstance(
            layer, (nn.Identity, Conv)):
        return layer(x)
    if isinstance(x, P.PackedTF):
        if isinstance(layer, GlobalLayerNorm):
            return layer(x)
        if isinstance(layer, _ELEMENTWISE) or (
                isinstance(layer, nn.PReLU) and layer.num_parameters == 1):
            return P.PackedTF(layer(x.data), x.f, x.c)
    raise NotImplementedError(
        f"packed_tf: {type(layer).__name__} on a "
        f"{'packed map' if isinstance(x, P.PackedTF) else 'pack request'}")


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
