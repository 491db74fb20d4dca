"""Packed time-frequency layout: kernels K5-K9 and the packed carriers.

Counterpart of ``rtfs_tpu/ops/packed_tf.py``, forward and backward. A
packed map is ``(B, T, F*C)`` with the channel fastest, exactly the JAX
packed layout; the port's rank-4 maps are channels-first ``(B, C, T, F)``,
so the rank-4 side of K6-K9 is that layout. On this card the packed form
is plain channels-last storage: the TPU's reason for it (64-channel minor dims
padded to 128 lanes) does not exist here, and the port keeps it because
the JAX package's packed path runs through these ops.

- ``dw_conv_packed`` (K5): depthwise kT x kF conv, packed -> packed,
  stride 1, static (lo, hi) pads; CUDA ``dw_conv_packed_fwd``, a thread's
  taps and accumulators in registers over a ring of input rows
  (``dw_conv_geometry``).
- ``pw_proj_packed`` (K6): 1x1 dense conv, rank-4 -> packed, + bias; CUDA
  ``pw_proj_packed_fwd``, a 3xTF32 tensor-core product with W resident
  and x streamed (``pw_proj_geometry``; W held 256 k at a time).
- ``pw_unproj_packed`` (K7): 1x1 dense conv, packed -> rank-4, + bias;
  CUDA ``pw_unproj_packed_fwd``, K6's 3xTF32 product turned round
  (``pw_unproj_geometry``).
- ``spatial_down_packed`` (K8): separable static map, packed -> rank-4
  (adaptive average pool, stride-2 select); CUDA
  ``spatial_down_packed_fwd``.
- ``spatial_up_packed`` (K9): separable static map, rank-4 -> packed
  (torch-nearest upsample); CUDA ``spatial_up_packed_fwd``.

The backward (the JAX custom VJPs) reuses the forward kernels and adds
two weight-gradient kernels:

- K5: dx is K5 on the cotangent with the taps flipped and complementary
  pads; dW is ``dw_conv_packed_wgrad`` (CUDA ``dw_conv_packed_wgrad``).
- K6 / K7: dx of K6 is K7 with ``w.t()`` and dx of K7 is K6; dW of both
  is ``pw_packed_wgrad`` (CUDA ``pw_packed_wgrad``), a 3xTF32 tensor-core
  product over chunks of positions, one partial a chunk
  (``pw_wgrad_geometry``).
- K8 / K9: each map's transpose (``SpatialMap.transposed``) is its VJP,
  so dx of K8 is K9 and dx of K9 is K8, one launch each.
- Biases: a plain sum of the cotangent.

When autograd records (grad enabled and an input requires grad) an op runs
through its ``torch.autograd.Function`` on either device. The device picks
the implementation, forward and backward: on a CPU tensor the plain
PyTorch versions run, on a CUDA tensor the kernels launch or the call
raises.

The ops also take bf16 storage, forward and backward (the Pallas kernels
run in the caller's dtype: a bf16 packed model serves and trains in
bf16): x, w, bias and the output in bf16, the sums in float32, each output
rounded once (CUDA entries ``*_fwd_bf16``; K6 and K7 on the bf16 tensor
cores, ``mma.sync`` m16n8k16, ``pw_proj16_geometry``). K8's and K9's
rank-4 side is bf16 too: JAX's float32 rank-4 block is a workaround for
Mosaic on v5e, and bf16 in, float32 inside, bf16 out gives the same
values. On the card x, w and bias are of one dtype (a mixed call raises;
nothing is cast to reach the float32 kernel). A bf16 backward runs as JAX's
custom VJPs do in the cotangent's dtype: each dx is the bf16 forward entry
on the cotangent (K9 through a transposed pool map rounds each source's
term and adds the terms in bf16, as JAX sums one single-source pass a
source); the weight gradients read the bf16 operands and write float32
(``*_wgrad_bf16``), which is folded or transposed in float32 and rounded
once to the weight's dtype; a bias gradient is the cotangent summed in
float32, rounded once.

The model layers dispatch on ``PackedTF`` (a packed map flowing through a
module) and ``PackRequest`` (a rank-4 map handed to the 1x1 projection
that enters the packed world), inside ``packed_scope(True)``, which
``AVNet`` opens when its ``packed_tf`` switch is on.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import kernel_lib
from .sru_fused import arithmetic_dtype

_DTYPES = (torch.float32, torch.bfloat16)

# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def pack_tf(x4: torch.Tensor) -> torch.Tensor:
    """(B, C, T, F) -> packed (B, T, F*C)."""
    b, c, t, f = x4.shape
    return x4.permute(0, 2, 3, 1).reshape(b, t, f * c)


def unpack_tf(xp: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """Packed (B, T, F*C) -> (B, C, T, F)."""
    b, t, n = xp.shape
    if n != f * c:
        raise ValueError(f"unpack_tf: {n} columns are not F {f} x C {c}")
    return xp.reshape(b, t, f, c).permute(0, 3, 1, 2)


def gln_packed(xp, gamma, beta, f: int, eps: float = 1e-5):
    """GlobalLayerNorm on a packed map: statistics over (T, F*C) of each
    batch row (gLN's statistics), the per-channel affine broadcast over the
    innermost C. A bf16 map's statistics and normalised values are float32
    (the standard path's, ``layers.GlobalLayerNorm``), rounded to bf16
    before the affine in bf16, as ``rtfs_tpu/ops/packed_tf.py:gln_packed``
    does."""
    b, t, n = xp.shape
    c = n // f
    xf = xp.to(arithmetic_dtype(xp.dtype))
    var, mean = torch.var_mean(xf.reshape(b, -1), dim=1, unbiased=False)
    scale = torch.rsqrt(var + eps).reshape(b, 1, 1, 1)
    y = ((xf.reshape(b, t, f, c) - mean.reshape(b, 1, 1, 1)) * scale).to(
        xp.dtype)
    return (y * gamma + beta).reshape(b, t, n)


def _check_cuda(name: str, x, w=None, bias=None) -> torch.dtype:
    """Raise unless x (and bias) are contiguous on one CUDA device, all
    float32 or all bf16, and w (read through its strides) is of that dtype
    there too; returns the dtype."""
    dt = kernel_lib.check_cuda(name, *[t for t in (x, bias) if t is not None],
                               dtypes=_DTYPES)
    if w is not None and (w.device != x.device or w.dtype != dt):
        raise TypeError(f"{name}: w must be {str(dt)[6:]} on {x.device}, "
                        f"got {str(w.dtype)[6:]} on {w.device}")
    return dt


def _records(*tensors) -> bool:
    """True when autograd would record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _bias_grad(g, dims, dtype):
    """A bias's gradient: the cotangent ``g`` summed over ``dims`` in its
    arithmetic dtype, rounded once to ``dtype`` (the weight's, as JAX)."""
    return g.to(arithmetic_dtype(g.dtype)).sum(dims).to(dtype)


def _wide(*tensors):
    """The tensors in their arithmetic dtype (bf16 widened to float32, the
    others as they are; None stays None), each rounded first to the first
    one's dtype, as the JAX ops cast w and bias to x's."""
    dt = tensors[0].dtype
    ad = arithmetic_dtype(dt)
    return tuple(None if t is None else t.to(dt).to(ad) for t in tensors)


# ---------------------------------------------------------------------------
# K5: depthwise conv, packed -> packed
# ---------------------------------------------------------------------------
#
# out[b, t, f*C + c] = bias[c] + sum_{dt, df} w[dt, df, c]
#                      * x[b, t + dt - pt_lo, (f + df - pf_lo)*C + c]
# with x = 0 outside [0, T_in) x [0, F_in).


def dw_geometry(t_in, f_in, kt, kf, pads_t, pads_f):
    """Output (T, F) of a stride-1 conv with (lo, hi) pads."""
    return (t_in + pads_t[0] + pads_t[1] - kt + 1,
            f_in + pads_f[0] + pads_f[1] - kf + 1)


def dw_conv_packed_plain(xp, w, bias, f_in, c, pads_t, pads_f):
    """Explicit tap loop over the zero-padded (B, T, F, C) view; in bf16
    storage over the widened values, the output rounded once."""
    dtype = xp.dtype
    xp, w, bias = _wide(xp, w, bias)
    b, t_in, _ = xp.shape
    kt, kf, _ = w.shape
    t_out, f_out = dw_geometry(t_in, f_in, kt, kf, pads_t, pads_f)
    x4 = F.pad(xp.reshape(b, t_in, f_in, c),
               (0, 0, pads_f[0], pads_f[1], pads_t[0], pads_t[1]))
    out = 0.0
    for dt in range(kt):
        for df in range(kf):
            out = out + w[dt, df] * x4[:, dt:dt + t_out, df:df + f_out]
    if bias is not None:
        out = out + bias
    return out.reshape(b, t_out, f_out * c).to(dtype)


def dw_conv_packed_wgrad_plain(xp, g, f_in, c, kt_kf, pads_t, pads_f):
    """dW (kT, kF, C) of K5, tap by tap over the zero-padded (B, T, F, C)
    view: dW[dt, df] = sum_{b,t,f} g[b,t,f] * x[b, t+dt-pt_lo, f+df-pf_lo]."""
    b, t_out, n_out = g.shape
    f_out = n_out // c
    x4 = F.pad(xp.reshape(b, xp.shape[1], f_in, c),
               (0, 0, pads_f[0], pads_f[1], pads_t[0], pads_t[1]))
    g4 = g.reshape(b, t_out, f_out, c)
    return torch.stack([
        torch.stack([torch.einsum("btfc,btfc->c", g4,
                                  x4[:, dt:dt + t_out, df:df + f_out])
                     for df in range(kt_kf[1])])
        for dt in range(kt_kf[0])])


# K5-wgrad's kernel, ``kWg*`` in csrc/packed_tf.cu: WGRAD_THREADS threads
# a block (the most with the presets' 4 x 4 taps as template arguments),
# WGRAD_MAX_THREADS at most; a thread's window of WGRAD_TAPS taps along f;
# blocks of at most WGRAD_QUADS channel quads (64 channels) and segments
# of at most WGRAD_POS positions a thread
WGRAD_THREADS, WGRAD_MAX_THREADS = 256, 1024
WGRAD_TAPS = 4
WGRAD_QUADS = 16
WGRAD_POS = 12


def dw_wgrad_smem(kt: int, kf: int, qb: int, s: int, p: int,
                  elem: int = 4) -> int:
    """K5-wgrad's shared bytes (``wgrad_smem_floats`` in the source, and
    ``wgrad_smem_bytes_bf16`` for ``elem`` 2): the ring of kt + 2 x rows of
    s p + WGRAD_TAPS G - 1 positions and 3 g rows of s p positions, qb
    chunks of 4 values of ``elem`` bytes a position (G = ceil(kf /
    WGRAD_TAPS) tap groups), or the end's exchange of 16 float32 sums a
    thread if larger."""
    groups = -(-kf // WGRAD_TAPS)
    ft = s * p
    ring = ((kt + 2) * (ft + WGRAD_TAPS * groups - 1) + 3 * ft) * qb
    return max(4 * elem * ring, 4 * qb * groups * kt * s * 16)


@functools.lru_cache(maxsize=None)
def dw_wgrad_geometry(b: int, c: int, t_out: int, f_out: int, kt: int,
                      kf: int, elem: int = 4) -> dict:
    """K5-wgrad's launch, as ``dw_conv_packed_wgrad`` runs it: a thread
    owns a channel quad, a tap row and a group of WGRAD_TAPS taps (``units``
    = qb quads x kt x G a block) and a segment of ``p`` positions of the f
    tile (``s`` segments, ``ft`` = s p positions, ``tiles_f`` tiles); a
    block owns the tile, ``qb`` quads (``blocks_c`` channel blocks) and a
    run of the b * t_out output rows. ``runs`` blocks a tile and channel
    block, so that the grid (runs, tiles_f, blocks_c) is one wave of
    ``per_sm`` blocks an SM; ``parts`` = runs * tiles_f partials. ``p``
    splits f_out evenly over the tiles' segments and is halved while the
    ring does not fit one block. Raises ValueError where no block takes
    the taps (kt G above WGRAD_MAX_THREADS, or the ring of 1 position a
    thread above one block's shared memory). ``elem``: the operands' bytes
    a value (2 for bf16, whose ring is half the bytes)."""
    if min(b, c, t_out, f_out, kt, kf) < 1:
        raise ValueError(f"dw_conv_packed_wgrad: B {b}, C {c}, T {t_out}, "
                         f"F {f_out}, taps {kt} x {kf}")
    groups = -(-kf // WGRAD_TAPS)
    quads = -(-c // 4)
    qb = min(quads, WGRAD_QUADS, max(1, WGRAD_MAX_THREADS // (kt * groups)))
    units = qb * kt * groups
    if units > WGRAD_MAX_THREADS:
        raise ValueError(f"dw_conv_packed_wgrad: {kt} x {kf} taps need "
                         f"{units} threads a block")
    s = max(1, min(WGRAD_THREADS // units, -(-f_out // WGRAD_POS)))
    p = WGRAD_POS
    while True:
        tiles_f = -(-f_out // (s * p))
        p = -(-f_out // (tiles_f * s))
        smem = dw_wgrad_smem(kt, kf, qb, s, p, elem)
        if smem <= kernel_lib.SMEM_PER_BLOCK or p == 1:
            break
        p = -(-p // 2)
    if smem > kernel_lib.SMEM_PER_BLOCK:
        raise ValueError(f"dw_conv_packed_wgrad: {kt} x {kf} taps need "
                         f"{smem} bytes of shared memory a block")
    threads = units * s
    blocks_c = -(-quads // qb)
    per_sm = max(1, min(kernel_lib.SMEM_PER_SM // (smem + 1024),
                        2048 // threads, 32))  # 32 blocks an SM at most
    runs = max(1, min(b * t_out,
                      per_sm * kernel_lib.SMS // (tiles_f * blocks_c)))
    return {"qb": qb, "units": units, "s": s, "p": p, "ft": s * p,
            "tiles_f": tiles_f, "blocks_c": blocks_c, "threads": threads,
            "runs": runs, "grid": (runs, tiles_f, blocks_c),
            "parts": runs * tiles_f, "per_sm": per_sm, "smem": smem}


def dw_wgrad_launch_ints(b, t_in, f_in, c, t_out, f_out, kt_kf, pads_t,
                         pads_f, elem: int = 4) -> tuple:
    """The ints of K5-wgrad's launch: the shapes, taps, low pads, then
    ``dw_wgrad_geometry``'s qb, s, p, runs and parts."""
    geo = dw_wgrad_geometry(b, c, t_out, f_out, *kt_kf, elem)
    return (b, t_in, f_in, c, t_out, f_out, *kt_kf, pads_t[0], pads_f[0],
            geo["qb"], geo["s"], geo["p"], geo["runs"], geo["parts"])


def dw_conv_packed_wgrad(xp, g, f_in: int, c: int, kt_kf, pads_t, pads_f):
    """The weight gradient of ``dw_conv_packed`` (``_dw_conv_wgrad_impl``
    folded over F): (kT, kF, C) from the input xp (B, T_in, F_in*C) and
    the output's cotangent g (B, T_out, F_out*C); float32 on bf16
    operands (their products and sums float32, as JAX's kernel), else in
    their dtype."""
    if xp.device.type == "cpu":
        ad = arithmetic_dtype(xp.dtype)
        return dw_conv_packed_wgrad_plain(xp.to(ad), g.to(ad), f_in, c,
                                          kt_kf, pads_t, pads_f)
    dt = kernel_lib.check_cuda("dw_conv_packed_wgrad", xp, g, dtypes=_DTYPES)
    b, t_in, _ = xp.shape
    t_out, n_out = g.shape[1:]
    ints = dw_wgrad_launch_ints(b, t_in, f_in, c, t_out, n_out // c, kt_kf,
                                pads_t, pads_f, xp.element_size())
    partial = torch.empty(ints[-1], kt_kf[0] * kt_kf[1] * c,
                          device=xp.device)
    out = torch.empty(kt_kf[0], kt_kf[1], c, device=xp.device)
    kernel_lib.launch(
        "packed_tf", kernel_lib.entry("dw_conv_packed_wgrad", dt),
        xp.device,
        xp.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        *ints)
    return out


# K5's kernel, ``kDw*`` in csrc/packed_tf.cu: blocks of at most DW_QUADS
# channel quads (64 channels) and DW_THREADS threads; input rows in flight
# ahead of the row a step takes; the taps as template arguments at DW_FIXED
DW_QUADS, DW_THREADS, DW_AHEAD = 16, 256, 4
DW_FIXED = (4, 4)
DW_BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__


def dw_conv_smem(kt: int, kf: int, qb: int, ft: int, fixed: bool) -> int:
    """K5's shared bytes (``dw_smem_floats`` in the source): the (kt kf,
    qb) tap chunks, then the ring of ``nr`` input rows of ft + kf - 1
    positions, qb 16-byte chunks a position; nr = DW_AHEAD + 1 with the
    taps as template arguments, DW_AHEAD + kt otherwise."""
    nr = DW_AHEAD + (1 if fixed else kt)
    return 16 * qb * (kt * kf + nr * (ft + kf - 1))


@functools.lru_cache(maxsize=None)
def dw_conv_geometry(b: int, c: int, t_out: int, f_out: int, kt: int,
                     kf: int) -> dict:
    """K5's launch, as ``dw_conv_packed_fwd`` runs it: a block of (``qb``
    quads, ``ft`` positions) threads owns ``qb`` channel quads (``blocks_c``
    channel blocks), an f tile of ``ft`` positions (``tiles_f`` tiles, split
    evenly) and a run of the output rows of one batch row (``runs`` a tile,
    batch row and channel block, the rows split evenly); ``grid`` (runs,
    tiles_f, b blocks_c) is about DW_BLOCKS_PER_SM blocks an SM. ``fixed``:
    the taps are the template's (registers); ``slots`` the ring's rows.
    Where wide taps' ring and taps do not fit one block's shared memory,
    the block takes fewer positions, then fewer quads. Raises ValueError
    on an empty output and where even one quad at one position does not
    fit."""
    if min(b, c, t_out, f_out, kt, kf) < 1:
        raise ValueError(f"dw_conv_packed: B {b}, C {c}, T {t_out}, "
                         f"F {f_out}, taps {kt} x {kf}")
    fixed = (kt, kf) == DW_FIXED
    limit = kernel_lib.SMEM_PER_BLOCK
    quads = -(-c // 4)
    # the shared bytes grow linearly in qb and in ft
    qb = min(quads, DW_QUADS, limit // dw_conv_smem(kt, kf, 1, 1, fixed))
    if qb < 1:
        raise ValueError(f"dw_conv_packed: {kt} x {kf} taps need "
                         f"{dw_conv_smem(kt, kf, 1, 1, fixed)} bytes of "
                         "shared memory a block")
    nr = DW_AHEAD + (1 if fixed else kt)
    ft_fit = (limit // (16 * qb) - kt * kf) // nr - kf + 1
    tiles_f = -(-f_out // min(DW_THREADS // qb, ft_fit))
    ft = -(-f_out // tiles_f)
    smem = dw_conv_smem(kt, kf, qb, ft, fixed)
    blocks_c = -(-quads // qb)
    if tiles_f >= 65536 or b * blocks_c >= 65536:
        raise ValueError(f"dw_conv_packed: B {b}, C {c}, F {f_out}: grid "
                         "too large")
    runs = max(1, min(t_out, DW_BLOCKS_PER_SM * kernel_lib.SMS
                      // (tiles_f * b * blocks_c)))
    return {"qb": qb, "ft": ft, "threads": qb * ft, "tiles_f": tiles_f,
            "blocks_c": blocks_c, "runs": runs,
            "grid": (runs, tiles_f, b * blocks_c), "fixed": fixed,
            "slots": DW_AHEAD + (1 if fixed else kt), "smem": smem}


def dw_conv_launch_ints(b, t_in, f_in, c, t_out, f_out, kt_kf, pads_t,
                        pads_f, w_strides) -> tuple:
    """The ints of K5's launch: the shapes, taps, low pads, w's strides,
    then ``dw_conv_geometry``'s qb, ft and runs."""
    geo = dw_conv_geometry(b, c, t_out, f_out, *kt_kf)
    return (b, t_in, f_in, c, t_out, f_out, *kt_kf, pads_t[0], pads_f[0],
            *w_strides, geo["qb"], geo["ft"], geo["runs"])


def _dw_forward(xp, w, bias, f_in, c, pads_t, pads_f):
    if xp.device.type == "cpu":
        return dw_conv_packed_plain(xp, w, bias, f_in, c, pads_t, pads_f)
    dt = _check_cuda("dw_conv_packed", xp, w, bias)
    kt, kf, _ = w.shape
    b, t_in, _ = xp.shape
    t_out, f_out = dw_geometry(t_in, f_in, kt, kf, pads_t, pads_f)
    if min(b, t_out, f_out, c) <= 0:
        raise ValueError(f"dw_conv_packed: empty output {t_out} x {f_out}")
    out = torch.empty(b, t_out, f_out * c, device=xp.device, dtype=dt)
    kernel_lib.launch(
        "packed_tf", kernel_lib.entry("dw_conv_packed_fwd", dt), xp.device,
        xp.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        *dw_conv_launch_ints(b, t_in, f_in, c, t_out, f_out, (kt, kf),
                             pads_t, pads_f, w.stride()),
    )
    return out


class _DwConv(torch.autograd.Function):
    """K5 with its backward (``_dw_conv_bwd``)."""

    @staticmethod
    def forward(ctx, xp, w, bias, f_in, c, pads_t, pads_f):
        ctx.save_for_backward(xp, w)
        ctx.geometry = (f_in, c, pads_t, pads_f)
        return _dw_forward(xp, w, bias, f_in, c, pads_t, pads_f)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        f_in, c, pads_t, pads_f = ctx.geometry
        g = g.contiguous()
        kt, kf, _ = w.shape
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the full correlation: K5 on g, taps flipped, pads k-1-lo/hi
            dx = _dw_forward(g, torch.flip(w, (0, 1)), None, g.shape[2] // c,
                             c, (kt - 1 - pads_t[0], kt - 1 - pads_t[1]),
                             (kf - 1 - pads_f[0], kf - 1 - pads_f[1]))
        if ctx.needs_input_grad[1]:
            dw = dw_conv_packed_wgrad(xp, g, f_in, c, (kt, kf), pads_t,
                                      pads_f).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = _bias_grad(g.reshape(-1, c), 0, w.dtype)
        return dx, dw, db, None, None, None, None


def dw_conv_packed(xp, w, bias, f_in: int, c: int, pads_t, pads_f):
    """Depthwise conv on packed (B, T_in, F_in*C), stride 1.

    Args:
      xp: packed map.
      w: (kT, kF, C) taps (a torch depthwise weight (C, 1, kT, kF) is
        ``weight[:, 0].permute(1, 2, 0)``; any strides).
      bias: (C,) or None.
      pads_t, pads_f: (lo, hi) zero pads (torch 'same' for k 4 is (1, 2)).

    Returns:
      packed (B, T_out, F_out*C) with torch Conv2d's output sizes.
    """
    kt, kf, cw = w.shape
    if cw != c or xp.shape[2] != f_in * c:
        raise ValueError(f"dw_conv_packed: x {tuple(xp.shape)}, F {f_in}, "
                         f"C {c}, w {tuple(w.shape)}")
    if _records(xp, w, bias):
        return _DwConv.apply(xp, w, bias, f_in, c, tuple(pads_t),
                             tuple(pads_f))
    return _dw_forward(xp, w, bias, f_in, c, pads_t, pads_f)


# ---------------------------------------------------------------------------
# K6 / K7: 1x1 dense convs, rank-4 <-> packed
# ---------------------------------------------------------------------------


def pw_proj_packed_plain(x4, w, bias):
    """In bf16 storage a float32 product of the widened values (their
    products exact) plus the bias, rounded once."""
    dtype = x4.dtype
    x4, w, bias = _wide(x4, w, bias)
    b, _, t, f = x4.shape
    out = torch.einsum("bitf,io->btfo", x4, w)
    if bias is not None:
        out = out + bias
    return out.reshape(b, t, f * w.shape[1]).to(dtype)


def pw_unproj_packed_plain(xp, w, bias, f: int):
    """As ``pw_proj_packed_plain``, packed in, rank-4 out."""
    dtype = xp.dtype
    xp, w, bias = _wide(xp, w, bias)
    b, t, n = xp.shape
    out = torch.einsum("btfi,io->botf", xp.reshape(b, t, f, n // f), w)
    if bias is not None:
        out = out + bias[:, None, None]
    return out.to(dtype)


def pw_packed_wgrad_plain(a, g):
    """dW (Ca, Cb) = sum over (b, t, f) of a[.., ca] g[.., cb], one einsum;
    one side is rank-4 (B, C, T, F), the other packed (B, T, F*C'); in
    float32 on bf16 operands (their products exact)."""
    ad = arithmetic_dtype(a.dtype)
    a, g = a.to(ad), g.to(ad)
    if a.dim() == 4:
        b, _, t, f = a.shape
        return torch.einsum("bitf,btfo->io", a, g.reshape(b, t, f, -1))
    b, _, t, f = g.shape
    return torch.einsum("btfi,botf->io", a.reshape(b, t, f, -1), g)


# pw-wgrad's kernel, ``kPw*`` in csrc/packed_tf.cu: a block's tile of dW
# is PW_WGRAD_ROWS planar x PW_WGRAD_COLS packed channels, PW_WGRAD_THREADS
# threads (warps of 32 x 32), one block an SM; PW_WGRAD_K positions a
# stage in a ring of PW_WGRAD_STAGES; the float32 sum in registers, the
# big products added to it every PW_WGRAD_FLUSH stages; a thread copies a
# planar row; staged planar rows of PW_WGRAD_PS floats, packed positions
# of PW_WGRAD_QS, output tile rows of PW_WGRAD_OS
PW_WGRAD_ROWS, PW_WGRAD_COLS, PW_WGRAD_K = 128, 64, 64
PW_WGRAD_STAGES = 3
PW_WGRAD_FLUSH = 1
PW_WGRAD_THREADS = 2 * PW_WGRAD_ROWS
PW_WGRAD_PS = PW_WGRAD_K + 4
PW_WGRAD_QS = PW_WGRAD_COLS + 8
PW_WGRAD_OS = PW_WGRAD_COLS + 2


# pw-wgrad's bf16 kernel (``kPw16*`` in csrc/packed_tf.cu,
# ``pw_wgrad16_kernel``): a block's tile of dW is PW16_ROWS planar x
# PW16_COLS packed channels, PW16_THREADS threads (warp w the planar
# channels of class w), one block an SM; PW16_K positions a stage in a
# ring of PW16_STAGES, the packed side with 8 positions before the
# stage's first; clusters of PW16_CLUSTER blocks (chunks) sum their tiles
# into one partial; staged planar rows of PW16_PS bf16, packed positions
# of PW16_QS, output tile rows of PW16_OS floats
PW16_ROWS, PW16_COLS, PW16_K = 256, 64, 64
PW16_STAGES = 4
PW16_CLUSTER = 2
PW16_THREADS = 256
PW16_PS = PW16_K + 8
PW16_QS = PW16_COLS + 8
PW16_OS = PW16_COLS + 1


def pw_wgrad16_smem() -> int:
    """pw-wgrad's bf16 kernel's shared bytes (``pw_wgrad16_smem_bytes`` in
    the source): PW16_STAGES stages of PW16_ROWS planar rows and PW16_K +
    8 packed positions in bf16, or in their place the float32 output
    tile and the staging tile of a cluster rank's transposed share."""
    ring = 2 * PW16_STAGES * (PW16_ROWS * PW16_PS + (PW16_K + 8) * PW16_QS)
    tile = PW16_ROWS * PW16_OS + PW16_COLS * (PW16_ROWS // PW16_CLUSTER + 1)
    return max(ring, 4 * tile)


@functools.lru_cache(maxsize=None)
def pw_wgrad16_geometry(b: int, m: int, cp: int, cq: int, k: int = PW16_K,
                        cluster: int = PW16_CLUSTER) -> dict:
    """pw-wgrad's launch on bf16 operands, as ``pw_packed_wgrad_bf16``
    runs it for a planar side of ``cp`` channels and a packed side of
    ``cq`` over ``b`` batch rows of ``m`` positions: ``tiles`` = ``tiles_p``
    x ``tiles_q`` tiles of PW16_ROWS x PW16_COLS; each batch row's
    positions in ``chunks`` chunks of ``chunk`` positions (a multiple of
    PW16_K; the last ragged), about one wave of one block an SM over a grid
    of (``gx``, tiles, b), ``gx`` the chunks rounded up to whole clusters
    of PW16_CLUSTER (the blocks past the last chunk sum nothing), one SM's
    worth of clusters kept free (a cluster's blocks must share a GPC);
    ``parts`` = b gx / PW16_CLUSTER partials of dW, one a cluster and
    tile. ``stages``: an interior chunk's. ``k`` and ``cluster`` are the
    kernel's constants, other values for tools/kernel_variants.py. Raises
    ValueError on an empty side."""
    if min(b, m, cp, cq) < 1:
        raise ValueError(f"pw_packed_wgrad: B {b}, M {m}, channels {cp} x "
                         f"{cq}")
    tiles_p, tiles_q = -(-cp // PW16_ROWS), -(-cq // PW16_COLS)
    tiles = tiles_p * tiles_q
    blocks = (kernel_lib.SMS // cluster - 1) * cluster
    per_row = max(1, blocks // (tiles * b))
    chunk = -(-(-(-m // per_row)) // k) * k
    chunks = -(-m // chunk)
    gx = -(-chunks // cluster) * cluster
    return {"tiles_p": tiles_p, "tiles_q": tiles_q, "tiles": tiles,
            "chunk": chunk, "chunks": chunks, "stages": chunk // k,
            "gx": gx, "grid": (gx, tiles, b), "parts": b * gx // cluster,
            "threads": PW16_THREADS, "smem": pw_wgrad16_smem()}


def pw16_stages(m: int, chunk: int, chunks: int, x: int) -> int:
    """The stages block x of a batch row runs (``ns`` in
    ``pw_wgrad16_kernel``): an interior chunk's chunk / PW16_K; the last
    chunk's up to m for every class (its positions shifted down by up to
    7); none past the last chunk."""
    if x < chunks - 1:
        return chunk // PW16_K
    if x == chunks - 1:
        return -(-(m - x * chunk + 7) // PW16_K)
    return 0


def pw_wgrad_smem(rows: int = PW_WGRAD_ROWS, stages: int = PW_WGRAD_STAGES,
                  k: int = PW_WGRAD_K) -> int:
    """pw-wgrad's shared bytes (``pw_wgrad_smem_floats`` in the source):
    the ring of ``stages`` stages of ``rows`` planar rows of k + 4 floats
    and ``k`` packed positions of PW_WGRAD_QS, or the (rows, PW_WGRAD_OS)
    output tile in its place, whichever is larger."""
    ring = stages * (rows * (k + 4) + k * PW_WGRAD_QS)
    return 4 * max(ring, rows * PW_WGRAD_OS)


@functools.lru_cache(maxsize=None)
def pw_wgrad_geometry(b: int, m: int, cp: int, cq: int,
                      rows: int = PW_WGRAD_ROWS,
                      k: int = PW_WGRAD_K) -> dict:
    """pw-wgrad's launch, as ``pw_packed_wgrad`` runs it for a planar side
    of ``cp`` channels and a packed side of ``cq`` (dW's rows and columns,
    K6's layout) over ``b`` batch rows of ``m`` positions: ``tiles`` =
    ``tiles_p`` x ``tiles_q`` tiles of ``rows`` x PW_WGRAD_COLS channels;
    each batch row's positions in ``chunks`` chunks of ``chunk`` positions
    (a multiple of ``k`` positions a stage; the last ragged), about one
    wave of one block an SM over the ``grid`` (chunks, tiles, b);
    ``parts`` = b chunks partials of dW, each written by the ``tiles``
    blocks of one (batch row, chunk); ``stages`` a whole chunk's. ``rows``
    and ``k`` are the kernel's constants, other values for
    tools/kernel_variants.py. Raises ValueError on an empty side."""
    if min(b, m, cp, cq) < 1:
        raise ValueError(f"pw_packed_wgrad: B {b}, M {m}, channels {cp} x "
                         f"{cq}")
    tiles_p, tiles_q = -(-cp // rows), -(-cq // PW_WGRAD_COLS)
    tiles = tiles_p * tiles_q
    per_row = max(1, kernel_lib.SMS // (tiles * b))
    chunk = -(-(-(-m // per_row)) // k) * k
    chunks = -(-m // chunk)
    return {"tiles_p": tiles_p, "tiles_q": tiles_q, "tiles": tiles,
            "chunk": chunk, "chunks": chunks, "stages": chunk // k,
            "grid": (chunks, tiles, b), "parts": b * chunks,
            "threads": 2 * rows, "smem": pw_wgrad_smem(rows, k=k)}


def pw_wgrad_launch_ints(a, g) -> tuple:
    """The ints of pw-wgrad's launch on (a, g) as ``pw_packed_wgrad`` (on
    bf16 operands ``pw_packed_wgrad_bf16``) takes them: B, M, Ca, Cb,
    whether a is the planar side, then ``pw_wgrad_geometry``'s (or
    ``pw_wgrad16_geometry``'s) chunk and parts."""
    a_planar = a.dim() == 4
    four, packed = (a, g) if a_planar else (g, a)
    b, cp, t, f = four.shape
    cq = packed.shape[2] // f
    geo = (pw_wgrad16_geometry if a.dtype == torch.bfloat16
           else pw_wgrad_geometry)(b, t * f, cp, cq)
    ca, cb = (cp, cq) if a_planar else (cq, cp)
    return (b, t * f, ca, cb, int(a_planar), geo["chunk"], geo["parts"])


def pw_packed_wgrad(a, g):
    """The weight gradient of the packed 1x1 convs (``_pw_wgrad_impl``):
    dW (Ca, Cb) = sum over positions of a^T g. K6's is (x4 rank-4, g
    packed), K7's (xp packed, g rank-4). Float32 on bf16 operands (JAX's
    kernel writes float32), else in their dtype."""
    a_planar = a.dim() == 4
    four, packed = (a, g) if a_planar else (g, a)
    b, c4, t, f = four.shape
    if packed.shape[:2] != (b, t) or packed.shape[2] % f:
        raise ValueError(f"pw_packed_wgrad: a {tuple(a.shape)}, g "
                         f"{tuple(g.shape)}")
    if a.device.type == "cpu":
        return pw_packed_wgrad_plain(a, g)
    dt = kernel_lib.check_cuda("pw_packed_wgrad", a, g, dtypes=_DTYPES)
    if dt == torch.bfloat16:  # the planar side's 16-byte copies
        a, g = (kernel_lib.aligned16(a), g) if a_planar else (
            a, kernel_lib.aligned16(g))
    ints = pw_wgrad_launch_ints(a, g)
    ca, cb = ints[2:4]
    partial = torch.empty(ints[-1], ca * cb, device=a.device)
    out = torch.empty(ca, cb, device=a.device)
    kernel_lib.launch(
        "packed_tf", kernel_lib.entry("pw_packed_wgrad", dt), a.device,
        a.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(), *ints)
    return out


# K6's kernel, ``kProj*`` in csrc/packed_tf.cu: PROJ_THREADS threads a
# block; tiles of PROJ_M positions x PROJ_N output channels; x staged
# PROJ_K reduction rows a stage in a ring of PROJ_STAGES, a staged row
# padded by PROJ_PAD floats; one launch a slice of PROJ_SLICE k rows
PROJ_THREADS = 512
PROJ_M, PROJ_N, PROJ_K = 128, 64, 32
PROJ_STAGES = 3
PROJ_PAD = 8
PROJ_SLICE = 256


def pw_proj_smem(k: int) -> int:
    """K6's shared bytes for a launch of reduction depth ``k`` at most
    PROJ_SLICE (``proj_smem_floats`` in the source): W's slice,
    round_up(k, PROJ_K) rows of PROJ_N channels split into big and small
    halves (2 PROJ_N floats a k), the ring of (PROJ_K, PROJ_M + PROJ_PAD)
    stages and the (PROJ_M, PROJ_N + PROJ_PAD) output tile."""
    kp = -(-k // PROJ_K) * PROJ_K
    return 4 * (kp * 2 * PROJ_N
                + PROJ_STAGES * PROJ_K * (PROJ_M + PROJ_PAD)
                + PROJ_M * (PROJ_N + PROJ_PAD))


@functools.lru_cache(maxsize=None)
def pw_proj_geometry(b: int, m: int, k: int, n: int) -> dict:
    """K6's launch, as ``pw_proj_packed_fwd`` runs it for x (b, k, m) and
    w (k, n): ``tiles`` = b * ceil(m / PROJ_M) (batch row, positions)
    tiles; ``blocks`` persistent blocks an N tile (one an SM, at most the
    tiles), block x walking the tiles x, x + blocks, ...; ``grid`` (blocks,
    ceil(n / PROJ_N)); ``slices`` launches of this grid, one a slice of
    at most PROJ_SLICE k (the first adds the bias, each later one adds its
    sums to the output the one before wrote); ``stages`` k stages a tile
    over all slices; ``smem`` a block's shared bytes, that of the first
    (largest) slice."""
    if min(b, m, k, n) < 1:
        raise ValueError(f"pw_proj_packed: B {b}, M {m}, K {k}, N {n}")
    tiles = b * -(-m // PROJ_M)
    blocks = min(tiles, kernel_lib.SMS)
    return {"tiles": tiles, "blocks": blocks,
            "grid": (blocks, -(-n // PROJ_N)), "stages": -(-k // PROJ_K),
            "slices": -(-k // PROJ_SLICE),
            "smem": pw_proj_smem(min(k, PROJ_SLICE))}


def pw_proj_launch_ints(x4, w) -> tuple:
    """The ints of K6's launch on x4 (B, K, T, F) and w (K, N): B, M, K,
    N, w's strides and the blocks of ``pw_proj_geometry``."""
    b, k, t, f = x4.shape
    n = w.shape[1]
    geo = pw_proj_geometry(b, t * f, k, n)
    return (b, t * f, k, n, *w.stride(), geo["blocks"])


# K6's and K7's bf16 kernels (``kP16*`` in csrc/packed_tf.cu): tiles of
# PROJ16_M positions x PROJ16_N channels, PROJ16_THREADS threads, PROJ16_K
# k a stage in two shared stages, one launch over all of K
PROJ16_M, PROJ16_N, PROJ16_K = 128, 64, 32
PROJ16_THREADS = 256


def pw_proj16_geometry(b: int, m: int, k: int, n: int) -> dict:
    """The launch of K6's and K7's bf16 kernels for x of ``b`` batch rows
    of ``m`` positions and ``k`` channels into ``n``: ``grid``
    (ceil(m / PROJ16_M), ceil(n / PROJ16_N), b), a block a tile of
    positions and channels over all of k in ``stages`` stages. Raises
    ValueError on an empty side or a grid the card does not take."""
    if min(b, m, k, n) < 1:
        raise ValueError(f"pw_proj_packed bf16: B {b}, M {m}, K {k}, N {n}")
    grid = (-(-m // PROJ16_M), -(-n // PROJ16_N), b)
    if grid[0] >= 2 ** 31 or max(grid[1:]) >= 65536:
        raise ValueError(f"pw_proj_packed bf16: grid {grid} too large")
    return {"grid": grid, "stages": -(-k // PROJ16_K),
            "threads": PROJ16_THREADS}


def _proj_forward(x4, w, bias):
    if x4.device.type == "cpu":
        return pw_proj_packed_plain(x4, w, bias)
    dt = _check_cuda("pw_proj_packed", x4, w, bias)
    b, k, t, f = x4.shape
    out = torch.empty(b, t, f * w.shape[1], device=x4.device, dtype=dt)
    if dt == torch.bfloat16:
        pw_proj16_geometry(b, t * f, k, w.shape[1])
        kernel_lib.launch(
            "packed_tf", "pw_proj_packed_fwd_bf16", x4.device, x4.data_ptr(),
            w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, t * f, k, w.shape[1], *w.stride())
        return out
    kernel_lib.launch(
        "packed_tf", "pw_proj_packed_fwd", x4.device, x4.data_ptr(),
        w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), *pw_proj_launch_ints(x4, w))
    return out


# K7's kernel (``kUnproj*`` in csrc/packed_tf.cu): tiles of UNPROJ_M
# positions x PROJ_N channels, UNPROJ_THREADS threads (warps of K6's 16 x
# 32), UNPROJ_BLOCKS blocks an SM; x staged PROJ_K k a stage in a ring of
# UNPROJ_STAGES, a staged position's PROJ_K k padded to UNPROJ_XS floats;
# W split as K6's, PROJ_SLICE k a launch; the output tile staged a channel
# a row of UNPROJ_OS floats (UNPROJ_M positions, a shift of 0-3, a pad)
UNPROJ_M = 128
UNPROJ_THREADS = UNPROJ_M // 16 * 2 * 32
UNPROJ_STAGES = 3
UNPROJ_BLOCKS = 1
UNPROJ_XS = PROJ_K + 4
UNPROJ_OS = UNPROJ_M + 4


def pw_unproj_smem(k: int) -> int:
    """K7's shared bytes for a launch of reduction depth ``k`` at most
    PROJ_SLICE (``unproj_smem_floats`` in the source): W's slice split as
    K6's (2 PROJ_N floats a k), the ring of (UNPROJ_M, UNPROJ_XS) stages
    and the (PROJ_N, UNPROJ_OS) output tile."""
    kp = -(-k // PROJ_K) * PROJ_K
    return 4 * (kp * 2 * PROJ_N + UNPROJ_STAGES * UNPROJ_M * UNPROJ_XS
                + PROJ_N * UNPROJ_OS)


@functools.lru_cache(maxsize=None)
def pw_unproj_geometry(b: int, m: int, k: int, n: int) -> dict:
    """K7's launch, as ``pw_unproj_packed_fwd`` runs it for x (b, m, k) and
    w (k, n): ``tiles`` = b * ceil(m / UNPROJ_M) (batch row, positions)
    tiles, ``n_tiles`` = ceil(n / PROJ_N) channel tiles; ``blocks``
    persistent blocks an N tile, together about UNPROJ_BLOCKS an SM (at
    most the tiles), block (x, y) walking the tiles x, x + blocks, ... of
    channel tile y, so that the n_tiles blocks of one x read the same x
    tiles at about the same time; ``grid`` (blocks, n_tiles); ``slices``
    launches, one a slice of at most PROJ_SLICE k (the first adds the
    bias, each later one adds its sums to the output); ``stages`` k stages a tile
    over all slices; ``smem`` a block's shared bytes (the first slice's)."""
    if min(b, m, k, n) < 1:
        raise ValueError(f"pw_unproj_packed: B {b}, M {m}, K {k}, N {n}")
    tiles = b * -(-m // UNPROJ_M)
    n_tiles = -(-n // PROJ_N)
    if n_tiles >= 65536:
        raise ValueError(f"pw_unproj_packed: N {n}: grid too large")
    blocks = max(1, min(tiles, UNPROJ_BLOCKS * kernel_lib.SMS // n_tiles))
    return {"tiles": tiles, "n_tiles": n_tiles, "blocks": blocks,
            "grid": (blocks, n_tiles), "stages": -(-k // PROJ_K),
            "slices": -(-k // PROJ_SLICE),
            "smem": pw_unproj_smem(min(k, PROJ_SLICE))}


def pw_unproj_launch_ints(xp, w, f: int) -> tuple:
    """The ints of K7's launch on xp (B, T, F*K) and w (K, N): B, M, K, N,
    w's strides and the blocks of ``pw_unproj_geometry``."""
    b, t, _ = xp.shape
    k, n = w.shape
    geo = pw_unproj_geometry(b, t * f, k, n)
    return (b, t * f, k, n, *w.stride(), geo["blocks"])


def _unproj_forward(xp, w, bias, f):
    if xp.device.type == "cpu":
        return pw_unproj_packed_plain(xp, w, bias, f)
    dt = _check_cuda("pw_unproj_packed", xp, w, bias)
    b, t, _ = xp.shape
    k, n = w.shape
    out = torch.empty(b, n, t, f, device=xp.device, dtype=dt)
    if dt == torch.bfloat16:
        pw_proj16_geometry(b, t * f, k, n)
        kernel_lib.launch(
            "packed_tf", "pw_unproj_packed_fwd_bf16", xp.device,
            xp.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), b,
            t * f, k, n, *w.stride())
        return out
    kernel_lib.launch(
        "packed_tf", "pw_unproj_packed_fwd", xp.device, xp.data_ptr(),
        w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), *pw_unproj_launch_ints(xp, w, f))
    return out


class _PwProj(torch.autograd.Function):
    """K6 with its backward (``_pw_proj_bwd``): dx is K7 with w^T, dW is
    pw-wgrad."""

    @staticmethod
    def forward(ctx, x4, w, bias):
        ctx.save_for_backward(x4, w)
        return _proj_forward(x4, w, bias)

    @staticmethod
    def backward(ctx, g):
        x4, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _unproj_forward(g, w.t(), None, x4.shape[3])
        if ctx.needs_input_grad[1]:
            dw = pw_packed_wgrad(x4, g).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = _bias_grad(g.reshape(-1, w.shape[1]), 0, w.dtype)
        return dx, dw, db


class _PwUnproj(torch.autograd.Function):
    """K7 with its backward (``_pw_unproj_bwd``): dx is K6 with w^T, dW is
    pw-wgrad."""

    @staticmethod
    def forward(ctx, xp, w, bias, f):
        ctx.save_for_backward(xp, w)
        return _unproj_forward(xp, w, bias, f)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _proj_forward(g, w.t(), None)
        if ctx.needs_input_grad[1]:
            dw = pw_packed_wgrad(xp, g).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = _bias_grad(g, (0, 2, 3), w.dtype)
        return dx, dw, db, None


def pw_proj_packed(x4, w, bias):
    """1x1 dense conv (B, Ci, T, F) x (Ci, Co) -> packed (B, T, F*Co).

    ``w`` may be any strided (Ci, Co) view (a torch weight (Co, Ci, 1, 1)
    gives ``weight[:, :, 0, 0].t()``)."""
    if w.shape[0] != x4.shape[1]:
        raise ValueError(f"pw_proj_packed: x {tuple(x4.shape)}, w "
                         f"{tuple(w.shape)}")
    if _records(x4, w, bias):
        return _PwProj.apply(x4, w, bias)
    return _proj_forward(x4, w, bias)


def pw_unproj_packed(xp, w, bias, f: int):
    """1x1 dense conv packed (B, T, F*Ci) x (Ci, Co) -> (B, Co, T, F)."""
    if xp.shape[2] != f * w.shape[0]:
        raise ValueError(f"pw_unproj_packed: x {tuple(xp.shape)}, F {f}, w "
                         f"{tuple(w.shape)}")
    if _records(xp, w, bias):
        return _PwUnproj.apply(xp, w, bias, f)
    return _unproj_forward(xp, w, bias, f)


# ---------------------------------------------------------------------------
# K8 / K9: separable static spatial maps
# ---------------------------------------------------------------------------
#
# down: y[b, c, t2, f2] = sum_t M[t2, t] sum_i fw[f2, i] x[b, t, fs[f2, i]*C + c]
# up:   y[b, t, f*C + c] = sum_t2 M[t, t2] sum_i fw[f, i] x[b, c, t2, fs[f, i]]


def _nearest_axis_idx(in_sz: int, out_sz: int) -> np.ndarray:
    # torch computes src = floor(float32(i) * (float32(in)/float32(out)))
    # in single precision (upsample_nearest CPU/CUDA kernels); double
    # precision floor(i * in/out) is 1 ulp off at exact multiples
    # (e.g. 3280->25 at i=15). Match torch bit-for-bit.
    scale = np.float32(in_sz) / np.float32(out_sz)
    idx = np.floor(
        np.arange(out_sz, dtype=np.float32) * scale
    ).astype(np.int64)
    return np.minimum(idx, in_sz - 1)


def _adaptive_pool_matrix(in_sz: int, out_sz: int) -> np.ndarray:
    """(out, in) averaging matrix with torch adaptive_avg_pool boundaries."""
    m = np.zeros((out_sz, in_sz), dtype=np.float32)
    for o in range(out_sz):
        start = (o * in_sz) // out_sz
        end = -((-(o + 1) * in_sz) // out_sz)  # ceil((o+1)*in/out)
        m[o, start:end] = 1.0 / (end - start)
    return m


def nearest_up_maps(t_in: int, t_out: int, f_in: int, f_out: int):
    """torch F.interpolate(nearest) as (M_T, fs, fw) for spatial_up."""
    ti = _nearest_axis_idx(t_in, t_out)
    m = np.zeros((t_out, t_in), np.float32)
    m[np.arange(t_out), ti] = 1.0
    fj = _nearest_axis_idx(f_in, f_out)
    fs = fj.reshape(-1, 1).astype(np.int32)
    fw = np.ones((f_out, 1), np.float32)
    return m, fs, fw


def adaptive_pool_maps(t_in: int, t_out: int, f_in: int, f_out: int):
    """torch adaptive_avg_pool2d as (M_T, fs, fw) for spatial_down."""
    m = _adaptive_pool_matrix(t_in, t_out)
    buckets = []
    for o in range(f_out):
        start = (o * f_in) // f_out
        end = -((-(o + 1) * f_in) // f_out)
        buckets.append([(i, 1.0 / (end - start)) for i in range(start, end)])
    nnz = max(len(b) for b in buckets)
    fs = np.zeros((f_out, nnz), np.int32)
    fw = np.zeros((f_out, nnz), np.float32)
    for o, b in enumerate(buckets):
        for i, (src, w) in enumerate(b):
            fs[o, i] = src
            fw[o, i] = w
    return m, fs, fw


def stride2_select_maps(t_conv: int, t_out: int, f_conv: int, f_out: int):
    """Row/block selectors turning a stride-1 conv output into the
    stride-2 conv output (out[i] = conv_s1[2 i])."""
    m = np.zeros((t_out, t_conv), np.float32)
    m[np.arange(t_out), 2 * np.arange(t_out)] = 1.0
    fs = (2 * np.arange(f_out)).reshape(-1, 1).astype(np.int32)
    fw = np.ones((f_out, 1), np.float32)
    return m, fs, fw


def transpose_fmap(fs, fw, f_in: int):
    """Transpose an F side (F_out, nnz) -> (f_in, nnz'): row f lists the
    output blocks that read input block f, with their weights
    (``_transpose_fmap``; weight-0 entries dropped, rows padded with
    weight-0 entries)."""
    rows = [[] for _ in range(f_in)]
    for o in range(fs.shape[0]):
        for i in range(fs.shape[1]):
            if fw[o, i] != 0.0:
                rows[int(fs[o, i])].append((o, float(fw[o, i])))
    nnz = max(1, max(len(r) for r in rows))
    tfs = np.zeros((f_in, nnz), np.int32)
    tfw = np.zeros((f_in, nnz), np.float32)
    for f, row in enumerate(rows):
        for i, (o, w) in enumerate(row):
            tfs[f, i] = o
            tfw[f, i] = w
    return tfs, tfw


class SpatialMap:
    """A separable static map: the dense T side ``m`` (T_out, T_in) and the
    F side as (F_out, nnz) source blocks ``fs`` and weights ``fw``, as the
    JAX builders give them. The kernels take the T side in the same
    compact form, ``ts``/``tw`` (T_out, nnz) from the rows of ``m``; the
    tensors, and the kernels' launch arguments, are made once per device
    and kept."""

    def __init__(self, m, fs, fw):
        self.m = np.ascontiguousarray(m, np.float32)
        self.fs = np.asarray(fs, np.int32)
        self.fw = np.asarray(fw, np.float32)
        self.fs_max = int(self.fs.max())
        self._on = {}
        self._launch = {}
        self._transposed = {}

    def transposed(self, f_in: int) -> "SpatialMap":
        """The linear transpose of this map onto an input F side of
        ``f_in`` blocks, its VJP: T side ``m.T``, F side
        ``transpose_fmap``; built once per ``f_in`` and kept."""
        if f_in not in self._transposed:
            self._transposed[f_in] = SpatialMap(
                self.m.T, *transpose_fmap(self.fs, self.fw, f_in))
        return self._transposed[f_in]

    @property
    def t_in(self) -> int:
        return self.m.shape[1]

    @property
    def t_out(self) -> int:
        return self.m.shape[0]

    @property
    def f_out(self) -> int:
        return self.fs.shape[0]

    def compact_t(self):
        """(ts, tw) (T_out, nnz): the nonzero entries of each row of m,
        padded with weight-0 entries."""
        rows = [np.flatnonzero(r) for r in self.m]
        nnz = max(1, max(len(r) for r in rows))
        ts = np.zeros((self.t_out, nnz), np.int32)
        tw = np.zeros((self.t_out, nnz), np.float32)
        for o, r in enumerate(rows):
            ts[o, :len(r)] = r
            tw[o, :len(r)] = self.m[o, r]
        return ts, tw

    def tensors(self, device: torch.device) -> dict:
        if device not in self._on:
            ts, tw = self.compact_t()
            self._on[device] = {
                name: torch.from_numpy(a).to(device)
                for name, a in (("m", self.m), ("ts", ts), ("tw", tw),
                                ("fs", self.fs), ("fw", self.fw),
                                ("rows", row_runs(ts, tw)))}
        return self._on[device]

    def launch_args(self, up: bool, c: int, f_in: int,
                    device: torch.device, dtype: torch.dtype = torch.float32,
                    b: int = 1) -> tuple:
        """The map's part of a K9 (``up``) or K8 launch for ``c`` channels
        and an input F side of ``f_in`` blocks on ``device`` in storage
        ``dtype``: (pointers, ints after the batch size), as
        ``spatial_{up,down}_packed_fwd`` (or their ``_bf16`` forms) take
        them; built once, after ``map_geometry`` has checked that the tile
        fits. K9 in bf16 takes its plan for batch size ``b``: the T terms
        of each run's first row, the runs, the F blocks' staged chunks."""
        b = b if up and dtype == torch.bfloat16 else 1
        key = (up, c, f_in, device, dtype, b)
        if key not in self._launch:
            geo = map_geometry(self, up, c, f_in, dtype, b)
            tens = dict(self.tensors(device))
            names = ("ts", "tw", "fs", "fw") + (("rows",) if up else ())
            ints = (self.t_in, f_in, c, self.t_out, self.f_out,
                    tens["ts"].shape[1], self.fs.shape[1])
            if up:
                ints += (tens["rows"].numel() - 1,)
            if up and dtype == torch.bfloat16:
                first = tens["rows"][:-1].long()
                tens.update(ts=tens["ts"][first].contiguous(),
                            tw=tens["tw"][first].contiguous(),
                            fr=torch.from_numpy(geo["fr"]).to(device))
                names += ("fr",)
                ints += (len(geo["fr"]), geo["fb"], geo["tile_rows"])
            # the plan's tensors kept alive beside their pointers
            self._launch[key] = (tuple(tens[n].data_ptr() for n in names),
                                 ints, tens)
        return self._launch[key][:2]


@functools.lru_cache(maxsize=None)
def cached_map(kind: str, t_in: int, t_out: int, f_in: int,
               f_out: int) -> SpatialMap:
    """The map of one geometry, built once: ``kind`` is "pool", "select"
    or "nearest"."""
    build = {"pool": adaptive_pool_maps, "select": stride2_select_maps,
             "nearest": nearest_up_maps}[kind]
    return SpatialMap(*build(t_in, t_out, f_in, f_out))


def _f_side(x, fs, fw, axis):
    """sum_i fw[o, i] * x[..., fs[o, i], ...] along ``axis`` (an F axis)."""
    g = x.index_select(axis, fs.reshape(-1).long())
    shape = list(x.shape)
    shape[axis:axis + 1] = list(fs.shape)
    g = g.reshape(shape)
    wshape = [1] * len(shape)
    wshape[axis:axis + 2] = list(fw.shape)
    return (g * fw.reshape(wshape)).sum(axis + 1)


def spatial_down_packed_plain(xp, smap: SpatialMap, c: int):
    """F side by gather, T side by the dense M (einsum), in xp's dtype (in
    bf16 storage over the widened values, rounded once)."""
    dtype = xp.dtype
    (xp,) = _wide(xp)
    b, t, n = xp.shape
    tens = smap.tensors(xp.device)
    col = _f_side(xp.reshape(b, t, n // c, c), tens["fs"], tens["fw"], 2)
    return torch.einsum("st,btfc->bcsf", tens["m"].to(col.dtype),
                        col).to(dtype)


def spatial_up_packed_plain(x4, smap: SpatialMap):
    """The T side by the dense M, then the F side, as K8's. In bf16 storage
    each source's term of the F side is rounded to bf16 and the terms are
    added in bf16, in order: JAX's K8 VJP sums one single-source pass a
    source of the transposed map, each in the cotangent's dtype (one
    source, every forward map, is one rounding)."""
    dtype = x4.dtype
    (x4,) = _wide(x4)
    b, c = x4.shape[:2]
    tens = smap.tensors(x4.device)
    y = torch.einsum("ts,bcsu->btuc", tens["m"].to(x4.dtype), x4)
    if dtype != torch.bfloat16:
        y = _f_side(y, tens["fs"], tens["fw"], 2)  # (B, T, F, C)
        return y.reshape(b, smap.t_out, smap.f_out * c).to(dtype)
    fs, fw = tens["fs"], tens["fw"]
    out = None
    for i in range(fs.shape[1]):
        part = (y.index_select(2, fs[:, i].long())
                * fw[:, i, None].to(y.dtype)).to(dtype)
        out = part if out is None else out + part
    return out.reshape(b, smap.t_out, smap.f_out * c)


# K8 / K9 launch geometry: MAP_PAD mirrors kMapPad of csrc/packed_tf.cu
MAP_PAD = 4   # floats past round_up(C, 4) in a row of the shared tile
MAP_ROWS = 4  # K9: the most output rows one block writes


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def map_smem(tile_rows: int, c: int, f_out: int, nt: int, nf: int) -> int:
    """Shared bytes of a K8/K9 block (``map_smem`` in the source): the
    (tile_rows, round_up(c, 4) + MAP_PAD) tile, then fs/fw (f_out, nf) and
    ts/tw (nt)."""
    return 4 * (tile_rows * (_round4(c) + MAP_PAD) + 2 * f_out * nf + 2 * nt)


def row_runs(ts, tw, limit: int = MAP_ROWS) -> np.ndarray:
    """K9's blocks over a compact T side: the first output row of each run
    of consecutive rows whose (ts, tw) rows are equal, at most ``limit``
    rows a run, then T_out. A block stages its run's source rows once."""
    starts = [0]
    for t in range(1, ts.shape[0]):
        if (t - starts[-1] >= limit or not np.array_equal(ts[t], ts[t - 1])
                or not np.array_equal(tw[t], tw[t - 1])):
            starts.append(t)
    starts.append(ts.shape[0])
    return np.asarray(starts, np.int32)


def map_geometry(smap: SpatialMap, up: bool, c: int, f_in: int,
                 dtype: torch.dtype = torch.float32, b: int = 1) -> dict:
    """K9's (``up``) or K8's launch on ``smap`` for ``c`` channels and an
    input F side of ``f_in`` blocks, as csrc/packed_tf.cu runs it: ``rows``
    holds the first output row of each block, then T_out (K9: the runs of
    ``row_runs``; K8: one row a block); ``tile_rows`` the tile's rows
    (round_up(f_in, 4) for K9, round_up(F_out, 4) for K8); ``smem`` a
    block's shared bytes. In bf16 storage ``map16_geometry``'s plan (for
    batch size ``b``). Raises ValueError when they exceed one block's
    shared memory."""
    if dtype == torch.bfloat16:
        return map16_geometry(smap, up, c, f_in, b)
    ts, tw = smap.compact_t()
    if up:
        rows, tile_rows = row_runs(ts, tw), _round4(f_in)
    else:
        rows = np.arange(smap.t_out + 1, dtype=np.int32)
        tile_rows = _round4(smap.f_out)
    smem = map_smem(tile_rows, c, smap.f_out, ts.shape[1], smap.fs.shape[1])
    _check_map_smem(smem, up, c, f_in, smap.f_out)
    return {"rows": rows, "tile_rows": tile_rows, "smem": smem}


def _check_map_smem(smem: int, up: bool, c: int, f_in: int, f_out: int):
    if smem > kernel_lib.SMEM_PER_BLOCK:
        raise ValueError(
            f"spatial_{'up' if up else 'down'}_packed: C {c}, F in {f_in} / "
            f"out {f_out} need {smem} bytes of shared memory a block, "
            f"more than {kernel_lib.SMEM_PER_BLOCK}")


# K8 / K9 in bf16 storage (spatial_{down,up}_bf16_kernel), mirroring
# csrc/packed_tf.cu: 16-byte chunks of 8 values on both sides
MAP16_PAD = 4  # floats past round_up(C, 8) in a row of a tile
DOWN16_F = 16  # K8: output f2 a block
MAP16_BLOCKS = 4 * kernel_lib.SMS  # K9: the fewest blocks a launch aims at


def _up16_split(smap: SpatialMap, n_f: int, cs: int) -> tuple:
    """K9 bf16's output f cut into ``n_f`` blocks of ``fb``: (fb, fr,
    tile_rows, smem), ``fr`` each block's staged input chunks of 8 f."""
    fb = -(-smap.f_out // n_f)
    n_f = -(-smap.f_out // fb)
    fr = np.zeros((n_f, 2), np.int32)
    for j in range(n_f):
        blk = slice(j * fb, (j + 1) * fb)
        src = smap.fs[blk][smap.fw[blk] != 0]
        if src.size:
            lo = int(src.min()) // 8
            fr[j] = (lo, int(src.max()) // 8 - lo + 1)
    tile_rows = 8 * int(fr[:, 1].max())
    smem = 4 * (-(-2 * fb * smap.fs.shape[1] // 4) * 4 + tile_rows * cs)
    return fb, fr, tile_rows, smem


def map16_geometry(smap: SpatialMap, up: bool, c: int, f_in: int,
                   b: int = 1) -> dict:
    """The bf16 kernels' launch on ``smap`` for ``c`` channels, an input F
    side of ``f_in`` blocks and batch size ``b``. K8: a block ``DOWN16_F``
    output f2 of one row, ``grid`` (ceil(F_out / DOWN16_F), T_out); its
    (DOWN16_F, CS) float32 tile. K9: ``row_runs``'s runs (``rows``), each
    split into ``grid[0]`` blocks of ``fb`` output f, as few as give
    ``MAP16_BLOCKS`` blocks over the batch (a block of 8 f at most) and
    fit the shared memory; ``fr`` (nF, 2) the input chunks of 8 f a block
    stages (the first, the count; (0, 0) where its f have no source),
    ``tile_rows`` the most rows a block's tile takes. CS = round_up(c, 8) +
    MAP16_PAD; ``smem`` a block's shared bytes. Raises ValueError where
    they exceed one block's shared memory."""
    cs = -(-c // 8) * 8 + MAP16_PAD
    if not up:
        smem = 4 * DOWN16_F * cs
        _check_map_smem(smem, up, c, f_in, smap.f_out)
        return {"grid": (-(-smap.f_out // DOWN16_F), smap.t_out),
                "smem": smem}
    ts, tw = smap.compact_t()
    rows = row_runs(ts, tw)
    most = -(-smap.f_out // 8)
    n_f = min(most, -(-MAP16_BLOCKS // ((len(rows) - 1) * b)))
    fb, fr, tile_rows, smem = _up16_split(smap, n_f, cs)
    while smem > kernel_lib.SMEM_PER_BLOCK and n_f < most:
        n_f = min(most, 2 * n_f)
        fb, fr, tile_rows, smem = _up16_split(smap, n_f, cs)
    _check_map_smem(smem, up, c, f_in, smap.f_out)
    return {"rows": rows, "grid": (len(fr), len(rows) - 1), "fb": fb,
            "fr": fr, "tile_rows": tile_rows, "smem": smem}


def _down_forward(xp, smap, c):
    dev = xp.device
    if dev.type == "cpu":
        return spatial_down_packed_plain(xp, smap, c)
    dt = _check_cuda("spatial_down_packed", xp)
    b, _, n = xp.shape
    ptrs, ints = smap.launch_args(False, c, n // c, dev, dt)
    out = torch.empty(b, c, smap.t_out, smap.f_out, device=dev, dtype=dt)
    kernel_lib.launch("packed_tf",
                      kernel_lib.entry("spatial_down_packed_fwd", dt), dev,
                      xp.data_ptr(), out.data_ptr(), *ptrs, b, *ints)
    return out


def _up_forward(x4, smap):
    dev = x4.device
    if dev.type == "cpu":
        return spatial_up_packed_plain(x4, smap)
    dt = _check_cuda("spatial_up_packed", x4)
    b, c, _, f2 = x4.shape
    ptrs, ints = smap.launch_args(True, c, f2, dev, dt, b)
    out = torch.empty(b, smap.t_out, smap.f_out * c, device=dev, dtype=dt)
    kernel_lib.launch("packed_tf",
                      kernel_lib.entry("spatial_up_packed_fwd", dt), dev,
                      x4.data_ptr(), out.data_ptr(), *ptrs, b, *ints)
    return out


class _SpatialDown(torch.autograd.Function):
    """K8 with its backward (``_spatial_down_bwd``): K9 through the
    transposed map, one launch whatever the rows' source count."""

    @staticmethod
    def forward(ctx, xp, smap, c):
        ctx.smap, ctx.f_in = smap, xp.shape[2] // c
        return _down_forward(xp, smap, c)

    @staticmethod
    def backward(ctx, g):
        return (_up_forward(g.contiguous(), ctx.smap.transposed(ctx.f_in)),
                None, None)


class _SpatialUp(torch.autograd.Function):
    """K9 with its backward (``_spatial_up_bwd``): K8 through the
    transposed map."""

    @staticmethod
    def forward(ctx, x4, smap):
        ctx.smap, ctx.f_in = smap, x4.shape[3]
        return _up_forward(x4, smap)

    @staticmethod
    def backward(ctx, g):
        c = g.shape[2] // ctx.smap.f_out
        return (_down_forward(g.contiguous(), ctx.smap.transposed(ctx.f_in),
                              c), None)


def spatial_down_packed(xp, smap: SpatialMap, c: int):
    """Packed (B, T, F*C) -> rank-4 (B, C, T2, F2) through ``smap``."""
    _, t, n = xp.shape
    if t != smap.t_in or n % c or smap.fs_max >= n // c:
        raise ValueError(f"spatial_down_packed: x {tuple(xp.shape)}, C {c}, "
                         f"map T {smap.t_in}")
    if _records(xp):
        return _SpatialDown.apply(xp, smap, c)
    return _down_forward(xp, smap, c)


def spatial_up_packed(x4, smap: SpatialMap):
    """Rank-4 (B, C, T2, F2) -> packed (B, T, F*C) through ``smap``."""
    _, _, t2, f2 = x4.shape
    if t2 != smap.t_in or smap.fs_max >= f2:
        raise ValueError(f"spatial_up_packed: x {tuple(x4.shape)}, map T "
                         f"{smap.t_in}")
    if _records(x4):
        return _SpatialUp.apply(x4, smap)
    return _up_forward(x4, smap)


# ---------------------------------------------------------------------------
# Model integration: the packed carriers and the scope
# ---------------------------------------------------------------------------

_PACKED_STATE = threading.local()


@contextlib.contextmanager
def packed_scope(on: bool):
    """Enable the packed-TF layout for module calls in scope."""
    old = getattr(_PACKED_STATE, "on", False)
    _PACKED_STATE.on = bool(on)
    try:
        yield
    finally:
        _PACKED_STATE.on = old


def packed_enabled() -> bool:
    return getattr(_PACKED_STATE, "on", False)


class PackedTF:
    """A packed (B, T, F*C) map carrying its (F, C) split.

    ``.shape`` is the port's logical (B, C, T, F), so module code comparing
    ``shape[2:]`` works unchanged; ``+``, ``*`` and ``-`` with another
    PackedTF of the same geometry, or a number, act on the data.
    """

    __slots__ = ("data", "f", "c")

    def __init__(self, data, f, c):
        self.data = data
        self.f = int(f)
        self.c = int(c)

    @property
    def shape(self):
        b, t, _ = self.data.shape
        return torch.Size((b, self.c, t, self.f))

    def unpack(self):
        return unpack_tf(self.data, self.f, self.c)

    def _binop(self, other, op):
        if isinstance(other, PackedTF):
            if (other.f, other.c) != (self.f, self.c):
                raise ValueError("PackedTF geometries differ")
            other = other.data
        elif not isinstance(other, (int, float)):
            raise TypeError(f"PackedTF with {type(other).__name__}: unpack "
                            "first")
        return PackedTF(op(self.data, other), self.f, self.c)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    __radd__ = __add__

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)


class PackRequest:
    """Marker: a rank-4 input to a 1x1 projection that should emit packed."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    @property
    def shape(self):
        return self.data.shape


def spatial_up_to(x4, t_out: int, f_out: int) -> PackedTF:
    """torch-nearest upsample of a rank-4 pooled map into a packed map."""
    _, c, t2, f2 = x4.shape
    smap = cached_map("nearest", t2, t_out, f2, f_out)
    return PackedTF(spatial_up_packed(x4, smap), f_out, c)


def adaptive_pool_from(xp: PackedTF, t_out: int, f_out: int):
    """torch adaptive_avg_pool2d of a packed map -> rank-4 pooled map."""
    _, c, t, f = xp.shape
    return spatial_down_packed(xp.data, cached_map("pool", t, t_out, f, f_out),
                               c)


def dw_stride2_from(xp_conv: PackedTF, t_out: int, f_out: int):
    """Select the stride-2 conv output from a stride-1 packed conv
    (out[i] = conv_s1[2 i] when both pad by dilation*(k-1)//2)."""
    _, c, t_conv, f_conv = xp_conv.shape
    smap = cached_map("select", t_conv, t_out, f_conv, f_out)
    return spatial_down_packed(xp_conv.data, smap, c)
