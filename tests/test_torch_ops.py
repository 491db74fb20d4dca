"""Port ops and norms against their rtfs_tpu counterparts, on the CPU.

Same numpy inputs through both packages; the JAX side is channels-last
((B, T, C) / (B, T, F, C), HWIO kernels), the port channels-first with
torch weight layouts. f32 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.models import layers as JL
from rtfs_tpu.ops import convops as jconv
from rtfs_tpu.ops import stft as jstft
from rtfs_tpu_torch.models import layers as TL
from rtfs_tpu_torch.ops import convops as tconv
from rtfs_tpu_torch.ops import stft as tstft

# f32 sums over <= ~600 terms of O(1) values, taken in another order (XLA vs
# torch CPU kernels): a few ulps of the sum's magnitude
ATOL, RTOL = 2e-5, 2e-5


def _cf(x):
    """channels-last -> channels-first."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _conv_w(w):
    """JAX (*k, Cin/g, Cout) -> torch (Cout, Cin/g, *k)."""
    nd = w.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        w.transpose((nd + 1, nd) + tuple(range(nd)))))


def test_stft_istft():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    w = jstft.hann_window(256)
    ref = np.asarray(jstft.stft(jnp.asarray(x), 256, 128, w))  # (B, T, F)
    got = tstft.stft(torch.from_numpy(x), 256, 128, tstft.hann_window(256))
    assert got.shape == (2, 129, ref.shape[1])
    # two FFT libraries: 256-term complex sums of O(1) samples
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), ref,
                               atol=1e-4, rtol=1e-5)

    wav_ref = np.asarray(jstft.istft(jnp.asarray(ref), 256, 128, w, 1000))
    wav = tstft.istft(got, 256, 128, tstft.hann_window(256), 1000)
    np.testing.assert_allclose(wav.numpy(), wav_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wav.numpy(), x, atol=1e-5)  # round trip


@pytest.mark.parametrize(
    "spatial,cin,cout,k,stride,padding,groups,dilation",
    [
        ((23,), 6, 10, 3, 1, "same", 1, 1),
        ((23,), 6, 10, 4, 1, "same", 1, 1),        # even: asymmetric pad
        ((23,), 8, 8, 5, 1, "same", 8, 2),         # depthwise, dilated
        ((17,), 8, 16, 3, 2, 1, 8, 1),             # grouped, stride 2
        ((13, 11), 2, 12, 3, 1, "same", 1, 1),     # encoder-like 2->C
        ((13, 11), 8, 8, 4, 2, 1, 8, 1),           # pyramid DW stride 2
        ((13, 11), 8, 12, 1, 1, "same", 1, 1),     # 1x1 dense
        ((13, 11), 8, 8, 1, 1, "same", 8, 1),      # 1x1 depthwise gateway
    ],
)
def test_conv(spatial, cin, cout, k, stride, padding, groups, dilation):
    rng = np.random.default_rng(1)
    nd = len(spatial)
    x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
    w = (rng.standard_normal((k,) * nd + (cin // groups, cout)) * 0.2
         ).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(jconv.conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                padding=padding, dilation=dilation,
                                groups=groups, bias=jnp.asarray(b)))
    got = tconv.conv(_cf(x), _conv_w(w), stride=stride, padding=padding,
                     dilation=dilation, groups=groups,
                     bias=torch.from_numpy(b))
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "spatial,cin,cout,k,stride,padding",
    [((9,), 16, 6, 8, 1, 0),          # DualPathRNN back-projection
     ((7, 5), 12, 2, 3, 1, 1),        # STFT decoder
     ((7,), 4, 4, 3, 2, 1)],          # strided
)
def test_conv_transpose(spatial, cin, cout, k, stride, padding):
    rng = np.random.default_rng(2)
    nd = len(spatial)
    x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
    w = (rng.standard_normal((k,) * nd + (cout, cin)) * 0.2).astype(np.float32)
    ref = np.asarray(jconv.conv_transpose(jnp.asarray(x), jnp.asarray(w),
                                          stride=stride, padding=padding))
    # JAX (*k, Cout, Cin) -> torch (Cin, Cout, *k)
    wt = torch.from_numpy(np.ascontiguousarray(
        w.transpose((nd + 1, nd) + tuple(range(nd)))))
    got = tconv.conv_transpose(_cf(x), wt, stride=stride, padding=padding)
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,size", [
    ((2, 25, 3), (51,)), ((2, 50, 3), (251,)), ((2, 16, 8, 3), (33, 17)),
    ((2, 125, 64, 2), (251, 129)), ((2, 7, 1, 3), (30, 11)),
])
def test_interp_nearest(shape, size):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jconv.interp_nearest(jnp.asarray(x), size))
    got = tconv.interp_nearest(_cf(x), size)
    np.testing.assert_array_equal(_cl(got), ref)  # a gather: exact


@pytest.mark.parametrize("shape,size", [
    ((2, 50, 3), (7,)), ((2, 31, 17, 3), (7, 5)), ((2, 251, 129, 2), (125, 64)),
])
def test_adaptive_avg_pool(shape, size):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jconv.adaptive_avg_pool(jnp.asarray(x), size))
    got = tconv.adaptive_avg_pool(_cf(x), size)
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=RTOL)


def test_unfold_1d():
    x = np.random.default_rng(5).standard_normal((2, 13, 5)).astype(np.float32)
    ref = np.asarray(jconv.unfold_1d(jnp.asarray(x), 4, 1))  # (B, T', C*k)
    got = tconv.unfold_1d(_cf(x), 4, 1)                      # (B, C*k, T')
    np.testing.assert_array_equal(_cl(got), ref)  # a copy: exact


def _affine(rng, shape):
    return (1 + 0.3 * rng.standard_normal(shape)).astype(np.float32), \
        (0.3 * rng.standard_normal(shape)).astype(np.float32)


def test_global_layer_norm():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 9, 7, 6)) + 0.5).astype(np.float32)
    g, b = _affine(rng, (6,))
    ref = JL.GlobalLayerNorm(6).apply(
        {"params": {"scale": g, "bias": b}}, jnp.asarray(x))
    mod = TL.GlobalLayerNorm(6)
    mod.load_state_dict({"norm.weight": torch.from_numpy(g),
                         "norm.bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = mod(_cf(x))
    # JAX takes single-pass E[x^2]-E[x]^2 statistics, torch two-pass
    np.testing.assert_allclose(_cl(got), np.asarray(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("n_freqs", [1, 7])
def test_layer_norm_4d(n_freqs):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 7, 6)).astype(np.float32)
    g, b = _affine(rng, (1, 1, n_freqs, 6))
    ref = JL.LayerNormalization4D(6, n_freqs=n_freqs).apply(
        {"params": {"scale": g, "bias": b}}, jnp.asarray(x))
    mod = TL.LayerNormalization4D(6, n_freqs=n_freqs)
    mod.load_state_dict({"gamma": torch.from_numpy(g.transpose(0, 3, 1, 2)),
                         "beta": torch.from_numpy(b.transpose(0, 3, 1, 2))})
    with torch.no_grad():
        got = mod(_cf(x))
    # single-pass (JAX) vs two-pass (port) variance
    np.testing.assert_allclose(_cl(got), np.asarray(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("shape", [(2, 11, 6), (2, 5, 4, 6)])
def test_batch_norm_eval(shape):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape).astype(np.float32)
    g, b = _affine(rng, (6,))
    mean = (0.2 * rng.standard_normal(6)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    ref = JL.BatchNorm(6).apply(
        {"params": {"BatchNorm_0": {"scale": g, "bias": b}},
         "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}},
        jnp.asarray(x), train=False)
    mod = TL.BatchNorm(6).eval()
    mod.load_state_dict({
        "weight": torch.from_numpy(g), "bias": torch.from_numpy(b),
        "running_mean": torch.from_numpy(mean),
        "running_var": torch.from_numpy(var),
        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = mod(_cf(x))
    np.testing.assert_allclose(_cl(got), np.asarray(ref), atol=ATOL, rtol=RTOL)
