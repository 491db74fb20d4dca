"""Port modules against rtfs_tpu on the CPU, weights carried over with
``load_jax_params``.

The JAX variables are initialised and then perturbed (norm scales, biases,
BatchNorm statistics all non-trivial) so that every parameter matters.
DualPathRNN runs the JAX side with ``RTFS_SRU_BACKEND=interpret``, so it
takes the K1/K2/K3 time-major path in Pallas interpret mode, as
tests/test_convt_tm.py does; the port runs the same path with the plain
versions of its CUDA kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.models import attention as JA
from rtfs_tpu.models import fusion_layers as JF
from rtfs_tpu.models import layers as JL
from rtfs_tpu.models import rnn_blocks as JR
from rtfs_tpu.models import separators as JS
from rtfs_tpu_torch.models import attention as TA
from rtfs_tpu_torch.models import fusion_layers as TF
from rtfs_tpu_torch.models import layers as TL
from rtfs_tpu_torch.models import rnn_blocks as TR
from rtfs_tpu_torch.models import separators as TS
from rtfs_tpu_torch.utils.weights import load_jax_params

# f32 end to end through convs, norms, the SRU recurrence and softmax, each
# summing in another order than XLA; a few hundred ulps at O(1) outputs
ATOL, RTOL = 1e-4, 1e-4


def _jax_vars(mod, *args, seed=0):
    """Init ``mod``, move to numpy and perturb every leaf."""
    v = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(seed), *args))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, v)


def _cf(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _run(tmod, variables, *xs):
    load_jax_params(tmod, variables)
    tmod.eval()
    with torch.no_grad():
        out = tmod(*(_cf(x) for x in xs))
    return np.moveaxis(out.numpy(), 1, -1)


def _rand(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cls,shape,args,kwargs", [
    # pre-norm/pre-act, strided 2-D conv (padding (k-1)//2), BatchNorm2d
    ("ConvNormAct", (2, 11, 9, 8), (8, 12, 4),
     dict(stride=2, pre_norm_type="gLN", pre_act_type="PReLU",
          norm_type="BatchNorm2d", act_type="ReLU", is2d=True)),
    # depthwise 1-D, even kernel: torch 'same' pads (1, 2)
    ("ConvNormAct", (2, 13, 6), (6, 6, 4),
     dict(groups=6, norm_type="gLN", act_type="PReLU")),
    # conv -> act -> LN4D over (C, F)
    ("ConvActNorm", (2, 7, 5, 8), (8, 8, 3),
     dict(norm_type="LayerNormalization4D", act_type="PReLU", n_freqs=5,
          is2d=True)),
    # stride 2 means padding 0 here
    ("ConvActNorm", (2, 17, 6), (6, 10, 5),
     dict(stride=2, norm_type="BatchNorm1d", act_type="ReLU")),
])
def test_conv_blocks(cls, shape, args, kwargs):
    x = _rand(shape)
    jmod = getattr(JL, cls)(*args, **kwargs)
    variables = _jax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = _run(getattr(TL, cls)(*args, **kwargs), variables, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dim", [3, 4])
def test_dual_path_rnn_kernel_path(monkeypatch, dim):
    x = _rand((2, 21, 13, 16))
    jmod = JR.DualPathRNN(in_chan=16, hid_chan=8, dim=dim, kernel_size=4,
                          rnn_type="SRU", num_layers=3)
    monkeypatch.setenv("RTFS_SRU_BACKEND", "scan")
    variables = _jax_vars(jmod, jnp.asarray(x))
    monkeypatch.setenv("RTFS_SRU_BACKEND", "interpret")
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = _run(TR.DualPathRNN(16, 8, dim=dim, kernel_size=4, num_layers=3),
               variables, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_mhsa2d():
    x = _rand((2, 9, 7, 16))
    jmod = JA.MultiHeadSelfAttention2D(in_chan=16, n_freqs=7, n_head=4,
                                       hid_chan=4)
    variables = _jax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = _run(TA.MultiHeadSelfAttention2D(16, n_freqs=7, n_head=4,
                                           hid_chan=4), variables, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_global_attention():
    x = _rand((2, 11, 16))
    jmod = JA.GlobalAttention(in_chan=16, kernel_size=3, n_head=4)
    variables = _jax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = _run(TA.GlobalAttention(16, kernel_size=3, n_head=4), variables, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("local_shape,global_shape,norm,is2d", [
    ((2, 12, 10, 8), (2, 6, 5, 8), "gLN", True),    # global upsampled
    ((2, 6, 5, 8), (2, 12, 10, 8), "gLN", True),    # global resized down
    ((2, 25, 8), (2, 7, 8), "BatchNorm1d", False),  # video pyramid
])
def test_injection_multi_sum(local_shape, global_shape, norm, is2d):
    loc, glo = _rand(local_shape, 1), _rand(global_shape, 2)
    jmod = JF.InjectionMultiSum(8, 3, norm, is2d)
    variables = _jax_vars(jmod, jnp.asarray(loc), jnp.asarray(glo))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(loc), jnp.asarray(glo)))
    got = _run(TF.InjectionMultiSum(8, 3, norm, is2d), variables, loc, glo)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("a_shape,b_shape,ca,cb,is2d", [
    ((2, 12, 5, 8), (2, 5, 16), 8, 16, True),  # audio refined by video
    ((2, 12, 8), (2, 5, 16), 8, 16, False),
])
def test_attn_fusion_cell(a_shape, b_shape, ca, cb, is2d):
    a, b = _rand(a_shape, 1), _rand(b_shape, 2)
    jmod = JF.ATTNFusionCell(ca, cb, 4, is2d=is2d)
    variables = _jax_vars(jmod, jnp.asarray(a), jnp.asarray(b))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(a), jnp.asarray(b)))
    got = _run(TF.ATTNFusionCell(ca, cb, 4, is2d=is2d), variables, a, b)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


_AUDIO_LAYERS = (
    {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 4, "kernel_size": 4,
     "stride": 1, "rnn_type": "SRU", "num_layers": 2, "bidirectional": True},
    {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 3, "kernel_size": 4,
     "stride": 1, "rnn_type": "SRU", "num_layers": 2, "bidirectional": True},
    {"layer_type": "MultiHeadSelfAttention2D", "dim": 3, "n_freqs": 6,
     "n_head": 2, "hid_chan": 4, "act_type": "PReLU",
     "norm_type": "LayerNormalization4D"},
)
_VIDEO_LAYERS = (
    {"layer_type": "GlobalAttention", "ffn_name": "FeedForwardNetwork",
     "kernel_size": 3, "n_head": 4, "dropout": 0.1},
)


@pytest.mark.parametrize("shape,args", [
    # RTFS 2-D block: pyramid to (8, 6), DualPathRNN x2 + MHSA2D
    ((1, 17, 13, 16), (16, 8, 4, 2, "gLN", "PReLU", 2, _AUDIO_LAYERS, True)),
    # video 1-D block: BatchNorm1d pyramid of depth 4, GlobalAttention
    ((2, 50, 32), (32, 16, 3, 2, "BatchNorm1d", "PReLU", 4, _VIDEO_LAYERS,
                   False)),
])
def test_tdanet_block(shape, args):
    x = _rand(shape)
    jmod = JS.TDANetBlock(*args)
    variables = _jax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = _run(TS.TDANetBlock(*args), variables, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
