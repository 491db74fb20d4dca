"""Widths above the preset's, on the same kernels, against the JAX
package, on the CPU.

The JAX package takes its fused SRU stack and its time-major ConvT kernel
at any width. The port does too: K3 splits channels wider than one block
holds over its grid (``ops/convt_tm.fwd_geometry``, ``bwd_geometry``), K2
forward splits an H whose weight does not fit one block into slices of
units (``ops/sru_fused.k2_fwd_geometry``), and K6 takes any bottleneck
width a launch a slice of W. These tests pin the splits at the widths
once refused, check that no geometry function raises at any width from 8
to 160, hold the port's DualPathRNN at H 48 and H 80 (fused stack and
time-major tail, as at the preset) to rtfs_tpu's (its fused stack and
ConvT kernel in interpret mode) forward and gradients, and hold
``chip_smoke.rnn_launches`` to a counted forward and train step. About
25 s alone (the two JAX modules' jitted gradients, module-scoped).

Tolerances: ``tests/test_torch_sru.py``'s (atol 2e-5, rtol 1e-4) on the
outputs; the gradients to 2e-4 of each tensor's largest, as
``tests/test_torch_avnet_uni.py`` holds a DualPathRNN's.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from rtfs_tpu.models import rnn_blocks as JR
from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
from rtfs_tpu_torch.ops import convt_tm, kernel_lib, packed_tf, sru_fused
from rtfs_tpu_torch.ops import sru_pallas
from rtfs_tpu_torch.utils.weights import load_jax_params

ATOL, RTOL = 2e-5, 1e-4  # tests/test_torch_sru.py
GRAD_REL = 2e-4          # tests/test_torch_avnet_uni.py, MODEL_GRAD_REL
C, K, LAYERS = 16, 4, 2
X_SHAPE = (2, 21, 13, C)  # JAX layout (B, T, F, C)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module (the suite's workers share the
    cores; the plain recurrences are many small ops), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("c_in,in_slices", [(64, 1), (80, 2), (96, 2),
                                             (128, 2), (160, 3), (512, 8)])
def test_k3_splits_wide_input_channels_over_the_grid(c_in, in_slices):
    """At the preset's C_out 64 and k 8: 2H 64 is one block (the preset's
    launch); wider inputs, once refused, are split into the fewest equal
    slices whose W_flat and ring fit a block (forward), and into blocks of
    MAX_IN rows of dx (backward), the output channels one slice."""
    fwd = convt_tm.fwd_geometry(57, c_in, 64, 8, 500)
    bwd = convt_tm.bwd_geometry(57, c_in, 64, 8, 500)
    assert fwd["in_slices"] == in_slices == fwd["grid"][2]
    assert fwd["smem"] <= kernel_lib.SMEM_PER_BLOCK
    if in_slices > 1:
        assert convt_tm.fwd_smem(8, -(-c_in // (in_slices - 1)), 64) > \
            kernel_lib.SMEM_PER_BLOCK
    assert bwd["dx_grid"][2] == bwd["in_slices"] == -(-c_in // 64)
    assert bwd["out_slices"] == 1 and bwd["co_slice"] == 64
    assert bwd["dx_smem"] <= kernel_lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("h,units", [(32, 32), (48, 48), (64, 64), (68, 68),
                                     (80, 40), (128, 32), (268, 8)])
def test_k2_forward_splits_wide_h_over_the_grid(h, units):
    """Every H up to 68 is one slice (the preset's H 32 unchanged); a wider
    H, once refused, is split into the fewest equal slices of units whose
    rows of W_d fit one block beside the chunks."""
    geo = sru_fused.k2_fwd_geometry(57, h, 500)
    assert geo["units"] == units and geo["slices"] == -(-h // units)
    assert geo["grid"][2] == geo["slices"]
    assert geo["smem"] <= kernel_lib.SMEM_PER_BLOCK


@settings(max_examples=60, deadline=None)
@given(h=st.integers(8, 160), c_out=st.integers(8, 160),
       k=st.integers(1, 9), t_len=st.integers(1, 130),
       bsz=st.integers(1, 1100))
def test_every_width_fits_every_geometry(h, c_out, k, t_len, bsz):
    """At any width from 8 to 160, any T and B, no geometry function of
    the fused stack, K4, K3 or K6 raises or sizes a block above one
    block's shared memory."""
    assert sru_fused.k1_fwd_geometry(t_len, h, bsz)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK
    assert sru_fused.k2_fwd_geometry(t_len, h, bsz)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK
    sru_fused.k2_bwd_geometry(t_len, h, bsz)
    for dirs in (1, 2):
        assert sru_fused.scan_bwd_geometry(t_len, h, bsz, dirs)["smem"] <= \
            kernel_lib.SMEM_PER_BLOCK
    assert sru_pallas.k4_fwd_geometry(t_len, h, bsz)["smem"] <= 48 * 1024
    assert convt_tm.fwd_geometry(t_len, 2 * h, c_out, k, bsz)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK
    assert convt_tm.bwd_geometry(t_len, 2 * h, c_out, k, bsz)["dx_smem"] <= \
        kernel_lib.SMEM_PER_BLOCK
    assert packed_tf.pw_proj_geometry(1, 32379, 2 * h * k, c_out)["smem"] <= \
        kernel_lib.SMEM_PER_BLOCK


def test_preset_routes_and_launch_counts_are_unchanged():
    """H 32 at in_chan 64, window 8, 4 layers: the fused stack with K3,
    K1 1 / K2 3 / K3 1 a DualPathRNN forward, K1/K2/K3 8/24/8 and no K4 a
    preset forward, as phases 4 and 6 expect; the wide phase's H 48 and
    H 80 launch the same."""
    import chip_smoke
    from rtfs_tpu_torch.config import load_config

    for h in (32, *chip_smoke.WIDE_HIDDEN):
        assert chip_smoke.rnn_launches(64, h, 8, 4) == {
            "sru_dual_recurrence_fwd": 1, "sru_hidden_layer_fwd": 3,
            "convt1d_ola_tm_fwd": 1}
        m = DualPathRNN(64, h, dim=4, kernel_size=8, num_layers=4)
        assert m.rnn.uses_fused_stack
    per_fwd = {n: 2 * chip_smoke.REPEATS * v
               for n, v in chip_smoke.rnn_launches(64, 32, 8, 4).items()}
    assert per_fwd == chip_smoke.SERVE_LAUNCHES
    assert chip_smoke.k4_launches(load_config(chip_smoke.PRESET)) == 0
    assert chip_smoke.rnn_launches(64, 80, 8, 4, bidirectional=False) == {
        "sru_recurrence_fwd": 4}


@pytest.mark.parametrize("h", [48, 80])
def test_rnn_launches_match_a_counted_forward_and_step(monkeypatch, h):
    """``chip_smoke.rnn_launches`` against the calls that, on the card,
    launch each kernel once: a DualPathRNN's forward and its backward."""
    import chip_smoke
    from rtfs_tpu_torch.models.avnet import init_weights

    calls = {}
    for mod, fn, name in (
            (sru_fused, "_k1_forward", "sru_dual_recurrence_fwd"),
            (sru_fused, "_k1_backward", "sru_dual_recurrence_bwd"),
            (sru_fused, "_k2_forward", "sru_hidden_layer_fwd"),
            (sru_fused, "_k2_backward", "sru_hidden_layer_bwd"),
            (convt_tm, "_forward", "convt1d_ola_tm_fwd"),
            (convt_tm, "_backward", "convt1d_ola_tm_bwd"),
            (sru_pallas, "_k4_forward", "sru_recurrence_fwd"),
            (sru_pallas, "_k4_backward", "sru_recurrence_bwd")):
        def counted(*args, _f=getattr(mod, fn), _n=name, **kwargs):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(mod, fn, counted)
    m = DualPathRNN(C, h, dim=3, kernel_size=K, num_layers=3)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, C, 9, 7)).astype(np.float32))
    with torch.no_grad():
        m(x)
    expect = chip_smoke.rnn_launches(C, h, K, 3)
    assert calls == expect
    calls.clear()
    m(x).square().sum().backward()
    assert calls == {**expect, **{n.replace("_fwd", "_bwd"): v
                                  for n, v in expect.items()}}


def _perturb(rng):
    def perturb(path, x):
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    return perturb


@pytest.fixture(scope="module", params=[48, 80], ids=["h48", "h80"])
def jax_rnn(request):
    """rtfs_tpu's DualPathRNN (dim 3 and dim 4) at hid ``h`` through its
    fused Pallas stack and ConvT kernel in interpret mode: variables,
    output and ``jax.value_and_grad`` of sum(sin(out)) for the parameters
    and the input."""
    h = request.param
    x = np.random.default_rng(2).standard_normal(X_SHAPE).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        for dim in (3, 4):
            jmod = JR.DualPathRNN(in_chan=C, hid_chan=h, dim=dim,
                                  kernel_size=K, rnn_type="SRU",
                                  num_layers=LAYERS, bidirectional=True)
            v = jax.tree.map(np.asarray, jax.jit(jmod.init)(
                jax.random.PRNGKey(dim), jnp.asarray(x)))
            v = jax.tree_util.tree_map_with_path(
                _perturb(np.random.default_rng(dim)), v)

            def loss(params, x_, jmod=jmod):
                y = jmod.apply({"params": params}, x_)
                return jnp.sum(jnp.sin(y)), y

            (_, y), (g_p, g_x) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(v["params"],
                                                     jnp.asarray(x))
            out[dim] = dict(variables=v, y=np.asarray(y), g_params=g_p,
                            g_x=np.asarray(g_x))
    return h, x, out


@pytest.mark.parametrize("dim", [3, 4])
def test_wide_dual_path_rnn_matches_jax(jax_rnn, dim):
    """The port's DualPathRNN at H 48 and H 80 (the fused stack and the
    time-major tail, whose kernels split these widths over their grids on
    the card) against rtfs_tpu's, forward and the gradients of every
    parameter and of the input."""
    h, x, out = jax_rnn
    ref = out[dim]

    def port():
        return load_jax_params(DualPathRNN(C, h, dim=dim, kernel_size=K,
                                           num_layers=LAYERS),
                               ref["variables"])

    tmod = port()
    assert tmod.rnn.uses_fused_stack
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                          ).requires_grad_()
    y = tmod(xt)
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1),
                               ref["y"], atol=ATOL, rtol=RTOL)
    y.sin().sum().backward()
    want = dict(load_jax_params(port(), {"params": ref["g_params"]}
                                ).named_parameters())
    for n, p in tmod.named_parameters():
        scale = want[n].abs().max().item()
        torch.testing.assert_close(p.grad, want[n], rtol=0, msg=n,
                                   atol=GRAD_REL * scale)
    g_x = np.moveaxis(ref["g_x"], -1, 1)
    np.testing.assert_allclose(xt.grad.numpy(), g_x, rtol=0,
                               atol=GRAD_REL * np.abs(g_x).max())
