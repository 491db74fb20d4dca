"""Port SRU against rtfs_tpu: the plain K1/K2 versions against the Pallas
kernels in interpret mode, and the stack / module against both JAX backends.

Small shapes as in tests/test_sru_fused.py: a ragged folded batch, T not a
multiple of 8, several layers. The port's CPU path runs the plain versions
that its CUDA kernels are held against on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops import sru as jsru
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu_torch.ops import sru as tsru
from rtfs_tpu_torch.ops import sru_fused as tfused
from rtfs_tpu_torch.utils.weights import load_jax_params

# f32 recurrence: identical gate math, dot products of <= 64 terms summed in
# another order; errors stay at a few ulps through the tanh-like gates
ATOL, RTOL = 2e-5, 1e-4


def _vb(rng, h):
    v = (rng.standard_normal((2, 2, h)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((2, 2, h)) * 0.1).astype(np.float32)
    return v, b


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (37, 4, 3)])
def test_plain_k1_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(0)
    u_f = rng.standard_normal((t_len, 4 * h, bsz)).astype(np.float32)
    u_r = rng.standard_normal((t_len, 4 * h, bsz)).astype(np.float32)
    v, b = _vb(rng, h)
    ref = jfused.sru_dual_recurrence(
        jnp.asarray(u_f), jnp.asarray(u_r),
        jfused._vb_pack(jnp.asarray(v), jnp.asarray(b)), True)
    got = tfused.sru_dual_recurrence(
        torch.from_numpy(u_f), torch.from_numpy(u_r),
        tfused.vb_pack(torch.from_numpy(v), torch.from_numpy(b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (37, 4, 3)])
def test_plain_k2_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(1)
    x_f = (rng.standard_normal((t_len, h, bsz)) * 0.5).astype(np.float32)
    x_r = (rng.standard_normal((t_len, h, bsz)) * 0.5).astype(np.float32)
    wt = (rng.standard_normal((6 * h, 2 * h)) * 0.3).astype(np.float32)
    v, b = _vb(rng, h)
    ref = jfused.sru_hidden_layer(
        jnp.asarray(x_f), jnp.asarray(x_r), jnp.asarray(wt),
        jfused._vb_pack(jnp.asarray(v), jnp.asarray(b)), True)
    got = tfused.sru_hidden_layer(
        torch.from_numpy(x_f), torch.from_numpy(x_r), torch.from_numpy(wt),
        tfused.vb_pack(torch.from_numpy(v), torch.from_numpy(b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


def test_plain_k2_matches_pallas_interpret_at_h_300():
    """K2 above H 268, where the port's kernel streams its projection: the
    plain version the card is held against agrees with the Pallas kernel,
    whose (6H, 2H) weight block has no such limit. Dot products of 600
    terms (scaled to unit variance), the same tolerances."""
    t_len, h, bsz = 5, 300, 4
    rng = np.random.default_rng(2)
    x_f = (rng.standard_normal((t_len, h, bsz)) * 0.5).astype(np.float32)
    x_r = (rng.standard_normal((t_len, h, bsz)) * 0.5).astype(np.float32)
    wt = (rng.standard_normal((6 * h, 2 * h)) * (2 * h) ** -0.5).astype(
        np.float32)
    v, b = _vb(rng, h)
    ref = jfused.sru_hidden_layer(
        jnp.asarray(x_f), jnp.asarray(x_r), jnp.asarray(wt),
        jfused._vb_pack(jnp.asarray(v), jnp.asarray(b)), True)
    got = tfused.sru_hidden_layer(
        torch.from_numpy(x_f), torch.from_numpy(x_r), torch.from_numpy(wt),
        tfused.vb_pack(torch.from_numpy(v), torch.from_numpy(b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


def _stack_params(rng, d_in0, h, n_layers):
    ws, wcs, bs = [], [], []
    for layer in range(n_layers):
        d_in = d_in0 if layer == 0 else 2 * h
        k = 4 if d_in != 2 * h else 3
        ws.append((rng.standard_normal((d_in, 2 * k * h)) * 0.15
                   ).astype(np.float32))
        v, b = _vb(rng, h)
        wcs.append(v)
        bs.append(b)
    return ws, wcs, bs


@pytest.mark.parametrize("time_major", [False, True])
def test_sru_stack_matches_fused_interpret(time_major):
    rng = np.random.default_rng(2)
    bsz, t_len, c, ks, h = 3, 27, 6, 4, 8
    x = rng.standard_normal((bsz, t_len, c)).astype(np.float32)
    ws, wcs, bs = _stack_params(rng, c * ks, h, 3)
    ref = jfused.sru_stack_tpu(
        jnp.asarray(x), [jnp.asarray(a) for a in ws],
        [jnp.asarray(a) for a in wcs], [jnp.asarray(a) for a in bs], h,
        window=(ks, 1), interpret=True, time_major=time_major)
    tt = lambda arrs: [torch.from_numpy(a) for a in arrs]  # noqa: E731
    got = tfused.sru_stack(torch.from_numpy(x), tt(ws), tt(wcs), tt(bs), h,
                           window=(ks, 1), time_major=time_major)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize(
    "backend,input_size,hidden,layers,window,bidir",
    [
        ("interpret", 24, 8, 4, (4, 1), True),  # the fused stack, windowed
        ("scan", 24, 8, 4, (4, 1), True),
        ("scan", 20, 4, 2, None, True),         # fused stack, no window
        ("scan", 16, 8, 2, None, True),         # k = 3 on layer 0: plain scan
        ("scan", 12, 8, 2, None, False),        # unidirectional: plain scan
        # K4 (ops/sru_pallas.py) against JAX's Pallas gen-1 path
        ("interpret", 24, 8, 3, (4, 1), False),  # unidirectional, windowed
        ("interpret", 12, 8, 2, None, False),    # unidirectional, k = 4
        ("interpret", 8, 8, 2, None, False),     # unidirectional, k = 3
        ("interpret", 16, 8, 2, None, True),     # bidirectional, input 2H
    ],
)
def test_sru_module_matches_jax(backend, input_size, hidden, layers, window,
                                bidir):
    rng = np.random.default_rng(3)
    c = input_size // window[0] if window else input_size
    x = rng.standard_normal((2, 19, c)).astype(np.float32)
    kw = dict(input_size=input_size, hidden_size=hidden, num_layers=layers,
              bidirectional=bidir, window=window)
    jmod = jsru.SRU(backend=backend, **kw)
    variables = jax.tree.map(np.asarray,
                             jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = tsru.SRU(**kw)
    load_jax_params(tmod, variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_sru_layer_reset_gate_reads_updated_cell():
    """One step, hand-computed: r uses c_1, not c_0 (sru package code)."""
    h = 1
    x = torch.tensor([[[2.0]]])  # (B, L, D) with D == dirs*H: k = 3
    w = torch.tensor([[0.5, 1.0, -1.0]])  # [x~, f, r] projections
    v = torch.tensor([[[0.0], [3.0]]])  # (dirs, [v_f, v_r], H)
    b = torch.zeros(1, 2, 1)
    got = tsru.sru_layer(x, w, v, b, h, bidirectional=False)
    f = torch.sigmoid(torch.tensor(2.0))
    c1 = (1 - f) * 1.0
    r = torch.sigmoid(-2.0 + 3.0 * c1)
    assert torch.allclose(got.flatten(), r * c1 + (1 - r) * 2.0)
