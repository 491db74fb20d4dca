"""Port SRU backward (K1, K2) against rtfs_tpu's Pallas VJPs.

The port's autograd Functions run their plain BPTT on the CPU (the
versions the CUDA backward kernels are held against on the card). They are
compared with ``jax.grad`` / ``jax.vjp`` of the Pallas kernels in interpret
mode on the same numpy inputs, at small shapes (a ragged folded batch, T
not a multiple of 8, three layers), and checked with ``gradcheck`` in
float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu_torch.ops import sru_fused as tfused

# f32 BPTT: the same adjoint formulas summed in another order; the
# reductions (dW, dv, db) sum T * B terms of O(0.1-1), so their error
# grows with that count: atol 3e-5 and rtol 1e-3 as tests/test_sru_fused.py
ATOL, RTOL = 3e-5, 1e-3


def _vb(rng, h):
    v = (rng.standard_normal((2, 2, h)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((2, 2, h)) * 0.1).astype(np.float32)
    return v, b


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=what)


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
def test_sru_stack_grads_match_jax_interpret(time_major):
    """d(sum sin(stack)) for every weight, weight_c, bias and the input."""
    rng = np.random.default_rng(3)
    bsz, t_len, c, ks, h = 3, 21, 6, 4, 8
    x = rng.standard_normal((bsz, t_len, c)).astype(np.float32)
    ws, wcs, bs = _stack_params(rng, c * ks, h, 3)

    def loss(ws_, wcs_, bs_, x_):
        return jnp.sum(jnp.sin(jfused.sru_stack_tpu(
            x_, ws_, wcs_, bs_, h, window=(ks, 1), interpret=True,
            time_major=time_major)))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in wcs],
        [jnp.asarray(a) for a in bs], jnp.asarray(x))
    tw, twc, tb, tx = ([_t(a) for a in ws], [_t(a) for a in wcs],
                       [_t(a) for a in bs], _t(x))
    out = tfused.sru_stack(tx, tw, twc, tb, h, window=(ks, 1),
                           time_major=time_major)
    assert out.grad_fn is not None
    out.sin().sum().backward()
    for name, got, want in (("weights", tw, ref[0]), ("weight_cs", twc, ref[1]),
                            ("biases", tb, ref[2])):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g.grad, w, f"{name}[{i}]")
    _close(tx.grad, ref[3], "x")


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (10, 4, 3)])
def test_k1_vjp_matches_jax_interpret(t_len, h, bsz):
    rng = np.random.default_rng(0)
    u_f, u_r = (rng.standard_normal((t_len, 4 * h, bsz)).astype(np.float32)
                for _ in range(2))
    v, b = _vb(rng, h)
    dh = [rng.standard_normal((t_len, h, bsz)).astype(np.float32)
          for _ in range(2)]

    def fn(u_f_, u_r_, v_, b_):
        return jfused.sru_dual_recurrence(u_f_, u_r_, jfused._vb_pack(v_, b_),
                                          True)

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (u_f, u_r, v, b)))
    ref = vjp(tuple(map(jnp.asarray, dh)))
    ins = [_t(a) for a in (u_f, u_r, v, b)]
    out = tfused.sru_dual_recurrence(ins[0], ins[1],
                                     tfused.vb_pack(ins[2], ins[3]))
    torch.autograd.backward(out, [torch.from_numpy(a) for a in dh])
    for name, g, w in zip(("u_f", "u_r", "v", "b"), ins, ref):
        _close(g.grad, w, name)


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (10, 4, 3)])
def test_k2_vjp_matches_jax_interpret(t_len, h, bsz):
    rng = np.random.default_rng(1)
    x_f, x_r = ((rng.standard_normal((t_len, h, bsz)) * 0.5).astype(np.float32)
                for _ in range(2))
    wt = (rng.standard_normal((6 * h, 2 * h)) * 0.3).astype(np.float32)
    v, b = _vb(rng, h)
    dh = [rng.standard_normal((t_len, h, bsz)).astype(np.float32)
          for _ in range(2)]

    def fn(x_f_, x_r_, wt_, v_, b_):
        return jfused.sru_hidden_layer(x_f_, x_r_, wt_,
                                       jfused._vb_pack(v_, b_), True)

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x_f, x_r, wt, v, b)))
    ref = vjp(tuple(map(jnp.asarray, dh)))
    ins = [_t(a) for a in (x_f, x_r, wt, v, b)]
    out = tfused.sru_hidden_layer(ins[0], ins[1], ins[2],
                                  tfused.vb_pack(ins[3], ins[4]))
    torch.autograd.backward(out, [torch.from_numpy(a) for a in dh])
    for name, g, w in zip(("x_f", "x_r", "wt", "v", "b"), ins, ref):
        _close(g.grad, w, name)


def _f64(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale
                            ).requires_grad_()


def test_k1_function_gradcheck():
    rng = np.random.default_rng(5)
    t_len, h, bsz = 6, 3, 2
    ins = (_f64(rng, (t_len, 4 * h, bsz)), _f64(rng, (t_len, 4 * h, bsz)),
           _f64(rng, (8, h), 0.3))
    assert torch.autograd.gradcheck(tfused._DualRecurrence.apply, ins)


def test_k2_function_gradcheck():
    rng = np.random.default_rng(6)
    t_len, h, bsz = 6, 3, 2
    ins = (_f64(rng, (t_len, h, bsz), 0.5), _f64(rng, (t_len, h, bsz), 0.5),
           _f64(rng, (6 * h, 2 * h), 0.3), _f64(rng, (8, h), 0.3))
    assert torch.autograd.gradcheck(tfused._HiddenLayer.apply, ins)


def test_backward_plain_matches_autograd_of_plain_forward():
    """The step-by-step plain BPTT equals torch autograd through the plain
    forward (the third reference the card holds the kernels against)."""
    rng = np.random.default_rng(7)
    t_len, h, bsz = 9, 4, 3
    u = [_f64(rng, (t_len, 4 * h, bsz)) for _ in range(2)]
    vb = _f64(rng, (8, h), 0.3)
    x = [_f64(rng, (t_len, h, bsz), 0.5) for _ in range(2)]
    wt = _f64(rng, (6 * h, 2 * h), 0.3)
    dh = [torch.from_numpy(rng.standard_normal((t_len, h, bsz)))
          for _ in range(2)]
    for plain, bwd, ins in (
            (tfused.sru_dual_recurrence_plain,
             tfused.sru_dual_recurrence_bwd_plain, (*u, vb)),
            (tfused.sru_hidden_layer_plain, tfused.sru_hidden_layer_bwd_plain,
             (*x, wt, vb))):
        h_f, h_r, c_f, c_r = plain(*ins, with_c=True)
        want = torch.autograd.grad((h_f, h_r), ins, dh)
        got = bwd(*[a.detach() for a in ins], c_f.detach(), c_r.detach(), *dh)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)
