"""Port K4 (the gen-1 SRU recurrence) and its layer functions against
rtfs_tpu's ``ops/sru_pallas.py``, the Pallas kernels in interpret mode.

The port's plain versions (the ones its CUDA kernels are held against on
the card) run on the CPU, forward and backward, through the same autograd
Function the card uses. Shapes are small and ragged: T not a multiple of
the Pallas op's 32-step chunk, B not a multiple of its 128 lanes, H 8 and
32; inputs from numpy seeds. The port's layer functions are time-major
(L, D, B), JAX's batch-major (B, L, D): the tests transpose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops import sru_pallas as jsp
from rtfs_tpu_torch.ops import sru_pallas as tsp

# f32 forward: the same gate math step by step (XLA's and torch's sigmoid
# round differently by an ulp or so)
ATOL, RTOL = 2e-5, 1e-5
# gradients, relative to each output's max |grad|: BPTT through T
# contracting steps, and (v, b) sums over T * B terms in another order
GRAD_REL = 1e-4


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _vb(rng, h):
    return _np(rng, (2, h), 0.3), _np(rng, (2, h), 0.1)


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= GRAD_REL * scale, (what, err, scale)


SHAPES = [(37, 8, 5), (45, 32, 131), (9, 32, 64)]


@pytest.mark.parametrize("t_len,h,bsz", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_pallas_interpret(t_len, h, bsz, reverse):
    """The reverse walk equals JAX's flip-run-flip."""
    rng = np.random.default_rng(0)
    u, x = _np(rng, (t_len, 3 * h, bsz)), _np(rng, (t_len, h, bsz))
    v, b = _vb(rng, h)
    flip = (lambda a: a[::-1]) if reverse else (lambda a: a)  # noqa: E731
    ref = flip(np.asarray(jsp.sru_recurrence(
        jnp.asarray(flip(u)), jnp.asarray(flip(x)), jnp.asarray(v),
        jnp.asarray(b), True)))
    got = tsp.sru_recurrence(torch.from_numpy(u), torch.from_numpy(x),
                             torch.from_numpy(v), torch.from_numpy(b),
                             reverse=reverse)
    assert got.grad_fn is None  # serving: no Function, no c
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    h_c, c = tsp.sru_recurrence_plain(torch.from_numpy(u), torch.from_numpy(x),
                                      torch.cat([torch.from_numpy(v),
                                                 torch.from_numpy(b)]),
                                      reverse, with_c=True)
    np.testing.assert_array_equal(h_c.numpy(), got.numpy())
    assert c.shape == h_c.shape


@pytest.mark.parametrize("t_len,h,bsz", SHAPES)
def test_recurrence_grads_match_jax_vjp(t_len, h, bsz):
    """The Function's gradients (du, dxhw, dv, db) and the plain backward
    against ``jax.vjp`` of the Pallas op (its ``_sru_vjp_bwd``)."""
    rng = np.random.default_rng(1)
    u, x = _np(rng, (t_len, 3 * h, bsz)), _np(rng, (t_len, h, bsz))
    v, b = _vb(rng, h)
    dh = _np(rng, (t_len, h, bsz))
    ref = jax.jit(lambda dh_, *a: jax.vjp(
        lambda *p: jsp.sru_recurrence(*p, True), *a)[1](dh_))(
            *map(jnp.asarray, (dh, u, x, v, b)))
    ins = [_t(a) for a in (u, x, v, b)]
    out = tsp.sru_recurrence(*ins)
    assert isinstance(out.grad_fn, tsp._Recurrence._backward_cls)
    out.backward(torch.from_numpy(dh))
    for name, g, w in zip(("u", "xhw", "v", "b"), ins, ref):
        _grad_close(g.grad, w, name)

    vb = torch.from_numpy(np.concatenate([v, b]))
    _, c = tsp.sru_recurrence_plain(torch.from_numpy(u), torch.from_numpy(x),
                                    vb, with_c=True)
    du, dxhw, dvb = tsp.sru_recurrence_bwd_plain(
        torch.from_numpy(u), torch.from_numpy(x), vb, c, torch.from_numpy(dh))
    _grad_close(du, ref[0], "plain du")
    _grad_close(dxhw, ref[1], "plain dxhw")
    _grad_close(dvb, np.concatenate([ref[2], ref[3]]), "plain dvb")


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_function_gradcheck(reverse):
    rng = np.random.default_rng(2)
    t_len, h, bsz = 6, 3, 2

    def f64(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale
                                ).requires_grad_()

    ins = (f64((t_len, 3 * h, bsz)), f64((t_len, h, bsz)), f64((2, h), 0.3),
           f64((2, h), 0.3))
    assert torch.autograd.gradcheck(
        lambda u, x, v, b: tsp.sru_recurrence(u, x, v, b, reverse), ins)


def test_backward_plain_matches_autograd_of_plain_forward():
    """The step-by-step plain BPTT equals torch autograd through the plain
    forward (the third reference the card holds K4's backward against)."""
    rng = np.random.default_rng(3)
    t_len, h, bsz = 9, 4, 3
    u = torch.from_numpy(rng.standard_normal((t_len, 3 * h, bsz))
                         ).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((t_len, h, bsz))).requires_grad_()
    vb = torch.from_numpy(rng.standard_normal((4, h)) * 0.3).requires_grad_()
    dh = torch.from_numpy(rng.standard_normal((t_len, h, bsz)))
    for reverse in (False, True):
        out, c = tsp.sru_recurrence_plain(u, x, vb, reverse, with_c=True)
        want = torch.autograd.grad(out, (u, x, vb), dh)
        got = tsp.sru_recurrence_bwd_plain(u.detach(), x.detach(),
                                           vb.detach(), c.detach(), dh,
                                           reverse)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


def _jax_value_and_grads(jfn, *args):
    """jfn(*args) and d(sum sin(jfn))/d(args), in one jit."""
    def loss(*a):
        out = jfn(*a)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(
            *map(jnp.asarray, args))
    return np.asarray(out), grads


def _layer_params(rng, d_in, h, dirs):
    k = 4 if d_in != dirs * h else 3
    return (_np(rng, (d_in, dirs * k * h), 0.3), _np(rng, (dirs, 2, h), 0.3),
            _np(rng, (dirs, 2, h), 0.1))


@pytest.mark.parametrize("d_in,h,dirs", [
    (12, 8, 1),   # dirs 1, k 4
    (8, 8, 1),    # dirs 1, k 3: the highway is the input
    (16, 8, 2),   # dirs 2, k 3: the reverse direction through the flag
    (24, 32, 1),  # the hidden width of RTFS-Net-4
])
def test_sru_layer_tpu_matches_jax(d_in, h, dirs):
    """Forward and d(sum sin(out)) for x, weight, weight_c and bias."""
    rng = np.random.default_rng(4)
    bsz, length = 5, 37
    x = _np(rng, (bsz, length, d_in))
    w, wc, b = _layer_params(rng, d_in, h, dirs)

    def jfn(x_, w_, wc_, b_):
        return jsp.sru_layer_tpu(x_, w_, wc_, b_, h, dirs == 2,
                                 interpret=True)

    ref, grads = _jax_value_and_grads(jfn, x, w, wc, b)
    ins = [_t(a) for a in (x, w, wc, b)]
    out = tsp.sru_layer_tpu(ins[0].permute(1, 2, 0), *ins[1:], h, dirs == 2)
    assert tuple(out.shape) == (length, dirs * h, bsz)
    out = out.permute(2, 0, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL,
                               rtol=RTOL)
    out.sin().sum().backward()
    for name, g, want in zip(("x", "weight", "weight_c", "bias"), ins, grads):
        _grad_close(g.grad, want, name)


@pytest.mark.parametrize("dirs", [1, 2])
def test_sru_layer_tpu_windowed_matches_jax(dirs):
    rng = np.random.default_rng(5)
    bsz, t_len, c, ks, h = 3, 40, 6, 4, 8
    x = _np(rng, (bsz, t_len, c))
    w, wc, b = _layer_params(rng, c * ks, h, dirs)

    def jfn(x_, w_, wc_, b_):
        return jsp.sru_layer_tpu_windowed(x_, w_, wc_, b_, h, dirs == 2,
                                          kernel=ks, interpret=True)

    ref, grads = _jax_value_and_grads(jfn, x, w, wc, b)
    ins = [_t(a) for a in (x, w, wc, b)]
    out = tsp.sru_layer_tpu_windowed(*ins, h, dirs == 2, ks).permute(2, 0, 1)
    assert tuple(out.shape) == ref.shape == (bsz, t_len - ks + 1, dirs * h)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL,
                               rtol=RTOL)
    out.sin().sum().backward()
    for name, g, want in zip(("x", "weight", "weight_c", "bias"), ins, grads):
        _grad_close(g.grad, want, name)


def test_windowed_layer_refuses_an_unprojected_highway():
    """JAX asserts k = 4 on the windowed layer; the port raises."""
    h, ks, c = 8, 2, 4  # C * k == H: k would be 3
    with pytest.raises(ValueError, match="k = 4"):
        tsp.sru_layer_tpu_windowed(torch.zeros(1, 9, c),
                                   torch.zeros(c * ks, 3 * h),
                                   torch.zeros(1, 2, h), torch.zeros(1, 2, h),
                                   h, False, ks)


def test_recurrence_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tsp.sru_recurrence(torch.zeros(4, 9, 2), torch.zeros(4, 2, 2),
                           torch.zeros(2, 3), torch.zeros(2, 3))
