"""K1, K2 and K3 forward in bf16 storage: the port's plain bf16 versions
against rtfs_tpu's Pallas kernels in interpret mode, on the same bf16
inputs made from a numpy seed.

The Pallas kernels take bf16 operands and keep their carries and dot
results in float32 (``rtfs_tpu/ops/sru_fused.py:322-323,436-437``,
``rtfs_tpu/ops/convt_tm.py:47-51``); the port's plain versions widen the
bf16 values to float32, compute, and round each stored value once. The
shapes cross a time chunk (``T_CHUNK + 9``), take odd batches and H 8 and
48. Two gates each:

- the port's bf16 output within 2 bf16 ulps of JAX's at every element,
  |diff| <= 2^-7 max(|ref|, 2^-6) (the count of elements that differ at
  all is printed: float32 sums in another order straddle a bf16 rounding
  boundary now and then);
- each side's max error against the float32 Pallas kernel on the same
  values widened, the port's no more than 1.5x JAX's.

A bf16 op that autograd records runs its plain bf16 backward on the CPU
(K1-K3; tests/test_torch_bf16_train.py holds those against JAX's VJPs);
a bf16 packed op raises. ~25 s alone.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtfs_tpu.ops import convt_tm as jconvt
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu_torch.ops import convt_tm as tconvt
from rtfs_tpu_torch.ops import sru_fused as tfused

BF16 = ml_dtypes.bfloat16
T_LONG = jfused.T_CHUNK + 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(rng, shape, scale=1.0):
    """bf16 values as a numpy bf16 array (JAX's input) and the same bits
    as a torch bf16 tensor (the port's)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def ulp_gate(got: np.ndarray, ref: np.ndarray, what: str) -> int:
    """Assert |got - ref| <= 2^-7 max(|ref|, 2^-6) everywhere; returns and
    prints the count of elements that differ at all."""
    diff = np.abs(got - ref)
    bound = 2.0 ** -7 * np.maximum(np.abs(ref), 2.0 ** -6)
    n_diff = int((diff > 0).sum())
    print(f"{what}: {n_diff} of {diff.size} elements differ, max "
          f"{diff.max():.3g}")
    assert (diff <= bound).all(), (what, float((diff / bound).max()))
    return n_diff


def _both_gates(got, ref16, ref32, what):
    """The two gates for one output: ulps against JAX's bf16, and the
    port's error against float32 within 1.5x JAX's."""
    got, ref16, ref32 = (_f32(a) for a in (got, ref16, ref32))
    ulp_gate(got, ref16, what)
    port_err = np.abs(got - ref32).max()
    jax_err = np.abs(ref16 - ref32).max()
    assert port_err <= 1.5 * jax_err + 1e-30, (what, port_err, jax_err)


def _vb(rng, h):
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    return v, b, tfused.vb_pack(tv, tb)


@pytest.mark.parametrize("t_len,h,bsz", [(T_LONG, 8, 5), (T_LONG, 48, 3)])
def test_k1_bf16_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(0)
    u_f, tu_f = _bf(rng, (t_len, 4 * h, bsz))
    u_r, tu_r = _bf(rng, (t_len, 4 * h, bsz))
    v, b, tvb = _vb(rng, h)
    vb = jfused._vb_pack(jnp.asarray(v), jnp.asarray(b))
    ref16 = jfused.sru_dual_recurrence(jnp.asarray(u_f), jnp.asarray(u_r),
                                       vb, True)
    ref32 = jfused.sru_dual_recurrence(
        jnp.asarray(_f32(u_f)), jnp.asarray(_f32(u_r)), vb.astype(jnp.float32),
        True)
    got = tfused.sru_dual_recurrence(tu_f, tu_r, tvb)
    for g, r16, r32, name in zip(got, ref16, ref32, ("h_f", "h_r")):
        assert g.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
        _both_gates(g.float().numpy(), r16, r32, f"K1 {name}")


@pytest.mark.parametrize("t_len,h,bsz", [(T_LONG, 8, 5), (T_LONG, 48, 3)])
def test_k2_bf16_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(1)
    x_f, tx_f = _bf(rng, (t_len, h, bsz), 0.5)
    x_r, tx_r = _bf(rng, (t_len, h, bsz), 0.5)
    wt, twt = _bf(rng, (6 * h, 2 * h), (2 * h) ** -0.5)
    v, b, tvb = _vb(rng, h)
    vb = jfused._vb_pack(jnp.asarray(v), jnp.asarray(b))
    ref16 = jfused.sru_hidden_layer(jnp.asarray(x_f), jnp.asarray(x_r),
                                    jnp.asarray(wt), vb, True)
    ref32 = jfused.sru_hidden_layer(
        jnp.asarray(_f32(x_f)), jnp.asarray(_f32(x_r)), jnp.asarray(_f32(wt)),
        vb.astype(jnp.float32), True)
    got = tfused.sru_hidden_layer(tx_f, tx_r, twt, tvb)
    for g, r16, r32, name in zip(got, ref16, ref32, ("h_f", "h_r")):
        assert g.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
        _both_gates(g.float().numpy(), r16, r32, f"K2 {name}")


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(T_LONG, 64, 64, 5, 8), (21, 48, 16, 3, 5)])
def test_k3_bf16_matches_pallas_interpret(length, c_in, c_out, bsz, k):
    rng = np.random.default_rng(2)
    x, tx = _bf(rng, (length, c_in, bsz))
    w, tw = _bf(rng, (k, c_out, c_in), 0.1)
    ref16 = jconvt.convt1d_ola_tm(jnp.asarray(x), jnp.asarray(w), True)
    ref32 = jconvt.convt1d_ola_tm(jnp.asarray(_f32(x)), jnp.asarray(_f32(w)),
                                  True)
    got = tconvt.convt1d_ola_tm(tx, tw)
    assert got.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    _both_gates(got.float().numpy(), ref16, ref32, "K3")


@pytest.mark.parametrize("op", ["k1", "k2", "k3", "packed"])
def test_bf16_ops_refuse_autograd_on_the_cpu(op):
    """K1, K2 and K3 take bf16 gradients, on the CPU through their plain
    bf16 backward (the card's kernels are in tests/test_torch_cuda_kernels
    .py): a recorded bf16 op's gradients are bf16 and equal the plain
    backward's. A recorded bf16 packed op (K5), refused while K5-K9 had no
    bf16 backward, now takes bf16 gradients through its Function: dx the
    plain bf16 forward on the flipped taps, dW the plain wgrad of the bf16
    operands rounded once (no float32 backward instead); not recorded
    (serving) it runs as before."""
    from rtfs_tpu_torch.ops import packed_tf as P

    rng = np.random.default_rng(3)
    _, vb = _bf(rng, (8, 8))
    if op == "packed":
        _, xp = _bf(rng, (2, 9, 4 * 8))
        _, w = _bf(rng, (3, 3, 8))
        ins = [xp.clone().requires_grad_(), w.clone().requires_grad_()]
        out = P.dw_conv_packed(*ins, None, 4, 8, (1, 1), (1, 1))
        _, g = _bf(rng, tuple(out.shape), 0.1)
        dx, dw = torch.autograd.grad(out, ins, g)
        assert dx.dtype == dw.dtype == torch.bfloat16
        assert torch.equal(dx, P.dw_conv_packed_plain(
            g, torch.flip(w, (0, 1)), None, 4, 8, (1, 1), (1, 1)))
        assert torch.equal(dw, P.dw_conv_packed_wgrad_plain(
            xp.float(), g.float(), 4, 8, (3, 3), (1, 1), (1, 1)).to(
                torch.bfloat16))
        with torch.no_grad():  # serving: not recorded, runs
            assert P.dw_conv_packed(xp, w, None, 4, 8, (1, 1),
                                    (1, 1)).dtype == torch.bfloat16
        return
    if op == "k1":
        _, u_f = _bf(rng, (9, 32, 4))
        _, u_r = _bf(rng, (9, 32, 4))
        args, fwd = [u_f, u_r, vb], tfused.sru_dual_recurrence
        c = tfused.sru_dual_recurrence_plain(u_f, u_r, vb, True)[2:]
        plain = lambda dh: tfused.sru_dual_recurrence_bwd_plain(  # noqa: E731
            u_f, u_r, vb, *c, *dh)
    elif op == "k2":
        _, x_f = _bf(rng, (9, 8, 5))
        _, x_r = _bf(rng, (9, 8, 5))
        _, wt = _bf(rng, (48, 16), 0.25)
        args, fwd = [x_f, x_r, wt, vb], tfused.sru_hidden_layer
        c = tfused.sru_hidden_layer_plain(x_f, x_r, wt, vb, True)[2:]
        plain = lambda dh: tfused.sru_hidden_layer_bwd_plain(  # noqa: E731
            x_f, x_r, wt, vb, *c, *dh)
    else:
        _, x = _bf(rng, (9, 16, 4))
        _, w = _bf(rng, (3, 8, 16))
        args, fwd = [x, w], tconvt.convt1d_ola_tm
        plain = lambda g: tconvt.convt1d_ola_tm_bwd_plain(  # noqa: E731
            *g, x, w)
    ins = [a.clone().requires_grad_() for a in args]
    outs = fwd(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [_bf(rng, tuple(o.shape), 0.1)[1] for o in outs]
    grads = torch.autograd.grad(outs, ins, cots)
    for g, w in zip(grads, plain(cots)):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        assert torch.equal(g, w)
