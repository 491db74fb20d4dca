"""Port K3 (time-major ConvTranspose1d) against rtfs_tpu's Pallas kernel.

The plain versions, which the CUDA kernels are held against on the card, run
against ``convt_tm.convt1d_ola_tm`` in interpret mode at the geometries of
tests/test_convt_tm.py, shrunk in batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops.convt_tm import convt1d_ola_tm as jconvt
from rtfs_tpu_torch.ops import convt_tm as tconvt


@pytest.mark.parametrize(
    "length,c_in,c_out,bsz,k",
    [
        (58, 64, 64, 12, 8),    # freq-scan geometry
        (119, 64, 64, 8, 8),    # time-scan geometry
        (13, 32, 48, 17, 5),    # ragged batch, odd kernel, c_in != c_out
    ],
)
def test_plain_k3_matches_pallas_interpret(length, c_in, c_out, bsz, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((length, c_in, bsz)).astype(np.float32)
    w = (rng.standard_normal((k, c_out, c_in)) * 0.1).astype(np.float32)
    ref = np.asarray(jconvt(jnp.asarray(x), jnp.asarray(w), True))
    got = tconvt.convt1d_ola_tm(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (length + k - 1, c_out, bsz)
    # sums of k*c_in <= 512 products of O(0.1) terms in another order
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_plain_k3_equals_conv_transpose1d():
    """The shifted-sum plain form is torch's ConvTranspose1d on the
    (B, C_in, L) view with the (C_in, C_out, k) weight."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((9, 6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    ref = torch.nn.functional.conv_transpose1d(x.permute(2, 1, 0),
                                               w.permute(2, 1, 0))
    got = tconvt.convt1d_ola_tm(x, w)
    torch.testing.assert_close(got, ref.permute(2, 1, 0), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "length,c_in,c_out,bsz,k",
    [
        (58, 64, 64, 6, 8),     # freq-scan geometry, batch shrunk
        (13, 32, 48, 17, 5),    # ragged batch, odd kernel, c_in != c_out
    ],
)
def test_k3_vjp_matches_pallas_interpret(length, c_in, c_out, bsz, k):
    """dx and dW of the autograd Function (plain backward on the CPU)
    against ``jax.vjp`` of the Pallas kernel in interpret mode."""
    import jax

    rng = np.random.default_rng(2)
    x = rng.standard_normal((length, c_in, bsz)).astype(np.float32)
    w = (rng.standard_normal((k, c_out, c_in)) * 0.1).astype(np.float32)
    g = rng.standard_normal((length + k - 1, c_out, bsz)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jconvt(a, b, True), jnp.asarray(x),
                     jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tconvt.convt1d_ola_tm(tx, tw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    # dx: sums of k*c_out <= 512 terms of O(0.1); dW: sums of L*B O(1)
    # products, in another order
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_dw),
                               atol=1e-4, rtol=2e-5)


def test_k3_function_gradcheck():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 3, 2))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 4, 3))).requires_grad_()
    assert torch.autograd.gradcheck(tconvt._ConvTranspose.apply, (x, w))


def test_k3_plain_backward_equals_conv_transpose1d_autograd():
    """The plain backward equals torch autograd of ConvTranspose1d on the
    (B, C_in, L) view (grad input plus grad weight)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 6, 4))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 5, 6))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((11, 5, 4)))
    out = torch.nn.functional.conv_transpose1d(x.permute(2, 1, 0),
                                               w.permute(2, 1, 0))
    want = torch.autograd.grad(out, (x, w), g.permute(2, 1, 0))
    got = tconvt.convt1d_ola_tm_bwd_plain(g, x.detach(), w.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-10)
