"""Port losses (SDR family and PIT) against rtfs_tpu.losses.

Inputs from numpy seeds; the same arrays go to both packages. Tolerance:
float32 sums of L = 800 products and a 10*log10, in another order; values
are O(1-30 dB), so atol 1e-4 with rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtfs_tpu import losses as J
from rtfs_tpu_torch import losses as T
from rtfs_tpu_torch.losses import pit as tpit

ATOL, RTOL = 1e-4, 1e-5
LENGTH = 800


def _pair(rng, b, n_src):
    targets = rng.standard_normal((b, n_src, LENGTH)).astype(np.float32)
    ests = (targets[:, rng.permutation(n_src)]
            + 0.3 * rng.standard_normal((b, n_src, LENGTH))).astype(np.float32)
    return ests, targets


def _cmp(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["pairwise_neg_sisdr", "pairwise_neg_sdsdr",
                                  "pairwise_neg_snr", "multisrc_neg_sisdr",
                                  "multisrc_neg_snr"])
@pytest.mark.parametrize("zero_mean", [True, False])
def test_sdr_losses_match_jax(name, zero_mean):
    rng = np.random.default_rng(0)
    ests, targets = _pair(rng, 3, 2)
    ests += 0.2  # a DC offset, so zero_mean matters
    want = getattr(J, name)(jnp.asarray(ests), jnp.asarray(targets),
                            zero_mean=zero_mean)
    got = getattr(T, name)(torch.from_numpy(ests), torch.from_numpy(targets),
                           zero_mean=zero_mean)
    _cmp(got, want)


@pytest.mark.parametrize("name", ["singlesrc_neg_sisdr", "singlesrc_neg_snr"])
def test_singlesrc_losses_match_jax(name):
    rng = np.random.default_rng(1)
    ests, targets = _pair(rng, 4, 1)
    want = getattr(J, name)(jnp.asarray(ests[:, 0]), jnp.asarray(targets[:, 0]))
    got = getattr(T, name)(torch.from_numpy(ests[:, 0]),
                           torch.from_numpy(targets[:, 0]))
    _cmp(got, want)


@pytest.mark.parametrize("n_src", [1, 2, 3, 5])  # 5: the Hungarian route
@pytest.mark.parametrize("loss", ["pairwise_neg_sisdr", "pairwise_neg_snr"])
def test_pit_matches_jax(n_src, loss):
    rng = np.random.default_rng(n_src)
    ests, targets = _pair(rng, 3, n_src)
    want_loss, want_ests = J.pit_loss(getattr(J, loss), jnp.asarray(ests),
                                      jnp.asarray(targets), return_ests=True)
    tests = torch.from_numpy(ests).requires_grad_()
    got_loss, got_ests = T.PITLossWrapper(getattr(T, loss))(
        tests, torch.from_numpy(targets), return_ests=True)
    _cmp(got_loss, want_loss)
    np.testing.assert_array_equal(got_ests.detach().numpy(),
                                  np.asarray(want_ests))
    got_loss.backward()  # differentiable through the pairwise matrix
    assert torch.isfinite(tests.grad).all()


def test_find_best_perm_indices_match_jax():
    rng = np.random.default_rng(7)
    for n_src in (2, 3, 5):
        pw = rng.standard_normal((4, n_src, n_src)).astype(np.float32)
        want = J.pit.find_best_perm(jnp.asarray(pw))
        got = tpit.find_best_perm(torch.from_numpy(pw))
        _cmp(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
