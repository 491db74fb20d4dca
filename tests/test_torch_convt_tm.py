"""Port K3 (time-major ConvTranspose1d) against rtfs_tpu's Pallas kernel.

The plain version, which the CUDA kernel is held against on the card, runs
against ``convt_tm.convt1d_ola_tm`` in interpret mode at the geometries of
tests/test_convt_tm.py, shrunk in batch.
"""

import numpy as np
import pytest
import torch

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
