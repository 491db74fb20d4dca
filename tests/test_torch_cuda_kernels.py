"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need a GPU and nvcc and skip without them. On a
machine with a card: ``python -m pytest tests/test_torch_cuda_kernels.py``.
Whether a card is present is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# the kernels sum dot products in another order than the plain versions'
# matmuls; gates are elementwise (see chip_smoke.py for the same bounds)
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (57, 32, 125), (3, 32, 300)])
def test_k1_k2_match_plain(dev, t_len, h, bsz):
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(0)
    vb = _t(rng, (8, h), dev, 0.3)
    u_f, u_r = _t(rng, (t_len, 4 * h, bsz), dev), _t(rng, (t_len, 4 * h, bsz), dev)
    for g, w in zip(S.sru_dual_recurrence(u_f, u_r, vb),
                    S.sru_dual_recurrence_plain(u_f, u_r, vb)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    x_f, x_r = _t(rng, (t_len, h, bsz), dev, 0.5), _t(rng, (t_len, h, bsz), dev, 0.5)
    wt = _t(rng, (6 * h, 2 * h), dev, 0.2)
    for g, w in zip(S.sru_hidden_layer(x_f, x_r, wt, vb),
                    S.sru_hidden_layer_plain(x_f, x_r, wt, vb)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 125, 8), (13, 32, 48, 17, 5)])
def test_k3_matches_plain(dev, length, c_in, c_out, bsz, k):
    from rtfs_tpu_torch.ops import convt_tm as K

    rng = np.random.default_rng(1)
    x = _t(rng, (length, c_in, bsz), dev)
    w = _t(rng, (k, c_out, c_in), dev, 0.1)
    torch.testing.assert_close(K.convt1d_ola_tm(x, w),
                               K.convt1d_ola_tm_plain(x, w), atol=ATOL, rtol=0)


def test_wrappers_reject_bad_input(dev):
    from rtfs_tpu_torch.ops import sru_fused as S

    u = torch.zeros(4, 32, 3, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        S.sru_dual_recurrence(u, u, torch.zeros(8, 8, device=dev,
                                                dtype=torch.float64))
    u = torch.zeros(4, 3, 32, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        S.sru_dual_recurrence(u, u, torch.zeros(8, 8, device=dev))


def test_dual_path_rnn_card_matches_cpu(dev):
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(16, 8, dim=4, kernel_size=4, num_layers=3)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 11, 13)).astype(np.float32))
    with torch.no_grad():
        want = m(x)
        kernel_lib.reset_launches()
        got = m.to(dev)(x.to(dev)).cpu()
    assert kernel_lib.LAUNCHES == {"sru_dual_recurrence_fwd": 1,
                                   "sru_hidden_layer_fwd": 2,
                                   "convt1d_ola_tm_fwd": 1}
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
