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


def _close(got, want, rel=None):
    """Elementwise outputs to ATOL; reductions over T * B terms (dv, db,
    dW) to ``rel`` of their max |value| (chip_smoke.py's BWD_REL_TOL)."""
    for g, w in zip(got, want):
        atol = ATOL if rel is None else rel * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("t_len,h,bsz", [(21, 8, 5), (57, 32, 500),
                                         (118, 32, 256)])
def test_k1_k2_backward_match_plain(dev, t_len, h, bsz):
    """Forward with c and the BPTT kernels against the plain versions."""
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(3)
    vb = _t(rng, (8, h), dev, 0.3)
    u_f, u_r = _t(rng, (t_len, 4 * h, bsz), dev), _t(rng, (t_len, 4 * h, bsz), dev)
    dh_f, dh_r = _t(rng, (t_len, h, bsz), dev), _t(rng, (t_len, h, bsz), dev)
    fwd = S._k1_forward(u_f, u_r, vb, with_c=True)
    _close(fwd, S.sru_dual_recurrence_plain(u_f, u_r, vb, with_c=True))
    c_f, c_r = fwd[2], fwd[3]
    got = S._k1_backward(u_f, u_r, vb, c_f, c_r, dh_f, dh_r)
    want = S.sru_dual_recurrence_bwd_plain(u_f, u_r, vb, c_f, c_r, dh_f, dh_r)
    _close(got[:2], want[:2])
    _close(got[2:], want[2:], rel=1e-4)
    x_f, x_r = _t(rng, (t_len, h, bsz), dev, 0.5), _t(rng, (t_len, h, bsz), dev, 0.5)
    wt = _t(rng, (6 * h, 2 * h), dev, 0.2)
    fwd = S._k2_forward(x_f, x_r, wt, vb, with_c=True)
    _close(fwd, S.sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c=True))
    got = S._k2_backward(x_f, x_r, wt, vb, fwd[2], fwd[3], dh_f, dh_r)
    want = S.sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, fwd[2], fwd[3],
                                        dh_f, dh_r)
    _close(got[:2], want[:2])
    _close(got[2:], want[2:], rel=1e-4)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 500, 8), (118, 64, 64, 256, 8),
                          (13, 32, 48, 17, 5)])
def test_k3_backward_matches_plain(dev, length, c_in, c_out, bsz, k):
    from rtfs_tpu_torch.ops import convt_tm as K

    rng = np.random.default_rng(4)
    x = _t(rng, (length, c_in, bsz), dev)
    w = _t(rng, (k, c_out, c_in), dev, 0.1)
    g = _t(rng, (length + k - 1, c_out, bsz), dev)
    dx, dw = K._backward(g, x, w)
    rx, rw = K.convt1d_ola_tm_bwd_plain(g, x, w)
    torch.testing.assert_close(dx, rx, atol=ATOL, rtol=0)
    _close((dw,), (rw,), rel=1e-4)  # dW sums L * B products


def test_wrappers_give_every_parameter_a_gradient(dev):
    """On the card K1/K2/K3 record autograd: every SRU and ConvT parameter
    of a DualPathRNN gets a gradient from the backward kernels, equal to
    the CPU run's (plain backward)."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(16, 8, dim=3, kernel_size=4, num_layers=3)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 11, 13)).astype(np.float32))
    m(x).square().sum().backward()
    want = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    m.to(dev)
    xd = x.to(dev).requires_grad_()
    kernel_lib.reset_launches()
    y = m(xd)
    assert y.grad_fn is not None
    y.square().sum().backward()
    assert kernel_lib.LAUNCHES == {
        "sru_dual_recurrence_fwd": 1, "sru_hidden_layer_fwd": 2,
        "convt1d_ola_tm_fwd": 1, "sru_dual_recurrence_bwd": 1,
        "sru_hidden_layer_bwd": 2, "convt1d_ola_tm_bwd": 1}
    assert xd.grad is not None
    for n, p in m.named_parameters():
        assert p.grad is not None, n
        scale = want[n].abs().max().item()
        torch.testing.assert_close(p.grad.cpu(), want[n], atol=1e-4 * scale,
                                   rtol=0, msg=n)


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
