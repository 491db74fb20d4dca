"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need a GPU and nvcc and skip without them. On a
machine with a card: ``python -m pytest tests/test_torch_cuda_kernels.py``.
Whether a card is present is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from rtfs_tpu_torch.ops.sru_fused import SCAN_AHEAD

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


# small H, the serving shapes at bs 1 and 8 (freq L 57 / B 125 per item,
# time L 118 / B 64), T 1, a ragged B that is a multiple of no tile and T
# a multiple of no chunk, H 48 and 64, and H 80, 128 and 268, whose K2
# forward splits its units over the grid
@pytest.mark.parametrize("t_len,h,bsz", [
    (21, 8, 5), (57, 32, 125), (3, 32, 300), (118, 32, 64), (57, 32, 1000),
    (118, 32, 512), (1, 32, 77), (37, 32, 131), (23, 48, 131), (19, 64, 50),
    (57, 80, 125), (9, 128, 40), (5, 268, 20)])
def test_k1_k2_match_plain(dev, t_len, h, bsz):
    """K1 and K2 forward (serving, and with c) against their plain
    versions; two calls of each give the same bits."""
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(0)
    vb = _t(rng, (8, h), dev, 0.3)
    u_f, u_r = _t(rng, (t_len, 4 * h, bsz), dev), _t(rng, (t_len, 4 * h, bsz), dev)
    k1 = S.sru_dual_recurrence(u_f, u_r, vb)
    for g, w in zip(k1, S.sru_dual_recurrence_plain(u_f, u_r, vb)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    k1_c = S._k1_forward(u_f, u_r, vb, with_c=True)
    for g, w in zip(k1_c, S.sru_dual_recurrence_plain(u_f, u_r, vb, True)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    for a, b in zip(k1 + k1_c[:2], S.sru_dual_recurrence(u_f, u_r, vb) * 2):
        assert torch.equal(a, b)  # c written or not, the same h
    x_f, x_r = _t(rng, (t_len, h, bsz), dev, 0.5), _t(rng, (t_len, h, bsz), dev, 0.5)
    wt = _t(rng, (6 * h, 2 * h), dev, 0.2)
    got = S.sru_hidden_layer(x_f, x_r, wt, vb)
    for g, w in zip(got, S.sru_hidden_layer_plain(x_f, x_r, wt, vb)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    with_c = S._k2_forward(x_f, x_r, wt, vb, with_c=True)
    for g, w in zip(with_c, S.sru_hidden_layer_plain(x_f, x_r, wt, vb, True)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    for a, b in zip(got, with_c[:2]):  # c written or not, the same h
        assert torch.equal(a, b)
    for a, b in zip(got, S.sru_hidden_layer(x_f, x_r, wt, vb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t_len,h,bsz", [(57, 300, 125), (5, 300, 64),
                                          (9, 512, 33), (3, 1024, 8)])
def test_k2_forward_streams_a_wide_h(dev, t_len, h, bsz):
    """K2 forward above H 268 (the reduction streamed through shared
    memory) against its plain version, serving and with c; two calls give
    the same bits."""
    from rtfs_tpu_torch.ops import sru_fused as S

    assert S.k2_fwd_geometry(t_len, h, bsz)["stream"]
    rng = np.random.default_rng(11)
    vb = _t(rng, (8, h), dev, 0.3)
    x_f = _t(rng, (t_len, h, bsz), dev, 0.5)
    x_r = _t(rng, (t_len, h, bsz), dev, 0.5)
    wt = _t(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    got = S._k2_forward(x_f, x_r, wt, vb, with_c=True)
    for g, w in zip(got, S.sru_hidden_layer_plain(x_f, x_r, wt, vb, True)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    for a, b in zip(got, S._k2_forward(x_f, x_r, wt, vb, with_c=True)):
        assert torch.equal(a, b)
    for a, b in zip(got, S.sru_hidden_layer(x_f, x_r, wt, vb)):
        assert torch.equal(a, b)  # c written or not, the same h


def _close(got, want, rel=None):
    """Elementwise outputs to ATOL; reductions over T * B terms (dv, db,
    dW) to ``rel`` of their max |value| (chip_smoke.py's BWD_REL_TOL)."""
    for g, w in zip(got, want):
        atol = ATOL if rel is None else rel * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


# the two training geometries at bs 4, a ragged B that is a multiple of no
# tile (64, 32, 128), T = 1, H above 32 (H 80: K2 forward's units in two
# slices); the scan's ring: T shorter than it, as long, one step longer;
# one column
@pytest.mark.parametrize("t_len,h,bsz", [
    (21, 8, 5), (57, 32, 500), (118, 32, 256), (37, 32, 131), (1, 32, 77),
    (23, 48, 131), (SCAN_AHEAD // 2, 32, 200), (SCAN_AHEAD, 48, 64),
    (SCAN_AHEAD + 1, 32, 131), (23, 32, 1), (19, 80, 64)])
def test_k1_k2_backward_match_plain(dev, t_len, h, bsz):
    """Forward with c and the BPTT kernels against the plain versions; two
    K1 and two K2 backward calls give the same bits."""
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
    again = S._k1_backward(u_f, u_r, vb, c_f, c_r, dh_f, dh_r)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    x_f, x_r = _t(rng, (t_len, h, bsz), dev, 0.5), _t(rng, (t_len, h, bsz), dev, 0.5)
    wt = _t(rng, (6 * h, 2 * h), dev, 0.2)
    fwd = S._k2_forward(x_f, x_r, wt, vb, with_c=True)
    _close(fwd, S.sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c=True))
    got = S._k2_backward(x_f, x_r, wt, vb, fwd[2], fwd[3], dh_f, dh_r)
    want = S.sru_hidden_layer_bwd_plain(x_f, x_r, wt, vb, fwd[2], fwd[3],
                                        dh_f, dh_r)
    _close(got[:2], want[:2])
    _close(got[2:], want[2:], rel=1e-4)
    again = S._k2_backward(x_f, x_r, wt, vb, fwd[2], fwd[3], dh_f, dh_r)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h", [32, 48])
def test_k2_function_matches_autograd_of_plain(dev, h):
    """K2's Function (forward with c, the backward kernel) against autograd
    through the plain forward on the same card inputs, at the preset's H
    and above 32."""
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(18)
    t_len, bsz = 29, 131

    def leaf(shape, scale=1.0):
        return _t(rng, shape, dev, scale).requires_grad_()

    ins = (leaf((t_len, h, bsz), 0.5), leaf((t_len, h, bsz), 0.5),
           leaf((6 * h, 2 * h), (2 * h) ** -0.5), leaf((8, h), 0.3))
    dh = (_t(rng, (t_len, h, bsz), dev), _t(rng, (t_len, h, bsz), dev))
    got = torch.autograd.grad(S.sru_hidden_layer(*ins), ins, dh)
    plain = S.sru_hidden_layer_plain(*ins)
    _close(got, torch.autograd.grad(plain, ins, dh), rel=1e-4)


# the two training geometries at bs 4, small channels and taps, a ragged B
# that is a multiple of no tile (32, 64), T = 1
@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 500, 8), (118, 64, 64, 256, 8),
                          (13, 32, 48, 17, 5), (37, 64, 64, 131, 8),
                          (1, 64, 64, 77, 8), (57, 96, 64, 125, 8),
                          (7, 160, 130, 40, 8)])
def test_k3_backward_matches_plain(dev, length, c_in, c_out, bsz, k):
    """K3 backward against the plain version; two calls give the same
    bits."""
    from rtfs_tpu_torch.ops import convt_tm as K

    rng = np.random.default_rng(4)
    x = _t(rng, (length, c_in, bsz), dev)
    w = _t(rng, (k, c_out, c_in), dev, 0.1)
    g = _t(rng, (length + k - 1, c_out, bsz), dev)
    dx, dw = K._backward(g, x, w)
    rx, rw = K.convt1d_ola_tm_bwd_plain(g, x, w)
    torch.testing.assert_close(dx, rx, atol=ATOL, rtol=0)
    _close((dw,), (rw,), rel=1e-4)  # dW sums L * B products
    dx2, dw2 = K._backward(g, x, w)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


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


# the serving shapes at bs 1 and 8, small channels and taps, C_in 32 and
# one that is no multiple of 8, a ragged B (no multiple of 32 or 4), L 1
# and L < k
@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 125, 8), (13, 32, 48, 17, 5),
                          (118, 64, 64, 64, 8), (57, 64, 64, 1000, 8),
                          (118, 64, 64, 512, 8), (37, 32, 64, 131, 8),
                          (9, 12, 20, 33, 3), (1, 64, 64, 77, 8),
                          (3, 32, 64, 131, 8), (57, 96, 64, 125, 8),
                          (57, 160, 64, 125, 8), (7, 72, 130, 40, 16)])
def test_k3_matches_plain(dev, length, c_in, c_out, bsz, k):
    """K3 forward against its plain version; two calls give the same
    bits."""
    from rtfs_tpu_torch.ops import convt_tm as K

    rng = np.random.default_rng(1)
    x = _t(rng, (length, c_in, bsz), dev)
    w = _t(rng, (k, c_out, c_in), dev, 0.1)
    got = K.convt1d_ola_tm(x, w)
    torch.testing.assert_close(got, K.convt1d_ola_tm_plain(x, w), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, K.convt1d_ola_tm(x, w))


def test_wrappers_reject_bad_input(dev):
    from rtfs_tpu_torch.ops import sru_fused as S

    u = torch.zeros(4, 32, 3, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        S.sru_dual_recurrence(u, u, torch.zeros(8, 8, device=dev,
                                                dtype=torch.float64))
    u = torch.zeros(4, 3, 32, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        S.sru_dual_recurrence(u, u, torch.zeros(8, 8, device=dev))


def test_k5_wgrad_takes_other_taps_and_unaligned_inputs(dev):
    """K5-wgrad's generic instantiation at 2 x 9 taps (three tap groups
    of the window) and its 4-byte copies from x and g 4 bytes off 16-byte
    alignment."""
    from rtfs_tpu_torch.ops import packed_tf as P

    rng = np.random.default_rng(13)
    b, t, f, c = 2, 11, 13, 12
    for (kt, kf), pads_t, pads_f in (((2, 9), (0, 1), (4, 4)),
                                     ((4, 4), (1, 2), (1, 2))):
        t_out, f_out = P.dw_geometry(t, f, kt, kf, pads_t, pads_f)
        n_x, n_g = b * t * f * c, b * t_out * f_out * c
        buf = _t(rng, (n_x + n_g + 2,), dev)
        xp = buf[1:1 + n_x].view(b, t, f * c)
        g = buf[2 + n_x:].view(b, t_out, f_out * c)
        got = P.dw_conv_packed_wgrad(xp, g, f, c, (kt, kf), pads_t, pads_f)
        want = P.dw_conv_packed_wgrad_plain(xp, g, f, c, (kt, kf), pads_t,
                                            pads_f)
        _close((got,), (want,), rel=1e-4)


@pytest.mark.parametrize("h", [48, 80])
def test_wide_dual_path_rnn_card_matches_cpu(dev, h):
    """A DualPathRNN wider than one K3 block takes (H 48: 2H 96 input
    channels) and than one K2 forward block takes (H 80) serves and takes
    gradients on the card as on the CPU, through K1, K2 and K3 as at the
    preset."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(16, h, dim=3, kernel_size=4, num_layers=3)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 11, 13)).astype(np.float32))
    xc = x.clone().requires_grad_()
    want = m(xc)
    want.square().sum().backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    md = m.to(dev)
    xd = x.to(dev).requires_grad_()
    kernel_lib.reset_launches()
    got = md(xd)
    got.square().sum().backward()
    route = {"sru_dual_recurrence_fwd": 1, "sru_hidden_layer_fwd": 2,
             "convt1d_ola_tm_fwd": 1}
    assert kernel_lib.LAUNCHES == {
        **route, **{k.replace("_fwd", "_bwd"): v for k, v in route.items()}}
    torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(xd.grad.cpu(), xc.grad, rtol=0,
                               atol=1e-4 * xc.grad.abs().max().item())
    for n, p in md.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), grads[n], rtol=0, msg=n,
                                   atol=1e-4 * grads[n].abs().max().item()
                                   + 1e-7)


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


# ------------------------------------------------------------- K4


# ragged shapes, the serving and bs-4 time sites; the scans' rings: T
# shorter than them, one step longer; one column; H above 32, and H 80 at
# the bs-4 freq site (a wide unidirectional SRU); H 300 (blocks of two
# units)
@pytest.mark.parametrize("t_len,h,bsz", [
    (37, 8, 5), (57, 32, 125), (118, 32, 300), (1, 32, 129), (118, 32, 256),
    (SCAN_AHEAD // 2, 32, 200), (SCAN_AHEAD + 1, 32, 131), (23, 32, 1),
    (29, 48, 131), (57, 80, 500), (5, 300, 33)])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4_matches_plain_and_backward_repeats_exactly(dev, t_len, h, bsz,
                                                       reverse):
    """K4 forward (serving, and with c) and backward against the plain
    versions at ragged shapes; two forward calls and two backward calls
    give the same bits."""
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(15)
    u, x = _t(rng, (t_len, 3 * h, bsz), dev), _t(rng, (t_len, h, bsz), dev)
    vb = _t(rng, (4, h), dev, 0.3)
    dh = _t(rng, (t_len, h, bsz), dev)
    want_h, want_c = S.sru_recurrence_plain(u, x, vb, reverse, with_c=True)
    got_h = S._k4_forward(u, x, vb, reverse, False)
    torch.testing.assert_close(got_h, want_h, atol=1e-5, rtol=0)
    assert torch.equal(got_h, S._k4_forward(u, x, vb, reverse, False))
    h_c, c = S._k4_forward(u, x, vb, reverse, True)
    _close((h_c, c), (want_h, want_c))
    got = S._k4_backward(u, x, vb, c, dh, reverse)
    want = S.sru_recurrence_bwd_plain(u, x, vb, c, dh, reverse)
    _close(got[:2], want[:2])
    _close(got[2:], want[2:], rel=1e-4)  # (v, b) sums over T * B terms
    again = S._k4_backward(u, x, vb, c, dh, reverse)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_k4_function_matches_autograd_of_plain(dev):
    """The Function's gradients (u, xhw, v, b through the kernels) against
    autograd through the plain forward on the same card inputs."""
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(16)
    t_len, h, bsz = 45, 32, 131

    def leaf(shape, scale=1.0):
        return _t(rng, shape, dev, scale).requires_grad_()

    ins = (leaf((t_len, 3 * h, bsz)), leaf((t_len, h, bsz)),
           leaf((2, h), 0.3), leaf((2, h), 0.1))
    dh = _t(rng, (t_len, h, bsz), dev)
    got = torch.autograd.grad(S.sru_recurrence(*ins), ins, dh)
    plain = S.sru_recurrence_plain(ins[0], ins[1], torch.cat(ins[2:]))
    _close(got, torch.autograd.grad(plain, ins, dh), rel=1e-4)


def test_unidirectional_dual_path_rnn_gradients_card_match_cpu(dev):
    """A unidirectional DualPathRNN on the card (K4 forward and backward,
    the library ConvTranspose tail) against the same module on the CPU:
    the output, the input's and every parameter's gradient."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(16, 8, dim=4, kernel_size=4, num_layers=3,
                    bidirectional=False)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 16, 11, 13)).astype(np.float32)).requires_grad_()
    y = m(x)
    y.square().sum().backward()
    want = {n: p.grad.clone() for n, p in m.named_parameters()}
    want["x"] = x.grad
    m.zero_grad()
    m.to(dev)
    xd = x.detach().to(dev).requires_grad_()
    kernel_lib.reset_launches()
    yd = m(xd)
    yd.square().sum().backward()
    assert kernel_lib.LAUNCHES == {"sru_recurrence_fwd": 3,
                                   "sru_recurrence_bwd": 3}
    torch.testing.assert_close(yd.detach().cpu(), y.detach(), atol=ATOL,
                               rtol=0)
    got = {n: p.grad for n, p in m.named_parameters()}
    got["x"] = xd.grad
    for n, w in want.items():
        assert got[n] is not None, n
        torch.testing.assert_close(got[n].cpu(), w, rtol=0, msg=n,
                                   atol=1e-4 * w.abs().max().item() + 1e-7)


# ------------------------------------------------------------- K5-K9
# one ragged small shape and the packed serving shapes (2 s of audio: STFT
# 251 x 129, hid 64 channels, bottleneck 256, pooled 125 x 64)
PACKED_SHAPES = {"ragged": (2, 13, 7, 4, 6), "serving": (1, 251, 129, 64, 256)}


@pytest.mark.parametrize("shape", sorted(PACKED_SHAPES))
@pytest.mark.parametrize("pads,with_bias", [((1, 2), True), ((1, 1), True),
                                            ((1, 2), False)])
def test_k5_matches_plain(dev, shape, pads, with_bias):
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, _ = PACKED_SHAPES[shape]
    rng = np.random.default_rng(6)
    xp = _t(rng, (b, t, f * c), dev)
    weight = _t(rng, (c, 1, 4, 4), dev, 0.25)  # torch depthwise layout
    w = weight[:, 0].permute(1, 2, 0)          # (kT, kF, C), strided
    bias = _t(rng, (c,), dev) if with_bias else None
    got = P.dw_conv_packed(xp, w, bias, f, c, pads, pads)
    want = P.dw_conv_packed_plain(xp, w, bias, f, c, pads, pads)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# K5's four sites at the packed shapes (bs 1, 4 and 8: "same" and
# pre-select with bias, their dx on the flipped taps without), and odd
# shapes: C 6 (no 16-byte chunks) and 70 (two channel blocks), an x 4
# bytes off 16-byte alignment, taps 3 x 3, 5 x 5 and 1 x 4 (the runtime
# taps' kernel), 17 x 17 and 24 x 24 (fewer positions, then fewer quads a
# block, so that ring and taps fit); (B, T, F, C, kT, kF, x offset in
# floats)
K5_SITES = {"same": ((1, 2), True), "pre-select": ((1, 1), True),
            "same dx": ((2, 1), False), "pre-select dx": ((2, 2), False)}
K5_SHAPES = {"bs1": (1, 251, 129, 64, 4, 4, 0),
             "bs4": (4, 251, 129, 64, 4, 4, 0),
             "bs8": (8, 251, 129, 64, 4, 4, 0), "c6": (3, 13, 7, 6, 4, 4, 0),
             "c70": (2, 11, 9, 70, 4, 4, 0), "off": (2, 17, 10, 64, 4, 4, 1),
             "taps-3x3": (2, 19, 21, 12, 3, 3, 0),
             "taps-5x5": (1, 23, 17, 64, 5, 5, 1),
             "taps-1x4": (4, 9, 33, 8, 1, 4, 0),
             "taps-17x17": (1, 20, 129, 64, 17, 17, 0),
             "taps-24x24": (1, 30, 40, 64, 24, 24, 1)}


@pytest.mark.parametrize("site", sorted(K5_SITES))
@pytest.mark.parametrize("shape", sorted(K5_SHAPES))
def test_k5_sites_match_plain_and_repeat_exactly(dev, shape, site):
    """K5 (``dw_conv_kernel``) at each site and shape against its plain
    version (1e-5, chip_smoke's gate); two calls give the same bits."""
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, kt, kf, off = K5_SHAPES[shape]
    pads, with_bias = K5_SITES[site]
    pads_t = tuple(min(p, kt - 1) for p in pads)
    pads_f = tuple(min(p, kf - 1) for p in pads)
    rng = np.random.default_rng(12)
    xp = _t(rng, (b * t * f * c + off,), dev)[off:].view(b, t, f * c)
    weight = _t(rng, (c, 1, kt, kf), dev, 1.0 / kt)
    w = weight[:, 0].permute(1, 2, 0)  # (kT, kF, C), strided
    if site.endswith("dx"):
        w = torch.flip(w, (0, 1))  # as the backward passes it
    bias = _t(rng, (c,), dev) if with_bias else None
    got = P.dw_conv_packed(xp, w, bias, f, c, pads_t, pads_f)
    want = P.dw_conv_packed_plain(xp, w, bias, f, c, pads_t, pads_f)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, P.dw_conv_packed(xp, w, bias, f, c, pads_t,
                                             pads_f))


# K7 at the packed sizes as the forward (bs 1 and 8: the layer's strided w,
# bias) and as K6's dx (bs 4: w.t() of K6's strided weight, no bias), and
# at M 129 (odd, one tile and one position), N 70 (a partial channel
# tile), K 300 (two launches) and an x 4 bytes off alignment (4-byte
# copies); (B, T, F, K, N, bias, x offset in floats)
K7_SHAPES = {"bs1": (1, 251, 129, 64, 256, True, 0),
             "bs4-k6-dx": (4, 251, 129, 64, 256, False, 0),
             "bs8": (8, 251, 129, 64, 256, True, 0),
             "m-129": (3, 1, 129, 64, 256, True, 0),
             "n-70": (2, 7, 129, 64, 70, False, 0),
             "off": (2, 5, 129, 64, 256, True, 1),
             "k-300": (1, 9, 43, 300, 40, True, 0)}


@pytest.mark.parametrize("shape", sorted(K7_SHAPES))
def test_k7_matches_plain_and_repeats_exactly(dev, shape):
    """K7 (``pw_unproj_kernel``, 3xTF32) against its plain version (1e-4,
    chip_smoke's gate); two calls give the same bits."""
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, k, n, with_bias, off = K7_SHAPES[shape]
    rng = np.random.default_rng(13)
    xp = _t(rng, (b * t * f * k + off,), dev)[off:].view(b, t, f * k)
    if shape.endswith("k6-dx"):  # K6's (Ci, Co) view, turned round
        w = _t(rng, (k, n, 1, 1), dev, n ** -0.5)[:, :, 0, 0].t().t()
    else:  # the layer's view of its (Co, Ci, 1, 1) weight
        w = _t(rng, (n, k, 1, 1), dev, k ** -0.5)[:, :, 0, 0].t()
    bias = _t(rng, (n,), dev) if with_bias else None
    got = P.pw_unproj_packed(xp, w, bias, f)
    torch.testing.assert_close(got, P.pw_unproj_packed_plain(xp, w, bias, f),
                               atol=1e-4, rtol=0)
    assert got.shape == (b, n, t, f)
    assert torch.equal(got, P.pw_unproj_packed(xp, w, bias, f))


# K6/K7 also at bs 8, with an M (T * F) a multiple of 4 (K6's 16-byte x
# path) and 1 off one tile of 128, and with N 70 (two N tiles of K6, no
# 16-byte stores)
PW_SHAPES = {**PACKED_SHAPES, "serving-bs8": (8, 251, 129, 64, 256),
             "m-mod-4": (2, 16, 9, 64, 40), "m-129": (3, 3, 43, 64, 256),
             "n-70": (2, 12, 12, 70, 40),
             # K above one slice of W (256 k): the 512 bottleneck, and a
             # last slice of 44 k with two N tiles
             "k-512": (1, 251, 129, 64, 512), "k-300": (2, 9, 13, 70, 300)}


@pytest.mark.parametrize("shape", sorted(PW_SHAPES))
def test_k6_k7_match_plain(dev, shape):
    """K6 with the serving view of w (strides (1, K)) and bias, and as K7's
    dx (a contiguous w, no bias), also from an x 4 bytes off 16-byte
    alignment; two K6 calls give the same bits; K7 back to rank-4."""
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_SHAPES[shape]
    rng = np.random.default_rng(7)
    x4 = _t(rng, (b, ci, t, f), dev)
    w_in = _t(rng, (c, ci, 1, 1), dev, ci ** -0.5)[:, :, 0, 0].t()
    b_in = _t(rng, (c,), dev)
    got = P.pw_proj_packed(x4, w_in, b_in)
    torch.testing.assert_close(got, P.pw_proj_packed_plain(x4, w_in, b_in),
                               atol=1e-4, rtol=0)
    assert torch.equal(got, P.pw_proj_packed(x4, w_in, b_in))
    w_dx = w_in.contiguous()
    off = _t(rng, (x4.numel() + 1,), dev)[1:].view(x4.shape)
    for x in (x4, off):
        torch.testing.assert_close(P.pw_proj_packed(x, w_dx, None),
                                   P.pw_proj_packed_plain(x, w_dx, None),
                                   atol=1e-4, rtol=0)
    w_out = _t(rng, (ci, c, 1, 1), dev, c ** -0.5)[:, :, 0, 0].t()
    back = P.pw_unproj_packed(got, w_out, None, f)
    torch.testing.assert_close(back, P.pw_unproj_packed_plain(got, w_out,
                                                              None, f),
                               atol=1e-4, rtol=0)
    assert back.shape == x4.shape


# (B, T, F, C) of a packed map; the pooled level is the stride-2 k-4 conv's
# output. "ragged": C and every F side not a multiple of 4; "odd-c": C 37
MAP_SHAPES = {"ragged": (3, 13, 7, 6), "serving": (1, 251, 129, 64),
              "serving-bs8": (8, 251, 129, 64), "odd-c": (1, 21, 18, 37)}


@pytest.mark.parametrize("shape", sorted(MAP_SHAPES))
def test_k8_k9_match_plain(dev, shape):
    """K8 and K9 at the three maps and their transposes (each the other's
    dx; the transposed select has rows and f blocks with no source)
    against their plain versions, two calls bit-identical; the ragged
    case also from inputs 4 bytes off 16-byte alignment (scalar chunks)."""
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c = MAP_SHAPES[shape]
    t2, f2 = (t - 2) // 2 + 1, (f - 2) // 2 + 1
    pool = P.cached_map("pool", t, t2, f, f2)
    sel = P.cached_map("select", t - 1, t2, f - 1, f2)  # (1, 1)-padded conv
    up = P.cached_map("nearest", t2, t, f2, f)
    rng = np.random.default_rng(8)
    down_fn = (P.spatial_down_packed, P.spatial_down_packed_plain)
    up_fn = (P.spatial_up_packed, P.spatial_up_packed_plain)
    for off in ((0, 1) if shape == "ragged" else (0,)):
        def x(*dims):
            flat = _t(rng, (int(np.prod(dims)) + off,), dev)
            return flat[off:].view(dims)

        cases = [  # (kernel and plain, arguments, max abs error)
            (down_fn, (x(b, t, f * c), pool, c), 1e-5),
            (down_fn, (x(b, t - 1, (f - 1) * c), sel, c), 0.0),
            (up_fn, (x(b, c, t2, f2), up), 0.0),
            (down_fn, (x(b, t, f * c), up.transposed(f2), c), 1e-5),
            (up_fn, (x(b, c, t2, f2), pool.transposed(f)), 1e-5),
            (up_fn, (x(b, c, t2, f2), sel.transposed(f - 1)), 0.0),
        ]
        for (kern, plain), args, tol in cases:
            got = kern(*args)
            torch.testing.assert_close(got, plain(*args), atol=tol, rtol=0)
            assert torch.equal(got, kern(*args))


def test_k8_k9_refuse_a_tile_larger_than_shared_memory(dev):
    from rtfs_tpu_torch.ops import packed_tf as P

    up = P.cached_map("nearest", 2, 3, 1024, 1024)  # a (1024, 68) tile
    with pytest.raises(ValueError, match="shared memory"):
        P.spatial_up_packed(torch.zeros(1, 64, 2, 1024, device=dev), up)
    pool = P.cached_map("pool", 2, 1, 2048, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        P.spatial_down_packed(torch.zeros(1, 2, 2048 * 64, device=dev),
                              pool, 64)


# K5-wgrad also with C 37 (4-byte copies, a partial quad), C 72 (two
# channel blocks) and the serving shape at bs 8
WGRAD_SHAPES = {**PACKED_SHAPES, "odd-c": (2, 9, 11, 37, 0),
                "c-72": (1, 6, 7, 72, 0), "serving-bs8": (8, 251, 129, 64, 0)}


@pytest.mark.parametrize("shape", sorted(WGRAD_SHAPES))
@pytest.mark.parametrize("kt,pads", [(4, (1, 2)), (4, (1, 1)), (3, (1, 1))])
def test_k5_wgrad_matches_plain_and_repeats_exactly(dev, shape, kt, pads):
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, _ = WGRAD_SHAPES[shape]
    b = 4 if shape == "serving" else b  # the training batch
    rng = np.random.default_rng(11)
    t_out, f_out = P.dw_geometry(t, f, kt, kt, pads, pads)
    xp, g = _t(rng, (b, t, f * c), dev), _t(rng, (b, t_out, f_out * c), dev)
    got = P.dw_conv_packed_wgrad(xp, g, f, c, (kt, kt), pads, pads)
    want = P.dw_conv_packed_wgrad_plain(xp, g, f, c, (kt, kt), pads, pads)
    _close((got,), (want,), rel=1e-4)  # sums of B*T*F products
    assert torch.equal(got, P.dw_conv_packed_wgrad(xp, g, f, c, (kt, kt),
                                                   pads, pads))


@pytest.mark.parametrize("shape", sorted(PACKED_SHAPES))
def test_pw_wgrad_matches_plain_and_repeats_exactly(dev, shape):
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PACKED_SHAPES[shape]
    b = 4 if shape == "serving" else b
    rng = np.random.default_rng(12)
    for a, g in (((b, ci, t, f), (b, t, f * c)),   # K6's dW
                 ((b, t, f * c), (b, ci, t, f))):  # K7's dW
        a, g = _t(rng, a, dev), _t(rng, g, dev)
        got = P.pw_packed_wgrad(a, g)
        _close((got,), (P.pw_packed_wgrad_plain(a, g),), rel=1e-4)
        assert torch.equal(got, P.pw_packed_wgrad(a, g))


# pw-wgrad (B, T, F, packed channels, planar channels): the bs-4 training
# shape; channels off every tile (48 x 200 both ways, 512 x 64 both ways:
# two planar tiles, or eight packed ones); B 1 at an odd M below one stage
# of positions; M a multiple of 4 with B 3
PW_WGRAD_SHAPES = {"bs4-train": (4, 251, 129, 64, 256),
                   "c200-ci48": (2, 17, 19, 200, 48),
                   "c48-ci200": (2, 17, 19, 48, 200),
                   "c64-ci512": (2, 9, 13, 64, 512),
                   "c512-ci64": (2, 9, 13, 512, 64),
                   "b1-m21": (1, 3, 7, 64, 256),
                   "b3-m96": (3, 8, 12, 64, 256)}


@pytest.mark.parametrize("shape", sorted(PW_WGRAD_SHAPES))
def test_pw_wgrad_shapes_match_plain_and_repeat_exactly(dev, shape):
    """pw-wgrad (3xTF32 on the tensor cores, one partial a chunk of
    positions) against its plain version, K6's dW (planar a, packed g) and
    K7's (packed a, planar g), to 1e-4 of max|dW|; two calls give the same
    bits."""
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_WGRAD_SHAPES[shape]
    rng = np.random.default_rng(14)
    for a, g in (((b, ci, t, f), (b, t, f * c)),   # K6's dW
                 ((b, t, f * c), (b, ci, t, f))):  # K7's dW
        a, g = _t(rng, a, dev), _t(rng, g, dev)
        got = P.pw_packed_wgrad(a, g)
        _close((got,), (P.pw_packed_wgrad_plain(a, g),), rel=1e-4)
        assert torch.equal(got, P.pw_packed_wgrad(a, g))


def test_pw_wgrad_does_not_drift_on_positive_sums(dev):
    """All-positive a and g at the bs-4 training shape, both layouts: every
    product adds to the sum, so a bias toward zero adds up. Held against
    float64 to 1e-4 of max|dW|, in the geometry's chunks and in one chunk a
    batch row (its 32,379 positions in one block): a sum kept in the
    tensor core's accumulator, which rounds toward zero, drifts ~1.8e-4 of
    the result over such a chunk (emulated in
    tests/test_torch_pw_wgrad_geometry.py; the kernel built with no flush
    fails here, PERF.md); the kernel adds its big products to a float32
    sum every few stages. Two calls give the same bits."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_WGRAD_SHAPES["bs4-train"]
    whole = -(-(t * f) // P.PW_WGRAD_K) * P.PW_WGRAD_K  # a chunk a row
    rng = np.random.default_rng(15)
    for a, g in (((b, ci, t, f), (b, t, f * c)),
                 ((b, t, f * c), (b, ci, t, f))):
        a, g = _t(rng, a, dev).abs(), _t(rng, g, dev).abs()
        want = P.pw_packed_wgrad_plain(a.double(), g.double())
        ints = P.pw_wgrad_launch_ints(a, g)
        assert ints[5] < whole  # the geometry's chunks are shorter
        for chunk, parts in (ints[5:], (whole, b)):
            def call():
                partial = torch.empty(parts, want.numel(), device=dev)
                out = torch.empty(want.shape, device=dev)
                kernel_lib.launch(
                    "packed_tf", "pw_packed_wgrad", dev, a.data_ptr(),
                    g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                    *ints[:5], chunk, parts)
                return out

            got = call()
            _close((got.double(),), (want,), rel=1e-4)
            assert torch.equal(got, call())


def test_packed_tdanet_block_gradients_card_match_cpu(dev):
    """A packed TDANet block's backward on the card (K5-K9 as dx, the two
    wgrad kernels) against the same block's on the CPU (plain versions):
    the input's and every parameter's gradient."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.separators import TDANetBlock
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    m = TDANetBlock(16, 8, kernel_size=4, upsampling_depth=2, is2d=True)
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 16, 21, 17)).astype(np.float32)).requires_grad_()
    with P.packed_scope(True):
        m(x).square().sum().backward()
        want = {n: p.grad.clone() for n, p in m.named_parameters()}
        want["x"] = x.grad
        m.zero_grad()
        m.to(dev)
        xd = x.detach().to(dev).requires_grad_()
        kernel_lib.reset_launches()
        m(xd).square().sum().backward()
    assert kernel_lib.LAUNCHES == {
        "dw_conv_packed_fwd": 8, "dw_conv_packed_wgrad": 4,
        "pw_proj_packed_fwd": 2, "pw_unproj_packed_fwd": 2,
        "pw_packed_wgrad": 2, "spatial_down_packed_fwd": 6,
        "spatial_up_packed_fwd": 6}
    got = {n: p.grad for n, p in m.named_parameters()}
    got["x"] = xd.grad
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert got[n] is not None, n
        torch.testing.assert_close(got[n].cpu(), w, rtol=0, msg=n,
                                   atol=1e-4 * w.abs().max().item() + 1e-7)


def test_packed_wrappers_give_every_parameter_a_gradient(dev):
    """With packed_tf, every parameter of a micro AVNet (2-D TDANet blocks
    with a DualPathRNN, CAF fusion) gets a finite gradient on the card,
    through K1-K3 and K5-K9 forward and backward."""
    from rtfs_tpu_torch.config import build_avnet
    from rtfs_tpu_torch.ops import kernel_lib

    model = build_avnet({"audionet": MICRO_PACKED_AUDIONET}, device=dev,
                        seed=0)
    assert model.packed_tf
    rng = np.random.default_rng(14)
    wav = _t(rng, (2, 1024), dev, 0.1)
    mouth = _t(rng, (2, 8, 32), dev)
    kernel_lib.reset_launches()
    model(wav, mouth).square().mean().backward()
    for fn in ("dw_conv_packed_wgrad", "pw_packed_wgrad",
               "spatial_up_packed_fwd", "sru_hidden_layer_bwd"):
        assert kernel_lib.LAUNCHES[fn] > 0, fn
    for n, p in model.named_parameters():
        assert p.grad is not None, n
        assert torch.isfinite(p.grad).all(), n


# a micro AVNet whose audio TDANet blocks take the packed layout (2-D,
# stride 2, kernel 4): STFT 33 x 33, hid 8, one DualPathRNN
MICRO_PACKED_AUDIONET = {
    "n_src": 1, "pretrained_vout_chan": 32, "packed_tf": True,
    "video_bn_params": {"kernel_size": -1},
    "audio_bn_params": {"pre_norm_type": "gLN", "pre_act_type": "ReLU",
                        "out_chan": 16, "kernel_size": 1, "is2d": True},
    "enc_dec_params": {
        "encoder_type": "STFTEncoder", "decoder_type": "STFTDecoder",
        "win": 64, "hop_length": 32, "out_chan": 16, "kernel_size": 3,
        "stride": 1, "bias": False, "act_type": None, "norm_type": None},
    "audio_params": {
        "audio_net": "TDANet", "hid_chan": 8, "kernel_size": 4, "stride": 2,
        "norm_type": "gLN", "act_type": "PReLU", "upsampling_depth": 2,
        "repeats": 2, "shared": True, "is2d": True,
        "layers": {"layer_1": {
            "layer_type": "DualPathRNN", "hid_chan": 4, "dim": 4,
            "kernel_size": 4, "stride": 1, "rnn_type": "SRU",
            "num_layers": 2, "bidirectional": True}}},
    "video_params": {
        "video_net": "TDANet", "hid_chan": 8, "kernel_size": 3, "stride": 2,
        "norm_type": "BatchNorm1d", "act_type": "PReLU",
        "upsampling_depth": 2, "repeats": 1, "shared": True, "is2d": False,
        "layers": {}},
    "fusion_params": {"fusion_type": "ATTNFusion", "fusion_shared": True,
                      "kernel_size": 4, "is2d": True},
    "mask_generation_params": {"mask_generator_type": "MaskGenerator",
                               "mask_act": "ReLU", "RI_split": True,
                               "is2d": True},
}


def test_packed_tdanet_block_card_matches_cpu(dev):
    """A packed TDANet block on the card (K5-K9 and the library's ops)
    against the same block on the CPU (the plain versions)."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.separators import TDANetBlock
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    m = TDANetBlock(16, 8, kernel_size=4, upsampling_depth=2, is2d=True)
    init_weights(m, torch.Generator().manual_seed(0))
    m.eval()
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 16, 21, 17)).astype(np.float32))
    with torch.no_grad(), P.packed_scope(True):
        want = m(x)
        kernel_lib.reset_launches()
        got = m.to(dev)(x.to(dev)).cpu()
    assert kernel_lib.LAUNCHES == {
        "dw_conv_packed_fwd": 4, "pw_proj_packed_fwd": 1,
        "pw_unproj_packed_fwd": 1, "spatial_down_packed_fwd": 2,
        "spatial_up_packed_fwd": 4}
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# bf16 storage (K1, K2, K3 forward): two bf16 ulps at every element,
# |diff| <= 2^-7 max(|want|, 2^-6); the kernels and the plain versions both
# compute in float32 and round once, so they part only where float32 sums
# in another order straddle a bf16 rounding boundary
def _bf16_close(got, want, what=""):
    assert got.dtype == want.dtype == torch.bfloat16, what
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * torch.clamp(w.abs(), min=2.0 ** -6)
    bad = (g - w).abs() > bound
    assert not bad.any(), (what, int(bad.sum()), (g - w).abs().max().item())


def _b(rng, shape, dev, scale=1.0):
    return _t(rng, shape, dev, scale).to(torch.bfloat16)


# the serving shapes at bs 1 and 8, small H, a ragged B, T 1, H 48 and 80
# (K2's units split over the grid), H 268 (held) and 536 (streamed); for
# K1's group copies B 125, 131 and 1000 at T 1 and 5 (shorter than a group
# and than the ring), H 48
@pytest.mark.parametrize("t_len,h,bsz", [
    (57, 32, 125), (118, 32, 64), (57, 32, 1000), (118, 32, 512),
    (21, 8, 5), (1, 32, 77), (37, 32, 131), (23, 48, 131), (57, 80, 125),
    (19, 48, 64), (9, 128, 40), (5, 268, 20), (3, 536, 8), (1, 48, 125),
    (5, 48, 131), (5, 32, 1000), (1, 32, 131), (5, 48, 125),
    (1, 48, 1000)])
def test_bf16_k1_k2_match_plain(dev, t_len, h, bsz):
    """K1 and K2 forward in bf16 storage against their plain bf16 versions
    and against the float32 kernels on the same values widened; K1 also
    with c (the training forward); two calls give the same bits; the
    launches are the bf16 entries."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(5)
    vb = _b(rng, (8, h), dev, 0.3)
    u_f, u_r = _b(rng, (t_len, 4 * h, bsz), dev), _b(rng, (t_len, 4 * h, bsz), dev)
    kernel_lib.reset_launches()
    k1 = S.sru_dual_recurrence(u_f, u_r, vb)
    assert dict(kernel_lib.LAUNCHES) == {"sru_dual_recurrence_fwd_bf16": 1}
    for g, w in zip(k1, S.sru_dual_recurrence_plain(u_f, u_r, vb)):
        _bf16_close(g, w, "K1 plain")
    wide = S.sru_dual_recurrence(u_f.float(), u_r.float(), vb.float())
    for g, w in zip(k1, wide):
        _bf16_close(g, w.to(torch.bfloat16), "K1 float32")
    for a, b in zip(k1, S.sru_dual_recurrence(u_f, u_r, vb)):
        assert torch.equal(a, b)
    k1c = S._k1_forward(u_f, u_r, vb, with_c=True)
    want = S.sru_dual_recurrence_plain(u_f, u_r, vb, with_c=True)
    for i, (g, w) in enumerate(zip(k1c, want)):
        _bf16_close(g, w, f"K1 with c, output {i}")
    for a, b in zip(k1c, S._k1_forward(u_f, u_r, vb, with_c=True)):
        assert torch.equal(a, b)
    for a, b in zip(k1c, k1):  # h as served
        assert torch.equal(a, b)
    x_f, x_r = _b(rng, (t_len, h, bsz), dev, 0.5), _b(rng, (t_len, h, bsz), dev, 0.5)
    wt = _b(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    kernel_lib.reset_launches()
    got = S.sru_hidden_layer(x_f, x_r, wt, vb)
    assert dict(kernel_lib.LAUNCHES) == {"sru_hidden_layer_fwd_bf16": 1}
    for g, w in zip(got, S.sru_hidden_layer_plain(x_f, x_r, wt, vb)):
        _bf16_close(g, w, "K2 plain")
    wide = S.sru_hidden_layer(x_f.float(), x_r.float(), wt.float(), vb.float())
    for g, w in zip(got, wide):
        _bf16_close(g, w.to(torch.bfloat16), "K2 float32")
    for a, b in zip(got, S.sru_hidden_layer(x_f, x_r, wt, vb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 125, 8), (118, 64, 64, 64, 8),
                          (57, 64, 64, 1000, 8), (118, 64, 64, 512, 8),
                          (13, 32, 48, 17, 5), (37, 32, 64, 131, 8),
                          (9, 12, 20, 33, 3), (1, 64, 64, 77, 8),
                          (57, 96, 64, 125, 8), (57, 160, 64, 125, 8),
                          (7, 72, 130, 40, 16), (5, 64, 64, 6, 8)])
def test_bf16_k3_matches_plain(dev, length, c_in, c_out, bsz, k):
    """K3 forward in bf16 storage against its plain bf16 version and the
    float32 kernel on the widened values; two calls give the same bits."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import kernel_lib

    rng = np.random.default_rng(7)
    x = _b(rng, (length, c_in, bsz), dev)
    w = _b(rng, (k, c_out, c_in), dev, 0.1)
    kernel_lib.reset_launches()
    got = K.convt1d_ola_tm(x, w)
    assert dict(kernel_lib.LAUNCHES) == {"convt1d_ola_tm_fwd_bf16": 1}
    _bf16_close(got, K.convt1d_ola_tm_plain(x, w), "K3 plain")
    _bf16_close(got, K.convt1d_ola_tm(x.float(), w.float()).to(torch.bfloat16),
                "K3 float32")
    assert torch.equal(got, K.convt1d_ola_tm(x, w))


# the redesigned bf16 forwards (K2 ``sru_hid_fwd_bf16_kernel``, K3
# ``convt1d_tm_fwd_bf16_kernel``): the six main-path sites (bs 1, 4 and 8
# at freq L 57 over B 125 bs and time L 118 over B 64 bs, H 32), B odd
# with bt 8 and with bt 1 (the word copies), bt 2 and 4, H 48 and 80 (the
# units split over the grid); bt 0 is the geometry's own choice
FWD16_SITES = [(57, 125), (118, 64), (57, 500), (118, 256), (57, 1000),
               (118, 512)]


@pytest.mark.parametrize("t_len,h,bsz,bt", [
    *((t, 32, b, 0) for t, b in FWD16_SITES), (37, 32, 131, 8),
    (37, 32, 131, 1), (21, 32, 250, 2), (13, 32, 12, 4), (23, 48, 131, 0),
    (19, 80, 64, 0), (9, 80, 125, 0)])
@pytest.mark.parametrize("with_c", [False, True])
def test_bf16_k2_redesign_matches_plain_and_float32(dev, t_len, h, bsz, bt,
                                                    with_c):
    """The bf16 K2 forward at the geometry's (or a forced) bt against its
    plain bf16 version and the float32 kernel on the widened values (two
    bf16 ulps), serving and with c; two calls give the same bits."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(21)
    vb = _b(rng, (8, h), dev, 0.3)
    x_f, x_r = (_b(rng, (t_len, h, bsz), dev, 0.5) for _ in range(2))
    wt = _b(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    geo = S.k2_fwd_bf16_geometry(t_len, h, bsz, bt=bt)
    assert not geo["stream"] and (bt == 0 or geo["bt"] == bt)

    def call():
        outs = [torch.empty_like(x_f) for _ in range(4 if with_c else 2)]
        c_ptrs = ((outs[2].data_ptr(), outs[3].data_ptr()) if with_c
                  else (None, None))
        kernel_lib.launch(
            "sru_fused", "sru_hidden_layer_fwd_bf16", dev, x_f.data_ptr(),
            x_r.data_ptr(), wt.data_ptr(), vb.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), *c_ptrs, t_len, h, bsz, geo["bt"],
            geo["steps"], geo["units"], 0)
        return outs

    got, again = call(), call()
    torch.cuda.synchronize()
    want = S.sru_hidden_layer_plain(x_f, x_r, wt, vb, with_c)
    wide = S._k2_forward(x_f.float(), x_r.float(), wt.float(), vb.float(),
                         with_c)
    for i, (g, a, w, f) in enumerate(zip(got, again, want, wide)):
        assert torch.equal(g, a), i
        _bf16_close(g, w, f"K2 plain {i}")
        _bf16_close(g, f.to(torch.bfloat16), f"K2 float32 {i}")


@pytest.mark.parametrize("length,c_in,bsz,tile", [
    *((t, 64, b, None) for t, b in FWD16_SITES), (37, 64, 131, None),
    (37, 64, 131, (32, 64)), (57, 64, 125, (16, 32)),
    (118, 64, 64, (32, 16)), (20, 48, 21, (16, 64)), (9, 96, 40, None)])
def test_bf16_k3_redesign_matches_plain_and_float32(dev, length, c_in, bsz,
                                                    tile):
    """The bf16 K3 forward at the geometry's (or a forced) tile of columns
    and output channels against its plain bf16 version and the float32
    kernel on the widened values (two bf16 ulps); two calls give the same
    bits; C_in 96 splits the input channels (float32 partials)."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import kernel_lib

    rng = np.random.default_rng(22)
    k, c_out = 8, 64
    x = _b(rng, (length, c_in, bsz), dev)
    w = _b(rng, (k, c_out, c_in), dev, (c_in * k) ** -0.5)
    geo = K.fwd_bf16_geometry(length, c_in, c_out, k, bsz,
                              *(tile or (0, 0)))

    def call():
        out = torch.empty(length + k - 1, c_out, bsz, device=dev,
                          dtype=torch.bfloat16)
        part = (torch.empty(geo["in_slices"], geo["part"], device=dev)
                if geo["in_slices"] > 1 else None)
        kernel_lib.launch(
            "convt_tm", "convt1d_ola_tm_fwd_bf16", dev, x.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), length, c_in, c_out,
            k, bsz, geo["nc"], geo["mb"], geo["ci_slice"], geo["blocks"])
        return out

    got, again = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _bf16_close(got, K.convt1d_ola_tm_plain(x, w), "K3 plain")
    _bf16_close(got, K.convt1d_ola_tm(x.float(), w.float()).to(
        torch.bfloat16), "K3 float32")


@pytest.mark.parametrize("op", ["k1", "k2", "k3", "k4", "packed"])
def test_bf16_refuses_gradients_and_takes_unaligned_views(dev, op):
    """K1, K2 and K3 take bf16 gradients on the card, through their bf16
    backward entries only (no float32 or plain backward instead); so do K4
    and a packed op (K5 here), refused until their bf16 backwards were
    ported: each bf16 backward entry launches once (K5: its dx on the
    flipped taps and its wgrad); a bf16 input whose data starts off a
    16-byte boundary is copied, not misread."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P
    from rtfs_tpu_torch.ops import sru_fused as S
    from rtfs_tpu_torch.ops import sru_pallas as K4

    rng = np.random.default_rng(9)
    vb = _b(rng, (8, 32), dev, 0.3)
    if op == "k4":
        ins = [_b(rng, (9, 96, 70), dev), _b(rng, (9, 32, 70), dev),
               _b(rng, (2, 32), dev), _b(rng, (2, 32), dev)]
        ins = [t.requires_grad_() for t in ins]
        out = K4.sru_recurrence(*ins)
        kernel_lib.reset_launches()
        grads = torch.autograd.grad(out, ins, torch.ones_like(out))
        assert dict(kernel_lib.LAUNCHES) == {"sru_recurrence_bwd_bf16": 1}
        assert all(g.dtype == torch.bfloat16 for g in grads)
        return
    if op == "packed":
        xp = _b(rng, (1, 9, 5 * 8), dev).requires_grad_()
        w = _b(rng, (4, 4, 8), dev).requires_grad_()
        out = P.dw_conv_packed(xp, w, None, 5, 8, (1, 2), (1, 2))
        kernel_lib.reset_launches()
        grads = torch.autograd.grad(out, (xp, w), torch.ones_like(out))
        assert dict(kernel_lib.LAUNCHES) == {
            "dw_conv_packed_fwd_bf16": 1, "dw_conv_packed_wgrad_bf16": 1}
        assert all(g.dtype == torch.bfloat16 for g in grads)
        return
    if op == "k1":
        ins = [_b(rng, (9, 128, 70), dev), _b(rng, (9, 128, 70), dev), vb]
        fwd, name = S.sru_dual_recurrence, "sru_dual_recurrence"
    elif op == "k2":
        ins = [_b(rng, (9, 32, 70), dev), _b(rng, (9, 32, 70), dev),
               _b(rng, (192, 64), dev, 0.1), vb]
        fwd, name = S.sru_hidden_layer, "sru_hidden_layer"
    else:
        ins = [_b(rng, (9, 64, 70), dev), _b(rng, (8, 64, 64), dev, 0.05)]
        fwd, name = K.convt1d_ola_tm, "convt1d_ola_tm"
    ins = [t.requires_grad_() for t in ins]
    outs = fwd(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    kernel_lib.reset_launches()
    grads = torch.autograd.grad(outs, ins, [torch.ones_like(o) for o in outs])
    assert dict(kernel_lib.LAUNCHES) == {f"{name}_bwd_bf16": 1}
    assert all(g.dtype == torch.bfloat16 for g in grads)
    if op != "k1":
        return
    big = _b(rng, (9 * 128 * 70 + 3,), dev)
    u_f = big[3:].view(9, 128, 70)  # 6 bytes off
    assert u_f.data_ptr() % 16 != 0
    u_r = u_f.clone()
    for g, w in zip(S.sru_dual_recurrence(u_f, u_r, vb),
                    S.sru_dual_recurrence_plain(u_f, u_r, vb)):
        _bf16_close(g, w, "K1 unaligned")


def _bf16_grad_close(got, want, what="", scale=None):
    """Two bf16 ulps of a gradient, the floor relative to its largest
    value: |got - want| <= 2^-7 max(|want|, scale, 2^-6 max|want|)
    (chip_smoke.bf16_grad_ulps)."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    g, w = got.float(), want.float()
    mag = w.abs() if scale is None else torch.maximum(w.abs(), scale)
    bound = 2.0 ** -7 * torch.clamp(mag, min=2.0 ** -6 * w.abs().max())
    bad = (g - w).abs() > bound
    assert not bad.any(), (what, int(bad.sum()), (g - w).abs().max().item())


# the bs-1 and bs-4 training sites (freq L 57 / B 125 per item, time L 118
# / B 64), ragged odd batches, H 8 and 48, T 1 and a T with an odd count;
# H 80 and 300, where K2's bf16 backward splits the units over the grid,
# H 600, where it streams X and W_d through a ring, and H 64 over B 500,
# where its scan takes every thread (the next chunk's copies go before U)
@pytest.mark.parametrize("t_len,h,bsz", [
    (57, 32, 125), (118, 32, 64), (57, 32, 500), (118, 32, 256),
    (13, 8, 33), (5, 48, 7), (1, 32, 77), (37, 32, 131), (19, 80, 64),
    (9, 300, 40), (5, 600, 20), (7, 64, 500), (1, 48, 125), (5, 48, 131),
    (5, 32, 1000), (1, 32, 131), (5, 48, 1000), (57, 32, 1000)])
def test_bf16_k1_k2_backward_match_plain(dev, t_len, h, bsz):
    """K1 and K2 backward in bf16 storage against their plain bf16
    versions (two bf16 ulps; K2's dx scaled by its three roundings, the two
    directions' dx rounded apart and their bf16 sum), against the float32
    kernels on the same values widened (flat cosine above 0.999); two
    calls give the same bits; the launches are the bf16 entries."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(12)
    vb = _b(rng, (8, h), dev, 0.3)
    dh = [_b(rng, (t_len, h, bsz), dev, 0.1) for _ in range(2)]
    u = [_b(rng, (t_len, 4 * h, bsz), dev) for _ in range(2)]
    x = [_b(rng, (t_len, h, bsz), dev, 0.5) for _ in range(2)]
    wt = _b(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    c1 = S._k1_forward(*u, vb, with_c=True)[2:]
    c2 = S._k2_forward(*x, wt, vb, with_c=True)[2:]
    for kern, plain, args, entry in (
            (S._k1_backward, S.sru_dual_recurrence_bwd_plain,
             (*u, vb, *c1, *dh), "sru_dual_recurrence_bwd_bf16"),
            (S._k2_backward, S.sru_hidden_layer_bwd_plain,
             (*x, wt, vb, *c2, *dh), "sru_hidden_layer_bwd_bf16")):
        kernel_lib.reset_launches()
        got = kern(*args)
        assert dict(kernel_lib.LAUNCHES) == {entry: 1}
        want = plain(*args)
        scales = [None] * len(got)
        if entry == "sru_hidden_layer_bwd_bf16":
            dxa, dxb = (t.to(torch.bfloat16).float().abs()
                        for t in S.hidden_bwd_terms(*args)[:2])
            scales[:2] = (dxa[:, :h] + dxb[:, :h] + want[0].float().abs(),
                          dxa[:, h:] + dxb[:, h:] + want[1].float().abs())
        for i, (g, w) in enumerate(zip(got, want)):
            _bf16_grad_close(g, w, f"{entry} {i}", scales[i])
        f32 = kern(*(a.float() for a in args))
        a = torch.cat([g.float().reshape(-1) for g in got]).double()
        b = torch.cat([g.reshape(-1) for g in f32]).double()
        assert (a @ b / (a.norm() * b.norm())).item() > 0.999
        for p, q in zip(got, kern(*args)):
            assert torch.equal(p, q)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(57, 64, 64, 125, 8), (118, 64, 64, 256, 8),
                          (13, 32, 48, 17, 5), (57, 160, 64, 125, 8),
                          (7, 72, 130, 40, 16), (1, 64, 64, 77, 8),
                          (57, 64, 64, 500, 8)])
def test_bf16_k3_backward_matches_plain(dev, length, c_in, c_out, bsz, k):
    """K3 backward in bf16 storage against its plain bf16 version and the
    float32 kernel on the widened values; two calls give the same bits
    (wide input and output channels split over the grid included)."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import kernel_lib

    rng = np.random.default_rng(13)
    x = _b(rng, (length, c_in, bsz), dev)
    w = _b(rng, (k, c_out, c_in), dev, 0.1)
    g = _b(rng, (length + k - 1, c_out, bsz), dev, 0.1)
    kernel_lib.reset_launches()
    got = K._backward(g, x, w)
    assert dict(kernel_lib.LAUNCHES) == {"convt1d_ola_tm_bwd_bf16": 1}
    for i, (a, b) in enumerate(zip(got, K.convt1d_ola_tm_bwd_plain(g, x, w))):
        _bf16_grad_close(a, b, f"K3 {i}")
    f32 = K._backward(g.float(), x.float(), w.float())
    a = torch.cat([t.float().reshape(-1) for t in got]).double()
    b = torch.cat([t.reshape(-1) for t in f32]).double()
    assert (a @ b / (a.norm() * b.norm())).item() > 0.999
    for p, q in zip(got, K._backward(g, x, w)):
        assert torch.equal(p, q)


def test_bf16_k3_k2_wgrad_do_not_drift_on_positive_sums(dev):
    """K3's and K2's bf16 dW kernels keep their sums in the tensor core's
    accumulators (which round toward zero) for one pass or chunk only,
    then add them to float32 sums. On all-positive inputs at the bs-4
    training shapes, where every product adds to the sum and a bias toward
    zero adds up, their float32 partials (before the bf16 rounding) summed
    in float64 hold against dW in float64 to 1e-4 of max|dW|: K3 in the
    geometry's runs of l steps and in one run of all of L a column tile
    (57 k16 steps in one block), K2 (its x, dh and v, b positive) in its
    batch tiles, each block a whole T. Two calls give the same bits."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(16)
    length, c, bsz, k = 57, 64, 500, 8
    x = _b(rng, (length, c, bsz), dev).abs()
    w = _b(rng, (k, c, c), dev, 0.1)
    g = _b(rng, (length + k - 1, c, bsz), dev, 0.1).abs()
    want = K.convt1d_ola_tm_bwd_plain(g.double(), x.double(), w.double())[1]
    geo = K.bwd_bf16_geometry(length, c, c, k, bsz)
    assert geo["lsteps"] < length
    for lsteps in (geo["lsteps"], length):
        def call():
            parts = torch.empty(-(-bsz // 16) * -(-length // lsteps), k, c,
                                c, device=dev)
            dx, dw = torch.empty_like(x), torch.empty_like(w)
            kernel_lib.launch(
                "convt_tm", "convt1d_ola_tm_bwd_bf16", dev, g.data_ptr(),
                w.data_ptr(), x.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                parts.data_ptr(), None, length, c, c, k, bsz, lsteps)
            return parts

        got = call()
        _close((got.double().sum(0),), (want,), rel=1e-4)
        assert torch.equal(got, call())
    t_len, h, bsz = 118, 32, 256
    x = [_b(rng, (t_len, h, bsz), dev, 0.5).abs() for _ in range(2)]
    dh = [_b(rng, (t_len, h, bsz), dev, 0.1).abs() for _ in range(2)]
    wt = _b(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    vb = _b(rng, (8, h), dev, 0.3).abs()
    c2 = S._k2_forward(*x, wt, vb, with_c=True)[2:]
    want = S.hidden_bwd_terms(*(a.double() for a in (*x, wt, vb, *c2, *dh)))[2]
    geo = S.k2_bwd_bf16_geometry(t_len, h, bsz)

    def call():
        dxd = torch.empty(2, t_len, 2 * h, bsz, device=dev, dtype=x[0].dtype)
        parts = torch.empty(geo["tiles"], 6 * h, 2 * h, device=dev)
        vparts = torch.empty(geo["tiles"], 8, h, device=dev)
        outs = [torch.empty_like(t) for t in (x[0], x[1], wt, vb)]
        kernel_lib.launch(
            "sru_fused", "sru_hidden_layer_bwd_bf16", dev,
            *(t.data_ptr() for t in (*x, wt, vb, *c2, *dh, *outs, dxd,
                                     parts, vparts)),
            t_len, h, bsz, geo["bt"], geo["steps"], geo["units"],
            int(geo["stream"]))
        return parts

    got = call()
    _close((got.double().sum(0),), (want,), rel=1e-4)
    assert torch.equal(got, call())


def test_bf16_backward_refuses_mixed_dtypes(dev):
    """A bf16 backward with one float32 operand raises: nothing is cast to
    reach either kernel."""
    from rtfs_tpu_torch.ops import convt_tm as K
    from rtfs_tpu_torch.ops import sru_fused as S

    rng = np.random.default_rng(14)
    u = [_b(rng, (9, 32, 20), dev) for _ in range(2)]
    c = [_b(rng, (9, 8, 20), dev) for _ in range(4)]
    with pytest.raises(TypeError):
        S._k1_backward(*u, _b(rng, (8, 8), dev), c[0].float(), *c[1:])
    x = [_b(rng, (9, 8, 20), dev) for _ in range(2)]
    with pytest.raises(TypeError):
        S._k2_backward(*x, _t(rng, (48, 16), dev), _b(rng, (8, 8), dev), *c)
    with pytest.raises(TypeError):
        K._backward(_t(rng, (16, 8, 20), dev), _b(rng, (9, 16, 20), dev),
                    _b(rng, (8, 8, 16), dev))


def test_bf16_dual_path_rnn_gradients_card_match_cpu(dev):
    """The preset's DualPathRNN block in bf16 (fused stack, K3 tail) on the
    card against its CPU path (the plain bf16 versions), forward and
    backward, at the bs-1 frequency-scan geometry: the launches are the
    bf16 entries only; the parameters' and the input's gradients, as one
    flat vector, within cosine 0.999 and relative L2 0.02."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(64, 32, dim=4, num_layers=4)
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(torch.bfloat16)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((1, 64, 118, 64)).astype(
        np.float32)).to(torch.bfloat16)
    grads = {}
    for d in ("cpu", dev):
        m.to(d).zero_grad()
        xi = x.detach().to(d).requires_grad_()
        kernel_lib.reset_launches()
        y = m(xi)
        y.float().square().mean().backward()
        if d != "cpu":
            assert dict(kernel_lib.LAUNCHES) == {
                "sru_dual_recurrence_fwd_bf16": 1,
                "sru_hidden_layer_fwd_bf16": 3, "convt1d_ola_tm_fwd_bf16": 1,
                "sru_dual_recurrence_bwd_bf16": 1,
                "sru_hidden_layer_bwd_bf16": 3, "convt1d_ola_tm_bwd_bf16": 1}
        grads[str(d)] = torch.cat(
            [xi.grad.float().reshape(-1).cpu()]
            + [p.grad.float().reshape(-1).cpu() for p in m.parameters()])
    a, b = grads["cuda"].double(), grads["cpu"].double()
    assert (a @ b / (a.norm() * b.norm())).item() > 0.999
    assert ((a - b).norm() / b.norm()).item() < 0.02


def test_bf16_dual_path_rnn_card_matches_cpu(dev):
    """The preset's DualPathRNN in bf16 (fused stack, K3 tail, bias in
    bf16) on the card against its CPU path (the plain bf16 versions), at
    the bs-1 frequency-scan geometry."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import kernel_lib

    m = DualPathRNN(64, 32, dim=4, num_layers=4)
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 64, 118, 64)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        want = m(x)
        kernel_lib.reset_launches()
        got = m.to(dev)(x.to(dev)).cpu()
    assert dict(kernel_lib.LAUNCHES) == {
        "sru_dual_recurrence_fwd_bf16": 1, "sru_hidden_layer_fwd_bf16": 3,
        "convt1d_ola_tm_fwd_bf16": 1}
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


# K2 forward in bf16 where its held kernel does not fit one block (H above
# 504, above 272 where B is not a multiple of 4): the streamed bf16 kernel, with B a
# multiple of 8 (16-byte copies of X), B 33 (odd: plain loads) and T a
# multiple of no chunk
@pytest.mark.parametrize("t_len,h,bsz", [(5, 600, 20), (9, 600, 33),
                                          (3, 1024, 8), (37, 537, 16)])
def test_bf16_k2_streams_a_wide_h(dev, t_len, h, bsz):
    """The streamed bf16 K2 forward against its plain bf16 version and the
    float32 kernel on the widened values (two bf16 ulps), serving and with
    c; two calls give the same bits; one bf16 launch each."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_fused as S

    assert S.k2_fwd_bf16_geometry(t_len, h, bsz)["stream"]
    rng = np.random.default_rng(14)
    vb = _b(rng, (8, h), dev, 0.3)
    x_f, x_r = (_b(rng, (t_len, h, bsz), dev, 0.5) for _ in range(2))
    wt = _b(rng, (6 * h, 2 * h), dev, (2 * h) ** -0.5)
    kernel_lib.reset_launches()
    got = S.sru_hidden_layer(x_f, x_r, wt, vb)
    assert dict(kernel_lib.LAUNCHES) == {"sru_hidden_layer_fwd_bf16": 1}
    for g, w in zip(got, S.sru_hidden_layer_plain(x_f, x_r, wt, vb)):
        _bf16_close(g, w, "K2 streamed plain")
    wide = S.sru_hidden_layer(x_f.float(), x_r.float(), wt.float(), vb.float())
    for g, w in zip(got, wide):
        _bf16_close(g, w.to(torch.bfloat16), "K2 streamed float32")
    with_c = S._k2_forward(x_f, x_r, wt, vb, with_c=True)
    for g, w in zip(with_c, S.sru_hidden_layer_plain(x_f, x_r, wt, vb, True)):
        _bf16_close(g, w, "K2 streamed plain, c")
    for a, b in zip(got, S.sru_hidden_layer(x_f, x_r, wt, vb)):
        assert torch.equal(a, b)


# K5-K9 forward in bf16 storage: the packed serving shapes at bs 1 and 8
# (STFT 251 x 129, hid 64, bottleneck 256, pooled 125 x 64; M = 32379 is
# odd, so every other channel row of K6's x and K7's out starts on a
# 2-byte boundary), a ragged shape (C 6: scalar chunks; F 7), C 37 and an
# input 2 bytes off alignment; (B, T, F, C, Cb, offset in values)
PACKED16_SHAPES = {"bs1": (1, 251, 129, 64, 256, 0),
                   "bs8": (8, 251, 129, 64, 256, 0),
                   "ragged": (3, 13, 7, 6, 20, 0),
                   "odd-c": (1, 21, 18, 37, 70, 0),
                   "off": (2, 17, 10, 64, 40, 1)}


@pytest.mark.parametrize("shape", sorted(PACKED16_SHAPES))
def test_bf16_packed_kernels_match_plain(dev, shape):
    """K5 (both pads), K6, K7, K8 (pool and select) and K9 (nearest) in
    bf16 storage against their plain bf16 versions and the float32 kernels
    on the widened values, two bf16 ulps at every element; two calls give
    the same bits; each launches its bf16 entry once."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, cb, off = PACKED16_SHAPES[shape]
    rng = np.random.default_rng(15)

    def x(*dims, scale=1.0):
        flat = _b(rng, (int(np.prod(dims)) + off,), dev, scale)
        return flat[off:].view(dims)

    same, pre = (1, 2), (1, 1)
    t2, f2 = (t - 2) // 2 + 1, (f - 2) // 2 + 1
    pool = P.cached_map("pool", t, t2, f, f2)
    sel = P.cached_map("select", t - 1, t2, f - 1, f2)
    up = P.cached_map("nearest", t2, t, f2, f)
    w_dw = _b(rng, (c, 1, 4, 4), dev, 0.25)[:, 0].permute(1, 2, 0)
    w_in = _b(rng, (c, cb, 1, 1), dev, cb ** -0.5)[:, :, 0, 0].t()
    w_out = _b(rng, (cb, c, 1, 1), dev, c ** -0.5)[:, :, 0, 0].t()
    bias_c, bias_cb = _b(rng, (c,), dev), _b(rng, (cb,), dev)
    xp = x(b, t, f * c)
    cases = {  # entry: (op, plain, args)
        "dw_conv_packed_fwd_bf16 same": (
            P.dw_conv_packed, P.dw_conv_packed_plain,
            (xp, w_dw, bias_c, f, c, same, same)),
        "dw_conv_packed_fwd_bf16 pre": (
            P.dw_conv_packed, P.dw_conv_packed_plain,
            (xp, w_dw, None, f, c, pre, pre)),
        "pw_proj_packed_fwd_bf16": (
            P.pw_proj_packed, P.pw_proj_packed_plain,
            (x(b, cb, t, f), w_in, bias_c)),
        "pw_unproj_packed_fwd_bf16": (
            P.pw_unproj_packed, P.pw_unproj_packed_plain,
            (xp, w_out, bias_cb, f)),
        "spatial_down_packed_fwd_bf16 pool": (
            P.spatial_down_packed, P.spatial_down_packed_plain,
            (xp, pool, c)),
        "spatial_down_packed_fwd_bf16 select": (
            P.spatial_down_packed, P.spatial_down_packed_plain,
            (x(b, t - 1, (f - 1) * c), sel, c)),
        "spatial_up_packed_fwd_bf16": (
            P.spatial_up_packed, P.spatial_up_packed_plain,
            (x(b, c, t2, f2), up)),
    }
    for name, (op, plain, args) in cases.items():
        kernel_lib.reset_launches()
        got = op(*args)
        assert dict(kernel_lib.LAUNCHES) == {name.split()[0]: 1}, name
        _bf16_close(got, plain(*args), f"{name} plain")
        wide = tuple(a.float() if torch.is_tensor(a) else a for a in args)
        _bf16_close(got, op(*wide).to(torch.bfloat16), f"{name} float32")
        assert torch.equal(got, op(*args)), name


def test_bf16_packed_refuses_mixed_dtypes_and_gradients(dev):
    """A bf16 packed op with a float32 weight or bias raises (nothing is
    cast to reach the float32 kernel); one that autograd records, refused
    until K5-K9's bf16 backward was ported, now runs its backward through
    the bf16 entries only (K5: its dx and wgrad; K9: K8 on the transposed
    map)."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    rng = np.random.default_rng(16)
    xp = _b(rng, (1, 9, 5 * 8), dev)
    w = _b(rng, (8, 1, 4, 4), dev)[:, 0].permute(1, 2, 0)
    with pytest.raises(TypeError):
        P.dw_conv_packed(xp, w.float(), None, 5, 8, (1, 2), (1, 2))
    with pytest.raises(TypeError):
        P.pw_unproj_packed(xp, _b(rng, (8, 16), dev),
                           _t(rng, (16,), dev), 5)
    xg, wg = xp.clone().requires_grad_(), w.detach().clone().requires_grad_()
    out = P.dw_conv_packed(xg, wg, None, 5, 8, (1, 2), (1, 2))
    kernel_lib.reset_launches()
    torch.autograd.grad(out, (xg, wg), torch.ones_like(out))
    assert dict(kernel_lib.LAUNCHES) == {"dw_conv_packed_fwd_bf16": 1,
                                         "dw_conv_packed_wgrad_bf16": 1}
    x4 = _b(rng, (1, 8, 4, 3), dev).requires_grad_()
    out = P.spatial_up_packed(x4, P.cached_map("nearest", 4, 9, 3, 5))
    kernel_lib.reset_launches()
    (dx,) = torch.autograd.grad(out, (x4,), torch.ones_like(out))
    assert dict(kernel_lib.LAUNCHES) == {"spatial_down_packed_fwd_bf16": 1}
    assert dx.dtype == torch.bfloat16


def test_bf16_packed_tdanet_block_card_matches_cpu(dev):
    """A packed TDANet block in bf16 on the card (K5-K9's bf16 entries)
    against the same block on the CPU (the plain bf16 versions): the
    launches are the bf16 entries only, the outputs bf16 and close."""
    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.separators import TDANetBlock
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    m = TDANetBlock(16, 8, kernel_size=4, upsampling_depth=2, is2d=True)
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.eval().to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 16, 21, 17)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad(), P.packed_scope(True):
        want = m(x)
        kernel_lib.reset_launches()
        got = m.to(dev)(x.to(dev)).cpu()
    assert kernel_lib.LAUNCHES == {
        "dw_conv_packed_fwd_bf16": 4, "pw_proj_packed_fwd_bf16": 1,
        "pw_unproj_packed_fwd_bf16": 1, "spatial_down_packed_fwd_bf16": 2,
        "spatial_up_packed_fwd_bf16": 4}
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


# K8 / K9 in bf16 storage (spatial_{down,up}_bf16_kernel): MAP_SHAPES and
# the training batch; their inputs also 2 and 8 bytes off a 16-byte
# boundary (value-by-value chunks) on the ragged and serving shapes
MAP16_SHAPES = {**MAP_SHAPES, "training-bs4": (4, 251, 129, 64)}


@pytest.mark.parametrize("shape", sorted(MAP16_SHAPES))
def test_k8_k9_bf16_match_plain_and_float32(dev, shape):
    """bf16 K8 and K9 at the three maps and their transposes against the
    plain bf16 versions and the float32 kernels on the widened values, two
    bf16 ulps (the transposed pool, a bf16 sum of terms rounded apart:
    two ulps of the terms' magnitude beside the float32 kernel), two calls
    bit-identical, one launch of the bf16 entry each."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c = MAP16_SHAPES[shape]
    t2, f2 = (t - 2) // 2 + 1, (f - 2) // 2 + 1
    pool = P.cached_map("pool", t, t2, f, f2)
    sel = P.cached_map("select", t - 1, t2, f - 1, f2)
    up = P.cached_map("nearest", t2, t, f2, f)
    rng = np.random.default_rng(20)
    down_fn = (P.spatial_down_packed, P.spatial_down_packed_plain)
    up_fn = (P.spatial_up_packed, P.spatial_up_packed_plain)
    offsets = (0, 1, 4) if shape in ("ragged", "serving") else (0,)
    for off in offsets:
        def x(*dims):
            flat = _b(rng, (int(np.prod(dims)) + off,), dev)
            return flat[off:].view(dims)

        cases = [  # (entry, kernel and plain, arguments)
            ("down pool", down_fn, (x(b, t, f * c), pool, c)),
            ("down select", down_fn, (x(b, t - 1, (f - 1) * c), sel, c)),
            ("up nearest", up_fn, (x(b, c, t2, f2), up)),
            ("down transposed nearest", down_fn,
             (x(b, t, f * c), up.transposed(f2), c)),
            ("up transposed pool", up_fn, (x(b, c, t2, f2),
                                           pool.transposed(f))),
            ("up transposed select", up_fn, (x(b, c, t2, f2),
                                             sel.transposed(f - 1))),
        ]
        for name, (kern, plain), args in cases:
            what = f"{name} {shape} off {off}"
            kernel_lib.reset_launches()
            got = kern(*args)
            entry = ("spatial_up_packed_fwd_bf16" if name.startswith("up")
                     else "spatial_down_packed_fwd_bf16")
            assert dict(kernel_lib.LAUNCHES) == {entry: 1}, what
            _bf16_close(got, plain(*args), what)
            f32 = kern(args[0].float(), *args[1:]).to(torch.bfloat16)
            smap = args[1]
            if name.startswith("up") and smap.fs.shape[1] > 1:
                absmap = P.SpatialMap(np.abs(smap.m), smap.fs,
                                      np.abs(smap.fw))
                mag = P.spatial_up_packed_plain(args[0].float().abs(),
                                                absmap)
                g, w = got.float(), f32.float()
                bound = 2.0 ** -7 * torch.clamp(w.abs() + mag,
                                                min=2.0 ** -6)
                assert not ((g - w).abs() > bound).any(), what
            else:
                _bf16_close(got, f32, f"{what} float32")
            assert torch.equal(got, kern(*args)), what


def test_k8_k9_bf16_refuse_a_tile_larger_than_shared_memory(dev):
    """The bf16 plan's tiles: K8's 16 f2 x C and K9's staged chunks x C
    float32; at C 8192 neither fits a block, and the wrappers raise."""
    from rtfs_tpu_torch.ops import packed_tf as P

    pool = P.cached_map("pool", 2, 1, 2, 1)
    c = 8192
    with pytest.raises(ValueError, match="shared memory"):
        P.spatial_down_packed(torch.zeros(1, 2, 2 * c, device=dev,
                                          dtype=torch.bfloat16), pool, c)
    with pytest.raises(ValueError, match="shared memory"):
        P.spatial_up_packed(torch.zeros(1, c, 1, 1, device=dev,
                                        dtype=torch.bfloat16),
                            pool.transposed(2))


# ------------------------------------------------------------- bf16 K4,
# K5-wgrad, pw-wgrad and the packed backward


# the uni sites at bs 1, 4 and 8 (freq L 57 / B 125 a batch item, time L
# 118 / B 64), odd batches (rows of 125 B and 64 B values start on 2-byte
# boundaries: the forward's 16-byte copies start at every offset mod 8, the
# scan reads a 4-byte word at a time), a T shorter than the scan's ring
# and one step longer, one column, H 8, 48 and 80 (the wide phase's)
K4_BF16_SHAPES = [(57, 32, 125), (118, 32, 64), (57, 32, 500),
                  (118, 32, 256), (57, 32, 1000), (118, 32, 512),
                  (SCAN_AHEAD // 2, 32, 131), (SCAN_AHEAD + 1, 8, 33),
                  (1, 32, 1), (37, 48, 77), (118, 48, 64), (57, 80, 125)]


@pytest.mark.parametrize("t_len,h,bsz", K4_BF16_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_k4_matches_plain(dev, t_len, h, bsz, reverse):
    """K4 forward (serving and with c) and backward in bf16 storage
    against their plain bf16 versions (two bf16 ulps; d(v, b) rounded a
    batch column, as JAX) and the float32 kernels on the widened values;
    two calls give the same bits; only the bf16 entries launch."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(40)
    u, x = _b(rng, (t_len, 3 * h, bsz), dev), _b(rng, (t_len, h, bsz), dev)
    vb = _b(rng, (4, h), dev, 0.3)
    dh = _b(rng, (t_len, h, bsz), dev, 0.1)
    kernel_lib.reset_launches()
    got_h = S._k4_forward(u, x, vb, reverse, False)
    h_c, c = S._k4_forward(u, x, vb, reverse, True)
    got = S._k4_backward(u, x, vb, c, dh, reverse)
    assert dict(kernel_lib.LAUNCHES) == {"sru_recurrence_fwd_bf16": 2,
                                         "sru_recurrence_bwd_bf16": 1}
    want_h, want_c = S.sru_recurrence_plain(u, x, vb, reverse, with_c=True)
    for g, w, what in ((got_h, want_h, "h"), (h_c, want_h, "h with c"),
                       (c, want_c, "c")):
        _bf16_close(g, w, f"K4 {what}")
    assert torch.equal(got_h, h_c)
    f32_h, f32_c = S._k4_forward(u.float(), x.float(), vb.float(), reverse,
                                 True)
    _bf16_close(got_h, f32_h.to(torch.bfloat16), "K4 h float32")
    _bf16_close(c, f32_c.to(torch.bfloat16), "K4 c float32")
    want = S.sru_recurrence_bwd_plain(u, x, vb, c, dh, reverse)
    for i, (g, w) in enumerate(zip(got, want)):
        _bf16_grad_close(g, w, f"K4 backward {i}")
    f32 = S._k4_backward(*(t.float() for t in (u, x, vb, c, dh)), reverse)
    a = torch.cat([t.float().reshape(-1) for t in got]).double()
    b = torch.cat([t.reshape(-1) for t in f32]).double()
    assert (a @ b / (a.norm() * b.norm())).item() > 0.999
    assert torch.equal(got_h, S._k4_forward(u, x, vb, reverse, False))
    for p, q in zip(got, S._k4_backward(u, x, vb, c, dh, reverse)):
        assert torch.equal(p, q)


def test_bf16_k4_function_and_unaligned_views(dev):
    """The bf16 Function's gradients against the plain bf16 backward on
    the same card inputs, with u and xhw views whose data start 2 bytes
    off a 4-byte word (copied by the layer, read a word at a time by the
    kernel otherwise)."""
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(41)
    t_len, h, bsz = 45, 32, 125
    big = _b(rng, (t_len * 3 * h * bsz + 1,), dev)
    u = big[1:].view(t_len, 3 * h, bsz)
    assert u.data_ptr() % 4 == 2
    x, vb = _b(rng, (t_len, h, bsz), dev), _b(rng, (4, h), dev, 0.3)
    h_got = S._k4_forward(u, x, vb, False, False)
    _bf16_close(h_got, S.sru_recurrence_plain(u, x, vb), "K4 unaligned u")
    ins = [t.clone().requires_grad_() for t in (u, x, vb[:2], vb[2:])]
    dh = _b(rng, (t_len, h, bsz), dev, 0.1)
    got = torch.autograd.grad(S.sru_recurrence(*ins), ins, dh)
    _, c = S.sru_recurrence_plain(u, x, vb, with_c=True)
    du, dx, dvb = S.sru_recurrence_bwd_plain(u, x, vb, c, dh)
    for g, w, what in zip(got, (du, dx, dvb[:2], dvb[2:]),
                          ("du", "dxhw", "dv", "db")):
        _bf16_grad_close(g, w, f"K4 Function {what}")


def test_bf16_k4_and_wgrads_refuse_mixed_dtypes(dev):
    """A bf16 K4 or packed weight gradient with one float32 operand raises:
    nothing is cast to reach either kernel."""
    from rtfs_tpu_torch.ops import packed_tf as P
    from rtfs_tpu_torch.ops import sru_pallas as S

    rng = np.random.default_rng(42)
    u, x = _b(rng, (9, 24, 20), dev), _b(rng, (9, 8, 20), dev)
    vb = _b(rng, (4, 8), dev)
    with pytest.raises(TypeError):
        S._k4_forward(u, x.float(), vb, False, False)
    with pytest.raises(TypeError):
        S._k4_backward(u, x, vb.float(), x, x, False)
    xp = _b(rng, (1, 9, 5 * 8), dev)
    with pytest.raises(TypeError):
        P.dw_conv_packed_wgrad(xp, xp.float(), 5, 8, (4, 4), (1, 2), (1, 2))
    with pytest.raises(TypeError):
        P.pw_packed_wgrad(_b(rng, (1, 16, 9, 5), dev), xp.float())


# K5-wgrad in bf16: the bs-4 training shape, ragged (C 6: values one by
# one with plain loads), C 37 (a partial quad), C 72 (two channel blocks)
# and an x 2 bytes off 8-byte alignment; (B, T, F, C, x offset in values)
WGRAD16_SHAPES = {"bs4-train": (4, 251, 129, 64, 0), "ragged": (3, 13, 7, 6, 0),
                  "odd-c": (2, 9, 11, 37, 0), "c-72": (1, 6, 7, 72, 0),
                  "off": (2, 17, 10, 64, 1)}


@pytest.mark.parametrize("shape", sorted(WGRAD16_SHAPES))
@pytest.mark.parametrize("kt,pads", [(4, (1, 2)), (4, (1, 1)), (3, (1, 1))])
def test_bf16_k5_wgrad_matches_plain(dev, shape, kt, pads):
    """K5-wgrad on bf16 x and g (a float32 dW) against its plain version
    (float32 on the widened operands) and the float32 kernel on the same
    values widened, to 1e-4 of max|dW|; two calls give the same bits."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, off = WGRAD16_SHAPES[shape]
    rng = np.random.default_rng(43)
    t_out, f_out = P.dw_geometry(t, f, kt, kt, pads, pads)
    flat = _b(rng, (b * t * f * c + off,), dev)
    xp = flat[off:].view(b, t, f * c)
    g = _b(rng, (b, t_out, f_out * c), dev)
    kernel_lib.reset_launches()
    got = P.dw_conv_packed_wgrad(xp, g, f, c, (kt, kt), pads, pads)
    assert dict(kernel_lib.LAUNCHES) == {"dw_conv_packed_wgrad_bf16": 1}
    assert got.dtype == torch.float32
    want = P.dw_conv_packed_wgrad_plain(xp.float(), g.float(), f, c,
                                        (kt, kt), pads, pads)
    _close((got,), (want,), rel=1e-4)
    f32 = P.dw_conv_packed_wgrad(xp.float(), g.float(), f, c, (kt, kt), pads,
                                 pads)
    _close((got,), (f32,), rel=1e-4)
    assert torch.equal(got, P.dw_conv_packed_wgrad(xp, g, f, c, (kt, kt),
                                                   pads, pads))


@pytest.mark.parametrize("shape", sorted(PW_WGRAD_SHAPES))
def test_bf16_pw_wgrad_matches_plain(dev, shape):
    """pw-wgrad on bf16 a and g (bf16 m16n8k16 products, a float32 dW)
    against its plain version and the float32 kernel on the widened
    values, K6's dW and K7's, to 1e-4 of max|dW|; two calls give the same
    bits; the bf16 entry launches."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_WGRAD_SHAPES[shape]
    rng = np.random.default_rng(44)
    for a, g in (((b, ci, t, f), (b, t, f * c)),   # K6's dW
                 ((b, t, f * c), (b, ci, t, f))):  # K7's dW
        a, g = _b(rng, a, dev), _b(rng, g, dev)
        kernel_lib.reset_launches()
        got = P.pw_packed_wgrad(a, g)
        assert dict(kernel_lib.LAUNCHES) == {"pw_packed_wgrad_bf16": 1}
        assert got.dtype == torch.float32
        _close((got,), (P.pw_packed_wgrad_plain(a, g),), rel=1e-4)
        _close((got,), (P.pw_packed_wgrad(a.float(), g.float()),), rel=1e-4)
        assert torch.equal(got, P.pw_packed_wgrad(a, g))


# pw-wgrad's packed sites at bs 1 and 8 (bs 4: PW_WGRAD_SHAPES'
# "bs4-train"), and C 60 (the packed side value by value)
PW_WGRAD16_SITES = {"bs1": (1, 251, 129, 64, 256),
                    "bs8": (8, 251, 129, 64, 256),
                    "c60-ci100": (2, 9, 13, 60, 100)}


@pytest.mark.parametrize("shape", sorted(PW_WGRAD16_SITES))
def test_bf16_pw_wgrad_sites_match_plain(dev, shape):
    """test_bf16_pw_wgrad_matches_plain at the packed bs-1 and bs-8
    sites and a packed side of 60 channels, with the planar operand a view
    2 bytes off 16-byte alignment (copied by the wrapper)."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_WGRAD16_SITES[shape]
    rng = np.random.default_rng(46)
    for planar_first in (True, False):
        flat = _b(rng, (b * ci * t * f + 1,), dev)
        four = flat[1:].view(b, ci, t, f)
        packed = _b(rng, (b, t, f * c), dev)
        a, g = (four, packed) if planar_first else (packed, four)
        kernel_lib.reset_launches()
        got = P.pw_packed_wgrad(a, g)
        assert dict(kernel_lib.LAUNCHES) == {"pw_packed_wgrad_bf16": 1}
        _close((got,), (P.pw_packed_wgrad_plain(a, g),), rel=1e-4)
        _close((got,), (P.pw_packed_wgrad(a.float(), g.float()),), rel=1e-4)
        assert torch.equal(got, P.pw_packed_wgrad(a, g))


def test_bf16_pw_wgrad_does_not_drift_on_positive_sums(dev):
    """test_pw_wgrad_does_not_drift_on_positive_sums on the bf16 entry:
    all-positive bf16 a and g at the bs-4 training shape, both layouts,
    against float64 to 1e-4 of max|dW|, in the geometry's chunks and in
    one chunk a batch row: the tensor core's sum (toward zero) is added to
    a float32 sum every stage."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, ci = PW_WGRAD_SHAPES["bs4-train"]
    whole = -(-(t * f) // P.PW_WGRAD_K) * P.PW_WGRAD_K
    rng = np.random.default_rng(45)
    for a, g in (((b, ci, t, f), (b, t, f * c)),
                 ((b, t, f * c), (b, ci, t, f))):
        a, g = _b(rng, a, dev).abs(), _b(rng, g, dev).abs()
        want = P.pw_packed_wgrad_plain(a.double(), g.double())
        ints = P.pw_wgrad_launch_ints(a, g)
        for chunk, parts in (ints[5:], (whole, b)):
            def call():
                partial = torch.empty(parts, want.numel(), device=dev)
                out = torch.empty(want.shape, device=dev)
                kernel_lib.launch(
                    "packed_tf", "pw_packed_wgrad_bf16", dev, a.data_ptr(),
                    g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                    *ints[:5], chunk, parts)
                return out

            got = call()
            _close((got.double(),), (want,), rel=1e-4)
            assert torch.equal(got, call())


def test_bf16_packed_functions_gradients_card_match_cpu(dev):
    """Every packed autograd Function in bf16 (dx, dW, db) on the card
    against the same Function on the CPU (the plain versions) at the
    packed bs-1 geometry: two bf16 ulps of each gradient's scale (float32
    sums in another order, each rounded once; K8's dx through the pool map
    with its source terms' magnitudes, as the CPU test's gate), the
    launches the bf16 entries only."""
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.ops import packed_tf as P

    b, t, f, c, cb = 1, 251, 129, 64, 256
    t2, f2 = (t - 2) // 2 + 1, (f - 2) // 2 + 1
    rng = np.random.default_rng(46)

    def x(*dims, scale=1.0):
        return _b(rng, dims, "cpu", scale)

    pool = P.cached_map("pool", t, t2, f, f2)
    up = P.cached_map("nearest", t2, t, f2, f)
    cases = {
        "K5": (lambda xp, w, bias: P.dw_conv_packed(
            xp, w, bias, f, c, (1, 2), (1, 2)),
               (x(b, t, f * c), x(4, 4, c, scale=0.25), x(c, scale=0.1))),
        "K6": (P.pw_proj_packed, (x(b, cb, t, f), x(cb, c, scale=cb ** -0.5),
                                  x(c, scale=0.1))),
        "K7": (lambda xp, w, bias: P.pw_unproj_packed(xp, w, bias, f),
               (x(b, t, f * c), x(c, cb, scale=c ** -0.5),
                x(cb, scale=0.1))),
        "K8": (lambda xp: P.spatial_down_packed(xp, pool, c),
               (x(b, t, f * c),)),
        "K9": (lambda x4: P.spatial_up_packed(x4, up), (x(b, c, t2, f2),)),
    }
    for name, (fn, args) in cases.items():
        grads, cot = {}, None
        for d in ("cpu", dev):
            ins = [a.to(d).requires_grad_() for a in args]
            out = fn(*ins)
            if cot is None:
                cot = x(*out.shape, scale=0.1)
            kernel_lib.reset_launches()
            grads[str(d)] = [gr.cpu() for gr in torch.autograd.grad(
                out, ins, cot.to(d))]
            if d != "cpu":
                assert kernel_lib.LAUNCHES and all(
                    k.endswith("_bf16") for k in kernel_lib.LAUNCHES), name
        for i, (g, w) in enumerate(zip(grads["cuda"], grads["cpu"])):
            scale = None
            if name == "K8":
                tmap = pool.transposed(f)
                tens = tmap.tensors(torch.device("cpu"))
                y = torch.einsum("ts,bcsu->btuc", tens["m"], cot.float())
                scale = sum((y.index_select(2, tens["fs"][:, j].long())
                             * tens["fw"][:, j, None]).abs()
                            for j in range(tens["fs"].shape[1])).reshape(
                                w.shape) + w.float().abs()
            _bf16_grad_close(g, w, f"{name} {i}", scale)
