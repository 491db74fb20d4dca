"""The packed-TF slice: K5-K9's plain versions and the packed AVNet against
``rtfs_tpu``.

Each op of ``rtfs_tpu_torch/ops/packed_tf.py`` runs on the CPU (its plain
PyTorch version) and is held against the JAX op of
``rtfs_tpu/ops/packed_tf.py`` run as ``tests/test_packed_tf.py`` runs it
(Pallas in interpret mode), at that file's ragged shapes, on the same
numpy inputs: forward to 1e-5, gradients through autograd against
``jax.grad`` through the custom VJPs to 1e-4. The port's rank-4 side is
channels-first (B, C, T, F), the JAX one (B, T, F, C); packed maps are the
same (B, T, F*C) in both.

The whole model: the port's AVNet with ``packed_tf`` against
``rtfs_tpu``'s ``AVNet(packed_tf=True)`` on carried-over variables, at
``tests/test_torch_avnet.py``'s geometry (one module-scoped JAX fixture:
its packed jit, Pallas in interpret mode, costs up to a minute).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.ops import packed_tf as JP
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch.config import build_avnet, load_config
from rtfs_tpu_torch.models import layers as L
from rtfs_tpu_torch.ops import packed_tf as P
from rtfs_tpu_torch.utils.weights import load_jax_params

B, T, F, C = 2, 13, 7, 4
CI = 6
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
PRESET = "lrs2_RTFSNet_4_layer"


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _to_cf(a):
    """JAX rank-4 (B, T, F, C) -> the port's (B, C, T, F)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


# ------------------------------------------------------------- K5


@pytest.mark.parametrize("kt,kf,pads_t,pads_f,with_bias", [
    (4, 4, (1, 2), (1, 2), True),   # torch 'same' for k 4 (the RTFS pyramid)
    (5, 5, (2, 2), (2, 2), True),   # odd kernel 'same'
    (4, 4, (1, 1), (1, 1), True),   # the stride-2 conv before its select
    (3, 3, (1, 1), (1, 1), True),
    (4, 4, (1, 2), (1, 2), False),  # bias None
])
def test_dw_conv_packed_matches_jax(kt, kf, pads_t, pads_f, with_bias):
    rng = np.random.default_rng(0)
    xp, w, bias = _np(rng, B, T, F * C), _np(rng, kt, kf, C), _np(rng, C)
    t_out, f_out = P.dw_geometry(T, F, kt, kf, pads_t, pads_f)
    cot = _np(rng, B, t_out, f_out * C)

    def jfn(xp, w, b):
        return JP.dw_conv_packed(xp, w, b if with_bias else None, F, C,
                                 pads_t, pads_f, (kt, kf), True)

    ref = jfn(xp, w, bias)
    args = [_t(xp), _t(w), _t(bias)]
    got = P.dw_conv_packed(args[0], args[1], args[2] if with_bias else None,
                           F, C, pads_t, pads_f)
    assert got.shape == ref.shape == (B, t_out, f_out * C)
    _close(got.detach(), ref, FWD_TOL)

    n = 3 if with_bias else 2
    g_ref = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                     argnums=tuple(range(n)))(xp, w, bias)
    (got * torch.from_numpy(cot)).sum().backward()
    for a, g, name in zip(args, g_ref, ("x", "w", "bias")):
        _close(a.grad, g, GRAD_TOL, name)


# ------------------------------------------------------------- K6 / K7


def test_pw_proj_packed_matches_jax():
    rng = np.random.default_rng(3)
    x4, w, bias = _np(rng, B, T, F, CI), _np(rng, CI, C), _np(rng, C)
    cot = _np(rng, B, T, F * C)

    def jfn(x, w, b):
        return JP.pw_proj_packed(x, w, b, True)

    ref = jfn(x4, w, bias)
    args = [_t(_to_cf(x4)), _t(w), _t(bias)]
    got = P.pw_proj_packed(*args)
    assert got.shape == ref.shape == (B, T, F * C)
    _close(got.detach(), ref, FWD_TOL)

    g_ref = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=(0, 1, 2))(
        x4, w, bias)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(args[0].grad, _to_cf(g_ref[0]), GRAD_TOL, "x")
    _close(args[1].grad, g_ref[1], GRAD_TOL, "w")
    _close(args[2].grad, g_ref[2], GRAD_TOL, "bias")


def test_pw_unproj_packed_matches_jax():
    rng = np.random.default_rng(4)
    xp, w, bias = _np(rng, B, T, F * C), _np(rng, C, CI), _np(rng, CI)
    cot = _np(rng, B, T, F, CI)

    def jfn(x, w, b):
        return JP.pw_unproj_packed(x, w, b, F, True)

    ref = jfn(xp, w, bias)
    args = [_t(xp), _t(w), _t(bias)]
    got = P.pw_unproj_packed(*args, F)
    assert got.shape == (B, CI, T, F)
    _close(got.detach(), _to_cf(ref), FWD_TOL)

    g_ref = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=(0, 1, 2))(
        xp, w, bias)
    (got * torch.from_numpy(_to_cf(cot))).sum().backward()
    for a, g, name in zip(args, g_ref, ("x", "w", "bias")):
        _close(a.grad, g, GRAD_TOL, name)


def test_pw_ops_take_strided_weight_views():
    """The Conv dispatch hands K5-K7 views of the torch weights."""
    rng = np.random.default_rng(5)
    weight = torch.from_numpy(_np(rng, C, CI, 1, 1))
    x4 = torch.from_numpy(_np(rng, B, CI, T, F))
    view = weight[:, :, 0, 0].t()
    assert not view.is_contiguous()
    torch.testing.assert_close(P.pw_proj_packed(x4, view, None),
                               P.pw_proj_packed(x4, view.contiguous(), None),
                               rtol=0, atol=0)


# ------------------------------------------------------------- K8 / K9


@pytest.mark.parametrize("kind", ["pool", "select"])
def test_spatial_down_packed_matches_jax(kind):
    rng = np.random.default_rng(6)
    if kind == "pool":
        t_in, f_in, t2, f2 = T, F, 6, 3
        maps, jmaps = (P.adaptive_pool_maps(t_in, t2, f_in, f2),
                       JP.adaptive_pool_maps(t_in, t2, f_in, f2))
    else:  # the stride-2 select after a (1, 1)-padded k-4 conv of 15 x 9
        t_in, f_in, t2, f2 = 14, 8, 7, 4
        maps, jmaps = (P.stride2_select_maps(t_in, t2, f_in, f2),
                       JP.stride2_select_maps(t_in, t2, f_in, f2))
    for a, b in zip(maps, jmaps):  # the port's copies of the builders
        np.testing.assert_array_equal(a, b)
    xp = _np(rng, B, t_in, f_in * C)
    cot = _np(rng, B, t2, f2, C)
    hm = [JP._hashable(a) for a in jmaps]

    def jfn(x):
        return JP.spatial_down_packed(x, *hm, f2, C, True)

    ref = jfn(xp)
    x = _t(xp)
    got = P.spatial_down_packed(x, P.SpatialMap(*maps), C)
    assert got.shape == (B, C, t2, f2)
    _close(got.detach(), _to_cf(ref), FWD_TOL)

    g_ref = jax.grad(lambda x: jnp.sum(jfn(x) * cot))(xp)
    (got * torch.from_numpy(_to_cf(cot))).sum().backward()
    _close(x.grad, g_ref, GRAD_TOL)


def test_spatial_up_packed_matches_jax():
    rng = np.random.default_rng(7)
    t2, f2 = 6, 3
    maps = P.nearest_up_maps(t2, T, f2, F)
    jmaps = JP.nearest_up_maps(t2, T, f2, F)
    for a, b in zip(maps, jmaps):
        np.testing.assert_array_equal(a, b)
    x4 = _np(rng, B, t2, f2, C)
    cot = _np(rng, B, T, F * C)
    hm = [JP._hashable(a) for a in jmaps]

    def jfn(x):
        return JP.spatial_up_packed(x, *hm, F, True)

    ref = jfn(x4)
    x = _t(_to_cf(x4))
    got = P.spatial_up_packed(x, P.SpatialMap(*maps))
    assert got.shape == ref.shape == (B, T, F * C)
    # nearest: every output is one input times 1, exactly
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))

    g_ref = jax.grad(lambda x: jnp.sum(jfn(x) * cot))(x4)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, _to_cf(g_ref), GRAD_TOL)


def test_spatial_map_compact_t_side_equals_dense_rows():
    smap = P.cached_map("pool", 251, 125, 129, 64)
    ts, tw = smap.compact_t()
    dense = np.zeros_like(smap.m)
    for o in range(smap.t_out):
        np.add.at(dense[o], ts[o], tw[o])
    np.testing.assert_array_equal(dense, smap.m)
    assert ts.shape == (125, 3)  # ragged buckets of 251 -> 125
    assert P.cached_map("pool", 251, 125, 129, 64) is smap


# ------------------------------------------------------------- gLN, layout


def test_gln_packed_and_layout_match_jax():
    rng = np.random.default_rng(8)
    x4 = _np(rng, B, T, F, C)
    gamma, beta = _np(rng, C), _np(rng, C)
    xp = x4.reshape(B, T, F * C)
    ref = JP.gln_packed(jnp.asarray(xp), gamma, beta, F=F)
    got = P.gln_packed(torch.from_numpy(xp), torch.from_numpy(gamma),
                       torch.from_numpy(beta), F)
    _close(got, ref, FWD_TOL)
    x_cf = torch.from_numpy(_to_cf(x4))
    np.testing.assert_array_equal(P.pack_tf(x_cf).numpy(), xp)
    np.testing.assert_array_equal(
        P.unpack_tf(torch.from_numpy(xp), F, C).numpy(), _to_cf(x4))
    # the module on a PackedTF equals the module on the rank-4 map
    mod = L.GlobalLayerNorm(C)
    with torch.no_grad():
        mod.norm.weight.copy_(torch.from_numpy(gamma))
        mod.norm.bias.copy_(torch.from_numpy(beta))
        packed = mod(P.PackedTF(torch.from_numpy(xp), F, C))
        torch.testing.assert_close(packed.unpack(), mod(x_cf), rtol=0,
                                   atol=FWD_TOL)
    assert packed.shape == x_cf.shape


def test_packed_dispatch_raises_where_jax_has_no_lowering():
    xp = P.PackedTF(torch.zeros(1, 5, 3 * 4), 3, 4)
    with pytest.raises(NotImplementedError, match="LayerNormalization4D"):
        L.ConvNormAct(4, 4, -1, norm_type="LN4d", is2d=True)(xp)
    with pytest.raises(NotImplementedError, match="Softmax"):
        L.ConvNormAct(4, 4, -1, act_type="Softmax", is2d=True)(xp)
    with pytest.raises(NotImplementedError, match="no packed lowering"):
        L.Conv(4, 8, 3, nd=2)(xp)  # a dense 3x3 conv
    with pytest.raises(NotImplementedError, match="dilation"):
        L.Conv(4, 4, 3, groups=4, dilation=2, nd=2)(xp)
    with pytest.raises(TypeError):
        xp + torch.zeros(1, 4, 5, 3)  # a rank-4 tensor is not packed


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def packed_pair():
    conf = jax_load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    jmodel = jax_build_avnet(conf)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 3968)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    # the JAX variables of a seeded model, without a JAX init (its jit
    # costs ~15 s): convert_avnet is exact (test_torch_avnet.py)
    seeded = build_avnet(conf, device="cpu", seed=0)
    variables = convert_avnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        conf["audionet"])

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    ref = np.asarray(jax.jit(dataclasses.replace(jmodel, packed_tf=True).apply)(
        variables, wav, mouth))
    pconf = dict(conf, audionet=dict(conf["audionet"], packed_tf=True))
    port = load_jax_params(build_avnet(pconf, device="cpu"), variables)
    assert port.packed_tf
    return conf, variables, port, wav, mouth, ref


def test_packed_avnet_matches_jax_packed(packed_pair):
    _, _, port, wav, mouth, ref = packed_pair
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mouth)).numpy()
    assert got.shape == ref.shape == (2, 1, 3968)
    # f32 through ~100 layers summing in another order, as the standard
    # path's test_torch_avnet.py
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-4 * scale, (np.abs(got - ref).max(),
                                                      scale)


def test_packed_avnet_equals_standard_avnet(packed_pair):
    _, _, port, wav, mouth, _ = packed_pair
    x, m = torch.from_numpy(wav), torch.from_numpy(mouth)
    with torch.no_grad():
        packed = port(x, m)
        port.packed_tf = False
        try:
            std = port(x, m)
        finally:
            port.packed_tf = True
    scale = std.abs().max().item()
    assert (packed - std).abs().max().item() < 1e-5 * scale


def test_packed_model_state_dict_and_carry_over_unchanged(packed_pair):
    """Packing is a layout choice: the same parameters under the same names,
    filled by load_jax_params and read back by convert_avnet as before."""
    conf, variables, port, _, _, _ = packed_pair
    std = build_avnet(conf, device="cpu", seed=3)
    pconf = dict(conf, audionet=dict(conf["audionet"], packed_tf=True))
    packed = build_avnet(pconf, device="cpu", seed=3)
    assert packed.packed_tf and not std.packed_tf
    for (k, a), (k2, b) in zip(std.state_dict().items(),
                               packed.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    back = convert_avnet({k: v.numpy() for k, v in port.state_dict().items()},
                         conf["audionet"])
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_chip_smoke_packed_launches_match_a_forward(packed_pair, monkeypatch):
    """chip_smoke.py expects, per packed forward, the launches its
    ``packed_launches`` derives from the preset: the op calls a forward
    makes, each of which launches its kernel once on the card."""
    import chip_smoke

    conf, _, port, wav, mouth, _ = packed_pair
    calls = {}
    ops = {"dw_conv_packed": "dw_conv_packed_fwd",
           "pw_proj_packed": "pw_proj_packed_fwd",
           "pw_unproj_packed": "pw_unproj_packed_fwd",
           "spatial_down_packed": "spatial_down_packed_fwd",
           "spatial_up_packed": "spatial_up_packed_fwd"}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[ops[name]] = calls.get(ops[name], 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ops:
        monkeypatch.setattr(P, name, counted(name, getattr(P, name)))
    with torch.no_grad():
        port(torch.from_numpy(wav), torch.from_numpy(mouth))
    assert calls == chip_smoke.packed_launches(conf)
    assert chip_smoke.packed_launches(load_config(PRESET)) == {
        "dw_conv_packed_fwd": 16, "pw_proj_packed_fwd": 4,
        "pw_unproj_packed_fwd": 4, "spatial_down_packed_fwd": 8,
        "spatial_up_packed_fwd": 16}


def test_build_avnet_still_refuses_batch_fold_and_bf16():
    """batch_fold is not ported and still raises, packed or not; bf16 with
    packed_tf, refused while K5-K9 took float32 only, now builds the packed
    bf16 model (K5-K9's bf16 entries), its parameters bf16."""
    conf = load_config(PRESET)
    for extra in ({"batch_fold": 2}, {"batch_fold": 2, "packed_tf": True}):
        bad = dict(conf, audionet=dict(conf["audionet"], **extra))
        with pytest.raises(NotImplementedError):
            build_avnet(bad, device="cpu")
    both = dict(conf, audionet=dict(conf["audionet"], packed_tf=True,
                                    compute_dtype="bfloat16"))
    model = build_avnet(both, device="cpu")
    assert model.packed_tf and model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
