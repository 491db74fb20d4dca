"""Packed-TF training: the packed backward against ``rtfs_tpu``.

The weight-gradient kernels' plain versions (K5-wgrad, pw-wgrad) against
the JAX functions that reach their Pallas kernels, run in interpret mode
as ``tests/test_packed_tf.py`` runs them, at ``tests/test_torch_packed_tf.
py``'s ragged shapes; the transposed spatial maps against JAX's
``_transpose_fmap`` and ``m.T``; the autograd Functions on the CPU; the
gradient of the port's packed AVNet against ``jax.grad`` of ``rtfs_tpu``'s
``AVNet(packed_tf=True)``; one packed ``AVSystem.train_step`` of
``tests/test_train.py``'s micro AVNet against the standard one; and
``chip_smoke.py``'s launch counts per packed train step against the op
calls of one step. On the CPU every op runs its plain
version, forward and backward, so these tests exercise the backward's
composition (flipped taps, complementary pads, transposed maps, ``w.t()``).

Tolerances: the wgrad reductions (a few hundred products summed in another
order) to 1e-4; the maps exactly; the model's gradients to 2e-4 of the
largest gradient (``tests/test_packed_tf.py``'s own bound for packed
against standard); the train step, packed against standard in the port,
to 1e-5 of each quantity's scale.
"""

import copy
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
from rtfs_tpu_torch.ops import packed_tf as P
from rtfs_tpu_torch.train import AVSystem, make_optimizer
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_train import MICRO_AUDIONET

B, T, F, C = 2, 13, 7, 4
CI = 6
WGRAD_TOL = 1e-4
MODEL_GRAD_REL = 2e-4
STEP_REL = 1e-5
PRESET = "lrs2_RTFSNet_4_layer"
SAMPLES = 3968


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_cf(a):
    """JAX rank-4 (B, T, F, C) -> the port's (B, C, T, F)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------- (a) wgrads


@pytest.mark.parametrize("kt,kf,pads_t,pads_f", [
    (4, 4, (1, 2), (1, 2)),  # torch 'same' for k 4
    (4, 4, (1, 1), (1, 1)),  # the stride-2 conv's stride-1 pass
    (5, 5, (2, 2), (2, 2)),
    (3, 3, (1, 1), (1, 1)),
])
def test_dw_wgrad_plain_matches_jax_kernel(kt, kf, pads_t, pads_f):
    rng = np.random.default_rng(20)
    t_out, f_out = P.dw_geometry(T, F, kt, kf, pads_t, pads_f)
    xp, g = _np(rng, B, T, F * C), _np(rng, B, t_out, f_out * C)
    acc = JP._dw_conv_wgrad_impl(jnp.asarray(xp), jnp.asarray(g), kt=kt,
                                 kf=kf, pf_lo=pads_f[0], pt_lo=pads_t[0],
                                 c=C, interpret=True)
    want = np.asarray(acc).reshape(kt, kf, f_out, C).sum(axis=2)
    got = P.dw_conv_packed_wgrad(torch.from_numpy(xp), torch.from_numpy(g),
                                 F, C, (kt, kf), pads_t, pads_f)
    assert got.shape == (kt, kf, C)
    _close(got, want, WGRAD_TOL)


def test_pw_wgrad_plain_matches_jax_kernel_both_layouts():
    rng = np.random.default_rng(21)
    x4, gp = _np(rng, B, T, F, CI), _np(rng, B, T, F * C)
    # K6's dW: rank-4 x, packed g
    want = JP._pw_wgrad_impl(jnp.asarray(x4), jnp.asarray(gp), True)
    got = P.pw_packed_wgrad(torch.from_numpy(_to_cf(x4)),
                            torch.from_numpy(gp))
    assert got.shape == (CI, C)
    _close(got, want, WGRAD_TOL, "rank-4 a")
    # K7's dW: packed x, rank-4 g; JAX takes it as (g, x) and transposes
    xp, g4 = _np(rng, B, T, F * C), _np(rng, B, T, F, CI)
    want = np.asarray(JP._pw_wgrad_impl(jnp.asarray(g4), jnp.asarray(xp),
                                        True)).T
    got = P.pw_packed_wgrad(torch.from_numpy(xp),
                            torch.from_numpy(_to_cf(g4)))
    assert got.shape == (C, CI)
    _close(got, want, WGRAD_TOL, "packed a")


# ------------------------------------------------------------- (b) maps


@pytest.mark.parametrize("kind,geometry", [
    ("pool", (T, 6, F, 3)),
    ("pool", (251, 125, 129, 64)),   # the serving pool: overlapping buckets
    ("select", (250, 125, 128, 64)),
    ("nearest", (125, 251, 64, 129)),
])
def test_transposed_maps_match_jax(kind, geometry):
    smap = P.cached_map(kind, *geometry)
    f_in = geometry[2]
    tr = smap.transposed(f_in)
    assert smap.transposed(f_in) is tr  # built once
    np.testing.assert_array_equal(tr.m, smap.m.T)
    tfs, tfw = JP._transpose_fmap(smap.fs, smap.fw, f_in)
    np.testing.assert_array_equal(tr.fs, tfs)
    np.testing.assert_array_equal(tr.fw, tfw)
    if kind == "pool" and f_in == 129:
        # every input column of 129 -> 64 feeds one or two buckets
        assert tr.fs.shape == (129, 2) and (tr.fw[:, 1] != 0).any()
        assert tr.compact_t()[0].shape[1] == 2


def test_pool_transpose_is_its_vjp_at_serving_size():
    """K9 through the transposed 251 x 129 -> 125 x 64 pool map equals
    autograd through the pool (several sources per row on both sides)."""
    rng = np.random.default_rng(22)
    smap = P.cached_map("pool", 251, 125, 129, 64)
    xp = torch.from_numpy(_np(rng, 1, 251, 129 * 3)).requires_grad_()
    g = torch.from_numpy(_np(rng, 1, 3, 125, 64))
    (P.spatial_down_packed_plain(xp, smap, 3) * g).sum().backward()
    got = P.spatial_up_packed_plain(g, smap.transposed(129))
    torch.testing.assert_close(got, xp.grad, atol=1e-6, rtol=0)


# ------------------------------------------------------------- (c) Functions


def _packed_ops(rng, grad=True):
    """Each packed op on small CPU inputs: (name, Function, output)."""
    def t(*shape):
        return torch.from_numpy(_np(rng, *shape)).requires_grad_(grad)

    pool = P.cached_map("pool", T, 6, F, 3)
    up = P.cached_map("nearest", 6, T, 3, F)
    return [
        ("dw_conv_packed", P._DwConv,
         P.dw_conv_packed(t(B, T, F * C), t(4, 4, C), t(C), F, C, (1, 2),
                          (1, 2))),
        ("pw_proj_packed", P._PwProj,
         P.pw_proj_packed(t(B, CI, T, F), t(CI, C), t(C))),
        ("pw_unproj_packed", P._PwUnproj,
         P.pw_unproj_packed(t(B, T, F * C), t(C, CI), t(CI), F)),
        ("spatial_down_packed", P._SpatialDown,
         P.spatial_down_packed(t(B, T, F * C), pool, C)),
        ("spatial_up_packed", P._SpatialUp,
         P.spatial_up_packed(t(B, C, 6, 3), up)),
    ]


def test_packed_ops_record_their_functions_on_the_cpu():
    """With requires_grad every packed op's output comes from its autograd
    Function (so ``tests/test_torch_packed_tf.py``'s gradient checks hold
    the Functions' backward against jax.grad); without it, or under
    no_grad, the op records nothing."""
    rng = np.random.default_rng(23)
    for name, fn, out in _packed_ops(rng):
        assert isinstance(out.grad_fn, fn._backward_cls), name
    for name, _, out in _packed_ops(rng, grad=False):
        assert out.grad_fn is None, name
    with torch.no_grad():
        for name, _, out in _packed_ops(rng):
            assert out.grad_fn is None, name


def test_functions_skip_gradients_nobody_needs(monkeypatch):
    """A Function computes no dW when the weight needs none, and no dx when
    the input needs none."""
    rng = np.random.default_rng(24)

    def refuse(*args, **kwargs):
        raise AssertionError("computed a gradient nobody needs")

    monkeypatch.setattr(P, "dw_conv_packed_wgrad", refuse)
    monkeypatch.setattr(P, "pw_packed_wgrad", refuse)
    x = torch.from_numpy(_np(rng, B, T, F * C)).requires_grad_()
    w = torch.from_numpy(_np(rng, 4, 4, C))
    P.dw_conv_packed(x, w, None, F, C, (1, 2), (1, 2)).sum().backward()
    assert x.grad is not None
    x4 = torch.from_numpy(_np(rng, B, CI, T, F)).requires_grad_()
    P.pw_proj_packed(x4, torch.from_numpy(_np(rng, CI, C)),
                     None).sum().backward()
    assert x4.grad is not None

    monkeypatch.undo()
    monkeypatch.setattr(P, "_unproj_forward", refuse)  # K6's dx
    w = torch.from_numpy(_np(rng, CI, C)).requires_grad_()
    P.pw_proj_packed(torch.from_numpy(_np(rng, B, CI, T, F)), w,
                     None).sum().backward()
    assert w.grad is not None


# ------------------------------------------------------------- (d) the model


def _conf():
    """The preset at its widths, cut in depth and length: repeats 1/1 and an
    STFT of 128 / 64 (65 x 63 bins and frames of 3968 samples, pooled 32 x
    31, whose pool buckets still overlap). The packed Pallas kernels unroll
    the F axis, so in interpret mode jax.grad through them costs ~60 s at
    F 65 and ~200 s at the preset's 129."""
    conf = jax_load_config(PRESET)
    a = conf["audionet"]
    a["audio_params"]["repeats"] = a["video_params"]["repeats"] = 1
    a["enc_dec_params"].update(win=128, hop_length=64)
    a["audio_params"]["layers"]["layer_3"]["n_freqs"] = 32  # the pooled F
    return conf


@pytest.fixture(scope="module")
def packed_grads():
    """jax.grad of rtfs_tpu's AVNet(packed_tf=True) (Pallas in interpret
    mode) at ``_conf()``'s geometry, batch 1, on variables carried over from
    a seeded port model (perturbed as tests/test_torch_packed_tf.py
    does)."""
    conf = _conf()
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((1, SAMPLES)) * 0.1).astype(np.float32)
    mouth = (rng.standard_normal((1, 8, 512)) * 0.5).astype(np.float32)
    tgt = wav[:, None] * 0.5
    seeded = build_avnet(conf, device="cpu", seed=0)
    variables = convert_avnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        conf["audionet"])

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    jmodel = dataclasses.replace(jax_build_avnet(conf), packed_tf=True)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        out = jmodel.apply({"params": params, **rest}, wav, mouth)
        return jnp.mean((out - tgt) ** 2) * 1e3

    value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    return conf, variables, wav, mouth, tgt, float(value), grads


def test_packed_avnet_gradients_match_jax(packed_grads):
    conf, variables, wav, mouth, tgt, want_loss, grads = packed_grads
    pconf = dict(conf, audionet=dict(conf["audionet"], packed_tf=True))
    port = load_jax_params(build_avnet(pconf, device="cpu"), variables).eval()
    out = port(torch.from_numpy(wav), torch.from_numpy(mouth))
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean() * 1e3
    loss.backward()
    assert loss.item() == pytest.approx(want_loss, rel=1e-4)
    rest = {k: v for k, v in variables.items() if k != "params"}
    want = dict(load_jax_params(build_avnet(conf, device="cpu"),
                                {"params": grads, **rest}).named_parameters())
    got = dict(port.named_parameters())
    assert got.keys() == want.keys()
    g_max = max(w.abs().max().item() for w in want.values())
    worst = max((p.grad - want[n]).abs().max().item() for n, p in got.items())
    assert worst < MODEL_GRAD_REL * g_max, (worst, g_max)


# ------------------------------------------------------------- (e) the step


def _no_dropout(conf):
    if isinstance(conf, dict):
        return {k: 0.0 if k == "dropout" else _no_dropout(v)
                for k, v in conf.items()}
    return conf


def _micro(packed, repeats=2):
    """tests/test_train.py's micro AVNet (2-D TDANet blocks of stride 2 and
    kernel 4 with a DualPathRNN and TF attention, STFT 33 x 33 pooled to
    16 x 16, hid 8), dropout 0: every packed op, at a size whose float64
    step stays cheap with the test suite's workers sharing the CPU."""
    a = _no_dropout(copy.deepcopy(MICRO_AUDIONET))
    a["audio_params"]["repeats"] = repeats
    a["packed_tf"] = packed
    return {"audionet": a}


def _step(conf, batch, dtype=torch.float32):
    """One port train step (AdamW as the preset's) on a seed-0 model in
    ``dtype`` with the mouth embedding given directly: (loss, grads,
    parameters after)."""
    model = build_avnet(conf, device="cpu", seed=0)
    model.to(dtype)
    system = AVSystem(model, video_model=torch.nn.Identity(),
                      optimizer=make_optimizer(model.parameters(), "adamw",
                                               lr=1e-3, weight_decay=0.1,
                                               clip_grad_norm=5.0))
    loss = system.train_step(batch, torch.Generator().manual_seed(0))
    return (loss["train_loss"].item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _batch(rng, b):
    mix = (rng.standard_normal((b, 1024)) * 0.1).astype(np.float32)
    return {"mix": mix, "src": mix[:, None] * 0.5,
            "mouth": rng.standard_normal((b, 8, 32)).astype(np.float32)}


def test_packed_train_step_equals_standard():
    """In float64, so that the comparison sees the layouts and not float32
    rounding: in float32 the two orders of summation put the gradients
    of the preset's model 1.3e-5 of the largest apart, and AdamW moves an
    entry whose gradient is rounding noise by about lr either way."""
    batch = _batch(np.random.default_rng(25), 2)
    loss_p, grads_p, params_p = _step(_micro(True), batch, torch.float64)
    loss_s, grads_s, params_s = _step(_micro(False), batch, torch.float64)
    assert loss_p == pytest.approx(loss_s, rel=STEP_REL)
    g_max = max(g.abs().max().item() for g in grads_s.values())
    for n, g in grads_s.items():
        torch.testing.assert_close(grads_p[n], g, atol=STEP_REL * g_max,
                                   rtol=0, msg=n)
    p_max = max(p.abs().max().item() for p in params_s.values())
    for n, p in params_s.items():
        torch.testing.assert_close(params_p[n], p, atol=STEP_REL * p_max,
                                   rtol=0, msg=n)


# ------------------------------------------------------------- (f) launches


def test_chip_smoke_packed_train_launches_match_a_step(monkeypatch):
    """chip_smoke.py expects, per packed train step, the launches its
    ``packed_train_launches`` derives from the preset: the calls one step
    makes to the functions that, on the card, launch one kernel each."""
    import chip_smoke

    conf = _micro(True, repeats=3)
    launchers = {"_dw_forward": "dw_conv_packed_fwd",
                 "dw_conv_packed_wgrad": "dw_conv_packed_wgrad",
                 "_proj_forward": "pw_proj_packed_fwd",
                 "_unproj_forward": "pw_unproj_packed_fwd",
                 "pw_packed_wgrad": "pw_packed_wgrad",
                 "_down_forward": "spatial_down_packed_fwd",
                 "_up_forward": "spatial_up_packed_fwd"}
    calls = {}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[launchers[name]] = calls.get(launchers[name], 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for name in launchers:
        monkeypatch.setattr(P, name, counted(name, getattr(P, name)))
    _step(conf, _batch(np.random.default_rng(26), 1))
    assert calls == chip_smoke.packed_train_launches(conf)
    assert chip_smoke.packed_train_launches(load_config(PRESET)) == {
        "dw_conv_packed_fwd": 32, "dw_conv_packed_wgrad": 16,
        "pw_proj_packed_fwd": 8, "pw_unproj_packed_fwd": 8,
        "pw_packed_wgrad": 8, "spatial_down_packed_fwd": 24,
        "spatial_up_packed_fwd": 24}
