"""The packed bf16 serving slice: K5-K9 and gLN in bf16 storage, K2 at a
wide H, and the packed bf16 AVNet, against rtfs_tpu.

JAX's packed bf16 model is ``replace(model, compute_dtype="bfloat16",
packed_tf=True)`` applied to ``cast_params(variables)`` (``bench.py``'s
``bf16_packed`` row); the port's is ``build_avnet`` with
``audionet.packed_tf: true`` and ``compute_dtype: "bfloat16"``.

Per op: each plain bf16 version of ``rtfs_tpu_torch/ops/packed_tf.py``
(K5-K9, ``gln_packed``) against the JAX op of ``rtfs_tpu/ops/packed_tf.py``
in interpret mode, at ``tests/test_packed_tf.py``'s ragged shapes, on the
same bf16 inputs made from a numpy seed, and K2's plain bf16 version at H
600 (the streamed bf16 kernel's width) against the Pallas op in interpret
mode. The gates are ``tests/test_torch_bf16_ops.py``'s: two bf16 ulps at
every element, |diff| <= 2^-7 max(|ref|, 2^-6), and the port's max error
against the float32 op on the widened values no more than 1.5x JAX's.

The whole model: the preset at audio repeats 2 and video repeats 1, bs 2,
3968 samples, variables from a seeded port model through
``convert_avnet`` (no JAX init), perturbed, then ``cast_params``. JAX runs
with ``RTFS_SRU_BACKEND=interpret`` (its fused SRU stack, as the port's).
Gates as ``tests/test_torch_bf16_avnet.py``'s: max error <= 3e-2 of max,
SI-SNR >= 25 dB, and the port's error against JAX's float32 output no
more than 2x JAX's own bf16 error against it; the port's packed bf16
forward also against its standard bf16 forward on the same weights.

Torch runs on one thread. ~60-90 s alone, most of it the JAX fixture's
jit of the packed bf16 model with the Pallas kernels in interpret mode.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.ops import packed_tf as JP
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu.utils.precision import cast_params as jax_cast_params
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch.config import build_avnet
from rtfs_tpu_torch.models import layers as L
from rtfs_tpu_torch.ops import packed_tf as P
from rtfs_tpu_torch.ops import sru_fused as tfused
from rtfs_tpu_torch.utils.weights import load_jax_params

BF16 = ml_dtypes.bfloat16
B, T, F, C = 2, 13, 7, 4
CI = 6
PRESET = "lrs2_RTFSNet_4_layer"
MAX_ERR_REL = 3e-2
SISNR_DB = 25.0
F32_ERR_FACTOR = 2.0


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


def _cf(a):
    """JAX rank-4 (B, T, F, C) -> the port's (B, C, T, F)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def ulp_gate(got, ref, what):
    """|got - ref| <= 2^-7 max(|ref|, 2^-6) at every element."""
    got, ref = _f32(got), _f32(ref)
    diff = np.abs(got - ref)
    bound = 2.0 ** -7 * np.maximum(np.abs(ref), 2.0 ** -6)
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} elements differ, "
          f"max {diff.max():.3g}")
    assert (diff <= bound).all(), (what, float((diff / bound).max()))


def both_gates(got, ref16, ref32, what):
    """Two bf16 ulps against JAX's bf16 output, and the port's error
    against the float32 op within 1.5x JAX's."""
    ulp_gate(got, ref16, what)
    got, ref16, ref32 = _f32(got), _f32(ref16), _f32(ref32)
    port_err = np.abs(got - ref32).max()
    jax_err = np.abs(ref16 - ref32).max()
    assert port_err <= 1.5 * jax_err + 1e-30, (what, port_err, jax_err)


def _port(t):
    assert t.dtype == torch.bfloat16
    return t.float().numpy()


# ------------------------------------------------------------- K5


@pytest.mark.parametrize("kt,kf,pads_t,pads_f,with_bias", [
    (4, 4, (1, 2), (1, 2), True),   # torch 'same' for k 4 (the RTFS pyramid)
    (4, 4, (1, 1), (1, 1), True),   # the stride-2 conv before its select
    (3, 3, (1, 1), (1, 1), False),
])
def test_dw_conv_packed_bf16_matches_pallas(kt, kf, pads_t, pads_f,
                                            with_bias):
    rng = np.random.default_rng(0)
    xp, txp = _bf(rng, (B, T, F * C))
    w, tw = _bf(rng, (kt, kf, C), 1.0 / kt)
    bias, tbias = _bf(rng, (C,)) if with_bias else (None, None)

    def jfn(*a):
        a = [None if v is None else jnp.asarray(v) for v in a]
        return JP.dw_conv_packed(*a, F, C, pads_t, pads_f, (kt, kf), True)

    ref16 = jfn(xp, w, bias)
    ref32 = jfn(_f32(xp), _f32(w), None if bias is None else _f32(bias))
    assert ref16.dtype == jnp.bfloat16
    got = P.dw_conv_packed(txp, tw, tbias, F, C, pads_t, pads_f)
    both_gates(_port(got), ref16, ref32, "K5")


# ------------------------------------------------------------- K6 / K7


def test_pw_proj_packed_bf16_matches_pallas():
    rng = np.random.default_rng(3)
    x4, _ = _bf(rng, (B, T, F, CI))
    w, tw = _bf(rng, (CI, C), CI ** -0.5)
    bias, tbias = _bf(rng, (C,))
    ref16 = JP.pw_proj_packed(jnp.asarray(x4), jnp.asarray(w),
                              jnp.asarray(bias), True)
    ref32 = JP.pw_proj_packed(jnp.asarray(_f32(x4)), jnp.asarray(_f32(w)),
                              jnp.asarray(_f32(bias)), True)
    tx = torch.from_numpy(_cf(_f32(x4))).to(torch.bfloat16)
    got = P.pw_proj_packed(tx, tw, tbias)
    both_gates(_port(got), ref16, ref32, "K6")


def test_pw_unproj_packed_bf16_matches_pallas():
    rng = np.random.default_rng(4)
    xp, txp = _bf(rng, (B, T, F * C))
    w, tw = _bf(rng, (C, CI), C ** -0.5)
    bias, tbias = _bf(rng, (CI,))
    ref16 = JP.pw_unproj_packed(jnp.asarray(xp), jnp.asarray(w),
                                jnp.asarray(bias), F, True)
    ref32 = JP.pw_unproj_packed(jnp.asarray(_f32(xp)), jnp.asarray(_f32(w)),
                                jnp.asarray(_f32(bias)), F, True)
    got = P.pw_unproj_packed(txp, tw, tbias, F)
    assert got.shape == (B, CI, T, F)
    both_gates(_port(got), _cf(_f32(ref16)), _cf(_f32(ref32)), "K7")


# ------------------------------------------------------------- K8 / K9


@pytest.mark.parametrize("kind", ["pool", "select"])
def test_spatial_down_packed_bf16_matches_pallas(kind):
    rng = np.random.default_rng(6)
    if kind == "pool":
        t_in, f_in, t2, f2 = T, F, 6, 3
        maps = JP.adaptive_pool_maps(t_in, t2, f_in, f2)
    else:  # the stride-2 select after a (1, 1)-padded k-4 conv of 15 x 9
        t_in, f_in, t2, f2 = 14, 8, 7, 4
        maps = JP.stride2_select_maps(t_in, t2, f_in, f2)
    xp, txp = _bf(rng, (B, t_in, f_in * C))
    hm = [JP._hashable(a) for a in maps]
    ref16 = JP.spatial_down_packed(jnp.asarray(xp), *hm, f2, C, True)
    ref32 = JP.spatial_down_packed(jnp.asarray(_f32(xp)), *hm, f2, C, True)
    assert ref16.dtype == jnp.bfloat16
    got = P.spatial_down_packed(txp, P.SpatialMap(*maps), C)
    assert got.shape == (B, C, t2, f2)
    both_gates(_port(got), _cf(_f32(ref16)), _cf(_f32(ref32)), f"K8 {kind}")


def test_spatial_up_packed_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    t2, f2 = 6, 3
    maps = JP.nearest_up_maps(t2, T, f2, F)
    x4, _ = _bf(rng, (B, t2, f2, C))
    hm = [JP._hashable(a) for a in maps]
    ref16 = JP.spatial_up_packed(jnp.asarray(x4), *hm, F, True)
    ref32 = JP.spatial_up_packed(jnp.asarray(_f32(x4)), *hm, F, True)
    assert ref16.dtype == jnp.bfloat16
    tx = torch.from_numpy(_cf(_f32(x4))).to(torch.bfloat16)
    got = P.spatial_up_packed(tx, P.SpatialMap(*maps))
    assert got.shape == (B, T, F * C)
    both_gates(_port(got), ref16, ref32, "K9")


# ------------------------------------------------------------- gLN


def test_gln_packed_bf16_matches_jax():
    """Float32 statistics, the normalised map rounded to bf16, then the
    bf16 affine, as ``rtfs_tpu/ops/packed_tf.py:gln_packed``; on a map
    with an offset (mean 4), where bf16 statistics would miss."""
    rng = np.random.default_rng(8)
    xp = (4 + rng.standard_normal((B, T, F * C))).astype(np.float32).astype(
        BF16)
    txp = torch.from_numpy(_f32(xp)).to(torch.bfloat16)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32).astype(
        BF16)
    tgamma = torch.from_numpy(_f32(gamma)).to(torch.bfloat16)
    beta, tbeta = _bf(rng, (C,), 0.1)
    ref16 = JP.gln_packed(jnp.asarray(xp), jnp.asarray(gamma),
                          jnp.asarray(beta), F=F)
    ref32 = JP.gln_packed(jnp.asarray(_f32(xp)), jnp.asarray(_f32(gamma)),
                          jnp.asarray(_f32(beta)), F=F)
    assert ref16.dtype == jnp.bfloat16
    got = P.gln_packed(txp, tgamma, tbeta, F)
    both_gates(_port(got), ref16, ref32, "gLN")


def test_gln_on_a_packed_bf16_map_agrees_with_the_standard_path():
    """The gLN module on a packed bf16 map and on the same map rank-4 (the
    standard path's float32 statistics): within two bf16 ulps."""
    rng = np.random.default_rng(9)
    _, txp = _bf(rng, (B, T, F * C))
    mod = L.GlobalLayerNorm(C)
    with torch.no_grad():
        mod.norm.weight.copy_(1 + 0.1 * torch.randn(C))
        mod.norm.bias.copy_(0.1 * torch.randn(C))
    mod = mod.to(torch.bfloat16)
    with torch.no_grad():
        packed = mod(P.PackedTF(txp, F, C)).unpack()
        std = mod(P.unpack_tf(txp, F, C))
    ulp_gate(_port(packed), _port(std), "gLN packed vs standard")


# ------------------------------------------------------------- K2 wide


def test_k2_bf16_at_h600_matches_pallas():
    """K2's plain bf16 version at H 600, the width where the card's bf16
    kernel streams its reduction, against the Pallas op in interpret
    mode."""
    rng = np.random.default_rng(10)
    t_len, h, bsz = 5, 600, 3
    x_f, tx_f = _bf(rng, (t_len, h, bsz), 0.5)
    x_r, tx_r = _bf(rng, (t_len, h, bsz), 0.5)
    wt, twt = _bf(rng, (6 * h, 2 * h), (2 * h) ** -0.5)
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    vb = jfused._vb_pack(jnp.asarray(v), jnp.asarray(b))
    ref16 = jfused.sru_hidden_layer(jnp.asarray(x_f), jnp.asarray(x_r),
                                    jnp.asarray(wt), vb, True)
    ref32 = jfused.sru_hidden_layer(
        jnp.asarray(_f32(x_f)), jnp.asarray(_f32(x_r)), jnp.asarray(_f32(wt)),
        vb.astype(jnp.float32), True)
    got = tfused.sru_hidden_layer(tx_f, tx_r, twt, tfused.vb_pack(tv, tb))
    for g, r16, r32, name in zip(got, ref16, ref32, ("h_f", "h_r")):
        assert r16.dtype == jnp.bfloat16
        both_gates(_port(g), r16, r32, f"K2 H 600 {name}")


def test_bf16_packed_ops_refuse_autograd_on_the_cpu():
    """Refused while K5-K9 had no bf16 backward, a recorded bf16 packed op
    now runs its autograd Function on the CPU and its gradients are bf16
    (K5, K6 and K9 here; each against JAX's VJP in
    tests/test_torch_bf16_packed_train.py), none through a float32
    backward; not recorded (serving) it runs as before."""
    rng = np.random.default_rng(11)
    _, xp = _bf(rng, (B, T, F * C))
    _, w = _bf(rng, (4, 4, C))
    _, x4 = _bf(rng, (B, CI, T, F))
    _, wp = _bf(rng, (CI, C))
    _, x4p = _bf(rng, (B, C, 6, 3))
    up = P.cached_map("nearest", 6, T, 3, F)
    for fn, args, grad in (
            (P.dw_conv_packed, (xp, w, None, F, C, (1, 2), (1, 2)), (0, 1)),
            (P.pw_proj_packed, (x4, wp, None), (1,)),
            (P.spatial_up_packed, (x4p, up), (0,))):
        args = [a.clone().requires_grad_() if i in grad else a
                for i, a in enumerate(args)]
        out = fn(*args)
        assert out.dtype == torch.bfloat16 and out.grad_fn is not None
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [args[i] for i in grad])
        assert all(g.dtype == torch.bfloat16
                   and torch.isfinite(g.float()).all() for g in grads)
    with torch.no_grad():  # serving: not recorded, runs
        assert P.spatial_up_packed(x4p, up).dtype == torch.bfloat16


# ------------------------------------------------------------- the model


def sisnr_db(est, ref):
    est = est - est.mean(-1, keepdims=True)
    ref = ref - ref.mean(-1, keepdims=True)
    proj = (est * ref).sum(-1, keepdims=True) / (ref * ref).sum(
        -1, keepdims=True) * ref
    return 10 * np.log10((proj ** 2).sum(-1) / ((est - proj) ** 2).sum(-1))


def _conf16(conf, packed=True):
    return dict(conf, audionet=dict(conf["audionet"], packed_tf=packed,
                                    compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def pair():
    conf = jax_load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    jmodel = jax_build_avnet(conf)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 3968)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    # the JAX variables of a seeded model, without a JAX init:
    # convert_avnet is exact (tests/test_torch_avnet.py)
    seeded = build_avnet(conf, device="cpu", seed=0)
    variables = convert_avnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        conf["audionet"])

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    cast = jax.tree.map(np.asarray, jax_cast_params(variables))
    jpacked16 = dataclasses.replace(jmodel, compute_dtype="bfloat16",
                                    packed_tf=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        ref16 = np.asarray(jax.jit(jpacked16.apply)(cast, wav, mouth))
        # the float32 function (the packed float32 model equals the
        # standard one to 1e-5, tests/test_torch_packed_tf.py)
        ref32 = np.asarray(jax.jit(jmodel.apply)(variables, wav, mouth))
    port = load_jax_params(build_avnet(_conf16(conf), device="cpu"), cast)
    assert port.packed_tf and next(port.parameters()).dtype == torch.bfloat16
    return dict(conf=conf, cast=cast, port=port, wav=wav, mouth=mouth,
                ref16=ref16, ref32=ref32)


def _forward(model, p):
    with torch.no_grad():
        out = model(torch.from_numpy(p["wav"]), torch.from_numpy(p["mouth"]))
    assert out.dtype == torch.float32
    return out.numpy()


def test_packed_bf16_avnet_meets_the_gates_against_jax(pair):
    got = _forward(pair["port"], pair)
    ref16, ref32 = pair["ref16"], pair["ref32"]
    assert got.shape == ref16.shape == (2, 1, 3968)
    err = np.abs(got - ref16).max()
    print(f"max err {err / np.abs(ref16).max():.3g} of max|ref|, SI-SNR "
          f"{sisnr_db(got, ref16).ravel()} dB, error against float32: port "
          f"{np.abs(got - ref32).max():.3g}, jax "
          f"{np.abs(ref16 - ref32).max():.3g}")
    assert err <= MAX_ERR_REL * np.abs(ref16).max(), err
    assert (sisnr_db(got, ref16) >= SISNR_DB).all()
    assert (np.abs(got - ref32).max()
            <= F32_ERR_FACTOR * np.abs(ref16 - ref32).max())


def test_packed_bf16_avnet_agrees_with_the_standard_bf16_forward(pair):
    """The same bf16 weights in the standard layout: the two layouts round
    at other places, so they agree to the whole-model gates, not bits."""
    std = load_jax_params(build_avnet(_conf16(pair["conf"], packed=False),
                                      device="cpu"), pair["cast"])
    assert not std.packed_tf
    packed, standard = _forward(pair["port"], pair), _forward(std, pair)
    err = np.abs(packed - standard).max()
    print(f"packed vs standard bf16: max err "
          f"{err / np.abs(standard).max():.3g} of max, SI-SNR "
          f"{sisnr_db(packed, standard).ravel()} dB")
    assert err <= MAX_ERR_REL * np.abs(standard).max()
    assert (sisnr_db(packed, standard) >= SISNR_DB).all()


def test_packed_bf16_forward_calls_each_entry_as_chip_smoke_counts(
        pair, monkeypatch):
    """A packed bf16 forward reaches K5-K9 and K1-K3 as often as
    ``chip_smoke.packed_bf16_launches`` says their bf16 entries launch on
    the card for this model's repeats, every call with bf16 tensors."""
    import chip_smoke
    from rtfs_tpu_torch.ops import convt_tm

    calls = {}

    def counted(entry, fn):
        def wrap(*args, **kw):
            assert all(a.dtype == torch.bfloat16 for a in args
                       if torch.is_tensor(a)), entry
            calls[entry] = calls.get(entry, 0) + 1
            return fn(*args, **kw)
        return wrap

    for mod, fn, entry in (
            (P, "dw_conv_packed", "dw_conv_packed_fwd_bf16"),
            (P, "pw_proj_packed", "pw_proj_packed_fwd_bf16"),
            (P, "pw_unproj_packed", "pw_unproj_packed_fwd_bf16"),
            (P, "spatial_down_packed", "spatial_down_packed_fwd_bf16"),
            (P, "spatial_up_packed", "spatial_up_packed_fwd_bf16"),
            (tfused, "_k1_forward", "sru_dual_recurrence_fwd_bf16"),
            (tfused, "_k2_forward", "sru_hidden_layer_fwd_bf16"),
            (convt_tm, "_forward", "convt1d_ola_tm_fwd_bf16")):
        monkeypatch.setattr(mod, fn, counted(entry, getattr(mod, fn)))
    _forward(pair["port"], pair)
    assert calls == chip_smoke.packed_bf16_launches(pair["conf"])
