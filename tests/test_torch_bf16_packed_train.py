"""Packed-TF training in bf16 against rtfs_tpu.

JAX's packed ops take their operands in the caller's dtype, and their
custom VJPs (``rtfs_tpu/ops/packed_tf.py``) run in the cotangent's: each dx
is the bf16 forward kernel on the cotangent (K5 on the flipped taps, K6 and
K7 through each other, K8 and K9 through each other over the transposed
maps), the two wgrad kernels read bf16 and write float32, which is folded
(K5) or transposed (K7) in float32 and rounded once to the weight's dtype,
and a bias's gradient is the cotangent summed in float32, rounded once.

- (i) The wgrads on bf16 operands: the port's plain versions against
  ``_dw_conv_wgrad_impl`` and ``_pw_wgrad_impl`` in interpret mode,
  float32 out, to float32 tolerance (1e-4 of the largest value: the same
  products summed in another order).
- (ii) Every packed autograd Function in bf16 (dx, dW, db) on the CPU
  against ``jax.vjp`` of ``dw_conv_packed``, ``pw_proj_packed``,
  ``pw_unproj_packed``, ``spatial_down_packed`` (pool, whose transposed map
  has two sources a row, and select) and ``spatial_up_packed`` in
  interpret mode, on the same bf16 inputs and cotangents: two bf16 ulps at
  every element, |d| <= 2^-7 max(|ref|, 2^-6 max|ref|), and the port's
  error against JAX's float32 VJP no more than 1.5x JAX's. K8's dx through
  a pool map rounds each source's term and adds the terms in bf16, as JAX
  sums one single-source pass a source: bit for bit at 13 x 7, where
  rounding the float32 sum once misses the gate (held here); at 65
  columns the float32 order of a term's T side flips its rounding now and
  then, so that gate takes the terms' magnitudes, as K2's bf16 dx gate
  does (tests/test_torch_bf16_train.py).
- (iii) One micro bf16 train step of the packed model (tests/test_train.py's
  micro AVNet, whose STFT is already cut to 33 bins, with ``packed_tf``,
  dropout 0) against rtfs_tpu's ``AVSystem`` on the bf16 packed model,
  with the Pallas kernels in interpret mode: the loss within 2e-2; the
  gradients by cosine above 0.99 and relative L2 below 0.15 and against
  the port's float32 step within 2x JAX bf16's relative L2; the
  parameters within 2 lr plus one bf16 ulp; each packed op of the step
  called on bf16 tensors as often as ``chip_smoke.packed_train_launches``
  counts its launches.
- (iv) The train entry on a packed bf16 micro config: an epoch, a resume,
  the checkpoint's dtypes.

Torch on one thread; JAX kept on the CPU by tests/conftest.py. ~85 s
alone, ~55 s of it the jit of the JAX packed step in interpret mode.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.ops import packed_tf as JP
from rtfs_tpu_torch.ops import packed_tf as P
from test_torch_bf16_train import (_bf, _f32, _gates, _ulp_ratio,
                                   hold_bf16_train_step, jax_bf16_train_step,
                                   run_bf16_train_entry)
from test_torch_train import _audionet

B, T, F, C = 2, 13, 7, 4
CI = 6
WGRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cf(a):
    """JAX rank-4 (B, T, F, C) -> the port's (B, C, T, F)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


# ------------------------------------------------------------------ (i)


@pytest.mark.parametrize("kt,kf,pads_t,pads_f", [
    (4, 4, (1, 2), (1, 2)), (4, 4, (1, 1), (1, 1)), (3, 5, (1, 1), (2, 2))])
def test_dw_wgrad_bf16_matches_jax_kernel(kt, kf, pads_t, pads_f):
    rng = np.random.default_rng(30)
    t_out, f_out = P.dw_geometry(T, F, kt, kf, pads_t, pads_f)
    xp, txp = _bf(rng, (B, T, F * C))
    g, tg = _bf(rng, (B, t_out, f_out * C))
    acc = JP._dw_conv_wgrad_impl(jnp.asarray(xp), jnp.asarray(g), kt=kt,
                                 kf=kf, pf_lo=pads_f[0], pt_lo=pads_t[0],
                                 c=C, interpret=True)
    assert acc.dtype == jnp.float32
    want = np.asarray(acc).reshape(kt, kf, f_out, C).sum(axis=2)
    got = P.dw_conv_packed_wgrad(txp, tg, F, C, (kt, kf), pads_t, pads_f)
    assert got.dtype == torch.float32 and got.shape == (kt, kf, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=WGRAD_REL * np.abs(want).max())


def test_pw_wgrad_bf16_matches_jax_kernel_both_layouts():
    rng = np.random.default_rng(31)
    x4, _ = _bf(rng, (B, T, F, CI))
    gp, tgp = _bf(rng, (B, T, F * C))
    want = np.asarray(JP._pw_wgrad_impl(jnp.asarray(x4), jnp.asarray(gp),
                                        True))
    got = P.pw_packed_wgrad(torch.from_numpy(_cf(_f32(x4))).to(
        torch.bfloat16), tgp)
    assert got.dtype == torch.float32 and got.shape == (CI, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=WGRAD_REL * np.abs(want).max())
    xp, txp = _bf(rng, (B, T, F * C))
    g4, _ = _bf(rng, (B, T, F, CI))
    want = np.asarray(JP._pw_wgrad_impl(jnp.asarray(g4), jnp.asarray(xp),
                                        True)).T
    got = P.pw_packed_wgrad(txp, torch.from_numpy(_cf(_f32(g4))).to(
        torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (C, CI)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=WGRAD_REL * np.abs(want).max())


# ------------------------------------------------------------------ (ii)


def _jax_vjp(fn, primals, cot):
    """(output, VJP of every primal) of ``fn`` at numpy primals."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(p) for p in primals))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_grads(fn, primals):
    """The port's output and gradients for a cotangent drawn later:
    returns (output, grad(cot))."""
    ins = [p.clone().requires_grad_() for p in primals]
    out = fn(*ins)
    return out, lambda cot: torch.autograd.grad(out, ins, cot)


def _hold(got, ref16, ref32, names, what):
    assert all(g.dtype == torch.bfloat16 for g in got), what
    for g, r16, r32, n in zip(got, ref16, ref32, names):
        _gates(g.detach().float().numpy(), r16, r32, f"{what} {n}")


@pytest.mark.parametrize("kt,kf,pads_t,pads_f", [
    (4, 4, (1, 2), (1, 2)), (4, 4, (1, 1), (1, 1))])
def test_dw_conv_function_bf16_matches_jax_vjp(kt, kf, pads_t, pads_f):
    rng = np.random.default_rng(32)
    t_out, f_out = P.dw_geometry(T, F, kt, kf, pads_t, pads_f)
    xp, txp = _bf(rng, (B, T, F * C))
    w, tw = _bf(rng, (kt, kf, C), 0.25)
    bias, tbias = _bf(rng, (C,), 0.1)
    cot, tcot = _bf(rng, (B, t_out, f_out * C), 0.1)

    def jfn(xp, w, bias):
        return JP.dw_conv_packed(xp, w, bias, F, C, pads_t, pads_f, (kt, kf),
                                 True)

    _, ref16 = _jax_vjp(jfn, (xp, w, bias), cot)
    _, ref32 = _jax_vjp(jfn, [_f32(a) for a in (xp, w, bias)], _f32(cot))
    out, grad = _port_grads(lambda x, w, b: P.dw_conv_packed(
        x, w, b, F, C, pads_t, pads_f), (txp, tw, tbias))
    assert out.grad_fn.name().startswith("_DwConv")
    _hold(grad(tcot), ref16, ref32, ("dx", "dW", "db"), "K5")


def test_pw_proj_function_bf16_matches_jax_vjp():
    rng = np.random.default_rng(33)
    x4, _ = _bf(rng, (B, T, F, CI))
    w, tw = _bf(rng, (CI, C), CI ** -0.5)
    bias, tbias = _bf(rng, (C,), 0.1)
    cot, tcot = _bf(rng, (B, T, F * C), 0.1)
    jfn = functools.partial(JP.pw_proj_packed, interpret=True)
    _, ref16 = _jax_vjp(jfn, (x4, w, bias), cot)
    _, ref32 = _jax_vjp(jfn, [_f32(a) for a in (x4, w, bias)], _f32(cot))
    tx4 = torch.from_numpy(_cf(_f32(x4))).to(torch.bfloat16)
    _, grad = _port_grads(P.pw_proj_packed, (tx4, tw, tbias))
    dx, dw, db = grad(tcot)
    _hold((dx.permute(0, 2, 3, 1), dw, db), ref16, ref32,
          ("dx", "dW", "db"), "K6")


def test_pw_unproj_function_bf16_matches_jax_vjp():
    rng = np.random.default_rng(34)
    xp, txp = _bf(rng, (B, T, F * C))
    w, tw = _bf(rng, (C, CI), C ** -0.5)
    bias, tbias = _bf(rng, (CI,), 0.1)
    cot, _ = _bf(rng, (B, T, F, CI), 0.1)
    jfn = functools.partial(JP.pw_unproj_packed, F=F, interpret=True)
    _, ref16 = _jax_vjp(jfn, (xp, w, bias), cot)
    _, ref32 = _jax_vjp(jfn, [_f32(a) for a in (xp, w, bias)], _f32(cot))
    _, grad = _port_grads(lambda x, w, b: P.pw_unproj_packed(x, w, b, F),
                          (txp, tw, tbias))
    tcot = torch.from_numpy(_cf(_f32(cot))).to(torch.bfloat16)
    _hold(grad(tcot), ref16, ref32, ("dx", "dW", "db"), "K7")


def _source_terms(cot, tmap):
    """The rounded terms of K9 through a transposed map, one a source, as
    the port's plain bf16 version forms them: (terms, their magnitudes
    summed)."""
    tens = tmap.tensors(cot.device)
    y = torch.einsum("ts,bcsu->btuc", tens["m"], cot.float())
    terms = [(y.index_select(2, tens["fs"][:, i].long())
              * tens["fw"][:, i, None]).to(torch.bfloat16).float()
             for i in range(tens["fs"].shape[1])]
    b, t = y.shape[:2]
    return terms, sum(x.abs() for x in terms).reshape(b, t, -1)


# (kind, T_in, F_in, T2, F2, C): the pool of 7 -> 3 buckets that overlap
# and of 65 -> 32 (F at tests/test_torch_packed_train.py's STFT 128 / 64), whose
# transposed maps have two sources on some rows, and a select
@pytest.mark.parametrize("site", [("pool", T, F, 6, 3, C),
                                  ("pool", 31, 65, 15, 32, 4),
                                  ("select", 14, 8, 7, 4, C)])
def test_spatial_down_function_bf16_matches_jax_vjp(site):
    """K8's dx is K9 through the transposed map. Where a row has several
    sources JAX rounds each source's term to bf16 and adds them in bf16;
    the port does the same, so its dx is JAX's but for the float32 order
    of each term's T side (one ulp of a term at a rounding): the gate
    takes the terms' magnitudes as K2's bf16 dx gate does. At the small
    pool the port's dx is JAX's bit for bit, and the float32 sum rounded
    once misses the plain two-ulp gate there."""
    kind, t_in, f_in, t2, f2, c = site
    rng = np.random.default_rng(35)
    build = (JP.adaptive_pool_maps if kind == "pool"
             else JP.stride2_select_maps)
    maps = build(t_in, t2, f_in, f2)
    smap = P.SpatialMap(*maps)
    tmap = smap.transposed(f_in)
    assert tmap.fs.shape[1] == (2 if kind == "pool" else 1)
    xp, txp = _bf(rng, (1, t_in, f_in * c))
    cot, _ = _bf(rng, (1, t2, f2, c))
    hm = [JP._hashable(a) for a in maps]

    def jfn(x):
        return JP.spatial_down_packed(x, *hm, f2, c, True)

    _, (ref16,) = _jax_vjp(jfn, (xp,), cot)
    _, (ref32,) = _jax_vjp(jfn, (_f32(xp),), _f32(cot))
    _, grad = _port_grads(lambda x: P.spatial_down_packed(x, smap, c),
                          (txp,))
    tcot = torch.from_numpy(_cf(_f32(cot))).to(torch.bfloat16)
    (dx,) = grad(tcot)
    assert dx.dtype == torch.bfloat16
    got = dx.float().numpy()
    _, mag = _source_terms(tcot, tmap)
    ref = _f32(ref16)
    scale = np.maximum(mag.numpy() + np.abs(ref), np.abs(ref))
    bound = 2.0 ** -7 * np.maximum(scale, 2.0 ** -6 * np.abs(ref).max())
    ratio = float((np.abs(got - ref) / bound).max())
    print(f"K8 {kind} {t_in}x{f_in} dx: {int((got != ref).sum())} of "
          f"{got.size} differ, worst {ratio:.3f} of the bound")
    assert ratio <= 1.0
    assert (np.abs(got - _f32(ref32)).max()
            <= 1.5 * np.abs(ref - _f32(ref32)).max() + 1e-30)
    if (kind, t_in) == ("pool", T):
        assert np.array_equal(got, ref)
        once = P.spatial_up_packed_plain(tcot.float(), tmap).to(
            torch.bfloat16).float().numpy()
        assert _ulp_ratio(once, ref) > 1.0


def test_spatial_up_function_bf16_matches_jax_vjp():
    rng = np.random.default_rng(36)
    t2, f2 = 6, 3
    maps = JP.nearest_up_maps(t2, T, f2, F)
    smap = P.SpatialMap(*maps)
    x4, _ = _bf(rng, (B, t2, f2, C))
    cot, tcot = _bf(rng, (B, T, F * C))
    hm = [JP._hashable(a) for a in maps]

    def jfn(x):
        return JP.spatial_up_packed(x, *hm, F, True)

    _, ref16 = _jax_vjp(jfn, (x4,), cot)
    _, ref32 = _jax_vjp(jfn, (_f32(x4),), _f32(cot))
    tx4 = torch.from_numpy(_cf(_f32(x4))).to(torch.bfloat16)
    _, grad = _port_grads(lambda x: P.spatial_up_packed(x, smap), (tx4,))
    (dx,) = grad(tcot)
    _hold((dx.permute(0, 2, 3, 1),), ref16, ref32, ("dx",), "K9")


# ------------------------------------------------------------------ (iii)


def _packed_audionet(dropout):
    """The micro AVNet packed, one repeat of its shared block (the jit of
    JAX's packed step in interpret mode takes ~80 s at two)."""
    a = dict(_audionet(dropout), packed_tf=True)
    a["audio_params"]["repeats"] = 1
    return a


@pytest.fixture(scope="module")
def jax_step():
    """rtfs_tpu's AVSystem step on the bf16 packed micro AVNet, the packed
    and SRU Pallas kernels in interpret mode (``jax_bf16_train_step``)."""
    return jax_bf16_train_step(_packed_audionet(0.0))


# the port's packed wrappers, by the C entry each launches on the card
_PACKED_CALLS = {"_dw_forward": "dw_conv_packed_fwd",
                 "dw_conv_packed_wgrad": "dw_conv_packed_wgrad",
                 "_proj_forward": "pw_proj_packed_fwd",
                 "_unproj_forward": "pw_unproj_packed_fwd",
                 "pw_packed_wgrad": "pw_packed_wgrad",
                 "_down_forward": "spatial_down_packed_fwd",
                 "_up_forward": "spatial_up_packed_fwd"}


def test_packed_bf16_train_step_matches_jax(jax_step, monkeypatch):
    import chip_smoke

    r = jax_step
    # every packed and SRU kernel on bf16 operands but K9's, whose rank-4
    # side JAX widens to float32 (a Mosaic workaround, the same values)
    assert "bfloat16" in r["calls"], r["calls"]
    counts = {}

    def counted(entry, fn):
        def run(*args, **kw):
            assert all(t.dtype == torch.bfloat16 for t in args
                       if torch.is_tensor(t)), entry
            counts[entry] = counts.get(entry, 0) + 1
            return fn(*args, **kw)
        return run

    def patch():
        for fn, entry in _PACKED_CALLS.items():
            monkeypatch.setattr(P, fn, counted(entry, getattr(P, fn)))

    model, _ = hold_bf16_train_step(r, patch)
    assert model.packed_tf
    assert counts == chip_smoke.packed_train_launches({"audionet": r["a"]})


# ------------------------------------------------------------------ (iv)


def test_packed_bf16_train_entry_checkpoints_and_resumes(tmp_path, capsys,
                                                         monkeypatch):
    """The train entry on a packed bf16 micro config: one epoch, then a
    resume to two, the checkpoint's dtypes (``run_bf16_train_entry``);
    the run's conf.json keeps packed_tf."""
    exp = run_bf16_train_entry(tmp_path, capsys, monkeypatch,
                               _packed_audionet(0.1), "packed16")
    with open(os.path.join(exp, "conf.json")) as f:
        assert json.load(f)["audionet"]["packed_tf"]
