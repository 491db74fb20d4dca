"""The unidirectional model in bf16, serving and training, against rtfs_tpu.

RTFS-Net-4 with both DualPathRNNs unidirectional (``chip_smoke.
UNI_OVERRIDES``) runs every SRU layer through K4 (``ops/sru_pallas.py``);
in bf16 (``audionet.compute_dtype: "bfloat16"``) K4 runs on bf16 storage,
as JAX's ``sru_layer_tpu`` gives U the compute dtype.

- (i) K4 forward and backward: the port's plain bf16 versions (what the
  autograd Function runs on a CPU tensor) against ``rtfs_tpu.ops.
  sru_pallas.sru_recurrence`` in interpret mode and its ``jax.vjp``, on
  the same bf16 inputs, both directions (JAX flips u, xhw and h in memory
  around the call where the port walks t = T-1 .. 0), at the main path's
  L 57 / B 125 and L 118 / B 64 cut in B, with odd B. Gate: two bf16 ulps
  at every element, |d| <= 2^-7 max(|ref|, 2^-6 max|ref|), and each
  side's error against JAX's float32 op on the widened values, the
  port's no more than 1.5x JAX's. d(v, b) is held to JAX's own reduction
  (one bf16 partial a batch column, added in float32 and rounded once):
  at the bs-1 frequency site summing float32 partials instead misses the
  gate by about 4x, and the port's per-column rounding holds it.
- (ii) The unidirectional bf16 AVNet (the preset's widths, audio repeats
  1, video repeats 1, 3968 samples) against JAX's
  ``replace(model, compute_dtype="bfloat16")`` on ``cast_params``'d
  variables with ``RTFS_SRU_BACKEND=interpret``: the weights bit for bit
  through ``load_jax_params`` and ``convert_avnet``, the waveform within
  3e-2 of max and 25 dB SI-SNR (tests/test_torch_bf16_avnet.py's gates),
  K4's bf16 entry reached as often as ``chip_smoke.k4_launches`` says.
- (iii) One micro bf16 train step (tests/test_train.py's micro AVNet with
  its DualPathRNN unidirectional, dropout 0) against rtfs_tpu's
  ``AVSystem`` on the bf16 model, as tests/test_torch_bf16_train.py's
  step: the loss within 2e-2; the gradients by cosine above 0.99 and
  relative L2 below 0.15, and against the port's float32 step within 2x
  JAX bf16's relative L2; the parameters within 2 lr plus one bf16 ulp.
- (iv) The train entry on a micro unidirectional bf16 config: an epoch, a
  resume, the checkpoint's dtypes, and the bundle served by the serving
  entry.

Torch on one thread; JAX kept on the CPU by tests/conftest.py. ~75 s
alone, most of it the JAX jits in interpret mode (the micro step ~30 s).
"""

import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.ops import sru_pallas as jk4
from rtfs_tpu.utils.precision import cast_params as jax_cast_params
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch.config import build_avnet
from rtfs_tpu_torch.ops import sru_pallas as tk4
from rtfs_tpu_torch.ops.sru_fused import scan_direction_bwd
from rtfs_tpu_torch.utils.parser import parse_overrides
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_torch_bf16_train import (_bf, _f32, _gates, _ulp_ratio,
                                   hold_bf16_train_step, jax_bf16_train_step,
                                   run_bf16_train_entry, serve_bundle)
from test_torch_train import _audionet

BF16 = ml_dtypes.bfloat16
PRESET = "lrs2_RTFSNet_4_layer"
SAMPLES = 3968
MAX_ERR_REL = 3e-2
SISNR_DB = 25.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ (i)


def _jax_k4(u, x, v, b, dh, reverse):
    """JAX's K4 and its VJP in interpret mode on numpy inputs, the reverse
    direction as its layers run it (inputs flipped in time, h and the
    gradients flipped back): (h, du, dx, dv, db)."""
    flip = (lambda a: a[::-1]) if reverse else (lambda a: a)
    h, vjp = jax.vjp(lambda u, x, v, b: jk4.sru_recurrence(u, x, v, b, True),
                     *(jnp.asarray(a) for a in (flip(u), flip(x), v, b)))
    du, dx, dv, db = vjp(jnp.asarray(flip(dh)))
    return (flip(np.asarray(h)), flip(np.asarray(du)), flip(np.asarray(dx)),
            np.asarray(dv), np.asarray(db))


# the main path's sites cut in B (bs 1 freq scan L 57 over B 125, time
# scan L 118 over B 64), odd B, both directions; a short one at H 8
@pytest.mark.parametrize("t_len,h,bsz,reverse", [
    (57, 32, 25, False), (57, 32, 25, True), (118, 32, 9, False),
    (118, 32, 9, True), (33, 8, 7, True)])
def test_k4_bf16_matches_pallas_interpret(t_len, h, bsz, reverse):
    rng = np.random.default_rng(t_len + bsz)
    u, tu = _bf(rng, (t_len, 3 * h, bsz))
    x, tx = _bf(rng, (t_len, h, bsz))
    v, tv = _bf(rng, (2, h), 0.3)
    b, tb = _bf(rng, (2, h), 0.1)
    dh, tdh = _bf(rng, (t_len, h, bsz), 0.1)
    ref16 = _jax_k4(u, x, v, b, dh, reverse)
    ref32 = _jax_k4(*(_f32(a) for a in (u, x, v, b, dh)), reverse)
    assert all(r.dtype == BF16 for r in ref16)
    ins = [t.clone().requires_grad_() for t in (tu, tx, tv, tb)]
    out = tk4.sru_recurrence(*ins, reverse=reverse)
    grads = torch.autograd.grad(out, ins, tdh)
    got = (out, *grads)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, r16, r32, name in zip(got, ref16, ref32,
                                 ("h", "du", "dxhw", "dv", "db")):
        _gates(g.detach().float().numpy(), r16, r32, f"K4 {name}")


def test_k4_bf16_dvb_rounds_each_batch_column_as_jax():
    """At the bs-1 frequency site (L 57, B 125): the port's d(v, b), one
    bf16 partial a batch column added in float32 and rounded once, is
    within the gate of JAX's; the same sums from float32 partials are
    not, so the gate tells the two reductions apart."""
    rng = np.random.default_rng(1)
    t_len, h, bsz = 57, 32, 125
    u, tu = _bf(rng, (t_len, 3 * h, bsz))
    x, tx = _bf(rng, (t_len, h, bsz))
    v, tv = _bf(rng, (2, h), 0.3)
    b, tb = _bf(rng, (2, h), 0.1)
    dh, tdh = _bf(rng, (t_len, h, bsz), 0.1)
    ref = np.concatenate(_jax_k4(u, x, v, b, dh, False)[3:])
    vb = torch.cat([tv, tb])
    _, c = tk4.sru_recurrence_plain(tu, tx, vb, with_c=True)
    got = tk4.sru_recurrence_bwd_plain(tu, tx, vb, c, tdh)[2]
    assert got.dtype == torch.bfloat16
    assert _ulp_ratio(got.float().numpy(), ref) <= 1.0
    cols = scan_direction_bwd(*(t.float() for t in (tu, tx, vb, c, tdh)),
                              False, columns=True)[2]
    f32_parts = cols.sum(-1).to(torch.bfloat16).float().numpy()
    assert _ulp_ratio(f32_parts, ref) > 1.0


def test_k4_bf16_forward_keeps_a_float32_carry():
    """h and c are rounded as they are stored, the carry never: the plain
    bf16 forward equals the float32 scan of the widened inputs, rounded
    once (a carry rounded every step drifts from it)."""
    rng = np.random.default_rng(2)
    _, tu = _bf(rng, (40, 24, 5))
    _, tx = _bf(rng, (40, 8, 5))
    _, vb = _bf(rng, (4, 8), 0.3)
    h, c = tk4.sru_recurrence_plain(tu, tx, vb, with_c=True)
    h32, c32 = tk4.sru_recurrence_plain(tu.float(), tx.float(), vb.float(),
                                        with_c=True)
    assert h.dtype == c.dtype == torch.bfloat16
    assert torch.equal(h, h32.to(torch.bfloat16))
    assert torch.equal(c, c32.to(torch.bfloat16))


# ------------------------------------------------------------------ (ii)


def sisnr_db(est, ref):
    est = est - est.mean(-1, keepdims=True)
    ref = ref - ref.mean(-1, keepdims=True)
    proj = (est * ref).sum(-1, keepdims=True) / (ref * ref).sum(
        -1, keepdims=True) * ref
    return 10 * np.log10((proj ** 2).sum(-1) / ((est - proj) ** 2).sum(-1))


def _uni_conf():
    import chip_smoke

    conf = parse_overrides(jax_load_config(PRESET),
                           list(chip_smoke.UNI_OVERRIDES))
    conf["audionet"]["audio_params"]["repeats"] = 1
    conf["audionet"]["video_params"]["repeats"] = 1
    return conf


def _bf16(conf):
    return dict(conf, audionet=dict(conf["audionet"],
                                    compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def pair():
    """JAX's bf16 and float32 unidirectional forwards on variables carried
    over from a seeded port model (perturbed), and the port's bf16 model
    filled with the same ``cast_params`` leaves."""
    conf = _uni_conf()
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, SAMPLES)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    seeded = build_avnet(conf, device="cpu", seed=0)

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, convert_avnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        conf["audionet"]))
    cast = jax.tree.map(np.asarray, jax_cast_params(variables))
    jmodel = jax_build_avnet(conf)
    jmodel16 = dataclasses.replace(jmodel, compute_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        ref16 = np.asarray(jax.jit(jmodel16.apply)(cast, wav, mouth))
        ref32 = np.asarray(jax.jit(jmodel.apply)(variables, wav, mouth))
    port = load_jax_params(build_avnet(_bf16(conf), device="cpu"), cast)
    return dict(conf=conf, cast=cast, port=port, wav=wav, mouth=mouth,
                ref16=ref16, ref32=ref32)


def test_uni_bf16_avnet_meets_the_gates_against_jax(pair, monkeypatch):
    import chip_smoke

    calls = []

    def counted(fn):
        def run(u, xhw, vb, reverse, with_c):
            assert {t.dtype for t in (u, xhw, vb)} == {torch.bfloat16}
            calls.append(reverse)
            return fn(u, xhw, vb, reverse, with_c)
        return run

    monkeypatch.setattr(tk4, "_k4_forward", counted(tk4._k4_forward))
    with torch.no_grad():
        got = pair["port"](torch.from_numpy(pair["wav"]),
                           torch.from_numpy(pair["mouth"]))
    assert len(calls) == chip_smoke.k4_launches(pair["conf"])
    assert got.dtype == torch.float32
    got, ref16, ref32 = got.numpy(), pair["ref16"], pair["ref32"]
    assert got.shape == ref16.shape == (2, 1, SAMPLES)
    err = np.abs(got - ref16).max()
    print(f"max err {err / np.abs(ref16).max():.3g} of max|ref|, SI-SNR "
          f"{sisnr_db(got, ref16).ravel()} dB, error against float32: port "
          f"{np.abs(got - ref32).max():.3g}, jax "
          f"{np.abs(ref16 - ref32).max():.3g}")
    assert err <= MAX_ERR_REL * np.abs(ref16).max(), err
    assert (sisnr_db(got, ref16) >= SISNR_DB).all()


def test_uni_bf16_weights_round_trip_bit_for_bit(pair):
    """The unidirectional SRUs' carried-over JAX variables, rounded by
    ``cast_params``, fill the bf16 port and come back through
    ``convert_avnet`` with the same bits, every leaf."""
    sd = {k: v.float().numpy().astype(BF16)
          if v.dtype == torch.bfloat16 else v.numpy()
          for k, v in pair["port"].state_dict().items()}
    assert {str(v.dtype) for v in pair["port"].state_dict().values()
            if v.is_floating_point()} == {"torch.bfloat16"}
    back = convert_avnet(sd, pair["conf"]["audionet"])
    want = dict(jax.tree_util.tree_leaves_with_path(pair["cast"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    sru = [p for p in want if "SRU_" in jax.tree_util.keystr(p)]
    assert sru  # the unidirectional SRUs' weights are among them
    for path, value in want.items():
        assert value.dtype == np.asarray(got[path]).dtype, path
        np.testing.assert_array_equal(
            np.asarray(got[path]).view(np.uint16), value.view(np.uint16),
            err_msg=str(path))


# ------------------------------------------------------------------ (iii)


def _uni_audionet(dropout):
    a = _audionet(dropout)
    a["audio_params"]["layers"]["layer_1"]["bidirectional"] = False
    return a


@pytest.fixture(scope="module")
def jax_step():
    """rtfs_tpu's AVSystem step on the bf16 unidirectional micro AVNet, K4
    in interpret mode (``jax_bf16_train_step``)."""
    return jax_bf16_train_step(_uni_audionet(0.0))


def test_uni_bf16_train_step_matches_jax(jax_step, monkeypatch):
    r = jax_step
    # JAX: two SRU layers a DualPathRNN call, two repeats of the shared
    # block, K4 forward and backward each, all on bf16 operands
    assert len(r["calls"]) == 8 and set(r["calls"]) == {"bfloat16"}, \
        r["calls"]
    counts = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def run(*args, **kw):
            assert all(t.dtype == torch.bfloat16 for t in args
                       if torch.is_tensor(t))
            counts[key] += 1
            return fn(*args, **kw)
        return run

    def patch():
        monkeypatch.setattr(tk4, "_k4_forward",
                            counted("fwd", tk4._k4_forward))
        monkeypatch.setattr(tk4, "_k4_backward",
                            counted("bwd", tk4._k4_backward))

    hold_bf16_train_step(r, patch)
    assert counts == {"fwd": 4, "bwd": 4}


# ------------------------------------------------------------------ (iv)


def test_uni_bf16_train_entry_checkpoints_resumes_and_serves(
        tmp_path, capsys, monkeypatch):
    """The train entry on a unidirectional bf16 micro config: one epoch,
    then a resume to two, the checkpoint's dtypes
    (``run_bf16_train_entry``); the bundle served by the serving entry
    from the run's conf.json, which keeps the unidirectional layer."""
    exp = run_bf16_train_entry(tmp_path, capsys, monkeypatch,
                               _uni_audionet(0.1), "uni16")
    with open(os.path.join(exp, "conf.json")) as f:
        layer = json.load(f)["audionet"]["audio_params"]["layers"]["layer_1"]
    assert layer["bidirectional"] is False
    est = serve_bundle(tmp_path, exp)
    assert est.shape == (1, 1984) and np.isfinite(est).all()
