"""bf16 training of the port against rtfs_tpu's, on the CPU.

The contract is the JAX bench's ``train_bf16`` row (``bench.py``):
``replace(model, compute_dtype="bfloat16")`` on ``cast_params``'d
variables, the gradients in bf16, and optax's clip and AdamW applied to
the bf16 parameters with bf16 moments, no float32 master copy.

- (i) K1, K2 and K3 backward: the port's plain bf16 versions (what the
  autograd Functions run on a CPU tensor) against ``jax.vjp`` of the
  Pallas ops in interpret mode on the same bf16 inputs, at two bf16 ulps
  per element, |d| <= 2^-7 max(|ref|, 2^-6 max|ref|) (the floor relative
  to the gradient's own scale); K2's dx is a bf16 sum of the two
  directions' dx, each rounded apart as JAX rounds them, so its bound
  takes the sum of the three roundings' magnitudes (the port's terms).
  Each side's error against JAX's float32 VJP on the widened values, the
  port's no more than 1.5x JAX's. Each length crosses a time chunk of
  the Pallas kernels (their chunk carries); every batch is odd.
- (ii) One train step of tests/test_train.py's micro AVNet (two SRU
  layers, so K1 and K2; dropout 0) against ``rtfs_tpu``'s ``AVSystem`` on
  the bf16 model, with ``RTFS_SRU_BACKEND=interpret`` so that its fused
  SRU VJPs run (both sides' calls are counted): the loss within 2e-2
  relative; the gradients as one flat vector by cosine above 0.99 and
  relative L2 below 0.15 (JAX's own bf16 gate, tests/test_sru_fused.py),
  and against the float32 gradients of the same weights within 2x JAX
  bf16's relative L2 (the port's float32 step, which
  tests/test_torch_train.py holds against JAX's); the BatchNorm statistics float32 and within 1e-2 of
  their scale (for a running mean, at least a tenth of the root of its
  running variance); the parameters after the step within 2 lr plus one
  bf16 ulp.
- (iii) The clip and AdamW alone, on identical bf16 gradients and
  parameters: equal to jitted optax (``rtfs_tpu.train.make_optimizer``)
  bit for bit over 3 steps, the clip triggered and not, with a state_dict
  round trip; in float32 within a few float32 ulps of the update and one
  of the value (XLA folds the Adam update's two divisions into one and
  sums the squares in its own order).
- (iv) The train entry on a micro bf16 config: a checkpoint with bf16
  parameters and moments and float32 statistics, a resume, the exported
  bundle served by the serving entry.
- (v) The unidirectional and packed-TF bf16 train systems build (their
  steps are tests/test_torch_bf16_uni.py's and
  tests/test_torch_bf16_packed_train.py's); batch_fold and joint video
  training still raise.

Torch on one thread; JAX kept on the CPU by tests/conftest.py.
"""

import copy
import dataclasses
import functools
import json
import os

import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.models.avnet import AVNet as JAVNet
from rtfs_tpu.ops import convt_tm as jconvt
from rtfs_tpu.ops import sru_fused as jfused
from rtfs_tpu.train import AVSystem as JAVSystem
from rtfs_tpu.train import make_optimizer as jmake_optimizer
from rtfs_tpu.utils.precision import cast_params as jax_cast_params
from rtfs_tpu_torch import inference
from rtfs_tpu_torch.config import build_avnet, load_config
from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
from rtfs_tpu_torch.data.wav import write_wav
from rtfs_tpu_torch.ops import convt_tm as tconvt
from rtfs_tpu_torch.ops import sru_fused as tfused
from rtfs_tpu_torch.train import AVSystem, make_optimizer
from rtfs_tpu_torch.train import main as train_main
from rtfs_tpu_torch.train.checkpoints import CheckpointManager
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_torch_train import MICRO_TRAIN_CONF, _audionet, _TorchMouthEmbed
from test_train import _batch, _MouthEmbed

BF16 = ml_dtypes.bfloat16
LR = 1e-3


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


def grad_ulp_gate(got, ref, what, scale=None) -> None:
    """|got - ref| <= 2^-7 max(|ref|, scale, 2^-6 max|ref|) everywhere."""
    diff = np.abs(got - ref)
    mag = np.abs(ref) if scale is None else np.maximum(np.abs(ref), scale)
    bound = 2.0 ** -7 * np.maximum(mag, 2.0 ** -6 * np.abs(ref).max())
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} elements differ, "
          f"worst {float((diff / bound).max()):.3f} of the bound")
    assert (diff <= bound).all(), (what, float((diff / bound).max()))


def _ulp_ratio(got, ref):
    """The largest |got - ref| / (2^-7 max(|ref|, 2^-6 max|ref|)):
    ``grad_ulp_gate``'s margin, without asserting it."""
    got, ref = _f32(got), _f32(ref)
    bound = 2.0 ** -7 * np.maximum(np.abs(ref), 2.0 ** -6 * np.abs(ref).max())
    return float((np.abs(got - ref) / bound).max())


def _gates(got, ref16, ref32, what, scale=None):
    got, ref16, ref32 = (_f32(a) for a in (got, ref16, ref32))
    grad_ulp_gate(got, ref16, what, scale)
    port_err = np.abs(got - ref32).max()
    jax_err = np.abs(ref16 - ref32).max()
    assert port_err <= 1.5 * jax_err + 1e-30, (what, port_err, jax_err)


def _port_grads(op, args, cots, n_in):
    """Gradients of the port's op (its autograd Function) with respect to
    its first ``n_in`` arguments, for the output cotangents ``cots``."""
    ins = [a.clone().requires_grad_(i < n_in) for i, a in enumerate(args)]
    outs = op(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ins[:n_in], cots)


# ------------------------------------------------------------------ (i)


@pytest.mark.parametrize("t_len,h,bsz", [(jfused.T_CHUNK + 1, 8, 5)])
def test_k1_bf16_backward_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(0)
    u_f, tu_f = _bf(rng, (t_len, 4 * h, bsz))
    u_r, tu_r = _bf(rng, (t_len, 4 * h, bsz))
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    dh = [_bf(rng, (t_len, h, bsz), 0.1) for _ in range(2)]

    def jax_grads(*args):
        def f(u_f, u_r, v, b):
            return jfused.sru_dual_recurrence(u_f, u_r, jfused._vb_pack(v, b),
                                              True)
        _, vjp = jax.vjp(f, *map(jnp.asarray, args))
        dt = args[0].dtype
        return vjp(tuple(jnp.asarray(d[0]).astype(dt) for d in dh))

    ref16 = jax_grads(u_f, u_r, v, b)
    ref32 = jax_grads(*map(_f32, (u_f, u_r, v, b)))
    got = _port_grads(
        lambda u_f, u_r, v, b: tfused.sru_dual_recurrence(
            u_f, u_r, tfused.vb_pack(v, b)),
        (tu_f, tu_r, tv, tb), tuple(d[1] for d in dh), 4)
    for g, r16, r32, name in zip(got, ref16, ref32,
                                 ("du_f", "du_r", "dv", "db")):
        assert g.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
        _gates(g.float().numpy(), r16, r32, f"K1 {name}")


@pytest.mark.parametrize("t_len,h,bsz", [(jfused.T_CHUNK + 9, 8, 7)])
def test_k2_bf16_backward_matches_pallas_interpret(t_len, h, bsz):
    rng = np.random.default_rng(1)
    x_f, tx_f = _bf(rng, (t_len, h, bsz), 0.5)
    x_r, tx_r = _bf(rng, (t_len, h, bsz), 0.5)
    wt, twt = _bf(rng, (6 * h, 2 * h), (2 * h) ** -0.5)
    v, tv = _bf(rng, (2, 2, h), 0.3)
    b, tb = _bf(rng, (2, 2, h), 0.1)
    dh = [_bf(rng, (t_len, h, bsz), 0.1) for _ in range(2)]

    def jax_grads(*args):
        def f(x_f, x_r, wt, v, b):
            return jfused.sru_hidden_layer(x_f, x_r, wt,
                                           jfused._vb_pack(v, b), True)
        _, vjp = jax.vjp(f, *map(jnp.asarray, args))
        dt = args[0].dtype
        return vjp(tuple(jnp.asarray(d[0]).astype(dt) for d in dh))

    ref16 = jax_grads(x_f, x_r, wt, v, b)
    ref32 = jax_grads(*map(_f32, (x_f, x_r, wt, v, b)))
    got = _port_grads(
        lambda x_f, x_r, wt, v, b: tfused.sru_hidden_layer(
            x_f, x_r, wt, tfused.vb_pack(v, b)),
        (tx_f, tx_r, twt, tv, tb), tuple(d[1] for d in dh), 5)
    # dx: the bf16 sum of the two directions' rounded dx (the port's terms,
    # from the forward's c)
    with torch.no_grad():
        c = tfused.sru_hidden_layer_plain(tx_f, tx_r, twt,
                                          tfused.vb_pack(tv, tb), True)[2:]
        dxa, dxb = (t.to(torch.bfloat16).float().abs() for t in
                    tfused.hidden_bwd_terms(tx_f, tx_r, twt,
                                            tfused.vb_pack(tv, tb), *c,
                                            dh[0][1], dh[1][1])[:2])
    scales = [(dxa[:, :h] + dxb[:, :h]).numpy(),
              (dxa[:, h:] + dxb[:, h:]).numpy(), None, None, None]
    for g, r16, r32, sc, name in zip(got, ref16, ref32, scales,
                                     ("dx_f", "dx_r", "dwt", "dv", "db")):
        assert g.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
        if sc is not None:
            sc = sc + np.abs(_f32(r16))
        _gates(g.float().numpy(), r16, r32, f"K2 {name}", sc)


@pytest.mark.parametrize("length,c_in,c_out,bsz,k",
                         [(jfused.T_CHUNK + 9, 64, 64, 5, 8)])
def test_k3_bf16_backward_matches_pallas_interpret(length, c_in, c_out, bsz,
                                                   k):
    rng = np.random.default_rng(2)
    x, tx = _bf(rng, (length, c_in, bsz))
    w, tw = _bf(rng, (k, c_out, c_in), 0.1)
    g, tg = _bf(rng, (length + k - 1, c_out, bsz), 0.1)

    def jax_grads(x, w):
        _, vjp = jax.vjp(lambda x, w: jconvt.convt1d_ola_tm(x, w, True),
                         jnp.asarray(x), jnp.asarray(w))
        return vjp(jnp.asarray(g).astype(x.dtype))

    ref16 = jax_grads(x, w)
    ref32 = jax_grads(_f32(x), _f32(w))
    got = _port_grads(tconvt.convt1d_ola_tm, (tx, tw), (tg,), 2)
    for gr, r16, r32, name in zip(got, ref16, ref32, ("dx", "dw")):
        assert gr.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
        _gates(gr.float().numpy(), r16, r32, f"K3 {name}")


# ------------------------------------------------------------------ (ii)


def _pallas_calls(jaxpr) -> list:
    """The dtypes of the first operand of every ``pallas_call`` in a
    closed jaxpr, its sub-jaxprs included."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(str(eqn.invars[0].aval.dtype))
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    return found


def _np32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _draw_variables(shapes, seed=0):
    """Variables on the shapes of a flax init, drawn from a numpy seed:
    kernels N(0, 1 / fan_in), scales about 1, running variances in [0.5,
    1.5], every other leaf N(0, 0.05^2). (A jit of the micro AVNet's init
    takes ~11 s on a CPU; its shapes alone take ~1 s.)"""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        shape = leaf.shape
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            x = 1 + 0.05 * rng.standard_normal(shape)
        else:
            x = 0.05 * rng.standard_normal(shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(a, params, stats, bf16=False):
    a = dict(a, compute_dtype="bfloat16") if bf16 else a
    return load_jax_params(build_avnet({"audionet": a}, device="cpu"),
                           {"params": params, "batch_stats": stats})


def jax_bf16_train_step(a):
    """rtfs_tpu's AVSystem step on the bf16 model of the audionet group
    ``a`` (``cast_params`` variables, ``optimizer.init`` of the bf16
    parameters), with the SRU and packed Pallas kernels in interpret mode:
    its loss, clipped gradients, new statistics and parameters after the
    step, and the first operand's dtype of each ``pallas_call``. The step
    is ``AVSystem.train_step_fn``'s own composition (its ``_forward_loss``
    under ``value_and_grad``, the optimizer's update,
    ``optax.apply_updates``), written out so that the gradients are
    returned too. XLA compiles it at backend optimisation level 0 without
    LLVM's expensive passes, which saves seconds of compile time; every
    operation keeps its dtype either way."""
    model, video = JAVNet(**a), _MouthEmbed()
    model16 = dataclasses.replace(model, compute_dtype="bfloat16")
    optimizer = jmake_optimizer("adamw", lr=LR, weight_decay=0.1)
    batch = _batch()
    variables = _draw_variables(jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0)}, batch["mix"],
        video.apply({}, batch["mouth"])))
    cast = jax_cast_params(variables)
    vvars = video.init(None, batch["mouth"])
    rng = jax.random.PRNGKey(1)
    system = JAVSystem(model16, video_model=video, optimizer=optimizer,
                       donate_state=False)

    def run(variables, opt_state):
        params = variables["params"]
        (loss, (new_stats, _)), grads = jax.value_and_grad(
            lambda p: system._forward_loss(
                p, variables["batch_stats"], vvars, batch, rng, train=True),
            has_aux=True)(params)
        updates, _ = optimizer.update(grads, opt_state, params)
        clipped, _ = optax.clip_by_global_norm(5.0).update(grads, None)
        return (loss, clipped, new_stats,
                optax.apply_updates(params, updates))

    opt_state = optimizer.init(cast["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        traced = jax.jit(run).trace(cast, opt_state)
        calls = _pallas_calls(traced.jaxpr)
        loss, clipped, new_stats, params2 = traced.lower().compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})(
                cast, opt_state)
    return dict(a=a, batch=batch, cast=cast, loss=float(loss),
                grads=clipped, new_stats=new_stats, params2=params2,
                calls=calls)


@pytest.fixture(scope="module")
def jax_bf16_step():
    """JAX's bf16 step of the micro AVNet (``jax_bf16_train_step``)."""
    return jax_bf16_train_step(_audionet(0.0))


def _flat(ts):
    return torch.cat([t.detach().reshape(-1).double() for t in ts])


def _cos_rel(a, b):
    return (float(a @ b / (a.norm() * b.norm())),
            float((a - b).norm() / b.norm()))


def hold_bf16_train_step(r, patch=lambda: None):
    """The port's bf16 step on ``r``'s rounded variables (``r`` from
    ``jax_bf16_train_step``) against JAX's: the loss within 2e-2; the
    gradients bf16, as one flat vector by cosine above 0.99 and relative
    L2 below 0.15 (JAX's own bf16 gate, tests/test_sru_fused.py), and
    against the port's float32 step of the same weights (which
    tests/test_torch_train.py holds against JAX's) within 2x JAX bf16's
    relative L2; the parameters after the step within 2 lr plus one bf16
    ulp. ``patch`` runs between the float32 and the bf16 step (to count
    the bf16 step's calls). Returns the bf16 and the float32 model after
    their steps."""
    a = r["a"]
    model32 = _port(a, _np32(r["cast"]["params"]),
                    _np32(r["cast"]["batch_stats"]))
    AVSystem(model32, video_model=_TorchMouthEmbed(),
             optimizer=make_optimizer(model32.parameters(), "adamw", lr=LR,
                                      weight_decay=0.1)).train_step(
        r["batch"], torch.Generator().manual_seed(0))
    patch()
    np_cast = jax.tree.map(np.asarray, r["cast"])
    model = _port(a, np_cast["params"], np_cast["batch_stats"], bf16=True)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    system = AVSystem(model, video_model=_TorchMouthEmbed(),
                      optimizer=make_optimizer(model.parameters(), "adamw",
                                               lr=LR, weight_decay=0.1))
    loss = system.train_step(r["batch"], torch.Generator().manual_seed(0))
    assert loss["train_loss"].dtype == torch.float32
    assert loss["train_loss"].item() == pytest.approx(r["loss"], rel=2e-2)

    names = [n for n, _ in model.named_parameters()]
    got = [p.grad for p in model.parameters()]
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = dict(_port(a, _np32(r["grads"]),
                      np_cast["batch_stats"]).named_parameters())
    g_port, g_jax, g_32 = (_flat(ts) for ts in (
        got, [want[n] for n in names],
        [p.grad for p in model32.parameters()]))
    cos, rel = _cos_rel(g_port, g_jax)
    rel_port32, rel_jax32 = _cos_rel(g_port, g_32)[1], _cos_rel(g_jax, g_32)[1]
    print(f"gradients: cosine {cos:.6f}, relative L2 {rel:.4f}; against "
          f"float32: port {rel_port32:.4f}, jax {rel_jax32:.4f}")
    assert cos > 0.99 and rel < 0.15
    assert rel_port32 <= 2 * rel_jax32
    want_p = dict(_port(a, _np32(r["params2"]),
                        _np32(r["new_stats"])).named_parameters())
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        torch.testing.assert_close(p.detach().float(), want_p[name].detach(),
                                   atol=2 * LR, rtol=2.0 ** -7, msg=name)
    return model, model32


def test_bf16_train_step_matches_jax(jax_bf16_step, monkeypatch):
    r = jax_bf16_step
    a = r["a"]
    # JAX: each DualPathRNN call runs K1 and K2 forward and backward
    # (two repeats of the shared block), all on bf16 operands
    assert len(r["calls"]) == 8 and set(r["calls"]) == {"bfloat16"}, \
        r["calls"]
    counts = {"k1": 0, "k2": 0, "k3": 0}

    def counted(key, fn):
        def run(*args):
            assert all(t.dtype == torch.bfloat16 for t in args)
            counts[key] += 1
            return fn(*args)
        return run

    def patch():
        monkeypatch.setattr(tfused, "_k1_backward",
                            counted("k1", tfused._k1_backward))
        monkeypatch.setattr(tfused, "_k2_backward",
                            counted("k2", tfused._k2_backward))
        monkeypatch.setattr(tconvt, "_backward",
                            counted("k3", tconvt._backward))

    model, model32 = hold_bf16_train_step(r, patch)
    assert counts == {"k1": 2, "k2": 2, "k3": 2}

    # the statistics within 1e-2 of their scale: a running variance's
    # largest value; a running mean's largest value or, where larger, a
    # tenth of its layer's input scale, the root of the largest running
    # variance (after one step it holds a tenth of a batch mean, which
    # bf16 inputs move by their own rounding whatever the mean's size)
    np_cast = jax.tree.map(np.asarray, r["cast"])
    want_s = _port(a, np_cast["params"], _np32(r["new_stats"])).state_dict()
    want32 = model32.state_dict()
    n_stats = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert buf.dtype == torch.float32, name
            err = (buf - want_s[name]).abs().max().item()
            scale = want_s[name].abs().max().item()
            if name.endswith("running_mean"):
                var = want_s[name[:-len("mean")] + "var"].max().item()
                scale = max(scale, 0.1 * var ** 0.5)
            own = (want_s[name] - want32[name]).abs().max().item()
            print(f"{name}: {err:.3e} of scale {scale:.3e}; JAX bf16 from "
                  f"the float32 step's {own:.3e}")
            assert err <= 1e-2 * scale, name
            n_stats += 1
    assert n_stats > 0


# ------------------------------------------------------------------ (iii)

SHAPES = ((64, 33), (17,), (300, 7))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale", [0.01, 1.0])  # clip not triggered / is
def test_clip_and_adamw_equal_jitted_optax(dtype, scale):
    rng = np.random.default_rng(0)
    jd = jnp.dtype(dtype)
    p0 = [jnp.asarray(rng.standard_normal(s), jd) for s in SHAPES]
    steps = [[jnp.asarray(rng.standard_normal(s) * scale, jd) for s in SHAPES]
             for _ in range(3)]
    norm = np.sqrt(sum(float(jnp.sum(g.astype(jnp.float32) ** 2))
                       for g in steps[0]))
    assert (norm > 5.0) == (scale == 1.0)

    opt = jmake_optimizer("adamw", lr=LR, weight_decay=0.1)
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    jparams, state = p0, opt.init(p0)
    torch_dt = getattr(torch, dtype)
    params = [torch.nn.Parameter(torch.tensor(_f32(p), dtype=torch_dt))
              for p in p0]
    topt = make_optimizer(params, "adamw", lr=LR, weight_decay=0.1)
    for i, grads in enumerate(steps):
        updates, state = update(grads, state, jparams)
        jparams = apply(jparams, updates)
        if i == 2:  # a resume between steps: the state round-trips
            saved = topt.state_dict()
            topt = make_optimizer(params, "adamw", lr=LR, weight_decay=0.1)
            topt.load_state_dict(saved)
        for p, g in zip(params, grads):
            p.grad = torch.tensor(_f32(g), dtype=torch_dt)
        topt.step()
        topt.zero_grad()
        moments = state[1].inner_state[0]
        for k, (p, jp) in enumerate(zip(params, jparams)):
            got, want = p.detach().float().numpy(), _f32(jp)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, want, f"step {i} {k}")
                for mine, theirs in ((topt.mu[k], moments.mu[k]),
                                     (topt.nu[k], moments.nu[k])):
                    assert mine.dtype == torch.bfloat16
                    np.testing.assert_array_equal(mine.float().numpy(),
                                                  _f32(theirs))
            else:  # a few float32 ulps of the update, one of the value
                np.testing.assert_allclose(got, want, rtol=2.0 ** -22,
                                           atol=LR * 2.0 ** -18)


# ------------------------------------------------------------------ (iv)


def run_bf16_train_entry(tmp_path, capsys, monkeypatch, a, name):
    """The train entry on the micro bf16 config of the audionet group
    ``a`` (the real lip backbone, synthetic data cut to 64 ms and 4 mouth
    crops of 16 x 16): one epoch, then a resume to two; the checkpoint
    holds bf16 parameters and moments and float32 BatchNorm statistics.
    Returns the run's directory."""
    monkeypatch.setattr(train_main, "SyntheticAVDataset", functools.partial(
        SyntheticAVDataset, segment=0.064, video_frames=4, mouth_size=16))
    a = dict(a, pretrained_vout_chan=512, compute_dtype="bfloat16")
    conf = {**copy.deepcopy(MICRO_TRAIN_CONF), "audionet": a,
            "log": {"path": str(tmp_path), "exp_name": name}}
    conf["data"]["sample_rate"] = 16000
    path = os.path.join(tmp_path, f"{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    row = train_main.cli(["--conf-dir", path, "--device", "cpu"])
    assert row["epoch"] == 0 and np.isfinite(row["val_loss"])
    row = train_main.cli(["--conf-dir", path, "--device", "cpu",
                          "--training.epochs", "2"])
    assert "resumed from epoch 0" in capsys.readouterr().out
    assert row["epoch"] == 1 and np.isfinite(row["train_loss"])
    exp = os.path.join(tmp_path, name)
    state = CheckpointManager(exp).restore()
    assert state["step"] == 4
    for key, v in state["model"].items():
        if v.is_floating_point():
            stat = key.endswith(("running_mean", "running_var"))
            assert v.dtype == (torch.float32 if stat else torch.bfloat16), key
    assert {m.dtype for m in state["optimizer"]["mu"]} == {torch.bfloat16}
    with open(os.path.join(exp, "conf.json")) as f:
        assert json.load(f)["audionet"]["compute_dtype"] == "bfloat16"
    return exp


def serve_bundle(tmp_path, exp):
    """The serving entry on a run's conf.json and bundle, on the CPU, with
    a 1984-sample wav and 4 mouth frames: the estimate."""
    rng = np.random.default_rng(0)
    write_wav(str(tmp_path / "mix.wav"),
              (rng.standard_normal(1984) * 0.1).astype(np.float32), 16000)
    np.savez(tmp_path / "mouth.npz",
             data=rng.integers(0, 256, (4, 96, 96), dtype=np.uint8))
    return inference.main(["--conf-dir", os.path.join(exp, "conf.json"),
                           "--wav", str(tmp_path / "mix.wav"),
                           "--mouth", str(tmp_path / "mouth.npz"),
                           "--out-dir", str(tmp_path / "out"), "--cpu"])


def test_bf16_train_entry_checkpoints_resumes_and_serves(tmp_path, capsys,
                                                         monkeypatch):
    """The train entry on a bf16 micro config (the micro AVNet with the
    real lip backbone): one epoch, then a resume to two, the checkpoint's
    dtypes (``run_bf16_train_entry``); the exported bundle serves through
    the serving entry from the run's conf.json."""
    exp = run_bf16_train_entry(tmp_path, capsys, monkeypatch,
                               _audionet(0.1), "micro16")
    est = serve_bundle(tmp_path, exp)
    assert est.shape == (1, 1984) and np.isfinite(est).all()


# ------------------------------------------------------------------ (v)


@pytest.mark.parametrize("case", ["unidirectional", "packed_tf"])
def test_bf16_training_still_refuses_k4_and_packed(case):
    """A bf16 config with a unidirectional SRU (K4) or packed-TF, refused
    until K4's and K5-K9's bf16 backwards were ported, now builds its
    train system (``AVSystem`` and the entry's ``build_system``) with bf16
    parameters, its SRU off the fused stack or its model packed; what is
    still not ported raises in the train entry before anything is
    written: batch_fold (with the unidirectional config) and joint video
    training (with the packed one)."""
    from rtfs_tpu_torch.ops.sru import SRU

    conf = load_config("lrs2_RTFSNet_4_layer")
    conf["audionet"].update(compute_dtype="bfloat16")
    conf["audionet"]["audio_params"]["repeats"] = 1
    conf["audionet"]["video_params"]["repeats"] = 1
    if case == "unidirectional":
        for layer in ("layer_1", "layer_2"):
            conf["audionet"]["audio_params"]["layers"][layer][
                "bidirectional"] = False
        bad = dict(conf, audionet=dict(conf["audionet"], batch_fold=2))
    else:
        conf["audionet"]["packed_tf"] = True
        bad = dict(conf, training=dict(conf["training"],
                                       train_video_model=True))
    system = AVSystem(build_avnet(conf, device="cpu"))
    assert {p.dtype for p in system.model.parameters()} == {torch.bfloat16}
    built = train_main.build_system(conf, "cpu")
    sru = [m for m in built.model.modules() if isinstance(m, SRU)]
    if case == "unidirectional":
        assert sru and not any(m.uses_fused_stack for m in sru)
    else:
        assert built.model.packed_tf
    with pytest.raises(NotImplementedError):
        train_main.main(dict(bad, log={"path": "/nonexistent/never",
                                       "exp_name": "x"}), "cpu")
