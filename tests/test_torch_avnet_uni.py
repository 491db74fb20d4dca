"""The unidirectional slice: RTFS-Net-4 with both DualPathRNNs'
``bidirectional`` set to false, the path through K4 (``ops/sru_pallas.py``).

The preset takes the two overrides as the entries apply them
(``utils/parser.parse_overrides``), its widths as published, repeats cut to
2 (audio) and 1 (video), on ``tests/test_torch_avnet.py``'s tiny geometry:
a 3968-sample waveform and an (8, 512) mouth embedding. rtfs_tpu's AVNet
runs with ``RTFS_SRU_BACKEND=interpret``, so each SRU layer goes through
the Pallas kernel of ``rtfs_tpu/ops/sru_pallas.py`` in interpret mode; the
port runs the kernel's plain versions on the CPU. Variables come from a
seeded port model through ``convert_avnet``, perturbed as in
``tests/test_torch_packed_train.py``.

Tolerances: the waveform to 1e-4 of its scale and the gradients to 2e-4 of
the largest, as the bidirectional and packed models are held.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.models import rnn_blocks as JR
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch.config import build_avnet
from rtfs_tpu_torch.models import rnn_blocks as TR
from rtfs_tpu_torch.ops import sru_pallas
from rtfs_tpu_torch.train import AVSystem, make_optimizer
from rtfs_tpu_torch.utils.parser import parse_overrides
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_train import MICRO_AUDIONET

PRESET = "lrs2_RTFSNet_4_layer"
UNI_OVERRIDES = ("--audionet.audio_params.layers.layer_1.bidirectional",
                 "false",
                 "--audionet.audio_params.layers.layer_2.bidirectional",
                 "false")
SAMPLES = 3968
WAVE_REL = 1e-4
MODEL_GRAD_REL = 2e-4
MODULE_ATOL = 1e-4  # tests/test_torch_modules.py's bound


def _uni_conf(repeats=2):
    conf = parse_overrides(jax_load_config(PRESET), list(UNI_OVERRIDES))
    conf["audionet"]["audio_params"]["repeats"] = repeats
    conf["audionet"]["video_params"]["repeats"] = 1
    return conf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it. The suite runs
    several pytest workers on one machine's cores, and torch's thread pool
    per process then oversubscribes them: with five other test files
    running on an 8-core CPU, the port's forward and backward here took
    76 s on the default pool and 1.5 s on one thread (the plain K4
    versions are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(rng):
    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    return perturb


@pytest.fixture(scope="module")
def uni():
    """``jax.value_and_grad`` of rtfs_tpu's unidirectional AVNet (K4 in
    interpret mode) at batch 2, its output beside the loss, and its
    variables' shapes from ``init`` (abstract)."""
    conf = _uni_conf()
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, SAMPLES)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    tgt = wav[:, None] * 0.5
    seeded = build_avnet(conf, device="cpu", seed=0)
    variables = jax.tree_util.tree_map_with_path(_perturb(rng), convert_avnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        conf["audionet"]))
    jmodel = jax_build_avnet(conf)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        out = jmodel.apply({"params": params, **rest}, wav, mouth)
        return jnp.mean((out - tgt) ** 2) * 1e3, out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTFS_SRU_BACKEND", "interpret")
        shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                                wav, mouth)
        (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    return dict(conf=conf, variables=variables, shapes=shapes, wav=wav,
                mouth=mouth, tgt=tgt, loss=float(value), out=np.asarray(out),
                grads=grads)


def _port(uni):
    return load_jax_params(build_avnet(uni["conf"], device="cpu"),
                           uni["variables"]).eval()


def test_uni_avnet_waveform_matches_jax(uni):
    with torch.no_grad():
        got = _port(uni)(torch.from_numpy(uni["wav"]),
                         torch.from_numpy(uni["mouth"])).numpy()
    ref = uni["out"]
    assert got.shape == ref.shape == (2, 1, SAMPLES)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < WAVE_REL * scale, (
        np.abs(got - ref).max(), scale)


def test_uni_avnet_gradients_match_jax(uni):
    port = _port(uni)
    out = port(torch.from_numpy(uni["wav"]), torch.from_numpy(uni["mouth"]))
    loss = ((out - torch.from_numpy(uni["tgt"])) ** 2).mean() * 1e3
    loss.backward()
    assert loss.item() == pytest.approx(uni["loss"], rel=1e-4)
    rest = {k: v for k, v in uni["variables"].items() if k != "params"}
    want = dict(load_jax_params(build_avnet(uni["conf"], device="cpu"),
                                {"params": uni["grads"], **rest}
                                ).named_parameters())
    got = dict(port.named_parameters())
    assert got.keys() == want.keys()
    g_max = max(w.abs().max().item() for w in want.values())
    worst = max((p.grad - want[n]).abs().max().item() for n, p in got.items())
    assert worst < MODEL_GRAD_REL * g_max, (worst, g_max)


def test_uni_param_count_and_tree_match_jax(uni):
    """The port's parameters are the JAX model's, leaf for leaf in count
    and tree (``init`` traced abstractly), with the dirs = 1 SRU shapes:
    layer 0 (512, 4H) and (1, 2, H), hidden layers (H, 3H)."""
    jax_count = sum(int(np.prod(a.shape))
                    for a in jax.tree.leaves(uni["shapes"]["params"]))
    port = build_avnet(uni["conf"], device="cpu")
    assert sum(p.numel() for p in port.parameters()) == jax_count
    assert (jax.tree.structure(uni["shapes"])
            == jax.tree.structure(uni["variables"]))
    sd = port.state_dict()
    sru = "refinement_module.audio_net.blocks.globalatt.0.rnn"
    assert tuple(sd[f"{sru}.weights.0"].shape) == (512, 128)
    assert tuple(sd[f"{sru}.weight_cs.0"].shape) == (1, 2, 32)
    assert tuple(sd[f"{sru}.biases.0"].shape) == (1, 2, 32)
    assert tuple(sd[f"{sru}.weights.3"].shape) == (32, 96)
    linear = "refinement_module.audio_net.blocks.globalatt.1.linear.weight"
    assert tuple(sd[linear].shape) == (32, 64, 8)  # ConvTranspose 32 -> 64


def test_uni_convert_avnet_round_trips_the_jax_variables(uni):
    sd = {k: v.numpy() for k, v in _port(uni).state_dict().items()}
    back = convert_avnet(sd, uni["conf"]["audionet"])
    want = dict(jax.tree_util.tree_leaves_with_path(uni["variables"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def _jax_module_vars(mod, x, seed=0):
    v = jax.tree.map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(seed),
                                                   x))
    return jax.tree_util.tree_map_with_path(
        _perturb(np.random.default_rng(seed)), v)


@pytest.mark.parametrize("dim", [3, 4])
def test_unidirectional_dual_path_rnn_matches_jax(monkeypatch, dim):
    """Forward and d(sum sin(out)) for the input and every parameter, the
    JAX module through K4 in interpret mode and the ``ConvTranspose`` tail
    (``num_dir`` 1: 8 -> 16 channels)."""
    x = np.random.default_rng(1).standard_normal((2, 21, 13, 16)).astype(
        np.float32)
    jmod = JR.DualPathRNN(in_chan=16, hid_chan=8, dim=dim, kernel_size=4,
                          rnn_type="SRU", num_layers=3, bidirectional=False)
    monkeypatch.setenv("RTFS_SRU_BACKEND", "scan")
    variables = _jax_module_vars(jmod, jnp.asarray(x))
    monkeypatch.setenv("RTFS_SRU_BACKEND", "interpret")

    def loss(params, x_):
        out = jmod.apply({"params": params}, x_)
        return jnp.sum(jnp.sin(out)), out

    (_, ref), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    ref = np.asarray(ref)

    def port():
        return load_jax_params(TR.DualPathRNN(16, 8, dim=dim, kernel_size=4,
                                              num_layers=3,
                                              bidirectional=False), variables)

    tmod = port()
    assert tmod.linear.weight.shape == (8, 16, 4)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                          ).requires_grad_()
    out = tmod(xt)
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), ref,
                               atol=MODULE_ATOL, rtol=MODULE_ATOL)
    out.sin().sum().backward()
    want = dict(load_jax_params(port(), {"params": g_params}
                                ).named_parameters())
    for n, p in tmod.named_parameters():
        scale = want[n].abs().max().item()
        torch.testing.assert_close(p.grad, want[n], rtol=0, msg=n,
                                   atol=MODEL_GRAD_REL * scale)
    g_x = np.moveaxis(np.asarray(g_x), -1, 1)
    np.testing.assert_allclose(xt.grad.numpy(), g_x, rtol=0,
                               atol=MODEL_GRAD_REL * np.abs(g_x).max())


def _micro_conf():
    """tests/test_train.py's micro AVNet, repeats 3, its DualPathRNN
    unidirectional, plus a bidirectional one that takes the fused stack."""
    a = copy.deepcopy(MICRO_AUDIONET)
    ap = a["audio_params"]
    ap["repeats"] = 3
    ap["layers"]["layer_1"]["bidirectional"] = False
    ap["layers"]["layer_3"] = dict(ap["layers"]["layer_1"], dim=3,
                                   bidirectional=True)
    return {"audionet": a}


def test_chip_smoke_k4_launches_match_a_forward_and_a_step(monkeypatch):
    """chip_smoke.py expects ``k4_launches(conf)`` K4 forwards per forward
    and as many backwards per train step: the calls that, on the card,
    launch the kernels once each. The bidirectional layer launches none."""
    import chip_smoke

    calls = {"sru_recurrence_fwd": 0, "sru_recurrence_bwd": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(sru_pallas, "_k4_forward", counted(
        "sru_recurrence_fwd", sru_pallas._k4_forward))
    monkeypatch.setattr(sru_pallas, "_k4_backward", counted(
        "sru_recurrence_bwd", sru_pallas._k4_backward))
    assert chip_smoke.k4_launches(_uni_conf(repeats=4)) == 32  # 2 x 4 x 4
    assert chip_smoke.k4_launches(jax_load_config(PRESET)) == 0  # fused
    conf = _micro_conf()
    n = chip_smoke.k4_launches(conf)
    assert n == 3 * 2  # repeats x layers of the unidirectional DualPathRNN

    model = build_avnet(conf, device="cpu", seed=0)
    rng = np.random.default_rng(2)
    mix = (rng.standard_normal((1, 1024)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((1, 8, 32)).astype(np.float32)
    with torch.no_grad():
        model(torch.from_numpy(mix), torch.from_numpy(mouth))
    assert calls == {"sru_recurrence_fwd": n, "sru_recurrence_bwd": 0}

    calls.update(sru_recurrence_fwd=0)
    system = AVSystem(model, video_model=torch.nn.Identity(),
                      optimizer=make_optimizer(model.parameters(), "adamw",
                                               lr=1e-3, weight_decay=0.1,
                                               clip_grad_norm=5.0))
    system.train_step({"mix": mix, "src": mix[:, None] * 0.5, "mouth": mouth},
                      torch.Generator().manual_seed(0))
    assert calls == {"sru_recurrence_fwd": n, "sru_recurrence_bwd": n}
