"""The whole slice: the port's RTFS-Net-4 against rtfs_tpu's AVNet.

The JAX AVNet is built from the preset with repeats shrunk to 2 (audio)
and 1 (video), widths as published, and run on a 3968-sample waveform with
an (8, 512) mouth embedding (the ``__graft_entry__`` tiny geometry). Its
variables, initialised with ``jax.random`` and perturbed, move to numpy and
into the port with ``load_jax_params``; ``convert_avnet`` of the port's
``state_dict()`` must give them back leaf for leaf.
"""

import types

import numpy as np
import pytest
import torch

import jax

from rtfs_tpu.config import build_avnet as jax_build_avnet
from rtfs_tpu.config import load_config as jax_load_config
from rtfs_tpu.utils.separator import separate_sample as jax_separate_sample
from rtfs_tpu.utils.torch_import import convert_avnet
from rtfs_tpu_torch.config import build_avnet, load_config
from rtfs_tpu_torch.utils.separator import separate_sample
from rtfs_tpu_torch.utils.weights import load_jax_params

PRESET = "lrs2_RTFSNet_4_layer"
REFERENCE_PARAM_COUNT = 739_952  # tests/test_model_zoo.py


@pytest.fixture(scope="module")
def pair():
    conf = jax_load_config(PRESET)
    conf["audionet"]["audio_params"]["repeats"] = 2
    conf["audionet"]["video_params"]["repeats"] = 1
    jmodel = jax_build_avnet(conf)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 3968)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((2, 8, 512)).astype(np.float32)
    variables = jax.tree.map(
        np.asarray,
        jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, wav, mouth))

    def perturb(path, x):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    apply = jax.jit(jmodel.apply)
    port = build_avnet(conf, device="cpu")
    load_jax_params(port, variables)
    return conf, apply, variables, port, wav, mouth


def test_avnet_waveform_matches_jax(pair):
    conf, apply, variables, port, wav, mouth = pair
    ref = np.asarray(apply(variables, wav, mouth))
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mouth)).numpy()
    assert got.shape == ref.shape == (2, 1, 3968)
    # f32 through ~100 layers summing in another order (XLA vs torch CPU);
    # the golden torch-vs-JAX bound of tests/test_avnet_golden.py is 5e-3
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-4 * scale, (np.abs(got - ref).max(),
                                                      scale)


def test_convert_avnet_round_trips_the_jax_variables(pair):
    conf, _, variables, port, _, _ = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_avnet(sd, conf["audionet"])
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_separate_sample_cpu_matches_jax(pair):
    _, apply, variables, port, wav, mouth = pair
    ref = jax_separate_sample(types.SimpleNamespace(apply=apply), variables,
                              wav[0], mouth[0])
    got = separate_sample(port, wav[0], mouth[0])
    assert got.shape == ref.shape == (1, 3968)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_chip_smoke_geometry_matches_the_forward(pair, monkeypatch):
    """chip_smoke.py checks and times the kernels at shapes it derives from
    the preset; they must be the shapes a forward hands the kernels."""
    import chip_smoke
    from rtfs_tpu_torch.models import rnn_blocks
    from rtfs_tpu_torch.ops import sru_fused

    conf, _, _, port, wav, mouth = pair
    seen = {}

    def record(name, fn):
        def wrapped(*args):
            seen.setdefault(name, set()).add(tuple(args[0].shape))
            return fn(*args)
        return wrapped

    for mod, name in ((sru_fused, "sru_dual_recurrence"),
                      (sru_fused, "sru_hidden_layer"),
                      (rnn_blocks, "convt1d_ola_tm")):
        monkeypatch.setattr(mod, name, record(name, getattr(mod, name)))
    with torch.no_grad():
        port(torch.from_numpy(wav), torch.from_numpy(mouth))

    geo = chip_smoke.main_path_geometry(conf, samples=wav.shape[1])
    h, bs = geo["H"], wav.shape[0]
    sites = [geo["freq"], geo["time"]]
    assert seen == {
        "sru_dual_recurrence": {(n, 4 * h, bs * m) for n, m in sites},
        "sru_hidden_layer": {(n, h, bs * m) for n, m in sites},
        "convt1d_ola_tm": {(n, 2 * h, bs * m) for n, m in sites},
    }


def test_param_count_full_preset():
    model = build_avnet(load_config(PRESET), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == REFERENCE_PARAM_COUNT


def test_build_avnet_draws_weights_from_the_seed():
    conf = load_config(PRESET)
    a, b = (build_avnet(conf, device="cpu", seed=s) for s in (0, 0))
    c = build_avnet(conf, device="cpu", seed=1)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = "encoder.conv.full_layer.2.weight"
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])


def test_build_avnet_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_avnet(load_config(PRESET))
