"""Port lip backbone (FRCNNVideoModel, ResNet-18 trunk) against rtfs_tpu.

The JAX model is initialised with ``jax.random`` at (1, 5, 88, 88), its
variables perturbed (BatchNorm statistics away from 0 / 1, so eval-mode BN
does real work), moved to numpy and into the port with
``load_jax_params``; ``convert_frcnn_video`` of the port's ``state_dict()``
must give them back leaf for leaf.
"""

import json

import numpy as np
import pytest
import torch

import jax

from rtfs_tpu.models.video import FRCNNVideoModel as JVideo
from rtfs_tpu.utils.torch_import import convert_frcnn_video
from rtfs_tpu_torch.config import build_video_model, load_config
from rtfs_tpu_torch.models.video import FRCNNVideoModel
from rtfs_tpu_torch.utils.weights import load_jax_params

SHAPE = (1, 5, 88, 88)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    mouth = rng.standard_normal(SHAPE).astype(np.float32)
    jmodel = JVideo()
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), mouth))

    def perturb(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    port = load_jax_params(FRCNNVideoModel().eval(), variables)
    return jmodel, variables, port, mouth


def test_video_model_matches_jax(pair):
    jmodel, variables, port, mouth = pair
    ref = np.asarray(jax.jit(jmodel.apply)(variables, mouth))
    with torch.no_grad():
        got = port(torch.from_numpy(mouth)).numpy()
    assert got.shape == ref.shape == (1, 5, 512)
    # f32 through 18 convolutions summed in another order (XLA vs torch)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-4 * scale, (np.abs(got - ref).max(),
                                                      scale)


def test_convert_frcnn_video_round_trips_the_jax_variables(pair):
    _, variables, port, _ = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_frcnn_video(sd, "resnet")
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_build_video_model_is_frozen_and_seeded(capsys):
    conf = load_config("lrs2_RTFSNet_4_layer")
    a = build_video_model(conf, device="cpu", seed=0)
    b = build_video_model(conf, device="cpu", seed=0)
    c = build_video_model(conf, device="cpu", seed=1)
    assert not a.training
    assert not any(p.requires_grad for p in a.parameters())
    w = "trunk.layer1.0.conv1.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    assert build_video_model({"videonet": None}, device="cpu") is None

    # a pretrained checkpoint is not loaded: a named one warns, and the
    # weights still come from the seed
    conf = json.loads(json.dumps(conf))
    conf["videonet"]["pretrain"] = "backbone.pth.tar"
    d = build_video_model(conf, device="cpu", seed=0)
    assert "not loaded" in capsys.readouterr().out
    assert torch.equal(d.state_dict()[w], a.state_dict()[w])
