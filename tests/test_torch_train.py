"""The port's train step against rtfs_tpu's, and the train entry on the CPU.

The micro AVNet of tests/test_train.py (two repeats of a TDANet with a
DualPathRNN and TF attention, a video TDANet with BatchNorm1d and a
GlobalAttention, CAF fusion) with its stand-in ``_MouthEmbed`` video, at
batch 2 of 1024 samples, with dropout 0 so that both steps are
deterministic. The JAX variables go into the port with
``load_jax_params``; JAX's gradient tree, its new BatchNorm statistics and
its parameters after the step go into further port models the same way,
so every tensor is compared under its port name.

Tolerances, float32 through ~60 layers summed in another order (XLA vs
torch CPU): the loss to 1e-4 relative; each gradient tensor to 1e-3 of its
own max |grad| plus 1e-6 of the largest gradient anywhere (tensors whose
true gradient is zero, such as conv biases under a norm, hold rounding
noise only); the BatchNorm statistics to 1e-5. Parameters after the AdamW
step: Adam moves each entry by about lr whatever the gradient's size, so
where a gradient is at rounding level the two steps may go opposite ways;
the parameters are compared to 2 lr + 1e-6.
"""

import copy
import functools
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from rtfs_tpu.models.avnet import AVNet as JAVNet
from rtfs_tpu.train import AVSystem as JAVSystem
from rtfs_tpu.train import make_optimizer as jmake_optimizer
from rtfs_tpu.train.system import TrainState
from rtfs_tpu_torch.config import build_avnet
from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
from rtfs_tpu_torch.models import layers as L
from rtfs_tpu_torch.train import AVSystem, make_optimizer
from rtfs_tpu_torch.train import main as train_main
from rtfs_tpu_torch.train.checkpoints import CheckpointManager, load_exported
from rtfs_tpu_torch.utils.weights import load_jax_params
from test_train import MICRO_AUDIONET, _batch, _MouthEmbed

LR = 1e-3


class _TorchMouthEmbed(torch.nn.Module):
    """tests/test_train.py's stand-in backbone: the mouth rows tiled to 32."""

    def forward(self, mouth):
        reps = -(-32 // mouth.shape[-1])
        return mouth.repeat(1, 1, reps)[..., :32]


def _audionet(dropout):
    a = copy.deepcopy(MICRO_AUDIONET)
    a["video_params"]["layers"]["layer_1"]["dropout"] = dropout
    return a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(a, params, stats):
    return load_jax_params(build_avnet({"audionet": a}, device="cpu"),
                           {"params": _np(params), "batch_stats": _np(stats)})


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step, its gradients and new statistics, the parameters after
    it and the validation loss, from one jitted function (the state is
    built as ``AVSystem.create_state`` builds it, with a jitted init)."""
    a = _audionet(0.0)
    model, video = JAVNet(**a), _MouthEmbed()
    optimizer = jmake_optimizer("adamw", lr=LR, weight_decay=0.1)
    system = JAVSystem(model, video_model=video, optimizer=optimizer,
                       donate_state=False)
    batch = _batch()
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                    batch["mix"], video.apply({}, batch["mouth"]))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optimizer.init(variables["params"]),
                       video_variables=video.init(None, batch["mouth"]))
    rng = jax.random.PRNGKey(1)

    @jax.jit
    def run(state):
        def loss_fn(params):
            return system._forward_loss(params, state.batch_stats,
                                        state.video_variables, batch, rng,
                                        train=True)

        (loss, (new_stats, _)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        clipped, _ = optax.clip_by_global_norm(5.0).update(grads, None)
        state2, metrics = system.train_step_fn(state, batch, rng)
        val = system.val_step_fn(state2, batch)["val_loss"]
        return loss, metrics["train_loss"], new_stats, clipped, state2, val

    loss, step_loss, new_stats, clipped, state2, val = run(state)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)
    return dict(a=a, batch=batch, state=state, loss=float(loss),
                grads=clipped, new_stats=new_stats, state2=state2,
                val=float(val))


def _port_system(a, params, stats):
    model = _port(a, params, stats)
    return AVSystem(model, video_model=_TorchMouthEmbed(),
                    optimizer=make_optimizer(model.parameters(), "adamw",
                                             lr=LR, weight_decay=0.1))


def test_train_step_matches_jax(jax_run):
    r = jax_run
    a, state = r["a"], r["state"]
    system = _port_system(a, state.params, state.batch_stats)
    out = system.train_step(r["batch"], torch.Generator().manual_seed(0))
    loss = out["train_loss"].item()
    assert loss == pytest.approx(r["loss"], rel=1e-4)

    want_g = dict(_port(a, r["grads"], state.batch_stats).named_parameters())
    got = dict(system.model.named_parameters())
    g_max = max(w.abs().max().item() for w in want_g.values())
    for name, p in got.items():
        assert p.grad is not None, name
        w = want_g[name].detach()
        tol = 1e-3 * w.abs().max().item() + 1e-6 * g_max
        torch.testing.assert_close(p.grad, w, atol=tol, rtol=0, msg=name)

    want_s = _port(a, state.params, r["new_stats"]).state_dict()
    n_stats = 0
    for name, buf in system.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(buf, want_s[name], atol=1e-5, rtol=0,
                                       msg=name)
            n_stats += 1
    assert n_stats > 0

    want_p = dict(_port(a, r["state2"].params,
                        r["new_stats"]).named_parameters())
    for name, p in got.items():
        torch.testing.assert_close(p.detach(), want_p[name].detach(),
                                   atol=2 * LR + 1e-6, rtol=0, msg=name)


def test_val_step_matches_jax(jax_run):
    r = jax_run
    system = _port_system(r["a"], r["state2"].params, r["new_stats"])
    val = system.val_step(r["batch"])["val_loss"].item()
    assert val == pytest.approx(r["val"], rel=1e-4)


def test_dropout_is_deterministic_under_a_generator(jax_run):
    """With the preset-like dropout 0.1, a fixed generator gives the same
    step twice; dropout changes the train forward and not the eval one."""
    r = jax_run
    a = _audionet(0.1)
    params, stats = r["state"].params, r["state"].batch_stats
    runs = []
    for _ in range(2):
        system = _port_system(a, params, stats)
        loss = system.train_step(r["batch"], torch.Generator().manual_seed(3))
        runs.append((loss["train_loss"].item(),
                     [p.detach().clone() for p in system.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for x, y in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x, y)

    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    video = _TorchMouthEmbed()(batch["mouth"])
    drop, plain = _port(a, params, stats), _port(_audionet(0.0), params, stats)
    L.set_dropout_generator(drop, torch.Generator().manual_seed(4))
    with torch.no_grad():
        outs = {}
        for mode in ("eval", "train"):  # train mode moves the BN stats
            for name, m in (("drop", drop), ("plain", plain)):
                getattr(m, mode)()
                outs[mode, name] = m(batch["mix"], video)
    assert not torch.equal(outs["train", "drop"], outs["train", "plain"])
    assert torch.equal(outs["eval", "drop"], outs["eval", "plain"])


def test_dropout_in_train_mode_needs_a_generator():
    m = L.Dropout(0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        m(torch.ones(3))
    assert torch.equal(m.eval()(torch.ones(3)), torch.ones(3))


MICRO_TRAIN_CONF = {
    "videonet": {"model_name": "FRCNNVideoModel", "backbone_type": "resnet",
                 "relu_type": "prelu", "pretrain": None},
    "training": {"epochs": 1, "batch_size": 2, "half_lr": True,
                 "early_stop": True, "divide_lr_by": None,
                 "online_mix": False},
    "optim": {"optimizer": "adamw", "lr": 0.001, "weight_decay": 0.1},
    "sche": {"patience": 2, "factor": 0.5},
    "data": {"synthetic": True, "synthetic_samples": 4},
}


def test_train_entry_runs_checkpoints_and_resumes(tmp_path, capsys,
                                                  monkeypatch):
    """The train entry on the CPU: micro AVNet with the real lip backbone,
    synthetic data (cut to 64 ms of audio and 4 mouth crops of 16 x 16),
    one epoch; it writes metrics.jsonl, a checkpoint and the best-model
    bundle, and a second run with two epochs resumes from the first run's
    checkpoint."""
    monkeypatch.setattr(train_main, "SyntheticAVDataset", functools.partial(
        SyntheticAVDataset, segment=0.064, video_frames=4, mouth_size=16))
    a = _audionet(0.1)
    a["pretrained_vout_chan"] = 512
    conf = {**copy.deepcopy(MICRO_TRAIN_CONF), "audionet": a,
            "log": {"path": str(tmp_path), "exp_name": "micro"}}
    path = os.path.join(tmp_path, "micro.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    row = train_main.cli(["--conf-dir", path, "--device", "cpu",
                          "--seed", "0"])
    exp = os.path.join(tmp_path, "micro")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0] and rows[0] == row
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    ckpt = CheckpointManager(exp)
    assert ckpt.latest_step() == 0 == ckpt.best_step()
    state = ckpt.restore()
    assert state["step"] == 2  # 4 samples at batch 2
    bundle = load_exported(os.path.join(exp, "best_model.pt"))
    assert bundle["model_args"] == a and bundle["infos"]["best_epoch"] == 0
    assert bundle["state"]["model"].keys() == state["model"].keys()

    row = train_main.cli(["--conf-dir", path, "--device", "cpu",
                          "--training.epochs", "2", "--optim.lr", "5e-4"])
    assert "resumed from epoch 0" in capsys.readouterr().out
    assert row["epoch"] == 1
    assert CheckpointManager(exp).restore()["step"] == 4
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
