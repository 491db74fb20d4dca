"""Port optimizer (global-norm clip + AdamW / Adam) and LR schedules against
rtfs_tpu.train.optim (optax).

Identical parameters and gradients (numpy seeds) go to both; the second
step's gradients have a global norm above 5.0, so the clip acts. Tolerance:
float32 Adam arithmetic in another order, updates of O(lr) on O(1)
parameters: atol 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from rtfs_tpu.train import optim as J
from rtfs_tpu_torch.train import optim as T

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}


def _grads(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name,wd", [("adamw", 0.1), ("adam", 0.0)])
def test_clip_and_adam_steps_match_optax(name, wd):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    # global norms ~0.5, ~20 (clipped to 5), ~2
    steps = [_grads(rng, s) for s in (0.1, 4.0, 0.4)]
    assert np.sqrt(sum((g ** 2).sum() for g in steps[1].values())) > 5.0

    opt = J.make_optimizer(name, lr=1e-3, weight_decay=wd)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = T.make_optimizer(tparams.values(), name, lr=1e-3, weight_decay=wd)
    for i, grads in enumerate(steps):
        if i == 2:  # a schedule moved the learning rate
            state = J.set_lr(state, 5e-4)
            T.set_lr(topt, 5e-4)
            assert T.get_lr(topt) == pytest.approx(J.get_lr(state))
        updates, state = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        topt.step()
        topt.zero_grad()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {i} {k}")


def test_clip_by_global_norm_is_optax_formula():
    rng = np.random.default_rng(1)
    grads = _grads(rng, 3.0)
    want, _ = optax.clip_by_global_norm(5.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    for p, g in zip(ps, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    norm = T.clip_by_global_norm(ps, 5.0)
    assert norm.item() > 5.0
    for p, k in zip(ps, SHAPES):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


def test_unported_optimizer_raises():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for name in ("lamb", "sgd"):
        with pytest.raises(NotImplementedError):
            T.make_optimizer(p, name)


def test_plateau_and_divide_schedules_match_jax():
    metrics = [1.0, 0.9, 0.95, 0.93, 0.91, 0.92, 0.8, 0.85, 0.86, 0.87, 0.88]
    jp, tp = J.ReduceLROnPlateau(factor=0.5, patience=2), T.ReduceLROnPlateau(
        factor=0.5, patience=2)
    jlr = tlr = 1e-3
    for m in metrics:
        jlr, tlr = jp.step(m, jlr), tp.step(m, tlr)
        assert tlr == jlr
    assert tlr < 1e-3
    jd = J.EpochDivideLR(base_lr=1e-3, divide_by=2.0, period=3)
    td = T.EpochDivideLR(base_lr=1e-3, divide_by=2.0, period=3)
    jlr = tlr = 1e-3
    for epoch in range(10):
        jlr, tlr = jd.lr_for_epoch(epoch, jlr), td.lr_for_epoch(epoch, tlr)
        assert tlr == jlr
    assert tlr == pytest.approx(1e-3 / 8)
