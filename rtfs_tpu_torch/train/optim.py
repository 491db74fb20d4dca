"""Optimizer factory and LR schedules.

Counterpart of ``rtfs_tpu/train/optim.py``: the reference recipe is AdamW
(lr 1e-3, weight decay 0.1) after a clip of the gradients' global norm to
5.0 (``train.py:81-86,143``), built there as optax's ``chain(
clip_by_global_norm(5.0), inject_hyperparams(adamw)(lr))``. The port
writes that chain out op by op (``OptaxAdam``), in the parameters' own
dtype, with the constants rounded to it as JAX rounds them: so a bf16
model trains on bf16 parameters with bf16 moments and no float32 master
copy, as the JAX bench's ``train_bf16`` row does (``bench.py:321-345``),
and its steps equal jitted optax's bit for bit on the same bf16 gradients
(``tests/test_torch_bf16_train.py``). ``torch.optim.AdamW`` is not
optax's formula. In float32 the steps agree with optax to a few float32
ulps: XLA folds ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` into one division
and sums the squares in its own order. Weight decay applies to every
parameter, as ``optax.adamw`` without a mask does; ``adam`` takes no
weight decay, as ``optax.adam`` has none.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

_DECAYS = {"adamw": True, "adam": False}
# optax's defaults, which the reference recipe keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python constant (a
    weakly typed scalar) against an array of that dtype."""
    return torch.tensor(value, dtype=dtype).item()


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float):
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    their dtype and on the device, without a host sync: each leaf's
    squares summed in float32 and rounded to its dtype, the sums added in
    leaf order (promoting as JAX does), the root taken; where the norm is
    ``max_norm`` or more, each gradient becomes ``(g / norm) * max_norm``.
    Returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    sums = [torch.sum(g * g, dtype=torch.float32).to(g.dtype) for g in grads]
    total = sums[0]
    for part in sums[1:]:
        total = total + part
    norm = torch.sqrt(total)
    keep = norm < _rounded(max_norm, norm.dtype)
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype)
                            * _rounded(max_norm, g.dtype)))
    return norm


class OptaxAdam:
    """optax's ``chain(clip_by_global_norm(clip), adamw(lr, B1, B2, EPS,
    weight_decay))`` (or ``adam``, ``weight_decay`` None) over ``params``,
    op by op in each parameter's dtype with multi-tensor
    (``torch._foreach_*``) ops: mu and nu in that dtype, the bias
    corrections ``1 - b ** count`` in float32 and rounded to it, ``lr``
    rounded to it. ``param_groups[0]["lr"]`` is the learning rate a
    schedule sets."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: Optional[float],
                 clip_grad_norm: Optional[float]):
        self.params = list(params)
        self.param_groups = [{"lr": lr, "params": self.params}]
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        if self.clip_grad_norm is not None:
            clip_by_global_norm(self.params, self.clip_grad_norm)
        self.count += 1
        f32 = np.float32
        bc = [f32(1) - f32(np.float64(f32(b)) ** self.count)
              for b in (B1, B2)]
        groups = {}
        for p, m, v in zip(self.params, self.mu, self.nu):
            if p.grad is not None:
                groups.setdefault(p.dtype, []).append((p, p.grad, m, v))
        for dt, rows in groups.items():
            ps, gs, ms, vs = (list(r) for r in zip(*rows))

            def c(value, dt=dt):  # a constant, rounded to the group's dtype
                return _rounded(value, dt)

            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(ms, c(B1))
            torch._foreach_add_(ms, torch._foreach_mul(gs, c(1 - B1)))
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(g2, c(1 - B2))
            torch._foreach_mul_(vs, c(B2))
            torch._foreach_add_(vs, g2)
            # (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p], times -lr
            den = torch._foreach_div(vs, c(bc[1]))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c(EPS))
            upd = torch._foreach_div(ms, c(bc[0]))
            torch._foreach_div_(upd, den)
            if self.weight_decay is not None:
                torch._foreach_add_(upd, torch._foreach_mul(
                    ps, c(self.weight_decay)))
            torch._foreach_mul_(upd, -c(self.param_groups[0]["lr"]))
            torch._foreach_add_(ps, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "lr": self.param_groups[0]["lr"],
                "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.param_groups[0]["lr"] = float(state["lr"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for i, (m, t) in enumerate(zip(mine, theirs)):
                mine[i] = t.to(m.device, m.dtype).clone()


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   optimizer: str = "adamw", lr: float = 1e-3,
                   weight_decay: float = 0.0,
                   clip_grad_norm: Optional[float] = 5.0) -> OptaxAdam:
    """String -> [global-norm clip] -> optimizer(lr, wd) over ``params``."""
    name = optimizer.lower()
    if name not in _DECAYS:  # rtfs_tpu's other names are not ported yet
        raise NotImplementedError(f"optimizer '{optimizer}' is not ported; "
                                  f"available: {sorted(_DECAYS)}")
    return OptaxAdam(params, lr, weight_decay if _DECAYS[name] else None,
                     clip_grad_norm)


def get_lr(opt) -> float:
    """The current learning rate (of the first parameter group)."""
    return float(opt.param_groups[0]["lr"])


def set_lr(opt, lr: float):
    """Set the learning rate of every parameter group; returns ``opt``."""
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch ReduceLROnPlateau parity).

    Reference wiring: patience from ``sche.patience``, factor ``sche.factor``
    when ``training.half_lr`` (``train.py:84-86``).
    """

    factor: float = 0.5
    patience: int = 10
    best: float = float("inf")
    num_bad_epochs: int = 0
    min_lr: float = 0.0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


@dataclasses.dataclass
class EpochDivideLR:
    """Manual epoch-wise LR divide (reference ``core.py:204-212``)."""

    base_lr: float
    divide_by: Optional[float] = None
    period: int = 0

    def lr_for_epoch(self, epoch: int, current_lr: float) -> float:
        if not self.divide_by or self.period <= 0 or epoch == 0:
            return current_lr
        if epoch % self.period == 0:
            return self.base_lr / (self.divide_by ** (epoch // self.period))
        return current_lr
