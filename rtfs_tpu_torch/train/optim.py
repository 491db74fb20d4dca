"""Optimizer factory and LR schedules.

Counterpart of ``rtfs_tpu/train/optim.py``: the reference recipe is AdamW
(lr 1e-3, weight decay 0.1) after a clip of the gradients' global norm to
5.0 (``train.py:81-86,143``). The clip uses optax's formula
(``clip_by_global_norm``: ``g * max_norm / ||g||`` once ``||g|| >=
max_norm``), not ``torch.nn.utils.clip_grad_norm_``'s ``+1e-6``. Weight
decay applies to every parameter, as ``optax.adamw`` without a mask does;
``adam`` takes no weight decay, as ``optax.adam`` has none.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

_FACTORIES = {
    "adamw": lambda params, lr, wd: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd),
    "adam": lambda params, lr, wd: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
}


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / ||g||) (optax formula),
    on the device, without a host sync; returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedOptimizer:
    """A torch optimizer behind a global-norm clip: ``step()`` clips the
    gradients of every parameter, then steps."""

    def __init__(self, inner: torch.optim.Optimizer,
                 clip_grad_norm: Optional[float]):
        self.inner = inner
        self.clip_grad_norm = clip_grad_norm
        self.params = [p for g in inner.param_groups for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self):
        if self.clip_grad_norm is not None:
            clip_by_global_norm(self.params, self.clip_grad_norm)
        self.inner.step()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   optimizer: str = "adamw", lr: float = 1e-3,
                   weight_decay: float = 0.0,
                   clip_grad_norm: Optional[float] = 5.0) -> ClippedOptimizer:
    """String -> [global-norm clip] -> optimizer(lr, wd) over ``params``."""
    name = optimizer.lower()
    if name not in _FACTORIES:  # rtfs_tpu's other names are not ported yet
        raise NotImplementedError(f"optimizer '{optimizer}' is not ported; "
                                  f"available: {sorted(_FACTORIES)}")
    return ClippedOptimizer(_FACTORIES[name](list(params), lr, weight_decay),
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
