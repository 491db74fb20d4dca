"""Permutation-invariant training (PIT) loss.

Counterpart of ``rtfs_tpu/losses/pit.py`` (reference
``src/losses/pit_wrapper.py:15-116``). For n_src <= 4 the best permutation
comes from one einsum over the one-hot permutation tensors; above that,
from SciPy's Hungarian solver on the host, as the reference does. The
chosen indices carry no gradient; the loss is differentiable through the
pairwise matrix.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch


def _perm_matrix(n_src: int) -> np.ndarray:
    """(n_perm, n_src, n_src) one-hot permutation tensors."""
    perms = list(itertools.permutations(range(n_src)))
    one_hot = np.zeros((len(perms), n_src, n_src), np.float32)
    for i, p in enumerate(perms):
        one_hot[i, np.arange(n_src), p] = 1.0
    return one_hot


def find_best_perm(pw_losses: torch.Tensor):
    """Min-over-permutations of a pairwise loss matrix.

    Args:
      pw_losses: (B, n_src_est, n_src_tgt).
    Returns:
      (min_loss (B,), batch_indices (B, n_src) int64): ``batch_indices[b]``
      is the permutation of the estimates that matches target order.
    """
    n_src = pw_losses.shape[-1]
    pwl = pw_losses.transpose(-1, -2)  # (B, tgt, est)
    if n_src <= 4:
        perms_oh = torch.from_numpy(_perm_matrix(n_src)).to(pwl)
        loss_set = torch.einsum("bij,pij->bp", pwl, perms_oh) / n_src
        min_loss, idx = loss_set.min(dim=1)
        perms = torch.tensor(list(itertools.permutations(range(n_src))),
                             device=pwl.device)
        return min_loss, perms[idx]
    from scipy.optimize import linear_sum_assignment

    mats = pwl.detach().cpu().numpy()
    batch_indices = torch.from_numpy(np.stack(
        [linear_sum_assignment(m)[1] for m in mats]).astype(np.int64)
    ).to(pwl.device)
    picked = torch.gather(pwl, 2, batch_indices[..., None])
    return picked.mean(dim=(-1, -2)), batch_indices


def reorder_sources(sources: torch.Tensor,
                    batch_indices: torch.Tensor) -> torch.Tensor:
    """Reorder (B, n_src, ...) estimates by per-batch permutation indices."""
    idx = batch_indices.reshape(*batch_indices.shape,
                                *(1,) * (sources.ndim - 2))
    return torch.gather(sources, 1, idx.expand_as(sources))


def pit_loss(pairwise_loss_fn: Callable, ests: torch.Tensor,
             targets: torch.Tensor, return_ests: bool = False):
    """Mean best-permutation loss (optionally with the reordered ests)."""
    min_loss, batch_indices = find_best_perm(pairwise_loss_fn(ests, targets))
    mean_loss = min_loss.mean()
    if return_ests:
        return mean_loss, reorder_sources(ests, batch_indices)
    return mean_loss


class PITLossWrapper:
    """Object-style wrapper mirroring the reference API (``pit_from="pw_mtx"``)."""

    def __init__(self, loss_func: Callable, pit_from: str = "pw_mtx"):
        if pit_from != "pw_mtx":
            raise NotImplementedError(
                "only pairwise-matrix PIT is used by the model zoo"
            )
        self.loss_func = loss_func

    def __call__(self, ests, targets, return_ests: bool = False):
        return pit_loss(self.loss_func, ests, targets, return_ests)
