"""Checkpoints: top-k by validation loss plus the latest, and the export
bundle.

Counterpart of ``rtfs_tpu/train/checkpoints.py`` with ``torch.save`` /
``torch.load`` in place of orbax and msgpack (reference: Lightning's
ModelCheckpoint top-5 by val_loss + save_last, ``train.py:117-127``;
``best_k_models.json``, ``train.py:151-153``; the self-describing
``best_model.pth``, ``base_av_model.py:36-51``). A checkpoint is
``AVSystem.state_dict()``: step, model, optimizer and video model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..utils.code_version import code_version


class CheckpointManager:
    """Keeps the ``top_k`` checkpoints with the lowest validation loss and
    the latest one under ``exp_dir/checkpoints/epoch_{n}.pt``; the index of
    saved epochs and their losses lives beside them, so a new manager on
    the same directory picks them up (resume)."""

    def __init__(self, exp_dir: str, top_k: int = 5):
        self.exp_dir = os.path.abspath(exp_dir)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.top_k = top_k
        self._index_path = os.path.join(self.ckpt_dir, "index.json")
        self.val_losses: Dict[int, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.val_losses = {int(k): v for k, v in json.load(f).items()}

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"epoch_{step}.pt")

    def save(self, step: int, state: Dict[str, Any], val_loss: float) -> None:
        torch.save(state, self.path(step))
        self.val_losses[int(step)] = float(val_loss)
        best = sorted(self.val_losses, key=lambda s: (self.val_losses[s], s))
        keep = set(best[: self.top_k]) | {max(self.val_losses)}
        for s in list(self.val_losses):
            if s not in keep:
                del self.val_losses[s]
                if os.path.exists(self.path(s)):
                    os.remove(self.path(s))
        with open(self._index_path, "w") as f:
            json.dump(self.val_losses, f, indent=2)
        with open(os.path.join(self.exp_dir, "best_k_models.json"), "w") as f:
            json.dump({f"epoch={s}": self.val_losses[s]
                       for s in best[: self.top_k]}, f, indent=2)

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default: the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self.path(step)):
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def best_step(self) -> Optional[int]:
        if not self.val_losses:
            return None
        return min(self.val_losses, key=lambda s: (self.val_losses[s], s))

    def latest_step(self) -> Optional[int]:
        return max(self.val_losses) if self.val_losses else None


def resolve_checkpoint_spec(spec: str, default: CheckpointManager):
    """``--checkpoint`` -> (manager, step): ``"7"`` is epoch 7 of this run,
    ``"/path/to/exp"`` the latest epoch of another run, ``"/path@7"`` its
    epoch 7 (as the JAX trainer)."""
    step: Optional[int] = None
    if "@" in spec:
        spec, step_s = spec.rsplit("@", 1)
        step = int(step_s)
    if spec.isdigit():
        return default, int(spec)
    path = os.path.abspath(spec)
    if os.path.basename(path) == "checkpoints":
        path = os.path.dirname(path)
    if not os.path.isdir(os.path.join(path, "checkpoints")):
        raise FileNotFoundError(
            f"--checkpoint={spec!r}: no checkpoints/ dir under {path}")
    mgr = CheckpointManager(path)
    return mgr, (step if step is not None else mgr.latest_step())


def export_model(path: str, model_conf: Dict[str, Any], model_state,
                 video_state=None, infos: Optional[Dict] = None) -> None:
    """Self-describing bundle: {model_name, model_args, state, infos}, the
    ``best_model.pth`` analogue; ``load_exported`` reads it back. ``infos``
    pins the checkout's ``code_version``, which the evaluation entry checks
    against the code it runs."""
    bundle = {
        "model_name": "AVNet",
        "model_args": model_conf,
        "state": {"model": model_state, "video_model": video_state or {}},
        "infos": {"software_versions": {"torch": str(torch.__version__)},
                  "code_version": code_version(),
                  **(infos or {})},
    }
    torch.save(bundle, path)


def load_exported(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)
