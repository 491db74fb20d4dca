"""AVSystem: the training system.

Counterpart of ``rtfs_tpu/train/system.py`` (reference
``src/system/core.py:50-232``): the frozen video forward, the AVNet in
train mode with PIT neg-SNR (train) or in eval mode with PIT neg-SI-SDR
(validation), the backward through the kernels' autograd Functions, the
global-norm clip and the optimizer step. BatchNorm statistics move in the
train forward (``layers.BatchNorm``). One device; data-parallel training
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses import pairwise_neg_sisdr, pairwise_neg_snr, pit_loss
from ..models import layers as L
from .optim import make_optimizer


def _fold_speakers(mouth):
    """(B, S, T, H, W) per-source mouths -> ((B*S, T, H, W), S); 4-D input
    passes through with S = 1."""
    if mouth.ndim == 5:
        b, s = mouth.shape[:2]
        return mouth.reshape((b * s,) + tuple(mouth.shape[2:])), s
    return mouth, 1


def _unfold_speakers(ests, n_spk: int):
    """(B*S, 1, T) per-speaker estimates -> (B, S, T)."""
    if n_spk == 1:
        return ests
    if ests.shape[1] != 1:
        raise ValueError(
            "per-source mouths (n_src>=2 dataset) require a 1-mask model "
            f"(audionet n_src=1); model emitted {ests.shape[1]} estimates"
        )
    return ests.reshape((-1, n_spk) + tuple(ests.shape[2:]))


class AVSystem:
    """Owns the AVNet, the frozen video model and the optimizer.

    Args:
      model: the port's ``AVNet`` on its device.
      video_model: frozen lip backbone on the same device (or None for
        audio-only); it runs in eval mode with no gradient, as
        ``jax.lax.stop_gradient`` around it in the JAX system.
      optimizer: from ``train.optim.make_optimizer`` (default: AdamW 1e-3,
        no weight decay, clip 5.0 over ``model``'s parameters).
    """

    def __init__(self, model, video_model=None, optimizer=None,
                 train_video_model: bool = False, online_mix: bool = False):
        if train_video_model:
            raise NotImplementedError(
                "joint video training (train_video_model) is not ported")
        if online_mix and video_model is None:
            raise NotImplementedError("online_mix is not ported")
        self.model = model
        self.video_model = video_model
        if video_model is not None:
            video_model.eval().requires_grad_(False)
        self.optimizer = optimizer or make_optimizer(model.parameters())
        self.step = 0

    def _tensors(self, batch):
        """The batch on the model's device in the model's dtype."""
        p = next(self.model.parameters())
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v, dtype=p.dtype, device=p.device)
                for k, v in batch.items() if k in ("mix", "src", "mouth")}

    def _forward_loss(self, batch, train: bool):
        wav, targets = batch["mix"], batch["src"]
        if targets.ndim == 2:
            targets = targets[:, None]
        mouth_emb, n_spk = None, 1
        if self.video_model is not None:
            mouth, n_spk = _fold_speakers(batch["mouth"])
            with torch.no_grad():
                mouth_emb = self.video_model(mouth)
        model_in = wav.repeat_interleave(n_spk, dim=0) if n_spk > 1 else wav
        ests = _unfold_speakers(self.model(model_in, mouth_emb), n_spk)
        loss_fn = pairwise_neg_snr if train else pairwise_neg_sisdr
        return pit_loss(loss_fn, ests, targets)

    def train_step(self, batch, generator: torch.Generator) -> dict:
        """One optimizer step on ``batch`` (dict of ``mix`` (B, L), ``src``
        (B, n_src, L), ``mouth``; numpy or tensors). Every dropout mask
        draws from ``generator``. Returns ``{"train_loss"}`` as a 0-d
        tensor on the device (no host sync)."""
        batch = self._tensors(batch)
        self.model.train()
        L.set_dropout_generator(self.model, generator)
        loss = self._forward_loss(batch, train=True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"train_loss": loss.detach()}

    def val_step(self, batch) -> dict:
        """PIT neg-SI-SDR in eval mode, no gradient: ``{"val_loss"}``."""
        batch = self._tensors(batch)
        self.model.eval()
        with torch.no_grad():
            return {"val_loss": self._forward_loss(batch, train=False)}

    def state_dict(self) -> dict:
        """Everything a resume needs (the TrainState counterpart)."""
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "video_model": (self.video_model.state_dict()
                            if self.video_model is not None else {}),
        }

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.video_model is not None and state.get("video_model"):
            self.video_model.load_state_dict(state["video_model"])


def make_generator(seed: int, device) -> torch.Generator:
    """The train step's generator on ``device``, seeded from ``--seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
