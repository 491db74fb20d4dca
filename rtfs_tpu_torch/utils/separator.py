"""Serving entry: one forward plus energy renormalisation.

Counterpart of ``rtfs_tpu/utils/separator.py:separate_sample`` (the
reference's ``separate()``, ``src/utils/separator.py:22-68``).
"""

from __future__ import annotations

import numpy as np
import torch


def separate_sample(model, wav, mouth_emb=None) -> np.ndarray:
    """Separate one utterance or a batch on the model's device.

    Args:
      model: an ``AVNet`` (``config.build_avnet``).
      wav: (L,) or (B, L) mixture, numpy or tensor.
      mouth_emb: (T2, C) or (B, T2, C) lip embedding, or None.

    Returns:
      (B, n_src, L) float32 numpy estimates, each source's RMS matched to
      the mixture's ((n_src, L) for a 1-D ``wav``).
    """
    device = next(model.parameters()).device
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    if mouth_emb is not None:
        mouth_emb = torch.as_tensor(mouth_emb, dtype=torch.float32,
                                    device=device)
        if mouth_emb.ndim == 2:
            mouth_emb = mouth_emb[None]
    with torch.inference_mode():
        est = model(wav, mouth_emb)
    est = _energy_renormalize(est.cpu().numpy(), wav.cpu().numpy())
    return est[0] if squeeze else est


def _energy_renormalize(est: np.ndarray, mix: np.ndarray) -> np.ndarray:
    """Match each source's RMS to the mixture RMS (reference semantics)."""
    in_rms = np.sqrt(np.mean(mix**2, axis=-1, keepdims=True))[..., None, :]
    est_rms = np.sqrt(np.mean(est**2, axis=-1, keepdims=True)) + 1e-8
    return est * (in_rms / est_rms)
