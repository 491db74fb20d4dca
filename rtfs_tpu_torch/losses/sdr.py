"""Negative SNR / SI-SDR / SD-SDR losses (pairwise, single, multi-src).

Counterpart of ``rtfs_tpu/losses/sdr.py`` (reference
``src/losses/matrix.py:13-149``): zero-mean over time, eps 1e-8 added to
the target energy AND inside the log, ``10*log10``. Training uses
``PIT(pairwise_neg_snr)``, validation ``PIT(pairwise_neg_sisdr)``.
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-8


def _zero_mean(ests, targets, dim):
    return (ests - ests.mean(dim=dim, keepdim=True),
            targets - targets.mean(dim=dim, keepdim=True))


def _neg_sdr(ests, targets, sdr_type, zero_mean, take_log, eps, dim):
    """-SDR of ``ests`` against ``targets`` (already broadcast) over
    ``dim``."""
    if zero_mean:
        ests, targets = _zero_mean(ests, targets, dim)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (ests * targets).sum(dim=dim, keepdim=True)
        energy = targets.square().sum(dim=dim, keepdim=True) + eps
        proj = dot * targets / energy
    else:
        proj = targets + torch.zeros_like(ests)  # the pairwise shape
    e_noise = ests - targets if sdr_type in ("sdsdr", "snr") else ests - proj
    sdr = proj.square().sum(dim=dim) / (e_noise.square().sum(dim=dim) + eps)
    if take_log:
        sdr = 10.0 * torch.log10(sdr + eps)
    return -sdr


def pairwise_neg_sdr(ests, targets, sdr_type: str = "sisdr", zero_mean=True,
                     take_log=True, eps: float = EPS):
    """(B, n_src, L) pair -> (B, n_src_est, n_src_tgt) negative SDRs."""
    if ests.ndim != 3 or targets.ndim != 3:
        raise ValueError("pairwise_neg_sdr expects (B, n_src, L) inputs")
    if zero_mean:  # over time, before the pairwise broadcast
        ests, targets = _zero_mean(ests, targets, 2)
    return _neg_sdr(ests[:, :, None], targets[:, None], sdr_type, False,
                    take_log, eps, 3)


def multisrc_neg_sdr(ests, targets, sdr_type="sisdr", zero_mean=True,
                     take_log=True, eps: float = EPS):
    """(B,) per-sample mean of matched-index negative SDRs."""
    return _neg_sdr(ests, targets, sdr_type, zero_mean, take_log, eps,
                    2).mean(dim=-1)


def singlesrc_neg_sdr(ests, targets, sdr_type="sisdr", zero_mean=True,
                      take_log=True, eps: float = EPS):
    """(B,) negative SDRs for (B, L) inputs."""
    return _neg_sdr(ests, targets, sdr_type, zero_mean, take_log, eps, 1)


pairwise_neg_sisdr = functools.partial(pairwise_neg_sdr, sdr_type="sisdr")
pairwise_neg_sdsdr = functools.partial(pairwise_neg_sdr, sdr_type="sdsdr")
pairwise_neg_snr = functools.partial(pairwise_neg_sdr, sdr_type="snr")
multisrc_neg_sisdr = functools.partial(multisrc_neg_sdr, sdr_type="sisdr")
multisrc_neg_snr = functools.partial(multisrc_neg_sdr, sdr_type="snr")
singlesrc_neg_sisdr = functools.partial(singlesrc_neg_sdr, sdr_type="sisdr")
singlesrc_neg_snr = functools.partial(singlesrc_neg_sdr, sdr_type="snr")
