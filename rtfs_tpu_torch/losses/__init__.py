"""Losses: permutation-invariant SDR family (counterpart of ``rtfs_tpu.losses``)."""

from .pit import PITLossWrapper, pit_loss, reorder_sources  # noqa: F401
from .sdr import (  # noqa: F401
    multisrc_neg_sisdr,
    multisrc_neg_snr,
    pairwise_neg_sdsdr,
    pairwise_neg_sisdr,
    pairwise_neg_snr,
    singlesrc_neg_sisdr,
    singlesrc_neg_snr,
)
