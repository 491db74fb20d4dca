"""Per-utterance metrics tracker + CSV reporting.

Counterpart of ``rtfs_tpu/metrics/tracker.py`` (reference
``ALLMetricsTracker``, ``src/metrics/allwrapper.py:19-125``): PIT SI-SNR
and SNR with improvement over the repeated-mixture baseline, through the
port's ``losses`` on CPU float32 tensors; running mean/std; CSV rows per
utterance plus avg, std and backend footer rows. PESQ/STOI backends
resolve lazily: pypesq / pystoi if installed, else the bundled numpy
``pesq_np`` / ``stoi_np``; the backend's name goes into every file.
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np
import torch

from ..losses import pairwise_neg_sisdr, pairwise_neg_snr, pit_loss

CSV_COLUMNS = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i", "pesq", "stoi"]


def _pesq_backend():
    """Returns (name, fn). The name is recorded into every results file so
    ITU-conformant (pypesq) and behavioral (pesq_np) scores are never
    silently mixed downstream."""
    try:
        from pypesq import pesq as _pesq

        return "pypesq", lambda est, clean, sr: float(_pesq(est, clean, sr))
    except ImportError:
        from .pesq_np import pesq as _pesq

        # pesq_np takes (ref, deg); the tracker calls (est, clean)
        return "pesq_np", lambda est, clean, sr: float(_pesq(clean, est, sr))


def _stoi_backend():
    try:
        from pystoi import stoi as _stoi

        return "pystoi", lambda clean, est, sr: float(
            _stoi(clean, est, sr, extended=False))
    except ImportError:
        from .stoi_np import stoi as _stoi

        return "stoi_np", lambda clean, est, sr: float(_stoi(clean, est, sr))


def _pit(loss_fn, ests: np.ndarray, targets: np.ndarray) -> float:
    return float(pit_loss(loss_fn, torch.from_numpy(ests),
                          torch.from_numpy(targets)))


class ALLMetricsTracker:
    def __init__(self, save_file: Optional[str] = None,
                 sample_rate: int = 16000):
        self.sample_rate = sample_rate
        self.rows = []
        self.acc = {k: [] for k in CSV_COLUMNS[1:]}
        self._csv = None
        self._writer = None
        if save_file:
            self._csv = open(save_file, "w", newline="")
            self._writer = csv.DictWriter(self._csv, fieldnames=CSV_COLUMNS)
            self._writer.writeheader()
        self.pesq_backend, self._pesq = _pesq_backend()
        self.stoi_backend, self._stoi = _stoi_backend()

    def __call__(self, mix, clean, estimate, key: str):
        """Track one utterance.

        Args:
          mix: (L,) mixture; clean/estimate: (n_src, L).
        """
        mix = np.asarray(mix, np.float32)
        clean = np.asarray(clean, np.float32)
        estimate = np.asarray(estimate, np.float32)
        est_b, clean_b = estimate[None], clean[None]
        mix_b = np.stack([mix] * clean.shape[0])[None]

        sisnr = _pit(pairwise_neg_sisdr, est_b, clean_b)
        sisnr_base = _pit(pairwise_neg_sisdr, mix_b, clean_b)
        sdr = _pit(pairwise_neg_snr, est_b, clean_b)
        sdr_base = _pit(pairwise_neg_snr, mix_b, clean_b)

        pesq_v = self._pesq(estimate[0], clean[0], self.sample_rate)
        stoi_v = self._stoi(clean[0], estimate[0], self.sample_rate)

        # CSV rows carry the raw PIT *loss* sign for sdr/sdr_i while the
        # accumulators negate it, as the reference tracker does
        # (allwrapper.py:67-80 writes sdr.item() but accumulates
        # -sdr.item()); kept bug for bug so CSVs are comparable.
        row = {
            "snt_id": key,
            "sdr": sdr,
            "sdr_i": sdr - sdr_base,
            "si-snr": -sisnr,
            "si-snr_i": -(sisnr - sisnr_base),
            "pesq": pesq_v,
            "stoi": stoi_v,
        }
        self.rows.append(row)
        if self._writer:
            self._writer.writerow(row)
        self.acc["sdr"].append(-sdr)
        self.acc["sdr_i"].append(-(sdr - sdr_base))
        self.acc["si-snr"].append(-sisnr)
        self.acc["si-snr_i"].append(-(sisnr - sisnr_base))
        self.acc["pesq"].append(pesq_v)
        self.acc["stoi"].append(stoi_v)

    def get_mean(self):
        return {k: float(np.nanmean(v)) if v else float("nan")
                for k, v in self.acc.items()}

    def get_std(self):
        return {k: float(np.nanstd(v)) if v else float("nan")
                for k, v in self.acc.items()}

    def final(self):
        if self._writer:
            mean, std = self.get_mean(), self.get_std()
            self._writer.writerow({"snt_id": "avg", **mean})
            self._writer.writerow({"snt_id": "std", **std})
            # provenance footer: which backend produced the pesq/stoi
            # columns (conformant pypesq/pystoi or the bundled behavioral
            # numpy implementations; see VALIDATION SCOPE in pesq_np.py)
            self._writer.writerow({
                "snt_id": "backend", "pesq": self.pesq_backend,
                "stoi": self.stoi_backend,
            })
            self._csv.close()
