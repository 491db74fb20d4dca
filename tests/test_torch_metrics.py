"""The port's evaluation metrics against rtfs_tpu.metrics.

``pesq_np.pesq`` and ``stoi_np.stoi`` (the port's copies) equal the JAX
package's exactly on seeded signals. ``ALLMetricsTracker`` (the port's PIT
SI-SNR / SNR through its torch losses on CPU float32 tensors) gives
``rtfs_tpu.metrics.ALLMetricsTracker``'s rows, means, stds and CSV (the
loss-signed ``sdr`` / ``sdr_i`` row quirk, the avg / std / backend footer
rows) on the same estimates: the SNR columns to 1e-4 dB (float32 sums in
another order: XLA against torch), PESQ and STOI exactly; with n_src 1
and 2, and with pypesq / pystoi installed (stand-ins) or not. About 4 s
alone (one torch thread).
"""

import csv
import sys
import types

import numpy as np
import pytest
import torch

from rtfs_tpu.metrics import ALLMetricsTracker as JTracker
from rtfs_tpu.metrics import pesq_np as jpesq_np
from rtfs_tpu.metrics import stoi_np as jstoi_np
from rtfs_tpu_torch.metrics import ALLMetricsTracker
from rtfs_tpu_torch.metrics import pesq_np, stoi_np

SR = 16000
SNR_COLUMNS = ("sdr", "sdr_i", "si-snr", "si-snr_i")
SNR_TOL = 1e-4  # dB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(n, seed):
    """A harmonic carrier under a 4 Hz syllabic envelope plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(120.0 + 20.0 * np.sin(2 * np.pi * t)) / SR
    carrier = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2)) ** 2
    x = (0.8 * carrier + 0.3 * rng.standard_normal(n)) * env
    return (0.1 * x / np.std(x)).astype(np.float32)


def _noisy(x, snr_db, seed):
    noise = np.random.default_rng(seed).standard_normal(x.shape)
    noise *= np.std(x) / np.std(noise) * 10.0 ** (-snr_db / 20.0)
    return (x + noise).astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("snr_db", [-5.0, 5.0, 20.0])
def test_pesq_and_stoi_equal_jax(fs, snr_db):
    clean = _speechlike(int(1.5 * fs), seed=int(snr_db) + fs)
    deg = _noisy(clean, snr_db, seed=2)
    got = pesq_np.pesq(clean, deg, fs)
    assert got == jpesq_np.pesq(clean, deg, fs) and np.isfinite(got)
    got = stoi_np.stoi(clean, deg, fs)
    assert got == jstoi_np.stoi(clean, deg, fs) and 0 < got < 1


def _utterances(n_src, n_utts=3):
    """Per utterance: (mix (L,), clean (n_src, L), estimate (n_src, L)),
    of unequal lengths; for n_src 2 the estimates come in swapped order,
    so PIT has a permutation to find."""
    out = []
    for u in range(n_utts):
        n = 12000 + 1600 * u
        clean = np.stack([_speechlike(n, 10 * u + s) for s in range(n_src)])
        other = _speechlike(n, 100 + u)
        mix = (clean.sum(0) + (other if n_src == 1 else 0)).astype(np.float32)
        est = np.stack([_noisy(c, 8.0 + 4 * u, 7 * u + i)
                        for i, c in enumerate(clean)])
        out.append((mix, clean, est[::-1].copy()))
    return out


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _assert_csv_equal(got, want):
    assert [r["snt_id"] for r in got] == [r["snt_id"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in SNR_COLUMNS and w[k] != "":
                assert abs(float(g[k]) - float(w[k])) <= SNR_TOL, (g, w)
            else:  # key, pesq, stoi and the backend row: the same text
                assert g[k] == w[k], (k, g, w)


def _track(tracker_cls, path, utts):
    tracker = tracker_cls(str(path), sample_rate=SR)
    for i, (mix, clean, est) in enumerate(utts):
        tracker(mix, clean, est, f"utt{i}")
    tracker.final()
    return tracker


@pytest.mark.parametrize("n_src", [1, 2])
def test_tracker_equals_jax(tmp_path, n_src):
    utts = _utterances(n_src)
    port = _track(ALLMetricsTracker, tmp_path / "port.csv", utts)
    jax_ = _track(JTracker, tmp_path / "jax.csv", utts)
    assert (port.pesq_backend, port.stoi_backend) == (
        jax_.pesq_backend, jax_.stoi_backend) == ("pesq_np", "stoi_np")
    got, want = _read_csv(tmp_path / "port.csv"), _read_csv(
        tmp_path / "jax.csv")
    _assert_csv_equal(got, want)
    assert [r["snt_id"] for r in got][-3:] == ["avg", "std", "backend"]
    assert got[-1]["pesq"] == "pesq_np" and got[-1]["stoi"] == "stoi_np"
    # the rows the tracker keeps are the CSV's rows
    assert [r["snt_id"] for r in port.rows] == [r["snt_id"] for r in got[:-3]]
    for k in SNR_COLUMNS:
        for r, w in zip(port.rows, want):
            assert abs(r[k] - float(w[k])) <= SNR_TOL
    for ours, theirs in ((port.get_mean(), jax_.get_mean()),
                         (port.get_std(), jax_.get_std())):
        assert ours.keys() == theirs.keys()
        for k in ours:
            tol = SNR_TOL if k in SNR_COLUMNS else 0.0
            assert abs(ours[k] - theirs[k]) <= tol, k
    # the reference's sign quirk: rows carry the PIT loss's sign for sdr
    # and sdr_i, the accumulators the metric's
    for r, acc in zip(port.rows, port.acc["sdr"]):
        assert r["sdr"] == -acc
    assert port.get_mean()["si-snr_i"] > 0 > float(got[0]["sdr"])


def test_tracker_prefers_pypesq_and_pystoi(tmp_path, monkeypatch):
    """With pypesq and pystoi importable (stand-ins here) both trackers
    take them, call them with the same arguments and record their names."""
    calls = []
    pypesq = types.ModuleType("pypesq")
    pypesq.pesq = lambda deg, ref, sr: calls.append("pesq") or 1.5
    pystoi = types.ModuleType("pystoi")
    pystoi.stoi = lambda clean, est, sr, extended: calls.append(
        ("stoi", extended)) or 0.25
    monkeypatch.setitem(sys.modules, "pypesq", pypesq)
    monkeypatch.setitem(sys.modules, "pystoi", pystoi)
    utts = _utterances(1, n_utts=1)
    port = _track(ALLMetricsTracker, tmp_path / "port.csv", utts)
    _track(JTracker, tmp_path / "jax.csv", utts)
    assert (port.pesq_backend, port.stoi_backend) == ("pypesq", "pystoi")
    assert calls == ["pesq", ("stoi", False)] * 2
    got = _read_csv(tmp_path / "port.csv")
    _assert_csv_equal(got, _read_csv(tmp_path / "jax.csv"))
    assert got[-1]["pesq"] == "pypesq" and got[0]["pesq"] == "1.5"
