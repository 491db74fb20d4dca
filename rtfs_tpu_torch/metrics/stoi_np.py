"""Pure-numpy STOI (Short-Time Objective Intelligibility), CPU eval metric.

A copy of ``rtfs_tpu/metrics/stoi_np.py``; the tests hold the two equal
bit for bit.

Implements the classical STOI measure (Taal et al., 2011) as used by the
``pystoi`` package the reference depends on (``src/metrics/allwrapper.py:13``,
``extended=False``): resample to 10 kHz, remove silent frames (40 dB range),
1/3-octave band decomposition of a 512-point STFT (25 ms frames, 50%
overlap), 384 ms (N=30 frame) segments, clipped correlation per band/segment.

This is an independent implementation from the published algorithm
description — no code is derived from pystoi.
"""

from __future__ import annotations

import numpy as np

FS = 10000
N_FRAME = 256  # 25.6 ms at 10 kHz
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30  # frames per analysis segment
BETA = -15.0  # lower SDR bound (dB)
DYN_RANGE = 40.0


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(int(fs), FS)
    return resample_poly(x, FS // g, fs // g)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """1/3-octave band matrix (num_bands, nfft//2+1)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm, cf


def _stft_frames(x: np.ndarray):
    hop = N_FRAME // 2
    n_frames = (len(x) - N_FRAME) // hop + 1
    if n_frames < 1:
        return np.zeros((0, NFFT // 2 + 1))
    w = np.hanning(N_FRAME + 2)[1:-1]
    idx = np.arange(n_frames)[:, None] * hop + np.arange(N_FRAME)[None, :]
    frames = x[idx] * w
    return np.fft.rfft(frames, NFFT, axis=-1)


def _remove_silent_frames(x, y, dyn_range=DYN_RANGE):
    hop = N_FRAME // 2
    n_frames = (len(x) - N_FRAME) // hop + 1
    w = np.hanning(N_FRAME + 2)[1:-1]
    idx = np.arange(n_frames)[:, None] * hop + np.arange(N_FRAME)[None, :]
    xf = x[idx] * w
    yf = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_kept = xf.shape[0]
    out_len = (n_kept - 1) * hop + N_FRAME if n_kept else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n_kept):
        xs[i * hop : i * hop + N_FRAME] += xf[i]
        ys[i * hop : i * hop + N_FRAME] += yf[i]
    return xs, ys


def stoi(clean: np.ndarray, estimate: np.ndarray, fs: int = 16000) -> float:
    """STOI in [0, 1]; higher = more intelligible."""
    clean = np.asarray(clean, np.float64)
    estimate = np.asarray(estimate, np.float64)
    x = _resample(clean, fs)
    y = _resample(estimate, fs)
    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME * 2:
        return float("nan")

    obm, _ = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    X = np.sqrt(obm @ (np.abs(_stft_frames(x)) ** 2).T)  # (bands, frames)
    Y = np.sqrt(obm @ (np.abs(_stft_frames(y)) ** 2).T)
    if X.shape[1] < N:
        return float("nan")

    d_sum = 0.0
    count = 0
    for m in range(N, X.shape[1] + 1):
        Xseg = X[:, m - N : m]
        Yseg = Y[:, m - N : m]
        # scale + clip (non-extended STOI)
        alpha = np.sqrt(
            np.sum(Xseg**2, axis=1, keepdims=True)
            / (np.sum(Yseg**2, axis=1, keepdims=True) + 1e-12)
        )
        Yprime = np.minimum(Yseg * alpha, Xseg * (1 + 10 ** (-BETA / 20)))
        xn = Xseg - Xseg.mean(axis=1, keepdims=True)
        yn = Yprime - Yprime.mean(axis=1, keepdims=True)
        denom = (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-12
        )
        d_sum += np.sum(np.sum(xn * yn, axis=1) / denom)
        count += NUM_BANDS
    return float(d_sum / count)
