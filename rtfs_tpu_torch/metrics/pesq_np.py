"""Pure-numpy PESQ (ITU-T P.862-style), CPU eval metric.

A copy of ``rtfs_tpu/metrics/pesq_np.py``; the tests hold the two equal
bit for bit. The reference reports PESQ through ``pypesq``
(``src/metrics/allwrapper.py:12,55``), which the package does not depend
on; like ``stoi_np`` this module bundles an independent implementation so
``rtfs_tpu_torch.test`` always emits a real number.

Implements the P.862 perceptual model from the published algorithm
description: level alignment to a fixed listening level, cross-correlation
delay compensation, 32 ms Hann-windowed power spectra, Bark-band pitch
power densities, partial frequency/gain compensation of the reference
toward the degraded signal, Zwicker-law loudness, masked symmetric and
asymmetry-weighted disturbance densities, and the L6-within/L2-across
time aggregation, mapped to ``4.5 - 0.1*d_sym - 0.0309*d_asym`` raw MOS
clamped to [-0.5, 4.5].

VALIDATION SCOPE: this is an independent re-implementation validated on
behavioral properties (identity -> 4.5, monotonicity in SNR, level
invariance, sane ordering across distortion types — see
``tests/test_metrics.py``). ITU conformance vectors are not bundled, so
per-utterance scores may deviate from the ITU binary; rank ordering and
sensitivity are validated.
"""

from __future__ import annotations

import numpy as np

TARGET_LEVEL = 1e7  # fixed active-band power the inputs are scaled to
DYN_FLOOR = 1e-12


def _frame_spectra(x: np.ndarray, nf: int):
    """50%-overlap Hann frames -> power spectra (n_frames, nf//2+1)."""
    hop = nf // 2
    n_frames = max((len(x) - nf) // hop + 1, 0)
    if n_frames == 0:
        return np.zeros((0, nf // 2 + 1))
    w = np.hanning(nf)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nf)[None, :]
    spec = np.fft.rfft(x[idx] * w, axis=-1)
    return (spec.real**2 + spec.imag**2) / nf


def _bark_edges(fs: int, nf: int):
    """0.5-Bark-spaced band edges as rfft bin indices, plus center freqs."""

    def bark(f):
        return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)

    f_hi = min(fs / 2.0, 8000.0)
    z_lo, z_hi = bark(50.0), bark(f_hi)
    n_bands = int(np.floor((z_hi - z_lo) / 0.5))
    z_edges = z_lo + np.arange(n_bands + 1) * 0.5
    # invert bark() numerically on a dense grid
    grid = np.linspace(25.0, fs / 2.0, 4096)
    f_edges = np.interp(z_edges, bark(grid), grid)
    bins = np.clip(
        np.round(f_edges / (fs / nf)).astype(int), 1, nf // 2
    )
    # ensure strictly increasing (narrow low bands can collide on bins)
    for i in range(1, len(bins)):
        bins[i] = max(bins[i], bins[i - 1] + 1)
    centers = 0.5 * (f_edges[:-1] + f_edges[1:])
    return bins, centers


def _band_power(spectra: np.ndarray, bins: np.ndarray):
    """Sum rfft power into bark bands -> (n_frames, n_bands)."""
    n_bands = len(bins) - 1
    out = np.empty(spectra.shape[:1] + (n_bands,))
    for b in range(n_bands):
        out[:, b] = spectra[:, bins[b] : bins[b + 1]].sum(-1)
    return out


def _hearing_threshold(centers: np.ndarray):
    """Approximate absolute hearing threshold power per band (terhardt)."""
    f = centers / 1000.0
    db = (
        3.64 * f**-0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f**4
    )
    return 10.0 ** (np.clip(db, -10.0, 60.0) / 10.0)


def _loudness(P: np.ndarray, P0: np.ndarray):
    """Zwicker-law loudness density per frame/band."""
    g = 0.23
    s = (P0 / 0.5) ** g
    ratio = np.maximum(0.5 + 0.5 * P / P0, DYN_FLOOR)
    L = s * (ratio**g - 1.0)
    return np.where(P > P0, L, 0.0)


def _align(ref: np.ndarray, deg: np.ndarray, max_shift: int):
    """Whole-utterance delay compensation via envelope cross-correlation."""
    n = 1 << int(np.ceil(np.log2(len(ref) + len(deg))))
    R = np.fft.rfft(np.abs(ref), n)
    D = np.fft.rfft(np.abs(deg), n)
    xc = np.fft.irfft(D * np.conj(R), n)
    lags = np.concatenate([np.arange(0, max_shift), np.arange(-max_shift, 0)])
    vals = np.concatenate([xc[:max_shift], xc[-max_shift:]])
    delay = int(lags[np.argmax(vals)])
    if delay > 0:  # degraded lags the reference
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> float:
    """Raw PESQ MOS in [-0.5, 4.5]; higher = better quality."""
    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if fs not in (8000, 16000):
        from scipy.signal import resample_poly

        g = np.gcd(int(fs), 16000)
        ref = resample_poly(ref, 16000 // g, fs // g)
        deg = resample_poly(deg, 16000 // g, fs // g)
        fs = 16000
    nf = 512 if fs == 16000 else 256

    ref, deg = _align(ref, deg, max_shift=int(0.125 * fs))
    if len(ref) < 2 * nf:
        return float("nan")

    # level alignment: scale each to a fixed power over the speech band
    def active_power(x):
        spec = _frame_spectra(x, nf)
        f = np.fft.rfftfreq(nf, 1.0 / fs)
        band = (f >= 300.0) & (f <= 3400.0)
        return max(spec[:, band].sum() / max(len(spec), 1), DYN_FLOOR)

    ref = ref * np.sqrt(TARGET_LEVEL / active_power(ref))
    deg = deg * np.sqrt(TARGET_LEVEL / active_power(deg))

    bins, centers = _bark_edges(fs, nf)
    Pr = _band_power(_frame_spectra(ref, nf), bins)
    Pd = _band_power(_frame_spectra(deg, nf), bins)
    n_frames = min(len(Pr), len(Pd))
    Pr, Pd = Pr[:n_frames], Pd[:n_frames]

    # speech-active frames (35 dB below the loudest reference frame)
    fe = Pr.sum(-1)
    active = fe > fe.max() * 10.0 ** (-35.0 / 10.0)

    # partial frequency compensation: per-band linear fit of ref -> deg
    # over active frames, bounded [-20, 20] dB
    num = (Pd[active] + 1e3).sum(0)
    den = (Pr[active] + 1e3).sum(0)
    bandgain = np.clip(num / den, 0.01, 100.0)
    Pr_eq = Pr * bandgain[None, :]

    # short-term gain compensation of the degraded signal, bounded
    g_frame = (Pr_eq.sum(-1) + 5e5) / (Pd.sum(-1) + 5e5)
    g_frame = np.clip(g_frame, 3e-4, 5.0)
    # first-order smoothing along time
    sm = np.empty_like(g_frame)
    acc = 1.0
    for i, g in enumerate(g_frame):
        acc = 0.8 * acc + 0.2 * g
        sm[i] = acc
    Pd_eq = Pd * sm[:, None]

    P0 = _hearing_threshold(centers)[None, :]
    Lr = _loudness(Pr_eq, P0)
    Ld = _loudness(Pd_eq, P0)

    # masked disturbance
    D = Ld - Lr
    m = 0.25 * np.minimum(Ld, Lr)
    d = np.where(D > m, D - m, np.where(D < -m, D + m, 0.0))

    # asymmetry factor: added noise is worse than removed signal
    h = ((Pd_eq + 50.0) / (Pr_eq + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
    d_asym = np.abs(d) * h

    width = np.diff(_bark_edges(fs, nf)[0]).astype(np.float64)
    w = width / width.sum()
    # frequency aggregation: L3 for symmetric, L1 for asymmetric
    Dn = (np.sum((np.abs(d) ** 3) * w[None, :], -1)) ** (1.0 / 3.0)
    An = np.sum(d_asym * w[None, :], -1)

    # weight frames by (reference energy + const)^0.04, emphasize active
    fw = ((fe + 1e5) / 1e5) ** 0.04
    Dn = np.minimum(Dn / fw, 45.0)
    An = np.minimum(An / fw, 45.0)

    # time aggregation: L6 within ~320 ms intervals, L2 across intervals
    def agg(v):
        step = max(int(0.32 * fs / (nf // 2)), 1)
        ints = [
            (np.mean(v[i : i + step] ** 6)) ** (1.0 / 6.0)
            for i in range(0, len(v), step)
        ]
        return float(np.sqrt(np.mean(np.square(ints))))

    d_sym = agg(Dn)
    d_asy = agg(An)
    mos = 4.5 - 0.1 * d_sym - 0.0309 * d_asy
    return float(np.clip(mos, -0.5, 4.5))


# ---------------------------------------------------------------------------
# ITU-T P.862.1 / P.862.2 mapping: raw P.862 score -> MOS-LQO
# ---------------------------------------------------------------------------
#
# Published logistic constants (P.862.1 §4 eq. 1 for narrowband;
# P.862.2 Annex A for wideband):
#   nb:  y = 0.999 + 4.0 / (1 + exp(-1.4945 x + 4.6607))
#   wb:  y = 0.999 + 4.0 / (1 + exp(-1.3669 x + 3.8224))
# The standard's own text pins the curve's operating range: the raw-score
# domain [-0.5, 4.5] maps to MOS-LQO ~[1.02, 4.55] (nb) / ~[1.04, 4.64]
# (wb). tests/test_metrics.py asserts those endpoint anchors and the
# round-trip through the published inverse (P.862.1 eq. 2).

_P8621 = {"nb": (-1.4945, 4.6607), "wb": (-1.3669, 3.8224)}


def mos_lqo(raw: float, mode: str = "nb") -> float:
    """Map a raw P.862 score to MOS-LQO via the P.862.1/.2 logistic."""
    a, b = _P8621[mode]
    return float(0.999 + 4.0 / (1.0 + np.exp(a * float(raw) + b)))


def mos_lqo_inverse(y: float, mode: str = "nb") -> float:
    """Published inverse mapping (P.862.1 eq. 2): MOS-LQO -> raw score."""
    a, b = _P8621[mode]
    y = float(np.clip(y, 0.999 + 1e-9, 4.999 - 1e-9))
    return float((b - np.log(4.0 / (y - 0.999) - 1.0)) / (-a))


def pesq_lqo(ref: np.ndarray, deg: np.ndarray, fs: int = 16000,
             mode: str = "nb") -> float:
    """PESQ mapped to MOS-LQO (P.862.1 nb / P.862.2 wb constants)."""
    raw = pesq(ref, deg, fs)
    return float("nan") if np.isnan(raw) else mos_lqo(raw, mode)
