"""WAV files in and out, through scipy.

``read_wav`` is the scipy branch of ``rtfs_tpu/data/native_wav.py:
read_wav`` (mono float32: channels averaged, int16 / int32 PCM scaled to
[-1, 1)); the JAX package's C++ decoder is host I/O the port does without.
``write_wav`` is ``inference.py:write_wav``: float32, clipped to [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_wav(path: str, max_len: Optional[int] = None) -> np.ndarray:
    """Decode one WAV to mono float32."""
    from scipy.io import wavfile

    _, wav = wavfile.read(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    else:
        wav = wav.astype(np.float32)
    return wav[:max_len] if max_len else wav


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write float32 samples, clipped to [-1, 1]."""
    from scipy.io import wavfile

    wavfile.write(path, sr, np.clip(wav, -1.0, 1.0).astype(np.float32))
