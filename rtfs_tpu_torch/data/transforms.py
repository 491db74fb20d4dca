"""Mouth-video preprocessing (train and eval), numpy.

A copy of ``rtfs_tpu/data/transforms.py`` (reference
``src/datas/transform.py:22-167``): scale by 1/255, random (train) or
center (eval) crop to 88 x 88, random horizontal flip (train), normalise
with the LRW mean and std (0.421, 0.165). Train-time randomness comes from
an explicit ``numpy.random.Generator``, so the same generator state gives
the JAX package's crops bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

CROP_SIZE = (88, 88)
MEAN, STD = 0.421, 0.165


def center_crop(frames: np.ndarray, size: Tuple[int, int] = CROP_SIZE):
    t, h, w = frames.shape
    th, tw = size
    dh = int(round(h - th) / 2.0)
    dw = int(round(w - tw) / 2.0)
    return frames[:, dh : dh + th, dw : dw + tw]


def random_crop(frames: np.ndarray, rng: np.random.Generator,
                size: Tuple[int, int] = CROP_SIZE):
    t, h, w = frames.shape
    th, tw = size
    dh = int(rng.integers(0, h - th + 1))
    dw = int(rng.integers(0, w - tw + 1))
    return frames[:, dh : dh + th, dw : dw + tw]


def horizontal_flip(frames: np.ndarray, rng: np.random.Generator,
                    flip_ratio: float = 0.5):
    if rng.random() < flip_ratio:
        return frames[:, :, ::-1]
    return frames


def preprocess_mouth(
    frames: np.ndarray,
    train: bool,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Raw (T, H, W) frames (uint8 range) -> normalised float32 (T, 88, 88)."""
    frames = np.asarray(frames, np.float32) / 255.0
    if train:
        if rng is None:
            raise ValueError("train preprocessing needs an explicit rng")
        frames = random_crop(frames, rng)
        frames = horizontal_flip(frames, rng)
    else:
        frames = center_crop(frames)
    return ((frames - MEAN) / STD).astype(np.float32)
