"""Synthetic random dataset: the smoke-train fixture.

A copy of ``rtfs_tpu/data/synthetic.py`` (reference ``local_test.py:22-35``):
random waveforms and mouth crops with the real shapes (2 s at 16 kHz, 50
frames of 88 x 88), so a train run exercises the whole system with no data
on disk. Sample ``i`` is a pure function of ``(dataset seed, i)``; the same
seeds give the JAX package's samples bit for bit. Batches stay numpy; the
train loop moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass
class SyntheticAVDataset:
    n_samples: int = 16
    n_src: int = 1
    sample_rate: int = 16000
    segment: float = 2.0
    video_frames: int = 50
    mouth_size: int = 88
    seed: int = 0

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx: int):
        """Sample ``idx`` deterministically from (self.seed, idx)."""
        rng = np.random.default_rng((self.seed, int(idx)))
        length = int(self.segment * self.sample_rate)
        src = rng.standard_normal((self.n_src, length)).astype(np.float32) * 0.1
        mouth = rng.standard_normal(
            (self.video_frames, self.mouth_size, self.mouth_size)
        ).astype(np.float32)
        return src.sum(0), src, mouth, f"synthetic_{idx}"

    def batch_index_plan(self, batch_size: int, *, shuffle: bool = True,
                         seed: int = 0, epoch: int = 0,
                         drop_last: bool = True) -> List[np.ndarray]:
        """Deterministic per-epoch plan (``AVSpeechDataset``'s rule, one
        host)."""
        order = np.arange(self.n_samples)
        rng = np.random.default_rng(seed + epoch * 7919)
        if shuffle:
            rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        return [order[s: s + batch_size] for s in range(0, stop, batch_size)]

    def collate(self, items: List[tuple]) -> dict:
        return {
            "mix": np.stack([it[0] for it in items]),
            "src": np.stack([it[1] for it in items]),
            "mouth": np.stack([it[2] for it in items]),
            "key": [it[3] for it in items],
        }

    def batches(self, batch_size: int, **plan_kwargs) -> Iterator[dict]:
        for idxs in self.batch_index_plan(batch_size, **plan_kwargs):
            yield self.collate([self[int(i)] for i in idxs])
