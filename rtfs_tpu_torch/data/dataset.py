"""AVSpeech dataset: json-manifest loader + deterministic batch plan.

Counterpart of ``rtfs_tpu/data/dataset.py`` (reference
``src/datas/avspeech_dataset.py:25-225``); the tests hold its items, plans
and batches equal to the JAX dataset's bit for bit:

- manifests ``{json_dir}/{mix,s1,s2}.json`` (``mix_clean.json`` where
  ``mix.json`` is absent, as WHAM's) of ``[wav_path, (mouth_npz,)
  n_samples]`` entries;
- ``n_src == 1`` is target-speaker extraction: each mixture contributes one
  sample per speaker (s1 and s2), so the dataset doubles; ``n_src == 2``
  pairs the sources;
- train mode (``segment`` set) drops utterances shorter than ``segment``
  seconds; both modes HARD-TRUNCATE waveforms to 2 s (reference
  ``avspeech_dataset.py:167,215``), and test batches carry each
  utterance's true ``length``;
- optional mixture-std normalization (``normalize_tensor_wav``).

WAVs are read through ``wav.read_wav`` (scipy). Items and batches are
numpy; the loader (``loader.PrefetchLoader``) moves them to the device.
The epoch order is seeded (``seed + epoch * 7919``) and host-shardable.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .transforms import preprocess_mouth
from .wav import read_wav

EPS = 1e-8


def normalize_wav(wav: np.ndarray, std: Optional[np.ndarray] = None):
    mean = wav.mean(-1, keepdims=True)
    if std is None:
        std = wav.std(-1, keepdims=True)
    return (wav - mean) / (std + EPS)


@dataclass
class AVSpeechDataset:
    json_dir: str
    n_src: int = 1
    sample_rate: int = 16000
    segment: Optional[float] = 2.0
    normalize_audio: bool = False
    audio_only: bool = False

    def __post_init__(self):
        if self.n_src not in (1, 2):
            raise ValueError(f"n_src must be 1 or 2, got {self.n_src}")
        self.seg_len = (
            int(self.segment * self.sample_rate) if self.segment else None
        )
        self.test = self.seg_len is None
        # Hard 2 s truncation (reference avspeech_dataset.py:167,215).
        self.max_len = self.sample_rate * 2

        mix_path = os.path.join(self.json_dir, "mix.json")
        if not os.path.exists(mix_path):  # wham manifests use mix_clean
            alt = os.path.join(self.json_dir, "mix_clean.json")
            if os.path.exists(alt):
                mix_path = alt
        with open(mix_path) as f:
            mix_infos = json.load(f)
        sources_infos = []
        for s in ("s1", "s2"):
            with open(os.path.join(self.json_dir, f"{s}.json")) as f:
                sources_infos.append(json.load(f))

        self.mix: List = []
        self.sources: List = []
        drop_utt = drop_len = 0
        for i, info in enumerate(mix_infos):
            if not self.test and info[1] < self.seg_len:
                drop_utt += 1
                drop_len += info[1]
                continue
            if self.n_src == 1:
                for src_inf in sources_infos:
                    self.mix.append(info)
                    self.sources.append(src_inf[i])
            else:
                self.mix.append(info)
                self.sources.append([src_inf[i] for src_inf in sources_infos])
        if drop_utt:
            print(
                f"Drop {drop_utt} utts "
                f"({drop_len / self.sample_rate / 3600:.2f} h) shorter than "
                f"{self.seg_len} samples"
            )

    def __len__(self) -> int:
        return len(self.mix)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None):
        stop = self.seg_len
        train = not self.test
        mixture = read_wav(self.mix[idx][0], stop)

        if self.n_src == 1:
            source = read_wav(self.sources[idx][0], stop)[None]
            mouth_paths = [self.sources[idx][1]]
        else:
            source = np.stack([read_wav(s[0], stop)
                               for s in self.sources[idx]])
            mouth_paths = [s[1] for s in self.sources[idx]]

        mouths = None
        if not self.audio_only:
            mouths = np.stack([
                preprocess_mouth(np.load(p)["data"], train,
                                 rng or np.random.default_rng(idx))
                for p in mouth_paths
            ])

        if self.normalize_audio:
            m_std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, std=m_std)
            source = normalize_wav(source, std=m_std)

        mixture = mixture[: self.max_len]
        source = source[..., : self.max_len]
        key = os.path.basename(self.mix[idx][0])
        if self.audio_only:
            return mixture, source, key
        return mixture, source, mouths, key

    def batch_index_plan(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
    ) -> List[np.ndarray]:
        """Deterministic per-epoch batch index plan, sharded across hosts."""
        n = len(self)
        order = np.arange(n)
        rng = np.random.default_rng(seed + epoch * 7919)
        if shuffle:
            rng.shuffle(order)
        order = order[host_id::num_hosts]
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        return [order[s: s + batch_size] for s in range(0, stop, batch_size)]

    def sample_rng(self, idx: int, seed: int,
                   epoch: int) -> np.random.Generator:
        """Per-sample augmentation rng: deterministic whatever the decode
        order or threading."""
        return np.random.default_rng((seed, epoch, int(idx)))

    def collate(self, items: List[tuple]) -> dict:
        """Assemble decoded items into one numpy batch."""
        batch = {
            "mix": _pad_stack([it[0] for it in items]),
            "src": _pad_stack([it[1] for it in items]),
        }
        if self.test:
            # true per-utterance lengths, so batched evaluation can trim
            # the zero padding before computing metrics
            batch["length"] = np.array(
                [it[0].shape[-1] for it in items], np.int32
            )
        if not self.audio_only:
            # (B, n_src, T, H, W) -> flatten speaker dim for n_src==1
            mouths = _pad_stack([it[2] for it in items])
            if self.n_src == 1:
                mouths = mouths[:, 0]
            batch["mouth"] = mouths
            batch["key"] = [it[3] for it in items]
        else:
            batch["key"] = [it[2] for it in items]
        return batch

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
    ) -> Iterator[dict]:
        """Yield numpy batches, sharded across hosts (the synchronous path;
        training reads the same plan through ``PrefetchLoader``)."""
        plan = self.batch_index_plan(
            batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
            host_id=host_id, num_hosts=num_hosts, drop_last=drop_last,
        )
        for idxs in plan:
            items = [
                self.__getitem__(int(i), self.sample_rng(i, seed, epoch))
                for i in idxs
            ]
            yield self.collate(items)


def _pad_stack(arrays):
    """Stack arrays, zero-padding trailing axes to the batch max.

    Test-time utterances (segment=None) keep native lengths up to the 2 s
    cap; batches with mixed lengths are padded so evaluation can batch, and
    the batch's ``length`` lets the caller trim each estimate back.
    """
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1:
        return np.stack(arrays)
    maxes = tuple(max(s[i] for s in shapes)
                  for i in range(len(arrays[0].shape)))
    out = np.zeros((len(arrays), *maxes), arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, d) for d in a.shape)] = a
    return out
