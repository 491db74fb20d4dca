"""Manifest builders: wav dirs -> {tr,cv,tt}/{mix,s1,s2}.json.

Counterpart of ``rtfs_tpu/data/manifests.py`` (reference
``data-preprocess/preprocess_{lrs2,lrs3,vox2,wham}.py``); the tests hold
its manifests equal to the JAX builder's. Each entry is ``[wav_path,
(mouth_npz_path,) n_samples]``; the speaker-ID -> mouth-file mapping is
dataset-specific (LRS2 splits the filename on ``_``; LRS3/VoxCeleb2 use
regexes). Run as ``python -m rtfs_tpu_torch.data.manifests --in-audio-dir
<wavs> --in-mouth-dir <npz> --out-dir <manifests> [--dataset lrs2]``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional


def _wav_len(path: str) -> int:
    """Frames in a WAV file, through scipy (mmap, no full read)."""
    from scipy.io import wavfile

    _, data = wavfile.read(path, mmap=True)
    return data.shape[0]


def _mouth_lrs2(mouth_dir, wav_file, spk):
    parts = wav_file.split("_")
    idx = {"s1": 0, "s2": 3, "s3": 6}[spk]
    return os.path.join(mouth_dir, f"{parts[idx]}_{parts[idx + 1]}.npz")


def _mouth_regex(pattern):
    p = re.compile(pattern)

    def fn(mouth_dir, wav_file, spk):
        matches = p.findall(wav_file)
        idx = {"s1": 0, "s2": 1, "s3": 2}[spk]
        return os.path.join(mouth_dir, f"{matches[idx]}.npz")

    return fn


MOUTH_RESOLVERS = {
    "lrs2": _mouth_lrs2,
    "lrs3": _mouth_regex(r".{11}_\d{5}"),
    "vox2": _mouth_regex(r"id\d{5}_.{11}_\d{5}"),
}


def preprocess_one_dir(
    in_audio_dir: str,
    out_dir: str,
    out_filename: str,
    mouth_dir: Optional[str] = None,
    mouth_resolver: Optional[Callable] = None,
):
    """Build one ``{spk}.json`` manifest for a directory of wavs."""
    in_dir = os.path.abspath(in_audio_dir)
    file_infos = []
    for wav_file in sorted(os.listdir(in_dir)):
        if not wav_file.endswith(".wav"):
            continue
        wav_path = os.path.join(in_dir, wav_file)
        n = _wav_len(wav_path)
        if out_filename == "mix" or mouth_resolver is None:
            file_infos.append((wav_path, n))
        else:
            file_infos.append(
                (wav_path, mouth_resolver(mouth_dir, wav_file, out_filename), n)
            )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_filename + ".json"), "w") as f:
        json.dump(file_infos, f, indent=4)


def preprocess_dataset(
    in_audio_dir: str,
    out_dir: str,
    dataset: str = "lrs2",
    mouth_dir: Optional[str] = None,
    splits=("tr", "cv", "tt"),
    speakers=("mix", "s1", "s2"),
):
    """Build the full manifest tree for a dataset.

    ``dataset`` in {lrs2, lrs3, vox2} resolves mouth paths; ``wham`` (or
    any audio-only set) passes ``mouth_dir=None`` and uses
    ``speakers=("mix_clean","s1","s2")`` like the reference.
    """
    resolver = MOUTH_RESOLVERS.get(dataset) if mouth_dir else None
    for split in splits:
        for spk in speakers:
            preprocess_one_dir(
                os.path.join(in_audio_dir, split, spk),
                os.path.join(out_dir, split),
                spk,
                mouth_dir=mouth_dir,
                mouth_resolver=resolver,
            )


def main():
    import argparse

    parser = argparse.ArgumentParser("AVSS manifest preprocessing")
    parser.add_argument("--in-audio-dir", required=True)
    parser.add_argument("--in-mouth-dir", default=None)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--dataset", default="lrs2",
                        choices=["lrs2", "lrs3", "vox2", "wham"])
    args = parser.parse_args()
    speakers = (
        ("mix_clean", "s1", "s2") if args.dataset == "wham"
        else ("mix", "s1", "s2")
    )
    preprocess_dataset(
        args.in_audio_dir, args.out_dir, args.dataset, args.in_mouth_dir,
        speakers=speakers,
    )


if __name__ == "__main__":
    main()
