"""Single-file inference: separate one wav given a mouth-crop ``.npz``.

Counterpart of ``inference.py`` (reference ``inference.py:23-65``)::

    python -m rtfs_tpu_torch.inference --conf-dir log/exp/conf.json \\
        --wav mix.wav --mouth mouth.npz [--model best_model.pt] \\
        [--out-dir separated] [--cpu] [--packed-tf]

``--conf-dir`` is the ``conf.json`` that the train entry writes (or a
bundled preset name); the model bundle (``train/checkpoints.py:
export_model``) defaults to ``best_model.pt`` beside it. The AVNet and the
frozen lip backbone are built on the card (on the CPU with ``--cpu``),
take the bundle's weights, and separate the first 2 s of the wav from the
lip embedding of the mouth frames (``.npz`` key ``data``, (T, H, W) in
the uint8 range). Writes ``<out-dir>/{key}_est{i}.wav``, clipped to
[-1, 1]. ``--packed-tf`` serves through the packed-TF kernels (K5-K9).
A ``conf.json`` whose ``audionet.compute_dtype`` is ``"bfloat16"`` serves
in bf16 (``config.build_avnet``; the bundle's float32 weights rounded at
load; waveforms in and out float32), through K5-K9's bf16 entries where
``audionet.packed_tf`` or ``--packed-tf`` asks for the packed layout.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import build_avnet, build_video_model, load_config
from .data.transforms import preprocess_mouth
from .data.wav import read_wav, write_wav
from .train.checkpoints import load_exported
from .utils.separator import separate_sample


def main(argv=None) -> np.ndarray:
    """Run the entry; returns the estimates (n_src, L), before the clip of
    the written files."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--conf-dir", required=True,
                        help="conf.json of a run, or a bundled preset name")
    parser.add_argument("--wav", required=True)
    parser.add_argument("--mouth", required=True,
                        help="mouth .npz (key 'data')")
    parser.add_argument("--model", default=None,
                        help="model bundle (default: best_model.pt beside "
                             "the config)")
    parser.add_argument("--out-dir", default="separated")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--packed-tf", action="store_true",
                        help="serve through the packed-TF kernels")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    conf = load_config(args.conf_dir)
    sr = conf["data"]["sample_rate"]
    exp_dir = os.path.dirname(os.path.abspath(args.conf_dir))
    state = load_exported(args.model or os.path.join(exp_dir,
                                                     "best_model.pt"))["state"]
    model = build_avnet(conf, device)
    model.load_state_dict(state["model"])
    model.packed_tf = args.packed_tf or model.packed_tf
    video_model = build_video_model(conf, device)
    if state.get("video_model"):
        video_model.load_state_dict(state["video_model"])

    wav = read_wav(args.wav)[: sr * 2]  # 2 s, as the JAX entry truncates
    mouth = preprocess_mouth(np.load(args.mouth)["data"], train=False)
    with torch.inference_mode():
        emb = video_model(torch.from_numpy(mouth[None]).to(device))
    est = separate_sample(model, wav, emb[0])

    os.makedirs(args.out_dir, exist_ok=True)
    key = os.path.splitext(os.path.basename(args.wav))[0]
    for i, src in enumerate(est):
        out = os.path.join(args.out_dir, f"{key}_est{i + 1}.wav")
        write_wav(out, src, sr)
        print("wrote", out)
    return est


if __name__ == "__main__":
    main()
