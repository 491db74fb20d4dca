"""Evaluation entry: score a model bundle on a test set.

Counterpart of ``test.py`` (reference ``test.py:24-152``)::

    python -m rtfs_tpu_torch.test --conf-dir log/exp/conf.json \\
        --test-dir <corpus>/tt [--model best_model.pt] [--batch-size N] \\
        [--save-examples N] [--cpu] [--packed-tf]

``--conf-dir`` is the ``conf.json`` that the train entry writes (or a
bundled preset name); the model bundle (``train/checkpoints.py:
export_model``) defaults to ``best_model.pt`` beside it, and a bundle
pinned to another code version draws a warning. The AVNet and the frozen
lip backbone are built on the card (on the CPU with ``--cpu``; with
``--packed-tf`` the AVNet runs the packed-TF kernels, K5-K9). The test set
(``AVSpeechDataset(test_dir, segment=None)``: whole utterances, still cut
to 2 s) goes through the model in order, ``--batch-size`` at a time, the
last batch short; each estimate is trimmed to its utterance's true length
before it is scored. Writes ``<exp>/results/metrics.csv`` (a row an
utterance, then avg, std and the PESQ/STOI backends), ``results.csv``
(mean and std a metric, and the two backends) and, with
``--save-examples N``, the first N utterances' mixture, estimates and
sources as wavs under ``results/examples/``.
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .config import build_avnet, build_video_model, load_config
from .data.dataset import AVSpeechDataset
from .data.wav import write_wav
from .metrics import ALLMetricsTracker
from .train.checkpoints import load_exported
from .utils.code_version import check_code_version


def main(argv=None) -> Dict[str, Any]:
    """Run the entry. Returns the tracker's ``rows`` (as written to
    ``metrics.csv``), ``mean`` and ``std``, the two ``backends``, and
    ``utterances``, ``secs`` (the loop) and ``forward_secs`` (from the
    batch to the estimates on the host)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--conf-dir", required=True,
                        help="conf.json of a run, or a bundled preset name")
    parser.add_argument("--test-dir", required=True,
                        help="directory of the test manifests")
    parser.add_argument("--model", default=None,
                        help="model bundle (default: best_model.pt beside "
                             "the config)")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--save-examples", type=int, default=0,
                        help="export this many example separations as wavs")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--packed-tf", action="store_true",
                        help="run the AVNet through the packed-TF kernels")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    conf = load_config(args.conf_dir)
    sr = conf["data"]["sample_rate"]
    exp_dir = os.path.dirname(os.path.abspath(args.conf_dir))
    bundle = load_exported(args.model or os.path.join(exp_dir,
                                                      "best_model.pt"))
    warn = check_code_version(bundle.get("infos", {}))
    if warn:
        print(f"WARNING: {warn}")
    state = bundle["state"]
    model = build_avnet(conf, device)
    model.load_state_dict(state["model"])
    model.packed_tf = args.packed_tf or model.packed_tf
    # audio-only evaluation (reference System(video_model=None))
    video_model = build_video_model(conf, device)
    if video_model is not None and state.get("video_model"):
        video_model.load_state_dict(state["video_model"])

    test_set = AVSpeechDataset(
        args.test_dir,
        n_src=conf["audionet"]["n_src"],
        sample_rate=sr,
        segment=None,  # whole utterances (still cut to 2 s)
        normalize_audio=conf["data"].get("normalize_audio", False),
        audio_only=video_model is None,
    )
    out_dir = os.path.join(exp_dir, "results")
    os.makedirs(out_dir, exist_ok=True)
    tracker = ALLMetricsTracker(os.path.join(out_dir, "metrics.csv"),
                                sample_rate=sr)
    examples_dir = os.path.join(out_dir, "examples")
    if args.save_examples:
        os.makedirs(examples_dir, exist_ok=True)

    n = 0
    t_fwd = 0.0
    t0 = time.perf_counter()
    for batch in test_set.batches(args.batch_size, shuffle=False,
                                  drop_last=False):
        keys = batch.pop("key")
        lengths = batch.pop("length")
        t1 = time.perf_counter()
        with torch.inference_mode():
            wav = torch.from_numpy(batch["mix"]).to(device)
            emb = None
            if video_model is not None:
                emb = video_model(torch.from_numpy(batch["mouth"]).to(device))
            ests = model(wav, emb).cpu().numpy()
        t_fwd += time.perf_counter() - t1
        for b in range(ests.shape[0]):
            # trim batch zero-padding: metrics see only real samples
            L = int(lengths[b])
            tracker(batch["mix"][b][:L], batch["src"][b][..., :L],
                    ests[b][..., :L], keys[b])
            if n < args.save_examples:
                stem = os.path.join(examples_dir, f"ex{n}_{keys[b]}")
                write_wav(stem + "_mix.wav", batch["mix"][b], sr)
                for s_i in range(ests.shape[1]):
                    write_wav(f"{stem}_est{s_i + 1}.wav", ests[b, s_i], sr)
                    write_wav(f"{stem}_src{s_i + 1}.wav", batch["src"][b, s_i],
                              sr)
            n += 1
        if n % 50 == 0:
            mean = tracker.get_mean()
            print(f"{n} utts: si-snr_i={mean['si-snr_i']:.2f} "
                  f"sdr_i={mean['sdr_i']:.2f}")
    secs = time.perf_counter() - t0

    tracker.final()
    mean, std = tracker.get_mean(), tracker.get_std()
    with open(os.path.join(out_dir, "results.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "mean", "std"])
        for k in mean:
            w.writerow([k, mean[k], std[k]])
        # backend provenance: conformant (pypesq/pystoi) or the bundled
        # behavioral numpy implementations, never silently mixed
        w.writerow(["pesq_backend", tracker.pesq_backend, ""])
        w.writerow(["stoi_backend", tracker.stoi_backend, ""])
    print("final:", {k: round(v, 3) for k, v in mean.items()},
          f"[pesq={tracker.pesq_backend}, stoi={tracker.stoi_backend}]")
    return {"rows": tracker.rows, "mean": mean, "std": std,
            "backends": (tracker.pesq_backend, tracker.stoi_backend),
            "utterances": n, "secs": secs,
            "forward_secs": t_fwd}


if __name__ == "__main__":
    main()
