"""Training entry of the port.

    python -m rtfs_tpu_torch.train.main --conf-dir <preset name or .json> \
        [--device cuda|cpu] [--seed N] [--checkpoint SPEC] [--x.y value ...]

Counterpart of ``train.py:54-325`` on one device: loads the config (dotted
overrides merge on top), builds the datasets, the frozen lip backbone, the
AVNet, the optimizer (AdamW after a global-norm clip of 5.0) and
``AVSystem``, and runs the epoch loop with validation, ReduceLROnPlateau /
epoch LR divide, early stopping, ``metrics.jsonl``, top-5 checkpoints with
resume, and a final ``best_model.pt`` export. Every dropout mask of the run
draws from one ``torch.Generator`` seeded from ``--seed``.

The data are the LRS2-layout files of ``data.train_dir`` and
``data.valid_dir`` (``AVSpeechDataset``; ``tools/make_synth_corpus.py``
writes such a corpus), read through the threaded ``PrefetchLoader`` with
``training.num_workers`` decode threads (default 8), each batch copied to
the device from pinned memory; or, with ``--data.synthetic true``, the
synthetic set. ``conf.json`` and the exported bundle pin the checkout's
``code_version``. Each epoch's row also gives the train loop's seconds and
steps, the seconds it waited on the loader (``loader_wait``) and, of
those, the wait for the epoch's first batch (``loader_first_wait``).

Runs on the card unless ``--device cpu``. Multi-device training, joint
video training, online mixing and TensorBoard are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..config import build_avnet, build_video_model, load_config
from ..data.dataset import AVSpeechDataset
from ..data.loader import PrefetchLoader, WaitTimer, pin_and_copy
from ..data.synthetic import SyntheticAVDataset
from ..utils.code_version import code_version
from ..utils.parser import parse_overrides
from .checkpoints import CheckpointManager, export_model, resolve_checkpoint_spec
from .optim import EpochDivideLR, ReduceLROnPlateau, get_lr, make_optimizer, set_lr
from .system import AVSystem, make_generator


def build_datasets(conf: Dict[str, Any]):
    """(train, val) sets from the ``data`` group (``train.py:24-51``): the
    synthetic set of ``synthetic_samples`` (default 64) samples, or the
    manifests of ``train_dir`` and ``valid_dir`` (audio only where the
    config has no ``videonet``)."""
    data = conf["data"]
    n_src = conf["audionet"]["n_src"]
    if data.get("synthetic"):
        n = data.get("synthetic_samples", 64)
        return (SyntheticAVDataset(n_samples=n, n_src=n_src),
                SyntheticAVDataset(n_samples=max(n // 4, 4), seed=123,
                                   n_src=n_src))
    audio_only = not conf.get("videonet")
    return tuple(
        AVSpeechDataset(data[key], n_src=n_src,
                        sample_rate=data["sample_rate"],
                        segment=data["segment"],
                        normalize_audio=data.get("normalize_audio", False),
                        audio_only=audio_only)
        for key in ("train_dir", "valid_dir"))


def build_system(conf: Dict[str, Any], device, seed: int = 0) -> AVSystem:
    """The frozen lip backbone, the AVNet (weights from ``seed``), the
    optimizer of ``conf["optim"]`` and the ``AVSystem`` over them. A bf16
    config (``audionet.compute_dtype``) trains in bf16 (``AVSystem``), in
    either layout and with either SRU."""
    optim_conf = conf["optim"]
    tconf = conf["training"]
    model = build_avnet(conf, device, seed=seed)
    optimizer = make_optimizer(
        model.parameters(), optim_conf.get("optimizer", "adamw"),
        lr=optim_conf.get("lr", 1e-3),
        weight_decay=optim_conf.get("weight_decay", 0.0), clip_grad_norm=5.0)
    return AVSystem(model, build_video_model(conf, device, seed=seed),
                    optimizer, online_mix=tconf.get("online_mix", False),
                    train_video_model=tconf.get("train_video_model", False))


def main(conf: Dict[str, Any], device: str = "cuda", seed: int = 0,
         checkpoint: Optional[str] = None) -> Dict[str, Any]:
    """Train; returns the last epoch's metrics row (None if no epoch ran).
    The system is built first, so that a config the port does not train
    (``batch_fold``, ``train_video_model``) raises NotImplementedError
    before anything is written."""
    device = torch.device(device)
    system = build_system(conf, device, seed)
    exp_dir = os.path.join(conf["log"].get("path", "log/tmp"),
                           conf["log"]["exp_name"])
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "conf.json"), "w") as f:
        # the code state beside the config (train.py:94-98)
        json.dump({**conf, "code_version": code_version()}, f, indent=2)

    train_set, val_set = build_datasets(conf)
    tconf, optim_conf = conf["training"], conf["optim"]
    batch_size = tconf["batch_size"]

    ckpt = CheckpointManager(exp_dir, top_k=5)
    start_epoch = 0
    if checkpoint:
        src, step = resolve_checkpoint_spec(checkpoint, ckpt)
        state = src.restore(step)
        if state is None:
            raise FileNotFoundError(
                f"--checkpoint={checkpoint!r}: no checkpoint found")
        system.load_state_dict(state)
        start_epoch = int(step) + 1
        print(f"resumed from epoch {step} ({checkpoint})")
    elif ckpt.latest_step() is not None:
        system.load_state_dict(ckpt.restore())
        start_epoch = ckpt.latest_step() + 1
        print(f"resumed from epoch {start_epoch - 1}")

    plateau = (ReduceLROnPlateau(factor=conf["sche"].get("factor", 0.5),
                                 patience=conf["sche"].get("patience", 10))
               if tconf.get("half_lr") else None)
    divide = EpochDivideLR(base_lr=optim_conf.get("lr", 1e-3),
                           divide_by=tconf.get("divide_lr_by"),
                           period=conf["sche"].get("patience", 0) or 0)
    generator = make_generator(seed, device)
    num_workers = tconf.get("num_workers") or 8
    train_loader, val_loader = (
        PrefetchLoader(d, batch_size, num_workers=num_workers,
                       place=pin_and_copy(device))
        for d in (train_set, val_set))
    best_val = float("inf")
    bad_epochs = 0
    patience = 15 if tconf.get("early_stop") else 10**9
    row = None
    with open(os.path.join(exp_dir, "metrics.jsonl"), "a") as metrics_log:
        for epoch in range(start_epoch, tconf["epochs"]):
            t0 = time.time()
            batches = WaitTimer(train_loader.epoch(seed=seed, epoch=epoch))
            t_train = time.perf_counter()
            train_losses = [system.train_step(batch, generator)["train_loss"]
                            for batch in batches]
            train_loss = torch.stack(train_losses).mean().item()
            t_train = time.perf_counter() - t_train
            val_losses = [system.val_step(batch)["val_loss"]
                          for batch in val_loader.epoch(shuffle=False)]
            val_loss = torch.stack(val_losses).mean().item()

            lr = get_lr(system.optimizer)
            new_lr = plateau.step(val_loss, lr) if plateau else lr
            new_lr = divide.lr_for_epoch(epoch, new_lr)
            if new_lr != lr:
                set_lr(system.optimizer, new_lr)
                print(f"lr -> {new_lr:.2e}")

            row = {"epoch": epoch, "train_loss": train_loss,
                   "val_loss": val_loss, "train_sisnr": -train_loss,
                   "val_sisnr": -val_loss, "learning_rate": lr,
                   "secs": round(time.time() - t0, 1),
                   "train_secs": t_train, "steps": batches.count,
                   "loader_wait": batches.wait,
                   "loader_first_wait": batches.first}
            print(json.dumps(row))
            metrics_log.write(json.dumps(row) + "\n")
            metrics_log.flush()
            ckpt.save(epoch, system.state_dict(), val_loss)

            if val_loss < best_val - 1e-9:
                best_val, bad_epochs = val_loss, 0
            else:
                bad_epochs += 1
                if bad_epochs > patience:
                    print(f"early stopping at epoch {epoch}")
                    break

    best = ckpt.best_step()
    if best is not None:
        state = ckpt.restore(best)
        export_model(os.path.join(exp_dir, "best_model.pt"), conf["audionet"],
                     state["model"], state["video_model"],
                     infos={"best_epoch": best,
                            "val_loss": ckpt.val_losses[best]})
        print(f"exported best model (epoch {best}) to "
              f"{exp_dir}/best_model.pt")
    return row


def cli(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--conf-dir", default="lrs2_RTFSNet_4_layer",
                        help="bundled preset name or path to a .json config")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", default=None,
                        help="epoch N, another run's dir, or dir@N")
    args, overrides = parser.parse_known_args(argv)
    conf = parse_overrides(load_config(args.conf_dir), overrides)
    return main(conf, args.device, args.seed, args.checkpoint)


if __name__ == "__main__":
    cli()
