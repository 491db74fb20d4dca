"""Profile the PyTorch port's RTFS-Net-4 forward or train step on the GPU.

Builds the full model (weights from seed 0, float32, TF32 off as in
``chip_smoke.py``), warms it up, then traces ``--iters`` forwards of
``--batch`` 2 s requests with ``torch.profiler`` and prints: the wall time
per forward, the device time per forward, the device idle share, and the
``--top`` kernels by device time with the share of the hand-written
kernels. Dotted overrides merge onto the preset as in the entries, e.g. the
unidirectional model (every SRU layer through K4). Needs one CUDA card.

``--train``: the train system's steps at ``--batch`` (synthetic data, as
``chip_smoke.py`` phase 6), two warm-up steps, then ``--iters`` steps,
each traced on its own: per step the wall and device time, idle share and
the device time of annotated regions (the optimizer's step), which are
not counted, since they cover kernels counted already.

Device time is ``chip_smoke.device_kernels`` of this script's own tree,
whichever tree is measured: ``--root DIR`` imports ``rtfs_tpu_torch``
from another checkout (an A/B's parent), which builds its kernels into
its own ``_build/``. ``--dump FILE`` writes each kernel's device ms and
launches a forward or step (mean over the iterations) as JSON;
``--diff A B`` prints two dumps' kernels by their difference; ``--sum
PART ..`` the device time of the kernels whose names hold each part.

    python3 tools/profile_port.py --batch 8 \\
        [--audionet.audio_params.layers.layer_1.bidirectional false ...]
    python3 tools/profile_port.py --train --batch 4 [--root DIR] \\
        [--dump chiprun_out/step.json] [--audionet.packed_tf true]
    python3 tools/profile_port.py --diff parent.json change.json
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OWN_KERNELS = ("sru_lay0_fwd_kernel", "sru_hid_fwd_kernel",
               "convt1d_tm_fwd_kernel", "sru_rec_fwd_kernel",
               "sru_rec_fwd16_kernel",
               "sru_lay0_fwd_bf16_kernel", "sru_lay0_fwd16_kernel",
               "sru_hid_fwd_bf16", "convt1d_tm_fwd_bf16")


def _own_smoke():
    """This tree's ``chip_smoke`` (the yardstick), whatever ``--root``."""
    spec = importlib.util.spec_from_file_location(
        "yardstick_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def diff(a_path: str, b_path: str, top: int) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    rows = [(b.get(k, [0.0, 0])[0] - a.get(k, [0.0, 0])[0], k)
            for k in set(a) | set(b)]
    rows.sort(key=lambda r: -abs(r[0]))
    print(f"total device ms: {sum(v[0] for v in a.values()):.3f} -> "
          f"{sum(v[0] for v in b.values()):.3f}")
    print(f"{'diff ms':>9} {'A ms':>9} {'B ms':>9} {'A n':>6} {'B n':>6}  "
          "kernel")
    for d, k in rows[:top]:
        (am, an), (bm, bn) = a.get(k, [0.0, 0]), b.get(k, [0.0, 0])
        print(f"{d:9.4f} {am:9.4f} {bm:9.4f} {an:6g} {bn:6g}  {k[:100]}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--dump")
    ap.add_argument("--diff", nargs=2)
    ap.add_argument("--sum", nargs="+", default=[],
                    help="print the device ms of the kernels whose names "
                         "hold each of these parts")
    args, overrides = ap.parse_known_args()
    if args.diff:
        return diff(*args.diff, args.top)
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    smoke = _own_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from rtfs_tpu_torch.config import build_avnet, load_config
    from rtfs_tpu_torch.utils.parser import parse_overrides

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = parse_overrides(load_config("lrs2_RTFSNet_4_layer"), overrides)
    print(f"card: {smoke.card_line()}")
    print(f"tree: {os.path.abspath(args.root)}")
    unit = "step" if args.train else "forward"
    per_iter = []  # (wall ms, kernels, annotated ms) a traced iteration
    if args.train:
        from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
        from rtfs_tpu_torch.train.main import build_system
        from rtfs_tpu_torch.train.system import make_generator

        data = SyntheticAVDataset(n_samples=args.batch * (args.iters + 2),
                                  seed=0)
        system = build_system(conf, "cuda", seed=0)
        generator = make_generator(0, "cuda")
        batches = list(data.batches(args.batch, seed=0, epoch=0))
        for batch in batches[:2]:
            system.train_step(batch, generator)
        torch.cuda.synchronize()
        for batch in batches[2:]:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                system.train_step(batch, generator)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            per_iter.append((wall_ms, *smoke.device_kernels(prof)))
    else:
        model = build_avnet(conf, device="cuda")
        rng = np.random.default_rng(0)
        wav = torch.from_numpy((rng.standard_normal((args.batch, 32000))
                                * 0.1).astype(np.float32)).cuda()
        mouth = torch.from_numpy(rng.standard_normal((args.batch, 50, 512))
                                 .astype(np.float32)).cuda()
        with torch.inference_mode():
            for _ in range(2):
                model(wav, mouth)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    model(wav, mouth)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        kernels, annotated_ms = smoke.device_kernels(prof)
        per_iter.append((wall_ms, kernels, annotated_ms))

    # {kernel: [device ms, launches]} a forward or step, over the iterations
    table = {}
    for _, kernels, _ in per_iter:
        for e in kernels:
            row = table.setdefault(e.key, [0.0, 0])
            row[0] += smoke.dev_us(e) / 1e3 / args.iters
            row[1] += e.count / args.iters
    for i, (wall_ms, kernels, annotated_ms) in enumerate(per_iter):
        n = 1 if args.train else args.iters
        dev_ms = sum(smoke.dev_us(e) for e in kernels) / 1e3
        own_ms = sum(smoke.dev_us(e) for e in kernels
                     if any(k in e.key for k in OWN_KERNELS)) / 1e3
        name = f"step {i}" if args.train else f"{args.iters} forwards"
        print(f"batch {args.batch} {name}: wall {wall_ms / n:.3f} ms/{unit} "
              f"(profiled), device {dev_ms / n:.3f} ms/{unit}, idle share "
              f"{max(0.0, 1 - dev_ms / wall_ms):.3f}; annotated regions "
              f"{annotated_ms / n:.3f} ms/{unit}, not counted; hand-written "
              f"forward kernels {own_ms / n:.3f} ms")
    dev_ms = sum(v[0] for v in table.values())
    print(f"batch {args.batch}: device {dev_ms:.3f} ms/{unit}, mean of "
          f"{args.iters}")
    print(f"{'device ms/' + unit:>14} {'share':>6} {'calls/' + unit:>10}  "
          "kernel")
    for key, (ms, calls) in sorted(table.items(), key=lambda kv: -kv[1][0])[
            : args.top]:
        print(f"{ms:14.4f} {ms / dev_ms:6.3f} {calls:10.1f}  {key[:110]}")
    for part in args.sum:
        rows = [v for k, v in table.items() if part in k]
        print(f"kernels holding {part!r}: {sum(r[0] for r in rows):.4f} "
              f"ms/{unit}, {sum(r[1] for r in rows):g} launches/{unit}")
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        with open(args.dump, "w") as f:
            json.dump(table, f, indent=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
