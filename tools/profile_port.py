"""Profile the PyTorch port's RTFS-Net-4 forward on the GPU.

Builds the full model (weights from seed 0, float32, TF32 off as in
``chip_smoke.py``), warms it up, then traces ``--iters`` forwards of
``--batch`` 2 s requests with ``torch.profiler`` and prints: the wall time
per forward, the device time per forward, the device idle share, and the
``--top`` kernels by device time with the share of the three hand-written
kernels. Needs one CUDA card.

    python3 tools/profile_port.py --batch 8
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OWN_KERNELS = ("sru_lay0_fwd_kernel", "sru_hidden_fwd_kernel",
               "convt1d_tm_fwd_kernel")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from rtfs_tpu_torch.config import build_avnet, load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_avnet(load_config("lrs2_RTFSNet_4_layer"), device="cuda")
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((args.batch, 32000)) * 0.1)
                           .astype(np.float32)).cuda()
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
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.iters
    own_ms = sum(_device_us(e) for e in kernels
                 if any(k in e.key for k in OWN_KERNELS)) / 1e3 / args.iters
    print(f"card: {card_line()}")
    print(f"batch {args.batch}: wall {wall_ms:.3f} ms/forward (profiled), "
          f"device {dev_ms:.3f} ms/forward, idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}; hand-written kernels "
          f"{own_ms:.3f} ms ({own_ms / max(dev_ms, 1e-9):.3f} of device)")
    print(f"{'device ms/fwd':>13} {'share':>6} {'calls/fwd':>9}  kernel")
    for e in kernels[: args.top]:
        ms = _device_us(e) / 1e3 / args.iters
        print(f"{ms:13.4f} {ms / dev_ms:6.3f} {e.count / args.iters:9.1f}  "
              f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
