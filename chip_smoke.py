#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtfs_tpu_torch) of RTFS-Net-4 on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one or outside the repository. Phases, any failure of which ends the run:

1. Card: name and power limit from nvidia-smi.
2. Build: nvcc compiles every ``rtfs_tpu_torch/csrc/*.cu`` for sm_90a, in
   parallel.
3. Forward kernels: each kernel of the serving path (K1 sru_dual_recurrence,
   K2 sru_hidden_layer, K3 convt1d_ola_tm) runs at the shapes the RTFS-Net-4
   forward gives it at batch 1 and 8, twice (the two outputs must be
   bit-identical), against its plain PyTorch version on the same inputs on
   the card, and is timed with CUDA events beside its float32 bound and,
   for K2 and K3, whose products run in 3xTF32 on the tensor cores, the
   bound of that route; per site, per bs-8 and per bs-1 forward, with the
   share of the bound each reaches.
4. Serving: the full RTFS-Net-4 (4 repeats, published widths, weights from
   seed 0) answers ``separate_sample`` requests of 2 s at batch 1 and 8 on
   the card. The launch counts of that run must be K1 8 / K2 24 / K3 8 per
   forward, and the output must match the same model on the CPU (where the
   port runs the kernels' plain versions) on the same weights and inputs.
5. Backward kernels: at the training shapes (the preset's batch 4, both
   DualPathRNN sites) the training forward of K1/K2 (which keeps the cell
   states c) and the backward kernels of K1, K2 and K3 run against the
   plain forward + plain backward and against torch autograd through the
   plain forward, on the same inputs on the card; the backward is timed
   per call and per step beside its bound, its plain version and, for
   K3, autograd of ``conv_transpose1d``; two calls must give the same
   bits. For K1 and K2 backward, whose scan is ``csrc/sru_scan.cuh``'s,
   it prints per site the scan's block, grid, ring depth and shared
   memory and the share of the bound.
6. Training: RTFS-Net-4 and the lip backbone are built on the card and on
   the CPU; one ``AVSystem.train_step`` at batch 1 with dropout 0, on the
   card and on the CPU in float32, is held against the same step in
   float64 on the CPU: with cuDNN off, the card's gradients must be as
   close to it as the CPU's float32 step's; with cuDNN, as the main path
   runs, within cuDNN's measured spread; loss and BatchNorm statistics in
   both. Then the
   port's train system (``rtfs_tpu_torch.train.main.build_system``, as the
   train entry builds it, with the preset's dropout) takes steps at batch 4
   on synthetic batches: launches per step must be K1/K2/K3 forward 8/24/8
   and backward 8/24/8, every loss finite and the parameters moved; it
   prints ms per step, peak memory, and one profiled step's device time,
   idle share, top kernels and the shares of K1 forward, K2 forward, K3
   forward, K1 backward and K2 backward, with each kernel's device time
   a launch.
7. Packed-TF kernels (run right after phase 3): K5 dw_conv_packed, K6
   pw_proj_packed and K7 pw_unproj_packed at the packed serving shapes
   (STFT 251 x 129, 64 hid channels, bottleneck 256, pooled 125 x 64) at
   batch 1 and 8, at their batch-4 training sites (K5's "same" forward and
   its dx: the flipped taps, pads (2, 1), no bias; K6 as K7's dx:
   contiguous w, no bias; K7 as K6's dx: w^T of K6's strided weight, no
   bias) and K6 at a bottleneck of 512 (two slices of W) at batch 1,
   each against its plain version on the same card inputs and called
   twice (bit-identical), timed with CUDA events beside its bound (K6 and
   K7, whose products run in 3xTF32 on the tensor cores: that route's,
   the SIMT-f32 one printed beside it), its plain version and one PyTorch
   call of the same function (on the layout that call takes; none for
   K5's dx, whose pads no single call takes).
   K8 spatial_down_packed and K9 spatial_up_packed at all six sites of
   their maps (pool, select, nearest and the three transposes, each the
   other kernel's dx) at batch 1, 4 and 8: against the plain version,
   two calls bit-identical, timed the same way, with the wrapper's host
   time per call; (7b, after phase 10) the profiler's device time per
   launch of each, and of K6 at its three sites; (7c, last) the
   profiler's device time per launch of K5 at its training and serving
   sites and of K7 at its serving sites and as K6's dx, beside the bound
   and the parent design's figure.
8. Serving from files (after phase 4): a seed-0 bundle, a 2 s wav and 50
   mouth frames go through ``rtfs_tpu_torch.inference.main`` on the card
   with and without ``--packed-tf`` and on the CPU with it. The packed run
   must launch K5 16 / K6 4 / K7 4 / K8 8 / K9 16 and K1 8 / K2 24 / K3 8;
   its output must match the card's standard output and the CPU's packed
   output. Then ``separate_sample`` latency at batch 1 and 8, packed and
   standard in turns on one model, and one profiled batch-1 forward of
   each.
9. Packed training (after phase 6): K5-wgrad ``dw_conv_packed_wgrad`` and
   pw-wgrad ``pw_packed_wgrad`` at the packed training shapes (batch 4)
   against their plain versions, twice (bit-identical), timed beside
   bound (pw-wgrad, a 3xTF32 product on the tensor cores: that route's,
   the SIMT-f32 one printed beside it), plain and one PyTorch call; each
   packed op's autograd Function
   (dx, dW, db through the kernels) against autograd through its plain
   forward on the same card inputs; one packed ``train_step`` at batch 1
   with dropout 0, with cuDNN and with it off, through phase 6's gates
   against phase 6's float64 and float32 CPU steps; then the train
   system with ``audionet.packed_tf`` on and the standard one take
   ``TRAIN_STEPS`` steps each at batch 4, in turns: every packed step
   must launch exactly the counts ``packed_train_launches`` derives (and
   K1/K2/K3 8/24/8 forward and backward), every loss be finite and the
   parameters move; it prints ms per step of both, peak memory, and one
   profiled packed step's device time, idle share, top kernels and the
   shares of the packed kernels, of K6 and of K1 forward. (9b, last) the
   profiler's device time per launch of K5-wgrad and of pw-wgrad (and its
   sum) at their two sites, beside the bound and the parent's figure.
10. Unidirectional (after phase 9): the preset with both DualPathRNNs'
   ``bidirectional`` false (``UNI_OVERRIDES``, applied by
   ``utils/parser.parse_overrides`` as the entries apply them), the path of
   K4 ``sru_recurrence`` (``csrc/sru_pallas.cu``). (a) K4 forward at the
   serving shapes (batch 1 and 8) and with c at batch 4, and its backward
   at batch 4, against the plain versions and autograd through the plain
   forward (forward and backward twice, bit-identical), timed beside
   bound and plain, and K4 forward at H 80 in both directions (a
   unidirectional SRU of that width); (b) ``separate_sample``
   at batch 1 and 8 launching exactly ``k4_launches`` K4 per forward and
   no other kernel, against the CPU;
   (c) the train entry with the overrides (8 synthetic samples, one
   epoch), then the serving entry on that run's ``conf.json`` and
   ``best_model.pt``, whose forward launches K4 ``k4_launches`` times;
   (d) one bs-1 step through phase 6's gates against this model's own
   float64 step, then ``TRAIN_STEPS`` steps at batch 4 launching exactly
   ``k4_launches`` K4 forward and backward each per step, with ms per
   step, peak memory and one profiled step's K4 share, together and for
   the forward and the backward (the scan of ``csrc/sru_scan.cuh``) apart,
   with their device time a launch. (10e, last) the profiler's device time
   per launch of K4 forward at the bs-8 and bs-4 sites, beside its bound
   and the parent's figure.
Wide (after phase 10): widths above the preset's, on the same kernels.
   A pair of DualPathRNNs (dim 4, dim 3) at the preset's in_chan 64,
   window 8 and 4 layers on the main path's pooled 125 x 64, at H 48 (K3
   splits its 96 input channels over the grid in two slices) and H 80
   (K2 forward splits its units in two slices, K3 its 160 input channels
   in three): K2 forward and K3 forward and backward at the bs-1 sites
   against their plain versions (two calls bit-identical), a bs-1
   forward against the CPU and a bs-4 train step through phase 6's
   gradient gates, each launching exactly what ``rnn_launches`` derives
   (K1 1 / K2 3 / K3 1 a DualPathRNN, as at the preset). K2 forward also
   at H 300 at the bs-1 sites (kernel only), where it streams its
   projection's reduction through shared memory.
11. Files (after "wide"): training from files and evaluation, the path
   of ``data.AVSpeechDataset``, ``data.PrefetchLoader`` and
   ``rtfs_tpu_torch.test``. (a) ``tools/make_synth_corpus.py`` writes a
   seed-0 LRS2-layout corpus (``FILE_CORPUS``: 32 / 2 / 5 mixtures of 2
   s), and ``shorten_mixture`` cuts one ``tt`` mixture to 1.6 s; (b) the
   loader's batches of ``tr``, copied to the card from pinned memory,
   equal the synchronous ``AVSpeechDataset.batches()`` bit for bit; (c)
   the train entry takes two epochs of the preset from ``tr`` / ``cv`` at
   batch 4 (64 samples after n_src-1 doubling, 16 steps an epoch),
   launching K1/K2/K3 8/24/8 forward and backward a step and 8/24/8 a
   validation forward, and exports ``best_model.pt``; it prints each
   epoch's seconds, wall ms a step and the loader's wait share (the
   second epoch is the measurement); (d) after one untimed call of the
   metrics, the evaluation entry scores that bundle on ``tt`` (10
   utterances) on the card at bs 1, 2 and 3 (8/24/8 a forward) and on
   the CPU at bs 1 and 3: the card's estimates (its example wavs) match
   the CPU's at bs 1 and at bs 3 (whose batches pad the short
   utterance's samples and end on a batch of one), and bs 2 (which pads
   nothing) matches bs 1, to 1e-3 of max, and every row's si-snr,
   si-snr_i, sdr and sdr_i to 1e-2 dB, stoi to 1e-3 and pesq to 2e-2; it
   prints utterances a second on the card.

The last lines are the ``kernels`` JSON object (15 kernels), the card
line, and ``{"ok": true, "device": {...}}``. TF32 is switched off for
cuDNN and matmuls before any comparison, so every float32 product is full
float32.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# float32 (non-tensor-core) operations/s. The kernels compute in float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense TF32 tensor-core operations/s; a 3xTF32 product (K2, K3 and K6
# forward, rtfs_tpu_torch/csrc/tf32x3.cuh) issues three a float32 one
TF32_OPS_PER_S = 495e12

PRESET = "lrs2_RTFSNet_4_layer"
SAMPLES = 32000  # 2 s at 16 kHz
VIDEO_FRAMES = 50
REPEATS = 4

# tolerances, max abs error against the plain version on the same card:
# K1: elementwise gate math only, expf vs torch.sigmoid rounding over T steps
# K2/K3: dot products of 64 / 512 terms summed in another order
TOL = {"sru_dual_recurrence": 1e-5, "sru_hidden_layer": 1e-4,
       "convt1d_ola_tm": 1e-4}
# serving, card vs CPU: every op of the forward runs in another order
# (cuDNN vs CPU convs, kernels vs plain loops); relative to max |output|
SERVE_REL_TOL = 1e-3
# backward kernels against the plain backward and autograd, relative to
# each output's max |value|: BPTT through T <= 118 contracting steps and
# reductions (dv, db, dW) over up to T*B = 28,500 terms in another order
BWD_REL_TOL = {"sru_dual_recurrence_bwd": 1e-4, "sru_hidden_layer_bwd": 1e-4,
               "convt1d_ola_tm_bwd": 1e-4}
# training, one step at batch 1, each float32 step held against the same
# step in float64 on the CPU: the loss relative to itself; BatchNorm
# statistics relative to max(1, |stat|); every gradient tensor with 1e-5
# of the largest gradient added (tensors whose true gradient is 0 hold
# only rounding noise). The card with cuDNN off runs the port's own code
# with native convs and is held to TRAIN_GRAD_CPU_FACTOR times the CPU
# float32 step's error on that tensor plus TRAIN_GRAD_REL_TOL of its max
# |grad|: ~100 layers of backward amplify float32 rounding, and no float32
# order does better than the CPU's error says. The card with cuDNN, as
# the main path runs it, is held to TRAIN_GRAD_CUDNN_REL_TOL of each
# tensor's max, against float64 and against the CPU's float32 step:
# cuDNN's engines with TF32 off (FFT among them) came out
# up to 25x the CPU's error from float64 (0.57% of max on the audio
# bottleneck's weight), where the same step with cuDNN off matched the CPU.
TRAIN_LOSS_REL_TOL = 1e-4
# K4 (gen-1 SRU recurrence) against its plain version on the card: the
# forward elementwise gate math only, as K1 (max abs error); the backward
# relative to each output's max, as K1's (BWD_REL_TOL)
K4_TOL = 1e-5
K4_BWD_REL_TOL = 1e-4
TRAIN_GRAD_CPU_FACTOR = 3.0
TRAIN_GRAD_REL_TOL = 1e-4
TRAIN_GRAD_CUDNN_REL_TOL = 1e-2
TRAIN_STAT_TOL = 1e-4
TRAIN_BATCH = 4  # the preset's training.batch_size
TRAIN_STEPS = 6
# packed-TF kernels against their plain versions on the card, max abs
# error on N(0, 1) inputs: K5 sums 16 taps in another order; K6/K7 dot
# products of 64 and 256 terms in another order
PACKED_TOL = {"dw_conv_packed": 1e-5, "pw_proj_packed": 1e-4,
              "pw_unproj_packed": 1e-4}
# K8 / K9 at each site of their maps, forward and transposed (the other's
# dx), max abs error against the plain version: the pool and the
# transposed nearest (K8) and the transposed pool (K9) sum up to 3 x 3
# terms in another order; select, nearest and the transposed select copy
# each value times 1 (or write 0), exactly
MAP_SITE_TOL = {"pool": 1e-5, "select": 0.0, "nearest": 0.0,
                "transposed nearest": 1e-5, "transposed pool": 1e-5,
                "transposed select": 0.0}
# the device kernels of K8 and K9, as the profiler names them
MAP_KERNEL_NAMES = {"spatial_down_packed": "spatial_down_kernel",
                    "spatial_up_packed": "spatial_up_kernel"}
# the packed weight gradients against their plain versions and the library
# call, relative to max |dW|: sums of B*T*F = 129,516 products (bs 4) in
# another order
PACKED_WGRAD_REL_TOL = 1e-4
# each packed op's Function backward (kernels) against autograd through its
# plain forward on the same card inputs, relative to each output's max:
# the same reductions as the forward and the weight gradients
PACKED_FN_REL_TOL = 1e-4
MOUTH_SIZE = 96  # raw mouth frames, center-cropped to 88 x 88


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase(name, fn, *args):
    """Run one phase, print its seconds, return its result."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def bound_ms(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32x3_bound_ms(bytes_moved: float, ops: float, product_ops: float):
    """The bound of a kernel whose ``product_ops`` of its ``ops`` run as
    3xTF32 products on the tensor cores, the rest in float32 on the SIMT
    units: the two kinds of unit work at once, so the larger of their
    times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(3 * product_ops / TF32_OPS_PER_S,
                (ops - product_ops) / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def products_bound_ms(bytes_moved: float, ops: float):
    """The bound of a kernel whose operations are all 3xTF32 products."""
    return tf32x3_bound_ms(bytes_moved, ops, ops)


def pw_wgrad_cost(positions: int, cp: int, cq: int) -> tuple:
    """pw-wgrad's bytes (each operand read once, dW written once) and
    flops over ``positions`` positions of a ``cp``- and a ``cq``-channel
    side."""
    return 4 * (positions * (cp + cq) + cp * cq), 2 * positions * cp * cq


def main_path_geometry(conf, samples: int = SAMPLES) -> dict:
    """(L, B-per-batch-item) of each DualPathRNN scan in the forward of
    ``samples``-long audio, from the preset: STFT frames, then the TDANet
    pyramid's stride-2 convs (padding (k-1)//2), then the window count of a
    stride-1 scan. tests/test_torch_avnet.py holds it against the shapes a
    forward gives the kernels."""
    a = conf["audionet"]
    edp, ap = a["enc_dec_params"], a["audio_params"]
    t = 1 + samples // edp["hop_length"]
    f = edp["win"] // 2 + 1
    k, s = ap["kernel_size"], ap["stride"]
    for _ in range(ap["upsampling_depth"] - 1):
        t = (t + 2 * ((k - 1) // 2) - k) // s + 1
        f = (f + 2 * ((k - 1) // 2) - k) // s + 1
    lay = ap["layers"]["layer_1"]
    win = lay["kernel_size"]
    return {
        "freq": (f - win + 1, t),  # dim=4: scans F, folds T into batch
        "time": (t - win + 1, f),  # dim=3: scans T, folds F into batch
        "H": lay["hid_chan"], "C": ap["hid_chan"], "k": win,
        "layers": lay["num_layers"],
    }


def packed_launches(conf) -> dict:
    """Launches of each packed-TF kernel per packed forward, from the
    preset. Every 2-D audio TDANet block with stride 2 and k > 1 (one per
    repeat) enters the packed layout at its projection (K6), runs the
    full-resolution depthwise conv and the stride-2 conv's stride-1 pass
    (K5 x 2) with its select (K8), pools the full-resolution map (K8),
    feeds the first level's fusion and concat cells (each a local K5 and
    two upsamples, K9) and leaves through the residual conv (K7).
    tests/test_torch_packed_tf.py holds it against a forward."""
    ap = conf["audionet"]["audio_params"]
    if not (ap.get("is2d") and ap["kernel_size"] > 1 and ap["stride"] == 2):
        return {}
    if ap["upsampling_depth"] < 2:
        raise ValueError("packed_tf needs upsampling_depth >= 2")
    r = ap["repeats"]
    return {"dw_conv_packed_fwd": 4 * r, "pw_proj_packed_fwd": r,
            "pw_unproj_packed_fwd": r, "spatial_down_packed_fwd": 2 * r,
            "spatial_up_packed_fwd": 4 * r}


def rnn_launches(c: int, h: int, k: int, layers: int,
                 bidirectional: bool = True) -> dict:
    """Launches of each SRU and ConvTranspose C entry in one forward of a
    DualPathRNN (stride 1) of ``c`` channels, hid ``h``, window ``k``: the
    fused stack (K1 once, K2 a hidden layer) and K3 as its tail where the
    stack applies (bidirectional, input c k not 2h), at any width;
    otherwise K4 a layer and direction. A train step launches each entry's
    backward as often."""
    dirs = 2 if bidirectional else 1
    if not (bidirectional and c * k != 2 * h):
        return {"sru_recurrence_fwd": dirs * layers}
    out = {"sru_dual_recurrence_fwd": 1, "convt1d_ola_tm_fwd": 1}
    if layers > 1:
        out["sru_hidden_layer_fwd"] = layers - 1
    return out


def k4_launches(conf) -> int:
    """Launches of K4 (``sru_recurrence_fwd``) per forward, from the preset:
    every SRU of an audio DualPathRNN that the fused stack does not take
    (unidirectional, or bidirectional with input width 2H) runs K4 once a
    layer and direction, once a repeat of the shared block. A train step
    launches as many K4 backwards. tests/test_torch_avnet_uni.py holds it
    against a forward and a train step."""
    ap = conf["audionet"]["audio_params"]
    n = 0
    for lay in ap["layers"].values():
        if lay["layer_type"] != "DualPathRNN" or lay["rnn_type"] != "SRU":
            continue
        bidir, h = lay["bidirectional"], lay["hid_chan"]
        if bidir and ap["hid_chan"] * lay["kernel_size"] != 2 * h:
            continue  # the fused stack, K1/K2
        n += (2 if bidir else 1) * lay["num_layers"]
    return n * ap["repeats"]


def packed_train_launches(conf) -> dict:
    """Launches of each packed-TF C entry per packed train step, from the
    preset: the forward's (``packed_launches``) and the backward's. Each K5
    gets its dx (K5 on the flipped taps) and its dW (K5-wgrad); K6 and K7
    each launch the other for their dx and pw-wgrad for their dW; K8's dx
    is K9 and K9's is K8, through the transposed maps. Every packed op's
    inputs need gradients (each comes from the block's parameters), so no
    backward launch is skipped. tests/test_torch_packed_train.py holds it
    against a train step."""
    f = packed_launches(conf)
    if not f:
        return {}
    pw = f["pw_proj_packed_fwd"] + f["pw_unproj_packed_fwd"]
    maps = f["spatial_down_packed_fwd"] + f["spatial_up_packed_fwd"]
    return {"dw_conv_packed_fwd": 2 * f["dw_conv_packed_fwd"],
            "dw_conv_packed_wgrad": f["dw_conv_packed_fwd"],
            "pw_proj_packed_fwd": pw, "pw_unproj_packed_fwd": pw,
            "pw_packed_wgrad": pw,
            "spatial_down_packed_fwd": maps, "spatial_up_packed_fwd": maps}


def packed_geometry(conf, samples: int = SAMPLES) -> dict:
    """Shapes of the packed segment: STFT (T, F), hid channels C, bottleneck
    Cb, kernel k, and the stride-2 level (T2, F2) the pool targets."""
    a = conf["audionet"]
    edp, ap = a["enc_dec_params"], a["audio_params"]
    t, f, k = 1 + samples // edp["hop_length"], edp["win"] // 2 + 1, \
        ap["kernel_size"]
    pad = (k - 1) // 2
    return {"T": t, "F": f, "C": ap["hid_chan"],
            "Cb": a["audio_bn_params"]["out_chan"], "k": k,
            "T2": (t + 2 * pad - k) // 2 + 1, "F2": (f + 2 * pad - k) // 2 + 1}


def _map_cost(smap, c: int, bs: int) -> tuple:
    """(bytes, flops) of a separable map: the distinct input values it
    reads (weight-0 entries are skipped), the output, the map itself;
    two flops a term."""
    ts, tw = smap.compact_t()
    rows = np.unique(ts[tw != 0])
    cols = np.unique(smap.fs[smap.fw != 0])
    n_t = (tw != 0).sum(1)          # terms per output row
    n_f = (smap.fw != 0).sum(1)     # terms per output column
    nbytes = 4 * bs * c * (len(rows) * len(cols) + smap.t_out * smap.f_out) \
        + 8 * (ts.size + smap.fs.size)
    return nbytes, 2 * bs * c * int(n_t.sum()) * int(n_f.sum())


def check_packed_kernels(conf, rng) -> dict:
    """Phase 7: K5-K7 against their plain versions at the packed serving
    shapes, batch 1 and 8, and K6 at its training site as K7's dx (batch
    4), each called twice (bit-identical), then K8 and K9
    (``check_map_kernels``); returns per kernel the max error and
    per-forward (batch 1) sums of kernel, plain, bound and library
    times."""
    import torch.nn.functional as Fn

    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    T, Fq, C, Cb, k = (g[n] for n in ("T", "F", "C", "Cb", "k"))
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    same = ((k - 1) // 2, k - 1 - (k - 1) // 2)
    pre = ((k - 1) // 2,) * 2
    t_conv, f_conv = P.dw_geometry(T, Fq, k, k, pre, pre)
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0}
           for name in (*PACKED_TOL, *MAP_KERNEL_NAMES)}
    # K6 runs its product in 3xTF32 on the tensor cores: its bound_ms is
    # that route's bound; the SIMT-f32 one is only printed
    simt_ms = {}
    for bs in (1, 8, 4):
        xp = t((bs, T, Fq * C))
        x_cl = xp.view(bs, T, Fq, C).permute(0, 3, 1, 2)  # channels_last
        x4 = t((bs, Cb, T, Fq))
        w_dw, b_dw = t((C, 1, k, k), 1.0 / k), t((C,))
        w_in, b_in = t((C, Cb, 1, 1), Cb ** -0.5), t((C,))
        w_out, b_out = t((Cb, C, 1, 1), C ** -0.5), t((Cb,))
        w_v = w_dw[:, 0].permute(1, 2, 0)  # (kT, kF, C) view, as Conv passes
        n_x, n_s = bs * T * Fq * C, bs * t_conv * f_conv * C
        dw_w = 4 * (k * k * C + C)
        m_pw = bs * T * Fq
        # (kernel, site, launches per forward, kernel call, plain call,
        #  bytes, flops, of those the 3xTF32 products' flops, library call)
        cases = [
            ("dw_conv_packed", "same", 12,
             lambda: P.dw_conv_packed(xp, w_v, b_dw, Fq, C, same, same),
             lambda: P.dw_conv_packed_plain(xp, w_v, b_dw, Fq, C, same, same),
             4 * 2 * n_x + dw_w, 2 * k * k * n_x, None,
             lambda: Fn.conv2d(x_cl, w_dw, b_dw, padding="same", groups=C)),
            ("dw_conv_packed", "pre-select", 4,
             lambda: P.dw_conv_packed(xp, w_v, b_dw, Fq, C, pre, pre),
             lambda: P.dw_conv_packed_plain(xp, w_v, b_dw, Fq, C, pre, pre),
             4 * (n_x + n_s) + dw_w, 2 * k * k * n_s, None,
             lambda: Fn.conv2d(x_cl, w_dw, b_dw, padding=pre[0], groups=C)),
            ("pw_proj_packed", "projection", 4,
             lambda: P.pw_proj_packed(x4, w_in[:, :, 0, 0].t(), b_in),
             lambda: P.pw_proj_packed_plain(x4, w_in[:, :, 0, 0].t(), b_in),
             4 * (m_pw * (Cb + C) + Cb * C + C), 2 * m_pw * Cb * C,
             2 * m_pw * Cb * C, lambda: Fn.conv2d(x4, w_in, b_in)),
            ("pw_unproj_packed", "residual", 4,
             lambda: P.pw_unproj_packed(xp, w_out[:, :, 0, 0].t(), b_out, Fq),
             lambda: P.pw_unproj_packed_plain(xp, w_out[:, :, 0, 0].t(),
                                              b_out, Fq),
             4 * (m_pw * (Cb + C) + Cb * C + Cb), 2 * m_pw * Cb * C,
             2 * m_pw * Cb * C, lambda: Fn.conv2d(x_cl, w_out, b_out)),
        ]
        if bs == 4:  # training sites: K5's "same" forward and its dx (the
            # flipped taps, pads (2, 1), no bias: no single library call
            # takes those pads), K6 as K7's dx (w contiguous, no bias) and
            # K7 as K6's dx (w^T of K6's strided weight, no bias)
            w_dx = w_out[:, :, 0, 0].contiguous()  # (Cb, C) = (w_out^T)^T
            w_lib = w_dx.t().contiguous()[:, :, None, None]
            w_fl = torch.flip(w_v, (0, 1))
            dx_pads = (k - 1 - same[0], k - 1 - same[1])
            w_in_v = w_in[:, :, 0, 0].t()  # K6's (Cb, C) view
            cases = [
                ("dw_conv_packed", "same", 0,
                 lambda: P.dw_conv_packed(xp, w_v, b_dw, Fq, C, same, same),
                 lambda: P.dw_conv_packed_plain(xp, w_v, b_dw, Fq, C, same,
                                                same),
                 4 * 2 * n_x + dw_w, 2 * k * k * n_x, None,
                 lambda: Fn.conv2d(x_cl, w_dw, b_dw, padding="same",
                                   groups=C)),
                ("dw_conv_packed", "same dx", 0,
                 lambda: P.dw_conv_packed(xp, w_fl, None, Fq, C, dx_pads,
                                          dx_pads),
                 lambda: P.dw_conv_packed_plain(xp, w_fl, None, Fq, C,
                                                dx_pads, dx_pads),
                 4 * (2 * n_x + k * k * C), 2 * k * k * n_x, None, None),
                ("pw_proj_packed", "K7 dx", 0,
                 lambda: P.pw_proj_packed(x4, w_dx, None),
                 lambda: P.pw_proj_packed_plain(x4, w_dx, None),
                 4 * (m_pw * (Cb + C) + Cb * C), 2 * m_pw * Cb * C,
                 2 * m_pw * Cb * C, lambda: Fn.conv2d(x4, w_lib)),
                ("pw_unproj_packed", "K6 dx", 0,
                 lambda: P.pw_unproj_packed(xp, w_in_v.t(), None, Fq),
                 lambda: P.pw_unproj_packed_plain(xp, w_in_v.t(), None, Fq),
                 4 * (m_pw * (Cb + C) + Cb * C), 2 * m_pw * Cb * C,
                 2 * m_pw * Cb * C,
                 lambda: Fn.conv2d(x_cl, w_in.transpose(0, 1)))]
        if bs == 1:  # K6 at K 512 (CTCNet's and TDFNet's bottleneck): W
            # in two slices; no preset of the port runs it
            k_big = 2 * P.PROJ_SLICE
            x_big = t((bs, k_big, T, Fq))
            w_big = t((C, k_big, 1, 1), k_big ** -0.5)
            cases.append(
                ("pw_proj_packed", f"K {k_big}", 0,
                 lambda: P.pw_proj_packed(x_big, w_big[:, :, 0, 0].t(), b_in),
                 lambda: P.pw_proj_packed_plain(x_big, w_big[:, :, 0, 0].t(),
                                                b_in),
                 4 * (m_pw * (k_big + C) + k_big * C + C),
                 2 * m_pw * k_big * C, 2 * m_pw * k_big * C,
                 lambda: Fn.conv2d(x_big, w_big, b_in)))
        for name, site, n, kern, plain, nbytes, nops, mm_ops, lib in cases:
            got = kern()
            again = kern()
            want = plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} ({site}, bs {bs}): two calls "
                                     "differ")
            ms = time_cuda(kern, 50)
            plain_ms = time_cuda(plain, 3, warmup=1)
            lib_ms = time_cuda(lib, 50) if lib is not None else math.nan
            f32_ms = bound_ms(nbytes, nops)[0]
            b_ms, b_by = (bound_ms(nbytes, nops) if mm_ops is None
                          else tf32x3_bound_ms(nbytes, nops, mm_ops))
            route = ("" if mm_ops is None
                     else f", 3xTF32; SIMT-f32 bound_ms={f32_ms:.5f}")
            print(f"kernel {name} bs={bs} site={site}: max_abs_err={err:.3e} "
                  f"(tol {PACKED_TOL[name]:.0e}) bit-identical=True "
                  f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} "
                  f"({b_by}{route}, {nbytes} B, {nops} flop) share of bound="
                  f"{b_ms / ms:.3f} library_ms="
                  f"{'none' if lib is None else f'{lib_ms:.5f}'}")
            if not err <= PACKED_TOL[name]:
                raise AssertionError(
                    f"{name} ({site}) disagrees with its plain version: "
                    f"{err:.3e} > {PACKED_TOL[name]:.0e}")
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if bs == 1:  # per-forward sums at batch 1
                r["ms"] += n * ms
                r["plain_ms"] += n * plain_ms
                r["bound_ms"] += n * b_ms
                r["library_ms"] += n * lib_ms
                r["bound_by"] = b_by
                if mm_ops is not None:
                    simt_ms[name] = simt_ms.get(name, 0.0) + n * f32_ms
    for name, f32 in simt_ms.items():
        r = res[name]
        print(f"kernel {name}: per bs-1 packed forward ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, 3xTF32; "
              f"SIMT-f32 bound_ms={f32:.4f}) library_ms="
              f"{r['library_ms']:.4f}")
    check_map_kernels(conf, rng, res)
    return res


def _host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call over ``iters`` back-to-back calls, not
    waiting for the card: what a call costs before its kernel can start."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def profile_map_kernels(conf, rng) -> None:
    """Phase 7b, last: the profiler's device microseconds per launch of
    K6 (its serving site at batch 1 and 8, its K7-dx site at batch 4) and
    of K8/K9 at each site and batch of phase 7 (on fresh inputs), after
    every timed phase, so that none of these profiler sessions runs before
    a host-clock or event timing."""
    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    dev = torch.device("cuda")
    w = torch.from_numpy(rng.standard_normal((g["Cb"], g["C"])).astype(
        np.float32) * g["Cb"] ** -0.5).to(dev)
    bias = torch.zeros(g["C"], device=dev)
    w_view = w.t().contiguous().t()  # strides (1, Cb), as the layer's view
    for bs, site, w_bs, b_bs in ((1, "projection", w_view, bias),
                                 (8, "projection", w_view, bias),
                                 (4, "K7 dx", w, None)):
        x4 = torch.from_numpy(rng.standard_normal(
            (bs, g["Cb"], g["T"], g["F"])).astype(np.float32)).to(dev)
        us = _device_us(functools.partial(P.pw_proj_packed, x4, w_bs, b_bs),
                        "pw_proj_kernel")
        print(f"kernel pw_proj_packed bs={bs} site={site}: device_us="
              f"{us:.3f}")
    for bs in (1, 4, 8):
        for name, site, _, smap, x, _, _ in _map_sites(conf, rng, bs):
            kern, _ = _map_calls(name, x, smap, packed_geometry(conf)["C"])
            print(f"kernel {name} bs={bs} site={site}: device_us="
                  f"{_device_us(kern, MAP_KERNEL_NAMES[name]):.3f}")


# the figures of the kernels' previous designs (PERF.md section 6, on an
# NVIDIA H100 80GB HBM3 at 700 W), printed beside their device time
PARENT_FIGURES = {
    "dw_conv_packed": "160.8 us of device a launch in a packed bs-4 step "
                      "(32 launches, 5.146 ms); 46.6 us a bs-1 launch",
    "pw_unproj_packed": "276.6 us of device a launch in a packed bs-4 step "
                        "(8 launches, 2.213 ms); K6 at the mirrored site "
                        "~106 us",
    "dw_conv_packed_wgrad": "3.2912 ms a packed bs-4 step by events, 16 "
                            "launches (~206 us a launch)",
    "pw_packed_wgrad": "2.2718 ms a packed bs-4 step by events, 8 launches "
                       "(~284 us a launch); SIMT float32",
    "sru_recurrence": "2.4664 ms a uni bs-8 forward by events, 32 launches;"
                      " ~70 us a launch of device time in a uni bs-4 step",
}


def profile_redesigned(conf, geo, rng) -> None:
    """Phases 9b and 10e, last: the profiler's device microseconds per
    launch of K5-wgrad (``dw_wgrad_kernel`` and its ``sum_partials_kernel``)
    and of pw-wgrad (``pw_wgrad_kernel`` and its sum) at their two bs-4
    sites, pw-wgrad's beside its 3xTF32 bound (bytes) and the SIMT-f32 one,
    and of K4 forward (``sru_rec_fwd_kernel``) at the
    uni bs-8 serving sites and the bs-4 training sites (with c), beside
    the bound of the call and the parent's figure; after every timed
    phase, as 7b."""
    from rtfs_tpu_torch.ops import packed_tf as P
    from rtfs_tpu_torch.ops import sru_pallas as S

    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    g = packed_geometry(conf)
    T, Fq, C, k = (g[n] for n in ("T", "F", "C", "k"))
    bs = TRAIN_BATCH
    same = ((k - 1) // 2, k - 1 - (k - 1) // 2)
    pre = ((k - 1) // 2,) * 2
    xp = t((bs, T, Fq * C))
    for site, pads in (("same", same), ("pre-select", pre)):
        t_out, f_out = P.dw_geometry(T, Fq, k, k, pads, pads)
        gg = t((bs, t_out, f_out * C))
        fn = functools.partial(P.dw_conv_packed_wgrad, xp, gg, Fq, C, (k, k),
                               pads, pads)
        us = _device_us(fn, "dw_wgrad_kernel")
        sum_us = _device_us(fn, "sum_partials_kernel")
        b_ms, b_by = bound_ms(4 * (bs * (T * Fq + t_out * f_out) * C
                                   + k * k * C), 2 * k * k * bs * t_out
                              * f_out * C)
        wg = P.dw_wgrad_geometry(bs, C, t_out, f_out, k, k)
        print(f"kernel dw_conv_packed_wgrad bs={bs} site={site}: device_us="
              f"{us:.3f} + sum {sum_us:.3f}, bound_us={b_ms * 1e3:.3f} "
              f"({b_by}), share of the bound {b_ms * 1e3 / (us + sum_us):.3f}"
              f"; grid {wg['grid']} of {wg['threads']} threads, "
              f"{wg['smem']} bytes of shared memory; parent: "
              f"{PARENT_FIGURES['dw_conv_packed_wgrad']}")
    Cb, r = g["Cb"], conf["audionet"]["audio_params"]["repeats"]
    nbytes, nops = pw_wgrad_cost(bs * T * Fq, Cb, C)
    b_ms, b_by = products_bound_ms(nbytes, nops)
    f32_ms, _ = bound_ms(nbytes, nops)
    pg = P.pw_wgrad_geometry(bs, T * Fq, Cb, C)
    step_us = 0.0
    for site, a, gg in (("K6 dW", t((bs, Cb, T, Fq)), xp),
                        ("K7 dW", xp, t((bs, Cb, T, Fq)))):
        fn = functools.partial(P.pw_packed_wgrad, a, gg)
        us = _device_us(fn, "pw_wgrad_kernel")
        sum_us = _device_us(fn, "sum_partials_kernel")
        step_us += r * (us + sum_us)
        print(f"kernel pw_packed_wgrad bs={bs} site={site}: device_us="
              f"{us:.3f} + sum {sum_us:.3f}, bound_us={b_ms * 1e3:.3f} "
              f"({b_by}, 3xTF32; SIMT-f32 {f32_ms * 1e3:.3f}), share of the "
              f"bound {b_ms * 1e3 / (us + sum_us):.3f}; grid {pg['grid']} of "
              f"{pg['threads']} threads, {pg['smem']} bytes of shared "
              f"memory; parent: {PARENT_FIGURES['pw_packed_wgrad']}")
    print(f"kernel pw_packed_wgrad per packed bs-{bs} step ({2 * r} "
          f"launches): device {step_us / 1e3:.4f} ms, bound "
          f"{2 * r * b_ms:.4f} ms (3xTF32), SIMT-f32 {2 * r * f32_ms:.4f}")
    H = geo["H"]
    vb = torch.cat([t((2, H), math.sqrt(1.0 / H)), t((2, H), 0.1)])
    for bs, with_c in ((8, False), (TRAIN_BATCH, True)):
        for site in ("freq", "time"):
            length, per_item = geo[site]
            B = bs * per_item
            u, x = t((length, 3 * H, B)), t((length, H, B))
            us = _device_us(functools.partial(S._k4_forward, u, x, vb, False,
                                              with_c), "sru_rec_fwd_kernel")
            b_ms, b_by = bound_ms(4 * (length * B * (5 + with_c) * H + 4 * H),
                                  20 * length * H * B)
            print(f"kernel sru_recurrence bs={bs} site={site} with_c="
                  f"{with_c} L={length} B={B}: device_us={us:.3f}, bound_us="
                  f"{b_ms * 1e3:.3f} ({b_by}), {us / length * 1e3:.1f} ns a "
                  f"step; parent: {PARENT_FIGURES['sru_recurrence']}")


def profile_k5_k7(conf, rng) -> None:
    """Phase 7c, last: the profiler's device microseconds per launch of K5
    (``dw_conv_packed_kernel``) at its bs-4 training sites (the "same"
    forward and its dx) and its bs-1 and bs-8 serving sites, and of K7
    (``pw_unproj_kernel``) at its serving sites (bs 1 and 8) and as K6's dx
    (bs 4), each beside the bound of the call and the parent's figure;
    after every timed phase, as 7b."""
    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    T, Fq, C, Cb, k = (g[n] for n in ("T", "F", "C", "Cb", "k"))
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    same = ((k - 1) // 2, k - 1 - (k - 1) // 2)
    pre = ((k - 1) // 2,) * 2
    w_v = t((C, k, k), 1.0 / k).permute(1, 2, 0)  # the layer's view
    w_fl = torch.flip(w_v, (0, 1))
    bias, bias_n = t((C,)), t((Cb,))
    w_out = t((Cb, C), C ** -0.5).t()             # the layer's (C, Cb) view
    w_k6dx = t((C, Cb), Cb ** -0.5)               # K6's w^T, contiguous
    for bs, site in ((4, "same"), (4, "same dx"), (1, "same"),
                     (1, "pre-select"), (8, "same"), (8, "pre-select")):
        xp = t((bs, T, Fq * C))
        if site == "same dx":
            pads, w, b = (k - 1 - same[0], k - 1 - same[1]), w_fl, None
        else:
            pads, w, b = (same if site == "same" else pre), w_v, bias
        t_out, f_out = P.dw_geometry(T, Fq, k, k, pads, pads)
        geo = P.dw_conv_geometry(bs, C, t_out, f_out, k, k)
        b_ms, b_by = bound_ms(4 * (bs * (T * Fq + t_out * f_out) * C
                                   + (k * k + 1) * C),
                              2 * k * k * bs * t_out * f_out * C)
        us = _device_us(functools.partial(P.dw_conv_packed, xp, w, b, Fq, C,
                                          pads, pads), "dw_conv_packed_kernel")
        print(f"kernel dw_conv_packed bs={bs} site={site}: device_us="
              f"{us:.3f}, bound_us={b_ms * 1e3:.3f} ({b_by}), share of the "
              f"bound {b_ms * 1e3 / us:.3f}; grid {geo['grid']} of "
              f"{geo['threads']} threads, {geo['smem']} bytes of shared "
              f"memory; parent: {PARENT_FIGURES['dw_conv_packed']}")
    for bs, site, w, b in ((1, "residual", w_out, bias_n),
                           (8, "residual", w_out, bias_n),
                           (4, "K6 dx", w_k6dx, None)):
        xp = t((bs, T, Fq * C))
        m = bs * T * Fq
        b_ms, b_by = tf32x3_bound_ms(4 * (m * (Cb + C) + Cb * C),
                                     2 * m * Cb * C, 2 * m * Cb * C)
        geo = P.pw_unproj_geometry(bs, T * Fq, C, Cb)
        us = _device_us(functools.partial(P.pw_unproj_packed, xp, w, b, Fq),
                        "pw_unproj_kernel")
        print(f"kernel pw_unproj_packed bs={bs} site={site}: device_us="
              f"{us:.3f}, bound_us={b_ms * 1e3:.3f} ({b_by}, 3xTF32), share "
              f"of the bound {b_ms * 1e3 / us:.3f}; grid {geo['grid']}, "
              f"{geo['smem']} bytes of shared memory; parent: "
              f"{PARENT_FIGURES['pw_unproj_packed']}")


def _device_us(fn, kernel: str, iters: int = 20) -> float:
    """The profiler's device microseconds per launch of ``kernel`` over
    ``iters`` calls of ``fn``; nan (not measured) when the profiler saw
    none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key
           and e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in evs)
    if count != iters:
        print(f"profiler: saw {count} launches of {kernel} in {iters} calls")
    if not count:
        return math.nan
    return sum(float(e.self_device_time_total) for e in evs) / count


def _map_sites(conf, rng, bs) -> list:
    """K8 and K9's six sites at the packed shapes and batch ``bs``, on
    fresh N(0, 1) inputs: the three forward maps (pool 251 x 129 -> 125 x
    64, the stride-2 select 250 x 128 -> 125 x 64, nearest 125 x 64 -> 251
    x 129) and their transposes (each the other kernel's dx in training),
    as (kernel, site, launches per packed forward, map, input, one PyTorch
    call of the same function and its result in the kernel's layout, or
    None where there is none)."""
    import torch.nn.functional as Fn

    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    T, Fq, C, k, T2, F2 = (g[n] for n in ("T", "F", "C", "k", "T2", "F2"))
    pre = ((k - 1) // 2,) * 2
    t_conv, f_conv = P.dw_geometry(T, Fq, k, k, pre, pre)
    pool = P.cached_map("pool", T, T2, Fq, F2)
    sel = P.cached_map("select", t_conv, T2, f_conv, F2)
    up = P.cached_map("nearest", T2, T, F2, Fq)
    dev = torch.device("cuda")
    aten = torch.ops.aten

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def cl(xp, tt, ff):  # a packed map as the channels-last (B, C, T, F)
        return xp.view(xp.shape[0], tt, ff, C).permute(0, 3, 1, 2)

    def packed(y):  # a library's (B, C, T, F) result in the packed layout
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], y.shape[2], -1)

    xp, xs, x2 = t((bs, T, Fq * C)), t((bs, t_conv, f_conv * C)), \
        t((bs, C, T2, F2))
    gp, g2 = t((bs, T, Fq * C)), t((bs, C, T2, F2))
    return [
        ("spatial_down_packed", "pool", 4, pool, xp,
         lambda: Fn.adaptive_avg_pool2d(cl(xp, T, Fq), (T2, F2)),
         lambda y: y),
        ("spatial_down_packed", "select", 4, sel, xs,
         lambda: cl(xs, t_conv, f_conv)[:, :, ::2, ::2].contiguous(),
         lambda y: y),
        ("spatial_up_packed", "nearest", 16, up, x2,
         lambda: Fn.interpolate(x2, size=(T, Fq), mode="nearest"), packed),
        ("spatial_down_packed", "transposed nearest", 0, up.transposed(F2),
         gp, lambda: aten.upsample_nearest2d_backward(
             cl(gp, T, Fq), [T, Fq], [bs, C, T2, F2]),
         lambda y: y),
        ("spatial_up_packed", "transposed pool", 0, pool.transposed(Fq), g2,
         lambda: aten._adaptive_avg_pool2d_backward(g2, cl(xp, T, Fq)),
         packed),
        ("spatial_up_packed", "transposed select", 0,
         sel.transposed(f_conv), g2, None, None),
    ]


def _map_calls(name, x, smap, c) -> tuple:
    """(the op's call, its plain version's call) of K8 or K9 on ``x``."""
    from rtfs_tpu_torch.ops import packed_tf as P

    if name == "spatial_up_packed":
        return (functools.partial(P.spatial_up_packed, x, smap),
                functools.partial(P.spatial_up_packed_plain, x, smap))
    return (functools.partial(P.spatial_down_packed, x, smap, c),
            functools.partial(P.spatial_down_packed_plain, x, smap, c))


def check_map_kernels(conf, rng, res) -> None:
    """Phase 7, K8 and K9: each site of ``_map_sites`` at batch 1, 4 and
    8: against the plain version to ``MAP_SITE_TOL``, two calls
    bit-identical; timed per call with CUDA events beside the bound, the
    plain version, the wrapper's host time per call (and that of
    ``kernel_lib.launch`` alone) and the PyTorch call (and its host
    time). Adds the forward sites' bs-1 sums per packed forward to
    ``res``."""
    from rtfs_tpu_torch.ops import kernel_lib

    C = packed_geometry(conf)["C"]
    dev = torch.device("cuda")
    for bs in (1, 4, 8):
        for name, site, n, smap, x, lib, lib_out in _map_sites(conf, rng,
                                                               bs):
            up_ = name == "spatial_up_packed"
            kern, plain = _map_calls(name, x, smap, C)
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            same = torch.equal(got, again)
            ms = time_cuda(kern, 50)
            plain_ms = time_cuda(plain, 3, warmup=1)
            host_us = _host_us(kern)
            # kernel_lib.launch alone (the ctypes call and the stream), its
            # arguments made once, into the same output
            ptrs, ints = smap.launch_args(
                up_, C, x.shape[3] if up_ else x.shape[2] // C, dev)
            launch_us = _host_us(functools.partial(
                kernel_lib.launch, "packed_tf",
                "spatial_up_packed_fwd" if up_ else "spatial_down_packed_fwd",
                dev, x.data_ptr(), got.data_ptr(), *ptrs, bs, *ints))
            nbytes, nops = _map_cost(smap, C, bs)
            b_ms, b_by = bound_ms(nbytes, nops)
            if lib is None:
                lib_ms, lib_txt = None, "library_ms=none (no PyTorch call)"
            else:
                lib_err = (lib_out(lib()) - want).abs().max().item()
                lib_ms = time_cuda(lib, 50)
                lib_txt = (f"library_ms={lib_ms:.5f} library_host_us="
                           f"{_host_us(lib):.2f} (library vs plain "
                           f"{lib_err:.3e})")
            print(f"kernel {name} bs={bs} site={site}: max_abs_err={err:.3e}"
                  f" (tol {MAP_SITE_TOL[site]:.0e}) bit-identical={same} "
                  f"ms={ms:.5f} host_us={host_us:.2f}"
                  f" launch_host_us={launch_us:.2f}"
                  f" plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}, "
                  f"{nbytes} B, {nops} flop) {lib_txt}")
            if not err <= MAP_SITE_TOL[site]:
                raise AssertionError(
                    f"{name} ({site}, bs {bs}) disagrees with its plain "
                    f"version: {err:.3e} > {MAP_SITE_TOL[site]:.0e}")
            if not same:
                raise AssertionError(f"{name} ({site}, bs {bs}): two calls "
                                     "differ")
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if bs == 1 and n:  # per-forward sums at batch 1
                r["ms"] += n * ms
                r["plain_ms"] += n * plain_ms
                r["bound_ms"] += n * b_ms
                r["library_ms"] += n * lib_ms
                r["bound_by"] = b_by


def check_kernels(geo, rng) -> dict:
    """Phase 3: every forward kernel against its plain version at the main
    path's shapes, called twice (the two outputs must be bit-identical);
    returns per kernel the max error and per-forward (batch 8) sums of
    kernel, plain, bound and library times, and for K2 and K3 the bound
    of their 3xTF32 products."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    H, C, k = geo["H"], geo["C"], geo["k"]
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    vb = torch.cat([t((2, 2, H), math.sqrt(1.0 / H)), t((2, 2, H), 0.1)],
                   dim=1).reshape(8, H)
    wt = t((6 * H, 2 * H), math.sqrt(1.0 / (2 * H)))
    w3 = t((k, C, 2 * H), math.sqrt(1.0 / (2 * H * k)))
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": None, "bound_by": None}
           for name in TOL}
    # K2/K3 forward run their products in 3xTF32 on the tensor cores: their
    # bound_ms is that route's bound; the SIMT-f32 one is only printed
    simt_ms = {"sru_hidden_layer": 0.0, "convt1d_ola_tm": 0.0}
    per_forward = {"sru_dual_recurrence": REPEATS,
                   "sru_hidden_layer": REPEATS * (geo["layers"] - 1),
                   "convt1d_ola_tm": REPEATS}
    bs1 = {}  # per bs-1 forward: (ms, bound_ms)

    for bs in (1, 8):
        for site in ("freq", "time"):
            length, per_item = geo[site]
            bsz = bs * per_item
            # (kernel, plain, inputs, bytes, flops, of those the products'
            #  flops, library call)
            cases = {
                "sru_dual_recurrence": (
                    sru_fused.sru_dual_recurrence,
                    sru_fused.sru_dual_recurrence_plain,
                    (t((length, 4 * H, bsz)), t((length, 4 * H, bsz)), vb),
                    4 * (2 * length * 4 * H * bsz + 2 * length * H * bsz),
                    2 * length * H * bsz * 20, None, None),
                "sru_hidden_layer": (
                    sru_fused.sru_hidden_layer,
                    sru_fused.sru_hidden_layer_plain,
                    (t((length, H, bsz), 0.5), t((length, H, bsz), 0.5),
                     wt, vb),
                    4 * (4 * length * H * bsz + wt.numel() + vb.numel()),
                    2 * length * bsz * (3 * H * 2 * H * 2 + 20 * H),
                    2 * length * bsz * 3 * H * 2 * H * 2, None),
                "convt1d_ola_tm": (
                    convt_tm.convt1d_ola_tm,
                    convt_tm.convt1d_ola_tm_plain,
                    (t((length, 2 * H, bsz)), w3),
                    4 * (length * 2 * H * bsz + w3.numel()
                         + (length + k - 1) * C * bsz),
                    2 * length * k * 2 * H * C * bsz,
                    2 * length * k * 2 * H * C * bsz,
                    "conv_transpose1d"),
            }
            for name, (kern, plain, args, nbytes, nops, mm_ops,
                       lib) in cases.items():
                got = kern(*args)
                again = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                got = torch.stack(got) if isinstance(got, tuple) else got
                again = (torch.stack(again) if isinstance(again, tuple)
                         else again)
                want = torch.stack(want) if isinstance(want, tuple) else want
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: two calls differ")
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                ms = time_cuda(lambda: kern(*args), 50)
                plain_ms = time_cuda(lambda: plain(*args), 3, warmup=1)
                f32_ms = bound_ms(nbytes, nops)[0]
                b_ms, b_by = (bound_ms(nbytes, nops) if mm_ops is None
                              else tf32x3_bound_ms(nbytes, nops, mm_ops))
                lib_ms = None
                if lib:
                    x_lib = args[0].permute(2, 1, 0).contiguous()
                    w_lib = args[1].permute(2, 1, 0).contiguous()
                    lib_ms = time_cuda(
                        lambda: torch.nn.functional.conv_transpose1d(
                            x_lib, w_lib), 50)
                route = ("" if mm_ops is None
                         else f", 3xTF32; SIMT-f32 bound_ms={f32_ms:.5f}")
                print(f"kernel {name} bs={bs} site={site} L={length} "
                      f"B={bsz}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                      f"(tol {TOL[name]:.0e}) ms={ms:.5f} plain_ms="
                      f"{plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}{route}) "
                      f"share of bound={b_ms / ms:.3f} library_ms={lib_ms}; "
                      "two calls bit-identical")
                if not err <= TOL[name]:
                    raise AssertionError(
                        f"{name} disagrees with its plain version: "
                        f"{err:.3e} > {TOL[name]:.0e}")
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if bs == 1:
                    ms_sum, b_sum = bs1.get(name, (0.0, 0.0))
                    bs1[name] = (ms_sum + per_forward[name] * ms,
                                 b_sum + per_forward[name] * b_ms)
                if bs == 8:  # per-forward sums at batch 8
                    n = per_forward[name]
                    r["ms"] += n * ms
                    r["plain_ms"] += n * plain_ms
                    r["bound_ms"] += n * b_ms
                    r["bound_by"] = b_by
                    if name in simt_ms:
                        simt_ms[name] += n * f32_ms
                    if lib_ms is not None:
                        r["library_ms"] = (r["library_ms"] or 0.0) + n * lib_ms
    for name, r in res.items():
        route = ("" if name not in simt_ms else
                 f", 3xTF32; SIMT-f32 bound_ms={simt_ms[name]:.4f}")
        print(f"kernel {name}: per bs-8 forward ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}{route}) "
              f"share of bound={r['bound_ms'] / r['ms']:.3f} "
              f"plain_ms={r['plain_ms']:.2f} library_ms={r['library_ms']}; "
              f"per bs-1 forward ms={bs1[name][0]:.4f} "
              f"bound_ms={bs1[name][1]:.4f}")
    return res


# launches of K1/K2/K3 per standard forward
SERVE_LAUNCHES = {"sru_dual_recurrence_fwd": 2 * REPEATS,
                  "sru_hidden_layer_fwd": 2 * REPEATS * 3,
                  "convt1d_ola_tm_fwd": 2 * REPEATS}


def serve(conf, rng, expect, label="serving") -> dict:
    """Phase 4 (and 10): the port's serving entry on the card, held
    against the same model on the CPU; the launches per forward must be
    exactly ``expect``. Returns the launch counts."""
    from rtfs_tpu_torch.config import build_avnet
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.utils.separator import separate_sample

    t0 = time.perf_counter()
    model = build_avnet(conf, device="cuda", seed=0)
    cpu_model = build_avnet(conf, device="cpu", seed=0)
    print(f"{label}: built RTFS-Net-4 ({REPEATS} repeats, "
          f"{sum(p.numel() for p in model.parameters())} params) on cuda and "
          f"cpu in {time.perf_counter() - t0:.3f} s")
    requests = {}
    for bs in (1, 8):
        wav = (rng.standard_normal((bs, SAMPLES)) * 0.1).astype(np.float32)
        mouth = rng.standard_normal((bs, VIDEO_FRAMES, 512)).astype(np.float32)
        requests[bs] = (wav, mouth)

    # the main path: counts from 0, the batch-1 and batch-8 requests, read
    kernel_lib.reset_launches()
    outs = {bs: separate_sample(model, *requests[bs]) for bs in (1, 8)}
    torch.cuda.synchronize()
    launches = dict(kernel_lib.LAUNCHES)
    n_fwd = len(requests)
    print(f"{label}: launches over {n_fwd} forwards: {launches}; per forward "
          f"{ {k: v / n_fwd for k, v in launches.items()} }")
    if launches != {k: n_fwd * v for k, v in expect.items()}:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect} per forward")

    for bs, (wav, mouth) in requests.items():
        got = outs[bs]
        if got.shape != (bs, 1, SAMPLES) or not np.isfinite(got).all():
            raise AssertionError(f"bs {bs}: bad output {got.shape}")
        t0 = time.perf_counter()
        want = separate_sample(cpu_model, wav, mouth)
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        print(f"{label}: bs={bs} card vs cpu max_abs_err={err:.3e} "
              f"max|out|={scale:.3e} (tol {SERVE_REL_TOL:.0e} * max|out|); "
              f"cpu forward {cpu_s:.3f} s")
        if not err <= SERVE_REL_TOL * scale:
            raise AssertionError(f"{label} bs {bs}: card and CPU outputs "
                                 "disagree")

    timing = {}
    for bs, iters in ((1, 20), (8, 10)):
        wav, mouth = requests[bs]
        separate_sample(model, wav, mouth)  # warm
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            separate_sample(model, wav, mouth)  # ends in a host copy
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        timing[bs] = med
        print(f"{label}: bs={bs} request latency median={med * 1e3:.3f} ms "
              f"min={min(times) * 1e3:.3f} ms max={max(times) * 1e3:.3f} ms "
              f"over {iters}; audio s/s={bs * SAMPLES / 16000 / med:.3f}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def serve_packed(conf, rng) -> dict:
    """Phase 8: the serving entry from files on the card, packed and
    standard, and on the CPU packed; returns the launch counts of the
    card's packed run (the main path of the packed kernels)."""
    import os
    import tempfile

    from rtfs_tpu_torch import inference
    from rtfs_tpu_torch.config import build_avnet, build_video_model
    from rtfs_tpu_torch.data.wav import write_wav
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train.checkpoints import export_model

    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "conf.json"), "w") as f:
            json.dump(conf, f)
        export_model(os.path.join(root, "best_model.pt"), conf["audionet"],
                     build_avnet(conf, device="cpu", seed=0).state_dict(),
                     build_video_model(conf, device="cpu", seed=0).state_dict())
        wav = (rng.standard_normal(SAMPLES) * 0.1).astype(np.float32)
        write_wav(os.path.join(root, "mix.wav"), wav, 16000)
        mouth = rng.integers(0, 256, (VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE),
                             dtype=np.uint8)
        np.savez(os.path.join(root, "mouth.npz"), data=mouth)

        def run(*extra):
            t0 = time.perf_counter()
            out = inference.main([
                "--conf-dir", os.path.join(root, "conf.json"),
                "--wav", os.path.join(root, "mix.wav"),
                "--mouth", os.path.join(root, "mouth.npz"),
                "--out-dir", os.path.join(root, "out"), *extra])
            return out, time.perf_counter() - t0

        std, std_s = run()
        # the main path of K5-K9: counts from 0, the packed entry run, read
        kernel_lib.reset_launches()
        packed, packed_s = run("--packed-tf")
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)
        cpu, cpu_s = run("--packed-tf", "--cpu")
    expect = {**SERVE_LAUNCHES, **packed_launches(conf)}
    print(f"serving from files: packed entry launches {launches} (expected "
          f"{expect}); entry wall s: card {std_s:.3f}, card packed "
          f"{packed_s:.3f}, cpu packed {cpu_s:.3f}")
    if launches != expect:
        raise AssertionError(f"packed entry launches {launches} != {expect}")
    if packed.shape != (1, SAMPLES) or not np.isfinite(packed).all():
        raise AssertionError(f"packed entry: bad output {packed.shape}")
    for label, want in (("card standard", std), ("cpu packed", cpu)):
        err = float(np.abs(packed - want).max())
        scale = float(np.abs(want).max())
        print(f"serving from files: card packed vs {label} max_abs_err="
              f"{err:.3e} max|out|={scale:.3e} (tol {SERVE_REL_TOL:.0e} * "
              "max|out|)")
        if not err <= SERVE_REL_TOL * scale:
            raise AssertionError(f"card packed and {label} outputs disagree")
    return launches


def packed_latency(conf, rng) -> None:
    """Phase 8, continued: ``separate_sample`` latency of one model on the
    card, packed and standard in turns, at batch 1 and 8, and one profiled
    batch-1 forward of each."""
    from torch.profiler import ProfilerActivity, profile

    from rtfs_tpu_torch.config import build_avnet
    from rtfs_tpu_torch.utils.separator import separate_sample

    model = build_avnet(conf, device="cuda", seed=0)
    for bs, iters in ((1, 20), (8, 10)):
        wav = (rng.standard_normal((bs, SAMPLES)) * 0.1).astype(np.float32)
        mouth = rng.standard_normal((bs, VIDEO_FRAMES, 512)).astype(np.float32)
        times = {False: [], True: []}
        for packed in (False, True):  # warm
            model.packed_tf = packed
            separate_sample(model, wav, mouth)
        for i in range(2 * iters):  # standard, packed, packed, standard, ...
            packed = (i % 4) in (1, 2)
            model.packed_tf = packed
            t0 = time.perf_counter()
            separate_sample(model, wav, mouth)
            times[packed].append(time.perf_counter() - t0)
        for packed in (False, True):
            ts = times[packed]
            med = statistics.median(ts)
            print(f"serving latency: bs={bs} {'packed' if packed else 'standard'}"
                  f" median={med * 1e3:.3f} ms min={min(ts) * 1e3:.3f} ms "
                  f"max={max(ts) * 1e3:.3f} ms over {len(ts)}; audio s/s="
                  f"{bs * SAMPLES / 16000 / med:.3f}")

    wav = (rng.standard_normal((1, SAMPLES)) * 0.1).astype(np.float32)
    mouth = rng.standard_normal((1, VIDEO_FRAMES, 512)).astype(np.float32)
    for packed in (False, True):
        model.packed_tf = packed
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            separate_sample(model, wav, mouth)
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (getattr(e, "self_device_time_total", 0) or 0) > 0]
        evs.sort(key=lambda e: e.self_device_time_total, reverse=True)
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        print(f"serving profile: bs=1 {'packed' if packed else 'standard'} "
              f"forward wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms, idle "
              f"share {max(0.0, 1 - dev_ms / wall_ms):.3f}")
        for e in evs[:8]:
            print(f"serving profile: top kernel "
                  f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
                  f"{e.key[:90]}")



def _max_err(got, want) -> tuple:
    """(max abs error, max |want|) over paired tensors."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    return err, scale


# the backward ops whose scan is csrc/sru_scan.cuh's, over both directions
SCAN_DIRS = ("sru_dual_recurrence_bwd", "sru_hidden_layer_bwd")


def check_backward_kernels(geo, rng, fwd_res) -> dict:
    """Phase 5: the training forward (with c) and the backward kernels at
    the training shapes against the plain versions and autograd; returns
    per backward kernel the max error and per-train-step (batch 4) sums of
    kernel, plain, bound and library times. The forward-with-c errors join
    the forward entries' ``max_abs_err`` in ``fwd_res``."""
    from rtfs_tpu_torch.ops import convt_tm, sru_fused

    H, C, k = geo["H"], geo["C"], geo["k"]
    dev = torch.device("cuda")

    def t(shape, scale=1.0, grad=False):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).requires_grad_(grad)

    # launches per train step at each of the two sites
    per_site = {"sru_dual_recurrence_bwd": REPEATS,
                "sru_hidden_layer_bwd": REPEATS * (geo["layers"] - 1),
                "convt1d_ola_tm_bwd": REPEATS}
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": None}
           for name in per_site}
    for site in ("freq", "time"):
        length, per_item = geo[site]
        B = TRAIN_BATCH * per_item
        vb = t((8, H), 0.3, True)
        u = (t((length, 4 * H, B), 1.0, True), t((length, 4 * H, B), 1.0, True))
        x = (t((length, H, B), 0.5, True), t((length, H, B), 0.5, True))
        wt = t((6 * H, 2 * H), math.sqrt(1.0 / (2 * H)), True)
        dh = (t((length, H, B)), t((length, H, B)))
        x3 = t((length, 2 * H, B), 1.0, True)
        w3 = t((k, C, 2 * H), math.sqrt(1.0 / (2 * H * k)), True)
        g3 = t((length + k - 1, C, B))
        d = lambda a: a.detach()  # noqa: E731

        with torch.no_grad():
            f1 = sru_fused._k1_forward(*map(d, u), d(vb), with_c=True)
            f2 = sru_fused._k2_forward(*map(d, x), d(wt), d(vb), with_c=True)
        cases = {
            "sru_dual_recurrence_bwd": (
                "sru_dual_recurrence", f1,
                sru_fused.sru_dual_recurrence_plain(*map(d, u), d(vb), True),
                lambda: sru_fused._k1_backward(*map(d, u), d(vb), f1[2],
                                               f1[3], *dh),
                lambda: sru_fused.sru_dual_recurrence_bwd_plain(
                    *map(d, u), d(vb), f1[2], f1[3], *dh),
                lambda: sru_fused.sru_dual_recurrence_plain(*u, vb),
                (*u, vb), dh,
                # u, c, dh read; du written (both directions); ~30 flops a
                # (step, unit, column, direction)
                4 * (2 * length * 4 * H * B * 2 + 2 * length * H * B * 2
                     + 16 * H),
                2 * length * H * B * 30, None),
            "sru_hidden_layer_bwd": (
                "sru_hidden_layer", f2,
                sru_fused.sru_hidden_layer_plain(*map(d, x), d(wt), d(vb),
                                                 True),
                lambda: sru_fused._k2_backward(*map(d, x), d(wt), d(vb),
                                               f2[2], f2[3], *dh),
                lambda: sru_fused.sru_hidden_layer_bwd_plain(
                    *map(d, x), d(wt), d(vb), f2[2], f2[3], *dh),
                lambda: sru_fused.sru_hidden_layer_plain(*x, wt, vb),
                (*x, wt, vb), dh,
                # x, c, dh read, dx written; wt, vb read, dwt, dvb written;
                # three (3H x 2H) products a (step, column, direction): U
                # recomputed, dx = W du, dW += x du^T; ~30 flops of gates
                4 * (2 * length * H * B * 4 + 2 * (wt.numel() + vb.numel())),
                2 * length * B * (3 * 2 * 3 * H * 2 * H + 30 * H), None),
            "convt1d_ola_tm_bwd": (
                None, None, None,
                lambda: convt_tm._backward(g3, d(x3), d(w3)),
                lambda: convt_tm.convt1d_ola_tm_bwd_plain(g3, d(x3), d(w3)),
                lambda: convt_tm.convt1d_ola_tm_plain(x3, w3),
                (x3, w3), (g3,),
                # g, x read, dx written; w read, dw written; dx and dW each
                # 2 k C_in C_out flops a (step, column)
                4 * ((length + k - 1) * C * B + 2 * length * 2 * H * B
                     + 2 * w3.numel()),
                4 * length * k * 2 * H * C * B, "conv_transpose1d"),
        }
        for name, (fwd_name, fwd_got, fwd_want, kern, plain, plain_fwd, ins,
                   cots, nbytes, nops, lib) in cases.items():
            if fwd_name is not None:
                err, scale = _max_err(fwd_got, fwd_want)
                print(f"kernel {fwd_name} (training forward, with c) "
                      f"site={site} L={length} B={B}: max_abs_err={err:.3e} "
                      f"(tol {TOL[fwd_name]:.0e})")
                if not err <= TOL[fwd_name]:
                    raise AssertionError(f"{fwd_name} with c disagrees with "
                                         f"its plain version: {err:.3e}")
                fwd_res[fwd_name]["max_abs_err"] = max(
                    fwd_res[fwd_name]["max_abs_err"], err)
            got = kern()
            again = kern()
            want = plain()
            outs = plain_fwd()
            outs = outs if isinstance(outs, tuple) else (outs,)
            auto = torch.autograd.grad(outs, ins, cots)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two calls differ")
            tol = BWD_REL_TOL[name]
            worst = 0.0
            for label, ref in (("plain backward", want), ("autograd", auto)):
                for i, (g, w) in enumerate(zip(got, ref)):
                    err = (g - w).abs().max().item()
                    scale = w.abs().max().item()
                    worst = max(worst, err)
                    print(f"kernel {name} site={site} L={length} B={B} "
                          f"output {i} vs {label}: max_abs_err={err:.3e} "
                          f"max|ref|={scale:.3e} (tol {tol:.0e} * max|ref|)")
                    if not err <= tol * scale:
                        raise AssertionError(
                            f"{name} output {i} disagrees with the "
                            f"{label}: {err:.3e} > {tol:.0e} * {scale:.3e}")
            ms = time_cuda(kern, 30)
            plain_ms = time_cuda(plain, 3, warmup=1)
            b_ms, b_by = bound_ms(nbytes, nops)
            lib_ms = None
            if lib:
                x_lib = d(x3).permute(2, 1, 0).contiguous().requires_grad_()
                w_lib = d(w3).permute(2, 1, 0).contiguous().requires_grad_()
                y_lib = torch.nn.functional.conv_transpose1d(x_lib, w_lib)
                g_lib = g3.permute(2, 1, 0).contiguous()
                lib_ms = time_cuda(lambda: torch.autograd.grad(
                    y_lib, (x_lib, w_lib), g_lib, retain_graph=True), 30)
            print(f"kernel {name} site={site} L={length} B={B}: per call "
                  f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} "
                  f"({b_by}) library_ms={lib_ms}; two calls bit-identical")
            if name in SCAN_DIRS:  # the adjoint scan of csrc/sru_scan.cuh
                sg = sru_fused.scan_bwd_geometry(length, H, B, 2)
                print(f"kernel {name} site={site}: scan block {sg['cols']} "
                      f"columns x {sg['units']} units, grid {sg['grid']}, "
                      f"{sg['ahead']} steps ahead, {sg['smem']} bytes of "
                      f"shared memory; share of the bound {b_ms / ms:.3f}")
            r = res[name]
            n = per_site[name]
            r["max_abs_err"] = max(r["max_abs_err"], worst)
            r["ms"] += n * ms
            r["plain_ms"] += n * plain_ms
            r["bound_ms"] += n * b_ms
            r["bound_by"] = b_by
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + n * lib_ms
    for name, r in res.items():
        print(f"kernel {name}: per bs-{TRAIN_BATCH} step ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} plain_ms={r['plain_ms']:.2f} "
              f"library_ms={r['library_ms']} (share of the bound "
              f"{r['bound_ms'] / r['ms']:.3f})")
    return res


def _no_dropout(conf):
    """A copy of ``conf`` with every ``dropout`` rate set to 0."""
    if isinstance(conf, dict):
        return {k: 0.0 if k == "dropout" else _no_dropout(v)
                for k, v in conf.items()}
    return conf


def _train_step_at(conf, batch, dev, dtype, cudnn=True) -> tuple:
    """One train step of a new system (weights from seed 0) on ``dev`` in
    ``dtype``, with cuDNN on or off: (loss, gradients, BatchNorm
    statistics, seconds), the tensors as float64 on the CPU."""
    from rtfs_tpu_torch.train.main import build_system
    from rtfs_tpu_torch.train.system import make_generator

    system = build_system(conf, dev, seed=0)
    system.model.to(dtype)
    system.video_model.to(dtype)
    torch.backends.cudnn.enabled = cudnn
    try:
        t0 = time.perf_counter()
        loss = system.train_step(batch, make_generator(0, dev))["train_loss"]
        loss = loss.item()
        secs = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.enabled = True
    grads = {}
    for n, p in system.model.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{n}: no gradient on {dev}")
        grads[n] = p.grad.to("cpu", torch.float64)
    stats = {n: b.to("cpu", torch.float64)
             for n, b in system.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, stats, secs


def _train_runs(conf, batch, runs) -> dict:
    """``{run: _train_step_at(...)}`` for ``runs`` ``{run: (device, dtype,
    cuDNN)}``, with dropout 0."""
    conf0 = _no_dropout(conf)
    res = {}
    for run, (dev, dtype, cudnn) in runs.items():
        res[run] = _train_step_at(conf0, batch, dev, dtype, cudnn)
        print(f"training: {run} step at batch 1 (dropout 0) "
              f"loss={res[run][0]:.9f} in {res[run][3]:.3f} s")
    return res


def compare_train_step(conf, batch, tag="") -> dict:
    """One train step at batch 1 with dropout 0 on the card (with cuDNN
    and with it off) and on the CPU in float32, each held against the
    CPU's float64 step, and the card's against the CPU's; a repeat of the
    card step shows its run-to-run spread. The tolerances are at
    ``TRAIN_GRAD_*``; ``tag`` prefixes the runs' names. Returns the card's,
    the CPU's and the float64 steps for the packed phase to reuse."""
    res = _train_runs(conf, batch, {
        f"{tag}card": ("cuda", torch.float32, True),
        f"{tag}card again": ("cuda", torch.float32, True),
        f"{tag}card, cuDNN off": ("cuda", torch.float32, False),
        f"{tag}cpu": ("cpu", torch.float32, True),
        f"{tag}cpu float64": ("cpu", torch.float64, True)})
    ref = {"float64": res.pop(f"{tag}cpu float64"), "cpu": res[f"{tag}cpu"],
           "card": res[f"{tag}card"]}
    spread = max((g - res[f"{tag}card again"][1][n]).abs().max().item()
                 for n, g in res[f"{tag}card"][1].items())
    hold_train_step(res, ref, f"{tag}card", f"{tag}card, cuDNN off")
    print(f"training: {tag}card vs {tag}card max abs {spread:.3e}")
    return ref


def hold_train_step(res, ref, on: str, off: str, label: str = "training",
                    stats: bool = True) -> None:
    """Hold the card's steps ``res[on]`` (cuDNN) and ``res[off]`` (cuDNN
    off) and the CPU's float32 step ``ref["cpu"]`` against the float64
    step ``ref["float64"]``: loss, gradients through the ``TRAIN_GRAD_*``
    gates, and (``stats``) the card's BatchNorm statistics; ``label``
    prefixes the lines."""
    loss64, g64, stats64, _ = ref["float64"]
    res = {on: res[on], off: res[off], "cpu": ref["cpu"]}
    scale = {n: g.abs().max().item() for n, g in g64.items()}
    g_max = max(scale.values())
    err = {run: {n: (g - g64[n]).abs().max().item()
                 for n, g in r[1].items()} for run, r in res.items()}

    for run, r in res.items():
        rel_l2 = statistics.median(
            ((g - g64[n]).norm() / g64[n].norm().clamp(min=1e-300)).item()
            for n, g in r[1].items())
        worst = max(g64, key=lambda n: err[run][n] / (scale[n] + 1e-5 * g_max))
        print(f"{label}: {run} against float64: loss {r[0]:.9f} / "
              f"{loss64:.9f}; gradients median rel_l2 {rel_l2:.3e}, worst "
              f"{worst} {err[run][worst]:.3e} on max|grad| "
              f"{scale[worst]:.3e}")
        if not abs(r[0] - loss64) <= TRAIN_LOSS_REL_TOL * abs(loss64):
            raise AssertionError(f"train loss {run} {r[0]} vs float64 "
                                 f"{loss64}")
    gates = {
        off: (
            lambda n: TRAIN_GRAD_CPU_FACTOR * err["cpu"][n]
            + TRAIN_GRAD_REL_TOL * scale[n] + 1e-5 * g_max,
            f"{TRAIN_GRAD_CPU_FACTOR} * cpu error + {TRAIN_GRAD_REL_TOL:.0e}"
            f" * max|grad| + 1e-5 * {g_max:.3e}"),
        on: (
            lambda n: TRAIN_GRAD_CUDNN_REL_TOL * scale[n] + 1e-5 * g_max,
            f"{TRAIN_GRAD_CUDNN_REL_TOL:.0e} * max|grad| + 1e-5 * "
            f"{g_max:.3e}"),
    }
    gates[f"{on} vs cpu"] = gates[on]
    err[f"{on} vs cpu"] = {n: (g - res["cpu"][1][n]).abs().max().item()
                           for n, g in res[on][1].items()}
    for run, (tol, text) in gates.items():
        rows = sorted(((err[run][n] / tol(n), n) for n in g64), reverse=True)
        for r, n in rows[:4]:
            print(f"{label}: {run}: grad {n}: max|grad|={scale[n]:.3e}, max "
                  f"abs error {err[run][n]:.3e} ({r:.3f} of the tolerance); "
                  f"against float64: {on} {err[on][n]:.3e}, {off} "
                  f"{err[off][n]:.3e}, cpu {err['cpu'][n]:.3e}")
        print(f"{label}: {run}: {len(rows)} gradients, worst at "
              f"{rows[0][0]:.3f} of its tolerance ({text})")
        if rows[0][0] > 1.0:
            raise AssertionError(f"{rows[0][1]}: {run}: gradient error "
                                 f"{err[run][rows[0][1]]:.3e}")
    if not stats:
        return
    stat_err = max((((s - stats64[n]).abs() / stats64[n].abs().clamp(min=1.0))
                    .max().item() for n, s in res[on][2].items()),
                   default=math.inf)
    print(f"{label}: {len(stats64)} BatchNorm statistics, {on} against "
          f"float64 max rel error {stat_err:.3e} (tol {TRAIN_STAT_TOL:.0e})")
    if not stat_err <= TRAIN_STAT_TOL:
        raise AssertionError(f"BatchNorm statistics: {len(stats64)} buffers, "
                             f"max rel error {stat_err:.3e}")


def dev_us(e) -> float:
    """A profiler event's own device time, us."""
    return float(getattr(e, "self_device_time_total", 0.0) or 0.0)


def device_kernels(prof) -> tuple:
    """A profile's device kernels and copies, by device time, and the
    device ms of the regions the code annotates (the optimizer's step):
    such a region can appear on the device's timeline too, and would count
    the kernels it covers twice."""
    kernels, annotated = [], 0.0
    for e in prof.key_averages():
        if dev_us(e) <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            annotated += dev_us(e)
        else:
            kernels.append(e)
    return sorted(kernels, key=dev_us, reverse=True), annotated / 1e3


def profile_step(system, batch, generator, label: str,
                 also=None) -> None:
    """One more train step under the profiler: wall and device time, idle
    share, the top kernels by device time and, for each group of ``also``
    ({group: kernel name parts}), every kernel whose name holds one of its
    parts, with their sum and share of the step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.train_step(batch, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, annotated_ms = device_kernels(prof)
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(f"{label}: profiled step wall {wall_ms:.3f} ms, device "
          f"{dev_ms:.3f} ms, idle share {max(0.0, 1 - dev_ms / wall_ms):.3f}"
          f"; annotated regions {annotated_ms:.3f} ms, not counted")
    for e in kernels[:12]:
        print(f"{label}: top kernel {dev_us(e) / 1e3:9.3f} ms "
              f"{dev_us(e) / 1e3 / dev_ms:6.3f} x{e.count:<5d} {e.key[:90]}")
    for group, parts in (also or {}).items():
        picked = [e for e in kernels if any(a in e.key for a in parts)]
        for e in picked:
            print(f"{label}: {group} kernel {dev_us(e) / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {dev_us(e) / e.count:8.2f} us a launch "
                  f"{e.key[:90]}")
        picked_ms = sum(dev_us(e) for e in picked) / 1e3
        print(f"{label}: {group} ({len(picked)} kernels: "
              f"{', '.join(parts)}) together {picked_ms:.3f} ms of the "
              f"step, share {picked_ms / dev_ms:.3f} of its device time")


# the device kernels of csrc/packed_tf.cu, as the profiler names them
PACKED_KERNEL_NAMES = ("dw_conv_packed_kernel", "pw_proj_kernel",
                       "pw_unproj_kernel",
                       "spatial_down_kernel", "spatial_up_kernel",
                       "dw_wgrad_kernel", "pw_wgrad_kernel",
                       "sum_partials_kernel")

# the device kernels of the main path whose share phase 6 prints, as the
# profiler names them: K1, K2 and K3 forward (one kernel each), K1
# backward (the adjoint scan of csrc/sru_scan.cuh) and K2 backward (its
# products in csrc/sru_fused.cu and the same scan)
MAIN_KERNEL_GROUPS = {
    "K1 forward": ("sru_lay0_fwd_kernel",),
    "K2 forward": ("sru_hid_fwd_kernel",),
    "K3 forward": ("convt1d_tm_fwd_kernel",),
    "K1 backward": ("sru_scan_bwd_kernel<1>",),
    "K2 backward": ("sru_hid_bwd_", "sru_scan_bwd_kernel<2>"),
}

# K4's device kernels in phase 10's profiled step: the forward
# (csrc/sru_pallas.cu) and the backward (the scan of csrc/sru_scan.cuh),
# together and apart
K4_KERNEL_GROUPS = {
    "K4": ("sru_rec_", "sru_scan_bwd_kernel<4>"),
    "K4 forward": ("sru_rec_fwd_kernel",),
    "K4 backward": ("sru_scan_bwd_kernel<4>",),
}

# launches of K1/K2/K3 per train step, forward and backward
TRAIN_LAUNCHES = {"sru_dual_recurrence_fwd": 2 * REPEATS,
                  "sru_hidden_layer_fwd": 2 * REPEATS * 3,
                  "convt1d_ola_tm_fwd": 2 * REPEATS,
                  "sru_dual_recurrence_bwd": 2 * REPEATS,
                  "sru_hidden_layer_bwd": 2 * REPEATS * 3,
                  "convt1d_ola_tm_bwd": 2 * REPEATS}


def train(conf, expect, label="training", also=None) -> tuple:
    """Phase 6 (and 10): one train step on the card against float64 on the
    CPU, then the train system's steps at batch 4, each launching exactly
    ``expect``; one more step profiled (``also``: {group: kernel name
    parts} whose device time it sums). Returns the launch counts of those
    steps and the batch-1 steps for phase 9."""
    from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train.main import build_system
    from rtfs_tpu_torch.train.system import make_generator

    data = SyntheticAVDataset(n_samples=TRAIN_BATCH * TRAIN_STEPS, seed=0)

    tag = "" if label == "training" else f"{label} "
    ref = compare_train_step(conf, data.collate([data[0]]), tag)

    # the main path: the train system's steps at batch 4, preset dropout
    system = build_system(conf, "cuda", seed=0)
    generator = make_generator(0, "cuda")
    batches = list(data.batches(TRAIN_BATCH, seed=0, epoch=0))
    before = [p.detach().clone() for p in system.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(system.train_step(batch, generator)["train_loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernel_lib.LAUNCHES)
    n = len(batches)
    print(f"{label}: launches over {n} steps: {launches}; per step "
          f"{ {k: v / n for k, v in launches.items()} }")
    if launches != {k: n * v for k, v in expect.items()}:
        raise AssertionError(f"{label}: {n} steps launched {launches}, "
                             f"expected {expect} per step")
    losses = [v.item() for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, system.model.parameters()))
    if moved == 0:
        raise AssertionError("no parameter changed in training")
    med = statistics.median(times[1:])
    print(f"{label}: {n} steps at batch {TRAIN_BATCH}, losses "
          f"{[round(v, 4) for v in losses]}; {moved} of {len(before)} "
          f"parameter tensors moved; ms per step median={med * 1e3:.3f} "
          f"min={min(times[1:]) * 1e3:.3f} max={max(times[1:]) * 1e3:.3f} "
          f"(first step {times[0] * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    profile_step(system, batches[0], generator, label, also=also)
    return launches, ref


def check_packed_wgrad_kernels(conf, rng) -> dict:
    """Phase 9, first: K5-wgrad and pw-wgrad against their plain versions
    at the packed training shapes (batch 4), each called twice (the two dW
    must be bit-identical), timed with CUDA events beside its bound (for
    pw-wgrad, whose product runs in 3xTF32 on the tensor cores, that
    route's, the SIMT-f32 one printed beside it), its plain version and
    one PyTorch call; returns per kernel the max relative error and
    per-train-step sums of kernel, plain, bound and library times."""
    import torch.nn.functional as Fn

    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    T, Fq, C, Cb, k = (g[n] for n in ("T", "F", "C", "Cb", "k"))
    r = conf["audionet"]["audio_params"]["repeats"]
    bs, dev = TRAIN_BATCH, torch.device("cuda")

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def cl(x, t_len, f_len):  # a packed map as a channels-last (B, C, T, F)
        return x.view(bs, t_len, f_len, C).permute(0, 3, 1, 2)

    same = ((k - 1) // 2, k - 1 - (k - 1) // 2)
    pre = ((k - 1) // 2,) * 2
    t_conv, f_conv = P.dw_geometry(T, Fq, k, k, pre, pre)
    xp, g_same, g_pre = t((bs, T, Fq * C)), t((bs, T, Fq * C)), t(
        (bs, t_conv, f_conv * C))
    x4, gp = t((bs, Cb, T, Fq)), t((bs, T, Fq * C))   # K6's dW
    xq, g4 = t((bs, T, Fq * C)), t((bs, Cb, T, Fq))   # K7's dW
    # the library's dW of a depthwise conv reads x padded beforehand (the
    # 'same' pads of an even kernel are uneven), channels-last as packed
    padded = {pads: Fn.pad(cl(xp, T, Fq), (*pads, *pads)).contiguous(
        memory_format=torch.channels_last) for pads in (same, pre)}
    n_x, n_s, m = bs * T * Fq * C, bs * t_conv * f_conv * C, bs * T * Fq

    def dw_lib(pads, gg, t_len, f_len):
        return lambda: torch.nn.grad.conv2d_weight(
            padded[pads], (C, 1, k, k), cl(gg, t_len, f_len),
            groups=C)[:, 0].permute(1, 2, 0)

    pw_bytes, pw_ops = pw_wgrad_cost(m, Cb, C)
    # (kernel, site, launches per step, kernel call, plain call, bytes,
    #  flops, library call, bound: K5-wgrad's SIMT float32, pw-wgrad's
    #  all 3xTF32 products)
    cases = [
        ("dw_conv_packed_wgrad", "same", 3 * r,
         lambda: P.dw_conv_packed_wgrad(xp, g_same, Fq, C, (k, k), same,
                                        same),
         lambda: P.dw_conv_packed_wgrad_plain(xp, g_same, Fq, C, (k, k),
                                              same, same),
         4 * (2 * n_x + k * k * C), 2 * k * k * n_x,
         dw_lib(same, g_same, T, Fq), bound_ms),
        ("dw_conv_packed_wgrad", "pre-select", r,
         lambda: P.dw_conv_packed_wgrad(xp, g_pre, Fq, C, (k, k), pre, pre),
         lambda: P.dw_conv_packed_wgrad_plain(xp, g_pre, Fq, C, (k, k), pre,
                                              pre),
         4 * (n_x + n_s + k * k * C), 2 * k * k * n_s,
         dw_lib(pre, g_pre, t_conv, f_conv), bound_ms),
        ("pw_packed_wgrad", "K6 dW", r,
         lambda: P.pw_packed_wgrad(x4, gp),
         lambda: P.pw_packed_wgrad_plain(x4, gp), pw_bytes, pw_ops,
         lambda: torch.einsum("bitf,btfo->io", x4, gp.view(bs, T, Fq, C)),
         products_bound_ms),
        ("pw_packed_wgrad", "K7 dW", r,
         lambda: P.pw_packed_wgrad(xq, g4),
         lambda: P.pw_packed_wgrad_plain(xq, g4), pw_bytes, pw_ops,
         lambda: torch.einsum("btfi,botf->io", xq.view(bs, T, Fq, C), g4),
         products_bound_ms),
    ]
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0}
           for name in ("dw_conv_packed_wgrad", "pw_packed_wgrad")}
    simt_ms = dict.fromkeys(res, 0.0)  # the SIMT-f32 bound, only printed
    for name, site, n, kern, plain, nbytes, nops, lib, bound in cases:
        got, again, want, lib_out = kern(), kern(), plain(), lib()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        lib_err = (lib_out - want).abs().max().item()
        ms = time_cuda(kern, 50)
        plain_ms = time_cuda(plain, 3, warmup=1)
        lib_ms = time_cuda(lib, 50)
        b_ms, b_by = bound(nbytes, nops)
        f32_ms, _ = bound_ms(nbytes, nops)
        simt_ms[name] += n * f32_ms
        print(f"kernel {name} bs={bs} site={site}: max_abs_err={err:.3e} "
              f"max|dW|={scale:.3e} (tol {PACKED_WGRAD_REL_TOL:.0e} * max|dW|)"
              f"; library vs plain {lib_err:.3e}; two calls bit-identical "
              f"{torch.equal(got, again)}; ms={ms:.5f} plain_ms="
              f"{plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}, {nbytes} B, "
              f"{nops} flop; SIMT-f32 bound_ms={f32_ms:.5f}) library_ms="
              f"{lib_ms:.5f}")
        if not max(err, lib_err) <= PACKED_WGRAD_REL_TOL * scale:
            raise AssertionError(f"{name} ({site}) disagrees with its plain "
                                 f"version or the library: {err:.3e}, "
                                 f"{lib_err:.3e} on max {scale:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({site}): two calls differ")
        e = res[name]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += n * ms
        e["plain_ms"] += n * plain_ms
        e["bound_ms"] += n * b_ms
        e["library_ms"] += n * lib_ms
        e["bound_by"] = b_by
    for name, e in res.items():
        print(f"kernel {name} per packed bs-{bs} step: ms={e['ms']:.4f} "
              f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}; SIMT-f32 "
              f"bound_ms={simt_ms[name]:.4f}) "
              f"plain_ms={e['plain_ms']:.2f} library_ms="
              f"{e['library_ms']:.4f}")
    return res


def check_packed_functions(conf, rng) -> None:
    """Phase 9, second: each packed op's autograd Function on the card (its
    backward through the kernels) against autograd through the op's plain
    forward on the same card inputs and cotangent, at the packed training
    shapes (batch 4): every input's gradient to ``PACKED_FN_REL_TOL`` of
    its max. The weights enter as the Conv passes them, views of the torch
    weight, so the gradients also cross the views."""
    from rtfs_tpu_torch.ops import packed_tf as P

    g = packed_geometry(conf)
    T, Fq, C, Cb, k, T2, F2 = (g[n] for n in ("T", "F", "C", "Cb", "k",
                                              "T2", "F2"))
    bs, dev = TRAIN_BATCH, torch.device("cuda")

    def leaf(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev).requires_grad_()

    same = ((k - 1) // 2, k - 1 - (k - 1) // 2)
    pre = ((k - 1) // 2,) * 2
    t_conv, f_conv = P.dw_geometry(T, Fq, k, k, pre, pre)
    xp, xs = leaf((bs, T, Fq * C)), leaf((bs, t_conv, f_conv * C))
    x4, x2 = leaf((bs, Cb, T, Fq)), leaf((bs, C, T2, F2))
    w_dw, b_dw = leaf((C, 1, k, k), 1.0 / k), leaf((C,))
    w_in, b_in = leaf((C, Cb, 1, 1), Cb ** -0.5), leaf((C,))
    w_out, b_out = leaf((Cb, C, 1, 1), C ** -0.5), leaf((Cb,))
    pool = P.cached_map("pool", T, T2, Fq, F2)
    sel = P.cached_map("select", t_conv, T2, f_conv, F2)
    up = P.cached_map("nearest", T2, T, F2, Fq)
    taps = lambda: w_dw[:, 0].permute(1, 2, 0)  # noqa: E731
    # (op, site, inputs, call of the op or its plain version)
    cases = [
        ("dw_conv_packed", "same", (xp, w_dw, b_dw),
         lambda f: f(xp, taps(), b_dw, Fq, C, same, same)),
        ("dw_conv_packed", "pre-select", (xp, w_dw, b_dw),
         lambda f: f(xp, taps(), b_dw, Fq, C, pre, pre)),
        ("dw_conv_packed", "no bias", (xp, w_dw),
         lambda f: f(xp, taps(), None, Fq, C, same, same)),
        ("pw_proj_packed", "projection", (x4, w_in, b_in),
         lambda f: f(x4, w_in[:, :, 0, 0].t(), b_in)),
        ("pw_unproj_packed", "residual", (xp, w_out, b_out),
         lambda f: f(xp, w_out[:, :, 0, 0].t(), b_out, Fq)),
        ("spatial_down_packed", "pool", (xp,), lambda f: f(xp, pool, C)),
        ("spatial_down_packed", "select", (xs,), lambda f: f(xs, sel, C)),
        ("spatial_up_packed", "nearest", (x2,), lambda f: f(x2, up)),
    ]
    for name, site, ins, call in cases:
        out = call(getattr(P, name))
        cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to(dev)
        got = torch.autograd.grad(out, ins, cot)
        want = torch.autograd.grad(call(getattr(P, f"{name}_plain")), ins,
                                   cot)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            print(f"backward {name} site={site} input {i} "
                  f"{tuple(b.shape)}: Function vs autograd of the plain "
                  f"forward max_abs_err={err:.3e} max|grad|={scale:.3e} "
                  f"(tol {PACKED_FN_REL_TOL:.0e} * max|grad|)")
            if not err <= PACKED_FN_REL_TOL * scale:
                raise AssertionError(f"{name} ({site}) input {i}: backward "
                                     f"{err:.3e} > tol on {scale:.3e}")


def train_packed(conf, rng, ref) -> tuple:
    """Phase 9: packed training. The kernels and the Functions, one packed
    bs-1 step held as phase 6's, then the packed and the standard train
    systems in turns at batch 4; returns the wgrad kernels' results and
    the launch counts of the packed steps (the main path)."""
    from rtfs_tpu_torch.data.synthetic import SyntheticAVDataset
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train.main import build_system
    from rtfs_tpu_torch.train.system import make_generator

    wgrads = check_packed_wgrad_kernels(conf, rng)
    check_packed_functions(conf, rng)

    # as --audionet.packed_tf true sets it
    pconf = dict(conf, audionet=dict(conf["audionet"], packed_tf=True))
    data = SyntheticAVDataset(n_samples=TRAIN_BATCH * TRAIN_STEPS, seed=0)
    res = _train_runs(pconf, data.collate([data[0]]), {
        "card packed": ("cuda", torch.float32, True),
        "card packed, cuDNN off": ("cuda", torch.float32, False)})
    hold_train_step(res, ref, "card packed", "card packed, cuDNN off")
    std, packed = ref["card"], res["card packed"]
    dist = max((g - std[1][n]).abs().max().item()
               for n, g in packed[1].items())
    g_max = max(g.abs().max().item() for g in std[1].values())
    print(f"packed training: card packed vs card standard step: loss "
          f"{packed[0]:.9f} / {std[0]:.9f}, gradients max abs {dist:.3e} "
          f"(max|grad| {g_max:.3e})")

    # the main path: packed and standard systems in turns (standard,
    # packed, packed, standard, ...), each on the same batches; the counts
    # are set to 0 before each packed step and read after it
    systems = {False: build_system(conf, "cuda", seed=0),
               True: build_system(pconf, "cuda", seed=0)}
    gens = {p: make_generator(0, "cuda") for p in systems}
    batches = list(data.batches(TRAIN_BATCH, seed=0, epoch=0))
    before = [p.detach().clone() for p in systems[True].model.parameters()]
    times = {False: [], True: []}
    losses = {False: [], True: []}
    peak = {False: 0, True: 0}
    launches = collections.Counter()
    for i in range(2 * len(batches)):
        packed = (i % 4) in (1, 2)
        batch = batches[len(times[packed])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launches()
        t0 = time.perf_counter()
        losses[packed].append(
            systems[packed].train_step(batch, gens[packed])["train_loss"])
        torch.cuda.synchronize()
        times[packed].append(time.perf_counter() - t0)
        if packed:
            launches.update(kernel_lib.LAUNCHES)
        peak[packed] = max(peak[packed], torch.cuda.max_memory_allocated())
    launches = dict(launches)
    n = len(batches)
    expect = {**TRAIN_LAUNCHES, **packed_train_launches(conf)}
    print(f"packed training: launches over {n} packed steps: {launches}; "
          f"per step { {k: v / n for k, v in launches.items()} }")
    if launches != {k: n * v for k, v in expect.items()}:
        raise AssertionError(f"packed steps launched {launches}, expected "
                             f"{expect} per step")
    for packed in (False, True):
        ls = [v.item() for v in losses[packed]]
        if not all(math.isfinite(v) for v in ls):
            raise AssertionError(f"non-finite train loss: {ls}")
        ts = times[packed][1:]
        print(f"packed training: {'packed' if packed else 'standard'} "
              f"{n} steps at batch {TRAIN_BATCH}, losses "
              f"{[round(v, 4) for v in ls]}; ms per step median="
              f"{statistics.median(ts) * 1e3:.3f} min={min(ts) * 1e3:.3f} "
              f"max={max(ts) * 1e3:.3f} (first step "
              f"{times[packed][0] * 1e3:.3f}); peak device memory "
              f"{peak[packed] / 2**20:.1f} MiB")
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, systems[True].model.parameters()))
    print(f"packed training: {moved} of {len(before)} parameter tensors "
          "moved")
    if moved == 0:
        raise AssertionError("no parameter changed in packed training")
    del systems[False]
    profile_step(systems[True], batches[0], gens[True], "packed training",
                 also={"packed kernels": PACKED_KERNEL_NAMES,
                       "K6 pw_proj_packed": ("pw_proj_kernel",),
                       "K1 forward": MAIN_KERNEL_GROUPS["K1 forward"]})
    return wgrads, launches


def check_k4_kernels(geo, rng) -> dict:
    """Phase 10, first: K4 forward at the serving shapes (batch 1 and 8,
    both sites), the training forward with c and the backward at batch 4,
    each against its plain version on the same card inputs; the backward
    also against autograd through the plain forward, twice (bit-identical),
    and the Function's gradients (u, xhw, v, b) against the same autograd.
    Returns per kernel the max error and the per-forward (batch 8) or
    per-train-step (batch 4) sums of kernel, plain and bound times."""
    from rtfs_tpu_torch.ops import sru_fused
    from rtfs_tpu_torch.ops import sru_pallas as S

    H, dev = geo["H"], torch.device("cuda")
    per_site = REPEATS * geo["layers"]  # K4 calls per site, one direction

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    v, b = t((2, H), math.sqrt(1.0 / H)), t((2, H), 0.1)
    vb = torch.cat([v, b])
    res = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": None}
           for name in ("sru_recurrence", "sru_recurrence_bwd")}
    for bs in (1, 8, TRAIN_BATCH):
        with_c = bs == TRAIN_BATCH  # the training forward keeps c
        for site in ("freq", "time"):
            length, per_item = geo[site]
            B = bs * per_item
            u, x = t((length, 3 * H, B)), t((length, H, B))
            kern = functools.partial(S._k4_forward, u, x, vb, False, with_c)
            plain = functools.partial(S.sru_recurrence_plain, u, x, vb, False,
                                      with_c)
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            got = got if with_c else (got,)
            again = again if with_c else (again,)
            want = want if with_c else (want,)
            err, _ = _max_err(got, want)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"sru_recurrence bs {bs} {site}: two "
                                     "calls differ")
            ms = time_cuda(kern, 50)
            plain_ms = time_cuda(plain, 3, warmup=1)
            # u, xhw read, h (and c) written, once each; ~20 flops a
            # (step, unit, column)
            b_ms, b_by = bound_ms(4 * (length * B * (5 + with_c) * H + 4 * H),
                                  20 * length * H * B)
            what = " (training, with c)" if with_c else ""
            geo4 = S.k4_fwd_geometry(length, H, B)
            print(f"kernel sru_recurrence{what} bs={bs} site={site} "
                  f"L={length} B={B}: max_abs_err="
                  f"{err:.3e} (tol {K4_TOL:.0e}) bit-identical=True "
                  f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} "
                  f"({b_by}) library_ms=None; block {geo4['cols']} columns "
                  f"x {geo4['units']} units, grid {geo4['grid']}, "
                  f"{geo4['ahead']} steps ahead; {ms / length * 1e6:.1f} ns "
                  "a step")
            if not err <= K4_TOL:
                raise AssertionError("sru_recurrence disagrees with its "
                                     f"plain version: {err:.3e}")
            r = res["sru_recurrence"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if bs == 8:  # per-forward sums at batch 8
                r["ms"] += per_site * ms
                r["plain_ms"] += per_site * plain_ms
                r["bound_ms"] += per_site * b_ms
                r["bound_by"] = b_by
            if not with_c:
                continue

            c, dh = got[1], t((length, H, B))
            kern = functools.partial(S._k4_backward, u, x, vb, c, dh, False)
            plain = functools.partial(S.sru_recurrence_bwd_plain, u, x, vb, c,
                                      dh)
            leaves = [a.clone().requires_grad_() for a in (u, x, v, b)]
            auto = torch.autograd.grad(S.sru_recurrence_plain(
                leaves[0], leaves[1], torch.cat(leaves[2:])), leaves, dh)
            fn = torch.autograd.grad(S.sru_recurrence(*leaves), leaves, dh)
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            auto_k = (auto[0], auto[1], torch.cat(auto[2:]))
            worst = 0.0
            for label, out, ref in (("kernel vs plain backward", got, want),
                                    ("kernel vs autograd", got, auto_k),
                                    ("Function vs autograd", fn, auto)):
                for i, (g, w) in enumerate(zip(out, ref)):
                    e, scale = (g - w).abs().max().item(), w.abs().max().item()
                    worst = max(worst, e)
                    print(f"kernel sru_recurrence_bwd site={site} L={length} "
                          f"B={B} output {i}, {label}: max_abs_err={e:.3e} "
                          f"max|ref|={scale:.3e} (tol "
                          f"{K4_BWD_REL_TOL:.0e} * max|ref|)")
                    if not e <= K4_BWD_REL_TOL * scale:
                        raise AssertionError(
                            f"sru_recurrence_bwd output {i} ({label}): "
                            f"{e:.3e} on {scale:.3e}")
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            ms = time_cuda(kern, 30)
            plain_ms = time_cuda(plain, 3, warmup=1)
            # u, xhw, c, dh read, du, dxhw written; ~35 flops a (step, unit,
            # column)
            b_ms, b_by = bound_ms(4 * (length * B * 10 * H + 8 * H),
                                  35 * length * H * B)
            sg = sru_fused.scan_bwd_geometry(length, H, B, 1)
            print(f"kernel sru_recurrence_bwd site={site} L={length} B={B}: "
                  f"two calls bit-identical {same}; ms={ms:.5f} plain_ms="
                  f"{plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                  f"library_ms=None; share of the bound {b_ms / ms:.3f}; "
                  f"scan block {sg['cols']} columns x {sg['units']} units, "
                  f"grid {sg['grid']}, {sg['ahead']} steps ahead, "
                  f"{sg['smem']} bytes of shared memory")
            if not same:
                raise AssertionError("sru_recurrence_bwd: two calls differ")
            r = res["sru_recurrence_bwd"]
            r["max_abs_err"] = max(r["max_abs_err"], worst)
            r["ms"] += per_site * ms
            r["plain_ms"] += per_site * plain_ms
            r["bound_ms"] += per_site * b_ms
            r["bound_by"] = b_by
    # K4 forward at the wide phase's H 80 (the route of a unidirectional
    # SRU, or of one whose input is 2H, that wide) at the bs-8 serving
    # sites, both directions
    hw = WIDE_HIDDEN[-1]
    vbw = torch.cat([t((2, hw), math.sqrt(1.0 / hw)), t((2, hw), 0.1)])
    for site in ("freq", "time"):
        length, per_item = geo[site]
        B = 8 * per_item
        u, x = t((length, 3 * hw, B)), t((length, hw, B))
        for reverse in (False, True):
            kern = functools.partial(S._k4_forward, u, x, vbw, reverse, False)
            got, again = kern(), kern()
            want = S.sru_recurrence_plain(u, x, vbw, reverse)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = time_cuda(kern, 30)
            b_ms, b_by = bound_ms(4 * (length * B * 5 * hw + 4 * hw),
                                  20 * length * hw * B)
            print(f"kernel sru_recurrence H={hw} bs=8 site={site} "
                  f"reverse={reverse} L={length} B={B}: max_abs_err="
                  f"{err:.3e} (tol {K4_TOL:.0e}) bit-identical="
                  f"{torch.equal(got, again)} ms={ms:.5f} bound_ms="
                  f"{b_ms:.5f} ({b_by}); {ms / length * 1e6:.1f} ns a step")
            if not (err <= K4_TOL and torch.equal(got, again)):
                raise AssertionError(f"sru_recurrence H {hw} {site}: "
                                     f"{err:.3e}, or two calls differ")
    return res


# the two overrides that make both DualPathRNNs unidirectional
UNI_OVERRIDES = ("--audionet.audio_params.layers.layer_1.bidirectional",
                 "false",
                 "--audionet.audio_params.layers.layer_2.bidirectional",
                 "false")


def uni_entries(conf_uni, rng) -> dict:
    """Phase 10, entries: the train entry with the overrides on 8 synthetic
    samples for one epoch, then the serving entry on the run's
    ``conf.json`` and ``best_model.pt`` with a 2 s wav and 50 mouth frames,
    on the card; returns the inference forward's launches."""
    import os
    import tempfile

    from rtfs_tpu_torch import inference
    from rtfs_tpu_torch.data.wav import write_wav
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train import main as train_main

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        kernel_lib.reset_launches()
        row = train_main.cli(["--conf-dir", PRESET, *UNI_OVERRIDES,
                              "--data.synthetic", "true",
                              "--data.synthetic_samples", "8",
                              "--training.epochs", "1", "--log.path", root])
        torch.cuda.synchronize()
        print(f"uni entries: train entry {time.perf_counter() - t0:.3f} s, "
              f"last row {row}, launches {dict(kernel_lib.LAUNCHES)}")
        if row is None or not math.isfinite(row["val_loss"]):
            raise AssertionError(f"uni train entry: {row}")
        exp_dir = os.path.join(root, conf_uni["log"]["exp_name"])
        wav = (rng.standard_normal(SAMPLES) * 0.1).astype(np.float32)
        write_wav(os.path.join(root, "mix.wav"), wav, 16000)
        mouth = rng.integers(0, 256, (VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE),
                             dtype=np.uint8)
        np.savez(os.path.join(root, "mouth.npz"), data=mouth)
        t0 = time.perf_counter()
        kernel_lib.reset_launches()
        est = inference.main([
            "--conf-dir", os.path.join(exp_dir, "conf.json"),
            "--wav", os.path.join(root, "mix.wav"),
            "--mouth", os.path.join(root, "mouth.npz"),
            "--out-dir", os.path.join(root, "out")])
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)
    expect = {"sru_recurrence_fwd": k4_launches(conf_uni)}
    print(f"uni entries: inference entry {time.perf_counter() - t0:.3f} s, "
          f"launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"uni inference launches {launches} != {expect}")
    if est.shape != (1, SAMPLES) or not np.isfinite(est).all():
        raise AssertionError(f"uni inference entry: bad output {est.shape}")
    return launches


def unidirectional(conf_uni, geo, rng) -> tuple:
    """Phase 10: RTFS-Net-4 with both DualPathRNNs unidirectional, the K4
    path. (a) K4 against its plain versions; (b) serving at batch 1 and 8,
    exactly ``k4_launches`` K4 per forward and no other kernel, against the
    CPU; (c) the train and serving entries; (d) one bs-1 step through phase
    6's gates with its own float64 reference, then ``TRAIN_STEPS`` steps at
    batch 4 launching exactly K4 forward and backward ``k4_launches`` each
    per step. Returns K4's results and the launches of (b) and (d)."""
    k4 = phase("10a K4 kernels", check_k4_kernels, geo, rng)
    per_fwd = k4_launches(conf_uni)
    served = phase("10b uni serving", serve, conf_uni, rng,
                        {"sru_recurrence_fwd": per_fwd}, "uni serving")
    phase("10c uni entries", uni_entries, conf_uni, rng)
    trained, _ = phase(
        "10d uni training", train, conf_uni,
        {"sru_recurrence_fwd": per_fwd, "sru_recurrence_bwd": per_fwd},
        "uni training", K4_KERNEL_GROUPS)
    return k4, served, trained


# the "wide" phase's hid_chan: 2H above the 64 input channels that one K3
# block takes (48), and H above the 68 units whose W_d one K2 forward
# block takes (80)
WIDE_HIDDEN = (48, 80)
# and H above 268, where K2 forward streams its projection's reduction
# through shared memory (kernel only: no preset or DualPathRNN of the
# phase reaches it)
WIDE_STREAM_H = 300


def _sum_launches(*counts) -> dict:
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


def wide(geo, rng) -> None:
    """Phase "wide": a pair of DualPathRNNs (dim 4, then dim 3) at the
    preset's in_chan, window and layers and the main path's pooled (T, F),
    at each H of ``WIDE_HIDDEN`` (weights from a seed): one bs-1 forward on
    the card against the port's CPU run (``SERVE_REL_TOL`` of max), then
    one bs-4 train step (mean square loss against a random target) on the
    card with cuDNN and without it, held through phase 6's gates against
    the same step in float32 and float64 on the CPU. The launches of the
    card's forward and step must be those ``rnn_launches`` derives. First,
    K2 forward and K3 forward and backward at each H's bs-1 sites against
    their plain versions (phase 3's and 5's tolerances), two calls
    bit-identical, with their split over the grid printed."""
    import copy

    from rtfs_tpu_torch.models.avnet import init_weights
    from rtfs_tpu_torch.models.rnn_blocks import DualPathRNN
    from rtfs_tpu_torch.ops import convt_tm, kernel_lib, sru_fused

    c, k, layers = geo["C"], geo["k"], geo["layers"]
    t_len, f_len = geo["freq"][1], geo["time"][1]
    dev = torch.device("cuda")

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    for h in WIDE_HIDDEN:
        vb = torch.cat([t((2, 2, h), math.sqrt(1.0 / h)), t((2, 2, h), 0.1)],
                       dim=1).reshape(8, h)
        wt = t((6 * h, 2 * h), math.sqrt(1.0 / (2 * h)))
        w3 = t((k, c, 2 * h), math.sqrt(1.0 / (2 * h * k)))
        for site in ("freq", "time"):
            length, bsz = geo[site]
            x = (t((length, h, bsz), 0.5), t((length, h, bsz), 0.5))
            k2 = functools.partial(sru_fused._k2_forward, *x, wt, vb, True)
            got, again = torch.stack(k2()), torch.stack(k2())
            want = torch.stack(sru_fused.sru_hidden_layer_plain(*x, wt, vb,
                                                                True))
            x3, g3 = t((length, 2 * h, bsz)), t((length + k - 1, c, bsz))
            k3 = functools.partial(convt_tm._forward, x3, w3)
            k3b = functools.partial(convt_tm._backward, g3, x3, w3)
            got3, again3, got3b, again3b = k3(), k3(), k3b(), k3b()
            want3 = convt_tm.convt1d_ola_tm_plain(x3, w3)
            want3b = convt_tm.convt1d_ola_tm_bwd_plain(g3, x3, w3)
            torch.cuda.synchronize()
            err2 = (got - want).abs().max().item()
            err3 = (got3 - want3).abs().max().item()
            err3b = max(((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(got3b, want3b))
            same = (torch.equal(got, again) and torch.equal(got3, again3)
                    and all(torch.equal(a, b) for a, b in zip(got3b, again3b)))
            g2 = sru_fused.k2_fwd_geometry(length, h, bsz)
            f3 = convt_tm.fwd_geometry(length, 2 * h, c, k, bsz)
            b3 = convt_tm.bwd_geometry(length, 2 * h, c, k, bsz)
            print(f"wide H {h} site={site} L={length} B={bsz}: "
                  f"sru_hidden_layer (units {g2['units']} x {g2['slices']} "
                  f"slices, bt {g2['bt']}) max_abs_err={err2:.3e} (tol "
                  f"{TOL['sru_hidden_layer']:.0e}) ms="
                  f"{time_cuda(k2, 10):.5f}; convt1d_ola_tm (input "
                  f"{f3['ci_slice']} x {f3['in_slices']} slices) "
                  f"max_abs_err={err3:.3e} (tol "
                  f"{TOL['convt1d_ola_tm']:.0e}) ms={time_cuda(k3, 10):.5f}; "
                  f"backward (output {b3['co_slice']} x {b3['out_slices']}, "
                  f"input {convt_tm.MAX_IN} x {b3['in_slices']}) max rel err "
                  f"{err3b:.3e} (tol {BWD_REL_TOL['convt1d_ola_tm_bwd']:.0e}); "
                  f"two calls bit-identical {same}")
            if not (err2 <= TOL["sru_hidden_layer"]
                    and err3 <= TOL["convt1d_ola_tm"]
                    and err3b <= BWD_REL_TOL["convt1d_ola_tm_bwd"] and same):
                raise AssertionError(f"wide H {h} {site}: a kernel disagrees "
                                     "with its plain version, or two calls "
                                     "differ")

    h = WIDE_STREAM_H
    vb = torch.cat([t((2, 2, h), math.sqrt(1.0 / h)), t((2, 2, h), 0.1)],
                   dim=1).reshape(8, h)
    wt = t((6 * h, 2 * h), math.sqrt(1.0 / (2 * h)))
    for site in ("freq", "time"):
        length, bsz = geo[site]
        x = (t((length, h, bsz), 0.5), t((length, h, bsz), 0.5))
        k2 = functools.partial(sru_fused._k2_forward, *x, wt, vb, True)
        got, again = torch.stack(k2()), torch.stack(k2())
        want = torch.stack(sru_fused.sru_hidden_layer_plain(*x, wt, vb, True))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same = torch.equal(got, again)
        g2 = sru_fused.k2_fwd_geometry(length, h, bsz)
        print(f"wide H {h} site={site} L={length} B={bsz}: sru_hidden_layer "
              f"streamed {g2['stream']} (units {g2['units']} x "
              f"{g2['slices']} slices, bt {g2['bt']}, {g2['kslices']} k "
              f"slices a chunk, {g2['smem']} bytes of shared memory) "
              f"max_abs_err={err:.3e} (tol {TOL['sru_hidden_layer']:.0e}) "
              f"ms={time_cuda(k2, 10):.5f}; two calls bit-identical {same}")
        if not (g2["stream"] and err <= TOL["sru_hidden_layer"] and same):
            raise AssertionError(f"wide H {h} {site}: K2 forward disagrees "
                                 "with its plain version, or two calls "
                                 "differ")

    for h in WIDE_HIDDEN:
        cpu = torch.nn.Sequential(
            DualPathRNN(c, h, dim=4, kernel_size=k, num_layers=layers),
            DualPathRNN(c, h, dim=3, kernel_size=k, num_layers=layers))
        init_weights(cpu, torch.Generator().manual_seed(h))
        card = copy.deepcopy(cpu).to("cuda")
        per_fwd = _sum_launches(
            *[rnn_launches(c, h, k, layers) for _ in range(2)])
        routes = [f"dim {m.dim}: fused stack {m.rnn.uses_fused_stack}"
                  for m in cpu]
        print(f"wide H {h}: {'; '.join(routes)}; launches a forward "
              f"{per_fwd}")
        x = torch.from_numpy(rng.standard_normal((1, c, t_len, f_len)).astype(
            np.float32))
        kernel_lib.reset_launches()
        with torch.no_grad():
            got = card(x.cuda()).cpu()
        launches = dict(kernel_lib.LAUNCHES)
        with torch.no_grad():
            want = cpu(x)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        print(f"wide H {h}: bs=1 card vs cpu max_abs_err={err:.3e} "
              f"max|out|={scale:.3e} (tol {SERVE_REL_TOL:.0e} * max|out|); "
              f"launches {launches}")
        if launches != per_fwd:
            raise AssertionError(f"wide H {h}: launches {launches} != "
                                 f"{per_fwd}")
        if not (got.shape == want.shape and err <= SERVE_REL_TOL * scale):
            raise AssertionError(f"wide H {h}: card and CPU outputs disagree")

        x = torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, c, t_len, f_len)).astype(np.float32))
        tgt = torch.from_numpy(rng.standard_normal(x.shape).astype(
            np.float32))

        def step(dev, dtype, cudnn):
            m = copy.deepcopy(cpu).to(dev, dtype)
            torch.backends.cudnn.enabled = cudnn
            try:
                loss = (m(x.to(dev, dtype)) - tgt.to(dev, dtype)).square(
                    ).mean()
                loss.backward()
            finally:
                torch.backends.cudnn.enabled = True
            return loss.item(), {n: p.grad.to("cpu", torch.float64)
                                 for n, p in m.named_parameters()}, {}, 0.0

        kernel_lib.reset_launches()
        on, off = f"wide H {h} card", f"wide H {h} card, cuDNN off"
        res = {on: step("cuda", torch.float32, True)}
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)
        res[off] = step("cuda", torch.float32, False)
        ref = {"cpu": step("cpu", torch.float32, True),
               "float64": step("cpu", torch.float64, True)}
        expect = _sum_launches(per_fwd, {n.replace("_fwd", "_bwd"): v
                                         for n, v in per_fwd.items()})
        print(f"wide H {h}: bs={TRAIN_BATCH} train step launches {launches} "
              f"(expected {expect})")
        if launches != expect:
            raise AssertionError(f"wide H {h}: step launches {launches}")
        hold_train_step(res, ref, on, off, label=f"wide H {h}", stats=False)


# phase 11: the corpus's mixtures a split (2 s each, seed 0), the epochs
# of the train entry (the last one's row is the measurement: the first
# pays the step's warm-up), the tt mixture cut short (its index, its
# samples: 1.6 s and 40 mouth frames) so that a bs-3 batch pads it, and
# the evaluation rows' limits (the SNR columns in dB)
FILE_CORPUS = {"tr": 32, "cv": 2, "tt": 5}
FILE_EPOCHS = 2
SHORT_MIXTURE = (1, 25600)
EVAL_ROW_TOL = {"si-snr": 1e-2, "si-snr_i": 1e-2, "sdr": 1e-2, "sdr_i": 1e-2,
                "stoi": 1e-3, "pesq": 2e-2}
# the evaluation runs (label, batch size, on the CPU), and the pairs held
# together: bs 2 pairs each mixture's two samples (n_src-1 doubling), so
# it pads nothing and must equal bs 1; bs 3 pads the short mixture's
# samples and ends on a batch of one, so it is held against the CPU at
# the same batching
FILE_EVAL_RUNS = (("card bs 1", 1, False), ("card bs 2", 2, False),
                  ("card bs 3", 3, False), ("cpu bs 1", 1, True),
                  ("cpu bs 3", 3, True))
FILE_EVAL_PAIRS = (("card bs 1", "cpu bs 1"), ("card bs 2", "card bs 1"),
                   ("card bs 3", "cpu bs 3"))


def file_launches(steps: int, forwards: int) -> dict:
    """K1/K2/K3 launches of ``steps`` train steps (``TRAIN_LAUNCHES`` each)
    and ``forwards`` more forwards (validation or evaluation batches,
    ``SERVE_LAUNCHES`` each)."""
    out = {k: steps * v for k, v in TRAIN_LAUNCHES.items() if steps}
    for k, v in SERVE_LAUNCHES.items():
        if forwards:
            out[k] = out.get(k, 0) + forwards * v
    return out


def shorten_mixture(split_dir: str, index: int, n_samples: int,
                    sample_rate: int = 16000, fps: int = 25) -> str:
    """Cut the ``index``-th mixture of an LRS2-layout split (``mix.json``,
    ``s1.json``, ``s2.json``) to its first ``n_samples``: its mixture and
    source wavs, its mouths to the frames that cover them, and the lengths
    in the manifests. Returns the mixture's file name (the test set's
    key)."""
    import os

    from rtfs_tpu_torch.data.wav import read_wav, write_wav

    frames = -(-n_samples * fps // sample_rate)
    for name in ("mix", "s1", "s2"):
        path = os.path.join(split_dir, f"{name}.json")
        with open(path) as f:
            infos = json.load(f)
        entry = infos[index]
        write_wav(entry[0], read_wav(entry[0])[:n_samples], sample_rate)
        if name != "mix":
            with np.load(entry[1]) as z:
                mouths = z["data"][:frames]
            np.savez_compressed(entry[1], data=mouths)
        entry[-1] = n_samples
        with open(path, "w") as f:
            json.dump(infos, f)
    return os.path.basename(entry[0])


def compare_rows(got: list, want: list, label: str) -> dict:
    """The largest difference a column of ``EVAL_ROW_TOL`` between two
    evaluation runs' rows (the same utterances in the same order); raises
    where one passes its limit or a value is not finite."""
    if [r["snt_id"] for r in got] != [r["snt_id"] for r in want]:
        raise AssertionError(f"{label}: the runs scored other utterances")
    worst = dict.fromkeys(EVAL_ROW_TOL, 0.0)
    for g, w in zip(got, want):
        for k, tol in EVAL_ROW_TOL.items():
            d = abs(g[k] - w[k])
            if not (math.isfinite(g[k]) and d <= tol):
                raise AssertionError(f"{label}: {k} {g[k]} against {w[k]} "
                                     f"(limit {tol}) for {g['snt_id']}")
            worst[k] = max(worst[k], d)
    print(f"{label}: largest row difference {worst} (limits {EVAL_ROW_TOL})")
    return worst


def files(conf) -> dict:
    """Phase 11: train from files and evaluate. (a) A seed-0 corpus from
    ``tools/make_synth_corpus.py`` (``FILE_CORPUS`` mixtures a split,
    LRS2 layout), one ``tt`` mixture cut short (``SHORT_MIXTURE``). (b)
    ``PrefetchLoader`` batches of ``tr``, pinned and copied to the card,
    against the synchronous ``AVSpeechDataset.batches()`` over the same
    plan, bit for bit. (c) ``train.main`` on the preset from ``tr`` /
    ``cv``: ``FILE_EPOCHS`` epochs at batch 4, launching exactly
    ``file_launches`` (8/24/8 forward and backward a step, 8/24/8 a
    validation forward), and ``best_model.pt`` exported; the last epoch's
    row is the measurement. (d) The evaluation entry ``rtfs_tpu_torch.
    test`` on ``tt`` with that bundle, the metrics warmed first, in
    ``FILE_EVAL_RUNS`` (8/24/8 a forward on the card): example wavs to
    ``SERVE_REL_TOL`` of max and rows to ``EVAL_ROW_TOL`` for each pair of
    ``FILE_EVAL_PAIRS``. Returns the launches of (c) and of the card's
    bs-1 evaluation."""
    import os
    import tempfile

    from rtfs_tpu_torch import test as eval_entry
    from rtfs_tpu_torch.data import (AVSpeechDataset, PrefetchLoader,
                                     pin_and_copy)
    from rtfs_tpu_torch.data.wav import read_wav
    from rtfs_tpu_torch.metrics import ALLMetricsTracker
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.train import main as train_main

    data = conf["data"]
    sr = data["sample_rate"]
    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "tools", "make_synth_corpus.py"), "--out", corpus,
             "--train", str(FILE_CORPUS["tr"]),
             "--val", str(FILE_CORPUS["cv"]),
             "--test", str(FILE_CORPUS["tt"]), "--seed", "0"],
            check=True, capture_output=True, text=True, timeout=300)
        split = {k: os.path.join(corpus, k) for k in FILE_CORPUS}
        short = shorten_mixture(split["tt"], *SHORT_MIXTURE, sample_rate=sr)
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, names in os.walk(corpus) for f in names)
        print(f"files: corpus {FILE_CORPUS} mixtures of 2 s, tt's {short} "
              f"cut to {SHORT_MIXTURE[1]} samples, {n_bytes} bytes, "
              f"written in {time.perf_counter() - t0:.3f} s")

        # (b) the loader's batches on the card against the synchronous path
        kw = dict(n_src=conf["audionet"]["n_src"], sample_rate=sr,
                  segment=data["segment"],
                  normalize_audio=data.get("normalize_audio", False))
        train_set = AVSpeechDataset(split["tr"], **kw)
        t0 = time.perf_counter()
        got = list(PrefetchLoader(train_set, TRAIN_BATCH, num_workers=8,
                                  place=pin_and_copy("cuda")).epoch(
                                      seed=0, epoch=0))
        torch.cuda.synchronize()
        t_loader = time.perf_counter() - t0
        want = list(train_set.batches(TRAIN_BATCH, seed=0, epoch=0))
        if len(got) != len(want) or not want:
            raise AssertionError(f"files: loader gave {len(got)} batches, "
                                 f"the synchronous path {len(want)}")
        for g, w in zip(got, want):
            if g.keys() != w.keys() or g["key"] != w["key"]:
                raise AssertionError("files: loader batch keys differ")
            for k in w:
                if k != "key" and not (g[k].is_cuda and np.array_equal(
                        g[k].cpu().numpy(), w[k])):
                    raise AssertionError(f"files: loader field {k} differs")
        print(f"files: {len(got)} loader batches of {TRAIN_BATCH} equal the "
              f"synchronous path bit for bit; loader epoch "
              f"{t_loader:.3f} s")
        del got

        # (c) the train entry from the files
        val_forwards = len(AVSpeechDataset(split["cv"], **kw).batch_index_plan(
            TRAIN_BATCH, shuffle=False))
        kernel_lib.reset_launches()
        t0 = time.perf_counter()
        train_main.cli([
            "--conf-dir", PRESET, "--data.train_dir", split["tr"],
            "--data.valid_dir", split["cv"],
            "--training.epochs", str(FILE_EPOCHS), "--log.path", root])
        torch.cuda.synchronize()
        train_launches = dict(kernel_lib.LAUNCHES)
        exp_dir = os.path.join(root, conf["log"]["exp_name"])
        with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = sum(r["steps"] for r in rows)
        expect = file_launches(steps, len(rows) * val_forwards)
        print(f"files: train entry {time.perf_counter() - t0:.3f} s, "
              f"{len(rows)} epochs of {rows[-1]['steps']} steps and "
              f"{val_forwards} validation forward(s), launches "
              f"{train_launches} (expected {expect})")
        if (len(rows) != FILE_EPOCHS or train_launches != expect
                or steps != FILE_EPOCHS * (len(train_set) // TRAIN_BATCH)):
            raise AssertionError(f"files: train launches {train_launches}")
        for row in rows:
            if not (math.isfinite(row["train_loss"])
                    and math.isfinite(row["val_loss"])):
                raise AssertionError(f"files: train row {row}")
            print(f"files: epoch {row['epoch']}: {row['secs']} s (train "
                  f"loop {row['train_secs']:.3f} s), wall ms a step "
                  f"{row['train_secs'] / row['steps'] * 1e3:.3f}, loader "
                  f"wait {row['loader_wait']:.4f} s (first batch "
                  f"{row['loader_first_wait']:.4f}), wait share "
                  f"{row['loader_wait'] / row['train_secs']:.4f}; train "
                  f"loss {row['train_loss']:.4f}, val loss "
                  f"{row['val_loss']:.4f}")
        if not os.path.exists(os.path.join(exp_dir, "best_model.pt")):
            raise AssertionError("files: no best_model.pt exported")

        # (d) the evaluation entry: the metrics' first calls kept out of
        # the timed runs, then the card's and the CPU's runs
        t0 = time.perf_counter()
        warm = np.random.default_rng(0).standard_normal(
            (3, 2 * sr)).astype(np.float32)
        ALLMetricsTracker(sample_rate=sr)(warm[0], warm[1:2], warm[2:3],
                                          "warm")
        print(f"files: the metrics' first call {time.perf_counter() - t0:.3f}"
              f" s (kept out of the timed runs)")
        runs = {}
        for label, bs, cpu in FILE_EVAL_RUNS:
            kernel_lib.reset_launches()
            out = eval_entry.main([
                "--conf-dir", os.path.join(exp_dir, "conf.json"),
                "--test-dir", split["tt"], "--batch-size", str(bs),
                "--save-examples", str(2 * FILE_CORPUS["tt"]),
                *(["--cpu"] if cpu else [])])
            if not cpu:
                torch.cuda.synchronize()
            launches = dict(kernel_lib.LAUNCHES)
            n = out["utterances"]
            expect = file_launches(0, 0 if cpu else -(-n // bs))
            examples = os.path.join(exp_dir, "results", "examples")
            est_files = sorted(f for f in os.listdir(examples) if "_est" in f)
            print(f"files: eval {label}: {n} utterances, "
                  f"{n / out['secs']:.3f} utterances/s with the metrics, "
                  f"{n / out['forward_secs']:.3f} in the forward alone; "
                  f"launches {launches} (expected {expect}); mean "
                  f"{ {k: round(v, 4) for k, v in out['mean'].items()} }, "
                  f"backends {out['backends']}")
            if launches != expect or len(est_files) != n:
                raise AssertionError(f"files: eval {label}: launches "
                                     f"{launches}, examples {est_files}")
            out["examples"] = [read_wav(os.path.join(examples, f))
                               for f in est_files]
            out["launches"] = launches
            runs[label] = out
            for f in os.listdir(examples):
                os.remove(os.path.join(examples, f))
    for label, ref in FILE_EVAL_PAIRS:
        got, want = runs[label], runs[ref]
        worst = 0.0
        for g, w in zip(got["examples"], want["examples"], strict=True):
            err = float(np.abs(g - w).max())
            scale = float(np.abs(w).max())
            if g.shape != w.shape or not err <= SERVE_REL_TOL * scale:
                raise AssertionError(f"files: {label} against {ref}: "
                                     f"estimate err {err} of max {scale}")
            worst = max(worst, err / scale)
        print(f"files: {label} against {ref}: estimates (the example wavs) "
              f"max_abs_err {worst:.3e} of max|out| (tol "
              f"{SERVE_REL_TOL:.0e})")
        compare_rows(got["rows"], want["rows"], f"files: {label} against "
                     f"{ref}")
    return {"train": train_launches, "eval": runs["card bs 1"]["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from rtfs_tpu_torch.config import load_config
    from rtfs_tpu_torch.ops import kernel_lib
    from rtfs_tpu_torch.utils.parser import parse_overrides

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    report = kernel_lib.build_all()
    print(f"build: {sorted(report)} in {time.perf_counter() - t0:.3f} s")
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off for cuDNN convolutions and matmuls")

    conf = load_config(PRESET)
    geo = main_path_geometry(conf)
    print(f"geometry: {geo}")
    rng = np.random.default_rng(0)

    kernels = phase("3 forward kernels", check_kernels, geo, rng)
    packed_kernels = phase("7 packed kernels", check_packed_kernels, conf,
                           rng)
    launches = phase("4 serving", serve, conf, rng, SERVE_LAUNCHES)
    packed_run = phase("8 serving from files", serve_packed, conf, rng)
    phase("8 packed latency", packed_latency, conf, rng)
    bwd = phase("5 backward kernels", check_backward_kernels, geo, rng,
                kernels)
    train_launches, ref = phase("6 training", train, conf, TRAIN_LAUNCHES,
                                "training", MAIN_KERNEL_GROUPS)
    wgrads, packed_train = phase("9 packed training", train_packed, conf,
                                 rng, ref)
    conf_uni = parse_overrides(load_config(PRESET), list(UNI_OVERRIDES))
    k4, uni_served, uni_trained = phase("10 unidirectional", unidirectional,
                                        conf_uni, geo, rng)
    phase("wide", wide, geo, rng)
    file_run = phase("11 files", files, conf)
    phase("7b K6, K8/K9 device time", profile_map_kernels, conf, rng)
    phase("9b, 10e K5-wgrad, pw-wgrad, K4 forward device time",
          profile_redesigned, conf, geo, rng)
    phase("7c K5, K7 device time", profile_k5_k7, conf, rng)

    sources = {
        "sru_dual_recurrence": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                "rtfs_tpu/ops/sru_fused.py:108",
                                "sru_dual_recurrence_fwd"),
        "sru_hidden_layer": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                             "rtfs_tpu/ops/sru_fused.py:400",
                             "sru_hidden_layer_fwd"),
        "convt1d_ola_tm": ("rtfs_tpu_torch/csrc/convt_tm.cu",
                           "rtfs_tpu/ops/convt_tm.py:38",
                           "convt1d_ola_tm_fwd"),
        "sru_dual_recurrence_bwd": ("rtfs_tpu_torch/csrc/sru_scan.cuh",
                                    "rtfs_tpu/ops/sru_fused.py:159",
                                    "sru_dual_recurrence_bwd"),
        "sru_hidden_layer_bwd": ("rtfs_tpu_torch/csrc/sru_fused.cu",
                                 "rtfs_tpu/ops/sru_fused.py:458",
                                 "sru_hidden_layer_bwd"),
        "convt1d_ola_tm_bwd": ("rtfs_tpu_torch/csrc/convt_tm.cu",
                               "rtfs_tpu/ops/convt_tm.py:59",
                               "convt1d_ola_tm_bwd"),
        "dw_conv_packed": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                           "rtfs_tpu/ops/packed_tf.py:228",
                           "dw_conv_packed_fwd"),
        "pw_proj_packed": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                           "rtfs_tpu/ops/packed_tf.py:435",
                           "pw_proj_packed_fwd"),
        "pw_unproj_packed": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                             "rtfs_tpu/ops/packed_tf.py:476",
                             "pw_unproj_packed_fwd"),
        "spatial_down_packed": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                                "rtfs_tpu/ops/packed_tf.py:667",
                                "spatial_down_packed_fwd"),
        "spatial_up_packed": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                              "rtfs_tpu/ops/packed_tf.py:712",
                              "spatial_up_packed_fwd"),
        "dw_conv_packed_wgrad": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                                 "rtfs_tpu/ops/packed_tf.py:305",
                                 "dw_conv_packed_wgrad"),
        "pw_packed_wgrad": ("rtfs_tpu_torch/csrc/packed_tf.cu",
                            "rtfs_tpu/ops/packed_tf.py:533",
                            "pw_packed_wgrad"),
        "sru_recurrence": ("rtfs_tpu_torch/csrc/sru_pallas.cu",
                           "rtfs_tpu/ops/sru_pallas.py:53",
                           "sru_recurrence_fwd"),
        "sru_recurrence_bwd": ("rtfs_tpu_torch/csrc/sru_scan.cuh",
                               "rtfs_tpu/ops/sru_pallas.py:91",
                               "sru_recurrence_bwd"),
    }
    line = {"kernels": []}
    for name, (src, rep, fn) in sources.items():
        if name in kernels:  # forward: the serving run, per forward at bs 8
            entry = {"launches": launches.get(fn, 0), **kernels[name],
                     "per_forward_at_batch": 8,
                     "launches_in_file_training": file_run["train"].get(fn, 0),
                     "launches_in_file_eval": file_run["eval"].get(fn, 0)}
        elif name in packed_kernels:  # packed: the packed entry's forward
            entry = {"launches": packed_run.get(fn, 0), **packed_kernels[name],
                     "per_forward_at_batch": 1,
                     "launches_in_packed_training": packed_train.get(fn, 0)}
        elif name in wgrads:  # packed dW: the packed steps, per step at bs 4
            entry = {"launches": packed_train.get(fn, 0), **wgrads[name],
                     "per_train_step_at_batch": TRAIN_BATCH}
        elif name == "sru_recurrence":  # K4: the uni serving run, bs 8
            entry = {"launches": uni_served.get(fn, 0), **k4[name],
                     "per_forward_at_batch": 8,
                     "launches_in_uni_training": uni_trained.get(fn, 0)}
        elif name == "sru_recurrence_bwd":  # K4: the uni steps, bs 4
            entry = {"launches": uni_trained.get(fn, 0), **k4[name],
                     "per_train_step_at_batch": TRAIN_BATCH}
        else:  # backward: the training run, per train step at bs 4
            entry = {"launches": train_launches.get(fn, 0), **bwd[name],
                     "per_train_step_at_batch": TRAIN_BATCH,
                     "launches_in_file_training": file_run["train"].get(fn, 0)}
        line["kernels"].append({"name": name, "route": "cuda", "source": src,
                                "replaces": rep, **entry})
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps(line))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
