"""Measure the card's mma.sync m16n8k8 TF32 rate and latency.

The K2 and K3 forward kernels (``rtfs_tpu_torch/csrc/tf32x3.cuh``) issue
their 3xTF32 products as warp-level ``mma.sync.m16n8k8`` TF32
instructions. This script times a loop of those instructions alone, on
registers, at 1 to 16 independent accumulators a warp and 1 to 16 warps
an SM, and prints TFLOP/s (2 x 16 x 8 x 8 flops an instruction) and the
cycles an instruction takes in one warp (with one accumulator, the
latency from one dependent instruction to the next), beside the card's
name and power limit. Needs one CUDA card and nvcc:

    python3 tools/mma_rate.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

template <int NACC>
__global__ void mma_loop(float* out, int iters, long long* cycles) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[NACC][4];
  for (int n = 0; n < NACC; ++n)
    for (int v = 0; v < 4; ++v) d[n][v] = 0.f;
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < NACC; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  const long long c1 = clock64();
  float s = 0.f;
  for (int n = 0; n < NACC; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = c1 - c0;
}

template <int NACC>
int launch(int blocks, int threads, int iters, void* out, void* cycles,
           void* stream) {
  mma_loop<NACC><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)out, iters, (long long*)cycles);
  return (int)cudaGetLastError();
}

extern "C" int run(int nacc, int blocks, int threads, int iters, void* out,
                   void* cycles, void* stream) {
  switch (nacc) {
    case 1: return launch<1>(blocks, threads, iters, out, cycles, stream);
    case 2: return launch<2>(blocks, threads, iters, out, cycles, stream);
    case 4: return launch<4>(blocks, threads, iters, out, cycles, stream);
    case 8: return launch<8>(blocks, threads, iters, out, cycles, stream);
    case 16: return launch<16>(blocks, threads, iters, out, cycles, stream);
  }
  return 1;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import card_line

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "mma.cu")
        lib_path = os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                        lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    iters = 4096
    print(f"card: {card_line()}; {sms} SMs")
    for warps in (1, 2, 4, 8, 16):
        for nacc in (1, 2, 4, 8, 16):
            args = (nacc, sms, 32 * warps, iters, out.data_ptr(),
                    cycles.data_ptr(), st)
            if lib.run(*args) != 0:
                raise RuntimeError("mma_rate: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                lib.run(*args)
            end.record()
            torch.cuda.synchronize()
            sec = start.elapsed_time(end) / 5 / 1e3
            n_mma = sms * warps * nacc * iters
            tflops = 2 * 16 * 8 * 8 * n_mma / sec / 1e12
            per = cycles.item() / (iters * nacc)
            print(f"warps/SM {warps:2d} accumulators/warp {nacc:2d}: "
                  f"{tflops:7.1f} TFLOP/s TF32, {per:6.2f} cycles an mma "
                  f"in warp 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
