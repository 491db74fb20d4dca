// The BPTT adjoint scan of an SRU recurrence for Hopper (sm_90a), float32,
// shared by three backward ops: K1 sru_dual_recurrence_bwd and K2
// sru_hidden_layer_bwd (csrc/sru_fused.cu) and K4 sru_recurrence_bwd
// (csrc/sru_pallas.cu). Each op says where its operands lie with one
// ScanIO a direction; nothing is copied or flipped in memory. K4's bf16
// backward (sru_recurrence_bwd_bf16) runs the same scan on bf16 storage
// (ScanTypes below): the arithmetic stays float32, as in the Pallas
// kernels. K1's and K2's bf16 backwards run the same adjoints in kernels
// of their own (sru_lay0_bwd16_kernel and sru_hid_bwd_bf16_kernel in
// csrc/sru_fused.cu).
//
// The adjoints, per step in reverse scan order (a forward-running
// recurrence from t = T-1 down with c_prev = c[t-1], a reverse-running one
// from t = 0 up with c_prev = c[t+1]; c_prev = 0 at the scan's end):
//   dr = dh (c_t - hw); dm = dr r (1 - r); dc = dh r + dm v_r + dc_next
//   df = dc (c_prev - u0); da = df f (1 - f)
//   du = [dc (1 - f), da, dm]; dhw = dh (1 - r); dc_prev = dc f + da v_f
//   d(v_f, v_r, b_f, b_r) += (da c_prev, dm c_t, da, dm)
// with f = sigmoid(u1 + v_f c_prev + b_f), r = sigmoid(u2 + v_r c_t + b_r).
//
// What bounds it on the H100. Per (step, unit, column, direction) the
// scan reads six floats (u0, u1, u2, the highway term, dh, c_prev) and
// writes four (du's three rows, dhw): 40 bytes for ~35 flops, so by the
// roofline it is bound by memory bytes (at the bs-4 training sites 11-23
// us a launch at 3.35 TB/s). What crosses steps is dc alone, a chain of
// five dependent operations a step; the gates f and r read only loaded
// values. So the scan runs at its bytes bound only if enough loads are in
// flight, about 2.3 MB across the card (3.35 TB/s x ~700 ns), from as few
// as 8,192 threads (K4 at the bs-4 time site). The design:
//   - one thread per (unit, column, direction), neighbouring threads on
//     neighbouring columns, so each copy and store of a warp is 128
//     coalesced bytes; dc and the four (v, b) sums stay in registers;
//   - each thread keeps the cp.async copies of its next kScanAhead steps
//     in flight in its own ring in shared memory (no thread reads
//     another's slots, so no barrier), one commit group a step: it waits
//     for the groups of its next kScanGroup steps, takes their values,
//     refills those slots with the steps kScanAhead later, computes the
//     steps' gates together (independent, so their latencies overlap),
//     then runs the chain over them; c_t is the last step's c_prev,
//     carried in a register, so c is read once a step;
//   - blocks of 32-128 threads (columns x units, ops/sru_fused.
//     scan_bwd_geometry), the largest whose grid has a block an SM, so
//     that the few threads of a small launch spread over the SMs;
//   - the (v, b) sums reduced per unit within the block (a warp lies in
//     one unit) and written as one partial per column block, which the
//     caller adds in a fixed order: no float atomics, so two calls give
//     the same bits.
// u and du may be the same memory (K2 writes du over U in place): a step's
// copy is issued kScanAhead steps before its own stores and reads only its
// own step's rows, which no earlier step writes.
//
// Measured on the H100 (tools/kernel_variants.py scan, PERF.md): depth 8
// with 2 steps a wait was the fastest of depths 4-16 and 1-2 a wait. K1's
// launches read and write at ~74% of the bytes bound; streaming stores
// and smaller blocks did not move them. Where the threads are fewest (K4
// at the bs-4 time site: 2 warps an SM) a step costs each thread its
// instructions, ~220 ns with the IEEE sigmoid, so that launch reaches
// ~45% of its bound; moving the offsets by one step instead of
// multiplying them out cut it by a fifth.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

// threads a block, at most (ops/sru_fused.py mirrors the three)
constexpr int kScanThreads = 128;
// steps whose copies each thread keeps in flight ahead of the chain
constexpr int kScanAhead = 8;
// steps a thread takes per wait, their gates computed together
constexpr int kScanGroup = 2;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// One direction of the scan. Row j of step t of u (rows [x~, f, r]), of
// the highway input, of du (rows [x~, f, r]) and of the highway term's
// adjoint starts at ptr + t * step + j * B, rows of one step H * B apart;
// c and dh are (T, H, B); vb holds the rows v_f, v_r, b_f, b_r of H; the
// partial sums d(v_f, v_r, b_f, b_r) of column block x go to part + x *
// part_stride + k * H. reverse: the recurrence ran t = T-1 .. 0, so the
// scan walks t = 0 .. T-1. TU is the type of u, du and the highway term's
// adjoint, TS that of the highway input, c, dh and vb. In bf16 storage,
// u_last, xhw_last and s_last are the index of the last value of the
// array that u, xhw and c (dh) point into, counted from that pointer.
template <typename TU, typename TS>
struct ScanIOT {
  const TU* u;
  const TS* xhw;
  TU* du;
  TU* dhw;
  long long u_step, xhw_step, du_step, dhw_step;
  const TS* c;
  const TS* dh;
  const TS* vb;
  float* part;
  int reverse;
  long long u_last, xhw_last, s_last;
};
using ScanIO = ScanIOT<float, float>;

// The storage of each launch, by its Kernel number (which also tells the
// launches apart in a profile): K1 (1), K2 (2) and K4 (4) in float32; K4
// in bf16 (14): every operand bf16, du rounded once, and each thread's
// (v, b) sums (one unit over one batch column) rounded to bf16 before the
// block adds them (kRoundParts: the Pallas kernel writes one bf16 partial
// a batch column, which jnp.sum widens and adds in float32).
template <int Kernel>
struct ScanTypes {
  using TU = float;
  using TS = float;
  static constexpr bool kRoundParts = false;
};
template <>
struct ScanTypes<14> {
  using TU = __nv_bfloat16;
  using TS = __nv_bfloat16;
  static constexpr bool kRoundParts = true;
};

// Copy value e of src into a thread's ring slot (4 bytes). float32: one
// 4-byte cp.async. bf16: cp.async has no 2-byte copy, so the thread copies
// the 4-byte-aligned word that holds the value (any offset: B odd
// included, no alignment asked of the caller; the word lies inside the
// value's allocation) and takes its half when it reads the slot
// (slot_value); where the value is the array's last (e == last) and opens
// its word, only its 2 bytes are read.
__device__ __forceinline__ void copy_value(float* dst, const float* src,
                                           long long e, long long, bool ok) {
  hk::cp_async4(dst, src + e, ok);
}
__device__ __forceinline__ void copy_value(float* dst,
                                           const __nv_bfloat16* src,
                                           long long e, long long last,
                                           bool ok) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src + e);
  const int bytes = !ok ? 0 : (e == last && !(a & 2)) ? 2 : 4;
  hk::cp_async4_n(dst, reinterpret_cast<const void*>(a & ~uintptr_t(3)),
                  bytes);
}

// Whether value e0 + i * step of base lies in the upper half of its word
// (bf16), from parities alone.
template <typename T>
__device__ __forceinline__ unsigned upper_half(const T* base, long long e0,
                                               long long step, int i) {
  return (unsigned)(((reinterpret_cast<uintptr_t>(base) >> 1) ^
                     (uintptr_t)e0 ^ (uintptr_t)(i & step)) & 1);
}

// A slot's value as float32: the float itself, or the bf16 half of the
// word (upper or lower) widened, exactly.
template <typename T>
__device__ __forceinline__ float slot_value(const float* d, unsigned upper) {
  if constexpr (sizeof(T) == 4) {
    return *d;
  } else {
    const uint32_t w = __float_as_uint(*d);
    return __uint_as_float(upper ? (w & 0xffff0000u) : (w << 16));
  }
}

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(B / cols), ceil(H / units), directions), cols * units
// threads, cols a multiple of 32: thread (column x * cols + tid % cols,
// unit y * units + tid / cols) of direction z reads io0 (z = 0) or io1.
// Kernel tells K1's launches (1), K2's (2) and K4's (4) apart in a
// profile, and picks the storage (ScanTypes; 14 the bf16 one).
template <int Kernel>
__global__ void __launch_bounds__(kScanThreads)
sru_scan_bwd_kernel(ScanIOT<typename ScanTypes<Kernel>::TU,
                            typename ScanTypes<Kernel>::TS> io0,
                    ScanIOT<typename ScanTypes<Kernel>::TU,
                            typename ScanTypes<Kernel>::TS> io1,
                    int T, int H, int B, int cols, long long part_stride) {
  using TU = typename ScanTypes<Kernel>::TU;
  using TS = typename ScanTypes<Kernel>::TS;
  extern __shared__ float ring[];  // (kScanAhead, 6, blockDim.x)
  __shared__ float red[kScanThreads / 32][4];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int units = nt / cols, j0 = blockIdx.y * units;
  const int b = blockIdx.x * cols + tid % cols, j = j0 + tid / cols;
  const ScanIOT<TU, TS> io = blockIdx.z == 0 ? io0 : io1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // d(v_f, v_r, b_f, b_r)
  if (b < B && j < H) {
    const float v_f = load_value(io.vb + j), v_r = load_value(io.vb + H + j);
    const float b_f = load_value(io.vb + 2 * H + j);
    const float b_r = load_value(io.vb + 3 * H + j);
    const long long hb = (long long)H * B, col = (long long)j * B + b;
    // offsets of the next step to copy (scan index k = 0, 1, ... in
    // order) and of the next to store, each moved by one step at a time:
    // step t of u at ou, of the highway at ox, of dh at og, c_prev at og +
    // dt; no multiply in the loop
    const long long dt = io.reverse ? hb : -hb;
    const int t0 = io.reverse ? 0 : T - 1;
    long long ou = t0 * io.u_step + col, ox = t0 * io.xhw_step + col;
    long long og = t0 * hb + col;
    long long od = t0 * io.du_step + col, ow = t0 * io.dhw_step + col;
    const long long su = io.reverse ? io.u_step : -io.u_step;
    const long long sx = io.reverse ? io.xhw_step : -io.xhw_step;
    const long long sd = io.reverse ? io.du_step : -io.du_step;
    const long long sw = io.reverse ? io.dhw_step : -io.dhw_step;
    const long long ou0 = ou, ox0 = ox, og0 = og;  // scan index 0's
    float* mine = ring + tid;  // slot s, value v: mine[(6 s + v) nt]
    // scan step k into slot k % kScanAhead as one commit group: u0, u1,
    // u2, the highway term, dh and c_prev; zero past the scan's end (the
    // copy then reads nothing; its address is kept in bounds)
    int k = 0;
    auto issue = [&]() {
      float* d = mine + (k % kScanAhead) * 6 * nt;
      const bool ok = k < T, ok_c = k + 1 < T;
      const long long eu = ok ? ou : 0;
      copy_value(d, io.u, eu, io.u_last, ok);
      copy_value(d + nt, io.u, eu + hb, io.u_last, ok);
      copy_value(d + 2 * nt, io.u, eu + 2 * hb, io.u_last, ok);
      copy_value(d + 3 * nt, io.xhw, ok ? ox : 0, io.xhw_last, ok);
      copy_value(d + 4 * nt, io.dh, ok ? og : 0, io.s_last, ok);
      copy_value(d + 5 * nt, io.c, ok_c ? og + dt : 0, io.s_last, ok_c);
      hk::cp_async_commit();
      ++k;
      ou += su;
      ox += sx;
      og += dt;
    };
#pragma unroll
    for (int i = 0; i < kScanAhead; ++i) issue();
    float c_t = load_value(io.c + t0 * hb + col);
    float dc = 0.f;
    for (int i0 = 0; i0 < T; i0 += kScanGroup) {
      // the groups of steps i0 .. i0 + kScanGroup - 1 are in; the compiler
      // barriers keep the slots' reads between the wait and the refill
      hk::cp_async_wait<kScanAhead - kScanGroup>();
      asm volatile("" ::: "memory");
      float u0[kScanGroup], u1[kScanGroup], u2[kScanGroup];
      float hw[kScanGroup], g[kScanGroup], cp[kScanGroup];
#pragma unroll
      for (int s = 0; s < kScanGroup; ++s) {
        const int i = i0 + s;
        const float* d = mine + (i % kScanAhead) * 6 * nt;
        u0[s] = slot_value<TU>(d, upper_half(io.u, ou0, su, i));
        u1[s] = slot_value<TU>(d + nt, upper_half(io.u, ou0 + hb, su, i));
        u2[s] = slot_value<TU>(d + 2 * nt,
                               upper_half(io.u, ou0 + 2 * hb, su, i));
        hw[s] = slot_value<TS>(d + 3 * nt, upper_half(io.xhw, ox0, sx, i));
        g[s] = slot_value<TS>(d + 4 * nt, upper_half(io.dh, og0, dt, i));
        cp[s] = slot_value<TS>(d + 5 * nt, upper_half(io.c, og0 + dt, dt, i));
      }
      asm volatile("" ::: "memory");
#pragma unroll
      for (int s = 0; s < kScanGroup; ++s) issue();  // i0 + kScanAhead + s
      // the gates, off the chain
      float ct[kScanGroup], f[kScanGroup], r[kScanGroup], dm[kScanGroup];
#pragma unroll
      for (int s = 0; s < kScanGroup; ++s) {
        ct[s] = s == 0 ? c_t : cp[s - 1];
        f[s] = sigmoid_f(u1[s] + v_f * cp[s] + b_f);
        r[s] = sigmoid_f(u2[s] + v_r * ct[s] + b_r);
        dm[s] = g[s] * (ct[s] - hw[s]) * r[s] * (1.f - r[s]);
      }
      // the chain in dc
#pragma unroll
      for (int s = 0; s < kScanGroup; ++s) {
        if (i0 + s >= T) break;
        dc = g[s] * r[s] + dm[s] * v_r + dc;
        const float da = dc * (cp[s] - u0[s]) * f[s] * (1.f - f[s]);
        TU* dut = io.du + od;
        store_value(dut, dc * (1.f - f[s]));
        store_value(dut + hb, da);
        store_value(dut + 2 * hb, dm[s]);
        store_value(io.dhw + ow, g[s] * (1.f - r[s]));
        od += sd;
        ow += sw;
        acc[0] += da * cp[s];
        acc[1] += dm[s] * ct[s];
        acc[2] += da;
        acc[3] += dm[s];
        dc = dc * f[s] + da * v_f;
      }
      c_t = cp[kScanGroup - 1];
    }
    hk::cp_async_wait_all();  // the zero-fill copies past the end
  }
  // the (v, b) sums of each unit over the block's columns: each warp's by
  // shuffles, then the unit's cols / 32 warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = acc[k];
    if constexpr (ScanTypes<Kernel>::kRoundParts)
      v = __bfloat162float(__float2bfloat16_rn(v));
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  const int per = cols / 32;
  if (tid < 4 * units && j0 + tid / 4 < H) {
    const int uu = tid / 4, k = tid % 4;
    float s = 0.f;
    for (int w = 0; w < per; ++w) s += red[uu * per + w][k];
    io.part[blockIdx.x * part_stride + (long long)k * H + j0 + uu] = s;
  }
}

// The block shapes the scan takes: cols a multiple of 32, 32 to
// kScanThreads threads.
inline bool scan_layout_ok(int T, int H, int B, int cols, int units) {
  return T >= 1 && H >= 1 && B >= 1 && cols >= 32 && cols % 32 == 0 &&
         units >= 1 && cols * units <= kScanThreads;
}

// Launches the scan over dirs (1 or 2) directions; cudaErrorInvalidValue
// for a block shape it does not take. The ring holds a 4-byte word a value
// in either storage, so its shared memory does not depend on the dtype.
template <int Kernel>
cudaError_t launch_scan_bwd(
    const ScanIOT<typename ScanTypes<Kernel>::TU,
                  typename ScanTypes<Kernel>::TS>& io0,
    const ScanIOT<typename ScanTypes<Kernel>::TU,
                  typename ScanTypes<Kernel>::TS>& io1,
    int dirs, int T, int H, int B, int cols, int units,
    long long part_stride, cudaStream_t stream) {
  if (!scan_layout_ok(T, H, B, cols, units) || dirs < 1 || dirs > 2)
    return cudaErrorInvalidValue;
  const int threads = cols * units;
  const size_t smem = (size_t)kScanAhead * 6 * threads * sizeof(float);
  // above 48 KB with the kernel's static reduction buffer: opt in
  if (smem + sizeof(float) * 4 * kScanThreads / 32 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)sru_scan_bwd_kernel<Kernel>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + cols - 1) / cols, (H + units - 1) / units, dirs);
  sru_scan_bwd_kernel<Kernel><<<grid, threads, smem, stream>>>(
      io0, io1, T, H, B, cols, part_stride);
  return cudaGetLastError();
}

}  // namespace
