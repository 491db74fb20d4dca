// Gen-1 SRU recurrence kernels for Hopper (sm_90a), float32.
//
// K4  sru_recurrence_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_fwd_impl).
// K4  sru_recurrence_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_vjp_bwd).
//
// One direction of one SRU layer over a precomputed projection (sru
// package v2.6 semantics: the reset gate reads the UPDATED cell, see
// rtfs_tpu/ops/sru.py):
//   f_t = sigmoid(u1_t + v_f * c_{t-1} + b_f)
//   c_t = f_t * c_{t-1} + (1 - f_t) * u0_t
//   r_t = sigmoid(u2_t + v_r * c_t + b_r)
//   h_t = r_t * c_t + (1 - r_t) * xhw_t
// Layouts are the Pallas op's boundary layouts, time-major with the folded
// batch fastest: u (T, 3H, B) with row blocks [x~, f, r]; xhw, h, c, dh,
// dxhw (T, H, B); vb (4, H) = [v_f, v_r, b_f, b_r]. T and B are taken as
// they come: the Pallas op pads T to 32 and B to 128 lanes, here the ragged
// edge is masked.
//
// The reverse direction of a bidirectional layer (k = 3, input 2H) is a
// flag: reverse != 0 walks t = T-1 .. 0, as K1 walks u_r, where the JAX op
// flips u and xhw in memory before the call and h after it.
//
// Forward: one thread per (unit j, batch column b), neighbouring threads on
// neighbouring b, so every (t, row, .) load and store is coalesced. The
// thread walks all T steps with c in a register (the Pallas kernel carried
// it across its sequential grid's time chunks in a VMEM scratch); v_f, v_r,
// b_f, b_r are per-unit scalars in registers (no lane-replicated vb). The
// cell states c are written only when the caller passes a c pointer
// (training); serving passes null.
//
// Backward (BPTT), the adjoints of _bwd_kernel, per step in reverse scan
// order with c_prev read from the saved c one step back in scan order
// (zero at the scan's start) and carried to the next step in a register,
// so the shifted c stream the Pallas op builds is not needed:
//   dr = dh (c_t - xhw); dm = dr r (1 - r); dc = dh r + dm v_r + dc_next
//   df = dc (c_prev - u0); da = df f (1 - f)
//   du = [dc (1 - f), da, dm]; dxhw = dh (1 - r); dc_prev = dc f + da v_f
//   d(v_f, v_r, b_f, b_r) += (da c_prev, dm c_t, da, dm)
// dc and the four sums stay in f32 registers. Each block sums its columns'
// (v, b) terms in a fixed order and writes one partial; the wrapper adds
// the partials in a fixed order. No float atomics, so two calls give the
// same bits.
//
// What bounds it on the H100. Per (step, column) over the H units the
// forward moves (3H + H + H) x 4 = 640 bytes at H = 32 (768 with c) for
// ~20 flops a unit, the backward 1280 bytes (reads u, xhw, c, dh; writes
// du, dxhw) for ~35: by the roofline both are bound by memory bytes. At the
// RTFS-Net-4 training shapes (freq scan T 57 over B 500, time scan T 118
// over B 256, bs 4) that is 6.5-6.9 us forward with c and 10.9-11.5 us
// backward at 3.35 TB/s. In practice the kernel is bound by the latency of
// T dependent steps: each thread's gate chain (two sigmoids, the cell
// update) cannot start before the previous step's c. At bs 1 the launch has
// only H x B = 4000 threads, a few warps a SM, so nothing hides that chain.
// The design unrolls the time loop so that the loads of later steps (which
// do not depend on c) start ahead of the chain. Splitting units across more
// threads, or several columns per thread, is left for later work.

#include <cuda_runtime.h>

namespace {

// block size, forward and backward; ops/sru_pallas.py sizes the backward's
// dvb partial buffer with the same constant
constexpr int kThreads = 128;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// grid (ceil(B / kThreads), H), one thread per (column b, unit j).
__global__ void sru_rec_fwd_kernel(const float* __restrict__ u,
                                   const float* __restrict__ xhw,
                                   const float* __restrict__ vb,
                                   float* __restrict__ h,
                                   float* __restrict__ cs,
                                   int T, int H, int B, int reverse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (b >= B) return;
  const float v_f = vb[j], v_r = vb[H + j];
  const float b_f = vb[2 * H + j], b_r = vb[3 * H + j];
  const long long row = (long long)H * B;  // one gate block per step
  const long long col = (long long)j * B + b;
  float c = 0.f;
#pragma unroll 4
  for (int i = 0; i < T; ++i) {
    const int t = reverse ? T - 1 - i : i;
    const float* ut = u + (long long)t * 3 * row + col;
    const float u0 = ut[0], u1 = ut[row], u2 = ut[2 * row];
    const long long o = (long long)t * row + col;
    const float x = xhw[o];
    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
    h[o] = r * c + (1.f - r) * x;
    if (cs) cs[o] = c;
  }
}

// Sums v over the block's threads with warp shuffles and a shared-memory
// pass over the warps, in a fixed order; the result is valid in thread 0.
// Every thread must call it; red holds blockDim / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free (a previous call may still read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// grid (ceil(B / kThreads), H), one thread per (column b, unit j). Writes
// du, dxhw and, per block, dvb_part[blockIdx.x][k][j], the sums of the
// block's columns.
__global__ void sru_rec_bwd_kernel(const float* __restrict__ u,
                                   const float* __restrict__ xhw,
                                   const float* __restrict__ vb,
                                   const float* __restrict__ cs,
                                   const float* __restrict__ dh,
                                   float* __restrict__ du,
                                   float* __restrict__ dxhw,
                                   float* __restrict__ dvb_part,
                                   int T, int H, int B, int reverse) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const bool live = b < B;
  const float v_f = vb[j], v_r = vb[H + j];
  const float b_f = vb[2 * H + j], b_r = vb[3 * H + j];
  const long long row = (long long)H * B;
  const long long col = (long long)j * B + (live ? b : 0);
  float dc = 0.f, a_vf = 0.f, a_vr = 0.f, a_bf = 0.f, a_br = 0.f;
  if (live) {
    // reverse scan order: forward from t = T-1 down, reverse from t = 0
    // up; the c_t of a step is the c_prev of the step before it
    float c_t = cs[(long long)(reverse ? 0 : T - 1) * row + col];
#pragma unroll 2
    for (int i = 0; i < T; ++i) {
      const int t = reverse ? i : T - 1 - i;
      const int tp = reverse ? t + 1 : t - 1;
      const float c_prev = i + 1 < T ? cs[(long long)tp * row + col] : 0.f;
      const float* ut = u + (long long)t * 3 * row + col;
      const float u0 = ut[0], u1 = ut[row], u2 = ut[2 * row];
      const long long o = (long long)t * row + col;
      const float x = xhw[o];
      const float g = dh[o];
      const float f = sigmoid_f(u1 + v_f * c_prev + b_f);
      const float r = sigmoid_f(u2 + v_r * c_t + b_r);
      const float dm = g * (c_t - x) * r * (1.f - r);
      dc = g * r + dm * v_r + dc;
      const float da = dc * (c_prev - u0) * f * (1.f - f);
      float* dut = du + (long long)t * 3 * row + col;
      dut[0] = dc * (1.f - f);
      dut[row] = da;
      dut[2 * row] = dm;
      dxhw[o] = g * (1.f - r);
      a_vf += da * c_prev;
      a_vr += dm * c_t;
      a_bf += da;
      a_br += dm;
      dc = dc * f + da * v_f;
      c_t = c_prev;
    }
  }
  float* part = dvb_part + (long long)blockIdx.x * 4 * H + j;
  const float s0 = block_sum(a_vf, red);
  if (threadIdx.x == 0) part[0] = s0;
  const float s1 = block_sum(a_vr, red);
  if (threadIdx.x == 0) part[H] = s1;
  const float s2 = block_sum(a_bf, red);
  if (threadIdx.x == 0) part[2 * H] = s2;
  const float s3 = block_sum(a_br, red);
  if (threadIdx.x == 0) part[3 * H] = s3;
}

}  // namespace

// c may be null (serving).
extern "C" int sru_recurrence_fwd(const void* u, const void* xhw,
                                  const void* vb, void* h, void* c, int T,
                                  int H, int B, int reverse, void* stream) {
  dim3 grid((B + kThreads - 1) / kThreads, H);
  sru_rec_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)xhw, (const float*)vb, (float*)h,
      (float*)c, T, H, B, reverse);
  return (int)cudaGetLastError();
}

// dvb_part: (ceil(B / kThreads), 4, H).
extern "C" int sru_recurrence_bwd(const void* u, const void* xhw,
                                  const void* vb, const void* c,
                                  const void* dh, void* du, void* dxhw,
                                  void* dvb_part, int T, int H, int B,
                                  int reverse, void* stream) {
  dim3 grid((B + kThreads - 1) / kThreads, H);
  sru_rec_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)xhw, (const float*)vb,
      (const float*)c, (const float*)dh, (float*)du, (float*)dxhw,
      (float*)dvb_part, T, H, B, reverse);
  return (int)cudaGetLastError();
}
