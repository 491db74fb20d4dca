// Fused bidirectional SRU stack kernels for Hopper (sm_90a), float32.
//
// K1  sru_dual_recurrence_fwd  replaces the Pallas kernel _lay0_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_dual_recurrence).
// K2  sru_hidden_layer_fwd     replaces the Pallas kernel _hid_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_hidden_layer).
//
// Recurrence (sru package v2.6 semantics; the reset gate reads the UPDATED
// cell, see rtfs_tpu/ops/sru.py):
//   f_t = sigmoid(u1_t + v_f * c_{t-1} + b_f)
//   c_t = f_t * c_{t-1} + (1 - f_t) * u0_t
//   r_t = sigmoid(u2_t + v_r * c_t + b_r)
//   h_t = r_t * c_t + (1 - r_t) * highway_t
// The reverse direction walks t = T-1 .. 0 in the same launch; nothing is
// flipped in memory.
//
// Layouts are the Pallas kernels' boundary layouts, time-major with the
// folded batch fastest: u (T, 4H, B) with row blocks [x~, f, r, highway];
// x, h (T, H, B); vb (8, H) = per direction [v_f, v_r, b_f, b_r];
// wt (6H, 2H) = per direction the rows [x~, f, r] x H of W^T.
//
// Serving only: the Pallas forward also writes the cell states c and the
// per-chunk entry carries, which only its backward reads. These kernels
// skip them; the training slice's backward kernels will need c.
//
// What bounds them on the H100. K1 moves 20 bytes per (step, unit, column)
// for ~15 flops, so by the roofline it is bound by memory bytes; in
// practice it is bound by latency, because each thread walks T dependent
// steps and the launch has only 2*H*B threads. The design keeps c in a
// register, makes neighbouring threads read neighbouring batch columns
// (coalesced), and unrolls the time loop so the loads of later steps issue
// before the dependent gate chain. K2 does 2*3H*2H flops per column, step
// and direction for ~16H bytes, so by the roofline it is bound by float32
// operations; in practice it is bound by the latency of its per-step
// chain (load x_t, barrier, 2H-long dot products, gate), T times over. A
// block owns one direction and a tile of batch columns (8 at H = 32, so
// the grid has many blocks even at batch 1); it keeps that direction's
// (3H x 2H) weight slice in shared memory (rows padded to 2H+1 floats
// against bank conflicts), stages x_t = [h_f; h_r]_t (2H x tile) per step
// into one of two buffers while the next step's x is already loading, and
// each thread forms the three dot products of its hidden unit and column
// (two accumulator chains each), then the gate update. The projection
// never leaves the kernel, as in the Pallas kernel. (A register-tiled
// variant, 32 columns a block, 4 a thread, measured 7-50% slower at the
// serving shapes: it has 4x fewer blocks; see PERF.md.)

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// grid (ceil(B / blockDim.x), H, 2), one thread per (column, unit, dir).
__global__ void sru_lay0_fwd_kernel(const float* __restrict__ u_f,
                                    const float* __restrict__ u_r,
                                    const float* __restrict__ vb,
                                    float* __restrict__ h_f,
                                    float* __restrict__ h_r,
                                    int T, int H, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int dir = blockIdx.z;
  if (b >= B) return;
  const float* u = dir == 0 ? u_f : u_r;
  float* h = dir == 0 ? h_f : h_r;
  const float v_f = vb[(dir * 4 + 0) * H + j];
  const float v_r = vb[(dir * 4 + 1) * H + j];
  const float b_f = vb[(dir * 4 + 2) * H + j];
  const float b_r = vb[(dir * 4 + 3) * H + j];
  const long long row = (long long)H * B;  // one gate block per step
  const long long col = (long long)j * B + b;
  float c = 0.f;
#pragma unroll 4
  for (int i = 0; i < T; ++i) {
    const int t = dir == 0 ? i : T - 1 - i;
    const float* ut = u + (long long)t * 4 * row + col;
    const float u0 = ut[0], u1 = ut[row], u2 = ut[2 * row];
    const float xhw = ut[3 * row];
    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
    h[(long long)t * row + col] = r * c + (1.f - r) * xhw;
  }
}

// grid (ceil(B / bt), 2), block (bt, H): thread (column tx, unit j).
// Thread (tx, j) loads rows j of x_f and x_r for its column, so the block
// stages all 2H rows of x_t. The loads of step i+1 are issued before step
// i's dot products (they do not depend on the recurrence), into a second
// x_s buffer, so one barrier per step suffices.
__global__ void sru_hidden_fwd_kernel(const float* __restrict__ x_f,
                                      const float* __restrict__ x_r,
                                      const float* __restrict__ wt,
                                      const float* __restrict__ vb,
                                      float* __restrict__ h_f,
                                      float* __restrict__ h_r,
                                      int T, int H, int B) {
  extern __shared__ float smem[];
  const int dir = blockIdx.y;
  const int tx = threadIdx.x, j = threadIdx.y;
  const int bt = blockDim.x;
  const int b = blockIdx.x * bt + tx;
  const int h2 = 2 * H, ws = h2 + 1;
  float* w_s = smem;               // (3H, 2H+1)
  float* x_s = smem + 3 * H * ws;  // 2 x (2H, bt)

  const float* wd = wt + (long long)dir * 3 * H * h2;
  for (int e = j * bt + tx; e < 3 * H * h2; e += bt * H)
    w_s[(e / h2) * ws + e % h2] = wd[e];

  const float v_f = vb[(dir * 4 + 0) * H + j];
  const float v_r = vb[(dir * 4 + 1) * H + j];
  const float b_f = vb[(dir * 4 + 2) * H + j];
  const float b_r = vb[(dir * 4 + 3) * H + j];
  float* h = dir == 0 ? h_f : h_r;
  const long long row = (long long)H * B;
  const long long col = (long long)j * B + b;
  const float* w0 = w_s + j * ws;
  const float* w1 = w_s + (H + j) * ws;
  const float* w2 = w_s + (2 * H + j) * ws;
  const bool live = b < B;
  int t = dir == 0 ? 0 : T - 1;
  float next_f = live ? x_f[t * row + col] : 0.f;
  float next_r = live ? x_r[t * row + col] : 0.f;
  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    const float cur_f = next_f, cur_r = next_r;
    float* xb = x_s + (i & 1) * h2 * bt;
    xb[j * bt + tx] = cur_f;
    xb[(H + j) * bt + tx] = cur_r;
    if (i + 1 < T && live) {
      const int tn = dir == 0 ? i + 1 : T - 2 - i;
      next_f = x_f[tn * row + col];
      next_r = x_r[tn * row + col];
    }
    __syncthreads();  // x_t is in (and, at i = 0, the weights)
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
    for (int k = 0; k < h2; k += 2) {
      const float xv = xb[k * bt + tx], xw = xb[(k + 1) * bt + tx];
      a0 += w0[k] * xv;
      a1 += w1[k] * xv;
      a2 += w2[k] * xv;
      e0 += w0[k + 1] * xw;
      e1 += w1[k + 1] * xw;
      e2 += w2[k + 1] * xw;
    }
    a0 += e0;
    a1 += e1;
    a2 += e2;
    // highway: this direction's own input h
    const float xhw = dir == 0 ? cur_f : cur_r;
    const float f = sigmoid_f(a1 + v_f * c + b_f);
    c = f * c + (1.f - f) * a0;
    const float r = sigmoid_f(a2 + v_r * c + b_r);
    if (live) h[t * row + col] = r * c + (1.f - r) * xhw;
    t = dir == 0 ? i + 1 : T - 2 - i;
  }
}

}  // namespace

extern "C" int sru_dual_recurrence_fwd(const void* u_f, const void* u_r,
                                       const void* vb, void* h_f, void* h_r,
                                       int T, int H, int B, void* stream) {
  const int threads = 128;
  dim3 grid((B + threads - 1) / threads, H, 2);
  sru_lay0_fwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)u_f, (const float*)u_r, (const float*)vb, (float*)h_f,
      (float*)h_r, T, H, B);
  return (int)cudaGetLastError();
}

extern "C" int sru_hidden_layer_fwd(const void* x_f, const void* x_r,
                                    const void* wt, const void* vb, void* h_f,
                                    void* h_r, int T, int H, int B, int bt,
                                    void* stream) {
  const size_t smem = (size_t)(3 * H * (2 * H + 1) + 4 * H * bt) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sru_hidden_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + bt - 1) / bt, 2);
  dim3 block(bt, H);
  sru_hidden_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x_f, (const float*)x_r, (const float*)wt,
      (const float*)vb, (float*)h_f, (float*)h_r, T, H, B);
  return (int)cudaGetLastError();
}
