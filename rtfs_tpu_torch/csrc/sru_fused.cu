// Fused bidirectional SRU stack kernels for Hopper (sm_90a), float32.
//
// K1  sru_dual_recurrence_fwd  replaces the Pallas kernel _lay0_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_dual_recurrence).
// K1  sru_dual_recurrence_bwd  replaces the Pallas kernel _lay0_bwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from _lay0_vjp_bwd).
// K2  sru_hidden_layer_fwd     replaces the Pallas kernel _hid_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_hidden_layer).
// K2  sru_hidden_layer_bwd     replaces the Pallas kernel _hid_bwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from _hid_vjp_bwd).
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
// x, h, c (T, H, B); vb (8, H) = per direction [v_f, v_r, b_f, b_r];
// wt (6H, 2H) = per direction the rows [x~, f, r] x H of W^T.
//
// Forward: the cell states c are written only when the caller passes c
// pointers (training); serving passes null. The Pallas forward also writes
// per-chunk entry carries because its grid walks time in chunks; a thread
// here walks all of T with c in a register, so the only boundary value is
// the zero state and no carry is stored.
//
// Backward (BPTT), the adjoints of the Pallas kernels, per step in reverse
// scan order (forward direction t = T-1 .. 0 with c_prev = c[t-1]; reverse
// direction t = 0 .. T-1 with c_prev = c[t+1]; c_prev = 0 at the scan's
// start):
//   dr = dh (c_t - hw); dm = dr r (1 - r); dc = dh r + dm v_r + dc_next
//   df = dc (c_prev - u0); da = df f (1 - f)
//   du = [dc (1 - f), da, dm, dh (1 - r)]; dc_prev = dc f + da v_f
//   d(v_f, v_r, b_f, b_r) += (da c_prev, dm c_t, da, dm)
// Reductions over the batch (dv, db, dW) are written as one partial per
// block and summed by the wrapper in a fixed order: no float atomics, so
// gradients are the same from run to run.
//
// What bounds them on the H100. K1 moves 20 bytes per (step, unit, column)
// for ~15 flops (its backward 44 bytes for ~30), so by the roofline it is
// bound by memory bytes; in practice it is bound by latency, because each
// thread walks T dependent steps and the launch has only 2*H*B threads.
// The design keeps c (dc) in a register, makes neighbouring threads read
// neighbouring batch columns (coalesced), and unrolls the time loop so the
// loads of later steps issue before the dependent gate chain. K2 does
// 2*3H*2H flops per column, step and direction for ~16H bytes (its backward
// three such products: U, dx = W du and dW += x du^T), so by the roofline
// it is bound by float32 operations; in practice it is bound by the
// latency of its per-step chain (load x_t, barrier, 2H-long dot products,
// gates), T times over. A block owns one direction and a tile of batch
// columns (8 at H = 32, so the grid has many blocks even at batch 1); it
// keeps that direction's (3H x 2H) weight slice in shared memory (rows
// padded to 2H+1 floats against bank conflicts), stages x_t = [h_f; h_r]_t
// (2H x tile) per step into one of two buffers while the next step's x is
// already loading, and each thread forms the three dot products of its
// hidden unit and column (two accumulator chains each), then the gate
// update. The projection never leaves the kernel, as in the Pallas kernel;
// the backward recomputes it the same way and keeps its dW partial in
// registers. (A register-tiled forward variant, 32 columns a block, 4 a
// thread, measured 7-50% slower at the serving shapes: it has 4x fewer
// blocks; see PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDwPerThread = 32;  // K2 backward dW registers per thread
// K1 block size, forward and backward (the backward writes one dvb partial
// a block; ops/sru_fused.py sizes that buffer with the same constant)
constexpr int kLay0Threads = 128;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// grid (ceil(B / blockDim.x), H, 2), one thread per (column, unit, dir).
__global__ void sru_lay0_fwd_kernel(const float* __restrict__ u_f,
                                    const float* __restrict__ u_r,
                                    const float* __restrict__ vb,
                                    float* __restrict__ h_f,
                                    float* __restrict__ h_r,
                                    float* __restrict__ c_f,
                                    float* __restrict__ c_r,
                                    int T, int H, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int dir = blockIdx.z;
  if (b >= B) return;
  const float* u = dir == 0 ? u_f : u_r;
  float* h = dir == 0 ? h_f : h_r;
  float* cs = dir == 0 ? c_f : c_r;  // null when serving
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
    if (cs) cs[(long long)t * row + col] = c;
  }
}

// Sums v over the block's threads into out (one float) with warp shuffles
// and a shared-memory pass over the warps; every thread must call it.
// red must hold blockDim / 32 floats.
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

// grid (ceil(B / blockDim.x), H, 2), one thread per (column, unit, dir);
// blockDim.x a multiple of 32. Writes du and, per block, the partial sums
// dvb_part[blockIdx.x][dir*4 + k][j] over the block's columns.
__global__ void sru_lay0_bwd_kernel(const float* __restrict__ u_f,
                                    const float* __restrict__ u_r,
                                    const float* __restrict__ vb,
                                    const float* __restrict__ c_f,
                                    const float* __restrict__ c_r,
                                    const float* __restrict__ dh_f,
                                    const float* __restrict__ dh_r,
                                    float* __restrict__ du_f,
                                    float* __restrict__ du_r,
                                    float* __restrict__ dvb_part,
                                    int T, int H, int B) {
  __shared__ float red[32];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int dir = blockIdx.z;
  const bool live = b < B;
  const float* u = dir == 0 ? u_f : u_r;
  const float* cs = dir == 0 ? c_f : c_r;
  const float* dh = dir == 0 ? dh_f : dh_r;
  float* du = dir == 0 ? du_f : du_r;
  const float v_f = vb[(dir * 4 + 0) * H + j];
  const float v_r = vb[(dir * 4 + 1) * H + j];
  const float b_f = vb[(dir * 4 + 2) * H + j];
  const float b_r = vb[(dir * 4 + 3) * H + j];
  const long long row = (long long)H * B;
  const long long col = (long long)j * B + (live ? b : 0);
  float dc = 0.f, a_vf = 0.f, a_vr = 0.f, a_bf = 0.f, a_br = 0.f;
  if (live) {
    // reverse scan order: the forward direction from t = T-1 down, the
    // reverse direction from t = 0 up; c_t of a step is c_prev of the last
    float c_t = cs[(long long)(dir == 0 ? T - 1 : 0) * row + col];
#pragma unroll 2
    for (int i = 0; i < T; ++i) {
      const int t = dir == 0 ? T - 1 - i : i;
      const int tp = dir == 0 ? t - 1 : t + 1;
      const float c_prev = i + 1 < T ? cs[(long long)tp * row + col] : 0.f;
      const float* ut = u + (long long)t * 4 * row + col;
      const float u0 = ut[0], u1 = ut[row], u2 = ut[2 * row];
      const float xhw = ut[3 * row];
      const float g = dh[(long long)t * row + col];
      const float f = sigmoid_f(u1 + v_f * c_prev + b_f);
      const float r = sigmoid_f(u2 + v_r * c_t + b_r);
      const float dm = g * (c_t - xhw) * r * (1.f - r);
      dc = g * r + dm * v_r + dc;
      const float da = dc * (c_prev - u0) * f * (1.f - f);
      float* dut = du + (long long)t * 4 * row + col;
      dut[0] = dc * (1.f - f);
      dut[row] = da;
      dut[2 * row] = dm;
      dut[3 * row] = g * (1.f - r);
      a_vf += da * c_prev;
      a_vr += dm * c_t;
      a_bf += da;
      a_br += dm;
      dc = dc * f + da * v_f;
      c_t = c_prev;
    }
  }
  float* part = dvb_part + (long long)blockIdx.x * 8 * H + dir * 4 * H + j;
  const float s0 = block_sum(a_vf, red);
  if (threadIdx.x == 0) part[0] = s0;
  const float s1 = block_sum(a_vr, red);
  if (threadIdx.x == 0) part[H] = s1;
  const float s2 = block_sum(a_bf, red);
  if (threadIdx.x == 0) part[2 * H] = s2;
  const float s3 = block_sum(a_br, red);
  if (threadIdx.x == 0) part[3 * H] = s3;
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
                                      float* __restrict__ c_f,
                                      float* __restrict__ c_r,
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
  float* cs = dir == 0 ? c_f : c_r;  // null when serving
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
    if (live) {
      h[t * row + col] = r * c + (1.f - r) * xhw;
      if (cs) cs[t * row + col] = c;
    }
    t = dir == 0 ? i + 1 : T - 2 - i;
  }
}

// grid (ceil(B / bt), 2), block (bt, H): thread (column tx, unit j), one
// direction per block, walking its time in reverse scan order. Per step:
//   1. stage x_t = [x_f; x_r]_t (2H x bt) (prefetched a step ahead), sync;
//   2. recompute u = W_d^T x_t for unit j, the gate adjoints, stage du
//      (3H x bt) in shared memory, sync;
//   3. dx_t = W_d du for rows j and H+j (+ the highway term on the
//      direction's own half), written to this direction's dx buffer
//      (T, 2H, B); the wrapper adds the two directions' buffers;
//   4. dW_d += x_t du^T over the block's columns: thread tid owns the
//      entries e = tid + k*nthreads of the (3H, 2H) block of dwt, in
//      registers.
// Shared rows are padded (weights 2H+1, x and du bt+1 floats) against bank
// conflicts. Outputs per block: dwt_part[blockIdx.x][dir*3H + o][i] and
// dvb_part[blockIdx.x][dir*4 + k][j].
__global__ void sru_hidden_bwd_kernel(const float* __restrict__ x_f,
                                      const float* __restrict__ x_r,
                                      const float* __restrict__ wt,
                                      const float* __restrict__ vb,
                                      const float* __restrict__ c_f,
                                      const float* __restrict__ c_r,
                                      const float* __restrict__ dh_f,
                                      const float* __restrict__ dh_r,
                                      float* __restrict__ dx_a,
                                      float* __restrict__ dx_b,
                                      float* __restrict__ dwt_part,
                                      float* __restrict__ dvb_part,
                                      int T, int H, int B) {
  extern __shared__ float smem[];
  const int dir = blockIdx.y;
  const int tx = threadIdx.x, j = threadIdx.y;
  const int bt = blockDim.x, bs = bt + 1;
  const int tid = j * bt + tx, nthreads = bt * H;
  const int b = blockIdx.x * bt + tx;
  const int h2 = 2 * H, h3 = 3 * H, ws = h2 + 1;
  float* w_s = smem;                 // (3H, 2H+1)
  float* x_s = w_s + h3 * ws;        // 2 x (2H, bt+1)
  float* du_s = x_s + 2 * h2 * bs;   // (3H, bt+1)
  float* red = du_s + h3 * bs;       // (H, bt+1)

  const float* wd = wt + (long long)dir * h3 * h2;
  for (int e = tid; e < h3 * h2; e += nthreads)
    w_s[(e / h2) * ws + e % h2] = wd[e];

  const float v_f = vb[(dir * 4 + 0) * H + j];
  const float v_r = vb[(dir * 4 + 1) * H + j];
  const float b_f = vb[(dir * 4 + 2) * H + j];
  const float b_r = vb[(dir * 4 + 3) * H + j];
  const float* cs = dir == 0 ? c_f : c_r;
  const float* dh = dir == 0 ? dh_f : dh_r;
  float* dx = dir == 0 ? dx_a : dx_b;
  const long long row = (long long)H * B;
  const bool live = b < B;
  const long long col = (long long)j * B + (live ? b : 0);
  const float* w0 = w_s + j * ws;
  const float* w1 = w_s + (H + j) * ws;
  const float* w2 = w_s + (2 * H + j) * ws;

  float acc[kMaxDwPerThread];
#pragma unroll
  for (int k = 0; k < kMaxDwPerThread; ++k) acc[k] = 0.f;
  float a_vf = 0.f, a_vr = 0.f, a_bf = 0.f, a_br = 0.f;

  int t = dir == 0 ? T - 1 : 0;
  float next_f = live ? x_f[t * row + col] : 0.f;
  float next_r = live ? x_r[t * row + col] : 0.f;
  float c_t = live ? cs[t * row + col] : 0.f;
  float dc = 0.f;
  for (int i = 0; i < T; ++i) {
    const float cur_f = next_f, cur_r = next_r;
    float* xb = x_s + (i & 1) * h2 * bs;
    xb[j * bs + tx] = cur_f;
    xb[(H + j) * bs + tx] = cur_r;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the previous step in scan order
    if (i + 1 < T && live) {
      next_f = x_f[tp * row + col];
      next_r = x_r[tp * row + col];
    }
    const float c_prev = (i + 1 < T && live) ? cs[tp * row + col] : 0.f;
    const float g = live ? dh[t * row + col] : 0.f;
    __syncthreads();  // x_t is in (and, at i = 0, the weights)
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
    for (int k = 0; k < h2; k += 2) {
      const float xv = xb[k * bs + tx], xw = xb[(k + 1) * bs + tx];
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
    const float xhw = dir == 0 ? cur_f : cur_r;
    const float f = sigmoid_f(a1 + v_f * c_prev + b_f);
    const float r = sigmoid_f(a2 + v_r * c_t + b_r);
    const float dm = g * (c_t - xhw) * r * (1.f - r);
    dc = g * r + dm * v_r + dc;
    const float da = dc * (c_prev - a0) * f * (1.f - f);
    const float du0 = dc * (1.f - f);
    du_s[j * bs + tx] = du0;
    du_s[(H + j) * bs + tx] = da;
    du_s[(2 * H + j) * bs + tx] = dm;
    const float dxhw = g * (1.f - r);
    a_vf += da * c_prev;
    a_vr += dm * c_t;
    a_bf += da;
    a_br += dm;
    dc = dc * f + da * v_f;
    c_t = c_prev;
    __syncthreads();  // du is in
    // dx rows j (x_f half) and H + j (x_r half)
    float d0 = 0.f, d1 = 0.f;
    for (int o = 0; o < h3; ++o) {
      const float duo = du_s[o * bs + tx];
      d0 += w_s[o * ws + j] * duo;
      d1 += w_s[o * ws + H + j] * duo;
    }
    if (dir == 0) d0 += dxhw; else d1 += dxhw;
    if (live) {
      float* dxt = dx + (long long)t * 2 * row + col;
      dxt[0] = d0;
      dxt[row] = d1;
    }
    // dW: entry e -> (o, i) of this direction's (3H, 2H) block of dwt
#pragma unroll
    for (int k = 0; k < kMaxDwPerThread; ++k) {
      const int e = tid + k * nthreads;
      if (e < h3 * h2) {
        const float* xi = xb + (e % h2) * bs;
        const float* duo = du_s + (e / h2) * bs;
        float s = 0.f;
        for (int q = 0; q < bt; ++q) s += xi[q] * duo[q];
        acc[k] += s;
      }
    }
    t = tp;
  }
  float* dw = dwt_part + ((long long)blockIdx.x * 2 + dir) * h3 * h2;
#pragma unroll
  for (int k = 0; k < kMaxDwPerThread; ++k) {
    const int e = tid + k * nthreads;
    if (e < h3 * h2) dw[e] = acc[k];
  }
  // dvb: sum the bt columns of each unit through shared memory
  float* part = dvb_part + (long long)blockIdx.x * 8 * H + dir * 4 * H + j;
  const float vals[4] = {a_vf, a_vr, a_bf, a_br};
  for (int k = 0; k < 4; ++k) {
    __syncthreads();
    red[j * bs + tx] = vals[k];
    __syncthreads();
    if (tx == 0) {
      float s = 0.f;
      for (int q = 0; q < bt; ++q) s += red[j * bs + q];
      part[k * H] = s;
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int sru_dual_recurrence_fwd(const void* u_f, const void* u_r,
                                       const void* vb, void* h_f, void* h_r,
                                       void* c_f, void* c_r, int T, int H,
                                       int B, void* stream) {
  dim3 grid((B + kLay0Threads - 1) / kLay0Threads, H, 2);
  sru_lay0_fwd_kernel<<<grid, kLay0Threads, 0, (cudaStream_t)stream>>>(
      (const float*)u_f, (const float*)u_r, (const float*)vb, (float*)h_f,
      (float*)h_r, (float*)c_f, (float*)c_r, T, H, B);
  return (int)cudaGetLastError();
}

// dvb_part: (ceil(B / kLay0Threads), 8, H).
extern "C" int sru_dual_recurrence_bwd(const void* u_f, const void* u_r,
                                       const void* vb, const void* c_f,
                                       const void* c_r, const void* dh_f,
                                       const void* dh_r, void* du_f,
                                       void* du_r, void* dvb_part, int T,
                                       int H, int B, void* stream) {
  dim3 grid((B + kLay0Threads - 1) / kLay0Threads, H, 2);
  sru_lay0_bwd_kernel<<<grid, kLay0Threads, 0, (cudaStream_t)stream>>>(
      (const float*)u_f, (const float*)u_r, (const float*)vb,
      (const float*)c_f, (const float*)c_r, (const float*)dh_f,
      (const float*)dh_r, (float*)du_f, (float*)du_r, (float*)dvb_part, T, H,
      B);
  return (int)cudaGetLastError();
}

extern "C" int sru_hidden_layer_fwd(const void* x_f, const void* x_r,
                                    const void* wt, const void* vb, void* h_f,
                                    void* h_r, void* c_f, void* c_r, int T,
                                    int H, int B, int bt, void* stream) {
  const size_t smem = (size_t)(3 * H * (2 * H + 1) + 4 * H * bt) * sizeof(float);
  cudaError_t e = set_smem((const void*)sru_hidden_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + bt - 1) / bt, 2);
  dim3 block(bt, H);
  sru_hidden_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x_f, (const float*)x_r, (const float*)wt,
      (const float*)vb, (float*)h_f, (float*)h_r, (float*)c_f, (float*)c_r,
      T, H, B);
  return (int)cudaGetLastError();
}

// dx_a, dx_b: (T, 2H, B) per direction; dwt_part: (ceil(B / bt), 6H, 2H);
// dvb_part: (ceil(B / bt), 8, H).
extern "C" int sru_hidden_layer_bwd(const void* x_f, const void* x_r,
                                    const void* wt, const void* vb,
                                    const void* c_f, const void* c_r,
                                    const void* dh_f, const void* dh_r,
                                    void* dx_a, void* dx_b, void* dwt_part,
                                    void* dvb_part, int T, int H, int B,
                                    int bt, void* stream) {
  if ((6 * H * H + bt * H - 1) / (bt * H) > kMaxDwPerThread)
    return (int)cudaErrorInvalidValue;
  const int bs = bt + 1;
  const size_t smem = (size_t)(3 * H * (2 * H + 1) + 4 * H * bs + 3 * H * bs
                               + H * bs) * sizeof(float);
  cudaError_t e = set_smem((const void*)sru_hidden_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + bt - 1) / bt, 2);
  dim3 block(bt, H);
  sru_hidden_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x_f, (const float*)x_r, (const float*)wt,
      (const float*)vb, (const float*)c_f, (const float*)c_r,
      (const float*)dh_f, (const float*)dh_r, (float*)dx_a, (float*)dx_b,
      (float*)dwt_part, (float*)dvb_part, T, H, B);
  return (int)cudaGetLastError();
}
