// Time-major ConvTranspose1d (stride 1, padding 0) for Hopper (sm_90a),
// float32.
//
// K3  convt1d_ola_tm_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/convt_tm.py, called from convt1d_ola_tm): the
//     back-projection at the tail of every DualPathRNN.
// K3  convt1d_ola_tm_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/convt_tm.py, called from _vjp_bwd): its VJP.
//
//   out[t, o, b] = sum_{j < k, 0 <= t-j < L} sum_i x[t-j, i, b] * W[j, o, i]
//   dx[l, i, b]  = sum_{j < k} sum_o W[j, o, i] * g[l+j, o, b]
//   dW[j, o, i]  = sum_{l < L, b} g[l+j, o, b] * x[l, i, b]
//
// x (L, C_in, B), W (k, C_out, C_in) (not flipped), out and g
// (L+k-1, C_out, B), the folded batch fastest. The bias is added outside,
// as in JAX.
//
// What bounds it on the H100: 2*k*C_in*C_out flops per output column
// against (C_in + C_out)*4 bytes, ~128 flops a byte at the DualPathRNN
// geometry (k 8, C 64), far above the card's float32 ratio, so all three
// products are bound by float32 operations; the design's job is to keep
// the FMA units fed from shared memory and registers.
//
// Forward: one block per (output step t, tile of 64 batch columns),
// 16 x 8 threads, each a register tile of 8 output channels x 4 columns;
// per tap j the block stages W[j] (rows padded to 68 floats) and the input
// tile x[t-j] in shared memory (taps off the sequence skipped).
//
// Backward. g is time-major, so g[l : l+k] is one contiguous (k*C_out, B)
// slab, and dx[l] = W_cat^T slab_l, a product of depth k*C_out = 512 with
// W_cat = W as (k*C_out, C_in); dW = sum_l slab_l x[l]^T, one product
// reduced over L*B columns.
//   dx (convt1d_tm_dx_kernel): W stays put. Each block keeps all of W
//     (k*C_out rows of 64 floats, 128 KB at the preset) in shared memory,
//     brought in by cp.async with the first k rows of g (with one block an
//     SM, nothing else hides that load's latency), and walks a run of
//     consecutive steps l for one tile of 32 batch
//     columns, keeping a ring of k+1 rows of g (C_out x 32 each): step l
//     reads rows l .. l+k-1 while cp.async brings row l+k into the free
//     slot, so each g row is read from memory once per block, not k times.
//     Its 256 threads are four groups that split the taps (j mod 4); a
//     thread holds an 8 (C_in) x 4 (column) register tile, and the groups'
//     tiles are added in shared memory in a fixed order. One block an SM
//     (224 KB of shared memory at the preset); the blocks are as many as
//     the column tiles times runs of steps that fill the 132 SMs once.
//   dW (convt1d_tm_wgrad_kernel): split-K over the L*B columns; a block
//     owns a 128 x 64 tile of dW_cat (k*C_out x C_in) and one chunk of
//     columns, stages 32 columns of the slab rows and of x transposed in
//     shared memory, the next stage's loads in flight in registers, each
//     thread an 8 x 4 register tile; one partial a chunk, summed in a
//     fixed order (convt1d_tm_sum_kernel): no float atomics, so two calls
//     give the same bits.
// All products run in full float32 on the SIMT units.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;    // forward: batch columns per block
constexpr int kMaxOut = 64;  // forward: output-channel limit (8 x 8)
constexpr int kWs = kMaxOut + 4;
// backward (ops/convt_tm.py mirrors these): dx columns per block, the
// dx block's tap groups, the C_in limit and W's row stride in shared
// memory (8 thread rows x 8), threads a block, dW tile rows (16 thread
// rows x 8) and columns per dW stage
constexpr int kDxCols = 32;
constexpr int kDxGroups = 4;
constexpr int kMaxIn = 64;
constexpr int kThreads = 256;
constexpr int kWgRows = 128;
constexpr int kWgCols = 32;

// grid (ceil(B / 64), L + K - 1), block (16, 8). x (L, Ci, B), out
// (L + K - 1, Co, B), w W (K, Co, Ci).
__global__ void convt1d_tm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int L, int Ci,
                                  int Co, int K, int B) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  const int b0 = blockIdx.x * kCols;
  float* w_s = smem;              // (Ci, kWs): w_s[q][p] = W[j][p][q]
  float* x_s = smem + Ci * kWs;   // (Ci, kCols)
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;

  for (int j = 0; j < K; ++j) {
    const int l = t - j;
    if (l < 0 || l >= L) continue;  // uniform over the block
    __syncthreads();
    const float* wj = w + (long long)j * Co * Ci;
    for (int e = tid; e < kMaxOut * Ci; e += nthreads) {
      const int p = e / Ci, q = e % Ci;
      w_s[q * kWs + p] = p < Co ? wj[p * Ci + q] : 0.f;
    }
    for (int e = tid; e < Ci * kCols; e += nthreads) {
      const int i = e / kCols, b = b0 + e % kCols;
      x_s[e] = b < B ? x[((long long)l * Ci + i) * B + b] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < Ci; ++i) {
      const float4 xv4 = *reinterpret_cast<const float4*>(x_s + i * kCols + 4 * tx);
      const float4 wa = *reinterpret_cast<const float4*>(w_s + i * kWs + 8 * ty);
      const float4 wb = *reinterpret_cast<const float4*>(w_s + i * kWs + 8 * ty + 4);
      const float xv[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] += wv[q] * xv[c];
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = 8 * ty + q;
    if (o >= Co) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = b0 + 4 * tx + c;
      if (b < B) out[((long long)t * Co + o) * B + b] = acc[q][c];
    }
  }
}

// 4-byte asynchronous copy global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Shared memory of the dx kernel in floats: W (K*Co rows of kMaxIn), the
// ring of K+1 g rows (Co x kDxCols each), the tap groups' exchange tiles.
__host__ __device__ __forceinline__ int dx_smem_floats(int K, int Co) {
  return K * Co * kMaxIn + (K + 1) * Co * kDxCols
         + (kDxGroups - 1) * kMaxIn * kDxCols;
}

// grid (ceil(B / kDxCols), ceil(L / steps)), kThreads threads. Block
// (tile, run) writes dx[l][:][b0 .. b0+31] for l in [run * steps,
// min(L, (run + 1) * steps)). Thread tid: group q = tid / 64 takes the
// taps j = q, q + 4, ...; within a group, (tx, ty) = (tid % 8, tid % 64 /
// 8) owns C_in rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3. Group 0
// adds the others' tiles in order and writes dx.
__global__ void __launch_bounds__(kThreads)
convt1d_tm_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                     float* __restrict__ dx, int L, int Ci, int Co, int K,
                     int B, int steps) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // w_s[j*Co + o][i]
  float* ring = w_s + K * Co * kMaxIn;           // (K+1, Co, kDxCols)
  float* red = ring + (K + 1) * Co * kDxCols;    // (groups-1, kMaxIn, kDxCols)
  const int tid = threadIdx.x, grp = tid >> 6;
  const int tx = tid & 7, ty = (tid & 63) >> 3;
  const int b0 = blockIdx.x * kDxCols;
  const int l0 = blockIdx.y * steps, l1 = min(L, l0 + steps);
  const int slot_len = Co * kDxCols;

  // g row r (Co x the tile's columns) into its ring slot r % (K+1)
  auto load_row = [&](int r) {
    float* dst = ring + (r % (K + 1)) * slot_len;
    const float* src = g + (long long)r * Co * B + b0;
    for (int e = tid; e < slot_len; e += kThreads) {
      const int o = e / kDxCols, c = e % kDxCols;
      const bool ok = b0 + c < B;
      cp_async4(dst + e, ok ? src + (long long)o * B + c : g, ok);
    }
  };
  // W, rows padded with zeros to kMaxIn, and the first K rows of g, all
  // in flight at once
  if (Ci % 4 == 0) {
    for (int e = 4 * tid; e < K * Co * kMaxIn; e += 4 * kThreads) {
      const int i = e % kMaxIn;
      const bool ok = i < Ci;
      cp_async16(w_s + e, ok ? w + (long long)(e / kMaxIn) * Ci + i : w, ok);
    }
  } else {
    for (int e = tid; e < K * Co * kMaxIn; e += kThreads) {
      const int i = e % kMaxIn;
      const bool ok = i < Ci;
      cp_async4(w_s + e, ok ? w + (long long)(e / kMaxIn) * Ci + i : w, ok);
    }
  }
  for (int r = l0; r < l0 + K; ++r) load_row(r);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int l = l0; l < l1; ++l) {
    // row l+K, read by the next step, into the slot row l-1 left
    if (l + 1 < l1) load_row(l + K);
    cp_async_commit();
    float acc[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
    for (int j = grp; j < K; j += kDxGroups) {
      const float* gr = ring + ((l + j) % (K + 1)) * slot_len + 4 * tx;
      const float* wr = w_s + j * Co * kMaxIn + 8 * ty;
#pragma unroll 4
      for (int o = 0; o < Co; ++o) {
        const float4 wa = *reinterpret_cast<const float4*>(wr + o * kMaxIn);
        const float4 wb = *reinterpret_cast<const float4*>(wr + o * kMaxIn + 4);
        const float4 gv = *reinterpret_cast<const float4*>(gr + o * kDxCols);
        const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += w8[p] * g4[q];
      }
    }
    if (grp > 0) {
      float* mine = red + (grp - 1) * kMaxIn * kDxCols;
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mine[(8 * ty + p) * kDxCols + 4 * tx + q] = acc[p][q];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int i = 8 * ty + p;
        if (i >= Ci) continue;
        float* out = dx + ((long long)l * Ci + i) * B + b0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * tx + q;
          float v = acc[p][q];
          for (int r = 0; r < kDxGroups - 1; ++r)
            v += red[(r * kMaxIn + i) * kDxCols + c];
          if (b0 + c < B) out[c] = v;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // row l+K is in; row l's slot and red are free
  }
}

// part[chunk][m][i] = sum over the columns col in [chunk * cols,
// min((chunk + 1) * cols, L * B)), (l, b) = divmod(col, B), of g[l*Co +
// m][b] x[l][i][b] for m < K*Co: one chunk of dW_cat. grid (ceil(Ci /
// 64), ceil(K*Co / 128), n_chunks), kThreads threads: (tx, ty) = (tid %
// 16, tid / 16) owns rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3.
// A stage stages kWgCols columns of both operands transposed; a thread
// loads one column (tid % 32) of rows tid / 32 + 8 r.
__global__ void __launch_bounds__(kThreads)
convt1d_tm_wgrad_kernel(const float* __restrict__ g,
                        const float* __restrict__ x, float* __restrict__ part,
                        int L, int Ci, int Co, int K, int B, int cols) {
  __shared__ __align__(16) float a_s[kWgCols][kWgRows + 4];  // a_s[col][m]
  __shared__ __align__(16) float b_s[kWgCols][kMaxIn + 4];   // b_s[col][i]
  constexpr int kRowStep = kThreads / kWgCols;
  constexpr int kPerA = kWgRows / kRowStep, kPerB = kMaxIn / kRowStep;
  const int M = K * Co;
  const int m0 = blockIdx.y * kWgRows, n0 = blockIdx.x * kMaxIn;
  const long long c0 = (long long)blockIdx.z * cols;
  const long long c1 = min(c0 + cols, (long long)L * B);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q = tid % kWgCols, r0 = tid / kWgCols;
  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[p][s] = 0.f;
  float ra[kPerA], rb[kPerB];
  auto load = [&](long long s0) {
    const long long col = s0 + q;
    const bool ok = col < c1;
    const int l = ok ? (int)(col / B) : 0;
    const int b = ok ? (int)(col - (long long)l * B) : 0;
    const float* gl = g + (long long)l * Co * B + b;  // slab row m at m * B
    const float* xl = x + (long long)l * Ci * B + b;
#pragma unroll
    for (int r = 0; r < kPerA; ++r) {
      const int m = m0 + r0 + kRowStep * r;
      ra[r] = ok && m < M ? gl[(long long)m * B] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kPerB; ++r) {
      const int i = n0 + r0 + kRowStep * r;
      rb[r] = ok && i < Ci ? xl[(long long)i * B] : 0.f;
    }
  };
  load(c0);
  for (long long s0 = c0; s0 < c1; s0 += kWgCols) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPerA; ++r) a_s[q][r0 + kRowStep * r] = ra[r];
#pragma unroll
    for (int r = 0; r < kPerB; ++r) b_s[q][r0 + kRowStep * r] = rb[r];
    __syncthreads();
    if (s0 + kWgCols < c1) load(s0 + kWgCols);
#pragma unroll 4
    for (int k = 0; k < kWgCols; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[k][8 * ty + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][4 * tx]);
      const float a8[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[p][s] += a8[p] * b4[s];
    }
  }
  float* out = part + (long long)blockIdx.z * M * Ci;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int m = m0 + 8 * ty + p;
    if (m >= M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = n0 + 4 * tx + s;
      if (i < Ci) out[(long long)m * Ci + i] = acc[p][s];
    }
  }
}

// out[e] = sum_{p < n_parts} part[p][e], p in order.
__global__ void convt1d_tm_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_parts,
                                     int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(long long)p * n + e];
  out[e] = s;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" int convt1d_ola_tm_fwd(const void* x, const void* w, void* out,
                                  int L, int Ci, int Co, int K, int B,
                                  void* stream) {
  if (Co > kMaxOut) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(Ci * (kWs + kCols)) * sizeof(float);
  cudaError_t e = set_smem((const void*)convt1d_tm_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kCols - 1) / kCols, L + K - 1);
  dim3 block(kCols / 4, 8);
  convt1d_tm_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, L, Ci, Co, K, B);
  return (int)cudaGetLastError();
}

// dx (L, C_in, B) and dw (K, C_out, C_in); dw_part (ceil(L * B / cols),
// K, C_out, C_in) is scratch: one partial per chunk of cols (l, b) columns.
// steps: consecutive steps l per dx block.
extern "C" int convt1d_ola_tm_bwd(const void* g, const void* w, const void* x,
                                  void* dx, void* dw, void* dw_part, int L,
                                  int Ci, int Co, int K, int B, int steps,
                                  int cols, void* stream) {
  if (Ci > kMaxIn || steps < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)dx_smem_floats(K, Co) * sizeof(float);
  cudaError_t e = set_smem((const void*)convt1d_tm_dx_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  convt1d_tm_dx_kernel<<<dim3(ceil_div(B, kDxCols), ceil_div(L, steps)),
                         kThreads, smem, st>>>(
      (const float*)g, (const float*)w, (float*)dx, L, Ci, Co, K, B, steps);
  const int n_chunks = ceil_div((long long)L * B, cols);
  convt1d_tm_wgrad_kernel<<<dim3(ceil_div(Ci, kMaxIn),
                                 ceil_div(K * Co, kWgRows), n_chunks),
                            kThreads, 0, st>>>(
      (const float*)g, (const float*)x, (float*)dw_part, L, Ci, Co, K, B,
      cols);
  const int n = K * Co * Ci;
  convt1d_tm_sum_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
      (const float*)dw_part, (float*)dw, n_chunks, n);
  return (int)cudaGetLastError();
}
