// Packed time-frequency kernels for Hopper (sm_90a), float32, forward and
// weight gradients. The backward's dx passes are the forward kernels
// themselves (K5 with flipped taps, K6 <-> K7, K8 <-> K9 through the
// transposed maps); see rtfs_tpu_torch/ops/packed_tf.py.
//
// A packed map is (B, T, F*C) with the channel fastest (the JAX packed
// layout); the port's rank-4 maps are channels-first (B, C, T, F). Each C
// entry launches its kernel on the caller's stream (the weight-gradient
// entries two: the per-block partials, then their sum) and returns
// cudaGetLastError().
//
// K5  dw_conv_packed_fwd      replaces the Pallas kernel _make_dw_kernel
//     (rtfs_tpu/ops/packed_tf.py, pallas_call in _dw_conv_fwd_impl):
//       out[b,t,f*C+c] = bias[c] + sum_{dt,df} w[dt,df,c]
//                        * x[b, t+dt-pt_lo, (f+df-pf_lo)*C + c]
//     with x = 0 outside [0,T_in) x [0,F_in) (the TPU folds that boundary
//     into its weight vectors, _dw_wvecs). Bound on the H100: bytes (2*kT*kF
//     flops per 8 bytes in and out). Design: one block per (tile of 8 output
//     rows, tile of FT = 512 / C output f positions, batch row); the block
//     stages the (8 + kT - 1) input rows x (FT + kF - 1)*C columns it reads,
//     zero-filled off the map, and the (kT, kF, C) taps in shared memory, so
//     each input value is read from device memory about once; one thread per
//     output element, neighbouring threads on neighbouring channels, so the
//     loads, the stores and the shared reads are all contiguous.
//
// K6  pw_proj_packed_fwd      replaces _make_pw_proj_kernel
//     (pallas_call in _pw_proj_impl): out[b, p, n] = bias[n] + sum_k
//     x[b, k, p] w[k, n], p = t*F + f, rank-4 in, packed out.
// K7  pw_unproj_packed_fwd    replaces _make_pw_unproj_kernel
//     (pallas_call in _pw_unproj_impl): out[b, n, p] = bias[n] + sum_k
//     x[b, p, k] w[k, n], packed in, rank-4 out.
//     Bound on the H100: float32 operations (2*K*N flops per (K+N)*4 bytes,
//     ~26 flops a byte at K 256, N 64; no tensor cores: full float32 with
//     TF32 off). Design: one template, a tiled product over M = T*F
//     positions: a block owns 64 positions x 64 outputs, stages 16-deep
//     slices of x and w in shared memory and each of its 256 threads keeps a
//     4 x 4 register tile. The template parameter says which side is
//     channel-planar (C, T*F) and which channel-innermost (T*F, C); it picks
//     the loads' and the stores' order so both stay contiguous. w is read
//     through its strides, so the caller passes a view of the torch weight.
//
// K8  spatial_down_packed_fwd replaces _make_spatial_down_kernel
//     (pallas_call in _spatial_down_impl): packed in, rank-4 out,
//       y[b,c,t2,f2] = sum_i tw[t2,i] sum_j fw[f2,j] x[b, ts[t2,i], fs[f2,j]*C + c]
// K9  spatial_up_packed_fwd   replaces _make_spatial_up_kernel
//     (pallas_call in _spatial_up_impl): rank-4 in, packed out,
//       y[b,t,f*C+c] = sum_i tw[t,i] sum_j fw[f,j] x[b, c, ts[t,i], fs[f,j]]
//     The TPU takes the T side as a dense matrix on its matrix unit; here it
//     is the same (T_out, nnz) index/weight form as the F side (entries of
//     weight 0 are skipped, as the TPU kernel skips them), so the sums are
//     the dense product's without its zeros. Bound on the H100: bytes. Design:
//     one block per (output row, tile of 32 f positions, batch row); the block
//     computes its 32 x C outputs in the order that reads its input
//     contiguously, keeps them in a shared tile and writes them in the order
//     that stores contiguously (a transpose through shared memory).
//
// K5-wgrad dw_conv_packed_wgrad replaces _make_dw_wgrad_kernel
//     (pallas_call in _dw_conv_wgrad_impl), folded over F as the JAX
//     backward folds it outside the kernel:
//       dW[dt,df,c] = sum_{b,t,f} g[b,t,f*C+c]
//                     * x[b, t+dt-pt_lo, (f+df-pf_lo)*C+c]
//     with x = 0 off the map. Bound on the H100: bytes (x and g read once,
//     2*kT*kF flops per 8 bytes). The TPU carries one accumulator through
//     its sequential grid; here blocks run in parallel, so each block (32
//     output rows x 512 / C f positions x a batch row) sums its share into
//     one (kT, kF, C) partial, and a second kernel adds the partials in a
//     fixed order: no float atomics, two runs give bit-identical dW. Inside
//     a block, each 8-row tile stages its x window as K5 does (zero-filled
//     off the map) and its g rows in shared memory; each thread owns
//     (tap, channel) pairs, neighbouring threads on neighbouring channels,
//     and sums over the tile's rows and f positions in a register.
//
// pw-wgrad  pw_packed_wgrad     replaces _make_pw_wgrad_kernel
//     (pallas_call in _pw_wgrad_impl): dW (Ca, Cb) = sum_p a[p,:]^T g[p,:]
//     over the B*T*F positions, one side channel-planar (B, C, M) and the
//     other channel-innermost (B, M, C): K6's dW reads the rank-4 x and the
//     packed g, K7's the packed x and the rank-4 g. Bound on the H100:
//     float32 operations (2*Ca*Cb flops per (Ca+Cb)*4 bytes). Design: K6/K7's
//     tiled product turned over: a block owns a 64 x 64 tile of dW and 1024
//     positions of a batch row, stages 32-position slices of both sides in
//     shared memory (loads in each side's contiguous order) and keeps a 4 x 4
//     register tile a thread; it writes its tile's partial, and the same
//     fixed-order second kernel sums the partials.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDwRows = 8;     // K5 output rows per block
constexpr int kDwCols = 512;   // K5 output columns per block (whole f positions)
constexpr int kBM = 64, kBN = 64, kBK = 16;  // K6/K7 tile
constexpr int kMapF = 32;      // K8/K9 f positions per block
constexpr int kWgRows = 32;    // K5-wgrad output rows per block (4 tiles of 8)
constexpr int kPwPos = 1024;   // pw-wgrad positions per block
constexpr int kPwK = 32;       // pw-wgrad positions per staged slice
constexpr long long kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
dw_conv_packed_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T_in, int F_in, int C, int T_out, int F_out, int KT,
                      int KF, int pt_lo, int pf_lo, int ws0, int ws1, int ws2,
                      int FT) {
  extern __shared__ float smem[];
  const int rows_in = kDwRows + KT - 1;
  const int cols_in = (FT + KF - 1) * C;
  float* x_s = smem;                      // (rows_in, cols_in)
  float* w_s = smem + rows_in * cols_in;  // (KT * KF, C)
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kDwRows;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* xb = x + (long long)b * T_in * F_in * C;

  for (int e = tid; e < KT * KF * C; e += kThreads) {
    const int c = e % C, tap = e / C;
    w_s[e] = w[(long long)(tap / KF) * ws0 + (long long)(tap % KF) * ws1 +
               (long long)c * ws2];
  }
  const int fin0 = f0 - pf_lo;  // input f of the tile's first column
  for (int e = tid; e < rows_in * cols_in; e += kThreads) {
    const int r = e / cols_in, j = e % cols_in;
    const int t = t0 - pt_lo + r, f = fin0 + j / C;
    float v = 0.f;
    if (t >= 0 && t < T_in && f >= 0 && f < F_in)
      v = xb[((long long)t * F_in + f) * C + j % C];
    x_s[e] = v;
  }
  __syncthreads();

  const int fcols = FT * C;
  for (int e = tid; e < kDwRows * fcols; e += kThreads) {
    const int r = e / fcols, col = e % fcols;
    const int t = t0 + r, f = f0 + col / C, c = col % C;
    if (t >= T_out || f >= F_out) continue;
    float acc = 0.f;
    for (int dt = 0; dt < KT; ++dt) {
      const float* xr = x_s + (r + dt) * cols_in + col;
      const float* wr = w_s + dt * KF * C + c;
      for (int df = 0; df < KF; ++df) acc = fmaf(wr[df * C], xr[df * C], acc);
    }
    if (bias != nullptr) acc += bias[c];
    out[(((long long)b * T_out + t) * F_out + f) * C + c] = acc;
  }
}

// grid (ceil(M / 64), ceil(N / 64), B), 256 threads. kProj (K6): x is
// (B, K, M), out (B, M, N); otherwise (K7): x (B, M, K), out (B, N, M).
template <bool kProj>
__global__ void __launch_bounds__(kThreads)
pw_packed_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int K, int N, int wsk, int wsn) {
  __shared__ float a_s[kBK][kBM + 1];
  __shared__ float w_s[kBK][kBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* xb = x + (long long)blockIdx.z * M * K;
  float* ob = out + (long long)blockIdx.z * M * N;
  // the thread's rows and columns: the store's contiguous side on tx
  const int mb = kProj ? ty : tx, nb = kProj ? tx : ty;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int mm = kProj ? e % kBM : e / kBK;
      const int kk = kProj ? e / kBM : e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K)
        v = kProj ? xb[(long long)k * M + m] : xb[(long long)m * K + k];
      a_s[kk][mm] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int nn = e % kBN, kk = e / kBN;
      const int n = n0 + nn, k = k0 + kk;
      w_s[kk][nn] = (n < N && k < K)
                        ? w[(long long)k * wsk + (long long)n * wsn]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][mb + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[kk][nb + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mb + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + nb + 16 * j;
      if (n >= N) continue;
      const float v = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
      if (kProj)
        ob[(long long)m * N + n] = v;
      else
        ob[(long long)n * M + m] = v;
    }
  }
}

// sum_i tw[i] sum_j fw[j] src[ts[i] * row_stride + fs[j] * col_stride],
// skipping weight-0 entries
__device__ __forceinline__ float separable_sum(
    const float* src, const int* ts, const float* tw, const int* fs,
    const float* fw, int NT, int NF, long long row_stride, int col_stride) {
  float acc = 0.f;
  for (int i = 0; i < NT; ++i) {
    const float wt = tw[i];
    if (wt == 0.f) continue;
    const float* row = src + (long long)ts[i] * row_stride;
    float s = 0.f;
    for (int j = 0; j < NF; ++j) {
      const float wf = fw[j];
      if (wf == 0.f) continue;
      s = fmaf(wf, row[(long long)fs[j] * col_stride], s);
    }
    acc = fmaf(wt, s, acc);
  }
  return acc;
}

// grid (ceil(F_out / 32), T_out, B). x packed (B, T_in, F_in*C), out
// (B, C, T_out, F_out).
__global__ void __launch_bounds__(kThreads)
spatial_down_kernel(const float* __restrict__ x, const int* __restrict__ ts,
                    const float* __restrict__ tw, const int* __restrict__ fs,
                    const float* __restrict__ fw, float* __restrict__ out,
                    int T_in, int F_in, int C, int T_out, int F_out, int NT,
                    int NF) {
  extern __shared__ float tile[];  // (kMapF, C + 1)
  const int b = blockIdx.z, t2 = blockIdx.y, f20 = blockIdx.x * kMapF;
  const int nf = min(kMapF, F_out - f20);
  const float* xb = x + (long long)b * T_in * F_in * C;
  for (int e = threadIdx.x; e < nf * C; e += kThreads) {  // c fastest
    const int fl = e / C, c = e % C, f2 = f20 + fl;
    tile[fl * (C + 1) + c] =
        separable_sum(xb + c, ts + t2 * NT, tw + t2 * NT, fs + f2 * NF,
                      fw + f2 * NF, NT, NF, (long long)F_in * C, C);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nf * C; e += kThreads) {  // f fastest
    const int c = e / nf, fl = e % nf;
    out[(((long long)b * C + c) * T_out + t2) * F_out + f20 + fl] =
        tile[fl * (C + 1) + c];
  }
}

// grid (ceil(F_out / 32), T_out, B). x (B, C, T_in, F_in), out packed
// (B, T_out, F_out*C).
__global__ void __launch_bounds__(kThreads)
spatial_up_kernel(const float* __restrict__ x, const int* __restrict__ ts,
                  const float* __restrict__ tw, const int* __restrict__ fs,
                  const float* __restrict__ fw, float* __restrict__ out,
                  int T_in, int F_in, int C, int T_out, int F_out, int NT,
                  int NF) {
  extern __shared__ float tile[];  // (kMapF, C + 1)
  const int b = blockIdx.z, t = blockIdx.y, f0 = blockIdx.x * kMapF;
  const int nf = min(kMapF, F_out - f0);
  const float* xb = x + (long long)b * C * T_in * F_in;
  for (int e = threadIdx.x; e < nf * C; e += kThreads) {  // f fastest
    const int c = e / nf, fl = e % nf, f = f0 + fl;
    tile[fl * (C + 1) + c] =
        separable_sum(xb + (long long)c * T_in * F_in, ts + t * NT,
                      tw + t * NT, fs + f * NF, fw + f * NF, NT, NF, F_in, 1);
  }
  __syncthreads();
  float* orow = out + (((long long)b * T_out + t) * F_out + f0) * C;
  for (int e = threadIdx.x; e < nf * C; e += kThreads)  // c fastest
    orow[e] = tile[(e / C) * (C + 1) + e % C];
}

// grid (ceil(F_out / FT), ceil(T_out / kWgRows), B). x packed (B, T_in,
// F_in*C), g packed (B, T_out, F_out*C); each block writes its (KT*KF*C)
// partial of dW to its row of partial.
__global__ void __launch_bounds__(kThreads)
dw_wgrad_partial_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        float* __restrict__ partial, int T_in, int F_in,
                        int C, int T_out, int F_out, int KT, int KF,
                        int pt_lo, int pf_lo, int FT) {
  extern __shared__ float smem[];
  const int rows_in = kDwRows + KT - 1;
  const int cols_in = (FT + KF - 1) * C;
  const int cols = FT * C;
  const int n_acc = KT * KF * C;
  float* x_s = smem;                     // (rows_in, cols_in)
  float* g_s = x_s + rows_in * cols_in;  // (kDwRows, cols)
  float* acc_s = g_s + kDwRows * cols;   // (KT * KF, C), entry e owned by
                                         // thread e % kThreads
  const int b = blockIdx.z, f0 = blockIdx.x * FT, tid = threadIdx.x;
  const int t_begin = blockIdx.y * kWgRows;
  const int t_end = min(T_out, t_begin + kWgRows);
  const float* xb = x + (long long)b * T_in * F_in * C;
  const float* gb = g + (long long)b * T_out * F_out * C;
  for (int e = tid; e < n_acc; e += kThreads) acc_s[e] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kDwRows) {
    __syncthreads();  // the previous tile's shared reads are done
    for (int e = tid; e < rows_in * cols_in; e += kThreads) {
      const int r = e / cols_in, j = e % cols_in;
      const int t = t0 - pt_lo + r, f = f0 - pf_lo + j / C;
      float v = 0.f;
      if (t >= 0 && t < T_in && f >= 0 && f < F_in)
        v = xb[((long long)t * F_in + f) * C + j % C];
      x_s[e] = v;
    }
    for (int e = tid; e < kDwRows * cols; e += kThreads) {
      const int r = e / cols, col = e % cols;
      const int t = t0 + r, f = f0 + col / C;
      g_s[e] = (t < t_end && f < F_out)
                   ? gb[((long long)t * F_out + f) * C + col % C]
                   : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < n_acc; e += kThreads) {
      const int c = e % C, tap = e / C, dt = tap / KF, df = tap % KF;
      float s = 0.f;
      for (int r = 0; r < kDwRows; ++r) {
        const float* gr = g_s + r * cols + c;
        const float* xr = x_s + (r + dt) * cols_in + df * C + c;
        for (int fl = 0; fl < FT; ++fl) s = fmaf(gr[fl * C], xr[fl * C], s);
      }
      acc_s[e] += s;
    }
  }
  float* pb = partial +
              ((long long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x) * n_acc;
  for (int e = tid; e < n_acc; e += kThreads) pb[e] = acc_s[e];
}

// grid (ceil(M / kPwPos), ceil(Ca / 64) * ceil(Cb / 64), B), 256 threads.
// kAPlanar (K6's dW): a (B, Ca, M), g (B, M, Cb); otherwise (K7's): a
// (B, M, Ca), g (B, Cb, M). partial (B * gridDim.x, Ca, Cb).
template <bool kAPlanar>
__global__ void __launch_bounds__(kThreads)
pw_wgrad_partial_kernel(const float* __restrict__ a,
                        const float* __restrict__ g,
                        float* __restrict__ partial, int M, int Ca, int Cb) {
  __shared__ float a_s[kPwK][kBM + 1];
  __shared__ float g_s[kPwK][kBN + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_b = (Cb + kBN - 1) / kBN;
  const int ca0 = (blockIdx.y / tiles_b) * kBM;
  const int cb0 = (blockIdx.y % tiles_b) * kBN;
  const int p_begin = blockIdx.x * kPwPos;
  const int p_end = min(M, p_begin + kPwPos);
  const float* ab = a + (long long)blockIdx.z * M * Ca;
  const float* gb = g + (long long)blockIdx.z * M * Cb;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kPwK) {
    // the planar side loads positions fastest, the innermost side channels
    for (int e = tid; e < kPwK * kBM; e += kThreads) {
      const int pp = kAPlanar ? e % kPwK : e / kBM;
      const int cc = kAPlanar ? e / kPwK : e % kBM;
      const int p = p0 + pp, ch = ca0 + cc;
      float v = 0.f;
      if (p < p_end && ch < Ca)
        v = kAPlanar ? ab[(long long)ch * M + p] : ab[(long long)p * Ca + ch];
      a_s[pp][cc] = v;
    }
    for (int e = tid; e < kPwK * kBN; e += kThreads) {
      const int pp = kAPlanar ? e / kBN : e % kPwK;
      const int cc = kAPlanar ? e % kBN : e / kPwK;
      const int p = p0 + pp, ch = cb0 + cc;
      float v = 0.f;
      if (p < p_end && ch < Cb)
        v = kAPlanar ? gb[(long long)p * Cb + ch] : gb[(long long)ch * M + p];
      g_s[pp][cc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < kPwK; ++pp) {
      float av[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[pp][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = g_s[pp][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* pb =
      partial + ((long long)blockIdx.z * gridDim.x + blockIdx.x) * Ca * Cb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ca = ca0 + ty + 16 * i;
    if (ca >= Ca) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cb = cb0 + tx + 16 * j;
      if (cb < Cb) pb[(long long)ca * Cb + cb] = acc[i][j];
    }
  }
}

// out[e] = sum_p partial[p, e] in a fixed order: thread row y sums the
// partials p = y, y + kSumY, ... and the kSumY row sums are added in order
constexpr int kSumX = 32, kSumY = 8;

__global__ void __launch_bounds__(kSumX * kSumY)
sum_partials_kernel(const float* __restrict__ partial,
                    float* __restrict__ out, int n_part, int n) {
  __shared__ float s[kSumY][kSumX];
  const int e = blockIdx.x * kSumX + threadIdx.x;
  float acc = 0.f;
  if (e < n)
    for (int p = threadIdx.y; p < n_part; p += kSumY)
      acc += partial[(long long)p * n + e];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < n) {
    float t = 0.f;
    for (int y = 0; y < kSumY; ++y) t += s[y][threadIdx.x];
    out[e] = t;
  }
}

int launch_sum(const void* partial, void* out, int n_part, int n,
               void* stream) {
  sum_partials_kernel<<<(n + kSumX - 1) / kSumX, dim3(kSumX, kSumY), 0,
                        (cudaStream_t)stream>>>((const float*)partial,
                                                (float*)out, n_part, n);
  return (int)cudaGetLastError();
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if ((long long)bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool grid_ok(long long y, long long z) { return y < 65536 && z < 65536; }

template <bool kProj>
int launch_pw(const void* x, const void* w, const void* bias, void* out,
              int B, int M, int K, int N, int wsk, int wsn, void* stream) {
  if (B < 1 || M < 1 || K < 1 || N < 1 || !grid_ok((N + kBN - 1) / kBN, B))
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, B);
  pw_packed_kernel<kProj><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)out, M, K,
      N, wsk, wsn);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch_map(Kernel kernel, const void* x, const void* ts, const void* tw,
               const void* fs, const void* fw, void* out, int B, int T_in,
               int F_in, int C, int T_out, int F_out, int NT, int NF,
               void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || NT < 1 || NF < 1 ||
      !grid_ok(T_out, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMapF * (C + 1) * sizeof(float);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((F_out + kMapF - 1) / kMapF, T_out, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)ts, (const float*)tw, (const int*)fs,
      (const float*)fw, (float*)out, T_in, F_in, C, T_out, F_out, NT, NF);
  return (int)cudaGetLastError();
}

}  // namespace

// w is (KT, KF, C) through its strides (ws0, ws1, ws2); bias may be NULL.
extern "C" int dw_conv_packed_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int B, int T_in,
                                  int F_in, int C, int T_out, int F_out,
                                  int KT, int KF, int pt_lo, int pf_lo,
                                  int ws0, int ws1, int ws2, void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || KT < 1 || KF < 1)
    return (int)cudaErrorInvalidValue;
  const int FT = C >= kDwCols ? 1 : kDwCols / C;
  const size_t smem = ((size_t)(kDwRows + KT - 1) * (FT + KF - 1) * C +
                       (size_t)KT * KF * C) * sizeof(float);
  const long long tiles_t = (T_out + kDwRows - 1) / kDwRows;
  if (!grid_ok(tiles_t, B)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)dw_conv_packed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((F_out + FT - 1) / FT, (unsigned)tiles_t, B);
  dw_conv_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)out, T_in,
      F_in, C, T_out, F_out, KT, KF, pt_lo, pf_lo, ws0, ws1, ws2, FT);
  return (int)cudaGetLastError();
}

// x (B, K, M) rank-4 with M = T*F, w (K, N) through strides, out (B, M, N)
extern "C" int pw_proj_packed_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int B, int M,
                                  int K, int N, int wsk, int wsn,
                                  void* stream) {
  return launch_pw<true>(x, w, bias, out, B, M, K, N, wsk, wsn, stream);
}

// x (B, M, K) packed, w (K, N) through strides, out (B, N, M) rank-4
extern "C" int pw_unproj_packed_fwd(const void* x, const void* w,
                                    const void* bias, void* out, int B, int M,
                                    int K, int N, int wsk, int wsn,
                                    void* stream) {
  return launch_pw<false>(x, w, bias, out, B, M, K, N, wsk, wsn, stream);
}

// maps: ts/tw (T_out, NT), fs/fw (F_out, NF), int32 / float32
extern "C" int spatial_down_packed_fwd(const void* x, const void* ts,
                                       const void* tw, const void* fs,
                                       const void* fw, void* out, int B,
                                       int T_in, int F_in, int C, int T_out,
                                       int F_out, int NT, int NF,
                                       void* stream) {
  return launch_map(spatial_down_kernel, x, ts, tw, fs, fw, out, B, T_in,
                    F_in, C, T_out, F_out, NT, NF, stream);
}

extern "C" int spatial_up_packed_fwd(const void* x, const void* ts,
                                     const void* tw, const void* fs,
                                     const void* fw, void* out, int B,
                                     int T_in, int F_in, int C, int T_out,
                                     int F_out, int NT, int NF, void* stream) {
  return launch_map(spatial_up_kernel, x, ts, tw, fs, fw, out, B, T_in, F_in,
                    C, T_out, F_out, NT, NF, stream);
}

// x (B, T_in, F_in*C), g (B, T_out, F_out*C) packed; out (KT, KF, C);
// partial holds n_part rows of KT*KF*C, one a block (the wrapper sizes it,
// and a grid of another size is refused)
extern "C" int dw_conv_packed_wgrad(const void* x, const void* g,
                                    void* partial, void* out, int B,
                                    int T_in, int F_in, int C, int T_out,
                                    int F_out, int KT, int KF, int pt_lo,
                                    int pf_lo, int n_part, void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || KT < 1 || KF < 1)
    return (int)cudaErrorInvalidValue;
  const int FT = C >= kDwCols ? 1 : kDwCols / C;
  const long long tiles_t = (T_out + kWgRows - 1) / kWgRows;
  const long long tiles_f = (F_out + FT - 1) / FT;
  if (!grid_ok(tiles_t, B) || tiles_f * tiles_t * B != n_part)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(kDwRows + KT - 1) * (FT + KF - 1) * C +
                       (size_t)kDwRows * FT * C + (size_t)KT * KF * C) *
                      sizeof(float);
  cudaError_t e = allow_smem((const void*)dw_wgrad_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)tiles_f, (unsigned)tiles_t, B);
  dw_wgrad_partial_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (float*)partial, T_in, F_in, C,
      T_out, F_out, KT, KF, pt_lo, pf_lo, FT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, out, n_part, KT * KF * C, stream);
}

// a_planar: a (B, Ca, M) rank-4 and g (B, M, Cb) packed (K6's dW), else a
// (B, M, Ca) packed and g (B, Cb, M) rank-4 (K7's); out (Ca, Cb); partial
// holds n_part = B * ceil(M / 1024) rows of Ca*Cb
extern "C" int pw_packed_wgrad(const void* a, const void* g, void* partial,
                               void* out, int B, int M, int Ca, int Cb,
                               int a_planar, int n_part, void* stream) {
  if (B < 1 || M < 1 || Ca < 1 || Cb < 1) return (int)cudaErrorInvalidValue;
  const long long chunks = (M + kPwPos - 1) / kPwPos;
  const long long tiles =
      (long long)((Ca + kBM - 1) / kBM) * ((Cb + kBN - 1) / kBN);
  if (!grid_ok(tiles, B) || chunks * B != n_part)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)tiles, B);
  if (a_planar)
    pw_wgrad_partial_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)g, (float*)partial, M, Ca, Cb);
  else
    pw_wgrad_partial_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)g, (float*)partial, M, Ca, Cb);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, out, n_part, Ca * Cb, stream);
}
