// Packed time-frequency kernels for Hopper (sm_90a), float32, forward.
//
// A packed map is (B, T, F*C) with the channel fastest (the JAX packed
// layout); the port's rank-4 maps are channels-first (B, C, T, F). Each C
// entry launches one kernel on the caller's stream and returns
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDwRows = 8;     // K5 output rows per block
constexpr int kDwCols = 512;   // K5 output columns per block (whole f positions)
constexpr int kBM = 64, kBN = 64, kBK = 16;  // K6/K7 tile
constexpr int kMapF = 32;      // K8/K9 f positions per block
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
