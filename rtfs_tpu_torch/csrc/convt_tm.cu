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
// products are bound by float32 operations.
//
// Design of out and dx (one kernel, ``Bwd`` picks the direction of the
// stencil): one block per (output step t, tile of 64 batch columns),
// 16 x 8 threads, each thread a register tile of 8 output channels x 4
// columns. Per tap j the block stages W[j] with the output channel
// fastest ((C_red, C_out) rows padded to 68 floats) and the input tile
// (C_red x 64) in shared memory; per reduced channel a thread then reads
// one float4 of input and two of W for 32 FMAs. Global loads and stores
// are coalesced along the batch columns. The forward reads x[t-j] (taps
// off the sequence skipped), dx reads g[l+j] (always on it).
//
// Design of dW, a (C_out x C_in) product per tap reduced over L*B: one
// block per (tap j, chunk of steps), 16 x 16 threads, each thread a 4 x 4
// register tile of (o, i). The block walks its steps' batch columns 32 at
// a time, staging g[l+j] and x[l] tiles transposed (column-major, rows of
// 68 floats) so a thread reads one float4 of each per column. Each block
// writes its own (C_out, C_in) partial; the wrapper sums the partials in a
// fixed order, so dW is the same from run to run (no float atomics).

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;    // batch columns per block (out / dx)
constexpr int kMaxOut = 64;  // output-channel limit: 8 thread rows x 8
constexpr int kWs = kMaxOut + 4;
constexpr int kRedCols = 32;  // batch columns per dW stage
constexpr int kMaxCh = 64;    // dW: C_out and C_in limit (16 threads x 4)

// grid (ceil(B / 64), T_out), block (16, 8). Forward: in = x (L, Cr, B),
// T_out = L + K - 1, out channels Co; Bwd: in = g (L + K - 1, Cr, B),
// T_out = L, out channels Co = C_in. w is W (K, C_out, C_in) either way.
template <bool Bwd>
__global__ void convt1d_tm_kernel(const float* __restrict__ in,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int T_in, int Cr,
                                  int Co, int K, int B) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  const int b0 = blockIdx.x * kCols;
  float* w_s = smem;              // (Cr, kWs): w_s[q][p] = M_j[p][q]
  float* x_s = smem + Cr * kWs;   // (Cr, kCols)
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;

  for (int j = 0; j < K; ++j) {
    const int l = Bwd ? t + j : t - j;
    if (l < 0 || l >= T_in) continue;  // uniform over the block
    __syncthreads();
    const float* wj = w + (long long)j * Co * Cr;
    for (int e = tid; e < kMaxOut * Cr; e += nthreads) {
      if (Bwd) {  // M_j[p][q] = W[j][q][p]: W[j] is (Cr, Co), copy as is
        const int q = e / kMaxOut, p = e % kMaxOut;
        w_s[q * kWs + p] = p < Co ? wj[q * Co + p] : 0.f;
      } else {    // M_j[p][q] = W[j][p][q]: W[j] is (Co, Cr), transpose
        const int p = e / Cr, q = e % Cr;
        w_s[q * kWs + p] = p < Co ? wj[p * Cr + q] : 0.f;
      }
    }
    for (int e = tid; e < Cr * kCols; e += nthreads) {
      const int i = e / kCols, b = b0 + e % kCols;
      x_s[e] = b < B ? in[((long long)l * Cr + i) * B + b] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < Cr; ++i) {
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

// grid (n_chunks, K), block (16, 16); block (chunk, j) reduces steps
// l in [chunk * Lc, min(L, (chunk + 1) * Lc)) over all B columns and
// writes dw_part[chunk][j] (C_out, C_in).
__global__ void convt1d_tm_dw_kernel(const float* __restrict__ g,
                                     const float* __restrict__ x,
                                     float* __restrict__ dw_part, int L,
                                     int Ci, int Co, int K, int B, int Lc) {
  __shared__ float4 g_s4[kRedCols * kWs / 4];  // g_s[col][o]
  __shared__ float4 x_s4[kRedCols * kWs / 4];  // x_s[col][i]
  float* g_s = reinterpret_cast<float*>(g_s4);
  float* x_s = reinterpret_cast<float*>(x_s4);
  const int j = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  const int l0 = blockIdx.x * Lc, l1 = min(L, l0 + Lc);
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int l = l0; l < l1; ++l) {
    const float* gl = g + (long long)(l + j) * Co * B;
    const float* xl = x + (long long)l * Ci * B;
    for (int b0 = 0; b0 < B; b0 += kRedCols) {
      __syncthreads();
      for (int e = tid; e < kMaxCh * kRedCols; e += nthreads) {
        const int ch = e / kRedCols, c = e % kRedCols, b = b0 + c;
        const bool ok = b < B;
        g_s[c * kWs + ch] = ok && ch < Co ? gl[(long long)ch * B + b] : 0.f;
        x_s[c * kWs + ch] = ok && ch < Ci ? xl[(long long)ch * B + b] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kRedCols; ++c) {
        const float4 gv = *reinterpret_cast<const float4*>(g_s + c * kWs + 4 * ty);
        const float4 xv = *reinterpret_cast<const float4*>(x_s + c * kWs + 4 * tx);
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += ga[p] * xa[q];
      }
    }
  }
  float* dw = dw_part + ((long long)blockIdx.x * K + j) * Co * Ci;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int o = 4 * ty + p;
    if (o >= Co) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * tx + q;
      if (i < Ci) dw[o * Ci + i] = acc[p][q];
    }
  }
}

template <bool Bwd>
cudaError_t launch_stencil(const float* in, const float* w, float* out,
                           int T_in, int T_out, int Cr, int Co, int K, int B,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(Cr * (kWs + kCols)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convt1d_tm_kernel<Bwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((B + kCols - 1) / kCols, T_out);
  dim3 block(kCols / 4, 8);
  convt1d_tm_kernel<Bwd><<<grid, block, smem, stream>>>(in, w, out, T_in, Cr,
                                                        Co, K, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int convt1d_ola_tm_fwd(const void* x, const void* w, void* out,
                                  int L, int Ci, int Co, int K, int B,
                                  void* stream) {
  if (Co > kMaxOut) return (int)cudaErrorInvalidValue;
  return (int)launch_stencil<false>((const float*)x, (const float*)w,
                                    (float*)out, L, L + K - 1, Ci, Co, K, B,
                                    (cudaStream_t)stream);
}

// dx (L, C_in, B); dw_part (ceil(L / Lc), K, C_out, C_in), summed over its
// first axis by the wrapper.
extern "C" int convt1d_ola_tm_bwd(const void* g, const void* w, const void* x,
                                  void* dx, void* dw_part, int L, int Ci,
                                  int Co, int K, int B, int Lc,
                                  void* stream) {
  if (Ci > kMaxOut || Ci > kMaxCh || Co > kMaxCh || Lc < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_stencil<true>((const float*)g, (const float*)w,
                                       (float*)dx, L + K - 1, L, Co, Ci, K, B,
                                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + Lc - 1) / Lc, K);
  dim3 block(16, 16);
  convt1d_tm_dw_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)x, (float*)dw_part, L, Ci, Co, K, B, Lc);
  return (int)cudaGetLastError();
}
