// Time-major ConvTranspose1d (stride 1, padding 0) for Hopper (sm_90a),
// float32.
//
// K3  convt1d_ola_tm_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/convt_tm.py, called from convt1d_ola_tm): the
//     back-projection at the tail of every DualPathRNN.
//
//   out[t, o, b] = sum_{j < k, 0 <= t-j < L} sum_i x[t-j, i, b] * W[j, o, i]
//
// x (L, C_in, B), W (k, C_out, C_in) (not flipped), out (L+k-1, C_out, B),
// the folded batch fastest. The bias is added outside, as in JAX.
//
// What bounds it on the H100: 2*k*C_in*C_out flops per output column
// against (C_in + C_out)*4 bytes, ~128 flops a byte at the DualPathRNN
// geometry (k 8, C 64), far above the card's float32 ratio, so it is bound
// by float32 operations. Design: one block per (output step t, tile of 64
// batch columns), 16 x 8 threads, each thread a register tile of 8 output
// channels x 4 columns. Per tap j the block stages W[j] transposed
// ((C_in, C_out) rows padded to 68 floats) and the x[t-j] tile (C_in x 64)
// in shared memory; per input channel a thread then reads one float4 of x
// and two of W for 32 FMAs. Global loads and stores are coalesced along
// the batch columns.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;    // batch columns per block
constexpr int kMaxOut = 64;  // C_out limit: 8 thread rows x 8 outputs
constexpr int kWs = kMaxOut + 4;

// grid (ceil(B / 64), L + k - 1), block (16, 8).
__global__ void convt1d_tm_fwd_kernel(const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      float* __restrict__ out, int L, int Ci,
                                      int Co, int K, int B) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  const int b0 = blockIdx.x * kCols;
  float* w_s = smem;              // (Ci, kWs): w_s[i][o] = W[j][o][i]
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
      const int o = e / Ci, i = e % Ci;
      w_s[i * kWs + o] = o < Co ? wj[o * Ci + i] : 0.f;
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

}  // namespace

extern "C" int convt1d_ola_tm_fwd(const void* x, const void* w, void* out,
                                  int L, int Ci, int Co, int K, int B,
                                  void* stream) {
  if (Co > kMaxOut) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(Ci * (kWs + kCols)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convt1d_tm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + kCols - 1) / kCols, L + K - 1);
  dim3 block(kCols / 4, 8);
  convt1d_tm_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, L, Ci, Co, K, B);
  return (int)cudaGetLastError();
}
