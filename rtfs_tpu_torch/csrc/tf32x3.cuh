// Device helpers shared by the hand-written Hopper kernels (sm_90a):
// float32 products on the tensor cores in 3xTF32, bfloat16 products with a
// float32 accumulator (the bf16-storage forwards), and cp.async copies.
// Every inline PTX instruction of the sources that include it is here.
//
// 3xTF32. TF32 keeps 10 of float32's 23 mantissa bits, so one TF32
// product per float32 one would not hold the kernels' 1e-4 gates. Each
// operand value x is split on the fly into big = x rounded to TF32 and
// small = x - big, which together keep about 21-22 bits of x, and a
// product a b is issued as three TF32 products, a_small b_big, a_big
// b_small and a_big b_big, into one f32 accumulator (a_small b_small,
// below 2^-21 of a b, is dropped). The split reads the float32 operand as
// it lies in shared memory: there is no pre-split copy.
//
// The split's cost. big is rounded to nearest, ties away from zero, the
// rounding of cvt.rna.tf32.f32, written as the integer add and mask that
// the instruction performs: sm_90 has no single instruction for it, and
// nvcc lowers cvt.rna.tf32.f32 to that add and mask behind an inf/NaN
// test and a select (four instructions a value for two). small = x - big
// is exact and is not rounded: the tensor core reads only the top 10
// mantissa bits of a TF32 operand, so small enters truncated, within
// 2^-21 |x|. Three instructions a value, not eleven with cvt for both
// halves (PERF.md). A NaN in x gives a NaN small, so NaN still
// reaches the output.
//
// What bounds a 3xTF32 product on the H100: three tensor-core products a
// float32 one, so at most 495 / 3 = 165 TFLOP/s of float32 work against
// 67 TFLOP/s on the SIMT units. mma.sync, the warp-level instruction of
// earlier generations, reaches only part of the tensor cores' peak on
// Hopper: tools/mma_rate.py measures about 320 TFLOP/s of TF32 at two or
// more warps a scheduler with two or more independent accumulators a
// warp, and 25 cycles from one dependent mma.sync to the next, so 3xTF32
// this way tops out near 107 TFLOP/s of float32 work. Each operand
// element a warp loads costs three ALU instructions to split, so a tile
// that reuses its fragments little is bound by those instructions and
// the shared-memory loads, not by the tensor cores: the kernels make
// each fragment serve several products.
//
// Why mma.sync and not wgmma: wgmma takes B (and A, unless it is in
// registers) from shared memory in its own layout, 64-row tiles for a
// warpgroup and asynchronous fences; a 3xTF32 wgmma would need B's big
// and small halves stored in shared memory, a second copy of the
// operand. At these depths (64 for K2's projection, 512 for K3) and
// these tile sizes, register-fed m16n8k8 products are the simple route;
// wgmma is a later lever.
//
// Fragments of mma.sync.m16n8k8 (.tf32), lane = 4 g + q: A (16 x 8) a0
// (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4); B (8 x 8, k x n) b0
// (q, g), b1 (q+4, g); C/D (16 x 8) c0 (g, 2q), c1 (g, 2q+1), c2 (g+8,
// 2q), c3 (g+8, 2q+1). Each kernel reads its fragments from shared
// memory in its own layout, with the padded row stride or swizzle that
// keeps them free of bank conflicts stated beside it, and splits them
// with split().

#pragma once

#include <cstdint>

namespace hk {

// ------------------------------------------------------------ 3xTF32

// x rounded to TF32 (nearest, ties away), in a 32-bit container
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small; the tensor core truncates small to TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with a float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// acc += a b in 3xTF32: the two cross terms, then the big product, into
// one float32 accumulator fragment
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(acc, a.small, b.big);
  mma_tf32(acc, a.big, b.small);
  mma_tf32(acc, a.big, b.big);
}

// 3xTF32 with the big products kept apart, for every tile pair: corr[i][j]
// += a_small b_big + a_big b_small, big[i][j] += a_big b_big, issued pass
// by pass over the pairs so that consecutive mma.sync write different
// accumulators (a dependent one waits ~25 cycles for the last). Why apart:
// the tensor core rounds its sums toward zero, so a float32 sum kept in
// its accumulator over a long K drifts toward zero by up to an ulp a step,
// and every output comes out slightly small (a bias that a later sum over
// many outputs, a weight gradient, adds up: 25x the float32 error on one
// packed weight gradient at K 256). The caller adds big to a float32 sum
// on the SIMT units, which round to nearest, every few k steps, and
// zeroes it; corr, 2^-11 of the sum, drifts below float32's rounding of
// it and is added once at the end.
template <int MI, int NJ>
__device__ __forceinline__ void mma3_apart(float (&big)[MI][NJ][4],
                                           float (&corr)[MI][NJ][4],
                                           const FragA (&a)[MI],
                                           const FragB (&b)[NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(corr[i][j], a[i].small, b[j].big);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(corr[i][j], a[i].big, b[j].small);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(big[i][j], a[i].big, b[j].big);
}

// ------------------------------------------------------------ bf16

// d += a b, one m16n8k16 product of bf16 operands with a float32
// accumulator: exactly a bf16 dot with a float32 result (the products of
// two bf16 values are exact in float32). Fragments, lane = 4 g + q, each
// 32-bit register two bf16 values, the lower k in the low half: A (16 x
// 16) a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..);
// B (16 x 8, k x n) b0 (2q..2q+1, g), b1 (2q+8..2q+9, g); C/D as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b: mma_bf16 into a zeroed accumulator
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// two bf16 bit patterns into one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// ldmatrix .x4: four 8 x 8 matrices of 16-bit values from shared memory,
// lane l giving the address of row l % 8 of matrix l / 8 (8 values,
// 16-byte aligned); register j of lane 4g + q holds matrix j's row g at
// columns 2q and 2q + 1: an A fragment of m16n8k16 from an [m][k] tile,
// or a B fragment pair from an [n][k] one.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// The shared-window address of p, and ldsm_x4 at such an address (a loop
// then steps its addresses by plain adds).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ldmatrix .x4 .trans: four 8 x 8 matrices of 16-bit values from shared
// memory, lane l giving the address of row l % 8 of matrix l / 8 (8
// values, 16-byte aligned); register j of lane 4g + q holds matrix j's
// rows 2q and 2q + 1 at column g, the lower row in the low half: a B
// fragment pair of m16n8k16 from a [k][n] tile, or an A fragment from a
// [k][m] one, in one instruction instead of eight 2-byte loads and four
// packs.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x4_trans_at(uint32_t (&r)[4],
                                                 unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ------------------------------------------------------------ MUFU

// 2^x and 1 / x on the special-function unit (ex2.approx and rcp.approx,
// flushing subnormals, the instructions __expf and __fdividef lower to);
// not volatile, so the compiler schedules them with the arithmetic
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ named barriers

// Barrier `id` (1-15; 0 is __syncthreads') over `count` threads, a
// multiple of 32: bar_sync waits for all of them, bar_arrive counts this
// thread in and goes on. Shared-memory writes made before either are
// visible to the threads that pass the barrier's bar_sync: a producer's
// bar_arrive and its consumers' bar_sync hand over a buffer.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_q() { return threadIdx.x & 3; }

// ------------------------------------------------------------ cp.async

// 4-byte asynchronous copy global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 4-byte asynchronous copy global -> shared of which only the first
// `bytes` (0, 2 or 4) are read; the rest of the 4 is zero-filled.
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// 16-byte asynchronous copy global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 8-byte asynchronous copy global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// 16-byte asynchronous copy global -> shared of which only the first
// `bytes` (0 to 16) are read; the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// w (8, 4, 2 or 1) consecutive bf16 values global -> shared, zero-filled
// when !ok: one cp.async of 2w bytes (src and dst aligned to it), or for w
// 1, which cp.async has no copy for, a plain load and store, done when it
// returns.
__device__ __forceinline__ void copy_bf16(unsigned short* dst,
                                          const unsigned short* src, int w,
                                          bool ok) {
  if (w == 8)
    cp_async16(dst, src, ok);
  else if (w == 4)
    cp_async8(dst, src, ok);
  else if (w == 2)
    cp_async4(dst, src, ok);
  else
    *dst = ok ? *src : (unsigned short)0;
}

// w (8, 4, 2 or 1) consecutive bf16 values global -> shared of which only
// the first n (0 to w) are read, the rest zero-filled: one cp.async of 2w
// bytes reading 2n (src and dst aligned to 2w bytes; src a valid address
// even where n is 0), or for w 1 a plain load and store.
__device__ __forceinline__ void copy_bf16_n(unsigned short* dst,
                                            const unsigned short* src, int w,
                                            int n) {
  if (w == 8) {
    cp_async16_n(dst, src, 2 * n);
  } else if (w == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(2 * n));
  } else if (w == 2) {
    cp_async4_n(dst, src, 2 * n);
  } else {
    *dst = n > 0 ? *src : (unsigned short)0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// wait until at most N of the committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace hk
