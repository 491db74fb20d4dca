// Packed time-frequency kernels for Hopper (sm_90a), float32, forward and
// weight gradients, and both also in bf16 storage (the Pallas kernels run
// in the caller's dtype: a bf16 packed model serves and trains in bf16).
// The backward's dx passes are the forward kernels themselves (K5 with
// flipped taps, K6 <-> K7, K8 <-> K9 through the transposed maps); see
// rtfs_tpu_torch/ops/packed_tf.py. The weight gradients on bf16 operands
// (dw_conv_packed_wgrad_bf16, pw_packed_wgrad_bf16) write a float32 dW,
// as JAX's wgrad kernels do; the caller rounds it once.
//
// bf16 storage (the *_fwd_bf16 entries): x, w, bias and out bf16, every
// sum float32, each output rounded once as it is stored. K5 is its
// float32 kernel with the element type a template argument (it widens its
// ring's 8-byte chunks of 4 channels as it reads them). K8 and K9 are
// their own kernels (spatial_down_bf16_kernel, spatial_up_bf16_kernel,
// below; the maps stay float32; JAX's float32 rank-4 side of K8/K9 is a
// Mosaic workaround that gives the same values). K6 and K7 are new
// kernels (pw_proj_bf16_kernel,
// pw_unproj_bf16_kernel): JAX's bf16 dot with a float32 result is one
// bf16 mma.sync m16n8k16 a fragment pair (the products of bf16 values are
// exact, so no 3xTF32 split), 128 x 64 tiles over all of K. Bound on the
// H100: bytes, as in float32, half as many. The channels-first side of K6
// and K7 has rows of M = 251 * 129 values, odd, so every other row starts
// on a 2-byte boundary and cp.async (no 2-byte copy) cannot take them: K6
// reads x's rows value by value (a warp 64 contiguous bytes), K7 stages
// its output tile in shared memory and writes each channel's run of
// positions value by value; their other side (a position's channels,
// contiguous) goes in 16-byte loads or 4-byte stores.
//
// A packed map is (B, T, F*C) with the channel fastest (the JAX packed
// layout); the port's rank-4 maps are channels-first (B, C, T, F). Each C
// entry launches its kernel on the caller's stream (the weight-gradient
// entries two: the per-block partials, then their sum) and returns
// cudaGetLastError().
//
// K5  dw_conv_packed_fwd      replaces the Pallas kernel _make_dw_kernel
//     (rtfs_tpu/ops/packed_tf.py, pallas_call in _dw_conv_fwd_impl;
//     dw_conv_packed_fwd_bf16 the same kernel on bf16 storage):
//       out[b,t,f*C+c] = bias[c] + sum_{dt,df} w[dt,df,c]
//                        * x[b, t+dt-pt_lo, (f+df-pf_lo)*C + c]
//     with x = 0 outside [0,T_in) x [0,F_in) (the TPU folds that boundary
//     into its weight vectors, _dw_wvecs); also its own dx (the flipped
//     taps, complementary pads, no bias). Bound on the H100: bytes (2*kT*kF
//     flops per 8 bytes in and out). Design (dw_conv_packed_kernel): a
//     thread owns a 16-byte chunk of 4 channels at one f position and walks
//     a run of output rows; each input row enters once, through a cp.async
//     ring of 16-byte copies a few rows ahead, and with the presets' 4 x 4
//     taps (template arguments) the thread's 16 tap chunks and 4
//     accumulators stay in registers, so one 16-byte shared read of a row
//     feeds the kT output rows it reaches (4 kT FMAs). Blocks are (channel
//     quads, positions) 2-D, about two an SM (ops/packed_tf.
//     dw_conv_geometry). The first design (one thread an output, 32
//     scalar shared reads for 16 FMAs, divisions on every element, no
//     overlap of loads and sums) took 5.7x as long (PERF.md).
//
// K6  pw_proj_packed_fwd      replaces _make_pw_proj_kernel
//     (pallas_call in _pw_proj_impl; pw_proj_packed_fwd_bf16 on bf16
//     storage, pw_proj_bf16_kernel): out[b, p, n] = bias[n] + sum_k
//     x[b, k, p] w[k, n], p = t*F + f, rank-4 in, packed out; also K7's
//     dx. Bound on the H100: bytes (2*K*N flops per (K+N)*4 bytes, ~26 a
//     byte at K 256, N 64; 3xTF32 at 495 / 3 TFLOP/s would bind above
//     ~49). Design (pw_proj_kernel): the product on the tensor cores in
//     3xTF32 (tf32x3.cuh), one persistent block an SM, W resident, x
//     streamed. A block splits the (K, 64) slice of W of its N tile once
//     into big and small halves in shared memory, in the order the B
//     fragments are read (one 16-byte load a lane, no split in the loop),
//     then walks the (batch row, 128 positions) tiles gridDim.x apart. x
//     comes through a cp.async ring of kProjStages stages of (32 k rows x
//     128 positions) in 16-byte blocks: a row of x starts anywhere (M =
//     251 * 129 at the preset is odd), so each row is copied from the
//     16-byte block that holds its first position and the A fragments
//     read it at that offset; the loads of the next stages run while the
//     warps multiply this one. 16 warps as 8 (positions) x 2 (channels),
//     each a 16 x 32 tile of m16n8k8 products, with 4 warps a scheduler to
//     hide the products' latency. The tensor core rounds its sums toward
//     zero, so the big products are summed on it one stage (32 k) at a
//     time and the stages' sums added in float32 on the SIMT units
//     (hk::mma3_apart): summed on the tensor core over all of K, the
//     outputs came out small enough to fail a packed step's gradient
//     gate. The epilogue adds the bias and stages the (128, 64) tile in
//     shared memory, so each packed row of 64 channels (256 bytes) is
//     written as 16-byte chunks. Each output is summed by one warp in one
//     fixed order: two calls give the same bits. W's split slice takes
//     128 floats a k, so a launch takes at most kProjSlice = 256 k: the
//     entry launches the kernel once for each slice of 256 k of a larger
//     K (512 in the CTCNet and TDFNet presets' bottleneck), the first with
//     the bias, each later one adding its sums to what the one before
//     wrote (ops/packed_tf.pw_proj_geometry mirrors the grid, the slices
//     and the shared memory).
// K7  pw_unproj_packed_fwd    replaces _make_pw_unproj_kernel
//     (pallas_call in _pw_unproj_impl; pw_unproj_packed_fwd_bf16 on bf16
//     storage, pw_unproj_bf16_kernel): out[b, n, p] = bias[n] + sum_k
//     x[b, p, k] w[k, n], packed in, rank-4 out; also K6's dx (w^T, a
//     strided view). Bound on the H100: bytes (as K6, mirrored). Design
//     (pw_unproj_kernel): K6's 3xTF32 product turned round, on its warp
//     tiles, W split, stage sequence and slices of 256 k: a stage copies
//     the tile's positions' contiguous rows of x as 16-byte chunks, and the
//     epilogue turns the (positions, channels) tile round through shared
//     memory, a row a channel, shifted by the offset of its first position
//     in out's 16-byte blocks (M is odd at the preset), so a warp writes a
//     channel's run of positions as aligned 16-byte chunks, element by
//     element at its two ends. The first design, SIMT float32 tiles, took
//     1.5x as long (PERF.md).
//
// K8  spatial_down_packed_fwd replaces _make_spatial_down_kernel
//     (pallas_call in _spatial_down_impl; spatial_down_packed_fwd_bf16 on
//     bf16 storage): packed in, rank-4 out,
//       y[b,c,t2,f2] = sum_i tw[t2,i] sum_j fw[f2,j] x[b, ts[t2,i], fs[f2,j]*C + c]
// K9  spatial_up_packed_fwd   replaces _make_spatial_up_kernel
//     (pallas_call in _spatial_up_impl; spatial_up_packed_fwd_bf16 on bf16
//     storage): rank-4 in, packed out,
//       y[b,t,f*C+c] = sum_i tw[t,i] sum_j fw[f,j] x[b, c, ts[t,i], fs[f,j]]
//     The TPU takes the T side as a dense matrix on its matrix unit; here it
//     is the same (T_out, nnz) index/weight form as the F side (entries of
//     weight 0 are skipped, as the TPU kernel skips them), so the sums are
//     the dense product's without its zeros. Each is the other's dx through
//     the transposed map. Bound on the H100: bytes (one or two flops a
//     value). Both turn the layout round (channels fastest on one side, f
//     on the other) through one shared tile, each side of it read or
//     written in 16-byte chunks: the channel-innermost side a chunk of 4
//     channels of one f, neighbouring threads on neighbouring chunks (whole
//     256-byte channel blocks at C 64); the channels-first side a chunk of
//     4 f of one channel, lanes 4 chunks x 8 channels, so a warp touches
//     64 contiguous bytes of each of 8 rows and the tile's stride
//     (round_up(C, 4) + kMapPad) keeps its scalar accesses at most two to
//     a bank. A block first loads its map rows (ts/tw, all of fs/fw) into
//     shared memory. The map's term counts are template arguments where
//     both are 1-3 (every map the model builds), so the loops over them
//     unroll and each K8 thread has its 2 chunks' NT x NF loads in flight
//     (K9: 4 chunks' NT); the kernels are held to 64 registers so that 4
//     blocks share an SM (faster at bs 4-8; 6 blocks spilled, and so did 4
//     K8 chunks with the loops unrolled). Where C
//     or the row length is not a multiple of 4, or a pointer not 16-byte
//     aligned, the chunks go as scalars.
//     K8: a block owns one output row t2 of a batch row: it reads the
//     column blocks fs names (select: every other one) of the NT source
//     rows, applies both sides on the way in (129 -> 64 halves the tile),
//     and writes the C rows of F_out as 16-byte chunks. (Staging the
//     T-combined source row and applying the F side from the tile instead
//     was slower at every site but the bs-4 pool.)
//     K9: a block owns a run of consecutive output rows whose T rows are
//     equal (the nearest map's pairs; rows with no source), at most
//     MAP_ROWS (ops/packed_tf.py): it stages the T-combined input
//     sum_i tw[i] x[b, :, ts[i], :] as an (F_in, C) tile once, then forms
//     each packed chunk from the tile through the F side and stores it to
//     every row of the run. A run with no source writes 0 without reading
//     x. The wrapper refuses a tile larger than a block's shared memory.
//     In bf16 storage (spatial_down_bf16_kernel, spatial_up_bf16_kernel)
//     the same sums, in the same order, by kernels built for the small
//     bs-1 maps (~5 MB a call at the preset): the float32 kernels' one
//     block a row filled under a quarter of the card at bs 1, staged the
//     map behind a barrier before the first load and moved 8-byte
//     chunks, 0.14-0.26 of the bound. Both move 16-byte chunks of 8
//     values on both sides (value by value where C, the row or a pointer
//     is not aligned to them), read the map through the read-only cache
//     (no staging before the first loads), and issue a chunk's loads
//     (K8: its NT x NF; K9: kUp16Items chunks' NT) before their sums. K8:
//     a block writes kDown16F output f2 of one row (500 blocks of 128
//     threads at bs 1), a thread forms 8 channels of one f2, and a
//     float32 tile turns them round so that each channel's run of f2
//     leaves as 16-byte chunks. K9: a block writes a run of rows (K9's
//     runs, as above) for a block of fb output f; the wrapper picks fb so
//     that the launch has about 4 x 132 blocks or more (5 blocks of 26 f
//     a run at bs 1, one of all 129 at bs 8) and the tile fits, and gives
//     each block the 16-byte input chunks its f's sources lie in
//     (ops/packed_tf.map16_geometry). K9 rounds each F source's term to
//     bf16 and adds the terms in bf16, in order, as JAX's K8 VJP sums one
//     single-source pass a source (one source, every forward map, is one
//     rounding).

// K5-wgrad dw_conv_packed_wgrad replaces _make_dw_wgrad_kernel
//     (pallas_call in _dw_conv_wgrad_impl), folded over F as the JAX
//     backward folds it outside the kernel:
//       dW[dt,df,c] = sum_{b,t,f} g[b,t,f*C+c]
//                     * x[b, t+dt-pt_lo, (f+df-pf_lo)*C+c]
//     with x = 0 off the map. Bound on the H100: bytes (x and g read once,
//     2*kT*kF flops per 8 bytes). The TPU carries one accumulator through
//     its sequential grid; here blocks run in parallel, so each block sums
//     its share into one (kT, kF, C) partial, and a second kernel adds the
//     partials in a fixed order: no float atomics, two runs give
//     bit-identical dW. Design (dw_wgrad_kernel): one wave of blocks, each
//     owning a run of output rows (of all B*T_out), a tile of f positions
//     and a block of 64 channels. A thread owns 4 consecutive channels,
//     one tap row dt and kWgTaps taps along f: 4 kWgTaps sums in
//     registers. It walks its positions of the tile with a window of
//     kWgTaps x values in registers, so a position costs one 16-byte load
//     of g and one of x from shared memory for 4 kWgTaps FMAs (the first
//     design read two floats a FMA and ran at 1/8 of the FMA rate). The
//     rows stream through a cp.async ring of 16-byte copies, the next
//     row's in flight while the threads take this one: a row adds one x
//     row (the tap rows before it are in the ring) and one g row. kT and
//     kF are template arguments at the presets' 4 x 4, runtime values
//     otherwise (kF in groups of kWgTaps taps). dw_conv_packed_wgrad_bf16
//     is the same kernel on bf16 x and g: its ring holds 8-byte chunks of
//     4 bf16 channels (8-byte copies; value by value with plain loads
//     where C % 4 != 0), widened as they are read; the sums float32.
//
// pw-wgrad  pw_packed_wgrad     replaces _make_pw_wgrad_kernel
//     (pallas_call in _pw_wgrad_impl; pw_packed_wgrad_bf16 on bf16 a and
//     g, pw_wgrad16_kernel, a design of its own, below):
//     dW (Ca, Cb) = sum_p a[p,:]^T g[p,:]
//     over the B*T*F positions, one side channel-planar (B, C, M) and the
//     other channel-innermost (B, M, C): K6's dW reads the rank-4 x and the
//     packed g, K7's the packed x and the rank-4 g. Bound on the H100:
//     bytes in 3xTF32 (2*Ca*Cb flops per (Ca+Cb)*4 bytes, ~26 a byte at
//     256 x 64; SIMT float32 would bind by operations). A split-K product:
//     a tiny dW and a reduction over B*M positions (129,516 at bs 4). The
//     TPU carries one accumulator through its grid; here each block sums a
//     chunk of one batch row's positions into one partial of dW and the
//     fixed-order sum_partials_kernel adds the partials: no float atomics,
//     two runs give bit-identical dW. Design (pw_wgrad_kernel): one wave of
//     blocks, each owning a chunk of positions and a tile of kPwRows planar
//     x kPwCols packed channels, at the presets' 256 x 64 two tiles, so the
//     64-channel side is read twice (the two blocks of a chunk run at once,
//     the second read mostly from L2) and the 256-channel side once. Both
//     sides stream through a cp.async ring of kPwK-position stages in
//     16-byte copies: a packed position's channels are contiguous; a planar
//     row's positions start anywhere in a 16-byte block (M = 251 * 129 is
//     odd), so each row lands shifted by its start's offset in its block,
//     its middle blocks copied whole and its two ends element by element
//     (zero past the chunk). The product runs on the tensor cores in 3xTF32
//     with the big products summed apart (hk::mma3_apart): planar channels
//     are the m16 rows, positions the k8 depth, packed channels the n8
//     columns. A planar row's shift depends on its channel mod 4, so a
//     block stages its rows grouped by channel mod 4 and each m16 tile
//     takes 16 channels of one class: one shift a tile, and the A fragment
//     reads of a warp hit 32 banks. The big products are added to a float32
//     sum every kPwFlush stages, and the cross terms once at the end.
//     Registers choose the tile: big, cross terms and sum of a 128 x 64 tile
//     fit a thread's registers (~160-180 of 255 at 256 threads); for all
//     256 x 64 of dW a block (each side read once) they do not (128 at 512
//     threads: spills); such a tile with its sum in shared memory, which
//     at 3 stages leaves room for 32-position stages only, ran ~10% slower
//     (PERF.md, PR 13). The first design (SIMT float32 64 x 64 tiles,
//     the 64-channel side read once per 64 rows of the other, plain loads,
//     no overlap) took ~280 us a bs-4 launch, this one ~115.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
// K5 (ops/packed_tf.py mirrors them): channel quads a block (64
// channels), threads a block at most, input rows in flight ahead of the
// row a step takes
constexpr int kDwQuads = 16;
constexpr int kDwThreads = 256;
constexpr int kDwAhead = 4;
// K6 (ops/packed_tf.py mirrors them): kProjThreads threads a block, a
// tile of kProjM positions x kProjN channels, kProjK rows of x a stage in
// a ring of kProjStages; staged rows padded by kProjPad floats (a stride
// of 8 mod 32 banks: the 8 g x 4 q lanes of a fragment read hit 32 banks)
constexpr int kProjThreads = 512;  // 16 warps, each 16 positions x 32
constexpr int kProjM = 128;
constexpr int kProjN = 64;
constexpr int kProjK = 32;
constexpr int kProjStages = 3;
constexpr int kProjPad = 8;
constexpr int kProjSlice = 256;  // k rows of W a launch holds split
// K7 (ops/packed_tf.py mirrors them): a tile of kUnprojM positions x
// kProjN channels, kUnprojThreads threads as (kUnprojM / 16) x 2 warps of
// K6's 16 positions x 32 channels, kUnprojBlocks blocks an SM; x staged
// kProjK k a stage in a ring of kUnprojStages, a staged position's kProjK
// k padded to kUnprojXS floats (4 mod 32 banks: the 8 g x 4 q lanes of a
// fragment read hit 32 banks); W split as K6's, kProjSlice k a launch;
// the output tile staged a channel a row, rows of kUnprojOS floats (the
// tile's positions, a row's shift of 0-3 and a pad; 4 mod 16 banks, so
// the (g, 2q) lanes of a fragment write hit distinct banks but for the
// rows' shifts)
constexpr int kUnprojM = 128;
constexpr int kUnprojThreads = kUnprojM / 16 * 2 * 32;
constexpr int kUnprojStages = 3;
constexpr int kUnprojBlocks = 1;
constexpr int kUnprojXS = kProjK + 4;
constexpr int kUnprojOS = kUnprojM + 4;
constexpr int kMapPad = 4;     // K8/K9 tile: floats past round_up(C, 4) a row
constexpr int kMapBlocks = 4;  // K8/K9 blocks an SM: at most 64 registers
constexpr int kK8Items = 2;   // K8: chunks a thread loads at once
constexpr int kK9Items = 4;   // K9: chunks a thread loads at once
// K8 and K9 in bf16 storage (ops/packed_tf.py mirrors them): a K8 block
// kDown16F output f2 of one row, kDown16Threads threads, kDown16Blocks an
// SM (at most 85 registers); a K9 block kUp16Threads threads, kUp16Blocks
// an SM (at most 42 registers), each thread staging kUp16Items chunks at
// once (half where NT > 1); their float32 tiles' rows round_up(C, 8) +
// kMap16Pad floats (a row's 8-channel chunks 16-byte aligned; 4 mod 32
// banks). tools/kernel_variants.py maps16 times other values: 2 items and
// 6 blocks beat 4 and 4 by 1.3 us at bs 1 and 1 us at bs 8 (PERF.md)
constexpr int kDown16Threads = 128;
constexpr int kDown16F = 16;
constexpr int kDown16Blocks = 6;
constexpr int kUp16Threads = 256;
constexpr int kUp16Blocks = 6;
constexpr int kUp16Items = 2;
constexpr int kMap16Pad = 4;
// K5-wgrad (ops/packed_tf.py mirrors them): threads a block when the taps
// are template arguments, and at most; the taps of a thread's window
constexpr int kWgThreads = 256;
constexpr int kWgMaxThreads = 1024;
constexpr int kWgTaps = 4;
// pw-wgrad (ops/packed_tf.py mirrors them): a block's tile of dW is
// kPwRows planar x kPwCols packed channels, kPwThreads threads as
// (kPwRows / 32) x 2 warps of 32 x 32; kPwK positions a stage in a ring of
// kPwStages; the float32 sum in registers, the big products added to it
// every kPwFlush stages; a thread copies a planar row. Staged planar rows
// of kPwPS floats (a row's kPwK positions, its shift of 0-3; 4 mod 32
// banks), packed positions of kPwQS (8 mod 32: the q x g lanes of a B fragment
// read hit 32 banks), output tile rows of kPwOS (2 mod 8: the pairs of
// outputs of a half warp hit 32 banks)
constexpr int kPwRows = 128;
constexpr int kPwCols = 64;
constexpr int kPwK = 64;
constexpr int kPwStages = 3;
constexpr int kPwFlush = 1;
constexpr int kPwThreads = 2 * kPwRows;
constexpr int kPwPS = kPwK + 4;
constexpr int kPwQS = kPwCols + 8;
constexpr int kPwOS = kPwCols + 2;
// K6 and K7 in bf16 storage (ops/packed_tf.py mirrors them): a tile of
// kP16M positions x kP16N channels, kP16Threads threads as 4 (positions)
// x 2 (channels) warps of 32 x 32; kP16K k a stage, two stages in shared
// memory; staged rows padded by 8 bf16 (a bf16 pair a 4-byte word, so
// the 8 g x 4 q lanes of a fragment read hit distinct banks, or share a
// word)
constexpr int kP16M = 128;
constexpr int kP16N = 64;
constexpr int kP16K = 32;
constexpr int kP16Threads = 256;
constexpr int kP16XS = kP16M + 8;  // K6: a staged k row of positions
constexpr int kP16KS = kP16K + 8;  // a staged position's or channel's k
constexpr long long kMaxSmem = 227 * 1024;

// a chunk of 4 floats at p: one 16-byte access where vec (every chunk of
// the row whole and 16-byte aligned), else the first n as scalars
__device__ __forceinline__ float4 load_chunk(const float* p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void store_chunk(float* p, float4 v, int n,
                                            bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

// a chunk of 4 channels as float32: a float4 as it is, 4 bf16 in 8 bytes
// widened (exact)
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to bf16 once, as a chunk of 4 at p: one 8-byte store where
// vec, else the first n as scalars
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, float4 v, int n,
                                            bool vec) {
  const unsigned short e[4] = {bf16_bits(v.x), bf16_bits(v.y), bf16_bits(v.z),
                               bf16_bits(v.w)};
  if (vec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        (uint32_t)e[0] | ((uint32_t)e[1] << 16),
        (uint32_t)e[2] | ((uint32_t)e[3] << 16));
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  for (int k = 0; k < 4 && k < n; ++k) q[k] = e[k];
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y), fmaf(w, v.z, a.z),
                     fmaf(w, v.w, a.w));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// a chunk of 4 values of E whole at p: 16 bytes aligned for float, 8 for
// bf16
__host__ __device__ __forceinline__ bool chunk_aligned(const float* p) {
  return aligned16(p);
}
__host__ __device__ __forceinline__ bool chunk_aligned(const __nv_bfloat16* p) {
  return (reinterpret_cast<size_t>(p) & 7) == 0;
}

__host__ __device__ __forceinline__ int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// K6's shared floats for a reduction depth K: W's slice split into big
// and small halves in B-fragment order (K padded to whole stages, 128
// floats a k), the ring, the output tile (ops/packed_tf.pw_proj_smem)
__host__ __device__ __forceinline__ int proj_smem_floats(int K) {
  return round_up(K, kProjK) * 2 * kProjN +
         kProjStages * kProjK * (kProjM + kProjPad) +
         kProjM * (kProjN + kProjPad);
}

// K6's and K7's slice of W (K, N) through its strides, split into B
// fragments in shared memory: entry e = (k step, n8 tile, lane (g, q)) of
// w4 holds W[k][n], W[k + 4][n], k = 8 step + q, n = n0 + 8 tile + g, big
// halves then small (zero past K and N); a block of kThreads threads,
// unrolled so that a thread's loads (16 entries at K 256) are in flight
// together
template <int kThreads_>
__device__ __forceinline__ void split_w(float4* w4, const float* w, int K,
                                        int N, int wsk, int wsn, int n0,
                                        int w_entries, int tid) {
#pragma unroll 16
  for (int e = tid; e < w_entries; e += kThreads_) {
    const int lane = e & 31, tile8 = (e >> 5) % (kProjN / 8);
    const int k = (e >> 5) / (kProjN / 8) * 8 + (lane & 3);
    const int n = n0 + 8 * tile8 + (lane >> 2);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[h] = k + 4 * h < K && n < N
                 ? w[(long long)(k + 4 * h) * wsk + (long long)n * wsn]
                 : 0.f;
    uint32_t big[2], small[2];
    hk::split(v[0], big[0], small[0]);
    hk::split(v[1], big[1], small[1]);
    w4[e] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                        __uint_as_float(small[0]), __uint_as_float(small[1]));
  }
}

// A place in a K6 block's sequence of stages: the tile (its batch row b
// and first position m0), the k stage within it and the ring slot. Stage
// s + 1 follows s: the next k stage, or the block's next tile (gridDim.x
// tiles on); the slot goes round the ring.
struct ProjCursor {
  int b, mt, kst, slot;  // mt: the tile's index among its row's M tiles
  __device__ __forceinline__ void next(int ks, int m_tiles) {
    if (++slot == kProjStages) slot = 0;
    if (++kst < ks) return;
    kst = 0;
    mt += gridDim.x;
    b += mt / m_tiles;
    mt %= m_tiles;
  }
};

// grid (blocks, ceil(N / kProjN)), kProjThreads threads, one block an SM.
// x (B, K, M) with xk >= K k rows a batch row (one slice of a deeper x),
// w (K, N) through its strides, out (B, M, N), written as bias + the sums,
// or with accumulate as out + the sums (bias null). Block (x, y)
// keeps W[:, n0 .. n0 + kProjN) and walks the tiles x, x + gridDim.x, ...
// of the B * ceil(M / kProjM) (batch row, positions) tiles. Its stages
// run in one sequence over its tiles (ProjCursor): stage s is k rows
// kst * kProjK .. of its tile, in ring slot s % kProjStages; iteration s
// waits for stage s, issues stage s + kProjStages - 1 into the slot
// iteration s - 1 read, then multiplies stage s.
//
// W's slice is split once, as the block starts: entry e = (k step, n8
// tile, lane) of w4 holds the lane's B fragment of that step and tile,
// (b0, b1) big then small, so a warp reads a fragment in one 16-byte load
// a lane with no split. A row of x starts anywhere (M = 251 * 129 at the
// preset is odd): a stage copies each k row's 128 positions as the 33
// 16-byte blocks that hold them, from the block of the first, so the row
// lands shifted by the first's offset in it, 0-3 floats, the same for
// rows 4 apart (4 M is a multiple of 4). A thread copies the same (row,
// block) pairs every stage. The big products' sums are added to acc once
// a stage (hk::mma3_apart).
__global__ void __launch_bounds__(kProjThreads, 1)
pw_proj_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int B, int M, int K, int N, int wsk, int wsn, int xk,
               int accumulate) {
  constexpr int WS = kProjN + kProjPad, XS = kProjM + kProjPad;
  constexpr int kChunks = kProjM / 4 + 1;  // 16-byte blocks a staged row
  constexpr int kCopies =
      (kProjK * kChunks + kProjThreads - 1) / kProjThreads;
  static_assert(4 * kChunks <= XS, "a staged row holds its blocks");
  extern __shared__ float4 smem4[];
  const int kp = round_up(K, kProjK), ks = kp / kProjK;
  const int w_entries = kp / 8 * (kProjN / 8) * 32;
  float4* w4 = smem4;  // (kp / 8, kProjN / 8, 32 lanes): B fragments
  float* x_s = reinterpret_cast<float*>(w4 + w_entries);
  float* o_s = x_s + kProjStages * kProjK * XS;  // (kProjM, WS): out[m][n]
  const int tid = threadIdx.x, n0 = blockIdx.y * kProjN;
  const int m_tiles = (M + kProjM - 1) / kProjM, tiles = B * m_tiles;
  const int my_tiles =
      (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * ks;
  // x's float index mod 4 at row 0, position 0: with a row's start, its
  // shift in the slot
  const uint32_t x4 = (uint32_t)(reinterpret_cast<uintptr_t>(x) >> 2);

  // the ring zeroed: the rows past K and the positions past M that no
  // copy reaches read 0 or a stale x value, never a NaN
  for (int e = tid; e < kProjStages * kProjK * XS; e += kProjThreads)
    x_s[e] = 0.f;
  __syncthreads();
  // the thread's copies of a stage: (row r, block c) = divmod(tid + i *
  // kProjThreads, kChunks); its offsets in x from the row's start and in
  // the slot
  int cr[kCopies];
  long long c_src[kCopies];
  int c_dst[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = tid + i * kProjThreads;
    cr[i] = e < kProjK * kChunks ? e / kChunks : 1 << 30;  // past any K
    c_src[i] = (long long)cr[i] * M;
    c_dst[i] = cr[i] * XS + 4 * (e % kChunks);
  }
  // the stage at `at` into its slot, one commit group (empty past the
  // block's last stage)
  ProjCursor ld{(int)blockIdx.x / m_tiles, (int)blockIdx.x % m_tiles, 0, 0};
  auto load_stage = [&](int s, const ProjCursor& at) {
    if (s < total) {
      float* dst = x_s + at.slot * kProjK * XS;
      const int k0 = at.kst * kProjK, m0 = at.mt * kProjM;
      const int span = min(kProjM, M - m0);  // needed positions a row
      const float* base = x + ((long long)at.b * xk + k0) * M + m0;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        if (k0 + cr[i] >= K) continue;
        const float* p = base + c_src[i];  // the row's position m0
        const float* src =
            reinterpret_cast<const float*>(
                reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15)) +
            (c_dst[i] - cr[i] * XS);
        // a block holding a needed position; the last may reach past
        // x's end into the same 16-byte block
        if (src < p + span) hk::cp_async16(dst + c_dst[i], src, true);
      }
    }
    hk::cp_async_commit();
  };
  for (int s = 0; s < kProjStages - 1; ++s) {
    load_stage(s, ld);
    ld.next(ks, m_tiles);
  }

  split_w<kProjThreads>(w4, w, K, N, wsk, wsn, n0, w_entries, tid);

  // the warp's 16 x 32 tile: positions wm * 16 .., channels wn * 32 ..;
  // the lane's bias for its accumulators' columns
  const int warp = tid >> 5, wm = warp & 7, wn = warp >> 3;
  const int g = hk::lane_g(), q = hk::lane_q();
  float bias_r[4][2];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int n = n0 + wn * 32 + nb * 8 + 2 * q + v;
      bias_r[nb][v] = bias != nullptr && n < N ? bias[n] : 0.f;
    }
  // acc: the float32 sum of the stages' big products (part, on the tensor
  // core a stage); corr: the cross terms, on the tensor core throughout
  float acc[1][4][4], part[1][4][4], corr[1][4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      acc[0][nb][v] = part[0][nb][v] = corr[0][nb][v] = 0.f;

  // the tile's sums + bias through o_s to out, 16-byte chunks of the
  // packed rows, with accumulate added to what the launch of the slice
  // before wrote there; the sums back to 0
  const bool vec_out = (N & 3) == 0 && aligned16(out);
  auto epilogue = [&](const ProjCursor& at) {
    // D: c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      float* o = o_s + (wm * 16 + g) * WS + wn * 32 + nb * 8 + 2 * q;
      float v4[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        v4[v] = acc[0][nb][v] + corr[0][nb][v] + bias_r[nb][v & 1];
        acc[0][nb][v] = corr[0][nb][v] = 0.f;
      }
      *reinterpret_cast<float2*>(o) = make_float2(v4[0], v4[1]);
      *reinterpret_cast<float2*>(o + 8 * WS) = make_float2(v4[2], v4[3]);
    }
    __syncthreads();
    const int m0 = at.mt * kProjM;
    float* ob = out + ((long long)at.b * M + m0) * N + n0;
    for (int e = tid; e < kProjM * kProjN / 4; e += kProjThreads) {
      const int r = e / (kProjN / 4), c = 4 * (e % (kProjN / 4));
      if (m0 + r >= M || n0 + c >= N) continue;
      float* o = ob + (long long)r * N + c;
      float4 v = *reinterpret_cast<const float4*>(o_s + r * WS + c);
      if (accumulate) {
        const int n = N - n0 - c;
        const float4 was =
            vec_out ? *reinterpret_cast<const float4*>(o)
                    : make_float4(o[0], n > 1 ? o[1] : 0.f,
                                  n > 2 ? o[2] : 0.f, n > 3 ? o[3] : 0.f);
        v = make_float4(was.x + v.x, was.y + v.y, was.z + v.z, was.w + v.w);
      }
      store_chunk(o, v, N - n0 - c, vec_out);
    }
    // the next write of o_s comes after the next stage's barrier
  };

  // the lane's A fragment elements (x[k][m]): rows q, q+4 and columns g,
  // g+8 of the warp's m16 tile, each row shifted as it landed
  const float* xl = x_s + q * XS + wm * 16 + g;
  const float4* wl = w4 + wn * 4 * 32 + (tid & 31);
  ProjCursor at{(int)blockIdx.x / m_tiles, (int)blockIdx.x % m_tiles, 0, 0};
  for (int s = 0; s < total; ++s) {
    hk::cp_async_wait<kProjStages - 2>();
    __syncthreads();  // stage s (and W's split) is in; every warp is done
                      // with stage s - 1
    load_stage(s + kProjStages - 1, ld);
    ld.next(ks, m_tiles);
    const int k0 = at.kst * kProjK;
    const uint32_t shift = (x4 + (uint32_t)(at.b * xk + k0 + q) * (uint32_t)M +
                            (uint32_t)(at.mt * kProjM)) & 3u;
    const float* xa = xl + at.slot * kProjK * XS + shift;
    const float4* wb = wl + at.kst * (kProjK / 8) * (kProjN / 8) * 32;
#pragma unroll
    for (int kk = 0; kk < kProjK; kk += 8) {
      hk::FragA a[1];
      hk::FragB b[4];
      const float* p = xa + kk * XS;
      hk::split(p[0], a[0].big[0], a[0].small[0]);
      hk::split(p[8], a[0].big[1], a[0].small[1]);
      hk::split(p[4 * XS], a[0].big[2], a[0].small[2]);
      hk::split(p[4 * XS + 8], a[0].big[3], a[0].small[3]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float4 f = wb[(kk / 8 * (kProjN / 8) + nb) * 32];
        b[nb].big[0] = __float_as_uint(f.x);
        b[nb].big[1] = __float_as_uint(f.y);
        b[nb].small[0] = __float_as_uint(f.z);
        b[nb].small[1] = __float_as_uint(f.w);
      }
      hk::mma3_apart(part, corr, a, b);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[0][nb][v] += part[0][nb][v];
        part[0][nb][v] = 0.f;
      }
    if (at.kst == ks - 1) epilogue(at);
    at.next(ks, m_tiles);
  }
  hk::cp_async_wait_all();
}

// K7's shared floats for a reduction depth K: W's slice split as K6's,
// the ring of (kUnprojM, kUnprojXS) stages and the (kProjN, kUnprojOS)
// output tile (ops/packed_tf.pw_unproj_smem)
__host__ __device__ __forceinline__ int unproj_smem_floats(int K) {
  return round_up(K, kProjK) * 2 * kProjN +
         kUnprojStages * kUnprojM * kUnprojXS + kProjN * kUnprojOS;
}

// A place in a K7 block's sequence of stages, as ProjCursor in K6's
struct UnprojCursor {
  int b, mt, kst, slot;
  __device__ __forceinline__ void next(int ks, int m_tiles) {
    if (++slot == kUnprojStages) slot = 0;
    if (++kst < ks) return;
    kst = 0;
    mt += gridDim.x;
    b += mt / m_tiles;
    mt %= m_tiles;
  }
};

// grid (blocks, ceil(N / kProjN)), kUnprojThreads threads, kUnprojBlocks an SM.
// x (B, M, xk) packed (a launch reads its K columns of each row from x's
// first: one slice of a deeper x), w (K, N) through its strides, out (B,
// N, M), written as bias + the sums, or with accumulate as out + the sums
// (bias null); vec: xk % 4 == 0 and x 16-byte aligned.
//
// K6's product turned round: out^T = x w, positions x channels, with
// K6's warp tiles, W split and stage sequence (see pw_proj_kernel). What differs is the layout on either side. A stage is
// kProjK k of the tile's kUnprojM positions: each position's row of x is
// contiguous, so the stage is kUnprojM runs of kProjK floats, copied as
// 16-byte chunks (4-byte ones where not vec), zero past M and past K;
// thread tid copies the same (position, chunk) pairs every stage. The A
// fragments read x[m][k] from position rows of kUnprojXS floats. The
// epilogue turns the (positions, channels) tile round through o_s, a row
// a channel: out's rows are a channel's M positions, and M is odd at the
// preset, so a row's tile of positions starts anywhere in a 16-byte
// block. Row n of o_s holds position m at column m + sh(n), sh(n) the
// tile's first position's offset in its 16-byte block of out, so each
// 16-byte chunk of o_s's row is one aligned 16-byte block of out's: a
// warp writes a row's chunks, a lane a chunk, the middle ones as one
// 16-byte store each and the two at the run's ends element by element.
// Each output is summed by one warp in one fixed order: two calls give
// the same bits.
__global__ void __launch_bounds__(kUnprojThreads, kUnprojBlocks)
pw_unproj_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int M, int K, int N, int wsk, int wsn, int xk,
                 int accumulate, int vec) {
  constexpr int XS = kUnprojXS, OS = kUnprojOS;
  constexpr int kChunks = kProjK / 4;  // 16-byte chunks a position a stage
  constexpr int kCopies = kUnprojM * kChunks / kUnprojThreads;
  static_assert(kUnprojM * kChunks % kUnprojThreads == 0, "whole copies");
  static_assert(kUnprojM + 3 < OS, "a shifted row fits its o_s row");
  extern __shared__ float4 smem4[];
  const int kp = round_up(K, kProjK), ks = kp / kProjK;
  const int w_entries = kp / 8 * (kProjN / 8) * 32;
  float4* w4 = smem4;  // (kp / 8, kProjN / 8, 32 lanes): B fragments
  float* x_s = reinterpret_cast<float*>(w4 + w_entries);  // x[m][k]
  float* o_s = x_s + kUnprojStages * kUnprojM * XS;  // out[n][sh(n) + m]
  const int tid = threadIdx.x, n0 = blockIdx.y * kProjN;
  const int m_tiles = (M + kUnprojM - 1) / kUnprojM, tiles = B * m_tiles;
  const int my_tiles =
      (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * ks;

  // the stage at `at` into its slot, one commit group (empty past the
  // block's last stage): copy i of thread tid is chunk (e & 7) of position
  // e >> 3, e = tid + i kUnprojThreads
  UnprojCursor ld{(int)blockIdx.x / m_tiles, (int)blockIdx.x % m_tiles, 0, 0};
  auto load_stage = [&](int s, const UnprojCursor& at) {
    if (s < total) {
      const int k0 = at.kst * kProjK, m0 = at.mt * kUnprojM;
      const float* base = x + ((long long)at.b * M + m0) * xk + k0;
      float* dst = x_s + at.slot * kUnprojM * XS;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int e = tid + i * kUnprojThreads, m = e / kChunks;
        const int k = 4 * (e % kChunks);
        const bool in = m0 + m < M;
        const float* src = base + (long long)m * xk + k;
        float* d = dst + m * XS + k;
        if (vec) {
          const bool ok = in && k0 + k < K;
          hk::cp_async16(d, ok ? src : x, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = in && k0 + k + j < K;
            hk::cp_async4(d + j, ok ? src + j : x, ok);
          }
        }
      }
    }
    hk::cp_async_commit();
  };
  for (int s = 0; s < kUnprojStages - 1; ++s) {
    load_stage(s, ld);
    ld.next(ks, m_tiles);
  }

  split_w<kUnprojThreads>(w4, w, K, N, wsk, wsn, n0, w_entries, tid);

  // the warp's 16 x 32 tile: positions wm * 16 .., channels wn * 32 ..;
  // the lane's bias for its accumulators' columns
  constexpr int kWarpsM = kUnprojM / 16;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = hk::lane_g(), q = hk::lane_q();
  float bias_r[4][2];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int n = n0 + wn * 32 + nb * 8 + 2 * q + v;
      bias_r[nb][v] = bias != nullptr && n < N ? bias[n] : 0.f;
    }
  // acc: the float32 sum of the stages' big products (part, on the tensor
  // core a stage); corr: the cross terms, on the tensor core throughout
  float acc[1][4][4], part[1][4][4], corr[1][4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      acc[0][nb][v] = part[0][nb][v] = corr[0][nb][v] = 0.f;

  // out's float index mod 4 at row 0, position 0: with a row's start, its
  // shift sh in o_s
  const uint32_t o4 = (uint32_t)(reinterpret_cast<uintptr_t>(out) >> 2);
  // the tile's sums + bias through o_s to out, with accumulate added to
  // what the launch of the slice before wrote there; the sums back to 0
  auto epilogue = [&](const UnprojCursor& at) {
    const int m0 = at.mt * kUnprojM, span = min(kUnprojM, M - m0);
    const uint32_t row0 =
        o4 + ((uint32_t)at.b * (uint32_t)N + (uint32_t)n0) * (uint32_t)M +
        (uint32_t)m0;
    // D: c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1) as
    // (position, channel)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = wn * 32 + nb * 8 + 2 * q + (v & 1);
        const int m = wm * 16 + g + 8 * (v >> 1);
        const uint32_t sh = (row0 + (uint32_t)n * (uint32_t)M) & 3u;
        o_s[n * OS + sh + m] =
            acc[0][nb][v] + corr[0][nb][v] + bias_r[nb][v & 1];
        acc[0][nb][v] = corr[0][nb][v] = 0.f;
      }
    __syncthreads();
    for (int r = warp; r < kProjN && n0 + r < N; r += kUnprojThreads / 32) {
      const int sh = (int)((row0 + (uint32_t)r * (uint32_t)M) & 3u);
      // o_s's chunk j is out's 16-byte block at ob + 4 j
      float* ob = out + ((long long)at.b * N + n0 + r) * M + m0 - sh;
      const float* os = o_s + r * OS;
      const int chunks = (sh + span + 3) >> 2;
      for (int j = lane; j < chunks; j += 32) {
        const int lo = 4 * j - sh;  // the chunk's first position
        if (lo >= 0 && lo + 4 <= span) {
          float4 v = *reinterpret_cast<const float4*>(os + 4 * j);
          if (accumulate) {
            const float4 was = *reinterpret_cast<const float4*>(ob + 4 * j);
            v = make_float4(was.x + v.x, was.y + v.y, was.z + v.z,
                            was.w + v.w);
          }
          *reinterpret_cast<float4*>(ob + 4 * j) = v;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (lo + k < 0 || lo + k >= span) continue;
            const float v = os[4 * j + k];
            ob[4 * j + k] = accumulate ? ob[4 * j + k] + v : v;
          }
        }
      }
    }
    // the next write of o_s comes after the next stage's barrier
  };

  // the lane's A fragment elements (x[m][k]): columns q, q+4 of rows g,
  // g+8 of the warp's m16 tile
  const float* xl = x_s + (wm * 16 + g) * XS + q;
  const float4* wl = w4 + wn * 4 * 32 + lane;
  UnprojCursor at{(int)blockIdx.x / m_tiles, (int)blockIdx.x % m_tiles, 0, 0};
  for (int s = 0; s < total; ++s) {
    hk::cp_async_wait<kUnprojStages - 2>();
    __syncthreads();  // stage s (and W's split) is in; every warp is done
                      // with stage s - 1
    load_stage(s + kUnprojStages - 1, ld);
    ld.next(ks, m_tiles);
    const float* xa = xl + at.slot * kUnprojM * XS;
    const float4* wb = wl + at.kst * (kProjK / 8) * (kProjN / 8) * 32;
#pragma unroll
    for (int kk = 0; kk < kProjK; kk += 8) {
      hk::FragA a[1];
      hk::FragB b[4];
      const float* p = xa + kk;
      hk::split(p[0], a[0].big[0], a[0].small[0]);
      hk::split(p[8 * XS], a[0].big[1], a[0].small[1]);
      hk::split(p[4], a[0].big[2], a[0].small[2]);
      hk::split(p[8 * XS + 4], a[0].big[3], a[0].small[3]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float4 f = wb[(kk / 8 * (kProjN / 8) + nb) * 32];
        b[nb].big[0] = __float_as_uint(f.x);
        b[nb].big[1] = __float_as_uint(f.y);
        b[nb].small[0] = __float_as_uint(f.z);
        b[nb].small[1] = __float_as_uint(f.w);
      }
      hk::mma3_apart(part, corr, a, b);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[0][nb][v] += part[0][nb][v];
        part[0][nb][v] = 0.f;
      }
    if (at.kst == ks - 1) epilogue(at);
    at.next(ks, m_tiles);
  }
  hk::cp_async_wait_all();
}

// The bf16 products of K6 and K7: a warp's 32 x 32 tile of one kP16K
// stage, two k16 steps of bf16 mma.sync m16n8k16 with float32
// accumulators (exactly JAX's bf16 dot with a float32 result: the
// products of two bf16 values are exact). w_s is the stage's W as [n][k]
// (rows of kP16KS), so a B register is one 4-byte read; the A fragments
// come from `a_frag`, which K6 and K7 read from their own layouts.
template <typename AFrag>
__device__ __forceinline__ void p16_stage(float (&acc)[2][4][4],
                                          const unsigned short* w_s, int n0,
                                          AFrag a_frag) {
  const int g = hk::lane_g(), q = hk::lane_q();
#pragma unroll
  for (int k0 = 0; k0 < kP16K; k0 += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) a_frag(a[mt], mt, k0);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const unsigned short* p = w_s + (n0 + 8 * nb + g) * kP16KS + k0 + 2 * q;
      b[nb][0] = *reinterpret_cast<const uint32_t*>(p);
      b[nb][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) hk::mma_bf16(acc[mt][nb], a[mt], b[nb]);
  }
}

// W's stage k0 .. k0 + kP16K - 1 of the tile's channels n0 .. n0 + kP16N
// - 1 as [n][k] bf16 (zero past K and N), w (K, N) through its strides:
// a thread 8 values, k fastest across the threads (the layers' weights
// are 1x1 conv weights (N, K), k contiguous)
__device__ __forceinline__ void p16_load_w(unsigned short (&v)[8],
                                           const unsigned short* w, int K,
                                           int N, int wsk, int wsn, int k0,
                                           int n0) {
  const int kk = threadIdx.x % kP16K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = threadIdx.x / kP16K + i * (kP16Threads / kP16K);
    const int k = k0 + kk;
    v[i] = k < K && n0 + n < N
               ? w[(long long)k * wsk + (long long)(n0 + n) * wsn]
               : (unsigned short)0;
  }
}

__device__ __forceinline__ void p16_store_w(const unsigned short (&v)[8],
                                            unsigned short* w_s) {
  const int kk = threadIdx.x % kP16K;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w_s[(threadIdx.x / kP16K + i * (kP16Threads / kP16K)) * kP16KS + kk] = v[i];
}

// K6 in bf16 storage. grid (ceil(M / kP16M), ceil(N / kP16N), B),
// kP16Threads threads. x (B, K, M) rank-4 with M = T*F, w (K, N) through
// its strides, bias (N) or null, out (B, M, N) packed; all bf16. Block
// (x, y, b) forms the tile of positions m0 = x kP16M .. and channels n0 =
// y kP16N .. of batch row b over all of K, kP16K k a stage: the stage's x
// rows ([k][m], rows of kP16XS) and W ([n][k]) go through registers into
// one of two shared stages, the next stage's global loads issued before
// this stage's products. A k row of x starts anywhere (M = 251 * 129 at
// the preset is odd, so every other row is 2-byte aligned only): its 128
// positions are read as bf16 values, a warp 32 consecutive ones (64
// bytes), with no alignment asked. An A register pairs two k rows, read
// apart and packed. The epilogue adds the bias to the float32 sums, rounds
// each output once and writes a channel pair as one 4-byte store where N
// is even (a position's channels are contiguous), else value by value.
// Each output is summed by one warp in one fixed order: two calls give
// the same bits.
__global__ void __launch_bounds__(kP16Threads)
pw_proj_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int wsk, int wsn) {
  __shared__ __align__(16) unsigned short x_s[2][kP16K * kP16XS];
  __shared__ __align__(16) unsigned short w_s[2][kP16N * kP16KS];
  const int b = blockIdx.z, m0 = blockIdx.x * kP16M, n0 = blockIdx.y * kP16N;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = hk::lane_g(), q = hk::lane_q();
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (long long)b * K * M;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  // a thread's x values of a stage: position m0 + tid % kP16M of the k
  // rows tid / kP16M + 2 i
  constexpr int kRowsPer = kP16Threads / kP16M;
  constexpr int kXPer = kP16K / kRowsPer;
  unsigned short xv[kXPer], wv[8];
  const int mm = tid % kP16M, r0 = tid / kP16M;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int k = k0 + r0 + i * kRowsPer;
      xv[i] = k < K && m0 + mm < M ? xb[(long long)k * M + m0 + mm]
                                   : (unsigned short)0;
    }
    p16_load_w(wv, w16, K, N, wsk, wsn, k0, n0);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i)
      x_s[buf][(r0 + i * kRowsPer) * kP16XS + mm] = xv[i];
    p16_store_w(wv, w_s[buf]);
  };
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nb][v] = 0.f;
  const int stages = (K + kP16K - 1) / kP16K;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) load((st + 1) * kP16K);
    // A (position m, k) = x[k][m]: the lane's k 2q, 2q+1 (+8) and
    // positions g, g + 8 of each m16 tile
    const unsigned short* xs = x_s[buf] + 2 * q * kP16XS + wm + g;
    p16_stage(acc, w_s[buf], wn, [&](uint32_t (&a)[4], int mt, int k0) {
      const unsigned short* p = xs + k0 * kP16XS + 16 * mt;
      a[0] = hk::pack_bf16(p[0], p[kP16XS]);
      a[1] = hk::pack_bf16(p[8], p[kP16XS + 8]);
      a[2] = hk::pack_bf16(p[8 * kP16XS], p[9 * kP16XS]);
      a[3] = hk::pack_bf16(p[8 * kP16XS + 8], p[9 * kP16XS + 8]);
    });
    if (st + 1 < stages) store(buf ^ 1);
    __syncthreads();
  }
  // D (position m, channel n): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q),
  // c3 (g+8, 2q+1)
  unsigned short* ob = reinterpret_cast<unsigned short*>(out) +
                       (long long)b * M * N;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int n = n0 + wn + 8 * nb + 2 * q;
      const float b0 = bias != nullptr && n < N ? to_f(bias[n]) : 0.f;
      const float b1 = bias != nullptr && n + 1 < N ? to_f(bias[n + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mt + g + 8 * h;
        if (m >= M || n >= N) continue;
        const unsigned short lo = bf16_bits(acc[mt][nb][2 * h] + b0);
        const unsigned short hi = bf16_bits(acc[mt][nb][2 * h + 1] + b1);
        unsigned short* o = ob + (long long)m * N + n;
        if (pairs)
          *reinterpret_cast<uint32_t*>(o) = (uint32_t)lo | ((uint32_t)hi << 16);
        else {
          o[0] = lo;
          if (n + 1 < N) o[1] = hi;
        }
      }
    }
}

// K7 in bf16 storage. grid (ceil(M / kP16M), ceil(N / kP16N), B),
// kP16Threads threads. x (B, M, K) packed, w (K, N) through its strides,
// bias (N) or null, out (B, N, M) rank-4; all bf16. Block (x, y, b) forms
// the tile of positions m0 = x kP16M .. and channels n0 = y kP16N .. over
// all of K, K6's stages and products; a stage's x is the tile's positions'
// rows of kP16K k ([m][k], rows of kP16KS), contiguous in x, read 8 values
// (16 bytes) a load where vec (K % 8 == 0, x 16-byte aligned), else value
// by value; an A register is one 4-byte read. The epilogue adds the bias,
// rounds each output once into a (kP16N, kP16M + 8) tile of bf16 in the
// stages' shared memory, a channel a row, then writes each channel's run
// of positions as consecutive values (a warp 64 bytes of one row of out).
__global__ void __launch_bounds__(kP16Threads)
pw_unproj_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      int wsk, int wsn, int vec) {
  constexpr int kXStage = kP16M * kP16KS, kWStage = kP16N * kP16KS;
  constexpr int kOS = kP16M + 8;  // a staged output row
  static_assert(kP16N * kOS <= 2 * (kXStage + kWStage),
                "the output tile fits the stages");
  __shared__ __align__(16) unsigned short sm[2 * (kXStage + kWStage)];
  const int b = blockIdx.z, m0 = blockIdx.x * kP16M, n0 = blockIdx.y * kP16N;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = hk::lane_g(), q = hk::lane_q();
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (long long)b * M * K;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  // a thread's x values of a stage: vec, two 16-byte blocks (positions
  // tid / 4 and tid / 4 + 64, k 8 (tid % 4) ..); else 16 values (k
  // tid % 32 of the positions tid / 32 + 8 i)
  constexpr int kVecPer = kP16M * kP16K / 8 / kP16Threads;  // 2
  constexpr int kScalarPer = kP16M * kP16K / kP16Threads;   // 16
  uint4 xq[kVecPer];
  unsigned short xv[kScalarPer], wv[8];
  auto load = [&](int k0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kVecPer; ++i) {
        const int e = tid + i * kP16Threads, m = e / (kP16K / 8);
        const int k = k0 + 8 * (e % (kP16K / 8));
        xq[i] = m0 + m < M && k < K
                    ? __ldg(reinterpret_cast<const uint4*>(
                          xb + (long long)(m0 + m) * K + k))
                    : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScalarPer; ++i) {
        const int m = tid / kP16K + i * (kP16Threads / kP16K);
        const int k = k0 + tid % kP16K;
        xv[i] = m0 + m < M && k < K ? xb[(long long)(m0 + m) * K + k]
                                    : (unsigned short)0;
      }
    }
    p16_load_w(wv, w16, K, N, wsk, wsn, k0, n0);
  };
  auto store = [&](int buf) {
    unsigned short* xs = sm + buf * (kXStage + kWStage);
    if (vec) {
#pragma unroll
      for (int i = 0; i < kVecPer; ++i) {
        const int e = tid + i * kP16Threads;
        *reinterpret_cast<uint4*>(xs + (e / (kP16K / 8)) * kP16KS +
                                  8 * (e % (kP16K / 8))) = xq[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScalarPer; ++i)
        xs[(tid / kP16K + i * (kP16Threads / kP16K)) * kP16KS + tid % kP16K] =
            xv[i];
    }
    p16_store_w(wv, xs + kXStage);
  };
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nb][v] = 0.f;
  const int stages = (K + kP16K - 1) / kP16K;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) load((st + 1) * kP16K);
    // A (position m, k) = x[m][k]: the lane's positions g, g + 8 of each
    // m16 tile and k 2q, 2q+1 (+8), one 4-byte read a register
    const unsigned short* xs = sm + buf * (kXStage + kWStage) +
                               (wm + g) * kP16KS + 2 * q;
    p16_stage(acc, sm + buf * (kXStage + kWStage) + kXStage, wn,
              [&](uint32_t (&a)[4], int mt, int k0) {
                const unsigned short* p = xs + 16 * mt * kP16KS + k0;
                a[0] = *reinterpret_cast<const uint32_t*>(p);
                a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kP16KS);
                a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
                a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kP16KS + 8);
              });
    if (st + 1 < stages) store(buf ^ 1);
    __syncthreads();
  }
  // D (position m, channel n): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q),
  // c3 (g+8, 2q+1), rounded into the tile [n][m] (the stages are done:
  // the last barrier)
  unsigned short* os = sm;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int nl = wn + 8 * nb + 2 * q, ml = wm + 16 * mt + g;
      const float b0 =
          bias != nullptr && n0 + nl < N ? to_f(bias[n0 + nl]) : 0.f;
      const float b1 =
          bias != nullptr && n0 + nl + 1 < N ? to_f(bias[n0 + nl + 1]) : 0.f;
      os[nl * kOS + ml] = bf16_bits(acc[mt][nb][0] + b0);
      os[(nl + 1) * kOS + ml] = bf16_bits(acc[mt][nb][1] + b1);
      os[nl * kOS + ml + 8] = bf16_bits(acc[mt][nb][2] + b0);
      os[(nl + 1) * kOS + ml + 8] = bf16_bits(acc[mt][nb][3] + b1);
    }
  __syncthreads();
  unsigned short* ob = reinterpret_cast<unsigned short*>(out) +
                       (long long)b * N * M;
  for (int e = tid; e < kP16N * kP16M; e += kP16Threads) {
    const int nl = e / kP16M, ml = e % kP16M;
    if (n0 + nl < N && m0 + ml < M)
      ob[(long long)(n0 + nl) * M + m0 + ml] = os[nl * kOS + ml];
  }
}

// item e of a (rows, chunks) walk over a channels-first side, in groups of
// 32 lanes: 4 neighbouring chunks of 8 neighbouring rows
__device__ __forceinline__ void planar_item(int e, int rows, int& r, int& p) {
  const int lane = e & 31, grp = e >> 5, row_groups = (rows + 7) >> 3;
  r = (grp % row_groups) * 8 + (lane >> 2);
  p = (grp / row_groups) * 4 + (lane & 3);
}

__device__ __forceinline__ int planar_items(int rows, int chunks) {
  return 32 * ((rows + 7) >> 3) * ((chunks + 3) >> 2);
}

// the block's map rows into shared memory: fs/fw (F_out, NF) whole, ts/tw
// the T row t; returns whether that row has a source
__device__ __forceinline__ bool stage_map(
    const int* ts, const float* tw, const int* fs, const float* fw, int t,
    int F_out, int NT, int NF, int* fs_s, float* fw_s, int* ts_s,
    float* tw_s) {
  for (int e = threadIdx.x; e < F_out * NF; e += kThreads) {
    fs_s[e] = fs[e];
    fw_s[e] = fw[e];
  }
  for (int e = threadIdx.x; e < NT; e += kThreads) {
    ts_s[e] = ts[(long long)t * NT + e];
    tw_s[e] = tw[(long long)t * NT + e];
  }
  __syncthreads();
  bool any = false;
  for (int i = 0; i < NT; ++i) any |= tw_s[i] != 0.f;
  return any;
}

// grid (T_out, B). x packed (B, T_in, F_in*C), out (B, C, T_out, F_out).
// tile (round_up(F_out, 4), CS): the row's sums, channels fastest.
template <int kNT, int kNF>
__global__ void __launch_bounds__(kThreads, kMapBlocks)
spatial_down_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ ts, const float* __restrict__ tw,
                    const int* __restrict__ fs, const float* __restrict__ fw,
                    int T_in, int F_in, int C, int T_out, int F_out, int nt,
                    int nf) {
  const int NT = kNT > 0 ? kNT : nt, NF = kNF > 0 ? kNF : nf;
  extern __shared__ float4 smem4[];
  const int CS = ((C + 3) & ~3) + kMapPad, CQ = (C + 3) >> 2;
  const int FQ = (F_out + 3) >> 2;
  float* tile = reinterpret_cast<float*>(smem4);
  int* fs_s = reinterpret_cast<int*>(tile + 4 * FQ * CS);
  float* fw_s = reinterpret_cast<float*>(fs_s + F_out * NF);
  int* ts_s = reinterpret_cast<int*>(fw_s + F_out * NF);
  float* tw_s = reinterpret_cast<float*>(ts_s + NT);
  const int b = blockIdx.y, t2 = blockIdx.x, tid = threadIdx.x;
  const bool any = stage_map(ts, tw, fs, fw, t2, F_out, NT, NF, fs_s, fw_s,
                             ts_s, tw_s);

  // in: chunk (f2, q) = channels 4q.. of output f2, both sides applied
  if (any) {
    const float* xb = x + (long long)b * T_in * F_in * C;
    const bool vec = (C & 3) == 0 && chunk_aligned(x);
    const int n = F_out * CQ;
    for (int e0 = tid; e0 < n; e0 += kK8Items * kThreads) {
      float4 acc[kK8Items];
#pragma unroll
      for (int u = 0; u < kK8Items; ++u)
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float wt = tw_s[i];
        if (wt == 0.f) continue;
        const float* row = xb + (long long)ts_s[i] * F_in * C;
        float4 s[kK8Items];
#pragma unroll
        for (int u = 0; u < kK8Items; ++u)
          s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          float wf[kK8Items];
          float4 v[kK8Items];
#pragma unroll
          for (int u = 0; u < kK8Items; ++u) {
            const int e = e0 + u * kThreads, f2 = e / CQ, q = e % CQ;
            wf[u] = e < n ? fw_s[f2 * NF + j] : 0.f;
            v[u] = wf[u] != 0.f
                       ? load_chunk(row + (long long)fs_s[f2 * NF + j] * C +
                                        4 * q,
                                    C - 4 * q, vec)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kK8Items; ++u)
            if (wf[u] != 0.f) s[u] = fma4(wf[u], v[u], s[u]);
        }
#pragma unroll
        for (int u = 0; u < kK8Items; ++u) acc[u] = fma4(wt, s[u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kK8Items; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n)
          *reinterpret_cast<float4*>(tile + (e / CQ) * CS + 4 * (e % CQ)) =
              acc[u];
      }
    }
  }
  __syncthreads();

  // out: chunk (c, p) = f2 4p.. of channel c
  const bool vec = (F_out & 3) == 0 && chunk_aligned(out);
  const int n = planar_items(C, FQ);
  for (int e = tid; e < n; e += kThreads) {
    int c, p;
    planar_item(e, C, c, p);
    if (c >= C || p >= FQ) continue;
    const float* col = tile + 4 * p * CS + c;
    const float4 v = any ? make_float4(col[0], col[CS], col[2 * CS],
                                       col[3 * CS])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    store_chunk(out + (((long long)b * C + c) * T_out + t2) * F_out + 4 * p,
                v, F_out - 4 * p, vec);
  }
}

// grid (G, B): block g writes the output rows [rows[g], rows[g+1]), which
// share one T row of the map. x (B, C, T_in, F_in), out packed
// (B, T_out, F_out*C). tile (round_up(F_in, 4), CS): the T-combined input,
// channels fastest.
template <int kNT, int kNF>
__global__ void __launch_bounds__(kThreads, kMapBlocks)
spatial_up_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const int* __restrict__ ts, const float* __restrict__ tw,
                  const int* __restrict__ fs, const float* __restrict__ fw,
                  const int* __restrict__ rows, int T_in, int F_in, int C,
                  int T_out, int F_out, int nt, int nf) {
  const int NT = kNT > 0 ? kNT : nt, NF = kNF > 0 ? kNF : nf;
  extern __shared__ float4 smem4[];
  const int CS = ((C + 3) & ~3) + kMapPad, CQ = (C + 3) >> 2;
  const int FP = (F_in + 3) >> 2;
  float* tile = reinterpret_cast<float*>(smem4);
  int* fs_s = reinterpret_cast<int*>(tile + 4 * FP * CS);
  float* fw_s = reinterpret_cast<float*>(fs_s + F_out * NF);
  int* ts_s = reinterpret_cast<int*>(fw_s + F_out * NF);
  float* tw_s = reinterpret_cast<float*>(ts_s + NT);
  const int b = blockIdx.y, tid = threadIdx.x;
  const int t0 = rows[blockIdx.x], t1 = rows[blockIdx.x + 1];
  const bool any = stage_map(ts, tw, fs, fw, t0, F_out, NT, NF, fs_s, fw_s,
                             ts_s, tw_s);

  // in: chunk (c, p) = f 4p.. of channel c, summed over the T row
  if (any) {
    const long long plane = (long long)T_in * F_in;
    const float* xb = x + (long long)b * C * plane;
    const bool vec = (F_in & 3) == 0 && chunk_aligned(x);
    const int n = planar_items(C, FP);
    for (int e0 = tid; e0 < n; e0 += kK9Items * kThreads) {
      int c[kK9Items], p[kK9Items];
      bool ok[kK9Items];
      float4 acc[kK9Items];
#pragma unroll
      for (int u = 0; u < kK9Items; ++u) {
        const int e = e0 + u * kThreads;
        planar_item(e, C, c[u], p[u]);
        ok[u] = e < n && c[u] < C && p[u] < FP;
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float wt = tw_s[i];
        if (wt == 0.f) continue;
        const float* row = xb + (long long)ts_s[i] * F_in;
        float4 v[kK9Items];
#pragma unroll
        for (int u = 0; u < kK9Items; ++u)
          v[u] = ok[u] ? load_chunk(row + c[u] * plane + 4 * p[u],
                                    F_in - 4 * p[u], vec)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kK9Items; ++u) acc[u] = fma4(wt, v[u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kK9Items; ++u) {
        if (!ok[u]) continue;
        float* d = tile + 4 * p[u] * CS + c[u];
        d[0] = acc[u].x;
        d[CS] = acc[u].y;
        d[2 * CS] = acc[u].z;
        d[3 * CS] = acc[u].w;
      }
    }
  }
  __syncthreads();

  // out: chunk (f, q) = channels 4q.. of f, through the F side, to every
  // row of the run
  const bool vec = (C & 3) == 0 && chunk_aligned(out);
  const long long row_len = (long long)F_out * C;
  for (int e = tid; e < F_out * CQ; e += kThreads) {
    const int f = e / CQ, q = e % CQ;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (any)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float wf = fw_s[f * NF + j];
        if (wf == 0.f) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            tile + fs_s[f * NF + j] * CS + 4 * q);
        s = fma4(wf, v, s);
      }
    float* o = out + ((long long)b * T_out + t0) * row_len +
               (long long)f * C + 4 * q;
    for (int t = t0; t < t1; ++t, o += row_len) store_chunk(o, s, C - 4 * q, vec);
  }
}

// 8 bf16 values (16 bytes) widened to float32 (exact)
__device__ __forceinline__ void widen8(const uint4& v, float (&o)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// the 16 bytes of 8 bf16 values at p: one 16-byte load where vec, else the
// first n value by value and zero past them
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n,
                                       bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) w[k >> 1] |= (uint32_t)q[k] << (16 * (k & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to bf16 (each value once) as 8 values at p: one 16-byte store
// where vec, else the first n value by value
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8],
                                       int n, bool vec) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)bf16_bits(v[2 * k]) |
           ((uint32_t)bf16_bits(v[2 * k + 1]) << 16);
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) q[k] = (unsigned short)(w[k >> 1] >> (16 * (k & 1)));
}

// a[k] += w * (the 8 bf16 values of raw)[k], each an FMA
__device__ __forceinline__ void fma8(float w, const uint4& raw,
                                     float (&a)[8]) {
  float v[8];
  widen8(raw, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = fmaf(w, v[k], a[k]);
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K8 in bf16 storage. grid (ceil(F_out / kDown16F), T_out, B): block (j,
// t2) writes output f2 [j kDown16F, (j + 1) kDown16F) of row t2 of a batch
// row, every channel. x packed (B, T_in, F_in*C), out (B, C, T_out,
// F_out), both bf16; the map float32 (ts/tw (T_out, NT), fs/fw (F_out,
// NF)), read through the read-only cache, no staging. A thread forms
// chunk (f2, 8 channels): the map's terms, then every one of its NT x NF
// 16-byte loads (NT, NF template arguments) before the sums, F side then
// T side in float32 as the float32 kernel sums them; the (kDown16F, CS)
// float32 tile turns the sums round, and each channel's run of f2 leaves
// as 16-byte chunks, rounded once.
template <int kNT, int kNF>
__global__ void __launch_bounds__(kDown16Threads, kDown16Blocks)
spatial_down_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         __nv_bfloat16* __restrict__ out,
                         const int* __restrict__ ts,
                         const float* __restrict__ tw,
                         const int* __restrict__ fs,
                         const float* __restrict__ fw, int T_in, int F_in,
                         int C, int T_out, int F_out, int nt, int nf,
                         int vec_in, int vec_out) {
  const int NT = kNT > 0 ? kNT : nt, NF = kNF > 0 ? kNF : nf;
  const int CS = round_up(C, 8) + kMap16Pad, CQ = (C + 7) >> 3;
  const int j = blockIdx.x, t2 = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int f0 = j * kDown16F, nfb = min(kDown16F, F_out - f0);
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int* tsr = ts + (long long)t2 * NT;
  const float* twr = tw + (long long)t2 * NT;
  bool any = false;
  for (int i = 0; i < NT; ++i) any |= __ldg(twr + i) != 0.f;

  // in: chunk (f2, q) = channels 8q.. of output f2; neighbouring threads on
  // neighbouring chunks (a 128-byte f block of 64 channels a quarter warp)
  if (any) {
    const __nv_bfloat16* xb = x + (long long)b * T_in * F_in * C;
    for (int e = tid; e < nfb * CQ; e += kDown16Threads) {
      const int fl = e / CQ, q = e - fl * CQ, f2 = f0 + fl;
      const __nv_bfloat16* xq = xb + 8 * q;
      const int* fsr = fs + (long long)f2 * NF;
      const float* fwr = fw + (long long)f2 * NF;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if constexpr (kNT > 0) {
        float wt[kNT], wf[kNF];
        int tr[kNT], fc[kNF];
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          wt[i] = __ldg(twr + i);
          tr[i] = __ldg(tsr + i);
        }
#pragma unroll
        for (int u = 0; u < kNF; ++u) {
          wf[u] = __ldg(fwr + u);
          fc[u] = __ldg(fsr + u);
        }
        uint4 raw[kNT][kNF];
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int u = 0; u < kNF; ++u)
            raw[i][u] = wt[i] != 0.f && wf[u] != 0.f
                            ? load8(xq + ((long long)tr[i] * F_in + fc[u]) * C,
                                    C - 8 * q, vec_in)
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (wt[i] == 0.f) continue;
          float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int u = 0; u < kNF; ++u)
            if (wf[u] != 0.f) fma8(wf[u], raw[i][u], s);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(wt[i], s[k], acc[k]);
        }
      } else {
        for (int i = 0; i < NT; ++i) {
          const float wt = __ldg(twr + i);
          if (wt == 0.f) continue;
          const __nv_bfloat16* row = xq + (long long)__ldg(tsr + i) * F_in * C;
          float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int u = 0; u < NF; ++u) {
            const float wf = __ldg(fwr + u);
            if (wf != 0.f)
              fma8(wf, load8(row + (long long)__ldg(fsr + u) * C, C - 8 * q,
                             vec_in),
                   s);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(wt, s[k], acc[k]);
        }
      }
      float4* d = reinterpret_cast<float4*>(tile + fl * CS + 8 * q);
      d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();

  // out: chunk (c, p) = f2 f0 + 8p.. of channel c; neighbouring threads on
  // the chunks of one channel, then on neighbouring channels (kDown16F 16:
  // a channel's 32 contiguous bytes a thread pair)
  const int P8 = (nfb + 7) >> 3;
  for (int e = tid; e < C * P8; e += kDown16Threads) {
    const int c = e / P8, p = e - c * P8;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = any ? tile[(8 * p + k) * CS + c] : 0.f;
    store8(out + (((long long)b * C + c) * T_out + t2) * F_out + f0 + 8 * p,
           v, nfb - 8 * p, vec_out);
  }
}

// K9 in bf16 storage. grid (nF, G, B): block (j, g) writes output f [j fb,
// j fb + fb) of the rows [rows[g], rows[g+1]) of a batch row, which share
// their T terms: rts/rtw (G, NT), those of the run's first row. x (B, C,
// T_in, F_in), out packed (B, T_out, F_out*C), both bf16; the map and the
// plan read through the read-only cache, no staging before the loads. fr
// (nF, 2): the block stages input f [8 fr[j][0], 8 (fr[j][0] + fr[j][1])),
// the 16-byte chunks that hold every source of its f (fr[j][1] 0: none).
// Shared memory: the block's F terms fw/fs (fb, NF), then the
// (tile_rows, CS) float32 tile of the T-combined input, channels fastest.
// A thread stages chunk (c, p) of 8 f of a channel (the run's NT 16-byte
// loads before their sums, a warp 16 channels x 2 chunks: 32 contiguous
// bytes of each of 16 rows; the tile's scalar stores at most two to a
// bank), then forms chunk (f, 8 channels) through the F side and stores it
// to every row of the run: neighbouring threads on neighbouring chunks,
// 16 bytes each.
template <int kNT, int kNF>
__global__ void __launch_bounds__(kUp16Threads, kUp16Blocks)
spatial_up_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ rts,
                       const float* __restrict__ rtw,
                       const int* __restrict__ fs,
                       const float* __restrict__ fw,
                       const int* __restrict__ rows,
                       const int* __restrict__ fr, int T_in, int F_in, int C,
                       int T_out, int F_out, int nt, int nf, int fb,
                       int vec_in, int vec_out) {
  const int NT = kNT > 0 ? kNT : nt, NF = kNF > 0 ? kNF : nf;
  const int CS = round_up(C, 8) + kMap16Pad, CQ = (C + 7) >> 3;
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int f0 = j * fb, nfb = min(fb, F_out - f0);
  const int t0 = __ldg(rows + g), t1 = __ldg(rows + g + 1);
  const int lo = __ldg(fr + 2 * j), n8 = __ldg(fr + 2 * j + 1);
  const int* tsr = rts + (long long)g * NT;
  const float* twr = rtw + (long long)g * NT;
  extern __shared__ float4 smem4[];
  float* fw_s = reinterpret_cast<float*>(smem4);
  int* fs_s = reinterpret_cast<int*>(fw_s + fb * NF);
  float* tile = fw_s + round_up(2 * fb * NF, 4);
  bool any = false;
  for (int i = 0; i < NT; ++i) any |= __ldg(twr + i) != 0.f;
  const bool staged = any && n8 > 0;

  if (staged) {
    // in: chunk (c, p) = f 8 (lo + p).. of channel c, summed over the T
    // terms in float32 as the float32 kernel sums them
    const long long plane = (long long)T_in * F_in;
    const __nv_bfloat16* xb = x + (long long)b * C * plane;
    const int cg = (C + 15) >> 4;
    const int n_in = 32 * cg * ((n8 + 1) >> 1);
    // kU items a thread at once, their loads issued before their sums
    constexpr int kU = kNT > 1 ? kUp16Items / 2 : kUp16Items;
    for (int e0 = tid; e0 < n_in; e0 += kU * kUp16Threads) {
      int c[kU], f8[kU];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kUp16Threads, lane = e & 31, grp = e >> 5;
        c[u] = (grp % cg) * 16 + (lane >> 1);
        const int p = (grp / cg) * 2 + (lane & 1);
        ok[u] = e < n_in && c[u] < C && p < n8;
        f8[u] = 8 * (lo + p);
      }
      uint4 raw[kU][kNT > 0 ? kNT : 1];
      if constexpr (kNT > 0) {
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const float wt = __ldg(twr + i);
          const long long row = (long long)__ldg(tsr + i) * F_in;
#pragma unroll
          for (int u = 0; u < kU; ++u)
            raw[u][i] = ok[u] && wt != 0.f
                            ? load8(xb + c[u] * plane + row + f8[u],
                                    F_in - f8[u], vec_in)
                            : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!ok[u]) continue;
        const __nv_bfloat16* xc = xb + c[u] * plane + f8[u];
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if constexpr (kNT > 0) {
#pragma unroll
          for (int i = 0; i < kNT; ++i) {
            const float wt = __ldg(twr + i);
            if (wt != 0.f) fma8(wt, raw[u][i], acc);
          }
        } else {
          for (int i = 0; i < NT; ++i) {
            const float wt = __ldg(twr + i);
            if (wt != 0.f)
              fma8(wt, load8(xc + (long long)__ldg(tsr + i) * F_in,
                             F_in - f8[u], vec_in),
                   acc);
          }
        }
        float* d = tile + (f8[u] - 8 * lo) * CS + c[u];
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k * CS] = acc[k];
      }
    }
    // the block's F terms, each source as its row of the tile
    for (int e = tid; e < nfb * NF; e += kUp16Threads) {
      fw_s[e] = __ldg(fw + (long long)f0 * NF + e);
      fs_s[e] = __ldg(fs + (long long)f0 * NF + e) - 8 * lo;
    }
  }
  __syncthreads();

  // out: chunk (f, q) = channels 8q.. of f. Each source's term rounded to
  // bf16 and the terms added in bf16, in order, as JAX's K8 VJP sums one
  // single-source pass a source of a transposed map, each in the
  // cotangent's dtype (_spatial_down_bwd); with one source (every forward
  // map) that is the single rounding of the float32 sum.
  const long long row_len = (long long)F_out * C;
  __nv_bfloat16* ob =
      out + ((long long)b * T_out + t0) * row_len + (long long)f0 * C;
  for (int e = tid; e < nfb * CQ; e += kUp16Threads) {
    const int fl = e / CQ, q = e - fl * CQ;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (staged)
#pragma unroll
      for (int u = 0; u < NF; ++u) {
        const float wf = fw_s[fl * NF + u];
        if (wf == 0.f) continue;
        const float4* v4 = reinterpret_cast<const float4*>(
            tile + fs_s[fl * NF + u] * CS + 8 * q);
        const float4 a = v4[0], c4 = v4[1];
        const float v[8] = {a.x, a.y, a.z, a.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = rbf(s[k] + rbf(wf * v[k]));
      }
    __nv_bfloat16* o = ob + (long long)fl * C + 8 * q;
    for (int t = t0; t < t1; ++t, o += row_len)
      store8(o, s, C - 8 * q, vec_out);
  }
}

// K5's and K5-wgrad's ring chunk of 4 channels: a float4, or 4 bf16 in 8
// bytes, widened as it is read
template <typename E>
struct DwChunk;
template <>
struct DwChunk<float> {
  using T = float4;
};
template <>
struct DwChunk<__nv_bfloat16> {
  using T = uint2;
};

// a chunk of 4 channels from src into the ring slot dst, zero-filled
// when !ok: one 16-byte cp.async (float) or 8-byte (bf16)
__device__ __forceinline__ void cp_chunk(float4* dst, const float* src,
                                         bool ok) {
  hk::cp_async16(dst, src, ok);
}
__device__ __forceinline__ void cp_chunk(uint2* dst, const __nv_bfloat16* src,
                                         bool ok) {
  hk::cp_async8(dst, src, ok);
}

// the first n (0-4) values of a chunk at src into dst, the rest zero:
// 4-byte cp.async a value for float; plain loads and stores for bf16
// (cp.async has no 2-byte copy), done when it returns
__device__ __forceinline__ void cp_chunk_n(float4* dst, const float* src,
                                           int n) {
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) hk::cp_async4(d + k, k < n ? src + k : src, k < n);
}
__device__ __forceinline__ void cp_chunk_n(uint2* dst,
                                           const __nv_bfloat16* src, int n) {
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  const unsigned short* v = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = k < n ? v[k] : (unsigned short)0;
}

// K5-wgrad's shared floats: the ring of kt + 2 x rows of FT + 4 G - 1
// positions and 3 g rows of FT positions, 4 QB channels a position, or the
// end's exchange of every thread's 16 sums where that is more
// (ops/packed_tf.dw_wgrad_geometry)
__host__ __device__ __forceinline__ int wgrad_smem_floats(int KT, int KF,
                                                          int QB, int S,
                                                          int P) {
  const int G = (KF + kWgTaps - 1) / kWgTaps, FT = S * P;
  const int ring = ((KT + 2) * (FT + kWgTaps * G - 1) + 3 * FT) * 4 * QB;
  return max(ring, QB * G * KT * S * 16);
}

// K5-wgrad's shared bytes in bf16 storage: the ring's chunks 4 bf16 (8
// bytes), or the end's exchange of 16 float32 sums a thread
__host__ __device__ __forceinline__ int wgrad_smem_bytes_bf16(int KT, int KF,
                                                              int QB, int S,
                                                              int P) {
  const int G = (KF + kWgTaps - 1) / kWgTaps, FT = S * P;
  const int ring = ((KT + 2) * (FT + kWgTaps * G - 1) + 3 * FT) * QB;
  return max(8 * ring, 4 * QB * G * KT * S * 16);
}

// float4 a += g * w, channel by channel
__device__ __forceinline__ void fma4v(float4 g, float4 w, float4& a) {
  a.x = fmaf(g.x, w.x, a.x);
  a.y = fmaf(g.y, w.y, a.y);
  a.z = fmaf(g.z, w.z, a.z);
  a.w = fmaf(g.w, w.w, a.w);
}

// grid (runs, ceil(F_out / FT), ceil(ceil(C / 4) / QB)), QB * G * KT * S
// threads (G = ceil(KF / kWgTaps) tap groups, FT = S * P positions a
// tile), KT_ / KF_ the kernel's taps or 0 (runtime KT, KF). x packed
// (B, T_in, F_in*C), g packed (B, T_out, F_out*C); block (x, y, z) writes
// its sums for the channels of its z to row y * gridDim.x + x of partial
// (KT, KF, C).
//
// Block (x, y, z) owns the output rows [x R / runs, (x + 1) R / runs) of
// the R = B * T_out rows in (b, t) order, the f tile y and the channel
// block z (4 QB channels). Thread (quad, group, dt, seg), quad fastest,
// owns channels 4 quad .. + 3 of the block, tap row dt and the taps df =
// kWgTaps group .. + kWgTaps - 1 (those below KF), and positions seg * P
// .. + P - 1 of the tile: 4 x kWgTaps sums in registers. A row's step
// streams the x row the step adds and the g row through a cp.async ring
// of 16-byte copies (4-byte ones where C % 4 != 0 or a pointer is not
// 16-byte aligned), zero past the map and past C: kt + 2 x rows and 3 g
// rows, the copies of the next step in flight while the threads walk
// this one. A thread walks its positions with a window of kWgTaps x
// values in registers (one 16-byte load of x and one of g a position for
// 4 kWgTaps FMAs). Rows of another batch row start the ring again. At
// the end the segments' sums meet in shared memory and the seg-0 threads
// add them in order: every partial is summed in one fixed order.
template <int KT_, int KF_, typename E = float>
__global__ void __launch_bounds__(KT_ ? kWgThreads : kWgMaxThreads)
dw_wgrad_kernel(const E* __restrict__ x, const E* __restrict__ g,
                float* __restrict__ partial, int B, int T_in, int F_in,
                int C, int T_out, int F_out, int KT, int KF, int pt_lo,
                int pf_lo, int QB, int S, int P, int vec) {
  extern __shared__ float4 smem4[];
  using Chunk = typename DwChunk<E>::T;
  const int kt = KT_ ? KT_ : KT, kf = KF_ ? KF_ : KF;
  const int G = (kf + kWgTaps - 1) / kWgTaps, NX = kt + 2;
  const int FT = S * P, XW = FT + kWgTaps * G - 1;
  Chunk* xs = reinterpret_cast<Chunk*>(smem4);  // NX x rows of (XW, QB)
  Chunk* gs = xs + NX * XW * QB;                // 3 g rows of (FT, QB)
  const int tid = threadIdx.x, quad = tid % QB;
  const int grp = tid / QB % G, dt = tid / (QB * G) % kt;
  const int seg = tid / (QB * G * kt);
  const int f0 = blockIdx.y * FT, c0 = blockIdx.z * 4 * QB;
  const long long rows = (long long)B * T_out;
  long long r = rows * blockIdx.x / gridDim.x;
  const long long r_end = rows * (blockIdx.x + 1) / gridDim.x;

  // one row of (positions, QB quads) from the packed row src (f of the
  // slot's position 0 at f_lo, f_max positions in the map; ok false for a
  // row off the map) into dst, zero off the map and past C
  auto stage = [&](Chunk* dst, const E* src, int f_lo, int f_max,
                   int positions, bool ok) {
    for (int e = tid; e < positions * QB; e += blockDim.x) {
      const int p = e / QB, q = e - p * QB, f = f_lo + p, c = c0 + 4 * q;
      const bool in = ok && f >= 0 && f < f_max && c < C;
      const E* s = src + (long long)f * C + c;
      if (vec)
        cp_chunk(dst + e, in ? s : x, in);
      else
        cp_chunk_n(dst + e, in ? s : x, in ? min(4, C - c) : 0);
    }
  };

  float4 acc[kWgTaps];
#pragma unroll
  for (int j = 0; j < kWgTaps; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  while (r < r_end) {  // a run of rows of one batch row
    const int b = (int)(r / T_out), t_lo = (int)(r - (long long)b * T_out);
    const int n = (int)min(r_end - r, (long long)(T_out - t_lo));
    r += n;
    const E* xb = x + (long long)b * T_in * F_in * C;
    const E* gb = g + (long long)b * T_out * F_out * C;
    // step i's group: x rows j = 0 .. kt-1 (i = 0) or j = i + kt - 1 (the
    // input row t_lo - pt_lo + j, slot j % NX), and g row t_lo + i (slot
    // i % 3); empty past the run
    auto issue = [&](int i) {
      if (i < n) {
        for (int j = i ? i + kt - 1 : 0; j < i + kt; ++j) {
          const int t = t_lo - pt_lo + j;
          const bool ok = t >= 0 && t < T_in;
          stage(xs + (j % NX) * XW * QB, xb + (long long)(ok ? t : 0) * F_in * C,
                f0 - pf_lo, F_in, XW, ok);
        }
        stage(gs + (i % 3) * FT * QB, gb + (long long)(t_lo + i) * F_out * C,
              f0, F_out, FT, true);
      }
      hk::cp_async_commit();
    };
    issue(0);
    issue(1);
    for (int i = 0; i < n; ++i) {
      hk::cp_async_wait<1>();
      __syncthreads();  // step i is in; every thread is done with step
                        // i - 1, whose slots step i + 2 takes
      issue(i + 2);
      const Chunk* xr =
          xs + ((i + dt) % NX) * XW * QB + (seg * P + kWgTaps * grp) * QB + quad;
      const Chunk* gr = gs + (i % 3) * FT * QB + seg * P * QB + quad;
      float4 w[kWgTaps];
#pragma unroll
      for (int j = 0; j < kWgTaps - 1; ++j) w[j] = widen(xr[j * QB]);
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        w[kWgTaps - 1] = widen(xr[(p + kWgTaps - 1) * QB]);
        const float4 gv = widen(gr[p * QB]);
#pragma unroll
        for (int j = 0; j < kWgTaps; ++j) fma4v(gv, w[j], acc[j]);
#pragma unroll
        for (int j = 0; j < kWgTaps - 1; ++j) w[j] = w[j + 1];
      }
    }
    hk::cp_async_wait_all();
    __syncthreads();  // the ring is free for the next run
  }

  // the segments' sums, added in order by the seg-0 threads
  const int units = QB * G * kt;
#pragma unroll
  for (int j = 0; j < kWgTaps; ++j) smem4[tid * kWgTaps + j] = acc[j];
  __syncthreads();
  if (seg != 0) return;
  float* pr = partial + (long long)(blockIdx.y * gridDim.x + blockIdx.x) *
                            kt * kf * C;
#pragma unroll
  for (int j = 0; j < kWgTaps; ++j) {
    float4 s = smem4[tid * kWgTaps + j];
    for (int sg = 1; sg < S; ++sg) {
      const float4 v = smem4[(sg * units + tid) * kWgTaps + j];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    const int df = kWgTaps * grp + j, c = c0 + 4 * quad;
    if (df >= kf) continue;
    float* o = pr + (long long)(dt * kf + df) * C + c;
    if (c < C) o[0] = s.x;
    if (c + 1 < C) o[1] = s.y;
    if (c + 2 < C) o[2] = s.z;
    if (c + 3 < C) o[3] = s.w;
  }
}

// K5's shared floats: the (kT kF, QB) taps, then the ring of NR input rows
// of FT + kF - 1 positions, 4 QB floats a position; NR = kDwAhead + 1
// where the taps are template arguments (a step reads its own row),
// kDwAhead + kT otherwise (a step reads the kT rows of its output row)
// (ops/packed_tf.dw_conv_geometry)
__host__ __device__ __forceinline__ int dw_smem_floats(int KT, int KF, int QB,
                                                       int FT, bool fixed) {
  const int nr = kDwAhead + (fixed ? 1 : KT);
  return (KT * KF + nr * (FT + KF - 1)) * 4 * QB;
}

// K5's shared bytes in bf16 storage: the taps widened to float32 as
// above, the ring's chunks 4 bf16 (8 bytes)
__host__ __device__ __forceinline__ int dw_smem_bytes_bf16(int KT, int KF,
                                                           int QB, int FT,
                                                           bool fixed) {
  const int nr = kDwAhead + (fixed ? 1 : KT);
  return 16 * KT * KF * QB + 8 * nr * (FT + KF - 1) * QB;
}

// grid (runs, ceil(F_out / FT), B * blocks_c), block (QB, FT), KT_ / KF_
// the taps or 0 (runtime KT, KF). x packed (B, T_in, F_in*C), w (KT, KF,
// C) through its strides, bias (C) or null, out packed (B, T_out,
// F_out*C); vec: C % 4 == 0 and x, out 16-byte aligned.
//
// Block (x, y, z) owns the output rows [x T_out / runs, (x + 1) T_out /
// runs) of batch row b = z / blocks_c, the f tile y (FT positions from f0
// = y FT) and channel block z % blocks_c (4 QB channels). Thread (quad, p)
// owns channels c = c0 + 4 quad .. + 3 at f = f0 + p, one 16-byte chunk.
// Step i takes input row r = t_lo - pt_lo + i, one of the n + kT - 1 rows
// the block's n output rows read: its FT + kF - 1 positions (zero off the
// map and past C) come through a cp.async ring of NR slots, the copies of
// the next kDwAhead rows in flight while the threads take this one; each
// thread copies its own quad at positions p, p + FT, .. of the row.
// With the taps as template arguments (the presets' 4 x 4) the thread
// keeps its kT x kF tap chunks and kT accumulators in registers, acc[j]
// the output row r + pt_lo - kT + 1 + j: each of the row's kF chunks, one
// 16-byte shared read, feeds kT products (tap row kT - 1 - j into acc[j]);
// then acc[0]'s row has all its rows and is stored, and the accumulators
// shift. Otherwise the thread forms an output row whole at the step that
// brings its last input row, from the kT rows in the ring and the taps in
// shared memory. Either way an output is bias + its sum over dt, then df,
// in that order, and is written by one thread: two calls give the same
// bits. No division in a loop: the layout is 2-D and the ring's slots go
// round by counters.
//
// E bf16 (bf16 storage: x, w, bias and out bf16): the ring holds the bf16
// chunks (8-byte copies; 4-channel chunks stay 8-byte aligned where C % 4
// == 0), each widened to float32 as it is read; the taps and the bias are
// widened once; the sums are float32 and each output is rounded once as
// it is stored, as the TPU kernel widens its bf16 window and weight
// vectors into a float32 accumulator. Where the chunks go as scalars (C %
// 4 != 0), the bf16 copies are plain loads (no 2-byte cp.async), stored
// to the ring between the same barriers as the asynchronous copies.
template <int KT_, int KF_, typename E>
__global__ void __launch_bounds__(kDwThreads, 2)
dw_conv_packed_kernel(const E* __restrict__ x, const E* __restrict__ w,
                      const E* __restrict__ bias, E* __restrict__ out,
                      int T_in, int F_in, int C, int T_out, int F_out, int KT,
                      int KF, int pt_lo, int pf_lo, int ws0, int ws1, int ws2,
                      int blocks_c, int vec) {
  constexpr bool kFixed = KT_ > 0;
  const int kt = kFixed ? KT_ : KT, kf = kFixed ? KF_ : KF;
  extern __shared__ float4 smem4[];
  const int QB = blockDim.x, FT = blockDim.y;
  const int quad = threadIdx.x, p = threadIdx.y;
  const int XW = FT + kf - 1, NR = kDwAhead + (kFixed ? 1 : kt);
  using Chunk = typename DwChunk<E>::T;
  float4* w_s = smem4;  // (kt kf, QB) taps
  Chunk* ring = reinterpret_cast<Chunk*>(w_s + kt * kf * QB);  // NR rows of
                                                               // (XW, QB)
  const int b = blockIdx.z / blocks_c;
  const int c = (blockIdx.z - b * blocks_c) * 4 * QB + 4 * quad;
  const int f0 = blockIdx.y * FT, f = f0 + p;
  const int t_lo = (int)((long long)T_out * blockIdx.x / gridDim.x);
  const int t_hi = (int)((long long)T_out * (blockIdx.x + 1) / gridDim.x);
  const int steps = t_hi - t_lo + kt - 1;
  const E* xb = x + (long long)b * T_in * F_in * C;

  // the taps of the block's channels: thread (quad, p) stages taps p, p +
  // FT, .. of its quad ((dt, df) stepped along, no division in the loop)
  {
    int dt = p / kf, df = p - dt * kf;
    const int step_t = FT / kf, step_f = FT - step_t * kf;
    for (int tap = p; tap < kt * kf; tap += FT) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = c + k < C ? to_f(w[(long long)dt * ws0 + (long long)df * ws1 +
                                  (long long)(c + k) * ws2])
                         : 0.f;
      w_s[tap * QB + quad] = make_float4(v[0], v[1], v[2], v[3]);
      dt += step_t;
      df += step_f;
      if (df >= kf) {
        df -= kf;
        ++dt;
      }
    }
  }
  // input row t_lo - pt_lo + i into slot `slot`, one commit group (empty
  // past the run's last row)
  auto issue = [&](int i, int slot) {
    if (i < steps) {
      const int r = t_lo - pt_lo + i;
      const bool row_ok = r >= 0 && r < T_in;
      const E* src = xb + (long long)(row_ok ? r : 0) * F_in * C + c;
      Chunk* dst = ring + (slot * XW + p) * QB + quad;
      for (int pp = p, fi = f0 - pf_lo + p; pp < XW;
           pp += FT, fi += FT, dst += FT * QB) {
        const bool ok = row_ok && fi >= 0 && fi < F_in && c < C;
        const E* s = src + (long long)fi * C;
        if (vec)
          cp_chunk(dst, ok ? s : x, ok);
        else
          cp_chunk_n(dst, ok ? s : x, ok ? min(4, C - c) : 0);
      }
    }
    hk::cp_async_commit();
  };

  const bool live = f < F_out && c < C;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr && live)
    bv = make_float4(to_f(bias[c]), c + 1 < C ? to_f(bias[c + 1]) : 0.f,
                     c + 2 < C ? to_f(bias[c + 2]) : 0.f,
                     c + 3 < C ? to_f(bias[c + 3]) : 0.f);
  E* o = out + (((long long)b * T_out + t_lo) * F_out + f) * C + c;
  const long long o_row = (long long)F_out * C;
  // output row t_lo + i - (kt - 1) of the thread's chunk
  auto store = [&](float4 a, int i) {
    if (!live) return;
    if (bias != nullptr)
      a = make_float4(a.x + bv.x, a.y + bv.y, a.z + bv.z, a.w + bv.w);
    store_chunk(o + (long long)(i - (kt - 1)) * o_row, a, C - c, vec);
  };

  __syncthreads();  // the taps are in
  float4 wr[kFixed ? KT_ : 1][kFixed ? KF_ : 1];
  float4 acc[kFixed ? KT_ : 1];
  if constexpr (kFixed) {
#pragma unroll
    for (int dt = 0; dt < KT_; ++dt) {
#pragma unroll
      for (int df = 0; df < KF_; ++df) wr[dt][df] = w_s[(dt * KF_ + df) * QB + quad];
      acc[dt] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  int ld = 0;  // the slot of the next row issued
  for (int i = 0; i < kDwAhead; ++i) {
    issue(i, ld);
    if (++ld == NR) ld = 0;
  }
  int rd = 0;  // the slot of step i's row
  for (int i = 0; i < steps; ++i) {
    hk::cp_async_wait<kDwAhead - 1>();
    __syncthreads();  // row i is in; every thread is done with the slot
                      // that row i + kDwAhead takes
    issue(i + kDwAhead, ld);
    if (++ld == NR) ld = 0;
    const Chunk* xr = ring + (rd * XW + p) * QB + quad;
    if constexpr (kFixed) {
#pragma unroll
      for (int df = 0; df < KF_; ++df) {
        const float4 v = widen(xr[df * QB]);
#pragma unroll
        for (int j = 0; j < KT_; ++j) fma4v(v, wr[KT_ - 1 - j][df], acc[j]);
      }
      if (i >= KT_ - 1) store(acc[0], i);
#pragma unroll
      for (int j = 0; j < KT_ - 1; ++j) acc[j] = acc[j + 1];
      acc[KT_ - 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (i >= kt - 1) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      int slot = rd - (kt - 1);
      if (slot < 0) slot += NR;
      const float4* wq = w_s + quad;
      for (int dt = 0; dt < kt; ++dt) {
        const Chunk* xq = ring + (slot * XW + p) * QB + quad;
        for (int df = 0; df < kf; ++df, wq += QB)
          fma4v(widen(xq[df * QB]), *wq, a);
        if (++slot == NR) slot = 0;
      }
      store(a, i);
    }
    if (++rd == NR) rd = 0;
  }
  hk::cp_async_wait_all();
}

// pw-wgrad's shared floats: the ring of kPwStages stages of kPwRows
// planar rows and kPwK packed positions; the (kPwRows, kPwOS) output tile
// reuses it (ops/packed_tf.pw_wgrad_smem)
__host__ __device__ __forceinline__ int pw_wgrad_smem_floats() {
  const int ring = kPwStages * (kPwRows * kPwPS + kPwK * kPwQS);
  const int tile = kPwRows * kPwOS;
  return ring > tile ? ring : tile;
}

// The staged row of a tile's planar channel r (0 <= r < kPwRows): a block
// of 64 channels holds its 16 channels of class r % 4 in 16 consecutive
// rows, so the m16 tile t takes the channels 64 (t / 4) + 4 i + t % 4,
// i < 16, one class, whose rows start at one offset in their 16-byte blocks
__host__ __device__ __forceinline__ int pw_staged_row(int r) {
  return (r & ~63) | ((r & 3) << 4) | ((r & 63) >> 2);
}

// pw-wgrad's epilogue, in a block of kPwThreads threads as the kernels
// lay their warps out (warp (wm, wn), lane (g, q)): each lane's float32
// sums acc, its D fragments of m16 tiles 2 wm, 2 wm + 1 and n8 tiles 4 wn
// .. 4 wn + 3, through the output tile o_s (kPwRows, kPwOS) in shared
// memory (in the ring's place: it waits for every warp's last stage), to
// the block's rows of partial row (blockIdx.z, blockIdx.x), a row of 64
// packed channels, or of the planar channels where transposed, at a time.
// D c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1) of m16
// tile t, n8 tile nj are planar channel 64 (t / 4) + 4 g + t % 4 (+ 32),
// packed channel 32 wn + 8 nj + 2 q (+ 1).
__device__ __forceinline__ void pw_wgrad_store(const float (&acc)[2][4][4],
                                               float* o_s, float* partial,
                                               int Cp, int Cq, int cp0,
                                               int cq0, int transposed) {
  constexpr int kWarpsM = kPwRows / 32;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = hk::lane_g(), qq = hk::lane_q();
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int t = 2 * wm + mi;
      float* o = o_s + (64 * (t >> 2) + 4 * g + (t & 3)) * kPwOS + 32 * wn +
                 8 * nj + 2 * qq;
      o[0] = acc[mi][nj][0];
      o[1] = acc[mi][nj][1];
      o[32 * kPwOS] = acc[mi][nj][2];
      o[32 * kPwOS + 1] = acc[mi][nj][3];
    }
  __syncthreads();
  // the tile to its partial row, in the partial's order
  float* part = partial + ((long long)blockIdx.z * gridDim.x + blockIdx.x) *
                              ((long long)Cp * Cq);
  const int rows = min(kPwRows, Cp - cp0), cols = min(kPwCols, Cq - cq0);
  if (!transposed) {
    for (int e = tid; e < kPwRows * kPwCols; e += kPwThreads) {
      const int r = e / kPwCols, c = e % kPwCols;
      if (r < rows && c < cols)
        part[(long long)(cp0 + r) * Cq + cq0 + c] = o_s[r * kPwOS + c];
    }
  } else {
    for (int e = tid; e < kPwRows * kPwCols; e += kPwThreads) {
      const int c = e / kPwRows, r = e % kPwRows;
      if (r < rows && c < cols)
        part[(long long)(cq0 + c) * Cp + cp0 + r] = o_s[r * kPwOS + c];
    }
  }
}

// grid (chunks, tiles_p * tiles_q, B), kPwThreads threads, one block an
// SM. p (B, Cp, M) channel-planar, q (B, M, Cq) channel-innermost;
// partial (B * chunks, Cp * Cq), each row dW (Cp, Cq) of one chunk, or
// its transpose (Cq, Cp) where transposed (K7's dW: Ca is the packed
// side); vec: Cq % 4 == 0 and q 16-byte aligned. Block (x, y, b) sums the
// positions [x L, min(M, (x + 1) L)) of batch row b (L a multiple of kPwK)
// into tile y = (planar tile, packed tile) of partial row b chunks + x.
//
// Its stages (kPwK positions each, the last ragged) run through a ring of
// kPwStages slots: iteration s waits for stage s, issues stage s +
// kPwStages - 1 into the slot iteration s - 1 read, then multiplies stage
// s. A planar channel's staged row holds its kPwK positions from column
// sh, sh its first position's offset in a 16-byte block of p, the same
// for every stage (L and kPwK are multiples of 4) and for channels 4
// apart (4 M is a multiple of 4): thread r < kPwRows copies row r (a warp
// copies a block of 32 rows at once), the whole blocks as one 16-byte
// copy, the two that reach past the stage's window element by element,
// positions past the chunk as zeros. Positions past the chunk
// are zeros on the packed side too, so they add nothing; channels past Cp
// or Cq are not copied and only reach outputs that are not written.
//
// Warp (wm, wn) multiplies m16 tiles 2 wm, 2 wm + 1 (32 planar channels)
// by n8 tiles 4 wn .. 4 wn + 3 (32 packed channels) in 3xTF32, the big
// products apart, and adds them to the float32 sum every kPwFlush stages
// and at the last; each output is summed by one lane in one fixed order.
// The sum plus the cross terms goes through the output tile in shared
// memory (rows in channel order, in the ring's place) to the partial, a
// row of 64 packed channels, or of the planar channels where transposed,
// at a time.
__global__ void __launch_bounds__(kPwThreads, 1)
pw_wgrad_kernel(const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ partial, int M, int Cp, int Cq, int L,
                int transposed, int vec) {
  constexpr int kPStage = kPwRows * kPwPS;
  constexpr int kStage = kPStage + kPwK * kPwQS;
  constexpr int kBlocks = kPwK / 4 + 1;  // 16-byte blocks a planar row
  constexpr int kWarpsM = kPwRows / 32;
  static_assert(kPwK % 32 == 0 && kPwRows % 64 == 0 && kPwCols == 64,
                "the bank layouts and the warp grid");
  static_assert(kPwThreads == kWarpsM * 2 * 32, "a warp a 32 x 32 tile");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* o_s = ring;  // the output tile, after the last stage
  const int tid = threadIdx.x, b = blockIdx.z;
  const int tiles_q = (Cq + kPwCols - 1) / kPwCols;
  const int cp0 = (int)blockIdx.y / tiles_q * kPwRows;
  const int cq0 = (int)blockIdx.y % tiles_q * kPwCols;
  const int p_begin = (int)blockIdx.x * L;
  const int p_end = min(M, p_begin + L);
  const int ns = (p_end - p_begin + kPwK - 1) / kPwK;
  // the offset of a planar row of class c in its 16-byte blocks: p's
  // float index mod 4 with the row's start and the chunk's first position
  const uint32_t p4 = (uint32_t)(reinterpret_cast<uintptr_t>(p) >> 2);
  auto shift = [&](int c) {
    return (int)((p4 + ((uint32_t)b * (uint32_t)Cp + (uint32_t)(cp0 + c)) *
                           (uint32_t)M +
                  (uint32_t)p_begin) &
                 3u);
  };

  // the thread's planar row: channel cp0 + tid, for tid < kPwRows
  const bool copies = tid < kPwRows && cp0 + tid < Cp;
  const int c_sh = shift(tid & 3);
  const float* c_row = p + ((long long)b * Cp + cp0 + tid) * M;
  auto load_stage = [&](int s, int slot) {
    if (s < ns) {
      const int p0 = p_begin + s * kPwK, avail = p_end - p0;
      float* ps = ring + slot * kStage;
      float* qs = ps + kPStage;
      if (copies) {
        float* dst = ps + pw_staged_row(tid) * kPwPS;
        const float* src = c_row + p0 - c_sh;  // block j at src + 4 j
#pragma unroll
        for (int j = 0; j < kBlocks; ++j) {
          const int lo = 4 * j - c_sh;  // its first position - p0
          if (lo + 4 <= 0 || lo >= kPwK) continue;
          if (lo >= 0 && lo + 4 <= kPwK && lo + 4 <= avail) {
            hk::cp_async16(dst + 4 * j, src + 4 * j, true);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (lo + e < 0 || lo + e >= kPwK) continue;
              const bool ok = lo + e < avail;
              hk::cp_async4(dst + 4 * j + e, ok ? src + 4 * j + e : p, ok);
            }
          }
        }
      }
      // the packed positions p0 .., 16-byte chunks of kPwCols channels
      for (int e = tid; e < kPwK * kPwCols / 4; e += kPwThreads) {
        const int pp = e / (kPwCols / 4), c = 4 * (e % (kPwCols / 4));
        float* d = qs + pp * kPwQS + c;
        const bool in = pp < avail;
        const float* src = q + ((long long)b * M + p0 + pp) * Cq + cq0 + c;
        if (vec) {
          const bool ok = in && cq0 + c < Cq;
          hk::cp_async16(d, ok ? src : q, ok);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool ok = in && cq0 + c + k < Cq;
            hk::cp_async4(d + k, ok ? src + k : q, ok);
          }
        }
      }
    }
    hk::cp_async_commit();
  };
  for (int s = 0; s < kPwStages - 1; ++s) load_stage(s, s);

  // the lane's A fragment elements: staged rows 16 t + g (+ 8), columns
  // q (+ 4) of its tile's class shift; B fragment elements: packed
  // positions q (+ 4), channels 32 wn + 8 nj + g
  const int warp = tid >> 5, wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = hk::lane_g(), qq = hk::lane_q();
  int a_off[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int t = 2 * wm + mi;
    a_off[mi] = (16 * t + g) * kPwPS + shift(t & 3) + qq;
  }
  const int b_off = qq * kPwQS + 32 * wn + g;
  // big: the big products since the last flush (on the tensor core);
  // corr: the cross terms, on the tensor core throughout; acc: the
  // float32 sum
  float big[2][4][4], corr[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        big[mi][nj][v] = corr[mi][nj][v] = acc[mi][nj][v] = 0.f;
  auto flush = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[mi][nj][v] += big[mi][nj][v];
          big[mi][nj][v] = 0.f;
        }
  };

  int slot = 0, ld_slot = kPwStages - 1, since = 0;
  for (int s = 0; s < ns; ++s) {
    hk::cp_async_wait<kPwStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    load_stage(s + kPwStages - 1, ld_slot);
    if (++ld_slot == kPwStages) ld_slot = 0;
    const float* ps = ring + slot * kStage;
    const float* qs = ps + kPStage;
#pragma unroll
    for (int kk = 0; kk < kPwK; kk += 8) {
      hk::FragA a[2];
      hk::FragB bf[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* pa = ps + a_off[mi] + kk;
        hk::split(pa[0], a[mi].big[0], a[mi].small[0]);
        hk::split(pa[8 * kPwPS], a[mi].big[1], a[mi].small[1]);
        hk::split(pa[4], a[mi].big[2], a[mi].small[2]);
        hk::split(pa[8 * kPwPS + 4], a[mi].big[3], a[mi].small[3]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const float* pb = qs + b_off + 8 * nj + kk * kPwQS;
        hk::split(pb[0], bf[nj].big[0], bf[nj].small[0]);
        hk::split(pb[4 * kPwQS], bf[nj].big[1], bf[nj].small[1]);
      }
      hk::mma3_apart(big, corr, a, bf);
    }
    if (++since == kPwFlush || s == ns - 1) {
      flush();
      since = 0;
    }
    if (++slot == kPwStages) slot = 0;
  }
  hk::cp_async_wait_all();
  // the sum plus the cross terms, to the partial
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][nj][v] += corr[mi][nj][v];
  pw_wgrad_store(acc, o_s, partial, Cp, Cq, cp0, cq0, transposed);
}

// pw-wgrad on bf16 storage (pw_wgrad16_kernel): p and q bf16, dW float32
// (JAX's wgrad kernel writes a float32 dW from bf16 operands), the
// product one bf16 mma.sync m16n8k16 a fragment pair (the products of two
// bf16 values are exact in float32).
//
// What bounds it on the H100 (PERF.md; tools/phase_split.py --pw16 splits
// a launch of the first design): bytes, 2 (Cp + Cq) bytes a position for
// 2 Cp Cq flops (~26 flops a byte at 256 x 64 against ~295 for the bf16
// tensor cores). The first bf16 kernel ran the float32 kernel's 128 x 64
// tiles (so the 64-channel side was read twice), built every fragment
// register from two 2-byte shared loads and a pack (a planar row staged
// at its own shift mod 8), and copied each planar row's two end blocks
// value by value. The design:
//   - a block owns all kPw16Rows x kPw16Cols of dW (at the presets' 256 x
//     64 the whole of it), so each side is read once; 8 warps, warp w the
//     32 planar channels w + 8 i of the tile against its 64 packed
//     channels: 16 m16n8 sums a lane, a float32 sum beside each (128
//     registers);
//   - a planar row is staged from the 16-byte boundary at or below its
//     window's first position, in whole 16-byte copies: the positions of
//     channel c's row start at offset d_c mod 8 in their blocks (M = 251
//     x 129 is odd), and channels 8 apart share d (8 M is a multiple of
//     8), so the block stages its channels grouped by c mod 8 (staged row
//     32 (c % 8) + c / 8: warp w's two m16 tiles one class) and each
//     class covers its own window of positions, shifted down by d: chunk
//     x's positions for class d are [x L - d, (x + 1) L - d) (the last
//     chunk's run to M, one stage more where d needs it), which tile a
//     batch row's positions once per class. The A fragments then come by
//     ldmatrix from aligned rows;
//   - the packed side is shifted instead: a stage holds kPw16K + 8
//     packed positions, from 8 before the stage's first (a halo), each a
//     128-byte row (64 channels), so an ldmatrix .trans can start at any
//     position: warp w reads its B fragments from the stage's row 8 - d_w
//     on. Positions outside [0, M) are zero on the packed side, so a
//     planar value read there (the row's neighbour, or the zero fill past
//     the array's end) adds nothing;
//   - stages of kPw16K positions stream through a cp.async ring of
//     kPw16Stages; the tensor core sums a stage (4 k16 steps, its first
//     product into a zeroed accumulator) and the stage's sum is added to
//     the float32 sum on the SIMT units: the tensor core's sum rounds
//     toward zero and drifts over a long K (the card test
//     test_bf16_pw_wgrad_does_not_drift_on_positive_sums);
//   - blocks are grouped in clusters of kPw16Cluster consecutive chunks;
//     after its last stage each block puts its tile in its shared memory
//     and rank r of the cluster adds the kPw16Cluster tiles' r-th share
//     of rows in rank order (distributed shared memory, a row at a time)
//     into one partial, in the partial's layout (dW's, or its transpose
//     for K7's, turned round in a staging tile of the block's own: reading
//     the remote tiles a column at a time made K7's dW take half as long
//     again as K6's), so a launch writes 1 / kPw16Cluster of the partials
//     a block each would; the fixed-order sum_partials_kernel adds the
//     partials, each written once, so two calls give the same bits. Clusters
//     of 2 beat 1, 4 and 8 (tools/kernel_variants.py pw16): the ~128
//     blocks of a launch, one an SM and a cluster's in one GPC, did not
//     all fit in one wave in clusters of 4 or 8.
//
// Staged planar rows of kPw16PS bf16 and packed positions of kPw16QS (144
// bytes, 36 words: the 8 rows of an ldmatrix matrix hit 8 distinct
// 4-bank groups, and a quarter warp's 16-byte copies into one row or
// consecutive rows likewise); the output tile's rows kPw16OS floats (an
// odd stride: a lane's D values of one register land 2 to a bank), and
// the transpose's staging rows kPw16Rows / kPw16Cluster + 1 (a warp's
// column writes hit 32 banks).
constexpr int kPw16Rows = 256;
constexpr int kPw16Cols = 64;
constexpr int kPw16K = 64;
constexpr int kPw16Stages = 4;
constexpr int kPw16Cluster = 2;
constexpr int kPw16Threads = 256;
constexpr int kPw16PS = kPw16K + 8;
constexpr int kPw16QS = kPw16Cols + 8;
constexpr int kPw16OS = kPw16Cols + 1;

// pw-wgrad's shared bytes in bf16 storage: the ring of kPw16Stages stages
// of kPw16Rows planar rows and kPw16K + 8 packed positions, or in its
// place the float32 output tile and the staging tile of a rank's
// transposed share (ops/packed_tf.pw_wgrad16_smem)
__host__ __device__ __forceinline__ int pw_wgrad16_smem_bytes() {
  const int ring =
      2 * kPw16Stages * (kPw16Rows * kPw16PS + (kPw16K + 8) * kPw16QS);
  const int tile = 4 * (kPw16Rows * kPw16OS +
                       kPw16Cols * (kPw16Rows / kPw16Cluster + 1));
  return ring > tile ? ring : tile;
}

// grid (round_up(chunks, kPw16Cluster), tiles_p * tiles_q, B), clusters
// of kPw16Cluster blocks along x, kPw16Threads threads, one block an SM.
// p (B, Cp, M) channel-planar, 16-byte aligned; q (B, M, Cq)
// channel-innermost; vec: Cq % 8 == 0 and q 16-byte aligned (else the
// packed side value by value). Block (x, y, b) sums chunk x of batch row
// b (positions [x L - d, (x + 1) L - d) for a planar channel of class d,
// above; L a multiple of kPw16K; none for x past the last chunk) into
// tile y = (planar tile, packed tile); cluster (x / kPw16Cluster, y, b)
// writes partial row b ceil(chunks / kPw16Cluster) + x / kPw16Cluster of
// (B ceil(chunks / kPw16Cluster), Cp * Cq), dW (Cp, Cq) or its transpose
// (Cq, Cp) where transposed (K7's dW: Ca is the packed side).
//
// Stage s of a chunk (p0 = x L + s kPw16K): thread t copies the 16-byte
// block t % 8 of the planar rows of channels i + 8 (t / 8), i < 8 (staged
// rows 32 i + t / 8), from element (b Cp + c) M + p0 - d_i of p on (zero
// past p's end; channels past Cp not copied: they reach only outputs
// that are not written), and the packed positions p0 - 8 .. p0 + kPw16K
// - 1 as 16-byte chunks of 8 channels (zero outside [0, M) or past Cq).
// Iteration s waits for stage s, issues stage s + kPw16Stages - 1 into
// the slot iteration s - 1 read, then multiplies stage s: warp w's A
// fragments from its staged rows 32 w .. 32 w + 31 at column kk, its B
// fragments from packed row 8 - d_w + kk on.
__global__ void __cluster_dims__(kPw16Cluster, 1, 1)
    __launch_bounds__(kPw16Threads, 1)
pw_wgrad16_kernel(const __nv_bfloat16* __restrict__ p,
                  const __nv_bfloat16* __restrict__ q,
                  float* __restrict__ partial, int M, int Cp, int Cq, int L,
                  int chunks, int transposed, int vec) {
  constexpr int kPStage = kPw16Rows * kPw16PS;
  constexpr int kQRows = kPw16K + 8;
  constexpr int kStage = kPStage + kQRows * kPw16QS;
  constexpr int kBlocks = kPw16K / 8;  // 16-byte blocks a staged row
  constexpr int kRowsPass = kPw16Threads / kBlocks;
  static_assert(kPw16Rows == 256 && kPw16Cols == 64 && kPw16K % 16 == 0 &&
                    kPw16Threads == 32 * 8,
                "warp w: the 32 channels of class w against 64 packed");
  static_assert(kPw16Threads % kBlocks == 0 && kPw16Rows % kRowsPass == 0,
                "whole passes of the block's threads over the staged rows");
  extern __shared__ float4 smem4[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem4);
  const unsigned short* pv = reinterpret_cast<const unsigned short*>(p);
  const unsigned short* qv = reinterpret_cast<const unsigned short*>(q);
  const int tid = threadIdx.x, b = blockIdx.z;
  const int tiles_q = (Cq + kPw16Cols - 1) / kPw16Cols;
  const int cp0 = (int)blockIdx.y / tiles_q * kPw16Rows;
  const int cq0 = (int)blockIdx.y % tiles_q * kPw16Cols;
  const int x = blockIdx.x;
  const long long xl = (long long)x * L;
  // stages: L / kPw16K, the last chunk's to M for every class, none past
  const int ns = x < chunks - 1 ? L / kPw16K
                 : x == chunks - 1
                     ? (int)((M - xl + 7 + kPw16K - 1) / kPw16K)
                     : 0;
  // the class of channel cp0 + i (i < 8): the offset of its chunk's first
  // position in its 16-byte block (p is aligned)
  auto shift = [&](int i) {
    return (int)(((uint32_t)((long long)b * Cp + cp0 + i) * (uint32_t)M +
                  (uint32_t)xl) &
                 7u);
  };
  int d_cls[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d_cls[i] = shift(i);
  // the thread's planar copies: block jb of staged rows j kRowsPass + rp
  // (one pass of the block's threads a j), staged row sr holding channel
  // sr / 32 + 8 (sr % 32) of the tile, class sr / 32
  const int jb = tid % kBlocks, rp = tid / kBlocks;
  const long long n_p = (long long)gridDim.z * Cp * M;  // p's values
  const int rows = Cp - cp0;  // valid planar channels of the tile
  auto load_stage = [&](int s, int slot) {
    if (s < ns) {
      unsigned short* ps = ring + slot * kStage;
      unsigned short* qs = ps + kPStage;
      const long long p0s = xl + (long long)s * kPw16K + 8 * jb;
#pragma unroll
      for (int j = 0; j < kPw16Rows / kRowsPass; ++j) {
        const int sr = j * kRowsPass + rp, cls = sr >> 5;
        const int ch = cls + 8 * (sr & 31);
        if (ch < rows) {
          const long long e =
              ((long long)b * Cp + cp0 + ch) * M + p0s - d_cls[cls];
          const long long left = n_p - e;
          const int bytes = left >= 8 ? 16 : left > 0 ? 2 * (int)left : 0;
          hk::cp_async16_n(ps + sr * kPw16PS + 8 * jb, bytes ? pv + e : pv,
                           bytes);
        }
      }
      const long long p0 = xl + (long long)s * kPw16K - 8;
      for (int e = tid; e < kQRows * kPw16Cols / 8; e += kPw16Threads) {
        const int pp = e >> 3, c = 8 * (e & 7);
        const long long pos = p0 + pp;
        unsigned short* d = qs + pp * kPw16QS + c;
        const bool in = pos >= 0 && pos < M;
        const unsigned short* src =
            qv + ((long long)b * M + pos) * Cq + cq0 + c;
        if (vec) {
          const bool ok = in && cq0 + c < Cq;
          hk::cp_async16(d, ok ? src : qv, ok);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            d[k] = in && cq0 + c + k < Cq ? src[k] : (unsigned short)0;
        }
      }
    }
    hk::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kPw16Stages - 1; ++s) load_stage(s, s);

  // warp w: A from staged rows 32 w + 16 mi + (lane's row), B from packed
  // row 8 - d_w + (lane's row); the lane's row and column in an x4
  // ldmatrix: matrix l / 8's row l % 8 at rows + 8 ((l / 8) & 1), columns
  // + 8 (l / 16)
  const int lane = tid & 31, w = tid >> 5;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const unsigned a_at =
      hk::smem_u32(ring + (32 * w + lr) * kPw16PS + lc);
  const unsigned b_at =
      hk::smem_u32(ring + kPStage + (8 - d_cls[w] + lr) * kPw16QS + lc);
  float big[2][8][4], acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][nj][v] = 0.f;

  int slot = 0, ld_slot = kPw16Stages - 1;
  for (int s = 0; s < ns; ++s) {
    hk::cp_async_wait<kPw16Stages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    load_stage(s + kPw16Stages - 1, ld_slot);
    if (++ld_slot == kPw16Stages) ld_slot = 0;
    const unsigned st = 2u * slot * kStage;  // the slot's byte offset
#pragma unroll
    for (int kk = 0; kk < kPw16K; kk += 16) {
      uint32_t a[2][4], bq[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        hk::ldsm_x4_at(a[mi], a_at + st + 2 * (16 * mi * kPw16PS + kk));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        hk::ldsm_x4_trans_at(r, b_at + st + 2 * (kk * kPw16QS + 16 * np));
        bq[2 * np][0] = r[0];
        bq[2 * np][1] = r[1];
        bq[2 * np + 1][0] = r[2];
        bq[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          if (kk == 0)
            hk::mma_bf16_zero(big[mi][nj], a[mi], bq[nj]);
          else
            hk::mma_bf16(big[mi][nj], a[mi], bq[nj]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mi][nj][v] += big[mi][nj][v];
    if (++slot == kPw16Stages) slot = 0;
  }
  hk::cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring

  // the tile to shared memory, a planar channel a row: D c0 (g, 2q), c1
  // (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1) of warp w's m16 tile
  // mi, n8 tile nj are planar channel w + 8 (16 mi + g) (+ 64), packed
  // channel 8 nj + 2 q (+ 1)
  float* o_s = reinterpret_cast<float*>(smem4);
  const int g = hk::lane_g(), qq = hk::lane_q();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      float* o = o_s + (w + 128 * mi + 8 * g) * kPw16OS + 8 * nj + 2 * qq;
      o[0] = acc[mi][nj][0];
      o[1] = acc[mi][nj][1];
      o[64 * kPw16OS] = acc[mi][nj][2];
      o[64 * kPw16OS + 1] = acc[mi][nj][3];
    }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's tile is in its shared memory
  const int rank = (int)cluster.block_rank();
  const float* tiles[kPw16Cluster];
#pragma unroll
  for (int k = 0; k < kPw16Cluster; ++k)
    tiles[k] = cluster.map_shared_rank(o_s, k);
  float* part = partial + ((long long)b * (gridDim.x / kPw16Cluster) +
                           x / kPw16Cluster) *
                              ((long long)Cp * Cq);
  const int cols = min(kPw16Cols, Cq - cq0);
  // rank r's share: rows r0 .. r0 + kQRowsR - 1 of the tile, read from
  // the cluster's tiles a row at a time (a warp's reads one 128-byte
  // row); the transpose goes through a staging tile of this block's own
  // (columns a row, past o_s) so that its writes are rows of dW^T
  constexpr int kQRowsR = kPw16Rows / kPw16Cluster;
  const int r0 = rank * kQRowsR;
  float* stg = o_s + kPw16Rows * kPw16OS;  // (kPw16Cols, kQRowsR + 1)
  for (int e = tid; e < kQRowsR * kPw16Cols; e += kPw16Threads) {
    const int r = e / kPw16Cols, c = e % kPw16Cols;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kPw16Cluster; ++k)
      v += tiles[k][(r0 + r) * kPw16OS + c];
    if (transposed)
      stg[c * (kQRowsR + 1) + r] = v;
    else if (r0 + r < rows && c < cols)
      part[(long long)(cp0 + r0 + r) * Cq + cq0 + c] = v;
  }
  if (transposed) {
    __syncthreads();
    for (int e = tid; e < kQRowsR * kPw16Cols; e += kPw16Threads) {
      const int c = e / kQRowsR, r = e % kQRowsR;
      if (r0 + r < rows && c < cols)
        part[(long long)(cq0 + c) * Cp + cp0 + r0 + r] =
            stg[c * (kQRowsR + 1) + r];
    }
  }
  cluster.sync();  // no block leaves while its tile is read
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

// the tiles of K6 (B * ceil(M / kProjM)), or -1 past the int range
long long proj_tiles(int B, int M) {
  const long long t = (long long)B * ((M + kProjM - 1) / kProjM);
  return t < (1LL << 31) ? t : -1;
}

// K8/K9's instantiation for a map of NT and NF terms a row: the counts as
// template arguments where both are 1, 2 or 3 (every map the packed model
// builds), so that their loops unroll; the generic kernel otherwise
template <typename Kernel>
Kernel pick_map_kernel(int NT, int NF, Kernel generic, Kernel k1, Kernel k2,
                       Kernel k3) {
  if (NT != NF || NT > 3) return generic;
  return NT == 1 ? k1 : NT == 2 ? k2 : k3;
}

// shared bytes of a K8/K9 block: the (tile_rows, CS) tile, then fs/fw and
// ts/tw (ops/packed_tf.map_smem)
size_t map_smem(int tile_rows, int C, int F_out, int NT, int NF) {
  const size_t cs = (size_t)((C + 3) & ~3) + kMapPad;
  return ((size_t)tile_rows * cs + 2 * (size_t)F_out * NF + 2 * (size_t)NT) *
         sizeof(float);
}

}  // namespace

// w is (KT, KF, C) through its strides (ws0, ws1, ws2); bias may be NULL.
// QB quads a block's channels, FT positions its f tile, runs blocks a
// tile, batch row and channel block (ops/packed_tf.dw_conv_geometry)
namespace {

// K5's launch on elements E (float, or bf16 storage); see
// dw_conv_packed_fwd
template <typename E>
int launch_dw_conv(const void* x, const void* w, const void* bias, void* out,
                   int B, int T_in, int F_in, int C, int T_out, int F_out,
                   int KT, int KF, int pt_lo, int pf_lo, int ws0, int ws1,
                   int ws2, int QB, int FT, int runs, void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || KT < 1 || KF < 1 ||
      QB < 1 || QB > kDwQuads || FT < 1 || QB * FT > kDwThreads ||
      runs < 1 || runs > T_out)
    return (int)cudaErrorInvalidValue;
  const long long tiles_f = (F_out + FT - 1) / FT;
  const long long blocks_c = ((C + 3) / 4 + QB - 1) / QB;
  if (!grid_ok(tiles_f, B * blocks_c)) return (int)cudaErrorInvalidValue;
  // the taps of every preset as template arguments
  const bool fixed = KT == 4 && KF == 4;
  const auto kernel = fixed ? dw_conv_packed_kernel<4, 4, E>
                            : dw_conv_packed_kernel<0, 0, E>;
  const size_t smem =
      sizeof(E) == 4
          ? (size_t)dw_smem_floats(KT, KF, QB, FT, fixed) * sizeof(float)
          : (size_t)dw_smem_bytes_bf16(KT, KF, QB, FT, fixed);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = C % 4 == 0 && chunk_aligned((const E*)x) &&
                   chunk_aligned((const E*)out);
  kernel<<<dim3(runs, (unsigned)tiles_f, (unsigned)(B * blocks_c)),
           dim3(QB, FT), smem, (cudaStream_t)stream>>>(
      (const E*)x, (const E*)w, (const E*)bias, (E*)out, T_in, F_in, C, T_out,
      F_out, KT, KF, pt_lo, pf_lo, ws0, ws1, ws2, (int)blocks_c, (int)vec);
  return (int)cudaGetLastError();
}

// K8's launch; see spatial_down_packed_fwd
int launch_spatial_down(const void* x, void* out, const void* ts,
                        const void* tw, const void* fs, const void* fw, int B,
                        int T_in, int F_in, int C, int T_out, int F_out,
                        int NT, int NF, void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || NT < 1 || NF < 1 ||
      !grid_ok(B, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = map_smem(4 * ((F_out + 3) / 4), C, F_out, NT, NF);
  const auto kernel = pick_map_kernel(NT, NF, spatial_down_kernel<0, 0>,
                                      spatial_down_kernel<1, 1>,
                                      spatial_down_kernel<2, 2>,
                                      spatial_down_kernel<3, 3>);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(T_out, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const int*)ts, (const float*)tw, (const int*)fs,
      (const float*)fw, T_in, F_in, C, T_out, F_out, NT, NF);
  return (int)cudaGetLastError();
}

// K9's launch; see spatial_up_packed_fwd
int launch_spatial_up(const void* x, void* out, const void* ts,
                      const void* tw, const void* fs, const void* fw,
                      const void* rows, int B, int T_in, int F_in, int C,
                      int T_out, int F_out, int NT, int NF, int G,
                      void* stream) {
  if (B < 1 || C < 1 || F_in < 1 || T_out < 1 || F_out < 1 || NT < 1 ||
      NF < 1 || G < 1 || G > T_out || !grid_ok(B, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = map_smem(4 * ((F_in + 3) / 4), C, F_out, NT, NF);
  const auto kernel = pick_map_kernel(NT, NF, spatial_up_kernel<0, 0>,
                                      spatial_up_kernel<1, 1>,
                                      spatial_up_kernel<2, 2>,
                                      spatial_up_kernel<3, 3>);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(G, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const int*)ts, (const float*)tw, (const int*)fs,
      (const float*)fw, (const int*)rows, T_in, F_in, C, T_out, F_out, NT,
      NF);
  return (int)cudaGetLastError();
}

// K8 bf16's shared bytes: its (kDown16F, CS) float32 tile
// (ops/packed_tf.map_geometry)
size_t down16_smem(int C) {
  return (size_t)kDown16F * (round_up(C, 8) + kMap16Pad) * sizeof(float);
}

// K9 bf16's: the block's F terms (fb, NF) as floats and ints, then the
// (tile_rows, CS) float32 tile (ops/packed_tf.map_geometry)
size_t up16_smem(int tile_rows, int C, int fb, int NF) {
  return ((size_t)round_up(2 * fb * NF, 4) +
          (size_t)tile_rows * (round_up(C, 8) + kMap16Pad)) *
         sizeof(float);
}

// K8's launch in bf16 storage; see spatial_down_packed_fwd_bf16
int launch_spatial_down_bf16(const void* x, void* out, const void* ts,
                             const void* tw, const void* fs, const void* fw,
                             int B, int T_in, int F_in, int C, int T_out,
                             int F_out, int NT, int NF, void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || NT < 1 || NF < 1 ||
      !grid_ok(T_out, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = down16_smem(C);
  const auto kernel = pick_map_kernel(NT, NF, spatial_down_bf16_kernel<0, 0>,
                                      spatial_down_bf16_kernel<1, 1>,
                                      spatial_down_bf16_kernel<2, 2>,
                                      spatial_down_bf16_kernel<3, 3>);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec_in = C % 8 == 0 && aligned16(x);
  const int vec_out = F_out % 8 == 0 && aligned16(out);
  kernel<<<dim3((F_out + kDown16F - 1) / kDown16F, T_out, B), kDown16Threads,
           smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const int*)ts,
      (const float*)tw, (const int*)fs, (const float*)fw, T_in, F_in, C, T_out,
      F_out, NT, NF, vec_in, vec_out);
  return (int)cudaGetLastError();
}

// K9's launch in bf16 storage; see spatial_up_packed_fwd_bf16
int launch_spatial_up_bf16(const void* x, void* out, const void* rts,
                           const void* rtw, const void* fs, const void* fw,
                           const void* rows, const void* fr, int B, int T_in,
                           int F_in, int C, int T_out, int F_out, int NT,
                           int NF, int G, int nF, int fb, int tile_rows,
                           void* stream) {
  if (B < 1 || C < 1 || F_in < 1 || T_out < 1 || F_out < 1 || NT < 1 ||
      NF < 1 || G < 1 || G > T_out || nF < 1 || fb < 1 ||
      (long long)(nF - 1) * fb >= F_out || (long long)nF * fb < F_out ||
      tile_rows < 0 || tile_rows % 8 != 0 || !grid_ok(G, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = up16_smem(tile_rows, C, fb, NF);
  const auto kernel = pick_map_kernel(NT, NF, spatial_up_bf16_kernel<0, 0>,
                                      spatial_up_bf16_kernel<1, 1>,
                                      spatial_up_bf16_kernel<2, 2>,
                                      spatial_up_bf16_kernel<3, 3>);
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec_in = F_in % 8 == 0 && aligned16(x);
  const int vec_out = C % 8 == 0 && aligned16(out);
  kernel<<<dim3(nF, G, B), kUp16Threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const int*)rts,
      (const float*)rtw, (const int*)fs, (const float*)fw, (const int*)rows,
      (const int*)fr, T_in, F_in, C, T_out, F_out, NT, NF, fb, vec_in,
      vec_out);
  return (int)cudaGetLastError();
}

// the grid of K6's and K7's bf16 kernels, or false where it is too large
bool p16_grid(int B, int M, int N, dim3& grid) {
  const long long mx = ((long long)M + kP16M - 1) / kP16M;
  const long long ny = ((long long)N + kP16N - 1) / kP16N;
  if (B < 1 || M < 1 || N < 1 || mx >= (1LL << 31) || !grid_ok(ny, B))
    return false;
  grid = dim3((unsigned)mx, (unsigned)ny, (unsigned)B);
  return true;
}

}  // namespace

extern "C" int dw_conv_packed_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int B, int T_in,
                                  int F_in, int C, int T_out, int F_out,
                                  int KT, int KF, int pt_lo, int pf_lo,
                                  int ws0, int ws1, int ws2, int QB, int FT,
                                  int runs, void* stream) {
  return launch_dw_conv<float>(x, w, bias, out, B, T_in, F_in, C, T_out,
                               F_out, KT, KF, pt_lo, pf_lo, ws0, ws1, ws2, QB,
                               FT, runs, stream);
}

// K5 in bf16 storage: x, w, bias and out bf16, the launch as
// dw_conv_packed_fwd's (the same blocks: ops/packed_tf.dw_conv_geometry)
extern "C" int dw_conv_packed_fwd_bf16(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int T_in, int F_in, int C, int T_out,
                                       int F_out, int KT, int KF, int pt_lo,
                                       int pf_lo, int ws0, int ws1, int ws2,
                                       int QB, int FT, int runs,
                                       void* stream) {
  return launch_dw_conv<__nv_bfloat16>(x, w, bias, out, B, T_in, F_in, C,
                                       T_out, F_out, KT, KF, pt_lo, pf_lo, ws0,
                                       ws1, ws2, QB, FT, runs, stream);
}

// x (B, K, M) rank-4 with M = T*F, w (K, N) through strides, out (B, M, N);
// blocks: the persistent blocks of an N tile, at most the tiles; one
// launch a slice of kProjSlice k (ops/packed_tf.pw_proj_geometry)
extern "C" int pw_proj_packed_fwd(const void* x, const void* w,
                                  const void* bias, void* out, int B, int M,
                                  int K, int N, int wsk, int wsn, int blocks,
                                  void* stream) {
  const long long tiles = B < 1 || M < 1 ? 0 : proj_tiles(B, M);
  if (tiles < 1 || K < 1 || N < 1 || blocks < 1 || blocks > tiles ||
      !grid_ok((N + kProjN - 1) / kProjN, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)proj_smem_floats(min(K, kProjSlice)) * sizeof(float);
  cudaError_t e = allow_smem((const void*)pw_proj_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // one launch a slice of kProjSlice k, in order, each after the first
  // adding to out
  for (int k0 = 0; k0 < K; k0 += kProjSlice) {
    pw_proj_kernel<<<dim3(blocks, (N + kProjN - 1) / kProjN), kProjThreads,
                     smem, (cudaStream_t)stream>>>(
        (const float*)x + (long long)k0 * M,
        (const float*)w + (long long)k0 * wsk,
        k0 == 0 ? (const float*)bias : nullptr, (float*)out, B, M,
        min(K - k0, kProjSlice), N, wsk, wsn, K, k0 > 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// x (B, M, K) packed, w (K, N) through strides, out (B, N, M) rank-4;
// blocks: the persistent blocks of an N tile, at most the tiles; one
// launch a slice of kProjSlice k, as K6's entry
// (ops/packed_tf.pw_unproj_geometry)
extern "C" int pw_unproj_packed_fwd(const void* x, const void* w,
                                    const void* bias, void* out, int B, int M,
                                    int K, int N, int wsk, int wsn, int blocks,
                                    void* stream) {
  const long long tiles =
      B < 1 || M < 1 ? 0 : (long long)B * ((M + kUnprojM - 1) / kUnprojM);
  if (tiles < 1 || K < 1 || N < 1 || blocks < 1 || blocks > tiles ||
      !grid_ok((N + kProjN - 1) / kProjN, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)unproj_smem_floats(min(K, kProjSlice)) * sizeof(float);
  cudaError_t e = allow_smem((const void*)pw_unproj_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = K % 4 == 0 && aligned16(x);
  for (int k0 = 0; k0 < K; k0 += kProjSlice) {
    pw_unproj_kernel<<<dim3(blocks, (N + kProjN - 1) / kProjN),
                       kUnprojThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x + k0, (const float*)w + (long long)k0 * wsk,
        k0 == 0 ? (const float*)bias : nullptr, (float*)out, B, M,
        min(K - k0, kProjSlice), N, wsk, wsn, K, k0 > 0, (int)vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// maps: ts/tw (T_out, NT), fs/fw (F_out, NF), int32 / float32
extern "C" int spatial_down_packed_fwd(const void* x, void* out,
                                       const void* ts, const void* tw,
                                       const void* fs, const void* fw, int B,
                                       int T_in, int F_in, int C, int T_out,
                                       int F_out, int NT, int NF,
                                       void* stream) {
  return launch_spatial_down(x, out, ts, tw, fs, fw, B, T_in, F_in, C, T_out,
                             F_out, NT, NF, stream);
}

// K8 in bf16 storage (spatial_down_bf16_kernel): x and out bf16, the map
// float32 as spatial_down_packed_fwd's
extern "C" int spatial_down_packed_fwd_bf16(const void* x, void* out,
                                            const void* ts, const void* tw,
                                            const void* fs, const void* fw,
                                            int B, int T_in, int F_in, int C,
                                            int T_out, int F_out, int NT,
                                            int NF, void* stream) {
  return launch_spatial_down_bf16(x, out, ts, tw, fs, fw, B, T_in, F_in, C,
                                  T_out, F_out, NT, NF, stream);
}

// rows (G + 1): the starts of the runs of output rows one block writes,
// then T_out (ops/packed_tf.row_runs)
extern "C" int spatial_up_packed_fwd(const void* x, void* out, const void* ts,
                                     const void* tw, const void* fs,
                                     const void* fw, const void* rows, int B,
                                     int T_in, int F_in, int C, int T_out,
                                     int F_out, int NT, int NF, int G,
                                     void* stream) {
  return launch_spatial_up(x, out, ts, tw, fs, fw, rows, B, T_in, F_in, C,
                           T_out, F_out, NT, NF, G, stream);
}

// K9 in bf16 storage (spatial_up_bf16_kernel): x and out bf16, fs/fw as
// spatial_up_packed_fwd's; the plan of ops/packed_tf.map_geometry: rts/rtw
// (G, NT) the T terms of each run's first row, rows (G + 1) the runs, fr
// (nF, 2) the staged input chunks of each block of fb output f, tile_rows
// the most of them (8 f a chunk)
extern "C" int spatial_up_packed_fwd_bf16(const void* x, void* out,
                                          const void* rts, const void* rtw,
                                          const void* fs, const void* fw,
                                          const void* rows, const void* fr,
                                          int B, int T_in, int F_in, int C,
                                          int T_out, int F_out, int NT,
                                          int NF, int G, int nF, int fb,
                                          int tile_rows, void* stream) {
  return launch_spatial_up_bf16(x, out, rts, rtw, fs, fw, rows, fr, B, T_in,
                                F_in, C, T_out, F_out, NT, NF, G, nF, fb,
                                tile_rows, stream);
}

// K6 in bf16 storage: x (B, K, M) rank-4, w (K, N) through its strides,
// bias (N) or NULL, out (B, M, N) packed, all bf16; one launch over all
// of K (pw_proj_bf16_kernel)
extern "C" int pw_proj_packed_fwd_bf16(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int M, int K, int N, int wsk, int wsn,
                                       void* stream) {
  dim3 grid;
  if (K < 1 || !p16_grid(B, M, N, grid)) return (int)cudaErrorInvalidValue;
  pw_proj_bf16_kernel<<<grid, kP16Threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, M, K, N, wsk, wsn);
  return (int)cudaGetLastError();
}

// K7 in bf16 storage: x (B, M, K) packed, w (K, N) through its strides,
// bias (N) or NULL, out (B, N, M) rank-4, all bf16; one launch over all of
// K (pw_unproj_bf16_kernel)
extern "C" int pw_unproj_packed_fwd_bf16(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int M, int K, int N, int wsk,
                                         int wsn, void* stream) {
  dim3 grid;
  if (K < 1 || !p16_grid(B, M, N, grid)) return (int)cudaErrorInvalidValue;
  const int vec = K % 8 == 0 && aligned16(x);
  pw_unproj_bf16_kernel<<<grid, kP16Threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, M, K, N, wsk, wsn, vec);
  return (int)cudaGetLastError();
}

namespace {

// K5-wgrad's launch on elements E (float, or bf16 storage), then the sum
// of its partials; k44 / k00 the kernel with the presets' 4 x 4 taps as
// template arguments and the generic one; see dw_conv_packed_wgrad
template <typename E, typename Kernel>
int launch_dw_wgrad(Kernel k44, Kernel k00, const void* x, const void* g,
                    void* partial, void* out, int B, int T_in, int F_in,
                    int C, int T_out, int F_out, int KT, int KF, int pt_lo,
                    int pf_lo, int QB, int S, int P, int runs, int n_part,
                    void* stream) {
  if (B < 1 || C < 1 || T_out < 1 || F_out < 1 || KT < 1 || KF < 1 ||
      QB < 1 || S < 1 || P < 1 || runs < 1)
    return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)QB * ((KF + kWgTaps - 1) / kWgTaps) * KT * S;
  const long long tiles_f = (F_out + S * P - 1) / (S * P);
  const long long blocks_c = ((C + 3) / 4 + QB - 1) / QB;
  if (threads > kWgMaxThreads || !grid_ok(tiles_f, blocks_c) ||
      tiles_f * runs != n_part)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && chunk_aligned((const E*)x) &&
                   chunk_aligned((const E*)g);
  const size_t smem =
      sizeof(E) == 4
          ? (size_t)wgrad_smem_floats(KT, KF, QB, S, P) * sizeof(float)
          : (size_t)wgrad_smem_bytes_bf16(KT, KF, QB, S, P);
  const Kernel kernel = KT == 4 && KF == 4 && threads <= kWgThreads ? k44
                                                                    : k00;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(runs, (unsigned)tiles_f, (unsigned)blocks_c), (int)threads,
           smem, (cudaStream_t)stream>>>(
      (const E*)x, (const E*)g, (float*)partial, B, T_in, F_in, C, T_out,
      F_out, KT, KF, pt_lo, pf_lo, QB, S, P, (int)vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, out, n_part, KT * KF * C, stream);
}

}  // namespace

// x (B, T_in, F_in*C), g (B, T_out, F_out*C) packed; out (KT, KF, C);
// QB quads a block's channels, S segments of P positions a tile, runs
// blocks a tile and channel block (ops/packed_tf.dw_wgrad_geometry);
// partial holds n_part = runs * ceil(F_out / (S * P)) rows of KT*KF*C, one
// a (run, f tile) (the wrapper sizes it, and a grid of another size is
// refused)
extern "C" int dw_conv_packed_wgrad(const void* x, const void* g,
                                    void* partial, void* out, int B,
                                    int T_in, int F_in, int C, int T_out,
                                    int F_out, int KT, int KF, int pt_lo,
                                    int pf_lo, int QB, int S, int P, int runs,
                                    int n_part, void* stream) {
  // the taps of every preset as template arguments
  return launch_dw_wgrad<float>(dw_wgrad_kernel<4, 4>, dw_wgrad_kernel<0, 0>,
                                x, g, partial, out, B, T_in, F_in, C, T_out,
                                F_out, KT, KF, pt_lo, pf_lo, QB, S, P, runs,
                                n_part, stream);
}

// K5-wgrad on bf16 storage: x and g bf16, partial and out float32 (JAX's
// wgrad kernel writes a float32 dW from bf16 operands), the launch as
// dw_conv_packed_wgrad's (ops/packed_tf.dw_wgrad_geometry with the bf16
// ring's shared memory)
extern "C" int dw_conv_packed_wgrad_bf16(const void* x, const void* g,
                                         void* partial, void* out, int B,
                                         int T_in, int F_in, int C,
                                         int T_out, int F_out, int KT,
                                         int KF, int pt_lo, int pf_lo,
                                         int QB, int S, int P, int runs,
                                         int n_part, void* stream) {
  using bf = __nv_bfloat16;
  return launch_dw_wgrad<bf>(dw_wgrad_kernel<4, 4, bf>,
                             dw_wgrad_kernel<0, 0, bf>, x, g, partial, out,
                             B, T_in, F_in, C, T_out, F_out, KT, KF, pt_lo,
                             pf_lo, QB, S, P, runs, n_part, stream);
}

// a_planar: a (B, Ca, M) rank-4 and g (B, M, Cb) packed (K6's dW), else a
// (B, M, Ca) packed and g (B, Cb, M) rank-4 (K7's); out (Ca, Cb). L
// positions a chunk of a batch row (a multiple of kPwK); partial holds
// n_part = B * ceil(M / L) rows of Ca*Cb, one a (batch row, chunk)
// (ops/packed_tf.pw_wgrad_geometry; the wrapper sizes it, and a grid of
// another size is refused)
extern "C" int pw_packed_wgrad(const void* a, const void* g, void* partial,
                               void* out, int B, int M, int Ca, int Cb,
                               int a_planar, int L, int n_part,
                               void* stream) {
  if (B < 1 || M < 1 || Ca < 1 || Cb < 1 || L < 1 || L % kPwK)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)M + L - 1) / L;
  // the planar side is dW's rows, the packed side its columns
  const int Cp = a_planar ? Ca : Cb, Cq = a_planar ? Cb : Ca;
  const float* p = (const float*)(a_planar ? a : g);
  const float* q = (const float*)(a_planar ? g : a);
  const long long tiles = (long long)((Cp + kPwRows - 1) / kPwRows) *
                          ((Cq + kPwCols - 1) / kPwCols);
  if (!grid_ok(tiles, B) || chunks * B != n_part)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)pw_wgrad_smem_floats() * sizeof(float);
  cudaError_t e = allow_smem((const void*)pw_wgrad_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = Cq % 4 == 0 && aligned16(q);
  pw_wgrad_kernel<<<dim3((unsigned)chunks, (unsigned)tiles, B), kPwThreads,
                    smem, (cudaStream_t)stream>>>(
      p, q, (float*)partial, M, Cp, Cq, L, !a_planar, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, out, n_part, Ca * Cb, stream);
}

// pw-wgrad on bf16 storage (pw_wgrad16_kernel): a and g bf16, the planar
// one 16-byte aligned, partial and out float32; the arguments as
// pw_packed_wgrad's, L a multiple of kPw16K and n_part = B
// ceil(chunks / kPw16Cluster), one partial a cluster
// (ops/packed_tf.pw_wgrad16_geometry)
extern "C" int pw_packed_wgrad_bf16(const void* a, const void* g,
                                    void* partial, void* out, int B, int M,
                                    int Ca, int Cb, int a_planar, int L,
                                    int n_part, void* stream) {
  if (B < 1 || M < 1 || Ca < 1 || Cb < 1 || L < 1 || L % kPw16K)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)M + L - 1) / L;
  const long long groups = (chunks + kPw16Cluster - 1) / kPw16Cluster;
  const int Cp = a_planar ? Ca : Cb, Cq = a_planar ? Cb : Ca;
  const __nv_bfloat16* p = (const __nv_bfloat16*)(a_planar ? a : g);
  const __nv_bfloat16* q = (const __nv_bfloat16*)(a_planar ? g : a);
  const long long tiles = (long long)((Cp + kPw16Rows - 1) / kPw16Rows) *
                          ((Cq + kPw16Cols - 1) / kPw16Cols);
  if (!grid_ok(tiles, B) || groups * B != n_part || !aligned16(p))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)pw_wgrad16_smem_bytes();
  cudaError_t e = allow_smem((const void*)pw_wgrad16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = Cq % 8 == 0 && aligned16(q);
  pw_wgrad16_kernel<<<dim3((unsigned)(groups * kPw16Cluster),
                           (unsigned)tiles, B),
                      kPw16Threads, smem, (cudaStream_t)stream>>>(
      p, q, (float*)partial, M, Cp, Cq, L, (int)chunks, !a_planar, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, out, n_part, Ca * Cb, stream);
}
