// Time-major ConvTranspose1d (stride 1, padding 0) for Hopper (sm_90a),
// float32 and in bf16 storage.
//
// K3  convt1d_ola_tm_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/convt_tm.py, called from convt1d_ola_tm): the
//     back-projection at the tail of every DualPathRNN;
//     convt1d_ola_tm_fwd_bf16 the same kernel on bf16 operands (what
//     bounds it: at the preset's 2H 64 and k 8, bf16 halves the bytes, so
//     ~256 flops a byte, near the card's bf16 ratio of ~295).
// K3  convt1d_ola_tm_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/convt_tm.py, called from _vjp_bwd): its VJP;
//     convt1d_ola_tm_bwd_bf16 its bf16 form (g, x, W in, dx and dW out
//     bf16; both products bf16 mma.sync.m16n8k16 on the tensor cores into
//     float32 sums, dx and dW rounded once, as the Pallas kernel's bf16
//     dots with float32 results and its float32 dW scratch): dx and dW in
//     one kernel over a window of g rows (convt1d_tm_bwd_bf16_kernel), one
//     float32 dW partial a run of l steps and column tile.
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
// products are bound by operations: the backward's by float32 ones on the
// SIMT units, the forward's by the tensor cores' rate in 3xTF32 (three
// TF32 products a float32 one, tf32x3.cuh); the design's job is to keep
// those units fed from shared memory and registers.
//
// Forward (convt1d_tm_fwd_kernel), the dx kernel's design transposed.
// x is time-major, so out[t] = W_flat window_t, a product of depth
// k*C_in = 512 with W_flat = W as (C_out x k*C_in), W_flat[o][j*C_in + i]
// = W[j][o][i], and window_t the k rows x[t-j] stacked (the Pallas
// kernel's windowed dot). Each block keeps W_flat (128 KB at the preset,
// each tap's C_in padded to a multiple of 8, rows padded to a stride of
// 4 mod 8 floats) in shared memory, brought in by cp.async with its
// first x rows, and walks a run of consecutive output steps t for one
// tile of 16 batch columns, 8 steps a pass, keeping a ring of k+15
// time-major x rows (C_in x 16 each, swizzled; rows outside [0, L)
// zero-filled by the copy): a pass reads rows t-k+1 .. t+7 while cp.async
// brings the next pass's 8 rows into the free slots, so each x row is
// read from memory once per block. The product runs on the tensor cores
// in 3xTF32 (tf32x3.cuh): the 8 warps split the output tile (C_out x 16)
// as 4 m16 x 2 n8 tiles, a warp one tile for all 8 steps of the pass, so
// that each W fragment it splits serves 8 products and each x fragment
// serves up to 8 (the row step t+p reads at tap j is the one step t+p-1
// read at tap j-1), and the tensor cores see 8 independent accumulators a
// warp; no partial sum crosses warps and the order of every sum is
// fixed. One block an SM (221 KB of shared memory at the preset); the
// blocks are the column tiles times runs of steps that fill the 132 SMs
// once. Wider channels are split over the grid's z, so that every width
// fits: output channels in blocks of 64 (the warps' four m16 tiles), input
// channels in the fewest equal slices (multiples of 8) whose W_flat and
// ring fit a block (ops/convt_tm.fwd_geometry; 2H 96 as two of 48, 160 as
// three of at most 56). Each input slice's sums go to a partial of out,
// and a second kernel adds the partials in a fixed order; one slice (C_in
// <= 64 at k 8, the presets') writes out directly.
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
//     Wider channels are split over the grid's z: input channels in
//     blocks of 64 (a thread's 8 x 8 rows), each writing its own rows of
//     dx, and output channels, the reduction, in slices whose W and ring
//     fit a block (64 at k 8), each writing a partial of dx that a second
//     kernel adds in a fixed order (ops/convt_tm.bwd_geometry).
//   dW (convt1d_tm_wgrad_kernel): split-K over the L*B columns; a block
//     owns a 128 x 64 tile of dW_cat (k*C_out x C_in) and one chunk of
//     columns, stages 32 columns of the slab rows and of x transposed in
//     shared memory, the next stage's loads in flight in registers, each
//     thread an 8 x 4 register tile; one partial a chunk, summed in a
//     fixed order (convt1d_tm_sum_kernel): no float atomics, so two calls
//     give the same bits.
// The float32 backward's products run in full float32 on the SIMT units.
// The bf16 backward's run on the tensor cores, as JAX's bf16 dots do (the
// products of bf16 values are exact in float32): what bounds it at the
// preset is its bytes (g and x read, ~7.7 MB at the bs-4 freq site), since
// one bf16 mma.sync does the work of 64 float32 FMAs. At step l both dx
// (dx[l] = W_cat^T slab_l) and dW (dW_cat += slab_l x[l]^T) take the g rows
// l .. l + k - 1, so one kernel (convt1d_tm_bwd_bf16_kernel) walks a
// column tile's l steps with a ring of g rows and does both: each g row
// is copied once a block and used by every tap of both products. The rows
// are staged as they lie (b fastest: K-contiguous for dW's operands; dx's
// take them by ldmatrix.trans), and dW's tensor-core accumulators are
// flushed into float32 registers every pass of 8 l steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using hk::cp_async16;
using hk::cp_async4;
using hk::cp_async_commit;
using hk::cp_async_wait_all;

// forward (ops/convt_tm.py mirrors these): output channels a block (4 m16
// tiles; a wider C_out is split over the grid), batch columns a block (2
// n8 tiles; also an x row's stride in shared memory, swizzled) and output
// steps a pass
constexpr int kMaxOut = 64;
constexpr int kFwdCols = 16;
constexpr int kFwdPass = 8;
// backward (ops/convt_tm.py mirrors these): dx columns per block, the
// dx block's tap groups, the input channels a dx block and dW tile (a
// wider C_in is split over the grid) and W's row stride in shared memory
// (8 thread rows x 8), threads a block, dW tile rows (16 thread rows x 8)
// and columns per dW stage
constexpr int kDxCols = 32;
constexpr int kDxGroups = 4;
constexpr int kMaxIn = 64;
constexpr int kThreads = 256;
constexpr int kWgRows = 128;
constexpr int kWgCols = 32;
// bf16 backward (ops/convt_tm.py mirrors them): taps, output and input
// channels a block (a larger K, C_out or C_in is split over the grid), its
// threads (for dW a warp a tap and 32 output channels), l steps a pass and
// passes in the ring (kDwStages - 1 of them in flight)
constexpr int kDwTaps = 8;
constexpr int kDwOut = 64;
constexpr int kDwIn = 32;
constexpr int kDwThreads = 512;
constexpr int kDwPass = 8;
constexpr int kDwStages = 3;

__host__ __device__ __forceinline__ int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Shared memory of the forward kernel in floats at Ci input and Co output
// channels a block: W_flat (C_out padded to 16 rows of k * C_in' + 4,
// C_in' = C_in padded to 8) and the ring of K + 2 kFwdPass - 1 x rows
// (C_in' x kFwdCols each).
__host__ __device__ __forceinline__ int fwd_smem_floats(int K, int Ci,
                                                        int Co) {
  const int cp = round_up(Ci, 8);
  return round_up(Co, 16) * (K * cp + 4)
         + (K + 2 * kFwdPass - 1) * cp * kFwdCols;
}

// Element (i, c) of an x row in its ring slot: rows of kFwdCols floats,
// column c XOR 8 on rows 2, 3 mod 4, so that a B fragment (rows q and q+4
// of 8, columns g of 8) meets 32 distinct banks; 4-float groups stay
// together.
__device__ __forceinline__ int ring_at(int i, int c) {
  return i * kFwdCols + (c ^ (((i >> 1) & 1) << 3));
}

// grid (ceil(B / kFwdCols), ceil((L + K - 1) / steps), n_in * n_out),
// kThreads threads; n_in = ceil(Ci / ci_slice) slices of the input
// channels, n_out = ceil(Co / kMaxOut) of the output channels. Block
// (tile, run, z) takes input channels ci0 .. ci0 + ci_slice - 1 (ci0 =
// (z % n_in) ci_slice) and writes its sums over them for output channels
// co0 .. co0 + kMaxOut - 1 (co0 = (z / n_in) kMaxOut) at columns b0 ..
// b0+15 and t in [run * steps, min(L + K - 1, (run + 1) * steps)) to
// out's partial z % n_in (out itself where n_in is 1), kFwdPass steps a
// pass. Warp w owns output channels 16 (w / 2) .. + 15 and columns
// 8 (w % 2) .. + 7 of the tile, for every step of a pass: tap j's W
// fragment serves them all, and step t+p at tap j reads the x row that
// step t+p-1 read at tap j-1, so each fragment is split once a pass. The
// next tap's operands are loaded from shared memory before this tap's
// products are issued.
// KT > 0 fixes the tap count at compile time (the preset's 8), so that
// the tap loop unrolls and the x fragments pass from step to step by
// register renaming; KT = 0 takes any K.
template <int KT>
__global__ void __launch_bounds__(kThreads)
convt1d_tm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int L, int Ci, int Co,
                      int k_taps, int B, int steps, int ci_slice) {
  extern __shared__ float4 smem4[];
  const int K = KT > 0 ? KT : k_taps;
  const int n_in = (Ci + ci_slice - 1) / ci_slice;
  const int ci0 = blockIdx.z % n_in * ci_slice;
  const int co0 = blockIdx.z / n_in * kMaxOut;
  const int ci_n = min(ci_slice, Ci - ci0), co_n = min(kMaxOut, Co - co0);
  const int cp = round_up(ci_n, 8), kt = K * cp, ws = kt + 4;
  const int rows = round_up(co_n, 16), slots = K + 2 * kFwdPass - 1;
  float* w_s = reinterpret_cast<float*>(smem4);  // w_s[o * ws + j*cp + i]
  float* ring = w_s + rows * ws;                 // (slots, cp, kFwdCols)
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kFwdCols;
  const int t_out = L + K - 1;
  const int t0 = blockIdx.y * steps, t1 = min(t_out, t0 + steps);
  const int slot_len = cp * kFwdCols;
  const bool vec_x = B % 4 == 0;
  x += (long long)ci0 * B;  // x[r][ci0 + i][b] at x[(r Ci + i) B + b]
  w += (long long)co0 * Ci + ci0;  // W[j][co0 + o][ci0 + i]
  out += ((long long)(blockIdx.z % n_in) * t_out * Co + co0) * B;

  // x row r (zero outside [0, L)) into its ring slot (r + slots) % slots
  auto load_row = [&](int r) {
    float* dst = ring + (r + slots) % slots * slot_len;
    const bool on = r >= 0 && r < L;
    const float* src = x + (long long)(on ? r : 0) * Ci * B + b0;
    const int per = vec_x ? 4 : 1;
    for (int e = per * tid; e < cp * kFwdCols; e += per * kThreads) {
      const int i = e / kFwdCols, c = e % kFwdCols;
      const bool ok = on && i < ci_n && b0 + c < B;
      const float* s = ok ? src + (long long)i * B + c : x;
      if (vec_x)
        hk::cp_async16(dst + ring_at(i, c), s, ok);
      else
        hk::cp_async4(dst + ring_at(i, c), s, ok);
    }
  };
  // W_flat, zero-padded, and the first window's rows t0-K+1 .. t0+P-1,
  // all in flight at once
  const int per_w = Ci % 4 == 0 ? 4 : 1;  // ci0 is a multiple of 8
  for (int e = per_w * tid; e < rows * kt; e += per_w * kThreads) {
    const int o = e / kt, j = e % kt / cp, i = e % cp;
    const bool ok = o < co_n && i < ci_n;
    const float* s = ok ? w + ((long long)j * Co + o) * Ci + i : w;
    if (per_w == 4)
      hk::cp_async16(w_s + o * ws + e % kt, s, ok);
    else
      hk::cp_async4(w_s + o * ws + e % kt, s, ok);
  }
  for (int r = t0 - K + 1; r < t0 + kFwdPass; ++r) load_row(r);
  hk::cp_async_commit();
  hk::cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5, m0 = (warp >> 1) * 16, n0 = (warp & 1) * 8;
  const int g = hk::lane_g(), q = hk::lane_q();
  // the lane's A elements (rows m0+g, m0+g+8; columns q, q+4 of a k8
  // block) and B elements (rows q, q+4 of a k8 block; column n0+g)
  const float* wl = w_s + (m0 + g) * ws + q;
  const int w8 = 8 * ws;
  const int xb0 = ring_at(q, n0 + g), xb1 = ring_at(q + 4, n0 + g);
  for (int t = t0; t < t1; t += kFwdPass) {
    // the next pass's rows, into the slots rows t-K-P+1 .. t-K left
    if (t + kFwdPass < t1)
      for (int r = t + kFwdPass; r < t + 2 * kFwdPass; ++r) load_row(r);
    hk::cp_async_commit();
    if (m0 < co_n) {  // uniform over the warp
      float acc[kFwdPass][4];
#pragma unroll
      for (int p = 0; p < kFwdPass; ++p)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[p][v] = 0.f;
      const int s_t = (t + slots) % slots;  // row t's slot
      for (int i0 = 0; i0 < cp; i0 += 8) {
        // step p >= 1 at tap 0 reads row t+p
        hk::FragB xb[kFwdPass];
#pragma unroll
        for (int p = 1; p < kFwdPass; ++p) {
          const int sp = s_t + p < slots ? s_t + p : s_t + p - slots;
          const float* r = ring + sp * slot_len + i0 * kFwdCols;
          hk::split(r[xb0], xb[p].big[0], xb[p].small[0]);
          hk::split(r[xb1], xb[p].big[1], xb[p].small[1]);
        }
        // tap j: W[j] and row t-j (slot sj); the next tap's loaded ahead
        int sj = s_t;
        const float* rx = ring + sj * slot_len + i0 * kFwdCols;
        const float* ra = wl + i0;
        float a_raw[4] = {ra[0], ra[w8], ra[4], ra[w8 + 4]};
        float b_raw[2] = {rx[xb0], rx[xb1]};
#pragma unroll
        for (int j = 0; j < K; ++j) {
          hk::FragA a;
#pragma unroll
          for (int v = 0; v < 4; ++v) hk::split(a_raw[v], a.big[v], a.small[v]);
          hk::split(b_raw[0], xb[0].big[0], xb[0].small[0]);
          hk::split(b_raw[1], xb[0].big[1], xb[0].small[1]);
          if (j + 1 < K) {
            sj = sj == 0 ? slots - 1 : sj - 1;
            rx = ring + sj * slot_len + i0 * kFwdCols;
            ra = wl + (j + 1) * cp + i0;
            a_raw[0] = ra[0];
            a_raw[1] = ra[w8];
            a_raw[2] = ra[4];
            a_raw[3] = ra[w8 + 4];
            b_raw[0] = rx[xb0];
            b_raw[1] = rx[xb1];
          }
#pragma unroll
          for (int p = 0; p < kFwdPass; ++p) hk::mma3(acc[p], a, xb[p]);
#pragma unroll
          for (int p = kFwdPass - 1; p > 0; --p) xb[p] = xb[p - 1];
        }
      }
      // c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
      const int c = b0 + n0 + 2 * q;
#pragma unroll
      for (int p = 0; p < kFwdPass; ++p) {
        if (t + p >= t1) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = m0 + g + 8 * h;
          if (o >= co_n) continue;
          float* dst = out + ((long long)(t + p) * Co + o) * B + c;
          if (c < B) dst[0] = acc[p][2 * h];
          if (c + 1 < B) dst[1] = acc[p][2 * h + 1];
        }
      }
    }
    hk::cp_async_wait_all();
    __syncthreads();  // the next pass's rows are in; this pass's are free
  }
}

// Element (i, c) of a bf16 row of kFwdCols columns in a ring slot (the
// bf16 backward's g and x rows): the two 8-value halves swapped on rows
// 4..7 mod 8, so that 2-byte reads of rows 2q and 2q+1 at column g meet
// 16 distinct banks, two lanes to a word; 8-value groups (a 16-byte copy)
// stay together.
__device__ __forceinline__ int ring16_at(int i, int c) {
  return i * kFwdCols + (c ^ (((i >> 2) & 1) << 3));
}

// K3 forward in bf16 storage (x, W and out bf16), convt1d_tm_fwd_bf16_kernel:
// out[t] = W_flat window_t on bf16 mma.sync m16n8k16 with float32
// accumulators (JAX's bf16 dot with a float32 result), each output
// rounded to bf16 once, after the whole reduction.
//
// What bounds it: at the bs-8 sites ~3.7 GFLOP and ~15 MB a launch, 3.7 us
// of the tensor cores and 4.6 us of bytes. Its first design, the
// float32 kernel's blocks with bf16 operands, took 31.5 us there and 29
// us at the bs-1 freq site (PERF.md): x rows were copied value by value
// where B is odd, a block held 16 columns and loaded all of W_flat for a
// single pass at bs 1 (64 blocks on 132 SMs), B fragments were four 2-byte
// reads and two packs, outputs 2-byte stores, and the copies ran one pass
// ahead with a wait for all of them every pass.
//
// The design. A block keeps W_flat's rows of `mb` output channels (64, 32
// or 16; W_flat[o][j C_in' + i] = W[j][co0 + o][ci0 + i], rows of K C_in'
// + 8 bf16) in shared memory and walks work items: an item is one pass of
// kFwd16Pass output steps for one tile of `nc` batch columns (32 or 16).
// The items of a grid row (one slice of the input channels and one block
// of output channels, blockIdx.z) are split into gridDim.x equal runs in
// tile-major order, so that the grid fills the card however the batch
// divides (ops/convt_tm.fwd_bf16_geometry); a block loads W once and
// walks its run, the passes of one tile in a row. x rows ([i][column],
// rows of nc + 8 bf16) pass through a ring of K - 1 + kFwd16Stages
// kFwd16Pass slots: the copies of a pass's rows are one commit group,
// issued two passes ahead and waited for a pass behind (cp.async.
// wait_group 1), one barrier a pass. A copy is vec values (the largest of
// 8, 4, 2 dividing B); where B is odd a row of a channel starts anywhere
// in a 16-byte block, so it is copied as the nc / 8 + 1 aligned 16-byte
// blocks from the one that holds its first value, and realigned in place
// after its wait (a thread a row of a channel: five word reads and one
// 16-byte store per 8 values): no copy is of one value. Warp (wm, wn) owns output channels 16
// wm .. + 15 and columns 16 wn .. + 15 for every step of a pass: tap j's
// A fragment (ldmatrix from W_flat) serves all kFwd16Pass steps and both
// n8 tiles, and step t + p at tap j reads the x row that step t + p - 1
// read at tap j - 1, so one ldmatrix .trans a tap brings the new row's B
// fragments and the rest pass on in registers: 16 mma.sync a pair of
// ldmatrix. Outputs go through a 16 x 16 bf16 tile of the warp's own in
// shared memory and leave as 16-byte stores (vec values where B is not a
// multiple of 8), a step at a time. Wider channels are split over the
// grid's z as in the float32 kernel: input channels in the fewest equal
// slices (multiples of 16) whose W_flat and ring fit, each writing a
// float32 partial of out, which convt1d_tm_sum_bf16_kernel adds in order
// and rounds once; one slice (C_in <= 64 at k 8, the presets') writes out.
constexpr int kFwd16Pass = 8;
constexpr int kFwd16Stages = 3;
constexpr int kFwd16Cols = 32;
// the staging tile a warp: 16 rows of 16 outputs + 8 (48 bytes)
constexpr int kFwd16Stage = 24;
// the warps a block at least (the copies' issue: a thread's copies are
// issued one after another, so more threads copy faster): 4 where two
// blocks share an SM (their registers: ~195 a thread), 8 where a block
// holds it alone
constexpr int kFwd16MinWarps = 4;
constexpr int kFwd16SoloWarps = 8;

// Shared memory of the bf16 forward in bytes at ci input channels, mb
// output channels and nc columns a block: W_flat (mb rows of K C_in' + 8,
// C_in' = ci padded to 16), the ring of K - 1 + kFwd16Stages kFwd16Pass x
// rows (C_in' x (nc + 8) each) and each warp's staging tile.
__host__ __device__ __forceinline__ int fwd_bf16_smem_bytes(int K, int ci,
                                                            int mb, int nc) {
  const int cp = round_up(ci, 16);
  return 2 * (mb * (K * cp + 8) +
              (K - 1 + kFwd16Stages * kFwd16Pass) * cp * (nc + 8) +
              (mb / 16) * (nc / 16) * 16 * kFwd16Stage);
}

// grid (blocks, 1, n_in * n_out), 32 max(4 or 8, (mb / 16) (nc / 16))
// threads (warps past the tile's only copy: a small tile's few warps would
// take its copies' issue alone); n_in =
// ceil(Ci / ci_slice) slices of the input channels, n_out = ceil(Co / mb)
// blocks of the output channels. Block (x, 0, z) takes input channels
// ci0 .. ci0 + ci_slice - 1 (ci0 = (z % n_in) ci_slice) and output
// channels co0 .. co0 + mb - 1 (co0 = (z / n_in) mb), and items [x items
// / blocks, (x + 1) items / blocks) of the items = ceil(B / nc) tiles x
// ceil((L + K - 1) / kFwd16Pass) passes, item = tile * passes + pass,
// writing out (or its partial z % n_in where n_in > 1) at those columns
// and steps. KT > 0 fixes the tap count (the preset's 8) so that the tap
// loop unrolls and the B fragments pass on by register renaming.
template <int KT>
__global__ void __launch_bounds__(kThreads)
convt1d_tm_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x16,
                           const __nv_bfloat16* __restrict__ w16,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ part, int L, int Ci, int Co,
                           int k_taps, int B, int nc, int mb, int ci_slice) {
  extern __shared__ float4 smem4[];
  constexpr int P = kFwd16Pass;
  const int K = KT > 0 ? KT : k_taps;
  const int n_in = (Ci + ci_slice - 1) / ci_slice;
  const int ci0 = blockIdx.z % n_in * ci_slice;
  const int co0 = blockIdx.z / n_in * mb;
  const int ci_n = min(ci_slice, Ci - ci0), co_n = min(mb, Co - co0);
  const int cp = round_up(ci_n, 16), kt = K * cp, ws = kt + 8, xs = nc + 8;
  const int slots = K - 1 + kFwd16Stages * P, slot_len = cp * xs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  unsigned short* w_s = reinterpret_cast<unsigned short*>(smem4);
  unsigned short* ring = w_s + mb * ws;  // (slots, cp, xs)
  unsigned short* stage = ring + slots * slot_len + warp * 16 * kFwd16Stage;
  const int t_out = L + K - 1, passes = (t_out + P - 1) / P;
  const int tiles = (B + nc - 1) / nc, items = tiles * passes;
  const int it0 = (int)((long long)blockIdx.x * items / gridDim.x);
  const int it1 = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const int vx = B % 8 == 0 ? 8 : B % 4 == 0 ? 4 : B % 2 == 0 ? 2 : 1;
  const int vw = Ci % 8 == 0 ? 8 : Ci % 4 == 0 ? 4 : Ci % 2 == 0 ? 2 : 1;
  const unsigned short* x =
      reinterpret_cast<const unsigned short*>(x16) + (long long)ci0 * B;
  const unsigned short* x_all = reinterpret_cast<const unsigned short*>(x16);
  const long long x_total = (long long)L * Ci * B;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(w16) +
                            (long long)co0 * Ci + ci0;
  const bool split = n_in > 1;
  float* pz = split ? part + (long long)(blockIdx.z % n_in) * t_out * Co * B
                    : nullptr;
  const int segb = nc / 8 + 1;  // 16-byte blocks of a raw channel row

  // W_flat, zero-padded, one copy of vw values each
  for (int e = vw * tid; e < mb * kt; e += vw * nthreads) {
    const int o = e / kt, j = e % kt / cp, i = e % cp;
    const bool ok = o < co_n && i < ci_n;
    hk::copy_bf16(w_s + o * ws + e % kt,
                  ok ? w + ((long long)j * Co + o) * Ci + i : w, vw, ok);
  }

  // x rows r0 .. r1 - 1 of column tile b0 (zero outside [0, L), past the
  // slice and past B) into their slots, every thread of the block copying;
  // where B is odd, each channel row's nc / 8 + 1 aligned 16-byte blocks
  // from the one holding its first value (realigned later)
  const int lnc = __ffs(nc) - 1, lvx = __ffs(vx) - 1;
  auto load_rows = [&](int r0, int r1, int b0) {
    if (vx > 1) {
      const int per_row = (cp * nc) >> lvx;  // copies a row
      for (int e = tid; e < (r1 - r0) * per_row; e += nthreads) {
        const int rr = e / per_row, f = (e - rr * per_row) << lvx;
        const int r = r0 + rr, i = f >> lnc, c = f & (nc - 1);
        const bool ok = r >= 0 && r < L && i < ci_n && b0 + c < B;
        hk::copy_bf16(ring + (r + slots) % slots * slot_len + i * xs + c,
                      ok ? x + ((long long)r * Ci + i) * B + b0 + c : x, vx,
                      ok);
      }
    } else {
      for (int e = tid; e < (r1 - r0) * cp * segb; e += nthreads) {
        const int rs = e / segb, m = e - rs * segb;
        const int rr = rs / cp, i = rs - rr * cp, r = r0 + rr;
        const bool on = r >= 0 && r < L && i < ci_n;
        const long long v0 =
            ((((long long)r * Ci + ci0 + i) * B + b0) & ~7LL) + 8 * m;
        const long long left = x_total - v0;
        const int bytes = !on ? 0 : left >= 8 ? 16 : left > 0 ? 2 * left : 0;
        hk::cp_async16_n(ring + (r + slots) % slots * slot_len + i * xs + 8 * m,
                         bytes ? x_all + v0 : x_all, bytes);
      }
    }
  };
  // B odd: rows r0 .. r1 - 1 realigned in place, a thread a channel row:
  // value c of the row is block value c + sh (sh its first value's place
  // in its 16-byte block, 0-7), zero outside [0, L), past the slice and
  // past B; 8 values at a time, in order, each reading the five words from
  // the one that holds value c8 + sh before writing four
  auto realign = [&](int r0, int r1, int b0) {
    for (int e = tid; e < (r1 - r0) * cp; e += nthreads) {
      const int r = r0 + e / cp, i = e % cp;
      uint32_t* row = reinterpret_cast<uint32_t*>(
          ring + (r + slots) % slots * slot_len + i * xs);
      const bool on = r >= 0 && r < L && i < ci_n;
      const int sh = on ? (int)((((long long)r * Ci + ci0 + i) * B + b0) & 7)
                        : 0;
      for (int c8 = 0; c8 < nc; c8 += 8) {
        uint32_t v[5], o[4];
#pragma unroll
        for (int m = 0; m < 5; ++m) v[m] = row[(c8 + sh) / 2 + m];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t pair = sh & 1 ? __funnelshift_r(v[m], v[m + 1], 16) : v[m];
          const int c = b0 + c8 + 2 * m;
          if (!on || c >= B) pair = 0;
          else if (c + 1 >= B) pair &= 0xffffu;
          o[m] = pair;
        }
        *reinterpret_cast<uint4*>(row + c8 / 2) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  };

  // warps past the tile's (mb / 16) (nc / 16) only copy
  const bool computes = warp < (mb / 16) * (nc / 16);
  const int wm = warp % (mb / 16), wn = warp / (mb / 16) % (nc / 16);
  const int m0 = wm * 16, n0 = wn * 16;
  const int g = hk::lane_g(), q = hk::lane_q();
  const int lm = lane >> 3, lr = lane & 7;
  const int lo = lr + 8 * (lm & 1), hi = 8 * (lm >> 1);
  // the lane's ldmatrix rows: A (W_flat [o][k]: o 0, 8, 0, 8 x k 0, 0, 8,
  // 8) and B (.trans, an x row's [i][column]: i 0, 8, 0, 8 x columns 0,
  // 0, 8, 8)
  const unsigned a_at = hk::smem_u32(w_s + (m0 + lo) * ws + hi);
  const unsigned ring_at = hk::smem_u32(ring + lo * xs + n0 + hi);

  int it = it0;
  while (it < it1) {
    // a segment: passes p0 .. p1 - 1 of one tile
    const int tile = it / passes, p0 = it % passes;
    const int p1 = min(passes, p0 + (it1 - it));
    it += p1 - p0;
    const int b0 = tile * nc;
    __syncthreads();  // every warp is done with the last segment's ring
    // passes p0 .. p0 + kFwd16Stages - 2 in flight, one group each (the
    // first with W_flat at the block's first segment, and the window's
    // K - 1 rows before it)
    load_rows(p0 * P - K + 1, p0 * P + P, b0);
    hk::cp_async_commit();
#pragma unroll
    for (int d = 1; d < kFwd16Stages - 1; ++d) {
      if (p0 + d < p1) load_rows((p0 + d) * P, (p0 + d + 1) * P, b0);
      hk::cp_async_commit();
    }
    for (int pass = p0; pass < p1; ++pass) {
      const int t = pass * P;
      hk::cp_async_wait<kFwd16Stages - 2>();  // this thread's copies of it
      __syncthreads();  // everyone's; pass - 1 is done with its rows
      if (vx == 1) {
        realign(pass == p0 ? t - K + 1 : t, t + P, b0);
        __syncthreads();
      }
      // the slots of rows t - P - K + 1 .. t - K, which pass - 1 read
      const int ahead = pass + kFwd16Stages - 1;
      if (ahead < p1) load_rows(ahead * P, ahead * P + P, b0);
      hk::cp_async_commit();
      if (!computes || m0 >= co_n) continue;  // uniform over the warp
      float acc[P][2][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[p][nt][v] = 0.f;
      const int s_t = (t + slots) % slots;  // row t's slot
      for (int i0 = 0; i0 < cp; i0 += 16) {
        const unsigned i_at = ring_at + 2 * i0 * xs;
        // B fragments of row t + p (step p >= 1 at tap 0)
        uint32_t xb[P][4];
#pragma unroll
        for (int p = 1; p < P; ++p) {
          const int sp = s_t + p < slots ? s_t + p : s_t + p - slots;
          hk::ldsm_x4_trans_at(xb[p], i_at + 2 * sp * slot_len);
        }
        int sj = s_t;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          uint32_t a[4];
          hk::ldsm_x4_at(a, a_at + 2 * (j * cp + i0));
          hk::ldsm_x4_trans_at(xb[0], i_at + 2 * sj * slot_len);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            hk::mma_bf16(acc[p][0], a, {xb[p][0], xb[p][1]});
            hk::mma_bf16(acc[p][1], a, {xb[p][2], xb[p][3]});
          }
#pragma unroll
          for (int p = P - 1; p > 0; --p)
#pragma unroll
            for (int v = 0; v < 4; ++v) xb[p][v] = xb[p - 1][v];
          sj = sj == 0 ? slots - 1 : sj - 1;
        }
      }
      // D (row o, column): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3
      if (split) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (t + p >= t_out) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = m0 + g + 8 * h, c = b0 + n0 + 8 * nt + 2 * q;
              if (o >= co_n) continue;
              float* dst = pz + ((long long)(t + p) * Co + co0 + o) * B + c;
              if (c < B) dst[0] = acc[p][nt][2 * h];
              if (c + 1 < B) dst[1] = acc[p][nt][2 * h + 1];
            }
        }
        continue;
      }
      // the warp's 16 x 16 tile of a step, rounded, through its staging
      // tile: lane l then stores row l / 2's columns 8 (l % 2) .. + 7, vx
      // values a store
      const int srow = lane >> 1, scol = 8 * (lane & 1);
      const int o_st = m0 + srow, c_st = b0 + n0 + scol;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (t + p >= t_out) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                acc[p][nt][2 * h], acc[p][nt][2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                stage + (g + 8 * h) * kFwd16Stage + 8 * nt + 2 * q) = v2;
          }
        __syncwarp();
        const uint4 chunk =
            *reinterpret_cast<const uint4*>(stage + srow * kFwd16Stage + scol);
        if (o_st < co_n) {
          unsigned short* dst = reinterpret_cast<unsigned short*>(out) +
                                ((long long)(t + p) * Co + co0 + o_st) * B +
                                c_st;
          const uint32_t w4[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
          if (vx == 8) {
            if (c_st < B) *reinterpret_cast<uint4*>(dst) = chunk;
          } else if (vx == 4) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (c_st + 4 * m < B)
                *reinterpret_cast<uint2*>(dst + 4 * m) =
                    make_uint2(w4[2 * m], w4[2 * m + 1]);
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (c_st + 2 * m >= B) break;
              if (vx == 2) {
                *reinterpret_cast<uint32_t*>(dst + 2 * m) = w4[m];
              } else {
                dst[2 * m] = (unsigned short)(w4[m] & 0xffffu);
                if (c_st + 2 * m + 1 < B)
                  dst[2 * m + 1] = (unsigned short)(w4[m] >> 16);
              }
            }
          }
        }
        __syncwarp();
      }
    }
  }
  hk::cp_async_wait_all();
}

// out[e] = bf16(sum_{p < n_parts} part[p][e]), p in order, rounded once.
__global__ void convt1d_tm_sum_bf16_kernel(const float* __restrict__ part,
                                           __nv_bfloat16* __restrict__ out,
                                           int n_parts, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(long long)p * n + e];
  out[e] = __float2bfloat16_rn(s);
}

// Shared memory of the dx kernel in floats at co_slice output channels a
// block: W's slice (K*co_slice rows of kMaxIn), the ring of K+1 g rows
// (co_slice x kDxCols each), the tap groups' exchange tiles.
__host__ __device__ __forceinline__ int dx_smem_floats(int K, int co_slice) {
  return K * co_slice * kMaxIn + (K + 1) * co_slice * kDxCols
         + (kDxGroups - 1) * kMaxIn * kDxCols;
}

// grid (ceil(B / kDxCols), ceil(L / steps), n_in * n_out), kThreads
// threads; n_in = ceil(Ci / kMaxIn) slices of the input channels, n_out =
// ceil(Co / co_slice) of the output channels (the reduction). Block
// (tile, run, z) writes dx[l][ci0 .. ci0+63][b0 .. b0+31] (ci0 = (z %
// n_in) kMaxIn) for l in [run * steps, min(L, (run + 1) * steps)), summed
// over output channels co0 .. co0 + co_slice - 1 (co0 = (z / n_in)
// co_slice), into dx's partial z / n_in (dx itself where n_out is 1).
// Thread tid: group q = tid / 64 takes the
// taps j = q, q + 4, ...; within a group, (tx, ty) = (tid % 8, tid % 64 /
// 8) owns C_in rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3. Group 0
// adds the others' tiles in order and writes dx.
__global__ void __launch_bounds__(kThreads)
convt1d_tm_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                     float* __restrict__ dx, int L, int Ci, int Co, int K,
                     int B, int steps, int co_slice) {
  extern __shared__ float4 smem4[];
  const int n_in = (Ci + kMaxIn - 1) / kMaxIn;
  const int ci0 = blockIdx.z % n_in * kMaxIn;
  const int co0 = blockIdx.z / n_in * co_slice;
  const int ci_n = min(kMaxIn, Ci - ci0), co_n = min(co_slice, Co - co0);
  float* w_s = reinterpret_cast<float*>(smem4);  // w_s[j*co_n + o][i]
  float* ring = w_s + K * co_slice * kMaxIn;     // (K+1, co_n, kDxCols)
  float* red = ring + (K + 1) * co_slice * kDxCols;  // (groups-1, kMaxIn,
                                                     // kDxCols)
  const int tid = threadIdx.x, grp = tid >> 6;
  const int tx = tid & 7, ty = (tid & 63) >> 3;
  const int b0 = blockIdx.x * kDxCols;
  const int l0 = blockIdx.y * steps, l1 = min(L, l0 + steps);
  const int slot_len = co_n * kDxCols;
  g += (long long)co0 * B;  // g[r][co0 + o][b] at g[(r Co + o) B + b]
  w += (long long)co0 * Ci + ci0;  // W[j][co0 + o][ci0 + i]
  dx += (long long)(blockIdx.z / n_in) * L * Ci * B + (long long)ci0 * B;

  // g row r (co_n x the tile's columns) into its ring slot r % (K+1)
  auto load_row = [&](int r) {
    float* dst = ring + (r % (K + 1)) * slot_len;
    const float* src = g + (long long)r * Co * B + b0;
    for (int e = tid; e < slot_len; e += kThreads) {
      const int o = e / kDxCols, c = e % kDxCols;
      const bool ok = b0 + c < B;
      cp_async4(dst + e, ok ? src + (long long)o * B + c : g, ok);
    }
  };
  // W's slice, rows padded with zeros to kMaxIn, and the first K rows of
  // g, all in flight at once; w_s row jo = j*co_n + o is W[j][co0 + o],
  // row jo of W's (K*Co, Ci) view where one slice takes all of C_out.
  // (On the H100 at the preset, dx took 80 us a call this way, 92 with a
  // tap-by-tap loop and 84 with a division on every row.)
  const int gap = Co - co_n;
  if (Ci % 4 == 0) {  // ci0 is a multiple of kMaxIn
    for (int e = 4 * tid; e < K * co_n * kMaxIn; e += 4 * kThreads) {
      const int i = e % kMaxIn, jo = e / kMaxIn;
      const int row = gap ? jo + jo / co_n * gap : jo;
      const bool ok = i < ci_n;
      cp_async16(w_s + e, ok ? w + (long long)row * Ci + i : w, ok);
    }
  } else {
    for (int e = tid; e < K * co_n * kMaxIn; e += kThreads) {
      const int i = e % kMaxIn, jo = e / kMaxIn;
      const int row = gap ? jo + jo / co_n * gap : jo;
      const bool ok = i < ci_n;
      cp_async4(w_s + e, ok ? w + (long long)row * Ci + i : w, ok);
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
      const float* wr = w_s + j * co_n * kMaxIn + 8 * ty;
#pragma unroll 4
      for (int o = 0; o < co_n; ++o) {
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
        if (i >= ci_n) continue;
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
convt1d_tm_wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                        float* __restrict__ part, int L, int Ci, int Co,
                        int K, int B, int cols) {
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

// Ring slots of the bf16 backward kernel: g rows (the passes in the ring
// and a window of kDwTaps - 1 more) and x rows; W's rows (a tap and an
// output channel) of kDwIn + 8 bf16 (80 bytes: the 8 rows of an
// ldmatrix matrix meet 8 distinct 16-byte bank groups); the dx tile a
// warp rounds and writes (16 input channels x 16 columns, rows of 24 bf16)
constexpr int kDwSlotsG = kDwStages * kDwPass + kDwTaps - 1;
constexpr int kDwSlotsX = kDwStages * kDwPass;
constexpr int kDwWRow = kDwIn + 8;
constexpr int kDwDxRow = 24;

// Shared memory of the bf16 backward kernel in bytes: its ring of g rows
// (kDwOut channels) and of x rows (kDwIn), kFwdCols columns each, W's
// kDwTaps kDwOut rows and the warps' dx tiles.
__host__ __device__ __forceinline__ int bwd_bf16_smem_bytes() {
  return 2 * (kFwdCols * (kDwSlotsG * kDwOut + kDwSlotsX * kDwIn)
              + kDwTaps * kDwOut * kDwWRow
              + kDwThreads / 32 * 16 * kDwDxRow);
}

// n (at most 8) bf16 values from shared memory to dst, as copies of w
// values (w the largest of 8, 4, 2, 1 dividing dst's element offset e,
// 16-, 8-, 4- or 2-byte stores), value by value where fewer than w are
// left.
__device__ __forceinline__ void store_bf16_n(unsigned short* dst,
                                             const unsigned short* src,
                                             long long e, int n) {
  const int a = (int)(e & 7);
  const int w = a == 0 ? 8 : (a & 3) == 0 ? 4 : (a & 1) == 0 ? 2 : 1;
  for (int s = 0; s < n; s += w) {
    if (s + w > n) {
      for (int v = s; v < n; ++v) dst[v] = src[v];
    } else if (w == 8) {
      *reinterpret_cast<uint4*>(dst + s) =
          *reinterpret_cast<const uint4*>(src + s);
    } else if (w == 4) {
      *reinterpret_cast<uint2*>(dst + s) =
          *reinterpret_cast<const uint2*>(src + s);
    } else if (w == 2) {
      *reinterpret_cast<uint32_t*>(dst + s) =
          *reinterpret_cast<const uint32_t*>(src + s);
    } else {
      dst[s] = src[s];
    }
  }
}

// K3's bf16 backward on the tensor cores, dx and dW in one walk of a
// window of g rows over l:
//   dx[l][i][b]        = sum_j sum_o W[j][o][i] g[l + j][o][b]
//   part[z][j][o][i]   = sum_{l in [l0, l1)} sum_{c < 16, b0 + c < B}
//                        g[l + j][o][b0 + c] x[l][i][b0 + c]
// for the block's column tile b0 = 16 (z % ceil(B / 16)) and run of l
// steps [l0, l1), l0 = lsteps (z / ceil(B / 16)). Both products need g
// rows l .. l + K - 1 at step l, so going from l to l + 1 the block needs
// one new g row (and the x row l for dW): g and x are each read once a
// block (g's window of K - 1 rows once more a run), where dx and dW apart
// would read g twice. The rows are copied as they lie (b fastest) into a
// ring (ring16_at's swizzle) and every fragment is one ldmatrix. grid
// (ceil(Ci / kDwIn), ceil(K / kDwTaps) ceil(Co / kDwOut), ceil(B / 16)
// ceil(L / lsteps)), kDwThreads threads, passes of kDwPass l steps,
// kDwStages - 1 of them in flight.
// - dW: warp w the tap j0 + w / 2 and output channels o0 + 32 (w % 2) +
//   [0, 32) against the block's kDwIn input channels, 2 m16 x 4 n8
//   fragments, one bf16 mma.sync.m16n8k16 each an l (K-contiguous A from
//   the g row, B from the x row, both untransposed), exactly JAX's bf16
//   dot with a float32 result. The tensor core's accumulators round
//   toward zero, so they are added to float32 registers every pass and
//   zeroed (pw-wgrad's flush). One float32 partial a block, written
//   through shared memory in 16-byte stores of whole rows.
// - dx: warp w the step lp + w / 2 of the pass and input channels 16 (w %
//   2) + [0, 16), 2 n8 fragments over the 16 columns, summed over the
//   block's taps and output channels in k16 steps (A = W^T by
//   ldmatrix.trans from W's rows as they lie, B = the g row l + j by
//   ldmatrix.trans), float32 and rounded once to bf16 as the Pallas
//   kernel's dx; where K or C_out is split over the grid (more than
//   kDwTaps taps or kDwOut channels), the block writes a float32 partial
//   of dx instead (dx_part, one a grid row y), which
//   convt1d_tm_sum_bf16_kernel adds in order and rounds once.
// What costs time at these sizes is issuing instructions more than the
// tensor cores: the copies take fixed channels and halves of rows a
// thread, and the fragments' shared addresses step by adds.
__global__ void __launch_bounds__(kDwThreads)
convt1d_tm_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ g16,
                           const __nv_bfloat16* __restrict__ w16,
                           const __nv_bfloat16* __restrict__ x16,
                           __nv_bfloat16* __restrict__ dx16,
                           float* __restrict__ dx_part,
                           float* __restrict__ part, int L, int Ci, int Co,
                           int K, int B, int lsteps) {
  extern __shared__ float4 smem4[];
  constexpr int kSlotG = kDwOut * kFwdCols, kSlotX = kDwIn * kFwdCols;
  unsigned short* gring = reinterpret_cast<unsigned short*>(smem4);
  unsigned short* xring = gring + kDwSlotsG * kSlotG;
  unsigned short* wt = xring + kDwSlotsX * kSlotX;  // (kDwTaps kDwOut, kDwWRow)
  unsigned short* dxs = wt + kDwTaps * kDwOut * kDwWRow;
  const unsigned short* g = reinterpret_cast<const unsigned short*>(g16);
  const unsigned short* w = reinterpret_cast<const unsigned short*>(w16);
  const unsigned short* x = reinterpret_cast<const unsigned short*>(x16);
  unsigned short* dx = reinterpret_cast<unsigned short*>(dx16);
  const int tap_tiles = (K + kDwTaps - 1) / kDwTaps, nb = (B + 15) / 16;
  const bool split = gridDim.y > 1;  // dx summed over the grid's rows y
  const int i0 = blockIdx.x * kDwIn;
  const int j0 = blockIdx.y % tap_tiles * kDwTaps;
  const int o0 = blockIdx.y / tap_tiles * kDwOut;
  const int b0 = blockIdx.z % nb * 16;
  const int l0 = blockIdx.z / nb * lsteps, l1 = min(L, l0 + lsteps);
  const int nj = min(kDwTaps, K - j0), no = min(kDwOut, Co - o0);
  const int ni = min(kDwIn, Ci - i0);
  const int n_pass = (l1 - l0 + kDwPass - 1) / kDwPass;
  const int tid = threadIdx.x;

  // the copies: thread tid takes the 8-value half tid % 2 of channel
  // (tid / 2) % C of every row r = tid / (2 C) mod kDwThreads / (2 C) of a
  // pass, C kDwOut for g and kDwIn for x; a half goes as copies of w
  // values, w the largest of 8, 4, 2, 1 to which its first element's
  // offset is aligned (16-, 8-, 4-byte cp.async; plain loads where it is
  // odd), zero past B and past the block's channels
  const int h = tid & 1, cg = (tid >> 1) % kDwOut, cx = (tid >> 1) % kDwIn;
  const int c0 = b0 + 8 * h;
  const int left_g = cg < no ? min(8, B - c0) : 0;
  const int left_x = cx < ni ? min(8, B - c0) : 0;
  const int dst_g = ring16_at(cg, 8 * h), dst_x = ring16_at(cx, 8 * h);
  auto copy_half = [&](unsigned short* dst, const unsigned short* base,
                       long long e0, int left) {
    const int a = (int)(e0 & 7);
    const int wv = a == 0 ? 8 : (a & 3) == 0 ? 4 : (a & 1) == 0 ? 2 : 1;
    for (int s = 0; s < 8; s += wv) {
      const int n = min(wv, max(0, left - s));
      hk::copy_bf16_n(dst + s, n > 0 ? base + e0 + s : base, wv, n);
    }
  };
  // W's rows (tap j0 + j, output channel o0 + o) of the block's input
  // channels, four 8-value chunks each, zero past them, with pass 0
  for (int u = tid; u < kDwTaps * kDwOut * 4; u += kDwThreads) {
    const int row = u >> 2, c = u & 3, j = row / kDwOut, o = row % kDwOut;
    const bool ok = j < nj && o < no;
    copy_half(wt + row * kDwWRow + 8 * c, w,
              ok ? ((long long)(j0 + j) * Co + o0 + o) * Ci + i0 + 8 * c : 0,
              ok ? min(8, ni - 8 * c) : 0);
  }
  // pass p's rows into their slots, one commit group (empty past the
  // last): the x rows of its l steps and the g rows it is the first to
  // need (in the first pass its whole window, later the kDwPass rows past
  // the previous pass's)
  auto load_pass = [&](int p) {
    if (p < n_pass) {
      const int lp = l0 + p * kDwPass, le = min(l1, lp + kDwPass);
      const int r0 = p == 0 ? lp + j0 : lp + j0 + nj - 1;
      const int r1 = le + j0 + nj - 1;
      for (int r = r0 + tid / (2 * kDwOut); r < r1;
           r += kDwThreads / (2 * kDwOut))
        copy_half(gring + r % kDwSlotsG * kSlotG + dst_g, g,
                  ((long long)r * Co + o0 + cg) * B + c0, left_g);
      for (int r = lp + tid / (2 * kDwIn); r < le;
           r += kDwThreads / (2 * kDwIn))
        copy_half(xring + r % kDwSlotsX * kSlotX + dst_x, x,
                  ((long long)r * Ci + i0 + cx) * B + c0, left_x);
    }
    hk::cp_async_commit();
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g_ = hk::lane_g(), q = hk::lane_q();
  const int jj = warp >> 1, oh = 32 * (warp & 1);
  const bool active = jj < nj && oh < no;  // dW, uniform over the warp
  const int sd = warp >> 1, mi_d = warp & 1;  // dx: step, channel half
  const bool active_dx = 16 * mi_d < ni;
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8. dW's A
  // matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15) row half first, B's
  // (x rows 0-7 | 8-15, an n8 fragment each) x (columns 0-7 | 8-15) column
  // half first; dx's (.trans) A (W's rows, k, 0-7 | 8-15) x (columns, m,
  // 0-7 | 8-15) column half first, B (g's rows, k, 0-7 | 8-15) x (columns,
  // n, 0-7 | 8-15) row half first. Byte addresses in slot 0, tap 0 and
  // the first 16 output channels; a g slot is kSlotG bf16 further, an x
  // slot kSlotX, 16 channels 16 rows.
  const int mt = lane >> 3, rr = lane & 7;
  const unsigned a_base = hk::smem_u32(gring);
  const unsigned b_base = hk::smem_u32(xring);
  const unsigned a_at0 =
      a_base + 2 * ring16_at(oh + rr + 8 * (mt & 1), 8 * (mt >> 1));
  const unsigned a_at1 =
      a_base + 2 * ring16_at(oh + 16 + rr + 8 * (mt & 1), 8 * (mt >> 1));
  const unsigned b_at0 = b_base + 2 * ring16_at(rr + 8 * (mt >> 1), 8 * (mt & 1));
  const unsigned b_at1 =
      b_base + 2 * ring16_at(16 + rr + 8 * (mt >> 1), 8 * (mt & 1));
  const unsigned dxa_at = hk::smem_u32(
      wt + (rr + 8 * (mt >> 1)) * kDwWRow + 16 * mi_d + 8 * (mt & 1));
  const unsigned dxb_at = a_base + 2 * ring16_at(rr + 8 * (mt & 1), 8 * (mt >> 1));
  unsigned short* dx_tile = dxs + warp * 16 * kDwDxRow;
  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) sum[a][b][v] = 0.f;

  for (int p = 0; p < kDwStages - 1; ++p) load_pass(p);
  for (int p = 0; p < n_pass; ++p) {
    hk::cp_async_wait<kDwStages - 2>();
    __syncthreads();  // pass p is in; every warp is done with pass p - 1,
                      // whose slots pass p + kDwStages - 1 takes
    load_pass(p + kDwStages - 1);
    const int lp = l0 + p * kDwPass, le = min(l1, lp + kDwPass);
    if (active) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[a][b][v] = 0.f;
      int sg = (lp + j0 + jj) % kDwSlotsG, sx = lp % kDwSlotsX;
      for (int l = lp; l < le; ++l) {
        const unsigned og = 2u * kSlotG * sg, ox = 2u * kSlotX * sx;
        uint32_t a[2][4], b[4][2], t[4];
        hk::ldsm_x4_at(a[0], a_at0 + og);
        hk::ldsm_x4_at(a[1], a_at1 + og);
        hk::ldsm_x4_at(t, b_at0 + ox);
        b[0][0] = t[0];
        b[0][1] = t[1];
        b[1][0] = t[2];
        b[1][1] = t[3];
        hk::ldsm_x4_at(t, b_at1 + ox);
        b[2][0] = t[0];
        b[2][1] = t[1];
        b[3][0] = t[2];
        b[3][1] = t[3];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8)
            hk::mma_bf16(acc[mi][n8], a[mi], b[n8]);
        sg = sg + 1 == kDwSlotsG ? 0 : sg + 1;
        sx = sx + 1 == kDwSlotsX ? 0 : sx + 1;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int v = 0; v < 4; ++v) sum[a][b][v] += acc[a][b][v];
    }
    const int l = lp + sd;
    if (l < le && active_dx) {  // uniform over the warp
      float d[2][4] = {};
      int sj = (l + j0) % kDwSlotsG;  // g row l + j0 + j
      for (int j = 0; j < nj; ++j) {
        const unsigned ga = dxb_at + 2u * kSlotG * sj;
        const unsigned wa = dxa_at + 2u * kDwOut * kDwWRow * j;
#pragma unroll
        for (int ob = 0; ob < kDwOut / 16; ++ob) {
          uint32_t a[4], t[4];
          hk::ldsm_x4_trans_at(a, wa + 2u * 16 * kDwWRow * ob);
          hk::ldsm_x4_trans_at(t, ga + 2u * 16 * kFwdCols * ob);
          const uint32_t b0_[2] = {t[0], t[1]}, b1_[2] = {t[2], t[3]};
          hk::mma_bf16(d[0], a, b0_);
          hk::mma_bf16(d[1], a, b1_);
        }
        sj = sj + 1 == kDwSlotsG ? 0 : sj + 1;
      }
      // c0 (i g, b 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
      const int ib = i0 + 16 * mi_d;
      if (split) {
        float* out = dx_part + (long long)blockIdx.y * L * Ci * B;
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int i = g_ + 8 * (v >> 1), c = b0 + 8 * n8 + 2 * q + (v & 1);
            if (16 * mi_d + i < ni && c < B)
              out[((long long)l * Ci + ib + i) * B + c] = d[n8][v];
          }
      } else {
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                d[n8][2 * hh], d[n8][2 * hh + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                dx_tile + (g_ + 8 * hh) * kDwDxRow + 8 * n8 + 2 * q) = v2;
          }
        __syncwarp();
        // lane: channel lane / 2, columns 8 (lane % 2) + [0, 8)
        const int i = lane >> 1, c = b0 + 8 * (lane & 1);
        if (16 * mi_d + i < ni && c < B) {
          const long long e = ((long long)l * Ci + ib + i) * B + c;
          store_bf16_n(dx + e, dx_tile + i * kDwDxRow + 8 * (lane & 1), e,
                       min(8, B - c));
        }
      }
    }
  }
  hk::cp_async_wait_all();
  __syncthreads();  // the ring is free: each warp's 32 x 32 dW sums go
                    // through its own tile of it (rows of 36 floats)
  constexpr int kTile = 32 * 36;
  float* tile = reinterpret_cast<float*>(smem4) + warp * kTile;
  if (!active) return;
  // c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
        *reinterpret_cast<float2*>(tile + (16 * mi + g_ + 8 * hh) * 36 + 8 * n8
                                   + 2 * q) =
            make_float2(sum[mi][n8][2 * hh], sum[mi][n8][2 * hh + 1]);
  __syncwarp();
  float* out = part + (((long long)blockIdx.z * K + j0 + jj) * Co + o0 + oh)
                          * Ci + i0;
  const int rows = min(32, no - oh);
  if (ni == kDwIn && Ci % 4 == 0) {  // whole 16-byte-aligned rows
    for (int e = lane; e < rows * 8; e += 32) {
      const int o = e >> 3, c = 4 * (e & 7);
      *reinterpret_cast<float4*>(out + (long long)o * Ci + c) =
          *reinterpret_cast<const float4*>(tile + o * 36 + c);
    }
  } else {
    for (int e = lane; e < rows * 32; e += 32) {
      const int o = e >> 5, c = e & 31;
      if (c < ni) out[(long long)o * Ci + c] = tile[o * 36 + c];
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

// steps: consecutive output steps t per block; ci_slice: input channels
// a block (a multiple of 8, or all of Ci). Where ci_slice < Ci, part
// ((L + K - 1) * Co * B floats a slice of the input channels) is scratch
// for the slices' partial sums, added in order into out; else it may be
// null.
extern "C" int convt1d_ola_tm_fwd(const void* x, const void* w, void* out,
                                  void* part, int L, int Ci, int Co, int K,
                                  int B, int steps, int ci_slice,
                                  void* stream) {
  if (steps < 1 || ci_slice < 1 || (ci_slice < Ci && ci_slice % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_in = ceil_div(Ci, ci_slice), n_out = ceil_div(Co, kMaxOut);
  if (n_in > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  float* dst = n_in > 1 ? (float*)part : (float*)out;
  const size_t smem =
      (size_t)fwd_smem_floats(K, min(ci_slice, Ci), min(Co, kMaxOut)) *
      sizeof(float);
  const void* kernel = K == 8 ? (const void*)convt1d_tm_fwd_kernel<8>
                              : (const void*)convt1d_tm_fwd_kernel<0>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(ceil_div(B, kFwdCols), ceil_div(L + K - 1, steps), n_in * n_out);
  if (K == 8)
    convt1d_tm_fwd_kernel<8><<<grid, kThreads, smem, st>>>(
        (const float*)x, (const float*)w, dst, L, Ci, Co, K, B, steps,
        ci_slice);
  else
    convt1d_tm_fwd_kernel<0><<<grid, kThreads, smem, st>>>(
        (const float*)x, (const float*)w, dst, L, Ci, Co, K, B, steps,
        ci_slice);
  if (n_in > 1) {
    const int n = (L + K - 1) * Co * B;
    convt1d_tm_sum_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
        (const float*)part, (float*)out, n_in, n);
  }
  return (int)cudaGetLastError();
}

// K3 forward in bf16 storage (ops/convt_tm.fwd_bf16_geometry): nc (16 or
// 32) columns and mb (16, 32 or 64) output channels a block, ci_slice
// input channels (a multiple of 16, or all of Ci), `blocks` blocks a grid
// row (each a run of the row's items); part ((L + K - 1) * Co * B float32
// values a slice) is scratch for the partial sums where ci_slice < Ci.
// x and w 16-byte aligned.
extern "C" int convt1d_ola_tm_fwd_bf16(const void* x, const void* w, void* out,
                                       void* part, int L, int Ci, int Co,
                                       int K, int B, int nc, int mb,
                                       int ci_slice, int blocks,
                                       void* stream) {
  if (L < 1 || Ci < 1 || Co < 1 || K < 1 || B < 1 || blocks < 1 ||
      (nc != 16 && nc != kFwd16Cols) || (mb != 16 && mb != 32 && mb != 64) ||
      ci_slice < 1 || (ci_slice < Ci && ci_slice % 16 != 0) ||
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_in = ceil_div(Ci, ci_slice), n_out = ceil_div(Co, mb);
  if (n_in > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)fwd_bf16_smem_bytes(K, min(ci_slice, Ci), mb, nc);
  const void* kernel = K == 8 ? (const void*)convt1d_tm_fwd_bf16_kernel<8>
                              : (const void*)convt1d_tm_fwd_bf16_kernel<0>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks, 1, n_in * n_out);
  const bool solo = 2 * (smem + 1024) > 233472;  // one block an SM
  const int threads = 32 * max(solo ? kFwd16SoloWarps : kFwd16MinWarps,
                               (mb / 16) * (nc / 16));
  if (K == 8)
    convt1d_tm_fwd_bf16_kernel<8><<<grid, threads, smem, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)out, (float*)part, L, Ci, Co, K, B, nc, mb, ci_slice);
  else
    convt1d_tm_fwd_bf16_kernel<0><<<grid, threads, smem, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)out, (float*)part, L, Ci, Co, K, B, nc, mb, ci_slice);
  if (n_in > 1) {
    const int n = (L + K - 1) * Co * B;
    convt1d_tm_sum_bf16_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)out, n_in, n);
  }
  return (int)cudaGetLastError();
}

// dx (L, C_in, B) and dw (K, C_out, C_in); dw_part (ceil(L * B / cols),
// K, C_out, C_in) is scratch: one partial per chunk of cols (l, b) columns.
// steps: consecutive steps l per dx block; co_slice: output channels a dx
// block. Where co_slice < Co, dx_part (L * Ci * B floats a slice of the
// output channels) is scratch for the dx blocks' partial sums, added in
// order into dx; else it may be null.
extern "C" int convt1d_ola_tm_bwd(const void* g, const void* w, const void* x,
                                  void* dx, void* dw, void* dw_part,
                                  void* dx_part, int L, int Ci, int Co, int K,
                                  int B, int steps, int cols, int co_slice,
                                  void* stream) {
  if (steps < 1 || cols < 1 || co_slice < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_in = ceil_div(Ci, kMaxIn), n_out = ceil_div(Co, co_slice);
  if (n_out > 1 && dx_part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)dx_smem_floats(K, min(co_slice, Co)) * sizeof(float);
  cudaError_t e =
      set_smem((const void*)convt1d_tm_dx_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  convt1d_tm_dx_kernel<<<dim3(ceil_div(B, kDxCols), ceil_div(L, steps),
                              n_in * n_out),
                         kThreads, smem, st>>>(
      (const float*)g, (const float*)w,
      n_out > 1 ? (float*)dx_part : (float*)dx, L, Ci, Co, K, B, steps,
      min(co_slice, Co));
  if (n_out > 1) {
    const int n = L * Ci * B;
    convt1d_tm_sum_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
        (const float*)dx_part, (float*)dx, n_out, n);
  }
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

// K3 backward in bf16 storage: g, w and x in, dx and dw out bf16, by
// convt1d_tm_bwd_bf16_kernel over runs of lsteps l steps for each tile of
// 16 columns. dw_part (ceil(B / 16) ceil(L / lsteps), K, C_out, C_in)
// float32, summed in order and rounded once; dx_part (ceil(K / 8)
// ceil(C_out / 64), L, C_in, B) float32 where K or C_out is split over the
// grid (more than 8 taps or 64 output channels), summed in order and
// rounded once, else it may be null. g, w and x 16-byte aligned.
extern "C" int convt1d_ola_tm_bwd_bf16(const void* g, const void* w,
                                       const void* x, void* dx, void* dw,
                                       void* dw_part, void* dx_part, int L,
                                       int Ci, int Co, int K, int B,
                                       int lsteps, void* stream) {
  using bf = __nv_bfloat16;
  if (lsteps < 1 ||
      ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(w) |
        reinterpret_cast<size_t>(x)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_y = ceil_div(K, kDwTaps) * ceil_div(Co, kDwOut);
  if (n_y > 1 && dx_part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_bf16_smem_bytes();
  cudaError_t e = set_smem((const void*)convt1d_tm_bwd_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = ceil_div(B, 16) * ceil_div(L, lsteps);
  convt1d_tm_bwd_bf16_kernel<<<dim3(ceil_div(Ci, kDwIn), n_y, n_chunks),
                               kDwThreads, smem, st>>>(
      (const bf*)g, (const bf*)w, (const bf*)x, (bf*)dx, (float*)dx_part,
      (float*)dw_part, L, Ci, Co, K, B, lsteps);
  if (n_y > 1) {
    const int n = L * Ci * B;
    convt1d_tm_sum_bf16_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
        (const float*)dx_part, (bf*)dx, n_y, n);
  }
  const int n = K * Co * Ci;
  convt1d_tm_sum_bf16_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
      (const float*)dw_part, (bf*)dw, n_chunks, n);
  return (int)cudaGetLastError();
}
