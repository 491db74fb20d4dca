// Fused bidirectional SRU stack kernels for Hopper (sm_90a), float32, and
// the forwards also in bf16 storage (the Pallas kernels run in the
// caller's dtype; bf16 is the JAX package's serving mode).
//
// K1  sru_dual_recurrence_fwd  replaces the Pallas kernel _lay0_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_dual_recurrence);
//     sru_dual_recurrence_fwd_bf16 the same kernel on bf16 operands.
// K1  sru_dual_recurrence_bwd  replaces the Pallas kernel _lay0_bwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from _lay0_vjp_bwd).
// K2  sru_hidden_layer_fwd     replaces the Pallas kernel _hid_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_hidden_layer);
//     sru_hidden_layer_fwd_bf16 the same kernel on bf16 operands,
//     streamed above H 536 as the float32 one is above H 268.
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
// Backward (BPTT): the adjoint scan of csrc/sru_scan.cuh (the adjoints of
// the Pallas kernels, both directions in one launch, each walking its
// steps in reverse scan order), which K4's backward shares. Reductions
// (dv, db, dW) are written as per-block partials and summed in a fixed
// order: no float atomics, so two calls give the same bits.
//
// What bounds them on the H100. K1 moves 20 bytes per (step, unit, column)
// for ~15 flops (its backward 40 bytes for ~35), so by the roofline it is
// bound by memory bytes; the forward in practice by latency, because each
// thread walks T dependent steps and the launch has only 2*H*B threads.
// The design
// keeps c (dc) in a register and makes neighbouring threads read
// neighbouring batch columns (coalesced). None of the loads depends on
// the chain: the forward keeps the cp.async copies of the next kLay0Ahead
// steps in flight, refilling a ring in shared memory as the chain empties
// it, so a step costs the chain's latency (two dependent sigmoid_f, ~275
// ns), not a load's; its blocks (columns x units,
// ops/sru_fused.k1_fwd_geometry) are as small as it takes to spread the
// grid over the SMs, so that at bs 1 the few threads run on many SMs and
// no block is half idle. The backward scan (sru_scan.cuh) is bound by its
// bytes: it keeps each thread's next kScanAhead steps of copies in flight
// in the same kind of ring, with blocks spread the same way
// (ops/sru_fused.scan_bwd_geometry). K2 does 2*3H*2H
// flops per column, step and direction for ~16H bytes, so by the roofline
// it is bound by operations. The projection's input is the previous
// layer's output, complete before the launch, so only c is sequential:
// the forward (sru_hid_fwd_kernel) takes the projection off the per-step
// chain and keeps it on chip. A block owns one direction and a tile of
// bt batch columns, keeps that direction's (3H x 2H) weight slice W_d in
// shared memory, and walks T in chunks of S steps in its scan order
// (t ascending for the forward direction, descending for the reverse one;
// nothing is flipped in memory). Per chunk: cp.async brings the next
// chunk's X = [h_f; h_r] columns (2H x S*bt, column s*bt + c for scan
// step s and batch column c) into one of two slots; the 8 warps form U^T
// = X^T W_d^T (S*bt x 3H, depth 2H) on the tensor cores in 3xTF32
// (tf32x3.cuh) into one of two U slots in shared memory; then one thread
// per (unit, column) walks the chunk's S steps from U with c in a
// register, the highway term (the direction's own input row) read from
// memory kFwdAhead steps ahead, and writes h (and c when training). One
// barrier a chunk. U never goes to device memory. Two blocks an SM at H
// 32, so that one block's product can overlap another's scan. The units
// are independent but for the projection, so where W_d and the chunks do
// not fit one block (H above 68) the grid also splits the units: a block
// owns a slice of them, keeps only the 3 x slice rows of W_d that project
// onto them, reads the whole of X and writes the U rows and h of its units
// alone (H 80 as two slices of 40; one slice, all of H, at every preset).
// Above H 268 not even 8 units' rows of W_d fit beside X's two slots: the
// block then streams the projection's reduction (kFwdK rows of X and
// columns of W_d a stage through a cp.async ring, U summed in shared
// memory), so its shared memory no longer grows with H; the bf16 kernel
// does the same above H 536 (sru_hid_fwd_bf16_kernel<true>).
// ops/sru_fused.k2_fwd_geometry picks bt, S and the slice so that the
// grid fills the card where B allows. The scan's chain (two sigmoids a
// step) and the product take about as long each at bs 8 (PERF.md).
//
// K2's backward is three products and a scan: U = W^T x, dx = W du and
// dW = sum_t du x^T (3 x 2*6H*2H flops a column and step), and the gate
// adjoints. Only the adjoint chain in (c, dc) depends across time steps,
// yet a kernel that walks the products step by step inside that chain
// leaves them latency-bound on a few blocks. So the entry splits the op at
// the recurrence into launches on the caller's stream:
//   1. U for all T*B columns at once (sru_hid_bwd_gemm_kernel), C_t = W^T
//      X_t per step, written to the scratch ud (T, 6H, B);
//   2. the adjoint scan (sru_scan.cuh, sru_scan_bwd_kernel<2>): one
//      thread per (column, unit, direction), as K1's backward, reading U
//      and writing du over it in place and the highway term dh (1 - r)
//      into dx;
//   3. dx += W du for all columns (the same product, W^T read transposed);
//   4. dW by split-K over the T*B columns (sru_hid_bwd_wgrad_kernel): each
//      block a 64 x 64 tile of dW over one chunk of columns, a partial
//      each;
//   5. the dW and (v, b) partials summed in a fixed order
//      (sru_hid_bwd_sum_kernel).
// The products are 64 x 64 tiles of 256 threads, each a 4 x 4 register
// tile, in full float32 on the SIMT units; operand stages of 16 reduction
// rows (U, dx) or 32 columns (dW) in shared memory, the next stage's
// global loads issued into registers before the current stage's FMAs.
// The products are bound by float32 operations, the scan by its bytes.
// Nothing holds dW in registers across the
// sequence, so any H is taken. Scratch: ud, one dW partial a chunk (about
// two blocks an SM), one (v, b) partial a scan block; the wrapper
// allocates them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sru_scan.cuh"
#include "tf32x3.cuh"

namespace {

// K1 forward's threads a block, at most (ops/sru_fused.py mirrors it; the
// backward scans' blocks are sru_scan.cuh's)
constexpr int kLay0Threads = 128;
// K1 forward (ops/sru_fused.py mirrors it): steps whose copies are in
// flight ahead of the recurrence (8 was as fast as 16 and 24)
constexpr int kLay0Ahead = 8;
// K2 backward products (ops/sru_fused.py mirrors them): tiles of kTile x
// kTile outputs, kGemmThreads threads of 4 x 4; kStage reduction rows a
// stage of U and dx, kWgCols (t, b) columns a stage of dW
constexpr int kTile = 64;
constexpr int kGemmThreads = 256;
constexpr int kStage = 16;
constexpr int kWgCols = 32;
// K2 forward (ops/sru_fused.py mirrors them): threads a block; a warp's
// job in the product, kFwdMT m16 tiles of U^T's columns by kFwdNB n8 tiles
// of its rows (each A fragment serves kFwdNB products, each B fragment
// kFwdMT); scan steps whose highway loads are issued together
constexpr int kFwdThreads = 256;
constexpr int kFwdMT = 2;
constexpr int kFwdNB = 3;
constexpr int kFwdAhead = 8;
// K2 forward where W_d's rows of a slice of units and X's two slots do not
// fit one block (H above 268; ops/sru_fused.py mirrors them): the
// projection's reduction streamed kFwdK rows of X and columns of W_d a
// stage through a ring of kFwdStages
constexpr int kFwdK = 32;
constexpr int kFwdStages = 3;
constexpr long long kMaxSmem = 227 * 1024;


// The K2 forward scan's sigmoid: the hardware exp2 and reciprocal, a few
// ulp from sigmoid_f and free of the branch that the IEEE division takes
// on its slow path; it shortens the scan's per-step chain (PERF.md).
// K2's backward recomputes the gates with sigmoid_f from a U of its own,
// formed in SIMT float32 rather than 3xTF32, so it differentiates a
// forward a few ulp from this one (within the gradient gates).
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// grid (ceil(B / cols), ceil(H / units), 2), cols * units threads, cols a
// multiple of 32 (ops/sru_fused.k1_fwd_geometry): thread (column b0 + tid
// % cols, unit j0 + tid / cols, direction blockIdx.z). The step loads go
// through a ring of kLay0Ahead slots in shared memory, each thread its own
// column of it (no thread reads another's, so no barrier): the thread
// keeps the cp.async copies of the next kLay0Ahead steps in flight, one
// commit group a step, waits for step i's group, takes its four values and
// issues step i + kLay0Ahead into the slot they came from. The same ring
// held in registers (plain loads kLay0Ahead steps ahead) was slower at
// bs 8 at every depth tried; cp.async's groups track the copies' arrival
// without holding registers.
__global__ void __launch_bounds__(kLay0Threads)
sru_lay0_fwd_kernel(const float* __restrict__ u_f,
                    const float* __restrict__ u_r,
                    const float* __restrict__ vb, float* __restrict__ h_f,
                    float* __restrict__ h_r, float* __restrict__ c_f,
                    float* __restrict__ c_r, int T, int H, int B, int cols) {
  extern __shared__ float ring[];  // (kLay0Ahead, 4, blockDim.x)
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  const int dir = blockIdx.z;
  if (b >= B || j >= H) return;
  const float* u = dir == 0 ? u_f : u_r;
  float* h = dir == 0 ? h_f : h_r;
  float* cs = dir == 0 ? c_f : c_r;  // null when serving
  const float v_f = vb[(dir * 4 + 0) * H + j];
  const float v_r = vb[(dir * 4 + 1) * H + j];
  const float b_f = vb[(dir * 4 + 2) * H + j];
  const float b_r = vb[(dir * 4 + 3) * H + j];
  const long long row = (long long)H * B;  // one gate block per step
  const long long col = (long long)j * B + b;
  const int nt = blockDim.x;
  float* mine = ring + threadIdx.x;  // slot s, gate row g: mine[(4 s + g) nt]
  // scan step i (t = i forward, T-1-i reverse) into slot i % kLay0Ahead,
  // one commit group (empty past T)
  auto issue = [&](int i) {
    if (i < T) {
      const int t = dir == 0 ? i : T - 1 - i;
      const float* ut = u + (long long)t * 4 * row + col;
      float* d = mine + (i % kLay0Ahead) * 4 * nt;
#pragma unroll
      for (int g = 0; g < 4; ++g) hk::cp_async4(d + g * nt, ut + g * row, true);
    }
    hk::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kLay0Ahead; ++i) issue(i);
  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    hk::cp_async_wait<kLay0Ahead - 1>();  // step i's group is in
    const float* d = mine + (i % kLay0Ahead) * 4 * nt;
    const float a0 = d[0], a1 = d[nt], a2 = d[2 * nt], hw = d[3 * nt];
    const int t = dir == 0 ? i : T - 1 - i;
    const float f = sigmoid_f(a1 + v_f * c + b_f);
    c = f * c + (1.f - f) * a0;
    const float r = sigmoid_f(a2 + v_r * c + b_r);
    h[(long long)t * row + col] = r * c + (1.f - r) * hw;
    if (cs) cs[(long long)t * row + col] = c;
    issue(i + kLay0Ahead);  // into the slot just read (its values used)
  }
}

// K1 forward in bf16 storage (u, vb, h and c bf16; the arithmetic and the
// carry c in float32, only the stored h and c rounded, as the Pallas
// kernel keeps its carries in float32 scratch). cp.async has no 2-byte
// copy, so a thread cannot fetch its own value: a warp, one unit and 32
// consecutive columns b0 .. b0+31 (cols is a multiple of 32), fetches its
// 32 values of a gate row together as the 16-byte blocks that cover them,
// five at most, lanes 0..19 one block each (gate lane / 5, block lane %
// 5), into the warp's ring (kLay0Ahead slots of 4 gate rows of kLay0Span
// values). A row's values start e0 % 8 values into its first block (e0
// the element index of the warp's first value; u's base is 16-byte
// aligned, which the wrapper guarantees), so each lane reads its value
// shifted by that offset; a block that runs past the end of u is read only
// up to the end and zero-filled after it. Each lane still keeps the next
// kLay0Ahead steps' copies in flight, one commit group a step; the warp
// waits for step i's group, meets at a __syncwarp (the other lanes' copies
// are in), reads, meets again (everyone has read the slot) and issues step
// i + kLay0Ahead into it. Lanes past B compute on whatever lies there and
// store nothing.
constexpr int kLay0Span = 40;  // 5 blocks of 8 bf16

__global__ void __launch_bounds__(kLay0Threads)
sru_lay0_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ u_f,
                         const __nv_bfloat16* __restrict__ u_r,
                         const __nv_bfloat16* __restrict__ vb,
                         __nv_bfloat16* __restrict__ h_f,
                         __nv_bfloat16* __restrict__ h_r,
                         __nv_bfloat16* __restrict__ c_f,
                         __nv_bfloat16* __restrict__ c_r, int T, int H, int B,
                         int cols) {
  extern __shared__ __align__(16) unsigned short ring16[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  const int dir = blockIdx.z;
  if (j >= H) return;  // the whole warp: one unit
  const int b0 = b - lane;
  const unsigned short* u = reinterpret_cast<const unsigned short*>(
      dir == 0 ? u_f : u_r);
  __nv_bfloat16* h = dir == 0 ? h_f : h_r;
  __nv_bfloat16* cs = dir == 0 ? c_f : c_r;  // null when serving
  const float v_f = __bfloat162float(vb[(dir * 4 + 0) * H + j]);
  const float v_r = __bfloat162float(vb[(dir * 4 + 1) * H + j]);
  const float b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j]);
  const float b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j]);
  const long long row = (long long)H * B;  // one gate block per step
  const long long total = (long long)T * 4 * row;
  const long long col = (long long)j * B + b0;
  unsigned short* mine = ring16 + warp * kLay0Ahead * 4 * kLay0Span;
  const int cg = lane / 5, ck = lane % 5;  // the lane's gate and block
  // scan step i into slot i % kLay0Ahead, one commit group (empty past T)
  auto issue = [&](int i) {
    if (i < T && lane < 20) {
      const int t = dir == 0 ? i : T - 1 - i;
      const long long e0 = (long long)t * 4 * row + cg * row + col;
      const long long src = (e0 & ~7LL) + 8 * ck;
      const long long left = total - src;
      const int bytes = left >= 8 ? 16 : (left > 0 ? 2 * (int)left : 0);
      hk::cp_async16_n(mine + ((i % kLay0Ahead) * 4 + cg) * kLay0Span + 8 * ck,
                       bytes > 0 ? u + src : u, bytes);
    }
    hk::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kLay0Ahead; ++i) issue(i);
  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    hk::cp_async_wait<kLay0Ahead - 1>();  // step i's group is in
    __syncwarp();                          // and the other lanes'
    const int t = dir == 0 ? i : T - 1 - i;
    const long long e0 = (long long)t * 4 * row + col;
    const unsigned short* d = mine + (i % kLay0Ahead) * 4 * kLay0Span + lane;
    float a[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      a[g] = __bfloat162float(__ushort_as_bfloat16(
          d[g * kLay0Span + (int)((e0 + g * row) & 7)]));
    __syncwarp();           // every lane has read the slot
    issue(i + kLay0Ahead);  // into the slot just read
    const float f = sigmoid_f(a[1] + v_f * c + b_f);
    c = f * c + (1.f - f) * a[0];
    const float r = sigmoid_f(a[2] + v_r * c + b_r);
    if (b < B) {
      h[(long long)t * row + col + lane] =
          __float2bfloat16_rn(r * c + (1.f - r) * a[3]);
      if (cs) cs[(long long)t * row + col + lane] = __float2bfloat16_rn(c);
    }
  }
}

__host__ __device__ __forceinline__ int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Shared memory of the K2 forward in floats, N = S * bt columns a chunk,
// U units a block: W_d's rows of those units (3U rows padded to 8 *
// kFwdNB, of 2H padded to 8, + 4), two X slots (2H' rows of N + 8) and
// two U slots (3U' rows of N + 4).
__host__ __device__ __forceinline__ int hid_fwd_smem_floats(int H, int N,
                                                            int U) {
  const int k8 = round_up(2 * H, 8), rows = round_up(3 * U, 8 * kFwdNB);
  return rows * (k8 + 4) + 2 * k8 * (N + 8) + 2 * rows * (N + 4);
}

// Shared memory of the streamed K2 forward in floats (N columns a chunk, U
// units a block): one U slot (3U' rows of N + 4), then the ring of
// kFwdStages stages, each kFwdK rows of X (of N + 8) and W_d's 3U' rows'
// kFwdK columns (of kFwdK + 4). It does not grow with H.
__host__ __device__ __forceinline__ int hid_fwd_stream_smem_floats(int N,
                                                                   int U) {
  const int rows = round_up(3 * U, 8 * kFwdNB);
  return rows * (N + 4) +
         kFwdStages * (kFwdK * (N + 8) + rows * (kFwdK + 4));
}

// grid (ceil(B / bt), 2, ceil(H / units)), kFwdThreads threads; S * bt a
// multiple of 32, units * bt <= kFwdThreads, S a multiple of min(S,
// kFwdAhead). Block (tile, dir, z) owns units j0 .. j0 + units - 1 (j0 =
// z units; all of H where units = H, as at every preset): it keeps the
// 3 units rows of W_d that project onto them (gate blocks of `units`
// rows, rows past H zero) and projects and scans only those, from the
// whole of X. Thread p < units * bt scans unit j0 + p / bt of column b0 +
// p % bt. Per chunk n: the
// copy of chunk n+1 is issued, the warps project chunk n into U slot n %
// 2, one barrier, then the scan of chunk n; the next chunk's product
// writes the other U slot, so the scan needs no second barrier.
//
// kStream (where W_d's rows of even 8 units and X's two slots do not fit
// one block, H above 268): the block keeps one U slot and streams the
// projection's reduction instead of holding W_d and a chunk of X whole.
// Stage s is k slice s % ksl (kFwdK rows of X's chunk s / ksl, the same
// kFwdK columns of the block's rows of W_d) in ring slot s % kFwdStages,
// the copies of the next kFwdStages - 1 stages in flight while the warps
// multiply this one; each warp adds its jobs' products of the slice to
// their U entries in shared memory (a job's entries are its warp's alone,
// and the sum runs over the slices in order), and after a chunk's last
// slice a barrier, then the scan of the chunk. Its U slot is written
// again only after the next stage's barrier, which every scan thread
// reaches after its scan.
template <bool kStream>
__global__ void __launch_bounds__(kFwdThreads, 2)
sru_hid_fwd_kernel(const float* __restrict__ x_f, const float* __restrict__ x_r,
                   const float* __restrict__ wt, const float* __restrict__ vb,
                   float* __restrict__ h_f, float* __restrict__ h_r,
                   float* __restrict__ c_f, float* __restrict__ c_r, int T,
                   int H, int B, int bt, int S, int units) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.y, b0 = blockIdx.x * bt, tid = threadIdx.x;
  const int j0 = blockIdx.z * units, hs = min(units, H - j0);
  const int N = S * bt, h2 = 2 * H, h3 = 3 * H;
  const int k8 = round_up(h2, 8), rows = round_up(3 * units, 8 * kFwdNB);
  const int ws = k8 + 4, xs = N + 8, us = N + 4;
  float* w_s = reinterpret_cast<float*>(smem4);  // (rows, ws): W_d[o][k]
  float* x_s = w_s + rows * ws;                  // 2 x (k8, xs): X[k][col]
  // 2 x (rows, us): U[o][col]; kStream: one, first, then the ring
  float* u_s = kStream ? w_s : x_s + 2 * k8 * xs;
  const int n_chunks = (T + S - 1) / S;
  const bool vec_x = bt % 4 == 0 && B % 4 == 0;
  const int warp = tid >> 5;

  // W_d's rows of the block's units, a warp a row: row o = gate * units +
  // jl is W_d's row gate * H + j0 + jl; zero-padded (units past H, rows >=
  // 3 units, columns >= 2H). (gate, jl) steps with o, with no division.
  const float* wd = wt + (long long)dir * h3 * h2;
  if constexpr (!kStream) {
    int gate = warp / units, jl = warp % units;
    for (int o = warp; o < rows; o += kFwdThreads / 32) {
      const bool row_ok = gate < 3 && jl < hs;
      const float* src = wd + (long long)(gate * H + j0 + jl) * h2;
      for (int k = tid & 31; k < k8; k += 32) {
        const bool ok = row_ok && k < h2;
        hk::cp_async4(w_s + o * ws + k, ok ? src + k : wt, ok);
      }
      for (jl += kFwdThreads / 32; jl >= units; jl -= units) ++gate;
    }
  }
  // chunk n's X (rows >= 2H, steps past T and columns past B zero) into
  // slot n % 2
  auto load_chunk = [&](int n) {
    float* dst = x_s + (n & 1) * k8 * xs;
    const int per = vec_x ? 4 : 1;
    for (int e = per * tid; e < k8 * N; e += per * kFwdThreads) {
      const int r = e / N, col = e % N, s = col / bt, c = col % bt;
      const int ii = n * S + s;
      const int t = dir == 0 ? ii : T - 1 - ii;
      const bool ok = r < h2 && ii < T && b0 + c < B;
      const float* src =
          ok ? (r < H ? x_f : x_r) + ((long long)t * H + r % H) * B + b0 + c
             : x_f;
      if (vec_x)
        hk::cp_async16(dst + r * xs + col, src, ok);
      else
        hk::cp_async4(dst + r * xs + col, src, ok);
    }
  };
  // U^T = X^T W_d^T of chunk n: warp job = (16 kFwdMT
  // columns, 8 kFwdNB rows of U); the lane's elements of a k8 step: X
  // (rows q, q+4; columns g, g+8 of each m16 tile), W_d (row g of each
  // n8 tile; columns q, q+4), the next step's loaded before this step's
  // products
  const int g = hk::lane_g(), q = hk::lane_q();
  const int m_jobs = N / (16 * kFwdMT);
  const int n_jobs = m_jobs * (rows / (8 * kFwdNB));
  auto project = [&](int n) {
    const float* xc = x_s + (n & 1) * k8 * xs;
    float* uc = u_s + (n & 1) * rows * us;
    for (int jb = warp; jb < n_jobs; jb += kFwdThreads / 32) {
      const int m0 = jb % m_jobs * 16 * kFwdMT;
      const int r0 = jb / m_jobs * 8 * kFwdNB;
      float acc[kFwdMT][kFwdNB][4];
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nb][v] = 0.f;
      const float* xl = xc + q * xs + m0 + g;
      const float* wl = w_s + (r0 + g) * ws + q;
      float a_raw[kFwdMT][4], b_raw[kFwdNB][2];
      auto load_raw = [&](int k0) {
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt) {
          const float* p = xl + k0 * xs + 16 * mt;
          a_raw[mt][0] = p[0];
          a_raw[mt][1] = p[8];
          a_raw[mt][2] = p[4 * xs];
          a_raw[mt][3] = p[4 * xs + 8];
        }
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb) {
          const float* p = wl + 8 * nb * ws + k0;
          b_raw[nb][0] = p[0];
          b_raw[nb][1] = p[4];
        }
      };
      load_raw(0);
      for (int k0 = 0; k0 < k8; k0 += 8) {
        hk::FragA a[kFwdMT];
        hk::FragB bf[kFwdNB];
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            hk::split(a_raw[mt][v], a[mt].big[v], a[mt].small[v]);
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            hk::split(b_raw[nb][v], bf[nb].big[v], bf[nb].small[v]);
        if (k0 + 8 < k8) load_raw(k0 + 8);
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
          for (int mt = 0; mt < kFwdMT; ++mt)
            hk::mma3(acc[mt][nb], a[mt], bf[nb]);
      }
      // D (column m, row o): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q),
      // c3 (g+8, 2q+1); stored as U[o][m]
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb) {
          float* u = uc + (r0 + 8 * nb + 2 * q) * us + m0 + 16 * mt + g;
          u[0] = acc[mt][nb][0];
          u[us] = acc[mt][nb][1];
          u[8] = acc[mt][nb][2];
          u[us + 8] = acc[mt][nb][3];
        }
    }
  };

  // the scan thread: unit j0 + jl, column b
  const int jl = tid / bt, j = j0 + jl, b = b0 + tid % bt;
  const bool live = tid < hs * bt && b < B;
  const float* xd = dir == 0 ? x_f : x_r;  // the highway: own input
  float* h = dir == 0 ? h_f : h_r;
  float* cs = dir == 0 ? c_f : c_r;  // null when serving
  const long long row = (long long)H * B;
  const long long col0 = (long long)j * B + b;
  float v_f = 0.f, v_r = 0.f, b_f = 0.f, b_r = 0.f;
  if (live) {
    v_f = vb[(dir * 4 + 0) * H + j];
    v_r = vb[(dir * 4 + 1) * H + j];
    b_f = vb[(dir * 4 + 2) * H + j];
    b_r = vb[(dir * 4 + 3) * H + j];
  }
  const int G = min(S, kFwdAhead);  // steps a group; S is a multiple
  // highway of the G steps from scan index i0 on
  auto load_hw = [&](int i0, float (&dst)[kFwdAhead]) {
#pragma unroll
    for (int s = 0; s < kFwdAhead; ++s) {
      const int i = i0 + s;
      const int t = dir == 0 ? i : T - 1 - i;
      dst[s] = live && s < G && i < T ? xd[t * row + col0] : 0.f;
    }
  };
  float hw[kFwdAhead];
  load_hw(0, hw);
  float c = 0.f;
  auto scan = [&](int n) {
    const float* u =
        u_s + (kStream ? 0 : (n & 1) * rows * us) + jl * us + tid % bt;
    for (int s0 = 0; s0 < S; s0 += G) {
      const int i0 = n * S + s0;
      if (i0 >= T) break;
      float hw_next[kFwdAhead];  // the next group's, across chunks
      load_hw(i0 + G, hw_next);
      float u0[kFwdAhead], u1[kFwdAhead], u2[kFwdAhead];
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) {
        if (s >= G) break;
        const int off = (s0 + s) * bt;
        u0[s] = u[off];
        u1[s] = u[units * us + off];
        u2[s] = u[2 * units * us + off];
      }
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) {
        const int i = i0 + s;
        if (s >= G || i >= T) break;
        const int t = dir == 0 ? i : T - 1 - i;
        const float f = sigmoid_fast(u1[s] + v_f * c + b_f);
        c = f * c + (1.f - f) * u0[s];
        const float r = sigmoid_fast(u2[s] + v_r * c + b_r);
        h[t * row + col0] = r * c + (1.f - r) * hw[s];
        if (cs) cs[t * row + col0] = c;
      }
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) hw[s] = hw_next[s];
    }
  };

  if constexpr (!kStream) {
    load_chunk(0);  // with W_d
    hk::cp_async_commit();
    hk::cp_async_wait_all();
    __syncthreads();
    for (int n = 0; n < n_chunks; ++n) {
      // chunk n+1 into the slot chunk n-1's product read (before the last
      // barrier)
      if (n + 1 < n_chunks) load_chunk(n + 1);
      hk::cp_async_commit();
      project(n);
      hk::cp_async_wait_all();
      __syncthreads();  // U of chunk n and X of chunk n+1 are in; the scan
                        // of chunk n-1 is done with the other U slot
      if (live) scan(n);
    }
  } else {
    static_assert(kFwdK == 32, "a lane copies a column of W_d's slice");
    const int ksl = (h2 + kFwdK - 1) / kFwdK, total = n_chunks * ksl;
    const int kws = kFwdK + 4;  // a row of W_d's slice: 4 mod 32 banks
    const int slot_floats = kFwdK * xs + rows * kws;
    float* ring = u_s + rows * us;  // slots of (kFwdK, xs) X, (rows, kws) W_d
    const int lane = tid & 31;
    // stage st into ring slot `slot`, one commit group (empty past the
    // last): X's rows k0 .. k0 + kFwdK - 1 of chunk st / ksl (rows >= 2H,
    // steps past T and columns past B zero) and those columns of W_d's
    // rows of the block's units, a warp a row, a lane a column
    auto load_stage = [&](int st, int slot) {
      if (st < total) {
        const int n = st / ksl, k0 = (st - n * ksl) * kFwdK;
        float* xd = ring + slot * slot_floats;
        float* wd_s = xd + kFwdK * xs;
        const int per = vec_x ? 4 : 1;
        for (int e = per * tid; e < kFwdK * N; e += per * kFwdThreads) {
          const int r = e / N, col = e % N, s = col / bt, c = col % bt;
          const int ii = n * S + s, k = k0 + r;
          const int t = dir == 0 ? ii : T - 1 - ii;
          const bool ok = k < h2 && ii < T && b0 + c < B;
          const float* src =
              ok ? (k < H ? x_f : x_r) + ((long long)t * H + k % H) * B + b0 + c
                 : x_f;
          if (vec_x)
            hk::cp_async16(xd + r * xs + col, src, ok);
          else
            hk::cp_async4(xd + r * xs + col, src, ok);
        }
        int gate = warp / units, jl = warp % units;
        for (int o = warp; o < rows; o += kFwdThreads / 32) {
          const bool ok = gate < 3 && jl < hs && k0 + lane < h2;
          const float* src =
              wd + (long long)(gate * H + j0 + jl) * h2 + k0 + lane;
          hk::cp_async4(wd_s + o * kws + lane, ok ? src : wt, ok);
          for (jl += kFwdThreads / 32; jl >= units; jl -= units) ++gate;
        }
      }
      hk::cp_async_commit();
    };
    // U^T += X^T W_d^T over the slice in `slot`: project's jobs and
    // fragments, the sums carried in U (from 0 at the chunk's first slice)
    auto project_slice = [&](int slot, bool first) {
      const float* xc = ring + slot * slot_floats;
      const float* wc = xc + kFwdK * xs;
      for (int jb = warp; jb < n_jobs; jb += kFwdThreads / 32) {
        const int m0 = jb % m_jobs * 16 * kFwdMT;
        const int r0 = jb / m_jobs * 8 * kFwdNB;
        float acc[kFwdMT][kFwdNB][4];
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
          for (int nb = 0; nb < kFwdNB; ++nb) {
            const float* u = u_s + (r0 + 8 * nb + 2 * q) * us + m0 + 16 * mt + g;
            acc[mt][nb][0] = first ? 0.f : u[0];
            acc[mt][nb][1] = first ? 0.f : u[us];
            acc[mt][nb][2] = first ? 0.f : u[8];
            acc[mt][nb][3] = first ? 0.f : u[us + 8];
          }
        const float* xl = xc + q * xs + m0 + g;
        const float* wl = wc + (r0 + g) * kws + q;
#pragma unroll
        for (int k0 = 0; k0 < kFwdK; k0 += 8) {
          hk::FragA a[kFwdMT];
          hk::FragB bf[kFwdNB];
#pragma unroll
          for (int mt = 0; mt < kFwdMT; ++mt) {
            const float* p = xl + k0 * xs + 16 * mt;
            hk::split(p[0], a[mt].big[0], a[mt].small[0]);
            hk::split(p[8], a[mt].big[1], a[mt].small[1]);
            hk::split(p[4 * xs], a[mt].big[2], a[mt].small[2]);
            hk::split(p[4 * xs + 8], a[mt].big[3], a[mt].small[3]);
          }
#pragma unroll
          for (int nb = 0; nb < kFwdNB; ++nb) {
            const float* p = wl + 8 * nb * kws + k0;
            hk::split(p[0], bf[nb].big[0], bf[nb].small[0]);
            hk::split(p[4], bf[nb].big[1], bf[nb].small[1]);
          }
#pragma unroll
          for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
            for (int mt = 0; mt < kFwdMT; ++mt)
              hk::mma3(acc[mt][nb], a[mt], bf[nb]);
        }
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
          for (int nb = 0; nb < kFwdNB; ++nb) {
            float* u = u_s + (r0 + 8 * nb + 2 * q) * us + m0 + 16 * mt + g;
            u[0] = acc[mt][nb][0];
            u[us] = acc[mt][nb][1];
            u[8] = acc[mt][nb][2];
            u[us + 8] = acc[mt][nb][3];
          }
      }
    };
    int ld = 0, rd = 0, n = 0, kk = 0;  // ring slots; chunk and slice
    for (int st = 0; st < kFwdStages - 1; ++st) {
      load_stage(st, ld);
      if (++ld == kFwdStages) ld = 0;
    }
    for (int st = 0; st < total; ++st) {
      hk::cp_async_wait<kFwdStages - 2>();
      __syncthreads();  // stage st is in; every warp is done with the slot
                        // stage st + kFwdStages - 1 takes, and every scan
                        // thread with U
      load_stage(st + kFwdStages - 1, ld);
      if (++ld == kFwdStages) ld = 0;
      project_slice(rd, kk == 0);
      if (++rd == kFwdStages) rd = 0;
      if (++kk == ksl) {
        kk = 0;
        __syncthreads();  // U of chunk n is whole
        if (live) scan(n);
        ++n;
      }
    }
    hk::cp_async_wait_all();
  }
}

// Shared memory of the bf16 K2 forward in bytes (N columns a chunk, U
// units a block): W_d's rows of those units in bf16 (3U rows padded to 8 *
// kFwdNB, of 2H padded to 16, + 8), two bf16 X slots (2H' rows of N + 8)
// and two float32 U slots (3U' rows of N + 4), as the float32 kernel's,
// U's slots unchanged (the product's result is float32).
__host__ __device__ __forceinline__ int hid_fwd_bf16_smem_bytes(int H, int N,
                                                                int U) {
  const int k16 = round_up(2 * H, 16), rows = round_up(3 * U, 8 * kFwdNB);
  return 2 * (rows * (k16 + 8) + 2 * k16 * (N + 8)) + 4 * 2 * rows * (N + 4);
}

// Shared memory of the streamed bf16 K2 forward in bytes (N columns a
// chunk, U units a block): one float32 U slot (3U' rows of N + 4), then
// the ring of kFwdStages stages, each kFwdK rows of X in bf16 (of N + 8)
// and W_d's 3U' rows' kFwdK columns in bf16 (of kFwdK + 8, 20 words: the
// 8 rows of a B fragment on distinct banks). It does not grow with H.
__host__ __device__ __forceinline__ int hid_fwd_bf16_stream_smem_bytes(int N,
                                                                       int U) {
  const int rows = round_up(3 * U, 8 * kFwdNB);
  return 4 * rows * (N + 4) +
         2 * kFwdStages * (kFwdK * (N + 8) + rows * (kFwdK + 8));
}

// K2 forward in bf16 storage (x, W^T, vb, h and c bf16): the float32
// kernel's blocks, chunks and scan, with the projection one bf16 mma.sync
// m16n8k16 a fragment pair with a float32 accumulator, exactly JAX's bf16
// dot with a float32 result (no 3xTF32 split: the products of bf16 values
// are exact). U stays float32 in shared memory; the gates and the carry
// are float32; h and c are rounded to bf16 as they are stored. X's rows
// are staged as in the float32 kernel ([k][column], rows of N + 8 bf16):
// an A fragment's register pairs two k rows, so each half is read apart
// (two 2-byte loads and a pack), 8q + g/2 banks apart, conflict-free. W_d
// stays [o][k] with rows of 2H' + 8 bf16 (4 mod 8 words), so a B
// register is one aligned 4-byte read, conflict-free. X's chunk is copied
// w values at a time, w the largest of 8, 4, 2 that divides bt and B (16-,
// 8- or 4-byte cp.async), or by plain loads where B is odd or bt is 1 (no
// 2-byte cp.async); W_d's rows (2H values, so every row starts on a 4-byte
// boundary) two values a copy. Units are split over the grid as in the
// float32 kernel.
//
// kStream (where W_d's rows of even 8 units and X's two slots do not fit
// one block, H above 536): the float32 kernel's streamed reduction in
// bf16. The block keeps one float32 U slot; stage s is k slice s % ksl
// (kFwdK = 32 rows of X's chunk s / ksl in bf16, two k16 steps, and the
// same 32 columns of the block's rows of W_d) in ring slot s %
// kFwdStages, the copies of the next kFwdStages - 1 stages in flight
// while the warps multiply this one. Each warp adds its jobs' products of
// the slice to their float32 U entries (its own entries, the slices in
// order), and after a chunk's last slice a barrier, then the scan. A
// plain-load copy of X (B odd, or bt 1: at the widths that stream bt is
// 1) is a store to shared memory made after the barrier that ends the
// slot's last reads, and read after the barrier that opens its stage, as
// the cp.async copies are.
template <bool kStream>
__global__ void __launch_bounds__(kFwdThreads, 2)
sru_hid_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x_f,
                        const __nv_bfloat16* __restrict__ x_r,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ vb,
                        __nv_bfloat16* __restrict__ h_f,
                        __nv_bfloat16* __restrict__ h_r,
                        __nv_bfloat16* __restrict__ c_f,
                        __nv_bfloat16* __restrict__ c_r, int T, int H, int B,
                        int bt, int S, int units) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.y, b0 = blockIdx.x * bt, tid = threadIdx.x;
  const int j0 = blockIdx.z * units, hs = min(units, H - j0);
  const int N = S * bt, h2 = 2 * H, h3 = 3 * H;
  const int k16 = round_up(h2, 16), rows = round_up(3 * units, 8 * kFwdNB);
  const int ws = k16 + 8, xs = N + 8, us = N + 4;
  unsigned short* w_s = reinterpret_cast<unsigned short*>(smem4);  // (rows, ws)
  unsigned short* x_s = w_s + rows * ws;  // 2 x (k16, xs): X[k][col]
  // 2 x (rows, us): U[o][col]; kStream: one, first, then the ring
  float* u_s = kStream ? reinterpret_cast<float*>(smem4)
                       : reinterpret_cast<float*>(x_s + 2 * k16 * xs);
  const unsigned short* xf16 = reinterpret_cast<const unsigned short*>(x_f);
  const unsigned short* xr16 = reinterpret_cast<const unsigned short*>(x_r);
  const unsigned short* wt16 = reinterpret_cast<const unsigned short*>(wt);
  const unsigned short* wd = wt16 + (long long)dir * h3 * h2;
  const int n_chunks = (T + S - 1) / S;
  const int vw = bt % 8 == 0 && B % 8 == 0   ? 8
                 : bt % 4 == 0 && B % 4 == 0 ? 4
                 : bt % 2 == 0 && B % 2 == 0 ? 2
                                             : 1;
  const int warp = tid >> 5, lane = tid & 31;

  // W_d's rows of the block's units, a warp a row, a lane two columns
  if constexpr (!kStream) {
    int gate = warp / units, jl = warp % units;
    for (int o = warp; o < rows; o += kFwdThreads / 32) {
      const bool row_ok = gate < 3 && jl < hs;
      const unsigned short* src = wd + (long long)(gate * H + j0 + jl) * h2;
      for (int k = 2 * lane; k < k16; k += 64) {
        const bool ok = row_ok && k < h2;
        hk::cp_async4(w_s + o * ws + k, ok ? src + k : wt16, ok);
      }
      for (jl += kFwdThreads / 32; jl >= units; jl -= units) ++gate;
    }
  }
  // rows k0 .. k0 + nr - 1 of chunk n's X (rows >= 2H, steps past T and
  // columns past B zero) into dst, rows of xs, vw values a copy
  auto load_x = [&](unsigned short* dst, int n, int k0, int nr) {
    for (int e = vw * tid; e < nr * N; e += vw * kFwdThreads) {
      const int r = e / N, col = e % N, s = col / bt, c = col % bt;
      const int ii = n * S + s, k = k0 + r;
      const int t = dir == 0 ? ii : T - 1 - ii;
      const bool ok = k < h2 && ii < T && b0 + c < B;
      const unsigned short* src =
          ok ? (k < H ? xf16 : xr16) + ((long long)t * H + k % H) * B + b0 + c
             : xf16;
      hk::copy_bf16(dst + r * xs + col, src, vw, ok);
    }
  };
  // U^T += X^T W_d^T over one k16 step, the float32 kernel's warp jobs:
  // A (column m, k) = X[k][m], the lane's rows k = 2q, 2q+1, 2q+8, 2q+9
  // and columns g, g + 8 of each m16 tile from xl; B from W_d's rows at wl
  // (rows wstride apart)
  const int g = hk::lane_g(), q = hk::lane_q();
  const int m_jobs = N / (16 * kFwdMT);
  const int n_jobs = m_jobs * (rows / (8 * kFwdNB));
  auto mma_step = [&](float (&acc)[kFwdMT][kFwdNB][4],
                      const unsigned short* xl, const unsigned short* wl,
                      int wstride) {
    uint32_t a[kFwdMT][4], bf[kFwdNB][2];
#pragma unroll
    for (int mt = 0; mt < kFwdMT; ++mt) {
      const unsigned short* p = xl + 16 * mt;
      a[mt][0] = hk::pack_bf16(p[0], p[xs]);
      a[mt][1] = hk::pack_bf16(p[8], p[xs + 8]);
      a[mt][2] = hk::pack_bf16(p[8 * xs], p[9 * xs]);
      a[mt][3] = hk::pack_bf16(p[8 * xs + 8], p[9 * xs + 8]);
    }
#pragma unroll
    for (int nb = 0; nb < kFwdNB; ++nb) {
      const unsigned short* p = wl + 8 * nb * wstride;
      bf[nb][0] = *reinterpret_cast<const uint32_t*>(p);
      bf[nb][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt)
        hk::mma_bf16(acc[mt][nb], a[mt], bf[nb]);
  };
  // a job's accumulators from U (zero where first) and back: D (column m,
  // row o) c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1), U[o][m]
  auto u_entry = [&](float* uc, int r0, int m0, int mt, int nb) {
    return uc + (r0 + 8 * nb + 2 * q) * us + m0 + 16 * mt + g;
  };
  auto store_u = [&](float (&acc)[kFwdMT][kFwdNB][4], float* uc, int r0,
                     int m0) {
#pragma unroll
    for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
      for (int nb = 0; nb < kFwdNB; ++nb) {
        float* u = u_entry(uc, r0, m0, mt, nb);
        u[0] = acc[mt][nb][0];
        u[us] = acc[mt][nb][1];
        u[8] = acc[mt][nb][2];
        u[us + 8] = acc[mt][nb][3];
      }
  };
  // U^T = X^T W_d^T of chunk n (held)
  auto project = [&](int n) {
    const unsigned short* xc = x_s + (n & 1) * k16 * xs;
    float* uc = u_s + (n & 1) * rows * us;
    for (int jb = warp; jb < n_jobs; jb += kFwdThreads / 32) {
      const int m0 = jb % m_jobs * 16 * kFwdMT;
      const int r0 = jb / m_jobs * 8 * kFwdNB;
      float acc[kFwdMT][kFwdNB][4];
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nb][v] = 0.f;
      const unsigned short* xl = xc + 2 * q * xs + m0 + g;
      const unsigned short* wl = w_s + (r0 + g) * ws + 2 * q;
      for (int k0 = 0; k0 < k16; k0 += 16)
        mma_step(acc, xl + k0 * xs, wl + k0, ws);
      store_u(acc, uc, r0, m0);
    }
  };

  // the scan thread: unit j0 + jl, column b
  const int jl = tid / bt, j = j0 + jl, b = b0 + tid % bt;
  const bool live = tid < hs * bt && b < B;
  const __nv_bfloat16* xd = dir == 0 ? x_f : x_r;  // the highway
  __nv_bfloat16* h = dir == 0 ? h_f : h_r;
  __nv_bfloat16* cs = dir == 0 ? c_f : c_r;  // null when serving
  const long long row = (long long)H * B;
  const long long col0 = (long long)j * B + b;
  float v_f = 0.f, v_r = 0.f, b_f = 0.f, b_r = 0.f;
  if (live) {
    v_f = __bfloat162float(vb[(dir * 4 + 0) * H + j]);
    v_r = __bfloat162float(vb[(dir * 4 + 1) * H + j]);
    b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j]);
    b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j]);
  }
  const int G = min(S, kFwdAhead);
  auto load_hw = [&](int i0, float (&dst)[kFwdAhead]) {
#pragma unroll
    for (int s = 0; s < kFwdAhead; ++s) {
      const int i = i0 + s;
      const int t = dir == 0 ? i : T - 1 - i;
      dst[s] = live && s < G && i < T ? __bfloat162float(xd[t * row + col0])
                                      : 0.f;
    }
  };
  float hw[kFwdAhead];
  load_hw(0, hw);
  float c = 0.f;
  auto scan = [&](int n) {
    const float* u =
        u_s + (kStream ? 0 : (n & 1) * rows * us) + jl * us + tid % bt;
    for (int s0 = 0; s0 < S; s0 += G) {
      const int i0 = n * S + s0;
      if (i0 >= T) break;
      float hw_next[kFwdAhead];
      load_hw(i0 + G, hw_next);
      float u0[kFwdAhead], u1[kFwdAhead], u2[kFwdAhead];
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) {
        if (s >= G) break;
        const int off = (s0 + s) * bt;
        u0[s] = u[off];
        u1[s] = u[units * us + off];
        u2[s] = u[2 * units * us + off];
      }
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) {
        const int i = i0 + s;
        if (s >= G || i >= T) break;
        const int t = dir == 0 ? i : T - 1 - i;
        const float f = sigmoid_fast(u1[s] + v_f * c + b_f);
        c = f * c + (1.f - f) * u0[s];
        const float r = sigmoid_fast(u2[s] + v_r * c + b_r);
        h[t * row + col0] = __float2bfloat16_rn(r * c + (1.f - r) * hw[s]);
        if (cs) cs[t * row + col0] = __float2bfloat16_rn(c);
      }
#pragma unroll
      for (int s = 0; s < kFwdAhead; ++s) hw[s] = hw_next[s];
    }
  };

  if constexpr (!kStream) {
    load_x(x_s, 0, 0, k16);  // with W_d
    hk::cp_async_commit();
    hk::cp_async_wait_all();
    __syncthreads();
    for (int n = 0; n < n_chunks; ++n) {
      if (n + 1 < n_chunks) load_x(x_s + ((n + 1) & 1) * k16 * xs, n + 1, 0,
                                   k16);
      hk::cp_async_commit();
      project(n);
      hk::cp_async_wait_all();
      __syncthreads();
      if (live) scan(n);
    }
  } else {
    static_assert(kFwdK % 16 == 0 && kFwdK / 2 <= 32,
                  "a slice is whole k16 steps; a lane copies two columns");
    const int ksl = (h2 + kFwdK - 1) / kFwdK, total = n_chunks * ksl;
    const int kws = kFwdK + 8;  // a row of W_d's slice: 20 words
    const int slot_elems = kFwdK * xs + rows * kws;
    // slots of (kFwdK, xs) X, then (rows, kws) W_d, bf16
    unsigned short* ring = reinterpret_cast<unsigned short*>(u_s + rows * us);
    // stage st into ring slot `slot`, one commit group (empty past the
    // last): X's rows k0 .. k0 + kFwdK - 1 of chunk st / ksl and those
    // columns of W_d's rows of the block's units, a warp a row, a lane
    // two columns (2H is even: a pair never straddles the row's end)
    auto load_stage = [&](int st, int slot) {
      if (st < total) {
        const int n = st / ksl, k0 = (st - n * ksl) * kFwdK;
        unsigned short* xd_s = ring + slot * slot_elems;
        unsigned short* wd_s = xd_s + kFwdK * xs;
        load_x(xd_s, n, k0, kFwdK);
        int gate = warp / units, jl = warp % units;
        for (int o = warp; o < rows; o += kFwdThreads / 32) {
          if (lane < kFwdK / 2) {
            const int k = k0 + 2 * lane;
            const bool ok = gate < 3 && jl < hs && k < h2;
            hk::cp_async4(wd_s + o * kws + 2 * lane,
                          ok ? wd + (long long)(gate * H + j0 + jl) * h2 + k
                             : wt16,
                          ok);
          }
          for (jl += kFwdThreads / 32; jl >= units; jl -= units) ++gate;
        }
      }
      hk::cp_async_commit();
    };
    // U^T += X^T W_d^T over the slice in `slot`, the sums carried in U
    // (from 0 at the chunk's first slice)
    auto project_slice = [&](int slot, bool first) {
      const unsigned short* xc = ring + slot * slot_elems;
      const unsigned short* wc = xc + kFwdK * xs;
      for (int jb = warp; jb < n_jobs; jb += kFwdThreads / 32) {
        const int m0 = jb % m_jobs * 16 * kFwdMT;
        const int r0 = jb / m_jobs * 8 * kFwdNB;
        float acc[kFwdMT][kFwdNB][4];
#pragma unroll
        for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
          for (int nb = 0; nb < kFwdNB; ++nb) {
            const float* u = u_entry(u_s, r0, m0, mt, nb);
            acc[mt][nb][0] = first ? 0.f : u[0];
            acc[mt][nb][1] = first ? 0.f : u[us];
            acc[mt][nb][2] = first ? 0.f : u[8];
            acc[mt][nb][3] = first ? 0.f : u[us + 8];
          }
        const unsigned short* xl = xc + 2 * q * xs + m0 + g;
        const unsigned short* wl = wc + (r0 + g) * kws + 2 * q;
#pragma unroll
        for (int k0 = 0; k0 < kFwdK; k0 += 16)
          mma_step(acc, xl + k0 * xs, wl + k0, kws);
        store_u(acc, u_s, r0, m0);
      }
    };
    int ld = 0, rd = 0, n = 0, kk = 0;  // ring slots; chunk and slice
    for (int st = 0; st < kFwdStages - 1; ++st) {
      load_stage(st, ld);
      if (++ld == kFwdStages) ld = 0;
    }
    for (int st = 0; st < total; ++st) {
      hk::cp_async_wait<kFwdStages - 2>();
      __syncthreads();  // stage st is in; every warp is done with the slot
                        // stage st + kFwdStages - 1 takes, and every scan
                        // thread with U
      load_stage(st + kFwdStages - 1, ld);
      if (++ld == kFwdStages) ld = 0;
      project_slice(rd, kk == 0);
      if (++rd == kFwdStages) rd = 0;
      if (++kk == ksl) {
        kk = 0;
        __syncthreads();  // U of chunk n is whole
        if (live) scan(n);
        ++n;
      }
    }
    hk::cp_async_wait_all();
  }
}

// Rows of a time-major (T, R, B) operand, each a row of B values (float,
// or bf16 for the bf16 backward's X): rows [0, r0) of step t at p0 + (t *
// step0 + r) * B, rows [r0, R) at p1 + (t * step1 + r - r0) * B. X = [x_f;
// x_r] is two such halves; U, du and dx's halves are one each (r0 >= R).
template <typename E>
struct RowsT {
  E* p0;
  E* p1;
  int r0, step0, step1;
  __device__ __forceinline__ E* row(int t, int r, int B) const {
    return r < r0 ? p0 + ((long long)t * step0 + r) * B
                  : p1 + ((long long)t * step1 + r - r0) * B;
  }
};
using Rows = RowsT<float>;

// C_t = op(A) B_t for every step t = blockIdx.z, where op(A)[m][k] is
// A[m * lda + k], or A[k * lda + m] with TransA, B_t is (K, N) and C_t
// (M, N) with N = B columns; with Accum, C_t += op(A) B_t. grid (ceil(N /
// 64), ceil(M / 64), T), kGemmThreads threads: thread (tx, ty) = (tid %
// 16, tid / 16) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of
// the tile. Each stage stages kStage rows of the reduction, the next
// stage's loads in flight in registers while this one's FMAs run. A and
// B_t may be bf16 (EA, EB: the bf16 backward's W and X), widened exactly
// as they are loaded; the products and sums are float32.
template <bool TransA, bool Accum, typename EA = float, typename EB = float>
__global__ void __launch_bounds__(kGemmThreads)
sru_hid_bwd_gemm_kernel(const EA* __restrict__ A, int lda, RowsT<EB> b,
                        Rows c, int M, int K, int N) {
  __shared__ __align__(16) float a_s[kStage][kTile + 4];  // a_s[k][m]
  __shared__ __align__(16) float b_s[kStage][kTile];      // b_s[k][n]
  constexpr int kPer = kStage * kTile / kGemmThreads;     // loads a thread
  const int t = blockIdx.z, m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  float ra[kPer], rb[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kGemmThreads;
      // A: element (m, k) of the tile, k fastest in memory unless TransA
      const int m = TransA ? e % kTile : e / kStage;
      const int k = TransA ? e / kTile : e % kStage;
      const int gm = m0 + m, gk = k0 + k;
      const long long ia = TransA ? (long long)gk * lda + gm
                                  : (long long)gm * lda + gk;
      ra[r] = gm < M && gk < K ? load_value(A + ia) : 0.f;
      const int kb = k0 + e / kTile, gn = n0 + e % kTile;
      rb[r] = kb < K && gn < N ? load_value(b.row(t, kb, N) + gn) : 0.f;
    }
  };
  const int n_stages = (K + kStage - 1) / kStage;
  load(0);
  for (int s = 0; s < n_stages; ++s) {
    __syncthreads();  // the last stage's reads are done
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kGemmThreads;
      const int m = TransA ? e % kTile : e / kStage;
      const int k = TransA ? e / kTile : e % kStage;
      a_s[k][m] = ra[r];
      b_s[e / kTile][e % kTile] = rb[r];
    }
    __syncthreads();
    if (s + 1 < n_stages) load((s + 1) * kStage);
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += a4[p] * b4[q];
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gm = m0 + 4 * ty + p;
    if (gm >= M) continue;
    float* out = c.row(t, gm, N);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gn = n0 + 4 * tx + q;
      if (gn < N) out[gn] = Accum ? out[gn] + acc[p][q] : acc[p][q];
    }
  }
}

// part[chunk][m][n] = sum over the columns col in [chunk * cols,
// min((chunk + 1) * cols, T * B)), (t, b) = divmod(col, B), of a_t[m][b] *
// b_t[n][b]: one chunk of the split-K product dW = sum_t du_t X_t^T. grid
// (ceil(N / 64), ceil(M / 64), n_chunks), kGemmThreads threads, each a 4 x
// 4 register tile as in the product above. A stage stages kWgCols columns
// of both operands transposed (column-major, rows of 68 floats); a thread
// loads one column (tid % 32) of rows tid / 32 + 8 r, so it splits one
// column index into (t, b) a stage, and a warp reads 32 consecutive
// columns. b may be bf16 (EB: the bf16 backward's X), widened exactly.
template <typename EB = float>
__global__ void __launch_bounds__(kGemmThreads)
sru_hid_bwd_wgrad_kernel(Rows a, RowsT<EB> b, float* __restrict__ part,
                         int M, int N, int T, int B, int cols) {
  __shared__ __align__(16) float a_s[kWgCols][kTile + 4];  // a_s[col][m]
  __shared__ __align__(16) float b_s[kWgCols][kTile + 4];  // b_s[col][n]
  constexpr int kPer = kWgCols * kTile / kGemmThreads;
  constexpr int kRowStep = kGemmThreads / kWgCols;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const long long c0 = (long long)blockIdx.z * cols;
  const long long c1 = min(c0 + cols, (long long)T * B);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q = tid % kWgCols, r0 = tid / kWgCols;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[p][s] = 0.f;
  float ra[kPer], rb[kPer];
  auto load = [&](long long s0) {
    const long long col = s0 + q;
    const bool ok = col < c1;
    const int t = ok ? (int)(col / B) : 0;
    const int bb = ok ? (int)(col - (long long)t * B) : 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int gm = m0 + r0 + kRowStep * r, gn = n0 + r0 + kRowStep * r;
      ra[r] = ok && gm < M ? a.row(t, gm, B)[bb] : 0.f;
      rb[r] = ok && gn < N ? load_value(b.row(t, gn, B) + bb) : 0.f;
    }
  };
  load(c0);
  for (long long s0 = c0; s0 < c1; s0 += kWgCols) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      a_s[q][r0 + kRowStep * r] = ra[r];
      b_s[q][r0 + kRowStep * r] = rb[r];
    }
    __syncthreads();
    if (s0 + kWgCols < c1) load(s0 + kWgCols);
#pragma unroll 8
    for (int k = 0; k < kWgCols; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[p][s] += a4[p] * b4[s];
    }
  }
  float* out = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gm = m0 + 4 * ty + p;
    if (gm >= M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gn = n0 + 4 * tx + s;
      if (gn < N) out[(long long)gm * N + gn] = acc[p][s];
    }
  }
}

// out[e] = sum_{p < n_parts} part[p][e], p in order, in float32; a bf16
// out rounded once.
template <typename EO = float>
__global__ void sru_hid_bwd_sum_kernel(const float* __restrict__ part,
                                       EO* __restrict__ out, int n_parts,
                                       int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(long long)p * n + e];
  store_value(out + e, s);
}

// The bf16 backward's dx, as the Pallas kernel forms it: each direction's
// dx = W_d du_d plus its highway term (on its own input's rows) in
// float32, rounded to bf16 per direction, then the two added in bf16.
// dxd (2, T, 2H, B) holds W_f du_f and W_r du_r, hw (2, T, H, B) the
// highway terms; one thread a (t, i, b) of dx_f and dx_r.
__global__ void sru_hid_bwd_dx_bf16_kernel(const float* __restrict__ dxd,
                                           const float* __restrict__ hw,
                                           __nv_bfloat16* __restrict__ dx_f,
                                           __nv_bfloat16* __restrict__ dx_r,
                                           int T, int H, int B) {
  const long long hb = (long long)H * B, n = T * hb;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long t = e / hb, ib = e - t * hb;  // ib = i * B + b
  const float* a = dxd + t * 2 * hb;            // W_f du_f at step t
  const float* c = dxd + n * 2 + t * 2 * hb;    // W_r du_r
  const float f0 = __bfloat162float(__float2bfloat16_rn(a[ib] + hw[e]));
  const float f1 = __bfloat162float(__float2bfloat16_rn(c[ib]));
  const float r0 = __bfloat162float(__float2bfloat16_rn(a[hb + ib]));
  const float r1 =
      __bfloat162float(__float2bfloat16_rn(c[hb + ib] + hw[n + e]));
  dx_f[e] = __float2bfloat16_rn(f0 + f1);
  dx_r[e] = __float2bfloat16_rn(r0 + r1);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// cols x units threads a block (ops/sru_fused.k1_fwd_geometry)
extern "C" int sru_dual_recurrence_fwd(const void* u_f, const void* u_r,
                                       const void* vb, void* h_f, void* h_r,
                                       void* c_f, void* c_r, int T, int H,
                                       int B, int cols, int units,
                                       void* stream) {
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kLay0Threads)
    return (int)cudaErrorInvalidValue;
  dim3 grid(ceil_div(B, cols), ceil_div(H, units), 2);
  const size_t smem = (size_t)kLay0Ahead * 4 * cols * units * sizeof(float);
  const cudaError_t e = set_smem((const void*)sru_lay0_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sru_lay0_fwd_kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const float*)u_f, (const float*)u_r, (const float*)vb, (float*)h_f,
      (float*)h_r, (float*)c_f, (float*)c_r, T, H, B, cols);
  return (int)cudaGetLastError();
}

// cols x units threads a block (ops/sru_fused.scan_bwd_geometry);
// dvb_part: (ceil(B / cols), 8, H).
extern "C" int sru_dual_recurrence_bwd(const void* u_f, const void* u_r,
                                       const void* vb, const void* c_f,
                                       const void* c_r, const void* dh_f,
                                       const void* dh_r, void* du_f,
                                       void* du_r, void* dvb_part, int T,
                                       int H, int B, int cols, int units,
                                       void* stream) {
  const long long hb = (long long)H * B, step = 4 * hb, hw = 3 * hb;
  const ScanIO io_f{(const float*)u_f, (const float*)u_f + hw, (float*)du_f,
                    (float*)du_f + hw, step, step, step, step,
                    (const float*)c_f, (const float*)dh_f, (const float*)vb,
                    (float*)dvb_part, 0};
  const ScanIO io_r{(const float*)u_r, (const float*)u_r + hw, (float*)du_r,
                    (float*)du_r + hw, step, step, step, step,
                    (const float*)c_r, (const float*)dh_r,
                    (const float*)vb + 4 * H, (float*)dvb_part + 4 * H, 1};
  return (int)launch_scan_bwd<1>(io_f, io_r, 2, T, H, B, cols, units, 8LL * H,
                                 (cudaStream_t)stream);
}

// bt batch columns a block, chunks of S steps, units a block
// (ops/sru_fused.py k2_fwd_geometry): W_d's rows of the units held whole
// where they and X's two slots fit one block, the reduction streamed
// (sru_hid_fwd_kernel<true>) where they do not.
extern "C" int sru_hidden_layer_fwd(const void* x_f, const void* x_r,
                                    const void* wt, const void* vb, void* h_f,
                                    void* h_r, void* c_f, void* c_r, int T,
                                    int H, int B, int bt, int S, int units,
                                    void* stream) {
  if (bt < 1 || S < 1 || units < 1 || (S * bt) % (16 * kFwdMT) != 0 ||
      units * bt > kFwdThreads || S % min(S, kFwdAhead) != 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)hid_fwd_smem_floats(H, S * bt, units) * sizeof(float);
  const bool streamed = (long long)smem > kMaxSmem;
  if (streamed)
    smem = (size_t)hid_fwd_stream_smem_floats(S * bt, units) * sizeof(float);
  if ((long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto kernel =
      streamed ? sru_hid_fwd_kernel<true> : sru_hid_fwd_kernel<false>;
  cudaError_t e = set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(ceil_div(B, bt), 2, ceil_div(H, units)), kFwdThreads, smem,
           (cudaStream_t)stream>>>(
      (const float*)x_f, (const float*)x_r, (const float*)wt,
      (const float*)vb, (float*)h_f, (float*)h_r, (float*)c_f, (float*)c_r,
      T, H, B, bt, S, units);
  return (int)cudaGetLastError();
}

// K1 forward in bf16 storage: as sru_dual_recurrence_fwd; u_f and u_r
// 16-byte aligned (the warps' 16-byte copies). Shared memory: the warps'
// rings, kLay0Ahead x 4 x kLay0Span bf16 each.
extern "C" int sru_dual_recurrence_fwd_bf16(const void* u_f, const void* u_r,
                                            const void* vb, void* h_f,
                                            void* h_r, void* c_f, void* c_r,
                                            int T, int H, int B, int cols,
                                            int units, void* stream) {
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kLay0Threads ||
      ((reinterpret_cast<size_t>(u_f) | reinterpret_cast<size_t>(u_r)) & 15))
    return (int)cudaErrorInvalidValue;
  dim3 grid(ceil_div(B, cols), ceil_div(H, units), 2);
  const size_t smem =
      (size_t)(cols * units / 32) * kLay0Ahead * 4 * kLay0Span * 2;
  const cudaError_t e = set_smem((const void*)sru_lay0_fwd_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sru_lay0_fwd_bf16_kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)u_f, (const __nv_bfloat16*)u_r,
      (const __nv_bfloat16*)vb, (__nv_bfloat16*)h_f, (__nv_bfloat16*)h_r,
      (__nv_bfloat16*)c_f, (__nv_bfloat16*)c_r, T, H, B, cols);
  return (int)cudaGetLastError();
}

// K2 forward in bf16 storage: as sru_hidden_layer_fwd, W_d's rows of the
// units held whole where they and X's two slots fit one block, the
// reduction streamed (sru_hid_fwd_bf16_kernel<true>) where they do not;
// every pointer 16-byte aligned.
extern "C" int sru_hidden_layer_fwd_bf16(const void* x_f, const void* x_r,
                                         const void* wt, const void* vb,
                                         void* h_f, void* h_r, void* c_f,
                                         void* c_r, int T, int H, int B,
                                         int bt, int S, int units,
                                         void* stream) {
  if (bt < 1 || S < 1 || units < 1 || (S * bt) % (16 * kFwdMT) != 0 ||
      units * bt > kFwdThreads || S % min(S, kFwdAhead) != 0 ||
      ((reinterpret_cast<size_t>(x_f) | reinterpret_cast<size_t>(x_r) |
        reinterpret_cast<size_t>(wt)) & 15))
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)hid_fwd_bf16_smem_bytes(H, S * bt, units);
  const bool streamed = (long long)smem > kMaxSmem;
  if (streamed) smem = (size_t)hid_fwd_bf16_stream_smem_bytes(S * bt, units);
  if ((long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto kernel = streamed ? sru_hid_fwd_bf16_kernel<true>
                               : sru_hid_fwd_bf16_kernel<false>;
  cudaError_t e = set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(ceil_div(B, bt), 2, ceil_div(H, units)), kFwdThreads, smem,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x_f, (const __nv_bfloat16*)x_r,
      (const __nv_bfloat16*)wt, (const __nv_bfloat16*)vb, (__nv_bfloat16*)h_f,
      (__nv_bfloat16*)h_r, (__nv_bfloat16*)c_f, (__nv_bfloat16*)c_r, T, H, B,
      bt, S, units);
  return (int)cudaGetLastError();
}

// Outputs dx_f, dx_r (T, H, B), dwt (6H, 2H), dvb (8, H). Scratch from the
// wrapper: ud (T, 6H, B); dw_part (ceil(T * B / cols), 6H, 2H), one per
// chunk of cols (t, b) columns; dvb_part (ceil(B / scan_cols), 8, H), the
// scan's blocks scan_cols x scan_units threads
// (ops/sru_fused.scan_bwd_geometry).
extern "C" int sru_hidden_layer_bwd(
    const void* x_f, const void* x_r, const void* wt, const void* vb,
    const void* c_f, const void* c_r, const void* dh_f, const void* dh_r,
    void* dx_f, void* dx_r, void* dwt, void* dvb, void* ud, void* dw_part,
    void* dvb_part, int T, int H, int B, int cols, int scan_cols,
    int scan_units, void* stream) {
  if (cols < 1 || !scan_layout_ok(T, H, B, scan_cols, scan_units))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int h2 = 2 * H, h6 = 6 * H;
  const Rows x{(float*)x_f, (float*)x_r, H, H, H};
  const Rows u{(float*)ud, nullptr, h6, h6, 0};
  const Rows dx{(float*)dx_f, (float*)dx_r, H, H, H};
  // 1. U = W^T X for every step
  sru_hid_bwd_gemm_kernel<false, false, float, float>
      <<<dim3(ceil_div(B, kTile), ceil_div(h6, kTile), T), kGemmThreads, 0,
         st>>>((const float*)wt, h2, x, u, h6, h2, B);
  // 2. the adjoint scan: du over U, the highway term into dx
  const long long hb = (long long)H * B, step = 6LL * hb;
  const ScanIO io_f{(const float*)ud, (const float*)x_f, (float*)ud,
                    (float*)dx_f, step, hb, step, hb, (const float*)c_f,
                    (const float*)dh_f, (const float*)vb, (float*)dvb_part,
                    0};
  const ScanIO io_r{(const float*)ud + 3 * hb, (const float*)x_r,
                    (float*)ud + 3 * hb, (float*)dx_r, step, hb, step, hb,
                    (const float*)c_r, (const float*)dh_r,
                    (const float*)vb + 4 * H, (float*)dvb_part + 4 * H, 1};
  const cudaError_t e = launch_scan_bwd<2>(io_f, io_r, 2, T, H, B, scan_cols,
                                           scan_units, 8LL * H, st);
  if (e != cudaSuccess) return (int)e;
  // 3. dx += W du (both directions in one sum over 6H)
  sru_hid_bwd_gemm_kernel<true, true, float, float>
      <<<dim3(ceil_div(B, kTile), ceil_div(h2, kTile), T), kGemmThreads, 0,
         st>>>((const float*)wt, h2, u, dx, h2, h6, B);
  // 4. dW partials by split-K over the T * B columns
  const int n_chunks = ceil_div((long long)T * B, cols);
  sru_hid_bwd_wgrad_kernel<float>
      <<<dim3(ceil_div(h2, kTile), ceil_div(h6, kTile), n_chunks),
         kGemmThreads, 0, st>>>(u, x, (float*)dw_part, h6, h2, T, B, cols);
  // 5. the partials, in order
  sru_hid_bwd_sum_kernel<float><<<ceil_div(h6 * h2, 256), 256, 0, st>>>(
      (const float*)dw_part, (float*)dwt, n_chunks, h6 * h2);
  sru_hid_bwd_sum_kernel<float><<<ceil_div(8 * H, 256), 256, 0, st>>>(
      (const float*)dvb_part, (float*)dvb, ceil_div(B, scan_cols), 8 * H);
  return (int)cudaGetLastError();
}

// K1 backward in bf16 storage (u, vb, c, dh and du bf16; the scan in
// float32, each du value rounded once): as sru_dual_recurrence_bwd, the
// scan's bf16 form (sru_scan_bwd_kernel<11>); dvb_part stays float32.
// No alignment is asked of any pointer.
extern "C" int sru_dual_recurrence_bwd_bf16(
    const void* u_f, const void* u_r, const void* vb, const void* c_f,
    const void* c_r, const void* dh_f, const void* dh_r, void* du_f,
    void* du_r, void* dvb_part, int T, int H, int B, int cols, int units,
    void* stream) {
  using bf = __nv_bfloat16;
  const long long hb = (long long)H * B, step = 4 * hb, hw = 3 * hb;
  const long long u_last = (long long)T * step - 1, s_last = T * hb - 1;
  const ScanIOT<bf, bf> io_f{(const bf*)u_f, (const bf*)u_f + hw, (bf*)du_f,
                             (bf*)du_f + hw, step, step, step, step,
                             (const bf*)c_f, (const bf*)dh_f, (const bf*)vb,
                             (float*)dvb_part, 0, u_last, u_last - hw,
                             s_last};
  const ScanIOT<bf, bf> io_r{(const bf*)u_r, (const bf*)u_r + hw, (bf*)du_r,
                             (bf*)du_r + hw, step, step, step, step,
                             (const bf*)c_r, (const bf*)dh_r,
                             (const bf*)vb + 4 * H, (float*)dvb_part + 4 * H,
                             1, u_last, u_last - hw, s_last};
  return (int)launch_scan_bwd<11>(io_f, io_r, 2, T, H, B, cols, units,
                                  8LL * H, (cudaStream_t)stream);
}

// K2 backward in bf16 storage: x, wt, vb, c, dh in and dx, dwt, dvb out
// bf16, everything between float32, as the Pallas kernel: U = W^T X from
// the widened bf16 values (exact products, float32 sums), the scan's bf16
// form (sru_scan_bwd_kernel<12>) reading U and writing du over it in
// float32 and each direction's highway term into hw, each direction's dx
// = W_d du_d in float32 into dxd, dW from float32 du and widened x; dx
// rounded per direction and the two added in bf16
// (sru_hid_bwd_dx_bf16_kernel), dW and dvb summed in float32 and rounded
// once. Scratch from the wrapper, all float32: ud (T, 6H, B), dxd (2, T,
// 2H, B), hw (2, T, H, B), dw_part and dvb_part as in
// sru_hidden_layer_bwd. No alignment is asked of any pointer.
extern "C" int sru_hidden_layer_bwd_bf16(
    const void* x_f, const void* x_r, const void* wt, const void* vb,
    const void* c_f, const void* c_r, const void* dh_f, const void* dh_r,
    void* dx_f, void* dx_r, void* dwt, void* dvb, void* ud, void* dxd,
    void* hw, void* dw_part, void* dvb_part, int T, int H, int B, int cols,
    int scan_cols, int scan_units, void* stream) {
  if (cols < 1 || !scan_layout_ok(T, H, B, scan_cols, scan_units))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  cudaStream_t st = (cudaStream_t)stream;
  const int h2 = 2 * H, h3 = 3 * H, h6 = 6 * H;
  const long long hb = (long long)H * B, n = T * hb;
  const RowsT<bf> x{(bf*)x_f, (bf*)x_r, H, H, H};
  const Rows u{(float*)ud, nullptr, h6, h6, 0};
  const Rows u_r{(float*)ud + 3 * hb, nullptr, h6, h6, 0};
  const Rows dx_a{(float*)dxd, nullptr, h2, h2, 0};
  const Rows dx_b{(float*)dxd + 2 * n, nullptr, h2, h2, 0};
  // 1. U = W^T X for every step
  sru_hid_bwd_gemm_kernel<false, false, bf, bf>
      <<<dim3(ceil_div(B, kTile), ceil_div(h6, kTile), T), kGemmThreads, 0,
         st>>>((const bf*)wt, h2, x, u, h6, h2, B);
  // 2. the adjoint scan: du over U, the highway terms into hw
  const long long step = 6LL * hb;
  const ScanIOT<float, bf> io_f{
      (const float*)ud, (const bf*)x_f, (float*)ud, (float*)hw, step, hb,
      step, hb, (const bf*)c_f, (const bf*)dh_f, (const bf*)vb,
      (float*)dvb_part, 0, 0, n - 1, n - 1};
  const ScanIOT<float, bf> io_r{
      (const float*)ud + 3 * hb, (const bf*)x_r, (float*)ud + 3 * hb,
      (float*)hw + n, step, hb, step, hb, (const bf*)c_r, (const bf*)dh_r,
      (const bf*)vb + 4 * H, (float*)dvb_part + 4 * H, 1, 0, n - 1, n - 1};
  const cudaError_t e = launch_scan_bwd<12>(io_f, io_r, 2, T, H, B,
                                            scan_cols, scan_units, 8LL * H,
                                            st);
  if (e != cudaSuccess) return (int)e;
  // 3. each direction's dx = W_d du_d (W_d^T the direction's 3H rows of wt)
  sru_hid_bwd_gemm_kernel<true, false, bf, float>
      <<<dim3(ceil_div(B, kTile), ceil_div(h2, kTile), T), kGemmThreads, 0,
         st>>>((const bf*)wt, h2, u, dx_a, h2, h3, B);
  sru_hid_bwd_gemm_kernel<true, false, bf, float>
      <<<dim3(ceil_div(B, kTile), ceil_div(h2, kTile), T), kGemmThreads, 0,
         st>>>((const bf*)wt + (long long)h3 * h2, h2, u_r, dx_b, h2, h3, B);
  sru_hid_bwd_dx_bf16_kernel<<<ceil_div(n, 256), 256, 0, st>>>(
      (const float*)dxd, (const float*)hw, (bf*)dx_f, (bf*)dx_r, T, H, B);
  // 4. dW partials by split-K over the T * B columns
  const int n_chunks = ceil_div((long long)T * B, cols);
  sru_hid_bwd_wgrad_kernel<bf>
      <<<dim3(ceil_div(h2, kTile), ceil_div(h6, kTile), n_chunks),
         kGemmThreads, 0, st>>>(u, x, (float*)dw_part, h6, h2, T, B, cols);
  // 5. the partials, in order, rounded once
  sru_hid_bwd_sum_kernel<bf><<<ceil_div(h6 * h2, 256), 256, 0, st>>>(
      (const float*)dw_part, (bf*)dwt, n_chunks, h6 * h2);
  sru_hid_bwd_sum_kernel<bf><<<ceil_div(8 * H, 256), 256, 0, st>>>(
      (const float*)dvb_part, (bf*)dvb, ceil_div(B, scan_cols), 8 * H);
  return (int)cudaGetLastError();
}
