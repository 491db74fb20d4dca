// Fused bidirectional SRU stack kernels for Hopper (sm_90a), float32, and
// each also in bf16 storage (the Pallas kernels run in the caller's dtype;
// bf16 is the JAX package's serving and bf16 training mode).
//
// K1  sru_dual_recurrence_fwd  replaces the Pallas kernel _lay0_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_dual_recurrence);
//     sru_dual_recurrence_fwd_bf16 its bf16 form, a warp's copies a group
//     of steps at a time (sru_lay0_fwd16_kernel).
// K1  sru_dual_recurrence_bwd  replaces the Pallas kernel _lay0_bwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from _lay0_vjp_bwd);
//     sru_dual_recurrence_bwd_bf16 its bf16 form, designed as the bf16
//     forward (sru_lay0_bwd16_kernel).
// K2  sru_hidden_layer_fwd     replaces the Pallas kernel _hid_fwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from sru_hidden_layer);
//     sru_hidden_layer_fwd_bf16 its bf16 form, producer and scan warps
//     handing over chunk slots (sru_hid_fwd_bf16_kernel), streamed where
//     that does not fit a block, as the float32 one is above H 268.
// K2  sru_hidden_layer_bwd     replaces the Pallas kernel _hid_bwd_kernel
//     (rtfs_tpu/ops/sru_fused.py, called from _hid_vjp_bwd);
//     sru_hidden_layer_bwd_bf16 its bf16 form, one fused kernel
//     (sru_hid_bwd_bf16_kernel: U, the adjoint scan, dx and dW a chunk of
//     steps at a time on chip, the products on bf16 mma.sync.m16n8k16).
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
// (ops/sru_fused.scan_bwd_geometry). K1's bf16 forms are designed apart
// (sru_lay0_fwd16_kernel, below). K2 does 2*3H*2H
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
// memory), so its shared memory no longer grows with H; the bf16 forward
// does the same where its held kernel does not fit
// (sru_hid_fwd_bf16_stream_kernel). The bf16 forward's held kernel
// (sru_hid_fwd_bf16_kernel) is designed apart, below.
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
// allocates them. The bf16 backward is not split so: one fused kernel
// keeps U, du and dx on chip a chunk of steps at a time, the products on
// the tensor cores (sru_hid_bwd_bf16_kernel, below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
// K2's float32 backward recomputes the gates with sigmoid_f from a U of
// its own, formed in SIMT float32 rather than 3xTF32, so it differentiates
// a forward a few ulp from this one (within the gradient gates); the bf16
// backward (sru_hid_bwd_bf16_kernel) uses this sigmoid, and the bf16
// forward the same ex2 and rcp with its constants folded off the chain.
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

// K1 in bf16 storage, forward (sru_lay0_fwd16_kernel) and backward
// (sru_lay0_bwd16_kernel): u, vb, h, c, dh and du bf16; the arithmetic
// and the carries (c forward, dc backward) float32, only the stored values
// rounded, as the Pallas kernels keep their carries in float32 scratch.
//
// What bounds them on the H100 (PERF.md; tools/phase_split.py --k1 splits
// a launch). Both move 2 bytes a value for a few flops, so by the roofline
// they are bound by bytes; where the threads are few (bs 1: about a warp
// an SM) a launch takes T steps of one warp, and a warp issues in order,
// so a step costs its instructions and the latencies it waits on, not its
// chain alone (~25 ns for the forward's carry on this card). A first
// design copied a step at a time, 8 steps ahead: each step a lane waited
// for its copies, met its warp twice and redid the copies' 64-bit address
// arithmetic, and its gates took the accurate sigmoid, so a step cost
// 10-30 times its chain. The design:
//   - a warp owns one unit and 32 consecutive batch columns, a lane a
//     column; cp.async has no 2-byte copy, so the warp copies a row's 32
//     values of a step as the five 16-byte blocks that cover them (a slot
//     row of kL16Span values from the 16-byte boundary below the first;
//     u's, c's and dh's bases 16-byte aligned, which the wrappers make
//     sure of), and each lane reads its value shifted by the first's
//     offset mod 8; a block that runs past the array's end reads only up
//     to it;
//   - copies go a group of kL16Group steps at a time, one commit group,
//     issued `Ahead` groups before the group is read into a ring of Ahead
//     + 1 group slots: lane l < 5 R (R rows a step: 4 forward, 6 backward)
//     owns block l % 5 of row l / 5 and copies it for the group's steps,
//     its source moved by one step's stride each. A lane waits and meets
//     its warp once a group, and refills the slot of the group read before
//     that meeting, so it needs no second one. A row's offset mod 8 is
//     the same in every group (a group moves it by a multiple of 8), so
//     each lane works its read offsets out once;
//   - a full group runs without a branch: its reads go before its chain,
//     the stores are predicated, and the gates take the hardware ex2 and
//     rcp with their constants folded off the chain (sigmoid(u + v c + b)
//     = 1 / (1 + 2^(-log2(e) (u + b) - log2(e) v c))), so the compiler can
//     overlap a step's r, h and stores with the next step's chain;
//   - the backward's (v, b) sums stay in registers and are reduced per
//     unit within the block (a warp lies in one unit) into one float32
//     partial a column block, which the caller adds in a fixed order: no
//     float atomics, so two calls give the same bits.
constexpr int kL16Group = 8;     // steps a group: one commit group, one wait
constexpr int kL16FwdAhead = 3;  // groups in flight ahead of the one read
constexpr int kL16BwdAhead = 2;
constexpr int kL16Span = 40;     // a row's slot: 5 blocks of 8 bf16
constexpr float kNegLog2e = -1.4426950408889634f;

__device__ __forceinline__ float bf16_at(const unsigned short* p) {
  return __bfloat162float(__ushort_as_bfloat16(*p));
}

// One lane's block of a row: at scan step i < lim it copies the 16 bytes
// at element x = (e + i step) & ~7 of `base` (the row's array moved by 8 k
// for block k), of which left - x elements lie inside the array (left: its
// length - 8 k); `dst` is the block's place in a step of a group slot (row
// r: r kL16Span + 8 k).
struct L16Block {
  const unsigned short* base;
  long long e, step, left;
  int lim, dst;
};

// The lane's copies of group n (one commit group; none where it owns no
// block), R rows a step of kL16Span values in the group slot.
template <int R>
__device__ __forceinline__ void l16_copy_group(unsigned short* slot, int n,
                                               bool owner, const L16Block& w) {
  if (owner) {
    long long e = w.e + (long long)(n * kL16Group) * w.step;
#pragma unroll
    for (int s = 0; s < kL16Group; ++s) {
      const long long src = e & ~7LL, left = w.left - src;
      if (n * kL16Group + s < w.lim && left > 0)
        hk::cp_async16_n(slot + s * R * kL16Span + w.dst, w.base + src,
                         left >= 8 ? 16 : 2 * (int)left);
      e += w.step;
    }
  }
  hk::cp_async_commit();
}

// A value's offset in its slot row: its element mod 8 (in 32 bits, which
// keeps it), plus the lane.
__device__ __forceinline__ int l16_offset(long long t, unsigned stride,
                                          unsigned add, int lane) {
  return (int)(((unsigned)t * stride + add) & 7u) + lane;
}

// grid (ceil(B / cols), ceil(H / units), 2), cols * units threads, cols a
// multiple of 32 (ops/sru_fused.k1_fwd_geometry): warp (unit j, columns
// b0 .. b0 + 31) of direction blockIdx.z, its ring of kL16FwdAhead + 1
// group slots of 4 gate rows a step; kWithC: c stored too (training).
// Lanes past B compute on whatever their slot holds and store nothing.
template <bool kWithC>
__global__ void __launch_bounds__(kLay0Threads)
sru_lay0_fwd16_kernel(const __nv_bfloat16* __restrict__ u_f,
                      const __nv_bfloat16* __restrict__ u_r,
                      const __nv_bfloat16* __restrict__ vb,
                      __nv_bfloat16* __restrict__ h_f,
                      __nv_bfloat16* __restrict__ h_r,
                      __nv_bfloat16* __restrict__ c_f,
                      __nv_bfloat16* __restrict__ c_r, int T, int H, int B,
                      int cols) {
  constexpr int kSlots = kL16FwdAhead + 1, kSlot = kL16Group * 4 * kL16Span;
  extern __shared__ __align__(16) unsigned short ring16[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  const int dir = blockIdx.z;
  if (j >= H) return;  // the whole warp: one unit
  const float nv_f = kNegLog2e * __bfloat162float(vb[(dir * 4 + 0) * H + j]);
  const float nv_r = kNegLog2e * __bfloat162float(vb[(dir * 4 + 1) * H + j]);
  const float b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j]);
  const float b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j]);
  const long long row = (long long)H * B;
  const long long col = (long long)j * B + (b - lane);
  const long long t0 = dir == 0 ? 0 : T - 1;  // scan step 0's t
  unsigned short* mine = ring16 + warp * kSlots * kSlot;
  const int r_own = lane / 5, k_own = lane - 5 * r_own;
  const L16Block w{
      reinterpret_cast<const unsigned short*>(dir == 0 ? u_f : u_r) +
          8 * k_own,
      t0 * 4 * row + r_own * row + col, dir == 0 ? 4 * row : -4 * row,
      (long long)T * 4 * row - 8 * k_own, T, r_own * kL16Span + 8 * k_own};
  const bool owner = lane < 4 * 5;
  auto issue = [&](int n) {
    l16_copy_group<4>(mine + (n % kSlots) * kSlot, n, owner, w);
  };
#pragma unroll
  for (int n = 0; n < kL16FwdAhead; ++n) issue(n);
  // read offsets of gate row r at steps of parity p (4 row even, or moving
  // them by 4: period 2)
  const unsigned row4 = (unsigned)(4 * row), row1 = (unsigned)row;
  int rd[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rd[p][r] = l16_offset(dir == 0 ? p : t0 - p, row4,
                            r * row1 + (unsigned)col, lane);
  const bool live = b < B;
  const long long step = dir == 0 ? row : -row;
  const long long first = t0 * row + col + lane;
  __nv_bfloat16* hp = (dir == 0 ? h_f : h_r) + first;
  __nv_bfloat16* cp = kWithC ? (dir == 0 ? c_f : c_r) + first : nullptr;
  float c = 0.f;
  // group n's steps from its slot; kFull: all kL16Group of them
  auto group = [&](auto full, int n) {
    constexpr bool kFull = decltype(full)::value;
    const int steps = kFull ? kL16Group : T - n * kL16Group;
    const unsigned short* d = mine + (n % kSlots) * kSlot;
    float a0[kL16Group], x1[kL16Group], x2[kL16Group], a3[kL16Group];
#pragma unroll
    for (int s = 0; s < kL16Group; ++s) {
      if (kFull || s < steps) {
        const unsigned short* ds = d + s * 4 * kL16Span;
        const int* o = rd[s & 1];
        a0[s] = bf16_at(ds + o[0]);
        x1[s] = kNegLog2e * (bf16_at(ds + kL16Span + o[1]) + b_f);
        x2[s] = kNegLog2e * (bf16_at(ds + 2 * kL16Span + o[2]) + b_r);
        a3[s] = bf16_at(ds + 3 * kL16Span + o[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < kL16Group; ++s) {
      if (!kFull && s >= steps) break;
      const float f =
          hk::rcp_approx(1.f + hk::ex2_approx(fmaf(nv_f, c, x1[s])));
      c = fmaf(f, c - a0[s], a0[s]);
      const float r =
          hk::rcp_approx(1.f + hk::ex2_approx(fmaf(nv_r, c, x2[s])));
      const __nv_bfloat16 hv = __float2bfloat16_rn(fmaf(r, c - a3[s], a3[s]));
      if (live) *hp = hv;
      hp += step;
      if constexpr (kWithC) {
        const __nv_bfloat16 cv = __float2bfloat16_rn(c);
        if (live) *cp = cv;
        cp += step;
      }
    }
  };
  const int groups = (T + kL16Group - 1) / kL16Group;
  for (int n = 0; n < groups; ++n) {
    hk::cp_async_wait<kL16FwdAhead - 1>();  // this lane's copies of group n
    __syncwarp();  // the warp's; and every lane is past group n - 1's reads
    issue(n + kL16FwdAhead);  // into group n - 1's slot
    if ((n + 1) * kL16Group <= T)
      group(std::true_type{}, n);
    else
      group(std::false_type{}, n);
  }
  hk::cp_async_wait_all();
}

// grid (ceil(B / cols), ceil(H / units), 2), cols * units threads
// (ops/sru_fused.k1_bwd_bf16_geometry): warp (unit j, columns b0 .. b0 +
// 31) of direction blockIdx.z walks its steps in reverse scan order (t =
// T-1 .. 0 for the forward-running direction, c_prev = c[t-1]; t = 0 ..
// T-1 for the reverse-running one, c_prev = c[t+1]; 0 at the scan's end),
// its ring of kL16BwdAhead + 1 group slots of 6 rows a step: u0, u1, u2,
// the highway term, dh and c_prev. The adjoints are sru_scan.cuh's; the
// (v, b) sums of column block x go to part[x * 8H + dir * 4H + k H + j].
// Lanes past B compute on whatever their slot holds, store nothing and
// leave their sums out.
__global__ void __launch_bounds__(kLay0Threads)
sru_lay0_bwd16_kernel(const __nv_bfloat16* __restrict__ u_f,
                      const __nv_bfloat16* __restrict__ u_r,
                      const __nv_bfloat16* __restrict__ vb,
                      const __nv_bfloat16* __restrict__ c_f,
                      const __nv_bfloat16* __restrict__ c_r,
                      const __nv_bfloat16* __restrict__ dh_f,
                      const __nv_bfloat16* __restrict__ dh_r,
                      __nv_bfloat16* __restrict__ du_f,
                      __nv_bfloat16* __restrict__ du_r,
                      float* __restrict__ part, int T, int H, int B,
                      int cols) {
  constexpr int kSlots = kL16BwdAhead + 1, kSlot = kL16Group * 6 * kL16Span;
  constexpr int kSub = 4;  // steps whose values and gates go together
  extern __shared__ __align__(16) unsigned short ring16[];
  __shared__ float red[kLay0Threads / 32][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = blockDim.x / cols, j0 = blockIdx.y * units;
  const int b = blockIdx.x * cols + tid % cols, j = j0 + tid / cols;
  const int dir = blockIdx.z;
  const bool live = b < B && j < H;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // d(v_f, v_r, b_f, b_r)
  if (j < H) {  // the whole warp: one unit
    const unsigned short* cst = reinterpret_cast<const unsigned short*>(
        dir == 0 ? c_f : c_r);
    const float v_f = __bfloat162float(vb[(dir * 4 + 0) * H + j]);
    const float v_r = __bfloat162float(vb[(dir * 4 + 1) * H + j]);
    const float b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j]);
    const float b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j]);
    const float nv_f = kNegLog2e * v_f, nv_r = kNegLog2e * v_r;
    const long long row = (long long)H * B, n_hb = (long long)T * row;
    const long long col = (long long)j * B + (b - lane);
    // scan step i: t = T-1-i (direction 0) or i; c_prev at the next step's
    // t, none at the last
    const long long t0 = dir == 0 ? T - 1 : 0, dt = dir == 0 ? -1 : 1;
    unsigned short* mine = ring16 + warp * kSlots * kSlot;
    const int r_own = lane / 5, k_own = lane - 5 * r_own;
    const bool u_own = r_own < 4;
    const L16Block w{
        reinterpret_cast<const unsigned short*>(
            u_own ? (dir == 0 ? u_f : u_r)
                  : r_own == 4 ? (dir == 0 ? dh_f : dh_r)
                               : (dir == 0 ? c_f : c_r)) +
            8 * k_own,
        u_own ? t0 * 4 * row + r_own * row + col
              : (r_own == 4 ? t0 : t0 + dt) * row + col,
        (u_own ? 4 * row : row) * dt,
        (u_own ? 4 * n_hb : n_hb) - 8 * k_own,
        r_own == 5 ? T - 1 : T, r_own * kL16Span + 8 * k_own};
    const bool owner = lane < 6 * 5;
    auto issue = [&](int n) {
      l16_copy_group<6>(mine + (n % kSlots) * kSlot, n, owner, w);
    };
#pragma unroll
    for (int n = 0; n < kL16BwdAhead; ++n) issue(n);
    // read offsets: u's rows at steps of parity p (period 2), dh's at step
    // s of a group (period 8); c_prev's at s is dh's at s + 1
    const unsigned row4 = (unsigned)(4 * row), row1 = (unsigned)row;
    int ru[2][4], rh[kL16Group];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ru[p][r] = l16_offset(t0 + dt * p, row4, r * row1 + (unsigned)col,
                              lane);
#pragma unroll
    for (int s = 0; s < kL16Group; ++s)
      rh[s] = l16_offset(t0 + dt * s, row1, (unsigned)col, lane);
    float c_t = b < B ? bf16_at(cst + t0 * row + col + lane) : 0.f;
    const long long step = 4 * row * dt;
    __nv_bfloat16* dup = (dir == 0 ? du_f : du_r) + t0 * 4 * row + col +
                         lane;
    float dc = 0.f;
    // group n's steps from its slot; kFull: all kL16Group of them, none
    // the scan's last
    auto group = [&](auto full, int n) {
      constexpr bool kFull = decltype(full)::value;
      const int steps = kFull ? kL16Group : T - n * kL16Group;
      const unsigned short* d = mine + (n % kSlots) * kSlot;
#pragma unroll
      for (int sg = 0; sg < kL16Group; sg += kSub) {
        if (!kFull && sg >= steps) break;
        float u0[kSub], u1[kSub], u2[kSub], hw[kSub], g[kSub], cp[kSub];
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          const int s = sg + q;
          if (kFull || s < steps) {
            const unsigned short* ds = d + s * 6 * kL16Span;
            const int* o = ru[s & 1];
            u0[q] = bf16_at(ds + o[0]);
            u1[q] = bf16_at(ds + kL16Span + o[1]);
            u2[q] = bf16_at(ds + 2 * kL16Span + o[2]);
            hw[q] = bf16_at(ds + 3 * kL16Span + o[3]);
            g[q] = bf16_at(ds + 4 * kL16Span + rh[s]);
            cp[q] = kFull || n * kL16Group + s + 1 < T
                        ? bf16_at(ds + 5 * kL16Span +
                                  rh[(s + 1) % kL16Group])
                        : 0.f;
          }
        }
        // the gates, off the chain
        float ct[kSub], f[kSub], r[kSub], dm[kSub];
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          ct[q] = q == 0 ? c_t : cp[q - 1];
          f[q] = hk::rcp_approx(1.f + hk::ex2_approx(fmaf(
                     nv_f, cp[q], kNegLog2e * (u1[q] + b_f))));
          r[q] = hk::rcp_approx(1.f + hk::ex2_approx(fmaf(
                     nv_r, ct[q], kNegLog2e * (u2[q] + b_r))));
          dm[q] = g[q] * (ct[q] - hw[q]) * r[q] * (1.f - r[q]);
        }
        // the chain in dc
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (!kFull && sg + q >= steps) break;
          dc = g[q] * r[q] + dm[q] * v_r + dc;
          const float da = dc * (cp[q] - u0[q]) * f[q] * (1.f - f[q]);
          const __nv_bfloat16 d0 = __float2bfloat16_rn(dc * (1.f - f[q]));
          const __nv_bfloat16 d1 = __float2bfloat16_rn(da);
          const __nv_bfloat16 d2 = __float2bfloat16_rn(dm[q]);
          const __nv_bfloat16 d3 = __float2bfloat16_rn(g[q] * (1.f - r[q]));
          if (live) {
            dup[0] = d0;
            dup[row] = d1;
            dup[2 * row] = d2;
            dup[3 * row] = d3;
          }
          dup += step;
          acc[0] += da * cp[q];
          acc[1] += dm[q] * ct[q];
          acc[2] += da;
          acc[3] += dm[q];
          dc = dc * f[q] + da * v_f;
        }
        c_t = cp[kSub - 1];
      }
    };
    const int groups = (T + kL16Group - 1) / kL16Group;
    for (int n = 0; n < groups; ++n) {
      hk::cp_async_wait<kL16BwdAhead - 1>();  // this lane's copies of n
      __syncwarp();  // the warp's; every lane is past group n - 1's reads
      issue(n + kL16BwdAhead);  // into group n - 1's slot
      // full: all its steps there, and not the scan's last (no c_prev)
      if ((n + 1) * kL16Group < T)
        group(std::true_type{}, n);
      else
        group(std::false_type{}, n);
    }
    hk::cp_async_wait_all();
  }
  // the (v, b) sums of each unit over the block's live columns: each
  // warp's by shuffles, then the unit's cols / 32 warps in order
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = live ? acc[k] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  const int per = cols / 32;
  if (tid < 4 * units && j0 + tid / 4 < H) {
    const int uu = tid / 4, k = tid % 4;
    float s = 0.f;
    for (int w = 0; w < per; ++w) s += red[uu * per + w][k];
    part[(long long)blockIdx.x * 8 * H + (dir * 4 + k) * H + j0 + uu] = s;
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

// K2 forward in bf16 storage (x, W^T, vb, h and c bf16), held
// (sru_hid_fwd_bf16_kernel): U = W_d X a chunk of S steps at a time on
// bf16 mma.sync m16n8k16 with float32 accumulators (JAX's bf16 dot with a
// float32 result: the products of bf16 values are exact), the gates and
// the carry in float32, h and c rounded to bf16 as they are stored.
//
// What bounds it: its bytes (x read, h written: ~15 MB, ~4.5 us at the
// bs-8 sites) and the recurrence's chain (two MUFU ops, ~25 ns a step:
// ~3 us over L 118); the product (~1.4 GFLOP at bs 8) is ~2 us of the
// tensor cores. Its first design took 40-56 us at bs 8 and 31-45
// at bs 1 (PERF.md): one warp group did the copy, the product and the
// scan of a chunk in turn, the scan waited for the next chunk's copy, and
// at bs 1 (bt 1, B odd) every copy of X was a synchronous 2-byte load.
//
// The design. A block owns one direction, bt batch columns and a slice of
// `units` units (ops/sru_fused.k2_fwd_bf16_geometry: all of H where a
// block holds it, and the widest bt whose grid fills the card; each X
// value a block copies serves all its units, so the units are split only
// where no bt fills the card). Its warps have two roles:
//   - kFwd16Prod producer warps copy X's chunks and W_d's rows of the
//     slice, and form U of a chunk into one of two float32 U slots, every
//     fragment by ldmatrix (A = W_d [o][k], B = X [k][column], .trans);
//   - ceil(units bt / 32) scan warps, one thread a (unit, column), walk a
//     chunk's S steps from its U slot with c in a register, the highway
//     term (the direction's own input row) read from the chunk's X slot.
// The roles hand over slots by named barriers: the producers arrive on
// FULL[n % 2] when U of chunk n is in slot n % 2 and sync on EMPTY[n % 2]
// before they write it again; the scan threads sync on FULL and arrive on
// EMPTY when chunk n's scan is done. So chunk n + 1's product runs while
// chunk n is scanned. X lies in a ring of kFwd16Ahead + 2 chunk slots
// ([k][column], rows of N + 8 bf16), one commit group a chunk, the copies
// of chunk n + kFwd16Ahead issued at chunk n (after EMPTY: the slot they
// take, chunk n - 2's, has been scanned) and waited for kFwd16Ahead - 1
// chunks behind their issue, then one producer barrier for all their
// copies. A product job is 16 rows of U by all the chunk's columns: one A
// fragment a k16 step serves N / 16 independent pairs of products.
// A copy is vw values, vw the largest of 8, 4, 2 that divides bt and B.
// Where B is odd (vw 1: cp.async has no 2-byte copy and a row's values
// start at either half of a word), each (row, step) of bt values is copied
// as the bt / 2 + 1 words from the one that holds its first value into a
// ring of kFwd16Ahead + 1 raw slots, and the producers realign it into the
// X slot (zero past 2H, T and B) after its wait: every copy is a 4-byte
// cp.async. Shared memory (bytes, each region a multiple of 16), R = 3
// units rounded up to 16, K = 2H rounded up to 16:
//   w    R x (K + 8) bf16                W_d's rows of the slice, [o][k]
//   x    (kFwd16Ahead + 2) x K x (N + 8) bf16  X's chunks, [k][column]
//   raw  (kFwd16Ahead + 1) x K x S x (bt / 2 + 1) words, where vw is 1
//   u    2 x R x (N + max(bt, 2)) float32 U's slots, [o][column]
// Rows of N + 8 and K + 8 bf16 (4 mod 8 words) keep ldmatrix's eight
// 16-byte rows on distinct banks; U's rows of N + bt floats keep a scan
// warp's reads (bt columns of 32 / bt units) on distinct banks.
constexpr int kFwd16Prod = 6;
constexpr int kFwd16ScanMax = 256;
constexpr int kFwd16Ahead = 2;
constexpr int kFwd16XSlots = kFwd16Ahead + 2;
constexpr int kFwd16RawSlots = kFwd16Ahead + 1;
// the named barriers: FULL[2], EMPTY[2], the producers'
constexpr int kBarFull = 1, kBarEmpty = 3, kBarProd = 5;

struct HidFwd16Smem {
  int w, x, raw, u, total;
  __host__ __device__ HidFwd16Smem(int H, int N, int U, int bt, int vw) {
    const int R = round_up(3 * U, 16), K = round_up(2 * H, 16), S = N / bt;
    w = 0;
    x = w + round_up(2 * R * (K + 8), 16);
    raw = x + round_up(2 * kFwd16XSlots * K * (N + 8), 16);
    u = raw + (vw == 1 ? round_up(4 * kFwd16RawSlots * K * S * (bt / 2 + 1),
                                  16)
                       : 0);
    total = u + round_up(4 * 2 * R * (N + (bt > 2 ? bt : 2)), 16);
  }
};

// The values a copy of X's chunk: the largest of 8, 4, 2 dividing bt and
// B, else 1 (B odd, or bt 1: the word copies)
__host__ __device__ __forceinline__ int hid_fwd16_vec(int bt, int B) {
  return bt % 8 == 0 && B % 8 == 0   ? 8
         : bt % 4 == 0 && B % 4 == 0 ? 4
         : bt % 2 == 0 && B % 2 == 0 ? 2
                                     : 1;
}

// grid (ceil(B / bt), 2, ceil(H / units)), 32 (kFwd16Prod + ceil(units bt
// / 32)) threads; bt 1, 2, 4 or 8, N = S bt 16, 32 or 64. Block (tile,
// dir, z) owns units j0 .. j0 + hs - 1 (j0 = z units) and columns b0 ..
// b0 + bt - 1. Scan thread p (tid - 32 kFwd16Prod) takes unit j0 + p / bt
// of column b0 + p % bt.
__global__ void __launch_bounds__(kFwd16Prod * 32 + kFwd16ScanMax, 2)
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
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const int dir = blockIdx.y, b0 = blockIdx.x * bt, tid = threadIdx.x;
  const int j0 = blockIdx.z * units, hs = min(units, H - j0);
  const int N = S * bt, h2 = 2 * H;
  const int R = round_up(3 * units, 16), K = round_up(h2, 16);
  const int ws = K + 8, xs = N + 8, us = N + (bt > 2 ? bt : 2);
  const int vw = hid_fwd16_vec(bt, B);
  const HidFwd16Smem lay(H, N, units, bt, vw);
  unsigned short* w_s = reinterpret_cast<unsigned short*>(sm + lay.w);
  unsigned short* x_s = reinterpret_cast<unsigned short*>(sm + lay.x);
  unsigned short* raw = reinterpret_cast<unsigned short*>(sm + lay.raw);
  float* u_s = reinterpret_cast<float*>(sm + lay.u);
  const unsigned short* xf16 = reinterpret_cast<const unsigned short*>(x_f);
  const unsigned short* xr16 = reinterpret_cast<const unsigned short*>(x_r);
  const unsigned short* wt16 = reinterpret_cast<const unsigned short*>(wt);
  const int n_chunks = (T + S - 1) / S;
  const int n_prod = 32 * kFwd16Prod, n_all = blockDim.x;
  const int lbt = __ffs(bt) - 1, lS = __ffs(S) - 1, lN = __ffs(N) - 1;
  const int lvw = __ffs(vw) - 1;

  if (tid < n_prod) {
    // ------------------------------------------------------- producers
    const int warp = tid >> 5;
    const int seg = bt / 2 + 1;  // words a raw (row, step)
    const long long total = (long long)T * H * B;  // values of x_f, x_r
    // x_d's element of X row k (< 2H) at scan step ii, column b0
    auto x_elem = [&](int k, int ii) {
      const long long t = dir == 0 ? ii : T - 1 - ii;
      return (t * H + (k < H ? k : k - H)) * B + b0;
    };
    // W_d's rows of the slice: row o = gate * units + jl is wt's row (3 dir
    // + gate) H + j0 + jl; zero past the slice, past 3 units and past 2H;
    // two values a copy (2H is even)
    for (int e = 2 * tid; e < R * K; e += 2 * n_prod) {
      const int o = e / K, k = e - o * K, gate = o / units;
      const int jl = o - gate * units;
      const bool ok = gate < 3 && jl < hs && k < h2;
      hk::cp_async4(
          w_s + o * ws + k,
          ok ? wt16 + ((long long)(3 * dir + gate) * H + j0 + jl) * h2 + k
             : wt16,
          ok);
    }
    // chunk n's copies, one commit group (empty past the last chunk)
    auto issue = [&](int n) {
      if (n < n_chunks && vw > 1) {
        unsigned short* dst = x_s + (n % kFwd16XSlots) * K * xs;
        for (int e = tid << lvw; e < K * N; e += n_prod << lvw) {
          const int k = e >> lN, col = e & (N - 1);
          const int c = col & (bt - 1), ii = n * S + (col >> lbt);
          const bool ok = k < h2 && ii < T && b0 + c < B;
          hk::copy_bf16(dst + k * xs + col,
                        ok ? (k < H ? xf16 : xr16) + x_elem(k, ii) + c : xf16,
                        vw, ok);
        }
      } else if (n < n_chunks) {
        // the words of (row k, step s) from the one holding its first
        // value, as many values of each as lie in x (0, 2 or 4 bytes)
        unsigned short* dst = raw + (n % kFwd16RawSlots) * K * S * 2 * seg;
        for (int e = tid; e < K * S * seg; e += n_prod) {
          const int ks = e / seg, m = e - ks * seg;
          const int k = ks >> lS, ii = n * S + (ks & (S - 1));
          int bytes = 0;
          const unsigned short* src = xf16;
          if (k < h2 && ii < T) {
            const long long w = (x_elem(k, ii) >> 1) + m;
            const long long left = total - 2 * w;
            bytes = left >= 2 ? 4 : left == 1 ? 2 : 0;
            src = (k < H ? xf16 : xr16) + 2 * w;
          }
          hk::cp_async4_n(dst + (ks * seg + m) * 2, src, bytes);
        }
      }
      hk::cp_async_commit();
    };
    // chunk n's raw words into its X slot: X[k][s bt + c] is the (k, s)
    // segment's value c from the first value's half of its word; zero past
    // 2H, T and B
    auto realign = [&](int n) {
      const unsigned short* src = raw + (n % kFwd16RawSlots) * K * S * 2 * seg;
      unsigned short* dst = x_s + (n % kFwd16XSlots) * K * xs;
      for (int ks = tid; ks < K * S; ks += n_prod) {
        const int k = ks >> lS, s = ks & (S - 1), ii = n * S + s;
        const bool on = k < h2 && ii < T;
        const int sh = on ? (int)(x_elem(k, ii) & 1) : 0;
        const unsigned short* p = src + ks * 2 * seg + sh;
        for (int c = 0; c < bt; ++c)
          dst[k * xs + (s << lbt) + c] =
              on && b0 + c < B ? p[c] : (unsigned short)0;
      }
    };
    // U[o][column] = W_d[o][k] X[k][column] of chunk n into U slot n % 2:
    // a job is 16 rows x the chunk's N columns, each k16 step one A
    // fragment for N / 16 B fragment pairs (independent accumulators), the
    // fragments by ldmatrix .x4 (A from the [o][k] tile, matrices at o 0,
    // 8, 0, 8 x k 0, 0, 8, 8; B, .trans, from the [k][column] tile, k 0, 8,
    // 0, 8 x columns 0, 0, 8, 8)
    const int g = hk::lane_g(), q = hk::lane_q();
    const int lm = (tid & 31) >> 3, lr = tid & 7;
    const int lo = lr + 8 * (lm & 1), hi = 8 * (lm >> 1);
    const int n16 = N >> 4;  // 1, 2 or 4 column tiles
    auto project = [&](int n) {
      const unsigned short* xc = x_s + (n % kFwd16XSlots) * K * xs;
      float* uc = u_s + (n & 1) * R * us;
      const unsigned b_at = hk::smem_u32(xc + lo * xs + hi);
      for (int o0 = 16 * warp; o0 < R; o0 += 16 * kFwd16Prod) {
        float acc[4][2][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[nt][h][v] = 0.f;
        const unsigned a_at = hk::smem_u32(w_s + (o0 + lo) * ws + hi);
        for (int k0 = 0; k0 < K; k0 += 16) {
          uint32_t a[4];
          hk::ldsm_x4_at(a, a_at + 2 * k0);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt < n16) {
              uint32_t b[4];
              hk::ldsm_x4_trans_at(b, b_at + 2 * (k0 * xs + 16 * nt));
              hk::mma_bf16(acc[nt][0], a, {b[0], b[1]});
              hk::mma_bf16(acc[nt][1], a, {b[2], b[3]});
            }
          }
        }
        // D (row o, column): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= n16) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* pu = uc + (o0 + g) * us + 16 * nt + 8 * h + 2 * q;
            *reinterpret_cast<float2*>(pu) =
                make_float2(acc[nt][h][0], acc[nt][h][1]);
            *reinterpret_cast<float2*>(pu + 8 * us) =
                make_float2(acc[nt][h][2], acc[nt][h][3]);
          }
        }
      }
    };

    for (int n = 0; n < kFwd16Ahead; ++n) issue(n);  // W_d with chunk 0
    for (int n = 0; n < n_chunks; ++n) {
      // U slot n % 2 and X slot (n + kFwd16Ahead) % kFwd16XSlots are
      // free: chunk n - 2 is scanned
      if (n >= 2) hk::bar_sync(kBarEmpty + (n & 1), n_all);
      hk::cp_async_wait<kFwd16Ahead - 1>();  // this thread's copies of n
      hk::bar_sync(kBarProd, n_prod);  // everyone's; chunk n - 1 projected
      issue(n + kFwd16Ahead);
      if (vw == 1) {
        realign(n);
        hk::bar_sync(kBarProd, n_prod);
      }
      project(n);
      hk::bar_arrive(kBarFull + (n & 1), n_all);
    }
    hk::cp_async_wait_all();
  } else {
    // ------------------------------------------------------- scan
    const int p = tid - n_prod, jl = p >> lbt, cc = p & (bt - 1);
    const int j = j0 + jl, b = b0 + cc;
    const bool live = jl < hs && b < B;
    __nv_bfloat16* h = dir == 0 ? h_f : h_r;
    __nv_bfloat16* cs = dir == 0 ? c_f : c_r;  // null when serving
    const long long row = (long long)H * B, col0 = (long long)j * B + b;
    float v_f = 0.f, v_r = 0.f, b_f = 0.f, b_r = 0.f;
    if (live) {
      v_f = __bfloat162float(vb[(dir * 4 + 0) * H + j]);
      v_r = __bfloat162float(vb[(dir * 4 + 1) * H + j]);
      b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j]);
      b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j]);
    }
    // sigmoid(u + v c + b) = 1 / (1 + 2^(-log2(e) (u + b) - log2(e) v c)):
    // the step's -log2(e) (u + b) is formed off the chain, so the chain in
    // c is one FMA, ex2, an add, rcp and the FMA of c (and h's the same)
    constexpr float kNegLog2e = -1.4426950408889634f;
    const float nv_f = kNegLog2e * v_f, nv_r = kNegLog2e * v_r;
    float c = 0.f;
    constexpr int kG = 8;  // steps whose loads go before their chain
    for (int n = 0; n < n_chunks; ++n) {
      hk::bar_sync(kBarFull + (n & 1), n_all);
      if (live) {
        const float* u = u_s + (n & 1) * R * us + jl * us + cc;
        // the highway: this direction's own input, X's row dir H + j
        const unsigned short* xh = x_s +
                                   (n % kFwd16XSlots) * K * xs +
                                   (dir * H + j) * xs + cc;
        const int steps = min(S, T - n * S);
        for (int s0 = 0; s0 < steps; s0 += kG) {
          float u0[kG], u1[kG], u2[kG], hw[kG];
#pragma unroll
          for (int k = 0; k < kG; ++k) {
            const int off = (s0 + k) << lbt;
            if (s0 + k < steps) {
              u0[k] = u[off];
              u1[k] = u[units * us + off];
              u2[k] = u[2 * units * us + off];
              hw[k] = __bfloat162float(__ushort_as_bfloat16(xh[off]));
            }
          }
#pragma unroll
          for (int k = 0; k < kG; ++k) {
            if (s0 + k >= steps) break;
            const int i = n * S + s0 + k;
            const long long t = dir == 0 ? i : T - 1 - i;
            const float f = hk::rcp_approx(
                1.f + hk::ex2_approx(fmaf(nv_f, c, kNegLog2e * (u1[k] + b_f))));
            c = fmaf(f, c - u0[k], u0[k]);
            const float r = hk::rcp_approx(
                1.f + hk::ex2_approx(fmaf(nv_r, c, kNegLog2e * (u2[k] + b_r))));
            h[t * row + col0] = __float2bfloat16_rn(fmaf(r, c - hw[k], hw[k]));
            if (cs) cs[t * row + col0] = __float2bfloat16_rn(c);
          }
        }
      }
      if (n + 2 < n_chunks) hk::bar_arrive(kBarEmpty + (n & 1), n_all);
    }
  }
}

// K2 forward in bf16 storage where W_d's rows of even a few units and the
// held kernel's X ring do not fit one block (ops/sru_fused.
// k2_fwd_bf16_geometry's `stream`: H above 504, 272 where B is not a multiple of 4): the
// float32 kernel's streamed reduction (sru_hid_fwd_kernel<true>) in bf16,
// its first bf16 design, kept. The block keeps one float32 U slot;
// stage s is k slice s % ksl (kFwdK = 32 rows of X's chunk s / ksl in
// bf16, two k16 steps, and the same 32 columns of the block's rows of W_d)
// in ring slot s % kFwdStages, the copies of the next kFwdStages - 1
// stages in flight while the warps multiply this one. Each warp adds its
// jobs' products of the slice to their float32 U entries (its own
// entries, the slices in order), and after a chunk's last slice a
// barrier, then the scan (one thread a unit and column, the highway read
// from memory kFwdAhead steps ahead). X's chunk is copied w values at a
// time, w the largest of 8, 4, 2 that divides bt and B, or by plain loads
// where B is odd or bt is 1: such a copy is a store to shared memory made
// after the barrier that ends the slot's last reads, and read after the
// barrier that opens its stage, as the cp.async copies are. A fragments
// pair two k rows of X ([k][column], rows of N + 8 bf16): two 2-byte
// reads and a pack a register; B registers are aligned 4-byte reads of
// W_d's [o][k] rows.
__global__ void __launch_bounds__(kFwdThreads, 2)
sru_hid_fwd_bf16_stream_kernel(const __nv_bfloat16* __restrict__ x_f,
                               const __nv_bfloat16* __restrict__ x_r,
                               const __nv_bfloat16* __restrict__ wt,
                               const __nv_bfloat16* __restrict__ vb,
                               __nv_bfloat16* __restrict__ h_f,
                               __nv_bfloat16* __restrict__ h_r,
                               __nv_bfloat16* __restrict__ c_f,
                               __nv_bfloat16* __restrict__ c_r, int T, int H,
                               int B, int bt, int S, int units) {
  static_assert(kFwdK % 16 == 0 && kFwdK / 2 <= 32,
                "a slice is whole k16 steps; a lane copies two columns");
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.y, b0 = blockIdx.x * bt, tid = threadIdx.x;
  const int j0 = blockIdx.z * units, hs = min(units, H - j0);
  const int N = S * bt, h2 = 2 * H, h3 = 3 * H;
  const int rows = round_up(3 * units, 8 * kFwdNB);
  const int xs = N + 8, us = N + 4;
  float* u_s = reinterpret_cast<float*>(smem4);  // (rows, us): U[o][col]
  const unsigned short* xf16 = reinterpret_cast<const unsigned short*>(x_f);
  const unsigned short* xr16 = reinterpret_cast<const unsigned short*>(x_r);
  const unsigned short* wt16 = reinterpret_cast<const unsigned short*>(wt);
  const unsigned short* wd = wt16 + (long long)dir * h3 * h2;
  const int n_chunks = (T + S - 1) / S;
  const int vw = hid_fwd16_vec(bt, B);
  const int warp = tid >> 5, lane = tid & 31;

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
  // U^T += X^T W_d^T over one k16 step: A (column m, k) = X[k][m], the
  // lane's rows k = 2q, 2q+1, 2q+8, 2q+9 and columns g, g + 8 of each m16
  // tile from xl; B from W_d's rows at wl (rows wstride apart)
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
  // a job's accumulator entries in U: D (column m, row o) c0 (g, 2q), c1
  // (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1), U[o][m]
  auto u_entry = [&](int r0, int m0, int mt, int nb) {
    return u_s + (r0 + 8 * nb + 2 * q) * us + m0 + 16 * mt + g;
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
    const float* u = u_s + jl * us + tid % bt;
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

  const int ksl = (h2 + kFwdK - 1) / kFwdK, total = n_chunks * ksl;
  const int kws = kFwdK + 8;  // a row of W_d's slice: 20 words
  const int slot_elems = kFwdK * xs + rows * kws;
  // slots of (kFwdK, xs) X, then (rows, kws) W_d, bf16
  unsigned short* ring = reinterpret_cast<unsigned short*>(u_s + rows * us);
  // stage st into ring slot `slot`, one commit group (empty past the
  // last): X's rows k0 .. k0 + kFwdK - 1 of chunk st / ksl and those
  // columns of W_d's rows of the block's units, a warp a row, a lane two
  // columns (2H is even: a pair never straddles the row's end)
  auto load_stage = [&](int st, int slot) {
    if (st < total) {
      const int n = st / ksl, k0 = (st - n * ksl) * kFwdK;
      unsigned short* xd_s = ring + slot * slot_elems;
      unsigned short* wd_s = xd_s + kFwdK * xs;
      load_x(xd_s, n, k0, kFwdK);
      int gate = warp / units, jw = warp % units;
      for (int o = warp; o < rows; o += kFwdThreads / 32) {
        if (lane < kFwdK / 2) {
          const int k = k0 + 2 * lane;
          const bool ok = gate < 3 && jw < hs && k < h2;
          hk::cp_async4(wd_s + o * kws + 2 * lane,
                        ok ? wd + (long long)(gate * H + j0 + jw) * h2 + k
                           : wt16,
                        ok);
        }
        for (jw += kFwdThreads / 32; jw >= units; jw -= units) ++gate;
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
          const float* u = u_entry(r0, m0, mt, nb);
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
#pragma unroll
      for (int mt = 0; mt < kFwdMT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kFwdNB; ++nb) {
          float* u = u_entry(r0, m0, mt, nb);
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

// Rows of a time-major (T, R, B) operand, each a row of B floats: rows
// [0, r0) of step t at p0 + (t * step0 + r) * B, rows [r0, R) at p1 + (t *
// step1 + r - r0) * B. X = [x_f; x_r] is two such halves; U, du and dx's
// halves are one each (r0 >= R).
struct Rows {
  float* p0;
  float* p1;
  int r0, step0, step1;
  __device__ __forceinline__ float* row(int t, int r, int B) const {
    return r < r0 ? p0 + ((long long)t * step0 + r) * B
                  : p1 + ((long long)t * step1 + r - r0) * B;
  }
};

// C_t = op(A) B_t for every step t = blockIdx.z, where op(A)[m][k] is
// A[m * lda + k], or A[k * lda + m] with TransA, B_t is (K, N) and C_t
// (M, N) with N = B columns; with Accum, C_t += op(A) B_t. grid (ceil(N /
// 64), ceil(M / 64), T), kGemmThreads threads: thread (tx, ty) = (tid %
// 16, tid / 16) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of
// the tile. Each stage stages kStage rows of the reduction, the next
// stage's loads in flight in registers while this one's FMAs run.
template <bool TransA, bool Accum>
__global__ void __launch_bounds__(kGemmThreads)
sru_hid_bwd_gemm_kernel(const float* __restrict__ A, int lda, Rows b,
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
      ra[r] = gm < M && gk < K ? A[ia] : 0.f;
      const int kb = k0 + e / kTile, gn = n0 + e % kTile;
      rb[r] = kb < K && gn < N ? b.row(t, kb, N)[gn] : 0.f;
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
// columns.
__global__ void __launch_bounds__(kGemmThreads)
sru_hid_bwd_wgrad_kernel(Rows a, Rows b, float* __restrict__ part,
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
      rb[r] = ok && gn < N ? b.row(t, gn, B)[bb] : 0.f;
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

// K2 backward in bf16 storage, one fused kernel (sru_hid_bwd_bf16_kernel):
// the bf16 forward's shape turned round. A block of kBwdThreads threads
// owns one direction, a tile of bt batch columns and a slice of `units`
// units (all of H at the presets), keeps that slice's rows of W_d (3 x
// units rows of W^T, bf16) in shared memory and walks T in chunks of S
// steps in the direction's reverse scan order (t descending for the
// forward direction, ascending for the reverse one). Per chunk of N = S *
// bt columns (column s * bt + c for scan step s and batch column c):
//   1. cp.async has brought the chunk's X = [x_f; x_r] (2H x N), c (the
//      slice's units, S + 1 steps: c_t and c_prev) and dh (S steps) into
//      one of two slots; the next chunk's copies go into the other, issued
//      by the threads the scan leaves idle while it runs (where it leaves
//      half of them), else by all before U;
//   2. U = W_d X (3 units x N, depth 2H) on bf16 mma.sync.m16n8k16 into
//      float32 shared memory: the Pallas kernel's jax.lax.dot(wt_f, x_t,
//      preferred_element_type=f32);
//   3. the adjoint scan (csrc/sru_scan.cuh's arithmetic, with the bf16
//      forward's sigmoid_fast), one thread a (unit, column), dc in a
//      register across chunks and the four (v, b) sums in registers, the
//      gates of four steps before the chain in dc over them; it writes du,
//      each value split into three bf16 parts (hi + mid + lo: the float32
//      du of the Pallas kernel to ~2^-27), and the highway term dh (1 - r);
//   4. dx = W_d^T du (2H x N, depth 3 units), three bf16 products a
//      fragment pair (one a part of du, each exact in float32) into three
//      float32 accumulators, added lo + mid, then hi, plus the highway term
//      on the direction's own rows, rounded to bf16 per direction as the
//      Pallas kernel's dxa_ref[t] = dx.astype(...), and stored to that
//      direction's bf16 buffer (with several unit slices: float32 partials
//      over the units);
//   5. dW_d += du X^T (3 units x 2H, depth N), the three parts again, the
//      tensor core's accumulators added every chunk to float32 sums in
//      shared memory (a sum left in them over T steps would drift toward
//      zero).
// Every fragment comes from shared memory by ldmatrix (.trans for the
// [k][m] and [k][n] tiles). At the end the block writes its dW and (v, b)
// partials (one a batch tile), which sru_hid_bwd_sum_kernel<bf16> adds in
// a fixed order and rounds once; sru_hid_bwd_dx_add_kernel adds the two
// directions' bf16 dx in bf16 (JAX's caller: dx = dxa + dxb), after
// summing a split's float32 partials in order and rounding each direction
// once. U, du and dx never touch device memory in float32 at one slice; a
// call reads x, c and dh once (c twice at chunk edges), writes bf16 dx
// twice and reads it once.
// What bounds it at the preset (H 32): the bytes (~15 MB at the bs-4 freq
// site) and the products (~5 GFLOP of bf16 tensor-core work: U once, dx
// and dW three times), 4-5 us each. In practice a block's chunk is a
// sequence of dependent phases (U, the scan's S steps, dx and dW) with
// one block an SM: clock64 stamps on the H100 gave ~50% of a chunk to dx
// and dW (the mma.sync chains and the dx stores), ~30% to the scan, ~10%
// each to U and the copies' issue (PERF.md).
//
// Units are sliced where W_d's rows, X's two slots and the dW sums do not
// fit one block (ops/sru_fused.k2_bwd_bf16_geometry: H above the
// presets'); each slice reads all of X and writes the dx partial of its
// units. Shared memory (bytes, each region a multiple of 16), R = 3 units
// rounded up to 16, K = 2H rounded up to 16:
//   w_s  R x (K + 8) bf16      W_d's rows of the slice, [o][i]
//   x_s  2 x K x (N + 8) bf16  X, [i][col]
//   c_s  2 x units x (N + bt) bf16, dh_s 2 x units x N bf16
//   u_s  R x (N + 8) float32   U, [o][col]
//   d_s  3 x R x (N + 8) bf16  du's three parts, [o][col]
//   h_s  units x N float32     the highway term
//   w_f  R x (K + 8) float32   the dW sums, [o][i]
// Rows of N + 8 and K + 8 bf16 (4 mod 8 words): ldmatrix's eight 16-byte
// rows and the 4-byte reads meet distinct banks; rows of N + 8 and K + 8
// floats keep a warp's float2 stores to U and the dW sums within two
// wavefronts.
//
// kStream (where W_d's rows of even 8 units, X's two slots and the dW sums
// do not fit one block, H above 384): nothing of the block's shared
// memory grows with H. X's chunk and W_d's columns stream through a ring
// of kBwdStages stages, each kBwdK rows of X (of N + 8) and the same kBwdK
// columns of the slice's rows of W_d (of kBwdK + 8), twice a chunk: the
// first pass sums U over the stages in float32 shared memory (each warp
// its own entries, the stages in order), then the scan; the second pass
// takes dx's rows and dW's columns of each stage's slice, the dW sums
// added every chunk to the block's own rows of its dW partial in device
// memory (read back from L2). The highway rows (the slice's units) come
// with c and dh, two slots of units x N; a chunk's c, dh and highway
// copies go with its first stage.
constexpr int kBwdThreads = 512;
constexpr int kBwdK = 32;
constexpr int kBwdStages = 3;

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

struct HidBwdSmem {
  int w, x, c, dh, hx, u, d, h, wf, ring, total;
  __host__ __device__ HidBwdSmem(int H, int N, int U, int bt, bool stream) {
    const int R = round_up(3 * U, 16), K = round_up(2 * H, 16);
    w = 0;
    x = w + (stream ? 0 : align16(2 * R * (K + 8)));
    c = x + (stream ? 0 : align16(2 * 2 * K * (N + 8)));
    dh = c + align16(2 * 2 * U * (N + bt));
    hx = dh + align16(2 * 2 * U * N);
    u = hx + (stream ? align16(2 * 2 * U * N) : 0);
    d = u + align16(4 * R * (N + 8));
    h = d + align16(2 * 3 * R * (N + 8));
    wf = h + align16(4 * U * N);
    ring = wf + (stream ? 0 : align16(4 * R * (K + 8)));
    total = ring + (stream ? align16(2 * kBwdStages *
                                     (kBwdK * (N + 8) + R * (kBwdK + 8)))
                           : 0);
  }
};

// v = hi + mid + lo, each a bf16 bit pattern: hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid); both differences are exact in
// float32, so the three keep v to ~2^-27 |v|
__device__ __forceinline__ void split3(float v, unsigned short& hi,
                                       unsigned short& mid,
                                       unsigned short& lo) {
  const __nv_bfloat16 a = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(a);
  const __nv_bfloat16 b = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(b);
  hi = __bfloat16_as_ushort(a);
  mid = __bfloat16_as_ushort(b);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

// grid (ceil(B / bt), 2, ceil(H / units)), kBwdThreads threads; bt 1, 2, 4
// or 8, units * bt <= kBwdThreads, N = S * bt a multiple of 16. Block
// (tile, dir, z) owns units j0 .. j0 + hs - 1 (j0 = z units). dxd: with
// one slice bf16 (2, T, 2H, B), each direction's dx rounded; else float32
// (slices, 2, T, 2H, B), each slice's partial. dw_part (tiles, 6H, 2H) and
// dvb_part (tiles, 8, H) float32, one partial a batch tile.
template <bool kStream>
__global__ void __launch_bounds__(kBwdThreads, 1)
sru_hid_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x_f,
                        const __nv_bfloat16* __restrict__ x_r,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ vb,
                        const __nv_bfloat16* __restrict__ c_f,
                        const __nv_bfloat16* __restrict__ c_r,
                        const __nv_bfloat16* __restrict__ dh_f,
                        const __nv_bfloat16* __restrict__ dh_r,
                        void* __restrict__ dxd, float* __restrict__ dw_part,
                        float* __restrict__ dvb_part, int T, int H, int B,
                        int bt, int S, int units) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const int dir = blockIdx.y, tile = blockIdx.x, b0 = tile * bt;
  const int j0 = blockIdx.z * units, hs = min(units, H - j0);
  const bool split = gridDim.z > 1;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = hk::lane_g(), q = hk::lane_q();
  const int N = S * bt, h2 = 2 * H, lbt = __ffs(bt) - 1;  // bt = 2^lbt
  const int R = round_up(3 * units, 16), K = round_up(h2, 16);
  const int ws = K + 8, xs = N + 8, cs = N + bt, us = N + 8, ds = N + 8;
  const int wk = kBwdK + 8;  // a row of W_d's columns in a stage
  const HidBwdSmem lay(H, N, units, bt, kStream);
  unsigned short* w_s = reinterpret_cast<unsigned short*>(sm + lay.w);
  unsigned short* x_s = reinterpret_cast<unsigned short*>(sm + lay.x);
  unsigned short* c_s = reinterpret_cast<unsigned short*>(sm + lay.c);
  unsigned short* dh_s = reinterpret_cast<unsigned short*>(sm + lay.dh);
  unsigned short* hx_s = reinterpret_cast<unsigned short*>(sm + lay.hx);
  float* u_s = reinterpret_cast<float*>(sm + lay.u);
  unsigned short* d_s = reinterpret_cast<unsigned short*>(sm + lay.d);
  float* h_s = reinterpret_cast<float*>(sm + lay.h);
  float* w_f = reinterpret_cast<float*>(sm + lay.wf);
  unsigned short* ring = reinterpret_cast<unsigned short*>(sm + lay.ring);
  const int slot_elems = kBwdK * xs + R * wk;  // a stage: X, then W_d
  const unsigned short* xf16 = reinterpret_cast<const unsigned short*>(x_f);
  const unsigned short* xr16 = reinterpret_cast<const unsigned short*>(x_r);
  const unsigned short* wt16 = reinterpret_cast<const unsigned short*>(wt);
  const unsigned short* cd = reinterpret_cast<const unsigned short*>(
      dir == 0 ? c_f : c_r);
  const unsigned short* gd = reinterpret_cast<const unsigned short*>(
      dir == 0 ? dh_f : dh_r);
  const unsigned short* xd = dir == 0 ? xf16 : xr16;  // the highway input
  const int n_chunks = (T + S - 1) / S;
  const int vw = bt % 8 == 0 && B % 8 == 0   ? 8
                 : bt % 4 == 0 && B % 4 == 0 ? 4
                 : bt % 2 == 0 && B % 2 == 0 ? 2
                                             : 1;
  float* dwp = dw_part + (long long)tile * 6 * H * h2;
  // the time step of scan step ii
  auto t_of = [&](int ii) { return dir == 0 ? T - 1 - ii : ii; };
  // dwt's row of row o = gate * units + jl of the slice, or -1 past it
  auto dw_row = [&](int o) {
    const int gate = o / units, jl = o % units;
    return gate < 3 && jl < hs ? (dir * 3 + gate) * H + j0 + jl : -1;
  };

  // W_d's columns k0 .. k0 + nk - 1 of the slice's rows into dst (rows of
  // `stride`): row o = gate * units + jl is wt's row (dir * 3 + gate) H +
  // j0 + jl; zero past the slice, past 3 units and past 2H; two values a
  // copy (2H is even: a pair never straddles a row's end)
  auto load_w = [&](unsigned short* dst, int stride, int k0, int nk) {
    for (int e = 2 * tid; e < R * nk; e += 2 * kBwdThreads) {
      const int o = e / nk, i = e % nk, row = dw_row(o);
      const bool ok = row >= 0 && k0 + i < h2;
      hk::cp_async4(dst + o * stride + i,
                    ok ? wt16 + (long long)row * h2 + k0 + i : wt16, ok);
    }
  };
  // rows r < nr of chunk n's columns of the steps n S .. n S + ns - 1 into
  // dst (rows of `stride`), vw values a copy: X's rows r0 + r (x_f's, then
  // x_r's) or a (T, H, B) operand's rows j0 + r; zero past T, B, 2H or the
  // slice
  // The copies go to threads lt = tid - t0 of nt (all of them, or the ones
  // the scan leaves idle).
  int t0 = 0, nt = kBwdThreads;
  auto load = [&](unsigned short* dst, int stride, int n, int ns, int nr,
                  bool is_x, int r0, const unsigned short* src) {
    // the thread's copies e = vw (lt + m nt), (r, col) = divmod(e, w),
    // walked by adding the step's quotient and remainder
    const int w = ns * bt, step = vw * nt, lt = tid - t0;
    const int dr = step / w, dcol = step % w;
    int r = vw * lt / w, col = vw * lt % w;
    while (r < nr) {
      const int s = col >> lbt, c = col & (bt - 1);
      const int ii = n * S + s, k = r0 + r;
      const bool ok = ii < T && b0 + c < B && (is_x ? k < h2 : r < hs);
      const unsigned short* p = src;
      if (ok) {
        const long long t = t_of(ii);
        p = is_x ? (k < H ? xf16 + (t * H + k) * B : xr16 + (t * H + k - H) * B)
                 : src + (t * H + j0 + r) * B;
        p += b0 + c;
      }
      hk::copy_bf16(dst + r * stride + col, p, vw, ok);
      r += dr;
      col += dcol;
      if (col >= w) {
        col -= w;
        ++r;
      }
    }
  };
  // chunk n's c (S + 1 steps), dh and, streamed, the highway rows into
  // their slot n % 2
  auto load_aux = [&](int n) {
    const int slot = n & 1;
    load(c_s + slot * units * cs, cs, n, S + 1, units, false, 0, cd);
    load(dh_s + slot * units * N, N, n, S, units, false, 0, gd);
    if constexpr (kStream)
      load(hx_s + slot * units * N, N, n, S, units, false, 0, xd);
  };

  // du's parts start at zero (rows past the slice's units stay so), and
  // the dW sums (held)
  for (int e = tid; e < 3 * R * ds; e += kBwdThreads) d_s[e] = 0;
  if constexpr (!kStream)
    for (int e = tid; e < R * ws; e += kBwdThreads) w_f[e] = 0.f;

  // the scan thread: unit j0 + jl, column b0 + cc
  const int jl = tid >> lbt, cc = tid & (bt - 1);
  const bool scan_thread = tid < units * bt;
  const bool live = jl < hs && b0 + cc < B && scan_thread;
  float v_f = 0.f, v_r = 0.f, b_f = 0.f, b_r = 0.f;
  if (live) {
    v_f = __bfloat162float(vb[(dir * 4 + 0) * H + j0 + jl]);
    v_r = __bfloat162float(vb[(dir * 4 + 1) * H + j0 + jl]);
    b_f = __bfloat162float(vb[(dir * 4 + 2) * H + j0 + jl]);
    b_r = __bfloat162float(vb[(dir * 4 + 3) * H + j0 + jl]);
  }
  float dc = 0.f, acc4[4] = {0.f, 0.f, 0.f, 0.f};
  auto bf = [](unsigned short v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  };
  const int own0 = dir * H + j0;  // dx's rows that take the highway term

  // the fragments of a 16 x 16 tile at p (rows of `stride`) by ldmatrix
  // .x4, lane l giving matrix l / 8's row l % 8: an A fragment from an
  // [m][k] tile (matrices at m 0, 8, 0, 8 x k 0, 0, 8, 8) or a [k][m] one
  // (.trans: k 0, 0, 8, 8 x m 0, 8, 0, 8); a B pair (two n8 tiles) from an
  // [n][k] tile (n 0, 0, 8, 8 x k 0, 8, 0, 8) or a [k][n] one (.trans: k
  // 0, 8, 0, 8 x n 0, 0, 8, 8)
  const int lm = (tid & 31) >> 3, lr = tid & 7;
  const int lo_a = lr + 8 * (lm & 1), hi_a = 8 * (lm >> 1);
  auto ldsm_mk = [&](uint32_t (&r)[4], const unsigned short* p, int stride) {
    hk::ldsm_x4(r, p + lo_a * stride + hi_a);
  };
  auto ldsm_nk = [&](uint32_t (&r)[4], const unsigned short* p, int stride) {
    hk::ldsm_x4(r, p + (lr + hi_a) * stride + 8 * (lm & 1));
  };
  auto ldsm_kn = [&](uint32_t (&r)[4], const unsigned short* p, int stride) {
    hk::ldsm_x4_trans(r, p + lo_a * stride + hi_a);
  };
  auto ldsm_km = [&](uint32_t (&r)[4], const unsigned short* p, int stride) {
    hk::ldsm_x4_trans(r, p + (lr + hi_a) * stride + 8 * (lm & 1));
  };

  // U[o][col] (+)= W_d[o][k] X[k][col] over nk k16-aligned rows of X: A =
  // W_d [o][k], B = X [k][col]; jobs of 16 rows x 16 columns
  auto project = [&](const unsigned short* wb, int wstride,
                     const unsigned short* xb, int nk, bool first) {
    for (int jb = warp; jb < (R / 16) * (N / 16); jb += kBwdThreads / 32) {
      const int o0 = jb / (N / 16) * 16, n0 = jb % (N / 16) * 16;
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* pu = u_s + (o0 + g) * us + n0 + 8 * nt + 2 * q;
        acc[nt][0] = first ? 0.f : pu[0];
        acc[nt][1] = first ? 0.f : pu[1];
        acc[nt][2] = first ? 0.f : pu[8 * us];
        acc[nt][3] = first ? 0.f : pu[8 * us + 1];
      }
      for (int k0 = 0; k0 < nk; k0 += 16) {
        uint32_t a[4], b[4];
        ldsm_mk(a, wb + o0 * wstride + k0, wstride);
        ldsm_kn(b, xb + k0 * xs + n0, xs);
        hk::mma_bf16(acc[0], a, {b[0], b[1]});
        hk::mma_bf16(acc[1], a, {b[2], b[3]});
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* pu = u_s + (o0 + g) * us + n0 + 8 * nt + 2 * q;
        pu[0] = acc[nt][0];
        pu[1] = acc[nt][1];
        pu[8 * us] = acc[nt][2];
        pu[8 * us + 1] = acc[nt][3];
      }
    }
  };

  // 3. the adjoint scan of chunk n over its steps, in scan order; hwp the
  // highway rows (jl's at hwp + jl * hw_stride). kScanG steps at a time:
  // their gates first (they read only loaded values), then the chain in dc
  // over them, so that the gates' latencies overlap
  constexpr int kScanG = 4;
  auto scan = [&](int n, const unsigned short* hwp, int hw_stride) {
    if (!scan_thread) return;
    const unsigned short* ccur = c_s + (n & 1) * units * cs;
    const unsigned short* gcur = dh_s + (n & 1) * units * N;
    for (int s0 = 0; s0 < S; s0 += kScanG) {
      float u0[kScanG], ct[kScanG], cp[kScanG], gg[kScanG], f[kScanG],
          r[kScanG], dm[kScanG];
      bool on[kScanG];
#pragma unroll
      for (int k = 0; k < kScanG; ++k) {
        const int s = s0 + k, col = s * bt + cc;
        on[k] = live && s < S && n * S + s < T;
        if (!on[k]) continue;
        u0[k] = u_s[jl * us + col];
        const float u1 = u_s[(units + jl) * us + col];
        const float u2 = u_s[(2 * units + jl) * us + col];
        ct[k] = bf(ccur[jl * cs + col]);
        cp[k] = bf(ccur[jl * cs + col + bt]);
        gg[k] = bf(gcur[jl * N + col]);
        const float xhw = bf(hwp[jl * hw_stride + col]);
        f[k] = sigmoid_fast(u1 + v_f * cp[k] + b_f);
        r[k] = sigmoid_fast(u2 + v_r * ct[k] + b_r);
        dm[k] = gg[k] * (ct[k] - xhw) * r[k] * (1.f - r[k]);
      }
#pragma unroll
      for (int k = 0; k < kScanG; ++k) {
        const int s = s0 + k, col = s * bt + cc;
        if (s >= S) break;
        float du[3] = {0.f, 0.f, 0.f}, hw = 0.f;
        if (on[k]) {
          dc = gg[k] * r[k] + dm[k] * v_r + dc;
          const float da = dc * (cp[k] - u0[k]) * f[k] * (1.f - f[k]);
          du[0] = dc * (1.f - f[k]);
          du[1] = da;
          du[2] = dm[k];
          hw = gg[k] * (1.f - r[k]);
          acc4[0] += da * cp[k];
          acc4[1] += dm[k] * ct[k];
          acc4[2] += da;
          acc4[3] += dm[k];
          dc = dc * f[k] + da * v_f;
        }
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          unsigned short p0, p1, p2;
          split3(du[gate], p0, p1, p2);
          const int at = (gate * units + jl) * ds + col;
          d_s[at] = p0;
          d_s[R * ds + at] = p1;
          d_s[2 * R * ds + at] = p2;
        }
        h_s[jl * N + col] = hw;
      }
    }
  };

  // 4. dx's rows i0 .. i0 + 15 (wb: W_d's column i0 at wb + o * wstride),
  // columns n0 .. n0 + 15 of chunk n: A = W_d^T, (i, o) = wb[o][i] ([k][m]),
  // B = du's part [o][col] ([k][n]), one accumulator a part (three chains
  // of mma.sync, not one), added lo + mid, then hi; then the highway term,
  // and the store
  auto dx_job = [&](int n, int i0, int n0, const unsigned short* wb,
                    int wstride) {
    float acc[3][2][4] = {};
    for (int k0 = 0; k0 < R; k0 += 16) {
      uint32_t a[4];
      ldsm_km(a, wb + k0 * wstride, wstride);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        uint32_t b[4];
        ldsm_kn(b, d_s + part * R * ds + k0 * ds + n0, ds);
        hk::mma_bf16(acc[part][0], a, {b[0], b[1]});
        hk::mma_bf16(acc[part][1], a, {b[2], b[3]});
      }
    }
    // c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1): a pair of
    // columns 2q, 2q + 1 is one step's batch columns c, c + 1 where bt >= 2,
    // stored as one 4-byte word where B is even (then c is, and the pair
    // is aligned)
    const bool pair = bt >= 2 && B % 2 == 0 && !split;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col0 = n0 + 8 * nt + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + g + 8 * h;
        if (i >= h2) continue;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + e;
          val[e] = acc[0][nt][2 * h + e] +
                   (acc[1][nt][2 * h + e] + acc[2][nt][2 * h + e]);
          if (i >= own0 && i < own0 + hs)
            val[e] += h_s[(i - own0) * N + col];
        }
        const int s = col0 >> lbt, c = col0 & (bt - 1), ii = n * S + s;
        if (ii >= T || b0 + c >= B) continue;
        const long long at =
            (((long long)dir * T + t_of(ii)) * h2 + i) * B + b0 + c;
        if (pair && b0 + c + 1 < B) {
          __nv_bfloat162 v2 = __floats2bfloat162_rn(val[0], val[1]);
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<__nv_bfloat16*>(dxd) + at) = v2;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + e;
          const int s1 = col >> lbt, c1 = col & (bt - 1), i1 = n * S + s1;
          if (i1 >= T || b0 + c1 >= B) continue;
          const long long at1 =
              (((long long)dir * T + t_of(i1)) * h2 + i) * B + b0 + c1;
          if (split)
            reinterpret_cast<float*>(dxd)[(long long)blockIdx.z * 2 * T * h2 *
                                              B + at1] = val[e];
          else
            reinterpret_cast<__nv_bfloat16*>(dxd)[at1] =
                __float2bfloat16_rn(val[e]);
        }
      }
    }
  };
  // 5. this chunk's dW over rows o0 .. o0 + 15 and columns i0 .. i0 + 15
  // (xb: X's row i0 at xb): A = du's part [o][col] ([m][k]), B = X
  // [i][col] ([n][k]), one accumulator a part; returns the sums in out,
  // lo + mid, then hi
  auto dw_job = [&](float (&out)[2][4], int o0, const unsigned short* xb) {
    float acc[3][2][4] = {};
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t b[4];
      ldsm_nk(b, xb + k0, xs);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        uint32_t a[4];
        ldsm_mk(a, d_s + part * R * ds + o0 * ds + k0, ds);
        hk::mma_bf16(acc[part][0], a, {b[0], b[1]});
        hk::mma_bf16(acc[part][1], a, {b[2], b[3]});
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        out[nt][v] = acc[0][nt][v] + (acc[1][nt][v] + acc[2][nt][v]);
  };

  if constexpr (!kStream) {
    load_w(w_s, ws, 0, K);
    const int dx_jobs = (K / 16) * (N / 16);
    const int dw_jobs = (R / 16) * (K / 16);
    load(x_s, xs, 0, S, K, true, 0, xf16);
    load_aux(0);
    hk::cp_async_commit();
    // where the scan leaves at least half the threads idle, they issue the
    // next chunk's copies while it runs; else every thread, before U
    const bool spare = units * bt <= kBwdThreads / 2;
    if (spare) {
      t0 = units * bt;
      nt = kBwdThreads - t0;
    }
    auto load_next = [&](int n) {
      if (n + 1 < n_chunks) {
        load(x_s + ((n + 1) & 1) * K * xs, xs, n + 1, S, K, true, 0, xf16);
        load_aux(n + 1);
      }
      hk::cp_async_commit();
    };
    for (int n = 0; n < n_chunks; ++n) {
      hk::cp_async_wait_all();
      __syncthreads();  // chunk n is in; the last chunk's reads are done
      if (!spare) load_next(n);
      const unsigned short* xc = x_s + (n & 1) * K * xs;
      project(w_s, ws, xc, K, true);  // 2. U = W_d X
      __syncthreads();                // U is whole
      if (spare && !scan_thread) load_next(n);
      scan(n, xc + own0 * xs, xs);
      __syncthreads();  // du and the highway term are whole
      for (int jb = warp; jb < dx_jobs + dw_jobs; jb += kBwdThreads / 32) {
        if (jb < dx_jobs) {
          const int i0 = jb / (N / 16) * 16, n0 = jb % (N / 16) * 16;
          dx_job(n, i0, n0, w_s + i0, ws);
        } else {
          const int jw = jb - dx_jobs;
          const int o0 = jw / (K / 16) * 16, i0 = jw % (K / 16) * 16;
          float acc[2][4];
          dw_job(acc, o0, xc + i0 * xs);
          // the chunk's sums into the float32 sums (this warp's entries)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* pw = w_f + (o0 + g) * ws + i0 + 8 * nt + 2 * q;
            pw[0] += acc[nt][0];
            pw[1] += acc[nt][1];
            pw[8 * ws] += acc[nt][2];
            pw[8 * ws + 1] += acc[nt][3];
          }
        }
      }
    }
    hk::cp_async_wait_all();
    __syncthreads();  // the dW sums are whole; U is free
    // the dW partial of the slice's rows
    for (int e = tid; e < R * h2; e += kBwdThreads) {
      const int o = e / h2, i = e % h2, row = dw_row(o);
      if (row >= 0) dwp[(long long)row * h2 + i] = w_f[o * ws + i];
    }
  } else {
    static_assert(kBwdK % 16 == 0, "a stage is whole k16 steps");
    // stage st of chunk st / (2 ksl): pass (st / ksl) % 2 (U, then dx and
    // dW) over X's rows and W_d's columns k0 = (st % ksl) kBwdK ..
    const int ksl = (K + kBwdK - 1) / kBwdK, per_chunk = 2 * ksl;
    const int total = n_chunks * per_chunk;
    const int dx_jobs = (kBwdK / 16) * (N / 16);
    const int dw_jobs = (R / 16) * (kBwdK / 16);
    auto load_stage = [&](int st) {
      if (st < total) {
        const int n = st / per_chunk, r = st % per_chunk;
        const int k0 = r % ksl * kBwdK;
        unsigned short* xs_ = ring + st % kBwdStages * slot_elems;
        load(xs_, xs, n, S, kBwdK, true, k0, xf16);
        load_w(xs_ + kBwdK * xs, wk, k0, kBwdK);
        if (r == 0) load_aux(n);
      }
      hk::cp_async_commit();
    };
    for (int st = 0; st < kBwdStages - 1; ++st) load_stage(st);
    for (int st = 0; st < total; ++st) {
      hk::cp_async_wait<kBwdStages - 2>();
      __syncthreads();  // stage st is in; every warp is done with the slot
                        // that stage st + kBwdStages - 1 takes
      load_stage(st + kBwdStages - 1);
      const int n = st / per_chunk, r = st % per_chunk;
      const int sl = r % ksl, k0 = sl * kBwdK;
      const unsigned short* xst = ring + st % kBwdStages * slot_elems;
      const unsigned short* wst = xst + kBwdK * xs;
      if (r < ksl) {  // 2. U += W_d's columns X's rows of the stage
        project(wst, wk, xst, kBwdK, sl == 0);
        if (sl == ksl - 1) {
          __syncthreads();  // U is whole
          scan(n, hx_s + (n & 1) * units * N, N);
          __syncthreads();  // du and the highway term are whole
        }
        continue;
      }
      for (int jb = warp; jb < dx_jobs + dw_jobs; jb += kBwdThreads / 32) {
        if (jb < dx_jobs) {  // dx's rows k0 .. k0 + kBwdK - 1
          const int ii = jb / (N / 16) * 16, n0 = jb % (N / 16) * 16;
          dx_job(n, k0 + ii, n0, wst + ii, wk);
        } else {  // dW's columns k0 .. k0 + kBwdK - 1, into the partial
          const int jw = jb - dx_jobs;
          const int o0 = jw / (kBwdK / 16) * 16, ii = jw % (kBwdK / 16) * 16;
          float acc[2][4];
          dw_job(acc, o0, xst + ii * xs);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int row = dw_row(o0 + g + 8 * (v >> 1));
              const int i = k0 + ii + 8 * nt + 2 * q + (v & 1);
              if (row < 0 || i >= h2) continue;
              float* p = dwp + (long long)row * h2 + i;
              *p = n == 0 ? acc[nt][v] : *p + acc[nt][v];
            }
        }
      }
    }
    hk::cp_async_wait_all();
    __syncthreads();  // U is free
  }

  // the (v, b) sums of each unit over the tile's columns, in column order
  float* red = u_s;  // (units, bt, 4)
  if (scan_thread)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(jl * bt + cc) * 4 + k] = acc4[k];
  __syncthreads();
  for (int e = tid; e < 4 * hs; e += kBwdThreads) {
    const int j = e / 4, k = e % 4;
    float s = 0.f;
    for (int c = 0; c < bt; ++c) s += red[(j * bt + c) * 4 + k];
    dvb_part[((long long)tile * 8 + dir * 4 + k) * H + j0 + j] = s;
  }
}

// dx_f[t][j][b] and dx_r[t][j][b] (row H + j of each direction's dx): each
// direction's dx, the sum of its n_parts partials in order (one at one
// slice: bf16, rounded already), rounded to bf16, then the two added and
// rounded (JAX's dx = dxa + dxb in bf16). One thread a (t, j, b).
template <typename E>
__global__ void sru_hid_bwd_dx_add_kernel(const E* __restrict__ dxd,
                                          int n_parts,
                                          __nv_bfloat16* __restrict__ dx_f,
                                          __nv_bfloat16* __restrict__ dx_r,
                                          int T, int H, int B) {
  const long long hb = (long long)H * B, n = T * hb;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long t = e / hb, jb = e - t * hb;  // jb = j * B + b
  float out[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // dx_f's rows j, dx_r's H + j
    float sum = 0.f;
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      float v = 0.f;
      for (int p = 0; p < n_parts; ++p)
        v += load_value(dxd + (((long long)p * 2 + dir) * T + t) * 2 * hb +
                        half * hb + jb);
      sum += __bfloat162float(__float2bfloat16_rn(v));
    }
    out[half] = sum;
  }
  dx_f[e] = __float2bfloat16_rn(out[0]);
  dx_r[e] = __float2bfloat16_rn(out[1]);
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

// K1 forward in bf16 storage: as sru_dual_recurrence_fwd
// (sru_lay0_fwd16_kernel); u_f and u_r 16-byte aligned (the warps' 16-byte
// copies). Shared memory: the warps' rings, kL16FwdAhead + 1 group slots
// of kL16Group x 4 x kL16Span bf16 each.
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
  const size_t smem = (size_t)(cols * units / 32) * (kL16FwdAhead + 1) *
                      kL16Group * 4 * kL16Span * 2;
  const auto kernel = c_f ? sru_lay0_fwd16_kernel<true>
                          : sru_lay0_fwd16_kernel<false>;
  const cudaError_t e = set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)u_f, (const __nv_bfloat16*)u_r,
      (const __nv_bfloat16*)vb, (__nv_bfloat16*)h_f, (__nv_bfloat16*)h_r,
      (__nv_bfloat16*)c_f, (__nv_bfloat16*)c_r, T, H, B, cols);
  return (int)cudaGetLastError();
}

// K2 forward in bf16 storage (ops/sru_fused.k2_fwd_bf16_geometry): held
// (sru_hid_fwd_bf16_kernel: bt 1, 2, 4 or 8 columns, chunks of S steps, S
// bt 16, 32 or 64, units a block, at most kFwd16ScanMax / bt) or, where
// `streamed`, sru_hid_fwd_bf16_stream_kernel (the float32 kernel's
// streamed geometry); x_f, x_r and wt 16-byte aligned.
extern "C" int sru_hidden_layer_fwd_bf16(const void* x_f, const void* x_r,
                                         const void* wt, const void* vb,
                                         void* h_f, void* h_r, void* c_f,
                                         void* c_r, int T, int H, int B,
                                         int bt, int S, int units,
                                         int streamed, void* stream) {
  if (T < 1 || H < 1 || B < 1 || bt < 1 || S < 1 || units < 1 ||
      ((reinterpret_cast<size_t>(x_f) | reinterpret_cast<size_t>(x_r) |
        reinterpret_cast<size_t>(wt)) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(B, bt), 2, ceil_div(H, units));
  const auto* xf = (const __nv_bfloat16*)x_f;
  const auto* xr = (const __nv_bfloat16*)x_r;
  const auto* w = (const __nv_bfloat16*)wt;
  const auto* v = (const __nv_bfloat16*)vb;
  auto* hf = (__nv_bfloat16*)h_f;
  auto* hr = (__nv_bfloat16*)h_r;
  auto* cf = (__nv_bfloat16*)c_f;
  auto* cr = (__nv_bfloat16*)c_r;
  if (streamed) {
    if ((S * bt) % (16 * kFwdMT) != 0 || units * bt > kFwdThreads ||
        S % min(S, kFwdAhead) != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)hid_fwd_bf16_stream_smem_bytes(S * bt, units);
    if ((long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        set_smem((const void*)sru_hid_fwd_bf16_stream_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    sru_hid_fwd_bf16_stream_kernel<<<grid, kFwdThreads, smem,
                                     (cudaStream_t)stream>>>(
        xf, xr, w, v, hf, hr, cf, cr, T, H, B, bt, S, units);
    return (int)cudaGetLastError();
  }
  const int N = S * bt;
  if ((bt & (bt - 1)) || bt > 8 || (N != 16 && N != 32 && N != 64) ||
      units * bt > kFwd16ScanMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)HidFwd16Smem(H, N, units, bt, hid_fwd16_vec(bt, B)).total;
  if ((long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_smem((const void*)sru_hid_fwd_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 32 * (kFwd16Prod + ceil_div(units * bt, 32));
  sru_hid_fwd_bf16_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      xf, xr, w, v, hf, hr, cf, cr, T, H, B, bt, S, units);
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
  sru_hid_bwd_gemm_kernel<false, false>
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
  sru_hid_bwd_gemm_kernel<true, true>
      <<<dim3(ceil_div(B, kTile), ceil_div(h2, kTile), T), kGemmThreads, 0,
         st>>>((const float*)wt, h2, u, dx, h2, h6, B);
  // 4. dW partials by split-K over the T * B columns
  const int n_chunks = ceil_div((long long)T * B, cols);
  sru_hid_bwd_wgrad_kernel
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
// float32, each du value rounded once): as sru_dual_recurrence_bwd, in
// sru_lay0_bwd16_kernel (cols x units threads a block, ops/sru_fused.
// k1_bwd_bf16_geometry); dvb_part (ceil(B / cols), 8, H) stays float32.
// u, c and dh 16-byte aligned (the warps' 16-byte copies).
extern "C" int sru_dual_recurrence_bwd_bf16(
    const void* u_f, const void* u_r, const void* vb, const void* c_f,
    const void* c_r, const void* dh_f, const void* dh_r, void* du_f,
    void* du_r, void* dvb_part, int T, int H, int B, int cols, int units,
    void* stream) {
  using bf = __nv_bfloat16;
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kLay0Threads ||
      ((reinterpret_cast<size_t>(u_f) | reinterpret_cast<size_t>(u_r) |
        reinterpret_cast<size_t>(c_f) | reinterpret_cast<size_t>(c_r) |
        reinterpret_cast<size_t>(dh_f) | reinterpret_cast<size_t>(dh_r)) &
       15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(B, cols), ceil_div(H, units), 2);
  const size_t smem = (size_t)(cols * units / 32) * (kL16BwdAhead + 1) *
                      kL16Group * 6 * kL16Span * 2;
  const cudaError_t e = set_smem((const void*)sru_lay0_bwd16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sru_lay0_bwd16_kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const bf*)u_f, (const bf*)u_r, (const bf*)vb, (const bf*)c_f,
      (const bf*)c_r, (const bf*)dh_f, (const bf*)dh_r, (bf*)du_f, (bf*)du_r,
      (float*)dvb_part, T, H, B, cols);
  return (int)cudaGetLastError();
}

// K2 backward in bf16 storage: x, wt, vb, c, dh in and dx, dwt, dvb out
// bf16, as the Pallas kernel: sru_hid_bwd_bf16_kernel (bt batch columns, S
// steps a chunk and `units` units a block, ops/sru_fused.
// k2_bwd_bf16_geometry; <true> where `streamed`, which the geometry sets
// where the held layout does not fit a block: the entry only checks that
// the layout it names fits), then sru_hid_bwd_dx_add_kernel (each direction's
// dx rounded, the two added in bf16) and sru_hid_bwd_sum_kernel<bf16> for
// dW and d(v, b) (the batch tiles' partials in order, rounded once).
// Scratch from the wrapper: dxd, bf16 (2, T, 2H, B) where one slice takes
// all of H, else float32 (slices, 2, T, 2H, B); dw_part (tiles, 6H, 2H)
// and dvb_part (tiles, 8, H) float32, tiles = ceil(B / bt). x, wt, c and
// dh 16-byte aligned.
extern "C" int sru_hidden_layer_bwd_bf16(
    const void* x_f, const void* x_r, const void* wt, const void* vb,
    const void* c_f, const void* c_r, const void* dh_f, const void* dh_r,
    void* dx_f, void* dx_r, void* dwt, void* dvb, void* dxd, void* dw_part,
    void* dvb_part, int T, int H, int B, int bt, int S, int units,
    int streamed, void* stream) {
  using bf = __nv_bfloat16;
  if (T < 1 || H < 1 || B < 1 || bt < 1 || bt > 8 || (bt & (bt - 1)) ||
      S < 1 || units < 1 || (S * bt) % 16 != 0 || units * bt > kBwdThreads ||
      ((reinterpret_cast<size_t>(x_f) | reinterpret_cast<size_t>(x_r) |
        reinterpret_cast<size_t>(wt) | reinterpret_cast<size_t>(c_f) |
        reinterpret_cast<size_t>(c_r) | reinterpret_cast<size_t>(dh_f) |
        reinterpret_cast<size_t>(dh_r)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const HidBwdSmem lay(H, S * bt, units, bt, streamed != 0);
  if (lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto kernel = streamed ? sru_hid_bwd_bf16_kernel<true>
                               : sru_hid_bwd_bf16_kernel<false>;
  cudaError_t e = set_smem((const void*)kernel, lay.total);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ceil_div(B, bt), slices = ceil_div(H, units);
  kernel<<<dim3(tiles, 2, slices), kBwdThreads, lay.total, st>>>(
      (const bf*)x_f, (const bf*)x_r, (const bf*)wt, (const bf*)vb,
      (const bf*)c_f, (const bf*)c_r, (const bf*)dh_f, (const bf*)dh_r, dxd,
      (float*)dw_part, (float*)dvb_part, T, H, B, bt, S, units);
  const long long n = (long long)T * H * B;
  if (slices > 1)
    sru_hid_bwd_dx_add_kernel<float><<<ceil_div(n, 256), 256, 0, st>>>(
        (const float*)dxd, slices, (bf*)dx_f, (bf*)dx_r, T, H, B);
  else
    sru_hid_bwd_dx_add_kernel<bf><<<ceil_div(n, 256), 256, 0, st>>>(
        (const bf*)dxd, 1, (bf*)dx_f, (bf*)dx_r, T, H, B);
  sru_hid_bwd_sum_kernel<bf><<<ceil_div(12 * H * H, 256), 256, 0, st>>>(
      (const float*)dw_part, (bf*)dwt, tiles, 12 * H * H);
  sru_hid_bwd_sum_kernel<bf><<<ceil_div(8 * H, 256), 256, 0, st>>>(
      (const float*)dvb_part, (bf*)dvb, tiles, 8 * H);
  return (int)cudaGetLastError();
}
