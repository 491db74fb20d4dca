// Gen-1 SRU recurrence kernels for Hopper (sm_90a), float32 and bf16
// storage.
//
// K4  sru_recurrence_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_fwd_impl).
// K4  sru_recurrence_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_vjp_bwd).
// sru_recurrence_{fwd,bwd}_bf16 take bf16 storage (a bf16 model's U takes
// the compute dtype, and the Pallas kernels run in it): the arithmetic and
// the carries float32, the stored values rounded where the Pallas kernels
// round them. The backward is the float32 scan on bf16 (below); the
// forward is a kernel of its own, sru_rec_fwd16_kernel (its design
// further down).
//
// One direction of one SRU layer over a precomputed projection (sru
// package v2.6 semantics: the reset gate reads the UPDATED cell, see
// rtfs_tpu/ops/sru.py):
//   f_t = sigmoid(u1_t + v_f * c_{t-1} + b_f)
//   c_t = f_t * c_{t-1} + (1 - f_t) * u0_t
//   r_t = sigmoid(u2_t + v_r * c_t + b_r)
//   h_t = r_t * c_t + (1 - r_t) * xhw_t
// Layouts are the Pallas op's boundary layouts, time-major with the folded
// batch fastest: u (T, 3H, B) with row blocks [x~, f, r]; xhw, h, c, dh,
// dxhw (T, H, B); vb (4, H) = [v_f, v_r, b_f, b_r]. T and B are taken as
// they come: the Pallas op pads T to 32 and B to 128 lanes, here the ragged
// edge is masked.
//
// The reverse direction of a bidirectional layer (k = 3, input 2H) is a
// flag: reverse != 0 walks t = T-1 .. 0, as K1 walks u_r, where the JAX op
// flips u and xhw in memory before the call and h after it.
//
// Forward: one thread per (unit j, batch column b), neighbouring threads on
// neighbouring b, so every (t, row, .) load and store is coalesced. The
// thread walks all T steps with c in a register (the Pallas kernel carried
// it across its sequential grid's time chunks in a VMEM scratch); v_f, v_r,
// b_f, b_r are per-unit scalars in registers (no lane-replicated vb). The
// cell states c are written only when the caller passes a c pointer
// (training); serving passes null. K1 forward's design (csrc/sru_fused.cu
// sru_lay0_fwd_kernel) over one direction and four streams (u0, u1, u2 and
// the highway xhw): the thread keeps the cp.async copies of its next
// kRecFwdAhead steps in flight in its own ring in shared memory, so a step
// waits for the gate chain, not for its loads; blocks of 32-128 threads
// (columns x units, ops/sru_pallas.k4_fwd_geometry) spread the grid over
// the SMs.
//
// Backward (BPTT), the adjoints of _bwd_kernel: the adjoint scan of
// csrc/sru_scan.cuh, which K1's and K2's backwards share, launched over
// one direction with K4's layout in a ScanIO (u's rows [x~, f, r] a step
// 3H x B apart, the highway xhw and its adjoint dxhw apart from u, vb's
// and the (v, b) partials' rows (4, H)); reverse != 0 scans t = 0 .. T-1.
// c_prev is read from the saved c one step on in scan order (zero at the
// scan's end), so the shifted c stream the Pallas op builds is not
// needed. The (v, b) partials, one per column block, are added in a
// fixed order by the wrapper: no float atomics, so two calls give the
// same bits.
//
// What bounds it on the H100. Per (step, column) over the H units the
// forward moves (3H + H + H) x 4 = 640 bytes at H = 32 (768 with c) for
// ~20 flops a unit, the backward 1280 bytes (reads u, xhw, c, dh; writes
// du, dxhw) for ~35: by the roofline both are bound by memory bytes. At the
// RTFS-Net-4 training shapes (freq scan T 57 over B 500, time scan T 118
// over B 256, bs 4) that is 6.5-6.9 us forward with c and 10.9-11.5 us
// backward at 3.35 TB/s. The forward is bound in practice by the latency
// of T dependent steps: each thread's gate chain (two sigmoids, the cell
// update) cannot start before the previous step's c. At bs 1 the launch
// has only H x B = 4000 threads, a few warps a SM, so nothing hides that
// chain. Its design issues the loads of later steps (which do not depend
// on c) ahead of the chain, through the ring. The backward
// carries only dc across steps, so it can run at its bytes bound if
// enough loads are in flight: the scan keeps each thread's next kScanAhead
// steps of copies in flight and spreads its 32-128 thread blocks over the SMs
// (sru_scan.cuh).

#include <cuda_runtime.h>

#include <type_traits>

#include "sru_scan.cuh"

namespace {

// the forward's blocks are at most kRecFwdThreads threads; each thread
// keeps the copies of its next kRecFwdAhead steps in flight
// (ops/sru_pallas.py mirrors both)
constexpr int kRecFwdThreads = 128;
constexpr int kRecFwdAhead = 8;

// grid (ceil(B / cols), ceil(H / units)), cols * units threads, cols a
// multiple of 32 (ops/sru_pallas.k4_fwd_geometry): thread (column b0 +
// tid % cols, unit j0 + tid / cols). Scan step i is t = i, or T-1-i with
// reverse. The step loads go through a ring of kRecFwdAhead slots in
// shared memory, each thread its own column of it (no thread reads
// another's, so no barrier): the thread keeps the copies of the next
// kRecFwdAhead steps in flight, one commit group a step, waits for step
// i's group, takes its four values and issues step i + kRecFwdAhead into
// the slot they came from.
__global__ void __launch_bounds__(kRecFwdThreads)
sru_rec_fwd_kernel(const float* __restrict__ u, const float* __restrict__ xhw,
                   const float* __restrict__ vb, float* __restrict__ h,
                   float* __restrict__ cs, int T, int H, int B, int reverse,
                   int cols) {
  extern __shared__ float ring[];  // (kRecFwdAhead, 4, blockDim.x)
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  if (b >= B || j >= H) return;
  const float v_f = vb[j], v_r = vb[H + j];
  const float b_f = vb[2 * H + j];
  const float b_r = vb[3 * H + j];
  const long long row = (long long)H * B;  // one gate block per step
  const long long col = (long long)j * B + b;
  const int nt = blockDim.x;
  float* mine = ring + threadIdx.x;  // slot s, stream g: mine[(4 s + g) nt]
  // scan step i into slot i % kRecFwdAhead, one commit group (empty past
  // T): u's three gate rows and the highway
  auto issue = [&](int i) {
    if (i < T) {
      const int t = reverse ? T - 1 - i : i;
      const long long eu = (long long)t * 3 * row + col;
      float* d = mine + (i % kRecFwdAhead) * 4 * nt;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        hk::cp_async4(d + g * nt, u + eu + g * row, true);
      hk::cp_async4(d + 3 * nt, xhw + (long long)t * row + col, true);
    }
    hk::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kRecFwdAhead; ++i) issue(i);
  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    hk::cp_async_wait<kRecFwdAhead - 1>();  // step i's group is in
    const float* d = mine + (i % kRecFwdAhead) * 4 * nt;
    const int t = reverse ? T - 1 - i : i;
    const long long o = (long long)t * row + col;
    const float u0 = d[0], u1 = d[nt], u2 = d[2 * nt], x = d[3 * nt];
    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
    h[o] = r * c + (1.f - r) * x;
    if (cs) cs[o] = c;
    issue(i + kRecFwdAhead);  // into the slot just read (its values used)
  }
}

int launch_rec_fwd(const void* u, const void* xhw, const void* vb, void* h,
                   void* c, int T, int H, int B, int reverse, int cols,
                   int units, void* stream) {
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kRecFwdThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols, (H + units - 1) / units);
  const size_t smem = (size_t)kRecFwdAhead * 4 * cols * units * sizeof(float);
  sru_rec_fwd_kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)xhw, (const float*)vb, (float*)h,
      (float*)c, T, H, B, reverse, cols);
  return (int)cudaGetLastError();
}

// K4 forward in bf16 storage (sru_rec_fwd16_kernel): u, xhw, vb, h and c
// bf16, as the Pallas kernel on a bf16 model; the gates, the cell update
// and the carry c float32 (the Pallas body promotes bf16 u, v and b
// against its float32 carry), only the stored h and c rounded.
//
// What bounds it on the H100 (PERF.md; tools/phase_split.py --k4 splits
// a launch). It moves 2 bytes a value for ~20 flops a (step, unit,
// column), so by the roofline it is bound by bytes; but where threads
// are few (bs 1: about a warp an SM) a launch takes T steps of one warp,
// and a step costs the warp's instructions in order, not its carry chain
// alone (~25 ns folded). The first bf16 kernel (the float32 one's ring
// of 4-byte words, a step at a time) spent a step on the copies' issue
// and address arithmetic, word reads and sigmoid_f, and ran slower than
// the float32 kernel. The design, K1's bf16 forward (csrc/sru_fused.cu
// sru_lay0_fwd16_kernel) over one direction:
//   - a warp owns one unit and 32 consecutive batch columns, a lane a
//     column; the warp copies a row's 32 values of a step as the 80 bytes
//     (five 16-byte blocks) from the 16-byte boundary below the first (a
//     slot row of kRec16Span values; u's and xhw's bases 16-byte aligned,
//     which the wrapper makes sure of), and each lane reads its value
//     shifted by the first's offset mod 8;
//   - the four rows of a step come from two arrays: u's three gate rows
//     (a step 3 H B values apart, the rows H B apart) and xhw's highway
//     row (a step H B apart). A group of kRec16Group steps is 32 (step,
//     row) copies, one a lane: lane l copies row l % 4 of the group's
//     step l / 4, its 80 bytes as five 16-byte cp.async from one source
//     address (K1's lanes own a block of a row for the group's 8 steps
//     and redo the address each step); a row whose 80 bytes would run
//     past its array's end (the last rows of u and xhw) copies the blocks
//     that start inside it, the last cut there and zero-filled. One bulk
//     copy a lane (cp.async.bulk on an mbarrier a slot) was tried and ran
//     slower than the first kernel: the bulk copies' issue took a third
//     of a launch (PERF.md);
//   - copies go kRec16Ahead groups ahead into a ring of kRec16Ahead + 1
//     group slots, one commit group a lane and group: at group n a lane
//     waits for its group n, meets its warp (the other lanes' copies are
//     in, and every lane is past group n - 1's reads) and issues group n
//     + kRec16Ahead into the slot of group n - 1;
//   - a row's offset mod 8 repeats every group (a group moves u's rows by
//     24 H B values and xhw's by 8 H B; a step moves them by 3 H B or H
//     B, so the offsets of one group's 8 steps may all differ): each lane
//     works out its 32 read offsets once;
//   - a full group runs without a branch: its reads go before its chain,
//     the gates take the hardware ex2 and rcp with their constants folded
//     off the chain (sigmoid(u + v c + b) = 1 / (1 + 2^(-log2(e) (u + b)
//     - log2(e) v c))), the stores are predicated; kWithC: c stored too
//     (training).
constexpr int kRec16Group = 8;   // steps a group: one slot, one phase
constexpr int kRec16Ahead = 3;   // groups in flight ahead of the one read
constexpr int kRec16Span = 40;   // a row's slot: 5 blocks of 8 bf16
constexpr float kNegLog2e = -1.4426950408889634f;

__device__ __forceinline__ float bf16_at(const unsigned short* p) {
  return __bfloat162float(__ushort_as_bfloat16(*p));
}

// grid (ceil(B / cols), ceil(H / units)), cols * units threads, cols a
// multiple of 32 (ops/sru_pallas.k4_fwd_geometry): warp (unit j, columns
// b0 .. b0 + 31) walks scan steps i = 0 .. T-1 (t = i, or T-1-i with
// reverse). Shared memory: the warps' rings of kRec16Ahead + 1 group
// slots of kRec16Group steps x 4 rows x kRec16Span values. Lanes past B
// compute on whatever their slot holds and store nothing.
template <bool kWithC>
__global__ void __launch_bounds__(kRecFwdThreads)
sru_rec_fwd16_kernel(const __nv_bfloat16* __restrict__ u,
                     const __nv_bfloat16* __restrict__ xhw,
                     const __nv_bfloat16* __restrict__ vb,
                     __nv_bfloat16* __restrict__ h,
                     __nv_bfloat16* __restrict__ cs, int T, int H, int B,
                     int reverse, int cols) {
  constexpr int kSlots = kRec16Ahead + 1;
  constexpr int kSlot = kRec16Group * 4 * kRec16Span;  // values
  extern __shared__ __align__(16) unsigned short ring16[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  if (j >= H || b - lane >= B) return;  // the whole warp
  unsigned short* mine = ring16 + warp * kSlots * kSlot;
  const float nv_f = kNegLog2e * __bfloat162float(vb[j]);
  const float nv_r = kNegLog2e * __bfloat162float(vb[H + j]);
  const float b_f = __bfloat162float(vb[2 * H + j]);
  const float b_r = __bfloat162float(vb[3 * H + j]);
  const long long row = (long long)H * B;
  const long long col = (long long)j * B + (b - lane);  // the warp's first
  const long long t0 = reverse ? T - 1 : 0;  // scan step 0's t
  const int dt = reverse ? -1 : 1;
  // the lane's copy: row r_own (u's gate row r_own, or 3: the highway) of
  // the group's step s_own, into the slot's row 4 s_own + r_own
  const int s_own = lane >> 2, r_own = lane & 3;
  const bool hw = r_own == 3;
  const unsigned short* src_arr =
      reinterpret_cast<const unsigned short*>(hw ? xhw : u);
  const long long stride = hw ? row : 3 * row;  // a step of its array
  const long long len = T * stride;             // the array's values
  const long long e_own =
      (t0 + dt * s_own) * stride + (hw ? 0 : r_own * row) + col;
  const long long e_group = dt * kRec16Group * stride;
  const int dst_own = (4 * s_own + r_own) * kRec16Span;
  // group n's copies into slot n % kSlots, one commit group (empty past
  // T)
  auto issue = [&](int n) {
    if (n * kRec16Group + s_own < T) {
      const long long src = (e_own + n * e_group) & ~7LL;
      unsigned short* dst = mine + (n % kSlots) * kSlot + dst_own;
      const unsigned short* from = src_arr + src;
      if (src + kRec16Span <= len) {
#pragma unroll
        for (int k = 0; k < kRec16Span / 8; ++k)
          hk::cp_async16(dst + 8 * k, from + 8 * k, true);
      } else {
#pragma unroll
        for (int k = 0; k < kRec16Span / 8; ++k) {
          const long long left = len - src - 8 * k;
          if (left > 0)
            hk::cp_async16_n(dst + 8 * k, from + 8 * k,
                             left >= 8 ? 16 : 2 * (int)left);
        }
      }
    }
    hk::cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kRec16Ahead; ++n) issue(n);
  // the lane's read of row r at a group's step s: its slot row plus the
  // row's offset mod 8 at that step (in 32 bits, which keeps it) plus the
  // lane
  int rd[kRec16Group][4];
#pragma unroll
  for (int s = 0; s < kRec16Group; ++s) {
    const unsigned t = (unsigned)(t0 + dt * s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned e = r < 3 ? t * (unsigned)(3 * row) + r * (unsigned)row +
                                     (unsigned)col
                               : t * (unsigned)row + (unsigned)col;
      rd[s][r] = (4 * s + r) * kRec16Span + (int)(e & 7u) + lane;
    }
  }
  const bool live = b < B;
  const long long step = dt * row;
  const long long first = t0 * row + col + lane;
  __nv_bfloat16* hp = h + first;
  __nv_bfloat16* cp = kWithC ? cs + first : nullptr;
  float c = 0.f;
  // group n's steps from its slot; kFull: all kRec16Group of them
  auto group = [&](auto full, int n) {
    constexpr bool kFull = decltype(full)::value;
    const int steps = kFull ? kRec16Group : T - n * kRec16Group;
    const unsigned short* d = mine + (n % kSlots) * kSlot;
    float a0[kRec16Group], x1[kRec16Group], x2[kRec16Group], a3[kRec16Group];
#pragma unroll
    for (int s = 0; s < kRec16Group; ++s) {
      if (kFull || s < steps) {
        a0[s] = bf16_at(d + rd[s][0]);
        x1[s] = kNegLog2e * (bf16_at(d + rd[s][1]) + b_f);
        x2[s] = kNegLog2e * (bf16_at(d + rd[s][2]) + b_r);
        a3[s] = bf16_at(d + rd[s][3]);
      }
    }
#pragma unroll
    for (int s = 0; s < kRec16Group; ++s) {
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
  const int groups = (T + kRec16Group - 1) / kRec16Group;
  for (int n = 0; n < groups; ++n) {
    hk::cp_async_wait<kRec16Ahead - 1>();  // this lane's copies of group n
    __syncwarp();  // the warp's; and every lane is past group n - 1's reads
    issue(n + kRec16Ahead);  // into group n - 1's slot
    if ((n + 1) * kRec16Group <= T)
      group(std::true_type{}, n);
    else
      group(std::false_type{}, n);
  }
  hk::cp_async_wait_all();
}

// the bf16 forward's shared bytes a warp: its ring
// (ops/sru_pallas.k4_fwd_geometry mirrors it); a block's warps' rings fit
// the default 48 KB of dynamic shared memory
constexpr int rec16_warp_smem() {
  return (kRec16Ahead + 1) * kRec16Group * 4 * kRec16Span * 2;
}
static_assert(kRecFwdThreads / 32 * rec16_warp_smem() <= 48 * 1024,
              "the bf16 forward's rings in the default shared memory");

int launch_rec_fwd16(const void* u, const void* xhw, const void* vb, void* h,
                     void* c, int T, int H, int B, int reverse, int cols,
                     int units, void* stream) {
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kRecFwdThreads ||
      (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(xhw)) %
          16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols, (H + units - 1) / units);
  const size_t smem = (size_t)(cols * units / 32) * rec16_warp_smem();
  using bf = __nv_bfloat16;
  auto kernel = c ? sru_rec_fwd16_kernel<true> : sru_rec_fwd16_kernel<false>;
  kernel<<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const bf*)u, (const bf*)xhw, (const bf*)vb, (bf*)h, (bf*)c, T, H, B,
      reverse, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// c may be null (serving); cols x units threads a block
// (ops/sru_pallas.k4_fwd_geometry).
extern "C" int sru_recurrence_fwd(const void* u, const void* xhw,
                                  const void* vb, void* h, void* c, int T,
                                  int H, int B, int reverse, int cols,
                                  int units, void* stream) {
  return launch_rec_fwd(u, xhw, vb, h, c, T, H, B, reverse, cols, units,
                        stream);
}

// K4 forward in bf16 storage (sru_rec_fwd16_kernel): u, xhw, vb, h and c
// bf16, u and xhw 16-byte aligned; sru_recurrence_fwd's blocks
extern "C" int sru_recurrence_fwd_bf16(const void* u, const void* xhw,
                                       const void* vb, void* h, void* c,
                                       int T, int H, int B, int reverse,
                                       int cols, int units, void* stream) {
  return launch_rec_fwd16(u, xhw, vb, h, c, T, H, B, reverse, cols, units,
                          stream);
}

// cols x units threads a block (ops/sru_fused.scan_bwd_geometry with one
// direction); dvb_part: (ceil(B / cols), 4, H).
extern "C" int sru_recurrence_bwd(const void* u, const void* xhw,
                                  const void* vb, const void* c,
                                  const void* dh, void* du, void* dxhw,
                                  void* dvb_part, int T, int H, int B,
                                  int reverse, int cols, int units,
                                  void* stream) {
  const long long hb = (long long)H * B;
  const ScanIO io{(const float*)u, (const float*)xhw, (float*)du,
                  (float*)dxhw, 3 * hb, hb, 3 * hb, hb, (const float*)c,
                  (const float*)dh, (const float*)vb, (float*)dvb_part,
                  reverse != 0};
  return (int)launch_scan_bwd<4>(io, io, 1, T, H, B, cols, units, 4LL * H,
                                 (cudaStream_t)stream);
}

// K4 backward in bf16 storage: u, xhw, vb, c and dh in and du, dxhw out
// bf16, the arithmetic float32 (sru_scan_bwd_kernel<14>); each thread's
// (v, b) sums, one unit's over its batch column, rounded to bf16 before
// the block adds them in float32, as the Pallas kernel writes one bf16
// partial a batch column that jnp.sum widens, adds in float32 and rounds
// once (the wrapper adds the blocks' float32 partials and rounds).
extern "C" int sru_recurrence_bwd_bf16(const void* u, const void* xhw,
                                       const void* vb, const void* c,
                                       const void* dh, void* du, void* dxhw,
                                       void* dvb_part, int T, int H, int B,
                                       int reverse, int cols, int units,
                                       void* stream) {
  using bf = __nv_bfloat16;
  const long long hb = (long long)H * B;
  const ScanIOT<bf, bf> io{(const bf*)u, (const bf*)xhw, (bf*)du, (bf*)dxhw,
                           3 * hb, hb, 3 * hb, hb, (const bf*)c,
                           (const bf*)dh, (const bf*)vb, (float*)dvb_part,
                           reverse != 0, 3 * T * hb - 1, T * hb - 1,
                           T * hb - 1};
  return (int)launch_scan_bwd<14>(io, io, 1, T, H, B, cols, units, 4LL * H,
                                  (cudaStream_t)stream);
}
