// Gen-1 SRU recurrence kernels for Hopper (sm_90a), float32 and bf16
// storage.
//
// K4  sru_recurrence_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_fwd_impl).
// K4  sru_recurrence_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_vjp_bwd).
// sru_recurrence_{fwd,bwd}_bf16 are the same kernels on bf16 storage (a
// bf16 model's U takes the compute dtype, and the Pallas kernels run in
// it): the arithmetic and the carries float32, the stored values rounded
// where the Pallas kernels round them.
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
//
// E bf16 (sru_recurrence_fwd_bf16): u, xhw, vb, h and c bf16, as the
// Pallas kernel on a bf16 model; a slot holds the 4-byte word that holds
// the value (copy_value of sru_scan.cuh: cp.async has no 2-byte copy, and
// where H * B is odd the rows start on 2-byte boundaries), and the value
// is its half of the word, widened. The gates, the cell update and the
// carry c are float32 (the Pallas body promotes bf16 u, v and b against
// its float32 carry); only the stored h and c are rounded, and the carry
// is never rounded between steps. u_last / x_last: the index of u's and
// xhw's last value (bf16 only).
template <typename E>
__global__ void __launch_bounds__(kRecFwdThreads)
sru_rec_fwd_kernel(const E* __restrict__ u, const E* __restrict__ xhw,
                   const E* __restrict__ vb, E* __restrict__ h,
                   E* __restrict__ cs, int T, int H, int B, int reverse,
                   int cols, long long u_last, long long x_last) {
  extern __shared__ float ring[];  // (kRecFwdAhead, 4, blockDim.x)
  const int b = blockIdx.x * cols + threadIdx.x % cols;
  const int j = blockIdx.y * (blockDim.x / cols) + threadIdx.x / cols;
  if (b >= B || j >= H) return;
  const float v_f = load_value(vb + j), v_r = load_value(vb + H + j);
  const float b_f = load_value(vb + 2 * H + j);
  const float b_r = load_value(vb + 3 * H + j);
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
        copy_value(d + g * nt, u, eu + g * row, u_last, true);
      copy_value(d + 3 * nt, xhw, (long long)t * row + col, x_last, true);
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
    const long long eu = (long long)t * 3 * row + col;
    const float u0 = slot_value<E>(d, upper_half(u, eu, 0, 0));
    const float u1 = slot_value<E>(d + nt, upper_half(u, eu + row, 0, 0));
    const float u2 =
        slot_value<E>(d + 2 * nt, upper_half(u, eu + 2 * row, 0, 0));
    const float x = slot_value<E>(d + 3 * nt, upper_half(xhw, o, 0, 0));
    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
    store_value(h + o, r * c + (1.f - r) * x);
    if (cs) store_value(cs + o, c);
    issue(i + kRecFwdAhead);  // into the slot just read (its values used)
  }
}

template <typename E>
int launch_rec_fwd(const void* u, const void* xhw, const void* vb, void* h,
                   void* c, int T, int H, int B, int reverse, int cols,
                   int units, void* stream) {
  if (T < 1 || H < 1 || B < 1 || cols < 32 || cols % 32 != 0 || units < 1 ||
      cols * units > kRecFwdThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + cols - 1) / cols, (H + units - 1) / units);
  const size_t smem = (size_t)kRecFwdAhead * 4 * cols * units * sizeof(float);
  const long long hb = (long long)H * B;
  sru_rec_fwd_kernel<E><<<grid, cols * units, smem, (cudaStream_t)stream>>>(
      (const E*)u, (const E*)xhw, (const E*)vb, (E*)h, (E*)c, T, H, B,
      reverse, cols, 3 * T * hb - 1, T * hb - 1);
  return (int)cudaGetLastError();
}

}  // namespace

// c may be null (serving); cols x units threads a block
// (ops/sru_pallas.k4_fwd_geometry).
extern "C" int sru_recurrence_fwd(const void* u, const void* xhw,
                                  const void* vb, void* h, void* c, int T,
                                  int H, int B, int reverse, int cols,
                                  int units, void* stream) {
  return launch_rec_fwd<float>(u, xhw, vb, h, c, T, H, B, reverse, cols,
                               units, stream);
}

// K4 forward in bf16 storage: u, xhw, vb, h and c bf16, the launch as
// sru_recurrence_fwd's (the same blocks and ring)
extern "C" int sru_recurrence_fwd_bf16(const void* u, const void* xhw,
                                       const void* vb, void* h, void* c,
                                       int T, int H, int B, int reverse,
                                       int cols, int units, void* stream) {
  return launch_rec_fwd<__nv_bfloat16>(u, xhw, vb, h, c, T, H, B, reverse,
                                       cols, units, stream);
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
