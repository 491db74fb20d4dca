// Gen-1 SRU recurrence kernels for Hopper (sm_90a), float32.
//
// K4  sru_recurrence_fwd  replaces the Pallas kernel _fwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_fwd_impl).
// K4  sru_recurrence_bwd  replaces the Pallas kernel _bwd_kernel
//     (rtfs_tpu/ops/sru_pallas.py, pallas_call in _sru_vjp_bwd).
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
// (training); serving passes null.
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
// chain. Its design unrolls the time loop so that the loads of later
// steps (which do not depend on c) start ahead of the chain. The backward
// carries only dc across steps, so it can run at its bytes bound if
// enough loads are in flight: the scan keeps each thread's next kScanAhead
// steps of copies in flight and spreads its 32-128 thread blocks over the SMs
// (sru_scan.cuh).

#include <cuda_runtime.h>

#include "sru_scan.cuh"

namespace {

// the forward's block size
constexpr int kThreads = 128;

// grid (ceil(B / kThreads), H), one thread per (column b, unit j).
__global__ void sru_rec_fwd_kernel(const float* __restrict__ u,
                                   const float* __restrict__ xhw,
                                   const float* __restrict__ vb,
                                   float* __restrict__ h,
                                   float* __restrict__ cs,
                                   int T, int H, int B, int reverse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (b >= B) return;
  const float v_f = vb[j], v_r = vb[H + j];
  const float b_f = vb[2 * H + j], b_r = vb[3 * H + j];
  const long long row = (long long)H * B;  // one gate block per step
  const long long col = (long long)j * B + b;
  float c = 0.f;
#pragma unroll 4
  for (int i = 0; i < T; ++i) {
    const int t = reverse ? T - 1 - i : i;
    const float* ut = u + (long long)t * 3 * row + col;
    const float u0 = ut[0], u1 = ut[row], u2 = ut[2 * row];
    const long long o = (long long)t * row + col;
    const float x = xhw[o];
    const float f = sigmoid_f(u1 + v_f * c + b_f);
    c = f * c + (1.f - f) * u0;
    const float r = sigmoid_f(u2 + v_r * c + b_r);
    h[o] = r * c + (1.f - r) * x;
    if (cs) cs[o] = c;
  }
}

}  // namespace

// c may be null (serving).
extern "C" int sru_recurrence_fwd(const void* u, const void* xhw,
                                  const void* vb, void* h, void* c, int T,
                                  int H, int B, int reverse, void* stream) {
  dim3 grid((B + kThreads - 1) / kThreads, H);
  sru_rec_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)xhw, (const float*)vb, (float*)h,
      (float*)c, T, H, B, reverse);
  return (int)cudaGetLastError();
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
