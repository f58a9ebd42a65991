// Near field of the grid repulsion a row at a time, on Hopper: each row is
// one vertex, against the bucket slots of its 3×3 cell neighborhood — the
// form in which the sharded grid step (core/distributed.py) calls the near
// field, one row per local vertex, the 9·cap slots split over "model".
//
// Replaces the Pallas kernel kernels/grid_force/kernel.py:grid_near_pallas
// (body _near_kernel) of the JAX package at cap = 1, as
// core/distributed.py:_grid_rep_spmd calls it through ops.near_field:
//
//   f_r = Σ_s (C·L²·w_s) · (p_r − p_s) / (|p_r − p_s|² + md²)
//
// over the slots s in columns [col0, col1) of row r's 9·cap slots (cell t
// of near9[r] gives columns t·cap .. t·cap + cap − 1); empty slots (w = 0)
// and columns past 9·cap add nothing.
//
// Two forms of the slot table, as the two variants of the sharded step
// hold it:
//   * index (all-gather variant): slots int32[ncell, cap] of indices into a
//     replicated table pos f32[ntab, 2], w f32[ntab] (the sentinel row has
//     w = 0);
//   * direct (halo variant): xyw f32[ncell, cap, 3] = (x, y, w) of each slot
//     (the band's cells and the two received halo rows).
// The kernel gathers through near9 and the table itself: the [rows, 9·cap]
// partner list (4.5 GB at 2^20 rows of 1080 slots) is never written.
//
// Design (simple first): one warp a row. The warp takes the row's cells in
// order; its lanes stride over a cell's slots (loads of one cell's index or
// xyw row are contiguous across the lanes), skip empty slots before reading
// their position, and keep the force in registers; a butterfly of shuffles
// sums the lanes. Each lane visits its slots in a fixed order and the
// butterfly is fixed, so a row's result repeats bit for bit run to run.
// The weight over d² takes the approximate reciprocal (rcp.approx.ftz:
// d² ≥ md² > 0), as the other force kernels do. C·L² and md² are read from
// device memory (consts[0], consts[1]).
//
// Bound on the H100: 11 flops a pair at the 67 TFLOP/s fp32 peak, or one
// reciprocal a pair on the MUFU pipe (16 lanes a clock per SM), against
// the bytes of the rows, near9, the slot table and the replicated table
// read once. The rows of one cell read the same slots; sharing them in
// shared memory, as grid_near.cu does for the per-cell form, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int NF_THREADS = 256;           // 8 rows a block

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <bool INDEX>
__global__ void __launch_bounds__(NF_THREADS)
near_field_kernel(const float* __restrict__ rows,
                  const int* __restrict__ near9, int R,
                  const int* __restrict__ slots,
                  const float* __restrict__ xyw, int ncell, int cap,
                  const float* __restrict__ pos,
                  const float* __restrict__ w, int ntab, int col0, int col1,
                  const float* __restrict__ consts, float* __restrict__ out) {
  const int r = (int)((blockIdx.x * (size_t)NF_THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;                      // whole warps leave together
  const float cl2 = __ldg(consts), md2 = __ldg(consts + 1);
  const float2 p = reinterpret_cast<const float2*>(rows)[r];
  float fx = 0.f, fy = 0.f;
  for (int t = 0; t < 9; ++t) {
    const int j0 = max(col0 - t * cap, 0);
    const int j1 = min(col1 - t * cap, cap);
    if (j0 >= j1) continue;
    const int c = __ldg(near9 + (size_t)r * 9 + t);
    if (c < 0 || c >= ncell) continue;
    for (int j = j0 + lane; j < j1; j += 32) {
      float x, y, m;
      if (INDEX) {
        const int s = __ldg(slots + (size_t)c * cap + j);
        if (s < 0 || s >= ntab) continue;
        m = __ldg(w + s);
        if (m == 0.f) continue;
        const float2 q = __ldg(reinterpret_cast<const float2*>(pos) + s);
        x = q.x;
        y = q.y;
      } else {
        const float* e = xyw + ((size_t)c * cap + j) * 3;
        m = __ldg(e + 2);
        if (m == 0.f) continue;
        x = __ldg(e);
        y = __ldg(e + 1);
      }
      const float dx = p.x - x;
      const float dy = p.y - y;
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, md2));
      const float inv = (cl2 * m) * rcp_approx(d2);
      fx = fmaf(dx, inv, fx);
      fy = fmaf(dy, inv, fy);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    fx += __shfl_xor_sync(0xffffffffu, fx, o);
    fy += __shfl_xor_sync(0xffffffffu, fy, o);
  }
  if (lane == 0) reinterpret_cast<float2*>(out)[r] = make_float2(fx, fy);
}

}  // namespace

// rows f32[R, 2] and out f32[R, 2] (8-byte aligned), near9 int32[R, 9];
// index form (pos != nullptr): cells = slots int32[ncell, cap], pos
// f32[ntab, 2] (8-byte aligned), w f32[ntab]; direct form (pos == nullptr):
// cells = xyw f32[ncell, cap, 3]. Columns [col0, col0 + ncols) of each
// row's 9·cap slots; consts f32[2] = (C·L², md²).
extern "C" int near_field_launch(const float* rows, const int* near9, int R,
                                 const void* cells, int ncell, int cap,
                                 const float* pos, const float* w, int ntab,
                                 int col0, int ncols, const float* consts,
                                 float* out, cudaStream_t stream) {
  if (R > 0) {
    const unsigned blocks =
        (unsigned)(((size_t)R * 32 + NF_THREADS - 1) / NF_THREADS);
    const int col1 = col0 + ncols;
    if (pos != nullptr) {
      near_field_kernel<true><<<blocks, NF_THREADS, 0, stream>>>(
          rows, near9, R, static_cast<const int*>(cells), nullptr, ncell, cap,
          pos, w, ntab, col0, col1, consts, out);
    } else {
      near_field_kernel<false><<<blocks, NF_THREADS, 0, stream>>>(
          rows, near9, R, nullptr, static_cast<const float*>(cells), ncell,
          cap, nullptr, nullptr, 0, col0, col1, consts, out);
    }
  }
  return (int)cudaGetLastError();
}
