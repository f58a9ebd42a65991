// Far field of the grid repulsion on Hopper: every vertex against every
// cell aggregate (x, y, mass).
//
// Replaces the Pallas kernel kernels/grid_force/kernel.py:grid_far_pallas
// (body _far_kernel) of the JAX package:
//
//   f_t = Σ_s (C·L²·w_s) · (p_t − p_s) / (|p_t − p_s|² + md²)
//
// over the G² cell aggregates s, for every vertex t; no output is masked
// (the caller masks the composed force).
//
// Bound on the H100: the arithmetic. The yardstick is 11 flops a pair (a
// multiply-add counts 2) at the 67 TFLOP/s fp32 peak, but the instructions
// a pair needs set the real ceiling: 7 on the FP32 pipe (2 FADD for the
// difference, 2 FFMA for d², 1 FMUL by the weight, 2 FFMA into the force)
// and one reciprocal on the MUFU pipe, whose 16 lanes a clock per SM (a
// quarter of the FP32 pipe's 128 lanes over 7 instructions) make it the
// narrower of the two.
//
// Design: each thread owns FAR_T targets (positions and forces in
// registers), so every source read from shared memory serves FAR_T pairs.
// The block stages a tile of sources as float4 (x, y, C·L²·w, 0): one
// 128-bit broadcast load a source. The weight over d² takes the approximate
// reciprocal (rcp.approx.ftz): d² ≥ md² > 0 and both are normal floats, so
// no special case arises, and one ulp of error is far inside the kernel's
// tolerance against the plain version. Each target sums its sources in
// order, so the result is deterministic run to run. Ragged edges of both
// sets are masked (a missing source has weight 0 at the origin). C·L² and
// md² are read from device memory (consts[0], consts[1]), so one captured
// CUDA graph serves every value of them.
#include <cuda_runtime.h>

namespace {

// 4096 targets a block: at n = 2^20, 256 blocks, all resident at once on
// 132 SMs (two a SM at 32 registers a thread), so no second wave trails
constexpr int FAR_THREADS = 1024;
constexpr int FAR_T = 4;           // targets per thread

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// FAR_THREADS threads, each FAR_T targets; a tile of FAR_THREADS sources
__global__ void __launch_bounds__(FAR_THREADS)
grid_far_kernel(const float* __restrict__ pos, int n,
                const float* __restrict__ cell_xyw, int nc,
                const float* __restrict__ consts, float* __restrict__ out) {
  constexpr int T = FAR_T;
  const float cl2 = __ldg(consts), md2 = __ldg(consts + 1);
  __shared__ float4 src[FAR_THREADS];
  // targets t0 + k·FAR_THREADS: a warp's loads and stores stay contiguous
  const int t0 = blockIdx.x * FAR_THREADS * T + threadIdx.x;
  float px[T], py[T], fx[T], fy[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int t = t0 + k * FAR_THREADS;
    const float2 p = t < n ? reinterpret_cast<const float2*>(pos)[t]
                           : make_float2(0.f, 0.f);
    px[k] = p.x;
    py[k] = p.y;
    fx[k] = 0.f;
    fy[k] = 0.f;
  }
  for (int base = 0; base < nc; base += FAR_THREADS) {
    const int s = base + threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < nc) {
      const float* c = cell_xyw + 3 * (size_t)s;
      v = make_float4(c[0], c[1], cl2 * c[2], 0.f);
    }
    src[threadIdx.x] = v;
    __syncthreads();
    const int cnt = min(FAR_THREADS, nc - base);
    if (cnt == FAR_THREADS) {
#pragma unroll 8
      for (int j = 0; j < FAR_THREADS; ++j) {
        const float4 c = src[j];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          const float dx = px[k] - c.x;
          const float dy = py[k] - c.y;
          const float d2 = fmaf(dx, dx, fmaf(dy, dy, md2));
          const float inv = c.z * rcp_approx(d2);
          fx[k] = fmaf(dx, inv, fx[k]);
          fy[k] = fmaf(dy, inv, fy[k]);
        }
      }
    } else {
      for (int j = 0; j < cnt; ++j) {
        const float4 c = src[j];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          const float dx = px[k] - c.x;
          const float dy = py[k] - c.y;
          const float d2 = fmaf(dx, dx, fmaf(dy, dy, md2));
          const float inv = c.z * rcp_approx(d2);
          fx[k] = fmaf(dx, inv, fx[k]);
          fy[k] = fmaf(dy, inv, fy[k]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int t = t0 + k * FAR_THREADS;
    if (t < n) reinterpret_cast<float2*>(out)[t] = make_float2(fx[k], fy[k]);
  }
}

}  // namespace

// pos f32[n, 2] and out f32[n, 2] (8-byte aligned: torch allocations are),
// cell_xyw f32[nc, 3] = (x, y, mass) of each cell aggregate, consts f32[2]
// = (C·L², md²).
extern "C" int grid_far_launch(const float* pos, int n, const float* cell_xyw,
                               int nc, const float* consts, float* out,
                               cudaStream_t stream) {
  if (n > 0) {
    constexpr int per_block = FAR_THREADS * FAR_T;
    grid_far_kernel<<<(n + per_block - 1) / per_block, FAR_THREADS, 0,
                      stream>>>(pos, n, cell_xyw, nc, consts, out);
  }
  return (int)cudaGetLastError();
}
