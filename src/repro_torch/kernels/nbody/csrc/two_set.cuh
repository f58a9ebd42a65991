// Two-set n-body FR repulsion on Hopper: every target against every source.
//
// Its one user is nbody.cu, the port of kernels/nbody/kernel.py:
// nbody_repulsion_pallas of the JAX package: all pairs of one vertex set
// (sources = targets = the level's vertices, weight mass·vmask, output
// masked by vmask). The grid far field has a kernel of its own
// (../../grid_force/csrc/grid_far.cu).
//
//   f_t = Σ_s (C·L²·w_s) · (p_t − p_s) / (|p_t − p_s|² + md²)
//
// Bound on the H100: fp32 throughput. Each pair costs 11 flops, counting a
// multiply-add as 2 (2 sub; d2 = dx·dx + dy·dy + md²: 2 mul + 2 add; one
// division; 2 multiply-adds) on 4 + 12 bytes
// that are read once per target and once per source, so at any realistic size
// the arithmetic dwarfs the bytes (n = 2048: 4M pairs on 40 KB).
//
// Design: one thread per target, which keeps its force in two registers. The
// block stages a tile of TS_THREADS sources (x, y, C·L²·w) through shared
// memory — every thread of the block reads the same source at once, a
// broadcast — and loops over the tiles. The ragged edge of both sets is
// masked here, so any n works. The order of operations is the reference's:
// inv = (C·L²·w) / d2, then f += d·inv. Sums run in source order per target,
// so results are deterministic run to run.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int TS_THREADS = 256;

// Source s sits at (spos[s*ps], spos[s*ps+1]) with weight sw[s*ws], zeroed
// where smask[s] is false (HAS_SRC_MASK). A target whose out_mask is false
// gets force 0 (HAS_OUT_MASK).
template <bool HAS_SRC_MASK, bool HAS_OUT_MASK>
__global__ void __launch_bounds__(TS_THREADS)
two_set_kernel(const float* __restrict__ tpos, int nt,
               const float* __restrict__ spos, int ps,
               const float* __restrict__ sw, int ws,
               const bool* __restrict__ smask, int ns,
               const bool* __restrict__ out_mask,
               float cl2, float md2, float* __restrict__ out) {
  __shared__ float sx[TS_THREADS];
  __shared__ float sy[TS_THREADS];
  __shared__ float scw[TS_THREADS];
  const int t = blockIdx.x * TS_THREADS + threadIdx.x;
  float px = 0.f, py = 0.f;
  if (t < nt) {
    px = tpos[2 * (size_t)t];
    py = tpos[2 * (size_t)t + 1];
  }
  float fx = 0.f, fy = 0.f;
  for (int base = 0; base < ns; base += TS_THREADS) {
    const int s = base + threadIdx.x;
    if (s < ns) {
      float w = sw[(size_t)s * ws];
      if (HAS_SRC_MASK && !smask[s]) w = 0.f;
      sx[threadIdx.x] = spos[(size_t)s * ps];
      sy[threadIdx.x] = spos[(size_t)s * ps + 1];
      scw[threadIdx.x] = cl2 * w;
    }
    __syncthreads();
    const int cnt = min(TS_THREADS, ns - base);
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float dx = px - sx[j];
      const float dy = py - sy[j];
      const float d2 = dx * dx + dy * dy + md2;
      const float inv = scw[j] / d2;
      fx += dx * inv;
      fy += dy * inv;
    }
    __syncthreads();
  }
  if (t < nt) {
    if (HAS_OUT_MASK && !out_mask[t]) {
      fx = 0.f;
      fy = 0.f;
    }
    out[2 * (size_t)t] = fx;
    out[2 * (size_t)t + 1] = fy;
  }
}

inline int two_set_blocks(int nt) { return (nt + TS_THREADS - 1) / TS_THREADS; }

}  // namespace repro_torch
