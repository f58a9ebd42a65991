// k-hop neighbor-list FR repulsion on Hopper.
//
// Replaces the Pallas kernel kernels/neighbor_force/kernel.py:
// neighbor_repulsion_pallas (body _neighbor_kernel) of the JAX package,
// together with the XLA gather in front of it (neighbor_force/ops.py:26-30):
//
//   f_v = Σ_k C·L²·w_u · (p_v − p_u) / (|p_v − p_u|² + md²),
//   u = nbr_idx[v, k], w_u = mass_u·vmask_u, over slots with nbr_mask set.
//
// Bound on the H100: device-memory bytes. Per (v, k) slot the kernel reads
// the index (4 B) and mask (1 B) and gathers a position (8 B), a mass (4 B)
// and a mask byte (1 B) — ~18 B for 11 flops, far below the card's
// flops-per-byte balance.
//
// Design: one warp per vertex. The 32 lanes walk the vertex's list row
// together, so the reads of nbr_idx and nbr_mask are coalesced, and each lane
// gathers its neighbor's position and weight straight from device memory
// (no pre-gathered [n, K, 2] table is ever written). A sentinel index (≥ n),
// a masked slot or an invalid neighbor contributes 0, as in the reference;
// a vertex outside vmask gets force 0 and skips its row. The lanes' partial
// sums meet in a fixed shuffle tree, so results are deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int NB_WARPS = 8;

__global__ void __launch_bounds__(NB_WARPS * 32)
neighbor_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                const bool* __restrict__ vmask,
                const int* __restrict__ nbr_idx,
                const bool* __restrict__ nbr_mask, int n, int K, float cl2,
                float md2, float* __restrict__ out) {
  const int v = blockIdx.x * NB_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  if (!vmask[v]) {
    if (lane == 0) {
      out[2 * (size_t)v] = 0.f;
      out[2 * (size_t)v + 1] = 0.f;
    }
    return;
  }
  const float px = pos[2 * (size_t)v];
  const float py = pos[2 * (size_t)v + 1];
  const int* row = nbr_idx + (size_t)v * K;
  const bool* mrow = nbr_mask + (size_t)v * K;
  float fx = 0.f, fy = 0.f;
  for (int k = lane; k < K; k += 32) {
    const int u = row[k];
    if (mrow[k] && u >= 0 && u < n && vmask[u]) {
      const float dx = px - pos[2 * (size_t)u];
      const float dy = py - pos[2 * (size_t)u + 1];
      const float d2 = dx * dx + dy * dy + md2;
      const float inv = (cl2 * mass[u]) / d2;
      fx += dx * inv;
      fy += dy * inv;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fx += __shfl_down_sync(0xffffffffu, fx, off);
    fy += __shfl_down_sync(0xffffffffu, fy, off);
  }
  if (lane == 0) {
    out[2 * (size_t)v] = fx;
    out[2 * (size_t)v + 1] = fy;
  }
}

}  // namespace

extern "C" int neighbor_repulsion_launch(const float* pos, const float* mass,
                                         const bool* vmask, const int* nbr_idx,
                                         const bool* nbr_mask, int n, int K,
                                         float cl2, float md2, float* out,
                                         cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + NB_WARPS - 1) / NB_WARPS;
    neighbor_kernel<<<blocks, NB_WARPS * 32, 0, stream>>>(
        pos, mass, vmask, nbr_idx, nbr_mask, n, K, cl2, md2, out);
  }
  return (int)cudaGetLastError();
}
