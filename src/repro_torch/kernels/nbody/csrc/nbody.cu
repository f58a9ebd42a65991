// All-pairs FR repulsion of one vertex set on Hopper.
//
// Replaces the Pallas kernel kernels/nbody/kernel.py:nbody_repulsion_pallas
// (body _nbody_kernel) of the JAX package:
//
//   f_t = Σ_s (C·L²·w_s) · (p_t − p_s) / (|p_t − p_s|² + md²),  w_s = mass_s·vmask_s,
//
// for every vertex t, and f_t = 0 where vmask_t is false.
//
// Bound on the H100: fp32 throughput. Each pair costs 11 flops, counting a
// multiply-add as 2 (2 sub; d² = dx·dx + dy·dy + md²: 2 mul + 2 add; one
// reciprocal counted as a division; 2 multiply-adds), on 13 bytes a vertex
// read once. The layout calls it on its exact levels (n ≤ 2048): at most
// 4.2M pairs, 0.7 µs of arithmetic for the whole card, so a call is bound by
// its launch and by the latency of its few dependent steps, not by either
// rate. The design spreads every call over many SMs and keeps its chain of
// dependent steps short:
//
//   * A cluster of NB_CLUSTER blocks takes one tile of NB_TILE targets; the
//     cluster's NB_CLUSTER·NB_WARPS warps split the sources between them in
//     subtiles of 32 (warp g of the cluster takes subtiles g, g + 64, …).
//     At 632 valid of n = 1024, 10 live clusters = 80 blocks carry the call.
//   * Each lane owns NB_T targets of the tile (t0 + lane + 32·k), so every
//     source broadcast from shared memory serves NB_T pairs.
//   * Work that cannot contribute is skipped, for any vmask: a subtile whose
//     32 weights are all 0 (one __ballot_sync), and a tile without a valid
//     target (its cluster writes zeros and leaves). At 9 valid of 256 the
//     call is one subtile of one cluster.
//   * The partial forces are joined in a fixed order, without atomics: each
//     block sums its warps' partials in warp order through shared memory,
//     then block r of the cluster sums the NB_CLUSTER blocks' sums of its
//     share of the tile in rank order through distributed shared memory.
//     The result is bit-identical from call to call.
//   * C·L² and md² are read from device memory (consts[0], consts[1]) at the
//     start of each block, so one captured CUDA graph serves every value
//     of them: the refine step's schedule row holds them.
//   * Lanes: B independent vertex sets of n_pad rows each (the batched
//     driver's [B, n_pad] groups) in one launch, lane b on blockIdx.y = b
//     with its own constants consts[2b], consts[2b + 1]. A lane's blocks
//     read and write only its rows, in the order of a one-lane call, so a
//     lane's result is the bits of the same lane launched alone. Lanes
//     multiply the clusters of a launch: at the batched floor n_pad 64 a
//     lane is one cluster.
//   * The weight over d² takes the approximate reciprocal (rcp.approx.ftz):
//     d² ≥ md² > 0 and both are normal floats, so no special case arises. The
//     order of operations is the reference's: inv = (C·L²·w)·(1/d²), then
//     f += d·inv.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB_WARPS = 8;                 // warps a block
constexpr int NB_T = 2;                     // targets a lane
constexpr int NB_TILE = 32 * NB_T;          // targets a cluster
constexpr int NB_CLUSTER = 8;               // blocks a cluster
constexpr int NB_SHARE = NB_TILE / NB_CLUSTER;  // targets each block finishes

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__global__ void __cluster_dims__(NB_CLUSTER, 1, 1)
__launch_bounds__(NB_WARPS * 32)
nbody_kernel(const float2* __restrict__ pos, const float* __restrict__ mass,
             const bool* __restrict__ vmask, int n,
             const float* __restrict__ consts, float2* __restrict__ out) {
  __shared__ float4 src[NB_WARPS][32];       // each warp's current subtile
  __shared__ float2 part[NB_WARPS][NB_TILE];  // each warp's partial forces
  __shared__ float2 red[NB_TILE];             // the block's sum of them
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = (blockIdx.x / NB_CLUSTER) * NB_TILE;
  const size_t lane0 = (size_t)blockIdx.y * n;     // the lane's first row
  pos += lane0;
  mass += lane0;
  vmask += lane0;
  out += lane0;
  consts += 2 * blockIdx.y;
  const float cl2 = __ldg(consts), md2 = __ldg(consts + 1);

  float px[NB_T], py[NB_T], fx[NB_T], fy[NB_T];
  bool live = false;
#pragma unroll
  for (int k = 0; k < NB_T; ++k) {
    const int t = t0 + lane + 32 * k;
    const float2 p = t < n ? pos[t] : make_float2(0.f, 0.f);
    px[k] = p.x;
    py[k] = p.y;
    fx[k] = 0.f;
    fy[k] = 0.f;
    live |= t < n && vmask[t];
  }
  // the same answer in every block of the cluster (it sees the same tile),
  // so a dead tile's blocks all leave before any cluster barrier
  if (!__syncthreads_or(live)) {
    if (threadIdx.x < NB_SHARE) {
      const int t = t0 + rank * NB_SHARE + threadIdx.x;
      if (t < n) out[t] = make_float2(0.f, 0.f);
    }
    return;
  }

  constexpr int stride = NB_CLUSTER * NB_WARPS;
  const int nsub = (n + 31) / 32;
  for (int sub = rank * NB_WARPS + warp; sub < nsub; sub += stride) {
    const int s = sub * 32 + lane;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);   // past n: weight 0
    if (s < n) {
      const float2 p = pos[s];
      v = make_float4(p.x, p.y, vmask[s] ? cl2 * mass[s] : 0.f, 0.f);
    }
    if (__ballot_sync(0xffffffffu, v.z != 0.f) == 0u) continue;
    src[warp][lane] = v;
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float4 c = src[warp][j];
#pragma unroll
      for (int k = 0; k < NB_T; ++k) {
        const float dx = px[k] - c.x;
        const float dy = py[k] - c.y;
        const float d2 = dx * dx + dy * dy + md2;
        const float inv = c.z * rcp_approx(d2);
        fx[k] += dx * inv;
        fy[k] += dy * inv;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int k = 0; k < NB_T; ++k)
    part[warp][lane + 32 * k] = make_float2(fx[k], fy[k]);
  __syncthreads();
  if (threadIdx.x < NB_TILE) {
    float2 acc = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NB_WARPS; ++w) {
      acc.x += part[w][threadIdx.x].x;
      acc.y += part[w][threadIdx.x].y;
    }
    red[threadIdx.x] = acc;
  }
  cluster.sync();                   // every block's sum is in its red[]
  if (threadIdx.x < NB_SHARE) {
    const int i = rank * NB_SHARE + threadIdx.x;
    const int t = t0 + i;
    float2 acc = *cluster.map_shared_rank(&red[i], 0);
#pragma unroll
    for (int r = 1; r < NB_CLUSTER; ++r) {
      const float2 b = *cluster.map_shared_rank(&red[i], r);
      acc.x += b.x;
      acc.y += b.y;
    }
    if (t < n) out[t] = vmask[t] ? acc : make_float2(0.f, 0.f);
  }
  cluster.sync();                   // no block leaves while its red[] is read
}

}  // namespace

// pos f32[lanes, n, 2] and out f32[lanes, n, 2] (8-byte aligned: torch
// allocations are), mass f32[lanes, n], vmask bool[lanes, n], consts
// f32[lanes, 2] = (C·L², md²) of each lane. One cluster of NB_CLUSTER
// blocks for each tile of NB_TILE targets of each lane.
extern "C" int nbody_repulsion_launch(const float* pos, const float* mass,
                                      const bool* vmask, int n, int lanes,
                                      const float* consts, float* out,
                                      cudaStream_t stream) {
  if (n > 0 && lanes > 0) {
    const dim3 blocks((n + NB_TILE - 1) / NB_TILE * NB_CLUSTER, lanes);
    nbody_kernel<<<blocks, NB_WARPS * 32, 0, stream>>>(
        reinterpret_cast<const float2*>(pos), mass, vmask, n, consts,
        reinterpret_cast<float2*>(out));
  }
  return (int)cudaGetLastError();
}
