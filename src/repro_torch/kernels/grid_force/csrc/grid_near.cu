// Exact near field of the grid repulsion on Hopper.
//
// Replaces the Pallas kernel kernels/grid_force/kernel.py:grid_near_pallas
// (body _near_kernel) of the JAX package, together with the XLA gathers in
// front of it and the scatter behind it (grid_force/ops.py:328-335): each
// bucketed vertex v of cell c feels every vertex u bucketed in c's 3×3
// neighborhood,
//
//   f_v = Σ_u C·L²·w_u · (p_v − p_u) / (|p_v − p_u|² + md²),  w_u = mass_u·vmask_u,
//
// and the force is written straight to f_near[v]. A vertex outside every
// bucket (overflow) keeps the 0 the caller initialised; the self pair has
// d = 0 and so adds 0, as in the reference.
//
// Bound on the H100: fp32 throughput. A cell of `cap` rows meets 9·cap slots;
// at n = 2^20 (G = 128, cap = 120) that is ~2·10^9 pairs of 11 flops per
// call, on ~60 MB of reads.
//
// Design: one block per cell. A bucket row fills from slot 0, so each of the
// 9 neighbor cells holds a prefix of valid slots; the block finds the 9
// prefix lengths, then gathers just those slots (x, y, C·L²·w) into shared
// memory, compacted, in the reference's slot order (9·cap·12 B at most,
// ~13 KB at cap = 120). Each thread owns one bucket row at a time and sums
// over the shared slots in order, so results are deterministic. An empty
// cell exits at once.
#include <cuda_runtime.h>

namespace {

constexpr int NEAR_THREADS = 128;

__global__ void __launch_bounds__(NEAR_THREADS)
near_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
            const bool* __restrict__ vmask, const int* __restrict__ bucket,
            const int* __restrict__ table, int n, int cap, float cl2,
            float md2, float* __restrict__ f_near) {
  extern __shared__ float smem[];
  __shared__ int cell_of[9];
  __shared__ int off[10];
  const int cell = blockIdx.x;
  const int* own = bucket + (size_t)cell * cap;
  if (own[0] >= n) return;  // empty cell: no rows (uniform over the block)

  if (threadIdx.x < 9) {
    const int c = table[(size_t)cell * 9 + threadIdx.x];
    const int* row = bucket + (size_t)c * cap;
    int lo = 0, hi = cap;  // first sentinel slot: rows fill from slot 0
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (row[mid] < n) lo = mid + 1; else hi = mid;
    }
    cell_of[threadIdx.x] = c;
    off[threadIdx.x + 1] = lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int j = 0; j < 9; ++j) off[j + 1] += off[j];
  }
  __syncthreads();
  const int total = off[9];
  float* sx = smem;
  float* sy = smem + 9 * cap;
  float* scw = smem + 18 * cap;
  for (int s = threadIdx.x; s < total; s += NEAR_THREADS) {
    int j = 0;
    while (s >= off[j + 1]) ++j;
    const int u = bucket[(size_t)cell_of[j] * cap + (s - off[j])];
    sx[s] = pos[2 * (size_t)u];
    sy[s] = pos[2 * (size_t)u + 1];
    scw[s] = cl2 * (vmask[u] ? mass[u] : 0.f);
  }
  __syncthreads();

  for (int r = threadIdx.x; r < cap; r += NEAR_THREADS) {
    const int v = own[r];
    if (v >= n) break;  // the rest of the row is sentinel
    const float px = pos[2 * (size_t)v];
    const float py = pos[2 * (size_t)v + 1];
    float fx = 0.f, fy = 0.f;
#pragma unroll 8
    for (int s = 0; s < total; ++s) {
      const float dx = px - sx[s];
      const float dy = py - sy[s];
      const float d2 = dx * dx + dy * dy + md2;
      const float inv = scw[s] / d2;
      fx += dx * inv;
      fy += dy * inv;
    }
    f_near[2 * (size_t)v] = fx;
    f_near[2 * (size_t)v + 1] = fy;
  }
}

}  // namespace

// bucket: int32[(nc + 1) * cap], sentinel n; table: int32[(nc + 1) * 9],
// sentinel nc; f_near: float32[n, 2], zeroed by the caller.
extern "C" int grid_near_launch(const float* pos, const float* mass,
                                const bool* vmask, const int* bucket,
                                const int* table, int n, int nc, int cap,
                                float cl2, float md2, float* f_near,
                                cudaStream_t stream) {
  const size_t smem = (size_t)27 * cap * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        near_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (nc > 0) {
    near_kernel<<<nc, NEAR_THREADS, smem, stream>>>(
        pos, mass, vmask, bucket, table, n, cap, cl2, md2, f_near);
  }
  return (int)cudaGetLastError();
}
