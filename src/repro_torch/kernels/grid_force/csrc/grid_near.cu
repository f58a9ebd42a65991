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
// bucket (overflow) gets 0; the self pair has d = 0 and so adds 0, as in the
// reference.
//
// Bounds on the H100, for the pairs the buckets hold (each bucketed row
// against the valid slots of its 9 cells):
//   * the yardstick: 11 flops a pair (a multiply-add counts 2) at the
//     67 TFLOP/s fp32 peak;
//   * the real ceiling: one reciprocal a pair on the MUFU pipe, 16 lanes a
//     clock per SM. The random 2^20 shape (G 128, cap 120, ~61 rows a cell)
//     holds ~544M pairs: 0.13 ms at 132 SMs × 1.98 GHz.
//
// Design: two kernels, one launch of the wrapper.
//   1. near_pack_kernel, a warp a cell, lanes over the cell's slots: each
//      valid bucket slot's vertex as float4 (x, y, C·L²·w, 0) at
//      packed[c·cap + slot], the count of valid slots in cnt[c] (ballots
//      over the row, 32 slots at a time; rows fill from slot 0, so the count
//      is the prefix length), and f_near zeroed. Every later read of a
//      source is then one 16-byte load from a row that neighbouring warps
//      read too, in place of three random ones.
//   2. near_kernel, a warp a cell, NEAR_WARPS consecutive cells a block
//      (most share a grid row, and so 6 of their 9 neighbor rows in L1), no
//      barrier:
//      * lanes 0–8 read the 9 neighbor cells and their counts at once, and
//        shuffles hand each row's cell and length to the warp;
//      * the lanes split as (row group g, slice q of the slots): RT ≤ 4 rows
//        a lane and s lanes a row, each summing the slots q, q + s, … of
//        each neighbor row, with (RT, s) picked per row count on the host
//        (grid_force/ops.py: near_split) — 61 rows take 4 rows a lane and
//        2 lanes a row (61 of 64 row slots), 10 rows 2 rows a lane and 5
//        lanes a row (30 of 32 lanes);
//      * the s partial sums of a row are joined by __shfl_down_sync in a
//        fixed tree order, so results are bit-identical from call to call,
//        with no atomics;
//      * the weight over d² takes the approximate reciprocal (rcp.approx.ftz):
//        d² ≥ md² > 0 and both are normal floats, so no special case arises.
//   C·L² (pack) and md² (near) are read from device memory, consts[0] and
//   consts[1], so one captured CUDA graph serves every value of them.
//   The sources are read in place through L1, not staged in shared memory:
//   a variant that copied each cell's 9 rows into shared memory (cp.async,
//   compacted) measured slower on the H100 at both path grids, and needs no
//   cap limit this way.
#include <cuda_runtime.h>

namespace {

constexpr int PACK_WARPS = 8;
constexpr int NEAR_WARPS = 4;        // cells a block of near_kernel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// cells 0..nc (the sentinel row nc included, whose count is 0)
__global__ void __launch_bounds__(PACK_WARPS * 32)
near_pack_kernel(const float2* __restrict__ pos, const float* __restrict__ mass,
                 const bool* __restrict__ vmask, const int* __restrict__ bucket,
                 int n, int nc, int cap, const float* __restrict__ consts,
                 float4* __restrict__ packed, int* __restrict__ cnt,
                 float2* __restrict__ f_near) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    f_near[i] = make_float2(0.f, 0.f);
  const int c = blockIdx.x * PACK_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c > nc) return;
  const int* row = bucket + (size_t)c * cap;
  const float cl2 = __ldg(consts);
  int count = 0;
  for (int k = 0; k < cap; k += 32) {
    const int slot = k + lane;
    const int u = slot < cap ? row[slot] : n;
    const bool ok = u < n;
    if (ok) {
      const float2 p = pos[u];
      packed[(size_t)c * cap + slot] =
          make_float4(p.x, p.y, vmask[u] ? cl2 * mass[u] : 0.f, 0.f);
    }
    const unsigned b = __ballot_sync(FULL, ok);
    count += __popc(b);
    if (b != FULL) break;           // the rest of the row is sentinel
  }
  if (lane == 0) cnt[c] = count;
}

// One source against a lane's RT rows: the reference's order of operations,
// inv = (C·L²·w)·(1/d²), then f += d·inv.
template <int RT>
__device__ __forceinline__ void pair_terms(const float4 u, const float* tx,
                                           const float* ty, float* fx,
                                           float* fy, float md2) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float dx = tx[i] - u.x, dy = ty[i] - u.y;
    const float inv = u.z * rcp_approx(fmaf(dx, dx, fmaf(dy, dy, md2)));
    fx[i] = fmaf(dx, inv, fx[i]);
    fy[i] = fmaf(dy, inv, fy[i]);
  }
}

// The rows of one cell against the valid slots of its 9 neighbor cells
// (lane j ≤ 8 holds cell c and length len of neighbor j): lanes as (row
// group g, slice q), RT rows a lane, s lanes a row.
template <int RT>
__device__ __forceinline__ void near_rows(
    const int* __restrict__ rows_of, const float4* __restrict__ packed,
    const float4* __restrict__ own, int c, int len, int R, int s, int cap,
    float md2, float2* __restrict__ f_near, int lane) {
  const int groups = 32 / s;
  const int g = lane / s, q = lane % s;
  for (int b = 0; b < R; b += RT * groups) {
    float tx[RT], ty[RT], fx[RT], fy[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int r = b + k * groups + g;
      const float4 t = g < groups && r < R ? own[r]
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      tx[k] = t.x;
      ty[k] = t.y;
      fx[k] = 0.f;
      fy[k] = 0.f;
    }
    const bool act = g < groups && b + g < R;   // the lane's first row
#pragma unroll 1
    for (int j = 0; j < 9; ++j) {
      const float4* row = packed + (size_t)__shfl_sync(FULL, c, j) * cap;
      int lj = __shfl_sync(FULL, len, j);
      if (!act) lj = 0;
#pragma unroll 4
      for (int k = q; k < lj; k += s)
        pair_terms<RT>(__ldg(row + k), tx, ty, fx, fy, md2);
    }
    // join the s slices of a row: lane q adds lane q + d while q + d < s,
    // d from the largest power of two below s down to 1
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      if (d < s) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float x = __shfl_down_sync(FULL, fx[i], d);
          const float y = __shfl_down_sync(FULL, fy[i], d);
          if (q + d < s) {
            fx[i] += x;
            fy[i] += y;
          }
        }
      }
    }
    if (q == 0 && g < groups) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const int r = b + k * groups + g;
        if (r < R) f_near[rows_of[r]] = make_float2(fx[k], fy[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(NEAR_WARPS * 32)
near_kernel(const int* __restrict__ bucket, const int* __restrict__ table,
            const float4* __restrict__ packed, const int* __restrict__ cnt,
            const int* __restrict__ split_of, int nc, int cap,
            const float* __restrict__ consts, float2* __restrict__ f_near) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cell = blockIdx.x * NEAR_WARPS + warp;
  if (cell >= nc) return;
  const int R = cnt[cell];
  if (R == 0) return;               // an empty cell has no rows
  // the 3×3 neighborhood: cell and length of each row, lane j ≤ 8
  int c = nc, len = 0;
  if (lane < 9) {
    c = table[(size_t)cell * 9 + lane];
    len = cnt[c];
  }
  const int split = split_of[R];
  const float md2 = __ldg(consts + 1);
  const int s = split & 0xff;
  const int* rows_of = bucket + (size_t)cell * cap;
  const float4* own = packed + (size_t)cell * cap;
  switch (split >> 8) {
    case 1:
      near_rows<1>(rows_of, packed, own, c, len, R, s, cap, md2, f_near, lane);
      break;
    case 2:
      near_rows<2>(rows_of, packed, own, c, len, R, s, cap, md2, f_near, lane);
      break;
    case 3:
      near_rows<3>(rows_of, packed, own, c, len, R, s, cap, md2, f_near, lane);
      break;
    default:
      near_rows<4>(rows_of, packed, own, c, len, R, s, cap, md2, f_near, lane);
      break;
  }
}

}  // namespace

// pos f32[n, 2] (8-byte aligned), mass f32[n], vmask bool[n];
// bucket int32[(nc + 1) * cap], sentinel n; table int32[(nc + 1) * 9],
// sentinel nc; split int32[cap + 1], (RT << 8) | s for each row count, from
// ops.near_split; consts f32[2] = (C·L², md²); scratch packed
// f32[(nc + 1) * cap, 4] (16-byte aligned)
// and cnt int32[nc + 1]; f_near f32[n, 2] (written whole).
extern "C" int grid_near_launch(const float* pos, const float* mass,
                                const bool* vmask, const int* bucket,
                                const int* table, const int* split, int n,
                                int nc, int cap, const float* consts,
                                float* packed, int* cnt, float* f_near,
                                cudaStream_t stream) {
  auto* pk = reinterpret_cast<float4*>(packed);
  auto* out = reinterpret_cast<float2*>(f_near);
  near_pack_kernel<<<(nc + PACK_WARPS) / PACK_WARPS, PACK_WARPS * 32, 0,
                     stream>>>(reinterpret_cast<const float2*>(pos), mass,
                               vmask, bucket, n, nc, cap, consts, pk, cnt,
                               out);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nc > 0) {
    near_kernel<<<(nc + NEAR_WARPS - 1) / NEAR_WARPS, NEAR_WARPS * 32, 0,
                  stream>>>(bucket, table, pk, cnt, split, nc, cap, consts, out);
  }
  return (int)cudaGetLastError();
}
