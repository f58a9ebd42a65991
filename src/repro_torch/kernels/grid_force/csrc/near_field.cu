// Near field of the grid repulsion a row at a time, on Hopper: each row is
// one vertex, against the bucket slots of its 3×3 cell neighborhood — the
// form in which the sharded grid step (core/distributed.py) calls the near
// field, one row per local vertex, the 9·cap slots split over "model".
//
// Replaces the Pallas kernel kernels/grid_force/kernel.py:grid_near_pallas
// (body _near_kernel) of the JAX package at cap = 1, as
// core/distributed.py:_grid_rep_spmd (lines 330-354) calls it through
// ops.near_field:
//
//   f_r = Σ_s (C·L²·w_s) · (p_r − p_s) / (|p_r − p_s|² + md²)
//
// over the slots s in columns [col0, col1) of row r's 9·cap slots (cell t
// of near9[r] gives columns t·cap .. t·cap + cap − 1); empty slots (w = 0),
// cells outside [0, ncell) and columns past 9·cap add nothing.
//
// Two forms of the slot table, as the two variants of the sharded step
// hold it:
//   * index (all-gather variant): slots int32[ncell, cap] of indices into a
//     replicated table pos f32[ntab, 2], w f32[ntab] (the sentinel row has
//     w = 0);
//   * direct (halo variant): xyw f32[ncell, cap, 3] = (x, y, w) of each slot
//     (the band's cells and the two received halo rows).
//
// Bound on the H100: 11 flops a pair at the 67 TFLOP/s fp32 peak, or the
// real ceiling, one reciprocal a pair on the MUFU pipe (16 lanes a clock
// per SM), against the bytes of the rows, near9, the slot table and the
// replicated table read once. At the 1M sharded path's level 0 (2^20 rows,
// G 128, cap 120, ~61 rows a cell on average) the pairs, 8.4e8, bound it:
// 0.138 ms at the fp32 peak, 0.201 ms on the MUFU pipe.
//
// What a row-at-a-time kernel has to overcome: a row reads 9·cap slots
// (1080 at level 0), and in the index form each slot is an index, then a
// weight and a position gathered at random from the replicated table; the
// ~61 rows of one cell repeat those gathers, ~1.1e9 slots a call. The rows
// of one cell share all 9 neighbor cells, as the per-cell grid_near.cu
// exploits, but here they arrive in partition order. So:
//
//   0. Grouping, a counting sort of the rows by their centre cell
//      near9[:, 4] (a centre outside [0, ncell) keyed ncell, one last
//      group), in three small kernels: nf_count_kernel (each row's key and
//      its rank in its group, one atomic a key a warp), nf_scan_kernel (one
//      block: each group's start) and nf_scatter_kernel (each row to its
//      group's start + rank). The order of the rows within a group comes
//      from the atomics and changes from call to call; no result depends on
//      it (below). Every shape is fixed by R and ncell and nothing is read
//      back to the host, so the op stays capturable. ops.group_rows is its
//      plain version: a torch.sort and a searchsorted, which take 0.138 ms
//      at level 0 and 0.064 ms at level 1 (chip_smoke.py phase 9a,
//      `plain_grouping_ms`; NVIDIA H100 80GB HBM3, 700.00 W).
//   1. nf_pack_kernel, a warp a cell of the slot table: each slot once as
//      float4 (x, y, C·L²·w, 0) at its own slot position (an empty slot
//      (0, 0, 0, 0), which adds exactly 0), and each cell's length, its
//      last non-empty slot + 1, found by ballots. The slot positions are
//      kept, so column t·cap + j still means slot j of cell t and a "model"
//      chunk stays exact; both call sites fill cells from slot 0, so the
//      length skips every empty slot there. The gathers of the index form
//      happen here, ~2e6 slots at level 0 in place of ~1.1e9.
//   2. nf_near_kernel, a warp a segment of at most `chunk` (128) rows of
//      one group, NF_WARPS a block, no barrier, no atomics. Warp w ≤ ncell
//      takes the first chunk of group w (consecutive cells: their warps
//      share 6 of 9 neighbor rows in L1); each warp after them takes the
//      chunks j ≥ 1 (rows gs + j·chunk onward) of the groups whose chunk j
//      starts in its `chunk` sorted positions: an overflowing cell (its
//      rows past cap, which the sharded step computes and then masks, make
//      the 1M path's level 0 8.4e8 pairs against grid_near's 5.9e8) and
//      the padding rows' group. Within a segment:
//      * lanes 0–8 read the 9 cells of its first row and their columns
//        [lo, hi): the packed length clipped to [col0, col1); shuffles hand
//        them to the warp;
//      * the lanes split as grid_near.cu's do, RT rows a lane and s lanes a
//        row: (RT, s) from ops.near_split_table at the group's size, and
//        for a group of more than `chunk` rows s = BIG_S with RT from the
//        segment's rows; each lane sums the slots lo + q, lo + q + s, … of
//        each neighbor row in order, through L1, and the s partial sums of
//        a row are joined by __shfl_down_sync in a fixed tree;
//      * a row whose near9 differs from the segment's first row (flagged by
//        ballots; the call sites have none, the card tests feed random
//        near9) is summed afterwards against its own 9 cells by the same
//        s, the same order of terms and the same tree.
//      A row's sum depends on its own inputs and on s, and s on its group's
//      size alone, not on RT, the segment or which row leads it: its bits
//      repeat call to call and under any permutation of the rows.
//   The weight over d² takes the approximate reciprocal (rcp.approx.ftz:
//   d² ≥ md² > 0), as the other force kernels do. C·L² (pack) and md²
//   (near) are read from device memory (consts[0], consts[1]).
//
// Measured (chip_smoke.py phase 9a, the whole op as one graph replay on
// the 1M sharded path's first call at each grid level; NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6 rows 3e–3h):
//   * level 0 (2^20 rows, G 128, cap 120): 0.702 ms in the index form,
//     0.699 ms in the direct form (the one-warp-a-row kernel before it:
//     12.9 and 2.66 ms): grouping 0.088, pack 0.026, near kernel 0.584.
//     The per-cell grid_near takes 0.414 ms on the same positions for the
//     ~5.9e8 pairs of the bucketed rows; this op also computes the
//     overflow rows, 8.4e8 pairs, at the same rate a pair.
//   * level 1 (131072 rows, G 105, cap 48): 0.0775 ms index, 0.0831 ms
//     direct (before: 0.395 and 0.144); grid_near 0.0457 ms.
#include <cuda_runtime.h>

namespace {

constexpr int PACK_WARPS = 8;       // cells a block of nf_pack_kernel
constexpr int NF_WARPS = 4;         // segments a block of nf_near_kernel
constexpr int GROUP_THREADS = 256;  // rows a block of the grouping kernels
constexpr int MAX_RT = 4;           // rows a lane at most (ops.NEAR_MAX_RT)
// lanes a row in a group of more rows than a warp takes (`chunk`): a full
// chunk costs a lane the same pair terms at s = 1, 2 or 4 (RT 4), and its
// last, partial chunk leaves fewer lanes idle the larger s is
constexpr int BIG_S = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <bool INDEX>
__global__ void __launch_bounds__(PACK_WARPS * 32)
nf_pack_kernel(const int* __restrict__ slots, const float* __restrict__ xyw,
               int ncell, int cap, const float2* __restrict__ pos,
               const float* __restrict__ w, int ntab,
               const float* __restrict__ consts, float4* __restrict__ packed,
               int* __restrict__ len) {
  const int c = blockIdx.x * PACK_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= ncell) return;
  const float cl2 = __ldg(consts);
  int last = -1;
  for (int k = 0; k < cap; k += 32) {
    const int j = k + lane;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    bool ok = false;
    if (j < cap) {
      const size_t e = (size_t)c * cap + j;
      if (INDEX) {
        const int s = __ldg(slots + e);
        if (s >= 0 && s < ntab) {
          const float m = __ldg(w + s);
          if (m != 0.f) {
            const float2 p = __ldg(pos + s);
            v = make_float4(p.x, p.y, cl2 * m, 0.f);
            ok = true;
          }
        }
      } else {
        const float m = __ldg(xyw + 3 * e + 2);
        if (m != 0.f) {
          v = make_float4(__ldg(xyw + 3 * e), __ldg(xyw + 3 * e + 1),
                          cl2 * m, 0.f);
          ok = true;
        }
      }
      packed[e] = v;
    }
    const unsigned b = __ballot_sync(FULL, ok);
    if (b) last = k + 31 - __clz(b);
  }
  if (lane == 0) len[c] = last + 1;
}

// Grouping 1: each row's key, its centre cell near9[r][4] (ncell for a
// centre outside [0, ncell)), and its rank among its group's rows: one
// atomic a key a warp (lanes of equal key found by __match_any_sync), so
// the padding rows, contiguous and all of one key, cost one atomic a warp.
__global__ void __launch_bounds__(GROUP_THREADS)
nf_count_kernel(const int* __restrict__ near9, int R, int ncell,
                int* __restrict__ cnt, int* __restrict__ key,
                int* __restrict__ rank) {
  const int r = blockIdx.x * GROUP_THREADS + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const unsigned live = __ballot_sync(FULL, r < R);
  if (r >= R) return;
  int k = __ldg(near9 + (size_t)r * 9 + 4);
  if (k < 0 || k >= ncell) k = ncell;
  const unsigned peers = __match_any_sync(live, k);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt + k, __popc(peers));
  base = __shfl_sync(live, base, leader);
  key[r] = k;
  rank[r] = base + __popc(peers & ((1u << lane) - 1u));
}

// Grouping 2, one block: starts[g] = Σ cnt[0 .. g − 1] for g = 0 .. n.
__global__ void __launch_bounds__(1024)
nf_scan_kernel(const int* __restrict__ cnt, int n, int* __restrict__ starts) {
  __shared__ int warp_sum[32];
  const int t = threadIdx.x, lane = t % 32, wp = t / 32;
  const int per = (n + 1023) / 1024;
  const int a = min(t * per, n), b = min(a + per, n);
  int own = 0;
  for (int i = a; i < b; ++i) own += cnt[i];
  int x = own;                                  // inclusive, in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wp] = x;
  __syncthreads();
  if (wp == 0) {
    int v = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  int run = x - own + (wp > 0 ? warp_sum[wp - 1] : 0);
  for (int i = a; i < b; ++i) {
    starts[i] = run;
    run += cnt[i];
  }
  if (t == 1023) starts[n] = run;              // every row
}

// Grouping 3: each row to its sorted position, starts[key] + rank.
__global__ void __launch_bounds__(GROUP_THREADS)
nf_scatter_kernel(int R, const int* __restrict__ key,
                  const int* __restrict__ rank,
                  const int* __restrict__ starts, int* __restrict__ order,
                  int* __restrict__ sk) {
  const int r = blockIdx.x * GROUP_THREADS + threadIdx.x;
  if (r >= R) return;
  const int k = key[r];
  const int p = starts[k] + rank[r];
  order[p] = r;
  sk[p] = k;
}

struct NearArgs {
  const float2* rows;
  const int* near9;
  const int* order;         // rows grouped by centre cell
  const int* sk;            // their keys
  const int* starts;        // int32[ncell + 2]: group g's first sorted row
  const float4* packed;
  const int* len;
  const int* split;         // (RT << 8) | s for 0..chunk rows
  const float* consts;
  float2* out;
  int R, ncell, cap, col0, col1, chunk;
};

// Columns [x, y) of neighbor t's cell c that count: its packed length,
// clipped to the call's columns [col0, col1); none for a cell outside
// [0, ncell).
__device__ __forceinline__ int2 span_of(const NearArgs& a, int c, int t) {
  if (c < 0 || c >= a.ncell) return make_int2(0, 0);
  return make_int2(max(a.col0 - t * a.cap, 0),
                   min(min(a.col1 - t * a.cap, a.cap), __ldg(a.len + c)));
}

// One source against a lane's RT rows: inv = (C·L²·w)·(1/d²), f += d·inv.
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

// Join the s slices of each row: lane q adds lane q + d while q + d < s,
// d from the largest power of two below s down to 1.
template <int RT>
__device__ __forceinline__ void join(float* fx, float* fy, int s, int q) {
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
}

// Sorted rows [b0, b0 + nrows) against the leader's 9 cells (lane j ≤ 8
// holds neighbor j's cell c and columns [lo, hi)): RT rows a lane, s lanes a
// row. The rows flagged in devm (lane k: rows 32k .. 32k + 31) are not
// written here.
template <int RT>
__device__ __forceinline__ void shared_rows(const NearArgs& a, int b0,
                                            int nrows, int c, int lo, int hi,
                                            unsigned devm, int s, float md2,
                                            int lane) {
  const int groups = 32 / s, g = lane / s, q = lane % s;
  for (int b = 0; b < nrows; b += RT * groups) {
    float tx[RT], ty[RT], fx[RT], fy[RT];
    int r[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int i = b + k * groups + g;
      r[k] = g < groups && i < nrows ? __ldg(a.order + b0 + i) : -1;
      const float2 p = r[k] >= 0 ? __ldg(a.rows + r[k])
                                 : make_float2(0.f, 0.f);
      tx[k] = p.x;
      ty[k] = p.y;
      fx[k] = 0.f;
      fy[k] = 0.f;
    }
    const bool act = r[0] >= 0;               // the lane's first row
#pragma unroll 1
    for (int j = 0; j < 9; ++j) {
      const float4* row = a.packed + (size_t)__shfl_sync(FULL, c, j) * a.cap;
      const int lj = __shfl_sync(FULL, lo, j);
      int hj = __shfl_sync(FULL, hi, j);
      if (!act) hj = lj;
#pragma unroll 4
      for (int k = lj + q; k < hj; k += s)
        pair_terms<RT>(__ldg(row + k), tx, ty, fx, fy, md2);
    }
    join<RT>(fx, fy, s, q);
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int i = b + k * groups + g;
      const unsigned m = __shfl_sync(FULL, devm, (i >> 5) & 31);
      if (q == 0 && r[k] >= 0 && !((m >> (i & 31)) & 1u))
        a.out[r[k]] = make_float2(fx[k], fy[k]);
    }
  }
}

// The rows flagged in devm, each against its own 9 cells read from near9,
// with shared_rows' split, order of terms and tree: a row's bits do not
// depend on which of the two took it.
__device__ __forceinline__ void alone_rows(const NearArgs& a, int b0,
                                           int nrows, unsigned devm, int s,
                                           float md2, int lane) {
  const int groups = 32 / s, g = lane / s, q = lane % s;
  for (int kk = 0; kk * 32 < nrows; ++kk) {
    unsigned m = __shfl_sync(FULL, devm, kk);
    while (m) {
      // row group g takes the g-th flagged row left
      unsigned mine = g < groups ? m : 0u;
      for (int t = 0; t < g && mine; ++t) mine &= mine - 1;
      for (int t = 0; t < groups && m; ++t) m &= m - 1;
      const int r =
          mine ? __ldg(a.order + b0 + kk * 32 + __ffs(mine) - 1) : -1;
      float tx = 0.f, ty = 0.f, fx = 0.f, fy = 0.f;
      if (r >= 0) {
        const float2 p = __ldg(a.rows + r);
        tx = p.x;
        ty = p.y;
      }
#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        int c = 0;
        int2 sp = make_int2(0, 0);
        if (r >= 0) {
          c = __ldg(a.near9 + (size_t)r * 9 + t);
          sp = span_of(a, c, t);
        }
        for (int k = sp.x + q; k < sp.y; k += s)
          pair_terms<1>(__ldg(a.packed + (size_t)c * a.cap + k), &tx, &ty,
                        &fx, &fy, md2);
      }
      join<1>(&fx, &fy, s, q);
      if (q == 0 && r >= 0) a.out[r] = make_float2(fx, fy);
    }
  }
}

// Sorted rows [b0, b1) of a group of `size` rows. The lanes a row, s,
// follow the group alone, so that a row's bits do; the rows a lane, RT,
// only the segment.
__device__ __forceinline__ void segment(const NearArgs& a, int b0, int b1,
                                        int size, float md2, int lane) {
  const int nrows = b1 - b0;
  int s, rt;
  if (size <= a.chunk) {
    const int split = __ldg(a.split + size);
    s = split & 0xff;
    rt = split >> 8;
  } else {
    s = BIG_S;
    rt = min(MAX_RT, (nrows + 32 / s - 1) / (32 / s));
  }
  const int lead = __ldg(a.order + b0);
  int raw = 0, c = 0, lo = 0, hi = 0;
  if (lane < 9) {
    raw = __ldg(a.near9 + (size_t)lead * 9 + lane);
    const int2 sp = span_of(a, raw, lane);
    if (sp.x < sp.y) {
      c = raw;
      lo = sp.x;
      hi = sp.y;
    }
  }
  int lead9[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) lead9[t] = __shfl_sync(FULL, raw, t);
  unsigned devm = 0;
  for (int kk = 0; kk * 32 < nrows; ++kk) {
    const int i = kk * 32 + lane;
    bool dev = false;
    if (i < nrows) {
      const int* n9 = a.near9 + (size_t)__ldg(a.order + b0 + i) * 9;
#pragma unroll
      for (int t = 0; t < 9; ++t) dev |= __ldg(n9 + t) != lead9[t];
    }
    const unsigned bal = __ballot_sync(FULL, dev);
    if (lane == kk) devm = bal;
  }
  switch (rt) {
    case 1:
      shared_rows<1>(a, b0, nrows, c, lo, hi, devm, s, md2, lane);
      break;
    case 2:
      shared_rows<2>(a, b0, nrows, c, lo, hi, devm, s, md2, lane);
      break;
    case 3:
      shared_rows<3>(a, b0, nrows, c, lo, hi, devm, s, md2, lane);
      break;
    default:
      shared_rows<4>(a, b0, nrows, c, lo, hi, devm, s, md2, lane);
      break;
  }
  if (__any_sync(FULL, devm != 0u))
    alone_rows(a, b0, nrows, devm, s, md2, lane);
}

__global__ void __launch_bounds__(NF_WARPS * 32)
nf_near_kernel(const NearArgs a) {
  const int lane = threadIdx.x % 32;
  const int wid = blockIdx.x * NF_WARPS + threadIdx.x / 32;
  const float md2 = __ldg(a.consts + 1);
  if (wid <= a.ncell) {                   // the first `chunk` rows of group wid
    const int gs = __ldg(a.starts + wid), ge = __ldg(a.starts + wid + 1);
    if (gs < ge) segment(a, gs, min(ge, gs + a.chunk), ge - gs, md2, lane);
    return;
  }
  // chunk j ≥ 1, rows gs + j·chunk onward, of each group whose chunk j
  // starts in the sorted positions [p0, p1)
  const int p0 = (wid - a.ncell - 1) * a.chunk;
  const int p1 = min(p0 + a.chunk, a.R);
  for (int p = p0; p < p1;) {
    const int key = __ldg(a.sk + p);
    const int gs = __ldg(a.starts + key), ge = __ldg(a.starts + key + 1);
    const int b = gs + max(1, (p0 - gs + a.chunk - 1) / a.chunk) * a.chunk;
    if (b < p1 && b < ge)
      segment(a, b, min(b + a.chunk, ge), ge - gs, md2, lane);
    p = min(ge, p1);
  }
}

}  // namespace

// rows f32[R, 2] and out f32[R, 2] (8-byte aligned), near9 int32[R, 9];
// index form (pos != nullptr): cells = slots int32[ncell, cap], pos
// f32[ntab, 2] (8-byte aligned), w f32[ntab]; direct form (pos == nullptr):
// cells = xyw f32[ncell, cap, 3]. Columns [col0, col0 + ncols) of each
// row's 9·cap slots; consts f32[2] = (C·L², md²); split int32[chunk + 1]
// (ops.near_split_table). Scratch: packed f32[ncell, cap, 4] (16-byte
// aligned) and work int32[4·R + 3·ncell + 3] (cnt, starts, len, key, rank,
// order, sk).
extern "C" int near_field_launch(const float* rows, const int* near9, int R,
                                 const void* cells, int ncell, int cap,
                                 const float* pos, const float* w, int ntab,
                                 int col0, int ncols, const float* consts,
                                 const int* split, int chunk, float* packed,
                                 int* work, float* out, cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  int* cnt = work;                  // [ncell + 1]
  int* starts = cnt + ncell + 1;    // [ncell + 2]
  int* len = starts + ncell + 2;    // [ncell]
  int* key = len + ncell;           // [R] each, from here
  int* rank = key + R;
  int* order = rank + R;
  int* sk = order + R;
  cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int) * (ncell + 1), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned row_blocks = (unsigned)((R + GROUP_THREADS - 1) / GROUP_THREADS);
  nf_count_kernel<<<row_blocks, GROUP_THREADS, 0, stream>>>(near9, R, ncell,
                                                            cnt, key, rank);
  nf_scan_kernel<<<1, 1024, 0, stream>>>(cnt, ncell + 1, starts);
  nf_scatter_kernel<<<row_blocks, GROUP_THREADS, 0, stream>>>(
      R, key, rank, starts, order, sk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto* pk = reinterpret_cast<float4*>(packed);
  if (ncell > 0) {
    const unsigned blocks = (unsigned)((ncell + PACK_WARPS - 1) / PACK_WARPS);
    if (pos != nullptr)
      nf_pack_kernel<true><<<blocks, PACK_WARPS * 32, 0, stream>>>(
          static_cast<const int*>(cells), nullptr, ncell, cap,
          reinterpret_cast<const float2*>(pos), w, ntab, consts, pk, len);
    else
      nf_pack_kernel<false><<<blocks, PACK_WARPS * 32, 0, stream>>>(
          nullptr, static_cast<const float*>(cells), ncell, cap, nullptr,
          nullptr, 0, consts, pk, len);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  NearArgs a;
  a.rows = reinterpret_cast<const float2*>(rows);
  a.near9 = near9;
  a.order = order;
  a.sk = sk;
  a.starts = starts;
  a.packed = pk;
  a.len = len;
  a.split = split;
  a.consts = consts;
  a.out = reinterpret_cast<float2*>(out);
  a.R = R;
  a.ncell = ncell;
  a.cap = cap;
  a.col0 = col0;
  const long long col1 = (long long)col0 + ncols;
  a.col1 = (int)(col1 < 9LL * cap ? col1 : 9LL * cap);
  a.chunk = chunk;
  const long long warps = ncell + 1LL + (R + chunk - 1) / chunk;
  nf_near_kernel<<<(unsigned)((warps + NF_WARPS - 1) / NF_WARPS),
                   NF_WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
