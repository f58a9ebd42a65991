// k-hop neighbor-list FR repulsion on Hopper.
//
// Replaces the Pallas kernel kernels/neighbor_force/kernel.py:
// neighbor_repulsion_pallas (body _neighbor_kernel) of the JAX package,
// together with the XLA gather in front of it (neighbor_force/ops.py:25-39):
//
//   f_v = Σ_k C·L²·w_u · (p_v − p_u) / (|p_v − p_u|² + md²),
//   u = nbr_idx[v, k], w_u = mass_u·vmask_u, over slots with nbr_mask set;
//
// a slot's index u is resolved as the JAX package's gather from the
// (n+1)-row padded tables resolves it: a negative u gets n+1 added, then u
// is clamped to [0, n]. Row n is the zero sentinel (the slot adds 0); row 0
// is a real vertex, so an index below -(n+1) reads vertex 0. A row outside
// vmask gets 0.
//
// Bound on the H100: the yardstick is device-memory bytes (per slot a 4 B
// index and a 1 B mask, per valid slot a gathered position, mass and mask
// byte; 11 flops a pair). The real limit is the rate of random gathers: a
// k-hop list names vertices scattered over the whole level, so nearly every
// gather is its own L1 miss, and an SM serves only so many at once. Between
// two calls of a level the lists (16384 × 128 × 5 B at the layout path's
// level 2) stay in the 50 MB L2.
//
// Design: two kernels, one call of the wrapper.
//   1. pack_kernel writes each vertex as float4 (x, y, C·L²·w, 0) to a
//      scratch table, so that a slot costs one 16-byte gather in place of
//      three (position, mass, mask byte), and lets the main kernel start at
//      once (griddepcontrol.launch_dependents).
//   2. neighbor_kernel, launched with programmatic dependent launch, so it
//      loads its lists while the pack runs. A row's slots in groups of 4
//      consecutive slots; R rows a warp and S = 32 / R lanes a row, G groups
//      a lane, picked from K on the host (neighbor_force/ops.py:
//      neighbor_split). A lane
//      * loads its row's vmask and position and the 32-bit words of its
//        groups' 4 mask bytes at once; then, for the groups whose mask word
//        is not 0, their 4 indices as one int4 (the scalar path, for K % 4 ≠
//        0 or unaligned lists, loads the same slots one by one) — the
//        indices of empty groups and of rows outside vmask are never read;
//      * waits for the pack (griddepcontrol.wait), then issues all its
//        gathers before any arithmetic: one float4 per valid slot, valid
//        meaning mask byte set, index resolving to a row below n and row in
//        vmask; an invalid slot's load is predicated off and it adds
//        weight 0. A
//        group that is empty in every lane of the warp (one __ballot_sync)
//        skips its gathers and its arithmetic: k-hop lists fill from slot
//        0, so their tails are such stretches;
//      * takes the weight over d² with the approximate reciprocal
//        (rcp.approx.ftz): d² ≥ md² > 0 and both are normal floats.
//      A row's S partial sums are joined by __shfl_down_sync in a fixed tree
//      order: two calls give the same bits, with no atomics.
//   C·L² (pack) and md² (main, after griddepcontrol.wait) are read from
//   device memory, consts[0] and consts[1], so one captured CUDA graph
//   serves every value of them.
//   Lanes: B independent levels of n rows each (the batched driver's
//   [B, n_pad] groups) in one call, lane b on blockIdx.y = b in both
//   kernels, with its own constants consts[2b], consts[2b + 1]. A lane's
//   indices are local to it (sentinel n) and resolve into its own rows of
//   the packed table, so a lane's result is the bits of the lane alone.
#include <cuda_runtime.h>

namespace {

constexpr int NB_THREADS = 256;
constexpr int PACK_BLOCKS = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(NB_THREADS)
pack_kernel(const float2* __restrict__ pos, const float* __restrict__ mass,
            const unsigned char* __restrict__ vmask, int n,
            const float* __restrict__ consts, float4* __restrict__ packed) {
  asm volatile("griddepcontrol.launch_dependents;");
  const size_t lane0 = (size_t)blockIdx.y * n;     // the lane's first row
  pos += lane0;
  mass += lane0;
  vmask += lane0;
  packed += lane0;
  const float cl2 = __ldg(consts + 2 * blockIdx.y);
  for (int i = blockIdx.x * NB_THREADS + threadIdx.x; i < n;
       i += gridDim.x * NB_THREADS) {
    const float2 p = pos[i];
    packed[i] = make_float4(p.x, p.y, vmask[i] ? cl2 * mass[i] : 0.f, 0.f);
  }
}

// The mask bytes of group g (slots 4g … 4g + 3) as the bytes of one word.
// VEC: one 32-bit load (K % 4 == 0, rows 4-byte aligned); else byte by
// byte, slots past K masked.
template <bool VEC>
__device__ __forceinline__ unsigned load_mask(const unsigned char* mrow,
                                              int g, int K) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned*>(mrow) + g);
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * g + i;
    if (k < K && __ldg(mrow + k)) m |= 1u << (8 * i);
  }
  return m;
}

// The indices of group g. VEC: one int4 load (rows 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ int4 load_idx(const int* row, int g, int K) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(row) + g);
  int s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * g + i;
    s[i] = k < K ? __ldg(row + k) : -1;
  }
  return make_int4(s[0], s[1], s[2], s[3]);
}

__device__ __forceinline__ int slot_of(const int4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// at least 4 blocks an SM, so at most 64 registers a thread: ptxas's own
// choice for G 2 (48) spilled
template <int R, int G, bool VEC>
__global__ void __launch_bounds__(NB_THREADS, 4)
neighbor_kernel(const float2* __restrict__ pos,
                const unsigned char* __restrict__ vmask,
                const float4* packed, const int* __restrict__ nbr_idx,
                const unsigned char* __restrict__ nbr_mask, int n, int K,
                const float* __restrict__ consts, float2* __restrict__ out) {
  constexpr int S = 32 / R;
  const size_t lane0 = (size_t)blockIdx.y * n;     // the lane's first row
  pos += lane0;
  vmask += lane0;
  packed += lane0;
  nbr_idx += lane0 * K;
  nbr_mask += lane0 * K;
  out += lane0;
  consts += 2 * blockIdx.y;
  const int q = threadIdx.x % S;
  const int v = (blockIdx.x * NB_THREADS + threadIdx.x) / S;
  const bool live = v < n;           // the last warp's spare rows
  const int* row = nbr_idx + (size_t)v * K;
  const unsigned char* mrow = nbr_mask + (size_t)v * K;
  const int groups = (K + 3) / 4;
  bool vrow = false;
  float2 p = make_float2(0.f, 0.f);
  if (live) {
    vrow = __ldg(vmask + v) != 0;
    p = __ldg(pos + v);
  }
  float fx = 0.f, fy = 0.f;
  float md2 = 0.f;
  // one pass when G·S groups cover the row (the host table sees to that up
  // to K 256), more for longer lists
  for (int base = 0; base < groups; base += G * S) {
    unsigned m[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = base + j * S + q;
      m[j] = live && g < groups ? load_mask<VEC>(mrow, g, K) : 0u;
    }
    int4 u[G];
    unsigned any = 0u;    // bit j: group j holds a valid slot in some lane
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (!vrow) m[j] = 0u;
      if (__ballot_sync(FULL, m[j] != 0u)) any |= 1u << j;
      u[j] = m[j] != 0u ? load_idx<VEC>(row, base + j * S + q, K)
                        : make_int4(-1, -1, -1, -1);
    }
    // the pack is done and its table visible from here on (a no-op after
    // the first pass)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    md2 = __ldg(consts + 1);
    float4 t[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = slot_of(u[j], i);
        // JAX's gather: wrap a negative index once, then clamp; s + n + 1
        // cannot overflow for s < 0
        const int r = s < 0 ? max(s + n + 1, 0) : s;
        t[j][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if ((any >> j & 1u) && ((m[j] >> (8 * i)) & 0xffu) != 0u && r < n)
          t[j][i] = __ldca(packed + r);
      }
    }
    // the reference's order of operations: inv = (C·L²·w)·(1/d²), then
    // f += d·inv
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (!(any >> j & 1u)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dx = p.x - t[j][i].x, dy = p.y - t[j][i].y;
        const float inv =
            t[j][i].z * rcp_approx(fmaf(dx, dx, fmaf(dy, dy, md2)));
        fx = fmaf(dx, inv, fx);
        fy = fmaf(dy, inv, fy);
      }
    }
  }
#pragma unroll
  for (int d = S / 2; d > 0; d >>= 1) {
    fx += __shfl_down_sync(FULL, fx, d, S);
    fy += __shfl_down_sync(FULL, fy, d, S);
  }
  if (live && q == 0)
    out[v] = vrow ? make_float2(fx, fy) : make_float2(0.f, 0.f);
}

// the main kernel, allowed to start before the pack kernel ahead of it on
// the stream has finished
template <int R, int G>
cudaError_t launch(bool vec, const float2* pos, const unsigned char* vmask,
                   const float4* packed, const int* nbr_idx,
                   const unsigned char* nbr_mask, int n, int K, int lanes,
                   const float* consts, float2* out, cudaStream_t stream) {
  constexpr int rows = NB_THREADS / 32 * R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + rows - 1) / rows, lanes);
  cfg.blockDim = dim3(NB_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return vec ? cudaLaunchKernelEx(&cfg, neighbor_kernel<R, G, true>, pos,
                                  vmask, packed, nbr_idx, nbr_mask, n, K,
                                  consts, out)
             : cudaLaunchKernelEx(&cfg, neighbor_kernel<R, G, false>, pos,
                                  vmask, packed, nbr_idx, nbr_mask, n, K,
                                  consts, out);
}

}  // namespace

// pos f32[lanes, n, 2] (8-byte aligned), mass f32[lanes, n], vmask
// bool[lanes, n]; nbr_idx int32[lanes, n, K], nbr_mask bool[lanes, n, K],
// indices local to their lane; consts f32[lanes, 2] = (C·L², md²) of each
// lane; scratch packed f32[lanes, n, 4] (16-byte aligned); out
// f32[lanes, n, 2] (written whole). (rows, groups) is a pair of
// ops.neighbor_split's table; vec = 1 only for K % 4 == 0 with nbr_idx
// 16-byte and nbr_mask 4-byte aligned (then every lane's rows are too).
// Returns cudaErrorInvalidValue for a pair the table does not hold.
extern "C" int neighbor_repulsion_launch(const float* pos, const float* mass,
                                         const bool* vmask, const int* nbr_idx,
                                         const bool* nbr_mask, int n, int K,
                                         int lanes, int rows, int groups,
                                         int vec, const float* consts,
                                         float* packed, float* out,
                                         cudaStream_t stream) {
  if (n <= 0 || lanes <= 0) return (int)cudaGetLastError();
  auto* p2 = reinterpret_cast<const float2*>(pos);
  auto* vm = reinterpret_cast<const unsigned char*>(vmask);
  auto* nm = reinterpret_cast<const unsigned char*>(nbr_mask);
  auto* pk = reinterpret_cast<float4*>(packed);
  auto* o2 = reinterpret_cast<float2*>(out);
  const int blocks = (n + NB_THREADS - 1) / NB_THREADS;
  const int pack_blocks = blocks < PACK_BLOCKS ? blocks : PACK_BLOCKS;
  pack_kernel<<<dim3(pack_blocks, lanes), NB_THREADS, 0, stream>>>(
      p2, mass, vm, n, consts, pk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define NB_CASE(r, g)                                                      \
  if (rows == r && groups == g)                                            \
    return (int)launch<r, g>(vec != 0, p2, vm, pk, nbr_idx, nm, n, K,      \
                             lanes, consts, o2, stream);
  NB_CASE(4, 1) NB_CASE(2, 1) NB_CASE(1, 1) NB_CASE(1, 2)
#undef NB_CASE
  return (int)cudaErrorInvalidValue;
}
