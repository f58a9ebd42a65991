// Attention forward (streaming softmax) on Hopper, bf16 in and out.
//
// Replaces the Pallas kernel kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel) of the JAX package, together
// with the transpose and jnp.repeat of its GQA wrapper (ops.py:32-35): for
// q [B,Sq,H,hd] and k/v [B,Sk,KV,hd], query head h reads KV head h / (H/KV)
// in place,
//
//   out[b,i,h] = Σ_j softmax_j(q[b,i,h]·k[b,j,h/G] · hd^-½) v[b,j,h/G],
//
// with scores and softmax in float32, p rounded to bf16 for the p·v product,
// and, when causal, the mask aligned bottom-right: row i sits at absolute
// position Sk − Sq + i and sees keys 0 … Sk − Sq + i. A row that sees no key
// is written 0. Any Sq and Sk work; hd is 64 or 128. The k/v batch strides
// are arguments, so cache[:, :kv_len] is read where it lies.
//
// The G = H/KV query heads that share a KV head are packed into the rows of
// one tile (row r = position r / G, head r % G), so each K/V tile is read
// once for all of them. Two routes, picked by the wrapper (ops.py) from the
// shapes alone:
//
// 1. wgmma (prefill, chunked prefill): bound by the tensor cores — 4·hd
//    flops per visible (query, key) pair against ~100 MB of q, k, v and out
//    at the LM path's prefill. A persistent grid, one block an SM, walks
//    query tiles of 128 packed rows of one (batch, KV head), the heaviest
//    causal tiles first. A block is three warpgroups: a producer whose
//    single thread keeps K/V tiles of FA_BK keys in flight by TMA (128-byte
//    swizzle) into a ring of FA_STAGES shared-memory stages, with
//    full/empty mbarriers, running on across query tiles; and two consumer
//    warpgroups of 64 rows each, which load the q rows of their next tile
//    while they work on this one. setmaxnreg moves registers from the
//    producer to the consumers. S = Q·Kᵀ is wgmma with Q and K from shared
//    memory (both K-major); O += P·V is wgmma with P as the register operand
//    (the S accumulators, rounded to bf16) and V from shared memory
//    (MN-major). The P·V of a tile is issued with the S of the next, and the
//    two warpgroups take turns to issue (ping-pong), so that one's softmax
//    runs while the other's products keep the tensor cores busy. Only tiles
//    that cross the causal diagonal or the ragged end of the keys are
//    masked. The output tile goes through shared memory and leaves in
//    coalesced 16-byte stores.
// 2. split-KV (decode; flash-decoding): bound by bytes — a decode step reads
//    the whole cache for a few flops a byte. Sq·G ≤ 64 rows use at most 4
//    tiles of 16, so the keys of each (batch, KV head) are split into chunks
//    of 64 or 128 keys (ops.split_plan), one block each, to put hundreds of
//    blocks on the 132 SMs. A block loads its chunk once with cp.async
//    (16-byte copies), computes S and P·V with mma.sync (the four warps
//    split the keys for S and the head dim for P·V, the chunk's softmax
//    shared through shared memory), and writes its unnormalised float32 o
//    with the chunk's max and sum to a scratch buffer. The last block of each
//    (batch, KV head) to finish, found by an atomic ticket, merges the
//    chunks by the log-sum-exp rule and writes bf16.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run
                   // time through cudaGetDriverEntryPoint, so no -lcuda
#include <math.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Route 1: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int FA_BK = 128;      // keys per K/V tile
constexpr int FA_STAGES = 2;    // K/V tiles in flight
constexpr int FA_CONSUMERS = 2; // consumer warpgroups, 64 rows each
constexpr int FA_ROWS = 64 * FA_CONSUMERS;
constexpr int FA_THREADS = 128 * (FA_CONSUMERS + 1);

// Shared memory, every tile 1024-byte aligned (128-byte swizzle atoms). A
// tile with hd 128 is two 64-column halves, each its own [rows][64] block.
// q is double-buffered: a warpgroup's rows of its next query tile load
// while it works on this one, and the buffer of a finished tile stages its
// output. K and V stages are filled and freed apart: a
// K tile is free once its S is computed, a V tile only after the P·V one
// tile later.
template <int HD>
struct FaSmem {
  static constexpr int HALVES = HD / 64;
  bf16 q[2][FA_CONSUMERS][HALVES][64 * 64];
  bf16 k[FA_STAGES][HALVES][FA_BK * 64];
  bf16 v[FA_STAGES][HALVES][FA_BK * 64];
  uint64_t full_k[FA_STAGES], full_v[FA_STAGES];
  uint64_t empty_k[FA_STAGES], empty_v[FA_STAGES];
};

template <int HD>
constexpr int fa_smem_bytes() { return (int)sizeof(FaSmem<HD>) + 1024; }

// named barriers: 1, 2 — a consumer warpgroup's own; 3, 4 — the turn of
// consumer 0, 1 to issue its matrix products (ping-pong)
constexpr int BAR_WG = 1, BAR_TURN = 3;

// The work: one query tile of FA_ROWS packed rows of one (batch, KV head).
// Item w is query tile n_qt − 1 − w / (B·KV), so the heaviest causal tiles
// come first; the blocks (one per SM) take the items in rounds of
// gridDim.x, every other round in reverse order, which evens out the work.
struct FaWork {
  int items, n_qt, BKV;
  __device__ int item(int round) const {
    const int i = (round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int w = round * gridDim.x + i;
    return w < items ? w : -1;
  }
  __device__ int rounds() const { return (items + gridDim.x - 1) / gridDim.x; }
};

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const bf16* __restrict__ q, bf16* __restrict__ out, int B,
                int Sq, int Sk, int H, int KV, float scale_log2, int causal) {
  using namespace fa;
  constexpr int HALVES = HD / 64;
  constexpr int TILE_BYTES = FA_BK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  FaSmem<HD>& sm = *reinterpret_cast<FaSmem<HD>*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));

  const int G = H / KV;
  const int rows = Sq * G;                 // packed (position, head) rows
  const int shift = Sk - Sq;               // bottom-right causal alignment
  const FaWork work{B * KV * ((rows + FA_ROWS - 1) / FA_ROWS),
                    (rows + FA_ROWS - 1) / FA_ROWS, B * KV};
  // first packed row of item w, and the K/V tiles it reads
  auto row0 = [&](int w) { return (work.n_qt - 1 - w / work.BKV) * FA_ROWS; };
  auto tiles = [&](int w) {
    const int n = (Sk + FA_BK - 1) / FA_BK;
    if (!causal) return n;
    const int maxq = (min(row0(w) + FA_ROWS, rows) - 1) / G + shift;
    return maxq < 0 ? 0 : min(n, maxq / FA_BK + 1);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(smem_addr(&sm.full_k[s]), 1);
      mbar_init(smem_addr(&sm.full_v[s]), 1);
      mbar_init(smem_addr(&sm.empty_k[s]), 4 * FA_CONSUMERS);  // per warp
      mbar_init(smem_addr(&sm.empty_v[s]), 4 * FA_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == FA_CONSUMERS) {
    // ---- producer: one thread issues every TMA load, across items ----
    regs_dealloc<40>();
    if (tid == 128 * FA_CONSUMERS) {
      int it = 0;                          // K/V tiles so far, all items
      for (int round = 0; round < work.rounds(); ++round) {
        const int w = work.item(round);
        if (w < 0) continue;
        const int bkv = w % work.BKV, kvh = bkv % KV, b = bkv / KV;
        const int n_tiles = tiles(w);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int stage = it % FA_STAGES;
          const int phase = (it / FA_STAGES) & 1;
          const uint32_t fk = smem_addr(&sm.full_k[stage]);
          mbar_wait(smem_addr(&sm.empty_k[stage]), phase ^ 1);
          mbar_expect_tx(fk, TILE_BYTES);
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            tma_load_4d(smem_addr(sm.k[stage][h]), &kmap, h * 64, kvh,
                        t * FA_BK, b, fk);
          const uint32_t fv = smem_addr(&sm.full_v[stage]);
          mbar_wait(smem_addr(&sm.empty_v[stage]), phase ^ 1);
          mbar_expect_tx(fv, TILE_BYTES);
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            tma_load_4d(smem_addr(sm.v[stage][h]), &vmap, h * 64, kvh,
                        t * FA_BK, b, fv);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: rows 64·wg … + 63 of each query tile ----
    regs_alloc<232>();
    const int t128 = tid % 128, warp = t128 / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;

    // This thread's 16-byte chunk of a row, and the rows of a 64-row tile
    // it visits (every STEP-th): `visit` gets each row and the offset of
    // its first element in q/out [B, Sq, H, hd], or −1 past the last row.
    // Position and head of a packed row follow by one division, then
    // incrementally.
    constexpr int CPR = HD / 8, STEP = 128 / CPR;
    const int chunk = t128 % CPR;
    const int step_p = STEP / G, step_g = STEP % G;
    auto for_rows = [&](int w, auto&& visit) {
      const int bkv = w % work.BKV, kvh = bkv % KV, b = bkv / KV;
      int r = row0(w) + 64 * wg + t128 / CPR;
      int p = r / G, gg = r - p * G;
      for (int row = t128 / CPR; row < 64; row += STEP, r += STEP) {
        visit(row, r < rows
                       ? (((long long)b * Sq + p) * H + kvh * G + gg) * HD
                       : -1ll);
        p += step_p;
        gg += step_g;
        if (gg >= G) { gg -= G; ++p; }
      }
    };
    // the item's 64 q rows of this warpgroup → q buffer `buf`, 128-byte
    // swizzled as TMA would write them (one cp.async group)
    auto load_q = [&](int w, int buf) {
      for_rows(w, [&](int row, long long off) {
        cp_async16(smem_addr(sm.q[buf][wg][chunk / 8]) + row * 128 +
                       (((chunk % 8) ^ (row % 8)) * 16),
                   q + (off < 0 ? 0 : off + chunk * 8), off >= 0);
      });
      cp_async_commit();
    };

    float o[HD / 2];
    float m[2], l[2];
    float s[FA_BK / 2];
    uint32_t p[FA_BK / 16][4];   // P of the tile whose P·V is pending
    int qpos[2], wg_minq = 0, qbuf = 0;

    // a stage is free once every consumer warp says so
    auto free_stage = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(bar));
    };
    // S = Q·Kᵀ of one tile (one wgmma group)
    auto issue_s = [&](int stage) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s,
                 desc_sw128(smem_addr(sm.q[qbuf][wg][kk / 4]) + (kk % 4) * 32,
                            16),
                 desc_sw128(smem_addr(sm.k[stage][kk / 4]) + (kk % 4) * 32, 16),
                 kk > 0);
      wgmma_commit();
    };
    // O += P·V of the pending tile (one wgmma group)
    auto issue_pv = [&](int stage, int phase) {
      mbar_wait(smem_addr(&sm.full_v[stage]), phase);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk)
        wgmma_rs(o, p[kk], desc_sw128(smem_addr(sm.v[stage][0]) +
                                          kk * 16 * 128, FA_BK * 128));
      wgmma_commit();
    };
    // mask, running max and p = 2^(s·scale − max) in place; returns the
    // factor that rescales O and l. A tile above every row of this
    // warpgroup (or rows past the end) is computed and masked like any
    // other, so that every wgmma is issued and awaited on one path.
    auto softmax = [&](int k0, float (&corr)[2]) {
      if (k0 + FA_BK > Sk || (causal && k0 + FA_BK - 1 > wg_minq)) {
        // the last key each row sees, relative to this thread's column
        int last[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          last[i] = (causal ? min(qpos[i], Sk - 1) : Sk - 1) - k0 - 2 * t4;
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + (e & 1) > last[e >> 1]) s[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
        corr[i] = ex2(m[i] * scale_log2 - base);   // 0 while m is -inf
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) {
          s[4 * j + 2 * i] = ex2(fmaf(s[4 * j + 2 * i], scale_log2, -base));
          s[4 * j + 2 * i + 1] =
              ex2(fmaf(s[4 * j + 2 * i + 1], scale_log2, -base));
          sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
        }
        l[i] = l[i] * corr[i] + sum;
      }
    };
    // O *= corr, then the tile's p → bf16 A fragments of the next P·V
    auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < FA_BK / 8; ++j) {
        p[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[4 * j], s[4 * j + 1]);
        p[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };

    int it = 0;                            // K/V tiles so far, all items
    if (work.item(0) >= 0) load_q(work.item(0), 0);
    for (int round = 0; round < work.rounds(); ++round) {
      const int w = work.item(round);
      if (w < 0) continue;
      const int wg_r0 = row0(w) + 64 * wg;
      const int n_tiles = tiles(w);
      // this item's q has landed; the next item's loads behind it
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(BAR_WG + wg, 128);
      if (work.item(round + 1) >= 0) load_q(work.item(round + 1), qbuf ^ 1);

      // this thread's two rows (g and g + 8 of its warp's 16)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wg_r0 + 16 * warp + g + 8 * i;
        qpos[i] = (r < rows ? r / G : 0) + shift;
      }
      wg_minq = wg_r0 / G + shift;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      // Ping-pong: each warpgroup issues its products (S of this tile, P·V
      // of the last) in its turn, hands the turn over, and runs its softmax
      // while the other's products keep the tensor cores busy. The first
      // tile has no P·V before it.
      if (wg == 1) named_arrive(BAR_TURN, 256);   // consumer 0 goes first
      if (n_tiles > 0) {
        const int stage = it % FA_STAGES, phase = (it / FA_STAGES) & 1;
        mbar_wait(smem_addr(&sm.full_k[stage]), phase);
        named_sync(BAR_TURN + wg, 256);
        issue_s(stage);
        named_arrive(BAR_TURN + 1 - wg, 256);
        wgmma_wait<0>();
        reg_fence(s);
        free_stage(&sm.empty_k[stage]);
        float corr[2];
        softmax(0, corr);
        rescale_and_pack(corr);
      }
      for (int t = 1; t < n_tiles; ++t) {
        const int cur = it + t, prev = it + t - 1;
        const int stage = cur % FA_STAGES, phase = (cur / FA_STAGES) & 1;
        const int pstage = prev % FA_STAGES;
        const int pphase = (prev / FA_STAGES) & 1;
        mbar_wait(smem_addr(&sm.full_k[stage]), phase);
        named_sync(BAR_TURN + wg, 256);
        issue_s(stage);
        issue_pv(pstage, pphase);
        named_arrive(BAR_TURN + 1 - wg, 256);
        wgmma_wait<1>();                    // S done, P·V may still run
        reg_fence(s);
        free_stage(&sm.empty_k[stage]);
        float corr[2];
        softmax(t * FA_BK, corr);
        wgmma_wait<0>();
        reg_fence(o);
        free_stage(&sm.empty_v[pstage]);
        rescale_and_pack(corr);
      }
      if (wg == 0) named_sync(BAR_TURN, 256);   // consumer 1's last hand-over
      if (n_tiles > 0) {
        const int last = it + n_tiles - 1;
        issue_pv(last % FA_STAGES, (last / FA_STAGES) & 1);
        wgmma_wait<0>();
        reg_fence(o);
        free_stage(&sm.empty_v[last % FA_STAGES]);
      }
      it += n_tiles;
      qbuf ^= 1;

      // normalise (the four threads of a row each summed a quarter) and
      // stage the 64 × HD tile in this item's q buffer, free since its last
      // S, as rows of HD bf16 whose 16-byte chunk c sits at c ^ (row % 8);
      // then write it out a 16-byte chunk a thread, row by row
      const uint32_t stage_o = smem_addr(sm.q[qbuf ^ 1][wg][0]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // unseen row → 0
        const int row = 16 * warp + g + 8 * i;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const uint32_t v = pack_bf16(o[4 * j + 2 * i] * inv,
                                       o[4 * j + 2 * i + 1] * inv);
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(
              stage_o + row * HD * 2 + ((j ^ (row % 8)) * 16) + t4 * 4),
              "r"(v) : "memory");
        }
      }
      named_sync(BAR_WG + wg, 128);
      for_rows(w, [&](int row, long long off) {
        if (off < 0) return;
        uint4 val;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                     : "r"(stage_o + row * HD * 2 +
                           ((chunk ^ (row % 8)) * 16)));
        *reinterpret_cast<uint4*>(out + off + chunk * 8) = val;
      });
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, Sk, KV, hd] with dense rows and a batch stride (elements) as the 4-D
// map (hd, KV, Sk, B); one box is 64 columns of FA_BK keys of one KV head.
// Keys past Sk read as zeros.
bool kv_map(CUtensorMap* map, const void* base, int HD, int KV, int Sk, int B,
            long long bstride) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV,
                              (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)KV * HD * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, row,
                                 B > 1 ? (cuuint64_t)bstride * 2 : row * Sk};
  const cuuint32_t box[4] = {64, 1, FA_BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared-memory attribute belongs to each device: set it once per device
// (bit d of `done`), so a second card is not refused the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && bit) done.fetch_or(bit);
  return e;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KV, long long k_bstride,
                 long long v_bstride, int causal, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_done{0};
  const int smem = fa_smem_bytes<HD>();
  cudaError_t e = allow_smem(fa_wgmma_kernel<HD>, smem, smem_done);
  if (e != cudaSuccess) return (int)e;
  const int rows = Sq * (H / KV);
  if (B == 0 || rows == 0) return (int)cudaGetLastError();
  CUtensorMap kmap{}, vmap{};       // never read when there are no keys
  if (Sk > 0 && !(kv_map(&kmap, k, HD, KV, Sk, B, k_bstride) &&
                  kv_map(&vmap, v, HD, KV, Sk, B, v_bstride)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int items = B * KV * ((rows + FA_ROWS - 1) / FA_ROWS);
  fa_wgmma_kernel<HD><<<min(items, sms), FA_THREADS, smem, stream>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<bf16*>(out), B,
      Sq, Sk, H, KV, LOG2E / sqrtf((float)HD), causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route 2: split-KV (flash-decoding) with mma.sync
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;    // 4 warps
constexpr int SPLIT_MAX_ROWS = 64;    // 4 row tiles of 16 (ops.SPLIT_ROWS)
constexpr int SPLIT_PAD = 8;          // bf16 of padding per row of p

// q's rows (16 per row tile), the chunk's k and v, p of one row tile, and
// the four warps' row maxima and sums
template <int HD, int CHUNK>
constexpr int split_smem_bytes(int row_tiles) {
  return 2 * (16 * row_tiles + 2 * CHUNK) * HD +
         2 * 16 * (CHUNK + SPLIT_PAD) + 2 * 4 * 16 * 4;
}

// A row of q, k or v in shared memory is HD bf16, unpadded: its 16-byte
// chunk c sits at chunk c ^ (row % 8), so the eight rows an ldmatrix reads
// at one column fall on distinct banks.
template <int HD>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int col) {
  return base + row * HD * 2 + ((((col / 8) ^ (row % 8)) * 8 + col % 8) * 2);
}

// One block per (chunk, KV head, batch): the chunk's partial attention for
// all R = Sq·G packed rows, one 16-row tile at a time. The four warps split
// the chunk's keys for S = Q·Kᵀ (CHUNK/4 each) and the head dim for P·V
// (HD/4 each); the chunk's row max and sum meet in shared memory.
// part_o [B, KV, splits, R, HD] gets o unnormalised, part_ml [.., R, 2]
// the row max in the log2 domain (−inf for a row that sees no key of the
// chunk) and the row sum.
template <int HD, int CHUNK>
__global__ void __launch_bounds__(SPLIT_THREADS, 3)   // 3 blocks an SM
fa_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int Sq, int Sk, int H, int KV,
                long long k_bstride, long long v_bstride, float scale_log2,
                int causal, float* __restrict__ part_o,
                float* __restrict__ part_ml, int* __restrict__ tickets,
                bf16* __restrict__ out) {
  using namespace fa;
  constexpr int PROW = CHUNK + SPLIT_PAD; // shared row of p
  constexpr int KW = CHUNK / 4;           // keys per warp for S
  constexpr int NT = KW / 8;              // its 8-key column tiles
  constexpr int DW = HD / 4;              // head-dim columns per warp for P·V
  constexpr int DT = DW / 8;
  constexpr int CH = HD / 8;              // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int R = Sq * G;
  const int MT = (R + 15) / 16;           // row tiles
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + MT * 16 * HD;
  bf16* sV = sK + CHUNK * HD;
  bf16* sP = sV + CHUNK * HD;
  float* red_m = reinterpret_cast<float*>(sP + 16 * PROW);   // [4][16]
  float* red_l = red_m + 4 * 16;                              // [4][16]
  const uint32_t aQ = smem_addr(sQ), aK = smem_addr(sK), aV = smem_addr(sV);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int c0 = split * CHUNK;
  const int c_end = min(c0 + CHUNK, Sk);
  const int shift = Sk - Sq;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8;

  // q rows, and the chunk's keys and values (zeros past its end)
  for (int c = tid; c < MT * 16 * CH; c += SPLIT_THREADS) {
    const int row = c / CH, col = (c % CH) * 8;
    const bool ok = row < R;
    const long long off =
        ok ? (((long long)b * Sq + row / G) * H + kvh * G + row % G) * HD + col
           : 0;
    cp_async16(swz<HD>(aQ, row, col), q + off, ok);
  }
  const bf16* kb = k + b * k_bstride + (long long)kvh * HD;
  const bf16* vb = v + b * v_bstride + (long long)kvh * HD;
  for (int c = tid; c < CHUNK * CH; c += SPLIT_THREADS) {
    const int row = c / CH, col = (c % CH) * 8;
    const int key = c0 + row;
    const bool ok = key < c_end;
    const long long off = ok ? (long long)key * KV * HD + col : 0;
    cp_async16(swz<HD>(aK, row, col), kb + off, ok);
    cp_async16(swz<HD>(aV, row, col), vb + off, ok);
  }
  cp_async_wait_all();
  __syncthreads();

  float* po = part_o + (((long long)b * KV + kvh) * splits + split) * R * HD;
  float* pml = part_ml + (((long long)b * KV + kvh) * splits + split) * R * 2;
  for (int mt = 0; mt < MT; ++mt) {
    // S for this warp's keys [kw0, kw0 + KW) of the chunk
    const int kw0 = warp * KW;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t qa[4];
      ldmatrix_x4(qa, swz<HD>(aQ, mt * 16 + (mi & 1) * 8 + (lane & 7),
                              kc * 16 + (mi >> 1) * 8));
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, swz<HD>(aK, kw0 + n2 * 16 + (mi >> 1) * 8 + (lane & 7),
                                kc * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
      }
    }
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = mt * 16 + g + 8 * i;
      qpos[i] = (row < R ? row / G : 0) + shift;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + kw0 + 8 * n + 2 * t4 + (e & 1);
        if (key >= c_end || (causal && key > qpos[e >> 1]))
          s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (t4 == 0) red_m[warp * 16 + g + 8 * i] = mx[i];
    }
    __syncthreads();
    float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      const float m = fmaxf(fmaxf(red_m[r], red_m[16 + r]),
                            fmaxf(red_m[32 + r], red_m[48 + r]));
      base[i] = m == -INFINITY ? 0.f : m * scale_log2;   // no key here
    }
    // p = 2^(s·scale − max), rounded to bf16 into shared memory
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = ex2(fmaf(s[n][2 * i], scale_log2, -base[i]));
        const float p1 = ex2(fmaf(s[n][2 * i + 1], scale_log2, -base[i]));
        sum[i] += p0 + p1;
        *reinterpret_cast<uint32_t*>(sP + (g + 8 * i) * PROW + kw0 + 8 * n +
                                     2 * t4) = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (t4 == 0) red_l[warp * 16 + g + 8 * i] = sum[i];
    }
    __syncthreads();

    // o[:, warp·DW … + DW) = P · V over the whole chunk
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, smem_addr(sP + ((mi & 1) * 8 + (lane & 7)) * PROW
                                + kk * 16 + (mi >> 1) * 8));
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, swz<HD>(aV, kk * 16 + (mi & 1) * 8 + (lane & 7),
                                      warp * DW + d2 * 16 + (mi >> 1) * 8));
        mma_bf16(o[2 * d2], pa, bv[0], bv[1]);
        mma_bf16(o[2 * d2 + 1], pa, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = mt * 16 + g + 8 * i;
      if (row >= R) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(po + (long long)row * HD + warp * DW +
                                   8 * d + 2 * t4) =
            make_float2(o[d][2 * i], o[d][2 * i + 1]);
    }
    if (tid < 16 && mt * 16 + tid < R) {
      const int r = tid;
      const float m = fmaxf(fmaxf(red_m[r], red_m[16 + r]),
                            fmaxf(red_m[32 + r], red_m[48 + r]));
      pml[(mt * 16 + r) * 2] = m == -INFINITY ? -INFINITY : m * scale_log2;
      pml[(mt * 16 + r) * 2 + 1] =
          red_l[r] + red_l[16 + r] + red_l[32 + r] + red_l[48 + r];
    }
    __syncthreads();                      // sP and red_* are reused
  }

  // The last block of this (batch, KV head) to finish merges every chunk's
  // partial by the log-sum-exp rule, two columns of one row a thread: a
  // running max over batches of MERGE chunks whose loads are all issued
  // before any is used (no branch between them). A row no chunk saw gives
  // 0. It then zeroes its ticket for the next launch.
  __shared__ int last;
  __threadfence();                        // partials visible to the merger
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b * KV + kvh], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int MERGE = 16;
  const long long bk_base = ((long long)b * KV + kvh) * splits * R;
  for (int idx = tid; idx < R * HD / 2; idx += SPLIT_THREADS) {
    const int row = idx / (HD / 2), col = 2 * (idx % (HD / 2));
    const float2* ml =
        reinterpret_cast<const float2*>(part_ml) + bk_base + row;
    const float* po = part_o + (bk_base + row) * HD + col;
    float mg = -INFINITY, lsum = 0.f, acc0 = 0.f, acc1 = 0.f;
    for (int s0 = 0; s0 < splits; s0 += MERGE) {
      float2 mls[MERGE], os[MERGE];
#pragma unroll
      for (int j = 0; j < MERGE; ++j) {
        const bool ok = s0 + j < splits;
        const long long sp = s0 + j;
        mls[j] = ok ? __ldcg(ml + sp * R) : make_float2(-INFINITY, 0.f);
        os[j] = ok ? __ldcg(reinterpret_cast<const float2*>(po + sp * R * HD))
                   : make_float2(0.f, 0.f);
      }
      float mb = mg;
#pragma unroll
      for (int j = 0; j < MERGE; ++j) mb = fmaxf(mb, mls[j].x);
      if (mb == -INFINITY) continue;      // no chunk so far saw the row
      const float c = ex2(mg - mb);       // 0 from -inf
      lsum *= c;
      acc0 *= c;
      acc1 *= c;
      mg = mb;
#pragma unroll
      for (int j = 0; j < MERGE; ++j) {
        const float w = ex2(mls[j].x - mg);   // 0 from -inf
        lsum = fmaf(w, mls[j].y, lsum);
        acc0 = fmaf(w, os[j].x, acc0);
        acc1 = fmaf(w, os[j].y, acc1);
      }
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    *reinterpret_cast<uint32_t*>(
        out + (((long long)b * Sq + row / G) * H + kvh * G + row % G) * HD +
        col) = pack_bf16(acc0 * inv, acc1 * inv);
  }
  if (tid == 0) tickets[b * KV + kvh] = 0;
}

template <int HD, int CHUNK>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KV, long long k_bstride,
                 long long v_bstride, int causal, int splits, float* part_o,
                 float* part_ml, int* tickets, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_done{0};
  cudaError_t e = allow_smem(fa_split_kernel<HD, CHUNK>,
                             split_smem_bytes<HD, CHUNK>(SPLIT_MAX_ROWS / 16),
                             smem_done);
  if (e != cudaSuccess) return (int)e;
  const int R = Sq * (H / KV);
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  if (R > SPLIT_MAX_ROWS || splits < 1) return (int)cudaErrorInvalidValue;
  const int smem = split_smem_bytes<HD, CHUNK>((R + 15) / 16);
  fa_split_kernel<HD, CHUNK><<<dim3(splits, KV, B), SPLIT_THREADS, smem,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), Sq, Sk, H, KV, k_bstride, v_bstride,
      LOG2E / sqrtf((float)HD), causal, part_o, part_ml, tickets,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: bf16 [B, Sq, H, hd] contiguous; k, v: bf16 [B, Sk, KV, hd] with
// dense rows and batch strides k_bstride, v_bstride (elements); hd 64 or 128.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int H, int KV,
                                            int hd, long long k_bstride,
                                            long long v_bstride, int causal,
                                            cudaStream_t stream) {
  if (hd == 64)
    return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, KV, k_bstride,
                            v_bstride, causal, stream);
  if (hd == 128)
    return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, KV, k_bstride,
                             v_bstride, causal, stream);
  return (int)cudaErrorInvalidValue;
}

// The same arguments, Sq·(H/KV) ≤ 64, plus the split plan (splits chunks of
// `chunk` keys, 64 or 128), float32 scratch (part_o holds
// B·KV·splits·Sq·(H/KV)·hd values, part_ml twice B·KV·splits·Sq·(H/KV))
// and B·KV int32 tickets, zero before the launch and left zero after it.
extern "C" int flash_attention_split_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int hd, long long k_bstride, long long v_bstride,
    int causal, int splits, int chunk, float* part_o, float* part_ml,
    int* tickets, cudaStream_t stream) {
#define FA_SPLIT(HD, CHUNK)                                                  \
  if (hd == HD && chunk == CHUNK)                                            \
    return launch_split<HD, CHUNK>(q, k, v, out, B, Sq, Sk, H, KV, k_bstride, \
                                   v_bstride, causal, splits, part_o,        \
                                   part_ml, tickets, stream);
  FA_SPLIT(64, 64)
  FA_SPLIT(64, 128)
  FA_SPLIT(128, 64)
  FA_SPLIT(128, 128)
#undef FA_SPLIT
  return (int)cudaErrorInvalidValue;
}
