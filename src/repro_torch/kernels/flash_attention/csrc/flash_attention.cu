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
// with scores and softmax in float32 and, when causal, the mask aligned
// bottom-right: row i sits at absolute position Sk − Sq + i and sees keys
// 0 … Sk − Sq + i. A row that sees no key is written 0. Any Sq and Sk work,
// Sq = 1 included; the ragged edges are masked here, so there is no
// alignment fallback.
//
// Bound on the H100: prefill (Sq = Sk = 2048) by operations — 4·hd flops per
// unmasked (query, key) pair on the tensor cores against ~100 MB of q, k, v
// and out; decode (Sq = 1) by bytes — it reads the whole cache once per step
// for a few flops per byte.
//
// Design: one block of 4 warps per (tile of 64 query rows, KV head, batch).
// The G = H/KV query heads that share a KV head are packed into the rows of
// one block (row r = position r / G, head r % G), so each K/V tile is read
// once for all of them — for decode that turns G single rows into one tile.
// K and V tiles of 64 keys stream through shared memory, double-buffered with
// cp.async (zero-filled past Sk); q·kᵀ and p·v run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, float32 accumulate), each warp owning 16 rows.
// The running max and denominator stay in float32 registers, p is rounded to
// bf16 for the p·v product as the Pallas kernel does, and the output is
// normalised and written once. KV tiles entirely above the causal diagonal of
// a block are never loaded. The k/v batch strides are arguments, so a decode
// step reads cache[:, :kv_len] where it lies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = 32 * FA_WARPS;
constexpr int FA_BQ = 16 * FA_WARPS;  // query rows per block
constexpr int FA_BK = 64;             // keys per tile
constexpr int FA_PAD = 8;             // bf16 of padding per shared row:
                                      // ldmatrix rows fall on distinct banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a·b, a 16×16 (row), b 16×8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
             long long k_bstride, long long v_bstride, float scale_log2,
             int causal) {
  constexpr int ROW = HD + FA_PAD;        // shared row, bf16 elements
  constexpr int TILE = FA_BK * ROW;       // one K or V tile
  constexpr int CHUNKS = HD / 8;          // 16-byte chunks per row
  constexpr int KC = HD / 16;             // k-steps of q·kᵀ
  constexpr int NT = FA_BK / 8;           // 8-key column tiles of s
  constexpr int DT = HD / 8;              // 8-wide column tiles of out
  static_assert(FA_BQ == FA_BK, "q is staged in a K tile buffer");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV0 = sK0 + TILE;
  __nv_bfloat16* sK1 = sV0 + TILE;
  __nv_bfloat16* sV1 = sK1 + TILE;

  const int G = H / KV;
  const int rows = Sq * G;                // packed (position, head) rows
  const int r0 = blockIdx.x * FA_BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = Sk - Sq;              // bottom-right causal alignment
  const __nv_bfloat16* kb = k + b * k_bstride + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + b * v_bstride + (long long)kvh * HD;

  // q rows of this block → sK1 (free until tile 1 is loaded)
  for (int c = tid; c < FA_BQ * CHUNKS; c += FA_THREADS) {
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int r = r0 + row;
    const bool ok = r < rows;
    const long long off =
        ok ? (((long long)b * Sq + r / G) * H + kvh * G + r % G) * HD + col
           : 0;
    cp_async16(smem_addr(sK1 + row * ROW + col), q + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int wrow = warp * 16;             // first row of this warp
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldmatrix_x4(qf[kc], smem_addr(sK1 + (wrow + (mi & 1) * 8 + (lane & 7)) * ROW
                                  + kc * 16 + (mi >> 1) * 8));
  __syncthreads();                        // every warp holds its q

  // the thread's two rows (g and g + 8 of the warp) and their positions
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wrow + g + 8 * i;
    rvalid[i] = r < rows;
    qpos[i] = (rvalid[i] ? r / G : 0) + shift;
  }
  const int wlast = min(r0 + wrow + 15, rows - 1);
  const bool warp_live = r0 + wrow < rows;
  const int warp_maxpos = warp_live ? wlast / G + shift : -1;

  int n_tiles = (Sk + FA_BK - 1) / FA_BK;
  if (causal) {
    const int blast = min(r0 + FA_BQ, rows) - 1;
    const int maxpos = blast / G + shift;
    n_tiles = maxpos < 0 ? 0 : min(n_tiles, maxpos / FA_BK + 1);
  }

  auto load_tile = [&](int tile, __nv_bfloat16* dK, __nv_bfloat16* dV) {
    for (int c = tid; c < FA_BK * CHUNKS; c += FA_THREADS) {
      const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int key = tile * FA_BK + row;
      const bool ok = key < Sk;
      const long long off = ok ? (long long)key * KV * HD + col : 0;
      cp_async16(smem_addr(dK + row * ROW + col), kb + off, ok);
      cp_async16(smem_addr(dV + row * ROW + col), vb + off, ok);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  if (n_tiles > 0) load_tile(0, sK0, sV0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool odd = tile & 1;
    if (tile + 1 < n_tiles)
      load_tile(tile + 1, odd ? sK0 : sK1, odd ? sV0 : sV1);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile has landed
    __syncthreads();
    const __nv_bfloat16* cK = odd ? sK1 : sK0;
    const __nv_bfloat16* cV = odd ? sV1 : sV0;
    const int kbase = tile * FA_BK;
    // a warp whose rows all lie above this tile's first key skips it
    if (warp_live && !(causal && warp_maxpos < kbase)) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(cK + (n2 * 16 + (mi >> 1) * 8 + (lane & 7))
                                            * ROW + kc * 16 + (mi & 1) * 8));
          mma_bf16(s[2 * n2], qf[kc], bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], qf[kc], bk[2], bk[3]);
        }
      }
      // scale into the log2 domain, mask, and the running max per row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = kbase + n * 8 + 2 * t4 + (e & 1);
          const bool ok = key < Sk && (!causal || key <= qpos[i]);
          s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        const float base = m_new == -INFINITY ? 0.f : m_new;  // no key yet
        corr[i] = exp2f(m[i] - base);     // 0 while m[i] is -inf
        m[i] = m_new;
        mx[i] = base;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
          l[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= corr[0]; o[d][1] *= corr[0];
        o[d][2] *= corr[1]; o[d][3] *= corr[1];
      }
      // out += p·v: the s accumulators are already the A fragments of p
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(cV + (kk * 16 + (mi & 1) * 8
                                                + (lane & 7)) * ROW
                                               + d2 * 16 + (mi >> 1) * 8));
          mma_bf16(o[2 * d2], pa, bv[0], bv[1]);
          mma_bf16(o[2 * d2 + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                      // done with this buffer
  }
  cp_async_wait<0>();

  // denominators: the four threads of a row each summed a quarter of it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int r = r0 + wrow + g + 8 * i;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // unseen row → 0
    __nv_bfloat16* orow =
        out + (((long long)b * Sq + r / G) * H + kvh * G + r % G) * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * t4) =
          pack_bf16(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, long long k_bstride,
           long long v_bstride, int causal, cudaStream_t stream) {
  const int smem = 4 * FA_BK * (HD + FA_PAD) * (int)sizeof(__nv_bfloat16);
  static bool smem_set = false;           // once per instantiation
  if (smem > 48 * 1024 && !smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int rows = Sq * (H / KV);
  if (B > 0 && rows > 0) {
    const dim3 grid((rows + FA_BQ - 1) / FA_BQ, KV, B);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
    flash_kernel<HD><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, k_bstride, v_bstride,
        scale_log2, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: bf16 [B, Sq, H, hd] contiguous; k, v: bf16 [B, Sk, KV, hd] with
// dense rows and batch strides k_bstride, v_bstride (elements); hd 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      long long k_bstride,
                                      long long v_bstride, int causal,
                                      cudaStream_t stream) {
  if (hd == 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, k_bstride, v_bstride,
                      causal, stream);
  if (hd == 128)
    return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, k_bstride, v_bstride,
                       causal, stream);
  return (int)cudaErrorInvalidValue;
}
