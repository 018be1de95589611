// Streaming split attention over the read-only stacked KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `mmduet_tpu/ops/attention.py::
// flash_decode_attention` (its `_kernel` body). Per lane b and kv head h it
// computes ONE online softmax over
//   (i)  slots [0, cache_len[b]) of layer `layer` of the (L, B, kh, S, hd)
//        cache, and
//   (ii) the chunk's own K/V (B, kh, Tc, hd): query row t sees chunk column c
//        iff c <= q_offset[b] + t and c < t_real[b].
// GQA query rows of one kv head are laid out as row = g * T + t.
//
// What bounds it: bytes for a decode step (T = 1: 7 GQA rows do two FMAs
// per byte of the cache read), operations for the 8- and 32-frame blocks
// (2744 and 10976 rows a head: 0.01275 ms of operations against 0.0045 ms
// of bytes at cache_len 2048, `ops/bounds.py`). The design reads only the
// live part of the cache: each block loads its lane's cursors itself and
// stops at cache_len[b], so the buffer's capacity S costs nothing. The layer
// offset into the stacked cache comes from `layer` and the strides; no
// per-layer copy is made.
//
// Every operand is addressed through the lane and head strides the caller
// passes (`Strides`), so the same kernel runs on a strided view: the
// sharded wrapper (the TPU package's `flash_decode_attention_sharded`, the
// kernel under `shard_map`) launches it once per (lane shard, kv-head shard)
// on that shard's view of q, out, cache, chunk and scales, with a grid over
// its local lanes and kv heads. No cache operand is copied, and a
// (lane, head) program does the same arithmetic in the same order whichever
// launch it belongs to, so a sharded run is bit-equal to one launch.
//
// One kernel, `flash_decode_tc_kernel<INT8>`, for both cache types
// (`flash_decode_bf16`, `flash_decode_int8`): tensor-core tiles, split over
// the cache when the rows are few. A block is one warpgroup (128 threads)
// on 64 GQA rows of one (lane, kv head) and one span of the cache. Both
// products are `wgmma`: S = Q K^T m64n64k16 from 128-byte-swizzled shared
// memory (8 steps over hd), O += P V m64n128k16 with P from registers,
// rounded to bf16 as in the Pallas kernel, and V untransposed through the
// MN-major descriptor. Keys stream in 64-key tiles through two bf16 stages
// of K and of V (80 KB of shared memory with the resident Q, 81 KB with
// the int8 cache's scales: two blocks an SM). A tile's products and
// softmax run one after the other, and the copies of the next tile land
// meanwhile; the second block on an SM keeps its tensor cores busy
// through a block's softmax. Copies are `cp.async` of 16 bytes a thread
// into the swizzled layout: no tensor map to encode per call (a call takes
// q, out and chunk pointers that change every layer, and the sharded
// wrapper passes strided views), and rows past a source's end are
// zero-filled by the copy itself.
//   The softmax runs on exp2 with scale * log2(e) folded into one fma per
//   score, in f32. The chunk's tiles come first (split 0 only), masked per
//   row at min(t_real, q_offset + t + 1) with t = row % T; then the span's
//   cache tiles, masked at the span's end. Only a tile that reaches past
//   the least limit of the block's rows is masked (a test of block-uniform
//   values, no divergence): the last cache tile of a span, and the chunk's
//   tiles near the diagonal. A row whose keys so far are all masked keeps m
//   = -1e30 and subtracts 0, so its masked scores weigh exactly 0.
//   The split (flash-decoding): the cache is cut into spans of a fixed number
//   of slots that depends only on the rows of a (lane, head), T times the GQA
//   group, and on S (`ops/attention.py::decode_split_span`): 256 slots when
//   the rows fit one tile (a decode step: 7 rows), 2048 up to 16 tiles (a
//   frame or joiner step: 448 rows), else one span (the 8- and 32-frame
//   blocks: 43 and 172 tiles a head are work enough). The grid is (row tiles,
//   lanes x kv heads, ceil(S / span)), sized from S: the wrapper never reads
//   a cursor. A block whose span starts past its lane's cache_len exits at
//   once; the splits are the grid's outer dimension, so that the blocks of
//   the first spans, those with work, are dispatched first and spread over
//   the SMs. With one live span a block writes its rows directly; else each
//   live block writes f32 partials (acc, m, l) into scratch, and the last one
//   of its (lane, head, row tile), found by a counter that it resets to 0,
//   combines them in span order, a warp a row and four columns a lane, so
//   that four rows' loads are in flight together. So a (lane, head) is
//   computed the same way in any launch, and a sharded run stays bit-equal to
//   one launch (the split depends on nothing a shard changes).
//
// The int8 cache (the Pallas kernel's `quantized=True` variant): int8 K/V
// rows with one f32 scale per (layer, lane, head, slot). A cache tile is
// half the bytes of a bf16 one and comes through registers, two tiles
// ahead: while the tensor cores take S of tile i, each thread widens its
// registers of tile i + 1's K (four 16-byte pieces) to bf16, exactly,
// stores them into the other stage in the swizzled layout the descriptors
// read, with its one scale beside it (64 K scales, then 64 V scales), and
// loads tile i + 2's K into the registers; under P V it does the same for
// V. A block's first two cache tiles load together; `fence.proxy.async`
// and the barrier at the top of tile i + 1 make the stores visible to
// `wgmma`. Rows and scales at or past the span's end load as zeros, so a
// slot past the cursor is never read. The chunk stays bf16 and comes by
// `cp.async`, one tile ahead. No int8 ring: shared memory stays at the bf16
// instance's two stages (81 KB, two blocks an SM; a ring of two int8 stages
// would take 114 KB, one block an SM, and a one-stage ring filled by
// `cp.async` in place of the registers was 5-17 % slower at every shape on
// an H100). The algebra is the Pallas kernel's: each thread multiplies its
// S accumulators by the K scale of their key (a column scaling, before the
// mask and the row max); the row sum l takes the unscaled p, and p is
// multiplied by the V scale of its key before it is rounded to bf16 for
// the value product, as `(p * vscale).astype(q.dtype)` does; the chunk's p
// is not scaled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;              // head dim (the only one supported)
constexpr float NEG = -1e30f;

// Element strides of the operands (rows of hd values are contiguous, and so
// are the q heads of one token, the slots of one cache head and the rows of
// one chunk head).
struct Strides {
  long long q_b, q_t;                // q: lane, token
  long long o_b, o_t;                // out: lane, token
  long long c_l, c_b, c_h;           // cache: layer, lane, kv head
  long long k_b, k_h;                // chunk: lane, kv head
  long long s_l, s_b, s_h;           // int8 cache scales: layer, lane, kv head
};

// 16 int8 values -> 16 bf16 values, exactly, as 8 packed pairs (the first
// four: values 0-7). A byte x in a 16-bit lane: the bf16 bits 0x4300 | (x &
// 0x7f) are 128 + (x & 0x7f), and 0x4300 ^ (x & 0x80) are 128 for x >= 0
// and 256 for x < 0, so their difference is x.
__device__ __forceinline__ void widen16(const uint4& raw, uint32_t (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t p = __byte_perm(w[i >> 1], 0u, (i & 1) ? 0x4342u : 0x4140u);
    const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;
    const uint32_t b = (p & 0x00800080u) ^ 0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    out[i] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

namespace hp = hopper;

namespace tc {

constexpr int THREADS = 128;            // one warpgroup
constexpr int BR = 64;                  // GQA rows of a block
constexpr int BKT = 64;                 // keys of a streamed tile
constexpr int NST = 2;                  // stages of K and of V
constexpr uint32_t HALF = 64 * 128;     // bytes of 64 rows x 64 columns
constexpr uint32_t TILE = 2 * HALF;     // a 64 x 128 bf16 tile
// Shared memory, in bytes from a 1024-byte aligned base: Q | K[NST] |
// V[NST] | (int8 cache) the scales of each stage, 64 of K then 64 of V
constexpr uint32_t SM_K = TILE;
constexpr uint32_t SM_V = SM_K + NST * TILE;
constexpr uint32_t SM_SC = SM_V + NST * TILE;
constexpr size_t SMEM = SM_SC + 1024;
constexpr size_t SMEM_INT8 = SM_SC + NST * 2 * BKT * sizeof(float) + 1024;
static_assert(HD == 4 * 32, "the combine gives each lane four columns");
static_assert(THREADS == 2 * BKT, "a thread loads one scale of a tile");

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
flash_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ k_cache, const void* __restrict__ v_cache,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const __nv_bfloat16* __restrict__ chunk_k,
                       const __nv_bfloat16* __restrict__ chunk_v,
                       const int* __restrict__ cache_len, const int* __restrict__ t_real,
                       const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters, const Strides st,
                       int T, int nh, int kh, int S, int Tc, int layer, int span, float scale) {
  using CacheT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int ticket;
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - hp::smem_u32(smem_raw));
  const int tile = blockIdx.x;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int bh = blockIdx.y;
  const int b = bh / kh;
  const int h = bh % kh;
  const int group = nh / kh;
  const int rows = group * T;
  const int row0 = tile * BR;

  const int clen = min(max(cache_len[b], 0), S);
  const int treal = min(max(t_real[b], 0), Tc);
  const int qoff = q_offset[b];
  const int n_live = max(1, (clen + span - 1) / span);  // spans that hold live slots
  if (split >= n_live) return;

  // this block's keys: the chunk (split 0 only), then cache slots [lo, hi)
  const int lo = split * span;
  const int hi = min(clen, lo + span);
  const int last = min(row0 + BR, rows) - 1;
  const bool one_g = row0 / T == last / T;  // the block's rows are of one q head
  const int t_max = one_g ? last % T : T - 1;
  const int chunk_end = split == 0 ? max(0, min(treal, qoff + t_max + 1)) : 0;
  const int nct = (chunk_end + BKT - 1) / BKT;
  const int n_tiles = nct + (max(hi - lo, 0) + BKT - 1) / BKT;
  // the least causal limit of the block's rows: a chunk tile wholly below
  // it needs no mask, nor does a cache tile wholly below hi
  const int chunk_free = min(treal, qoff + (one_g ? row0 % T : 0) + 1);

  const size_t chead = (size_t)b * st.k_b + (size_t)h * st.k_h;
  const size_t lay = (size_t)layer * st.c_l + (size_t)b * st.c_b + (size_t)h * st.c_h;
  const __nv_bfloat16* ckb = chunk_k + chead;
  const __nv_bfloat16* cvb = chunk_v + chead;
  const CacheT* kcb = static_cast<const CacheT*>(k_cache) + lay;
  const CacheT* vcb = static_cast<const CacheT*>(v_cache) + lay;

  // bf16 K or V of key tile i (the chunk's tiles first; with the int8
  // cache only the chunk's) into its stage i % NST; rows past the source's
  // end are zeros. Thread x copies the 16-byte chunk x % 16 of rows x / 16
  // + 8 k: one swizzled offset, 1024 bytes further for each k (unrolled: on
  // an H100 a strided loop over the tile took 15-20 % longer at the 8- and
  // 32-frame blocks)
  const int cr = threadIdx.x >> 4, cc = threadIdx.x & 15;
  const uint32_t cdst = hp::swizzled(cr, cc, HALF);
  auto load = [&](int i, bool v_tile) {
    const bool chunk = i < nct;
    const __nv_bfloat16* src;
    if constexpr (INT8)
      src = v_tile ? cvb : ckb;
    else
      src = v_tile ? (chunk ? cvb : vcb) : (chunk ? ckb : kcb);
    const int j0 = chunk ? i * BKT : lo + (i - nct) * BKT;
    const int n = chunk ? chunk_end : hi;
    const uint32_t dst = base + (v_tile ? SM_V : SM_K) + (i % NST) * TILE + cdst;
    const __nv_bfloat16* from = src + (size_t)(j0 + cr) * HD + cc * 8;
#pragma unroll
    for (int k = 0; k < BKT / 8; ++k) {
      const bool ok = j0 + cr + 8 * k < n;
      hp::cp_async16(dst + 1024 * k, ok ? from + (size_t)k * 8 * HD : src, ok);
    }
  };

  // The int8 cache's tiles: thread x holds the 16-byte pieces w8 of rows
  // wr + 16 k (k < 4) of the tile's K and of its V, and one scale: K's of
  // slot x or V's of slot x - 64. Within each 8-thread phase of a 16-byte
  // store the rows are one even and one odd and the pieces four, so the
  // swizzled stores meet no bank twice; each warp loads 512 contiguous bytes.
  const int wr = 4 * (threadIdx.x >> 5) + (((threadIdx.x >> 2) & 1) | ((threadIdx.x >> 3) & 2));
  const int w8 = (threadIdx.x & 3) | ((threadIdx.x >> 1) & 4);
  const float* scb = nullptr;
  if constexpr (INT8)
    scb = (threadIdx.x < BKT ? k_scale : v_scale) + (size_t)layer * st.s_l +
          (size_t)b * st.s_b + (size_t)h * st.s_h;
  // K or V of cache tile i into registers (zeros at and past hi), and with
  // K the thread's scale
  auto fetch = [&](int i, const CacheT* src, uint4 (&r)[4], float* sc) {
    const int j0 = lo + (i - nct) * BKT;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = j0 + wr + 16 * k;
      r[k] = row < hi ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * HD + w8 * 16))
                      : make_uint4(0, 0, 0, 0);
    }
    if (sc != nullptr) {
      const int j = j0 + (threadIdx.x & (BKT - 1));
      *sc = j < hi ? __ldg(scb + j) : 0.f;
    }
  };
  // those registers, widened, into K's or V's stage of tile i (and the scale)
  auto land = [&](int i, uint32_t part, const uint4 (&r)[4], const float* sc) {
    unsigned char* d = sbase + part + (i % NST) * TILE;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = wr + 16 * k;
      uint32_t w[8];
      widen16(r[k], w);
      *reinterpret_cast<uint4*>(d + hp::swizzled(row, 2 * w8, HALF)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(d + hp::swizzled(row, 2 * w8 + 1, HALF)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
    if (sc != nullptr)
      reinterpret_cast<float*>(sbase + SM_SC)[(i % NST) * 2 * BKT + threadIdx.x] = *sc;
  };
  uint4 rk[4], rv[4];  // K and V of the cache tile after the next
  float rsc = 0.f;

  // the block's query rows (row = g * T + t; zeros past `rows`) with K and
  // V of tile 0; with the bf16 cache, K and V of tile 1 as a second group of
  // copies; with the int8 cache, tile 1 into registers if it is a cache
  // tile (both in flight before tile 0 lands, if it is one too)
  for (int idx = threadIdx.x; idx < BR * 16; idx += THREADS) {
    const int r = idx >> 4, ch = idx & 15;
    const int row = row0 + r;
    const bool ok = row < rows;
    const int g = ok ? row / T : 0, t = ok ? row % T : 0;
    const __nv_bfloat16* src =
        q + (size_t)b * st.q_b + (size_t)t * st.q_t + (size_t)(h * group + g) * HD + ch * 8;
    hp::cp_async16(base + hp::swizzled(r, ch, HALF), src, ok);
  }
  if constexpr (INT8) {
    if (nct > 0) {
      load(0, false);
      load(0, true);
      if (n_tiles > 1 && nct == 1) {
        fetch(1, kcb, rk, &rsc);
        fetch(1, vcb, rv, nullptr);
      }
    } else if (n_tiles > 0) {
      uint4 k0[4], v0[4];
      float s0;
      fetch(0, kcb, k0, &s0);
      fetch(0, vcb, v0, nullptr);
      if (n_tiles > 1) {
        fetch(1, kcb, rk, &rsc);
        fetch(1, vcb, rv, nullptr);
      }
      land(0, SM_K, k0, &s0);
      land(0, SM_V, v0, nullptr);
    }
    hp::cp_async_commit();
  } else {
    if (n_tiles > 0) {
      load(0, false);
      load(0, true);
    }
    hp::cp_async_commit();
    if (n_tiles > 1) {
      load(1, false);
      load(1, true);
    }
    hp::cp_async_commit();
  }

  // this thread's rows (second: + 8) and the first of its two columns in
  // every 8-column block of an accumulator
  const int lane = threadIdx.x & 31;
  const int rr = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (threadIdx.x & 3);
  const int row[2] = {row0 + rr, row0 + rr + 8};
  int limit[2];  // the row's causal limit in the chunk (exclusive)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    limit[i] = row[i] < rows ? min(treal, qoff + row[i] % T + 1) : chunk_end;
  const float c = scale * hp::LOG2E;
  const uint64_t qdesc = hp::desc_kmajor(base);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // K and V of tile i + 2 into the stages that tile i has left
  auto refill = [&](int i) {
    __syncthreads();  // every warp's products are done with them
    if (i + 2 < n_tiles) {
      load(i + 2, false);
      load(i + 2, true);
    }
    hp::cp_async_commit();
  };

  for (int i = 0; i < n_tiles; ++i) {
    // K and V of tile i (and, at i = 0, Q) have landed
    if constexpr (INT8)
      hp::cp_async_wait<0>();
    else
      hp::cp_async_wait<1>();
    hp::fence_proxy_async();
    __syncthreads();
    float sc[32];
    const uint64_t kdesc = hp::desc_kmajor(base + SM_K + (i % NST) * TILE);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss(sc, qdesc + hp::kstep(kk, HALF), kdesc + hp::kstep(kk, HALF), kk);
    hp::wgmma_commit();
    if constexpr (INT8) {
      // while the tensor cores take S: tile i + 1 into the other stage,
      // which tile i - 1 has left (the chunk's by cp.async; the cache's K
      // from the registers), then tile i + 2's K into the registers
      if (i + 1 < nct) {
        load(i + 1, false);
        load(i + 1, true);
      } else if (i + 1 < n_tiles) {
        land(i + 1, SM_K, rk, &rsc);
      }
      if (i + 2 < n_tiles && i + 2 >= nct) fetch(i + 2, kcb, rk, &rsc);
      hp::cp_async_commit();
    }
    hp::wgmma_wait<0>();
    hp::acc_fence(sc);

    const bool chunk = i < nct;
    const float* tsc = reinterpret_cast<const float*>(sbase + SM_SC) + (i % NST) * 2 * BKT;
    if constexpr (INT8) {
      if (!chunk) {  // K's scales on S's columns, before the mask and the max
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 ks = *reinterpret_cast<const float2*>(tsc + n * 8 + col);
          sc[4 * n] *= ks.x;
          sc[4 * n + 1] *= ks.y;
          sc[4 * n + 2] *= ks.x;
          sc[4 * n + 3] *= ks.y;
        }
      }
    }
    const int j0 = chunk ? i * BKT : lo + (i - nct) * BKT;
    if (j0 + BKT > (chunk ? chunk_free : hi)) {  // the same in every thread
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + col + (e & 1);
          if (key >= (chunk ? limit[e >> 1] : hi)) sc[4 * n + e] = NEG;
        }
      }
    }
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[4 * n + e]);
    }
    float alpha[2], mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const float mn = fmaxf(m[k2], hp::quad_max(tmax[k2]));
      alpha[k2] = hp::ex2((m[k2] - mn) * c);
      m[k2] = mn;
      // a row with no visible key yet subtracts 0, so its masked scores
      // give exp2(-1e30 c) = 0 and not exp2(0)
      mc[k2] = mn > 0.5f * NEG ? mn * c : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = hp::ex2(fmaf(sc[4 * n + e], c, -mc[e >> 1]));
        rsum[e >> 1] += sc[4 * n + e];
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) l[k2] = l[k2] * alpha[k2] + rsum[k2];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    if constexpr (INT8) {
      if (!chunk) {  // V's scales on p, after l took it unscaled
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 vs = *reinterpret_cast<const float2*>(tsc + BKT + n * 8 + col);
          sc[4 * n] *= vs.x;
          sc[4 * n + 1] *= vs.y;
          sc[4 * n + 2] *= vs.x;
          sc[4 * n + 3] *= vs.y;
        }
      }
    }
    uint32_t pa[4][4];
    hp::pack_a(pa, sc);
    const uint64_t vdesc = hp::desc_mnmajor(base + SM_V + (i % NST) * TILE, HALF);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::wgmma_rs(acc, pa[kk], vdesc + hp::rowstep(kk));
    hp::wgmma_commit();
    if constexpr (INT8) {  // and under P V, the same for V
      if (i + 1 >= nct && i + 1 < n_tiles) land(i + 1, SM_V, rv, nullptr);
      if (i + 2 < n_tiles && i + 2 >= nct) fetch(i + 2, vcb, rv, nullptr);
    }
    hp::wgmma_wait<0>();
    hp::acc_fence(acc);
    if constexpr (!INT8) refill(i);
  }

  float lsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = hp::quad_sum(l[i]);
  auto out_row = [&](int r) {  // the output row of GQA row r
    return out + (size_t)b * st.o_b + (size_t)(r % T) * st.o_t +
           (size_t)(h * group + r / T) * HD;
  };

  if (n_live == 1) {  // the whole row in this block
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= rows) continue;
      const float denom = fmaxf(lsum[i], 1e-30f);
      __nv_bfloat16* dst = out_row(row[i]) + col;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            hp::pack(acc[4 * n + 2 * i] / denom, acc[4 * n + 2 * i + 1] / denom);
    }
    return;
  }

  // partials: acc (bh, split, row, HD) f32, then (m, l) (bh, split, row, 2)
  const size_t all_rows = (size_t)gridDim.y * nsplit * rows;
  const size_t first = ((size_t)bh * nsplit + split) * rows;
  float* pacc = part + first * HD;
  float* pml = part + all_rows * HD + first * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(pacc + (size_t)row[i] * HD + n * 8 + col) =
          make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    if (col == 0) *reinterpret_cast<float2*>(pml + 2 * row[i]) = make_float2(m[i], lsum[i]);
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)bh * gridDim.x + tile;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != n_live - 1) return;
  __threadfence();

  // the last block of this (lane, head, row tile): the live spans' partials
  // in span order, a warp a row and four columns a lane. Lane j reads span
  // s0 + j's (m, l), and each lane takes the weights of spans s0, s0 + 1, ...
  // in turn from the lane that read them, so every sum runs in span order
  const int warp = threadIdx.x >> 5;
  const size_t bh0 = (size_t)bh * nsplit * rows;
  const float* pm = part + all_rows * HD;
  for (int r = row0 + warp; r <= last; r += THREADS / 32) {
    float mx = NEG;
    for (int sp = lane; sp < n_live; sp += 32)
      mx = fmaxf(mx, __ldcg(pm + (bh0 + (size_t)sp * rows + r) * 2));
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    float lt = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < n_live; s0 += 32) {
      float2 ml = make_float2(NEG, 0.f);
      if (s0 + lane < n_live)
        ml = __ldcg(reinterpret_cast<const float2*>(pm + (bh0 + (size_t)(s0 + lane) * rows + r) *
                                                        2));
      const float w = hp::ex2((ml.x - mx) * c);
      const int n = min(32, n_live - s0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        lt += wj * __shfl_sync(0xffffffffu, ml.y, j);
        const float4 a = __ldcg(reinterpret_cast<const float4*>(
            part + (bh0 + (size_t)(s0 + j) * rows + r) * HD + 4 * lane));
        o[0] += wj * a.x;
        o[1] += wj * a.y;
        o[2] += wj * a.z;
        o[3] += wj * a.w;
      }
    }
    const float den = fmaxf(lt, 1e-30f);
    *reinterpret_cast<uint2*>(out_row(r) + 4 * lane) =
        make_uint2(hp::pack(o[0] / den, o[1] / den), hp::pack(o[2] / den, o[3] / den));
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// One launch of the kernel for the cache type INT8 (see flash_decode_bf16).
template <bool INT8>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* chunk_k, const void* chunk_v, const void* cache_len,
           const void* t_real, const void* q_offset, void* out, void* part, void* counters,
           const long long* s, int B, int T, int nh, int kh, int S, int Tc, int layer, int span,
           float scale, void* stream) {
  constexpr size_t smem = INT8 ? SMEM_INT8 : SMEM;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      flash_decode_tc_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
  if (span < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (nh / kh) * T;
  const int nsplit = (S + span - 1) / span;
  if (nsplit > 1 && (part == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + BR - 1) / BR, B * kh, nsplit);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  flash_decode_tc_kernel<INT8><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(chunk_k), static_cast<const __nv_bfloat16*>(chunk_v),
      static_cast<const int*>(cache_len), static_cast<const int*>(t_real),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), st, T, nh, kh, S, Tc, layer, span,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers of bf16 / int32 tensors or of strided views
// of them; `strides` points to the 12 element strides of `Strides`, in its
// order, on the host. B, nh and kh are the view's own (a shard's local)
// counts. The caller checks shapes, dtypes, strides, alignment and hd ==
// 128. `span` is the split's slots (`decode_split_span`); with ceil(S /
// span) > 1 spans, `part` is f32 scratch of B kh ceil(S / span) (nh / kh)
// T (hd + 2) values and `counters` int32 zeros, B kh ceil((nh / kh) T /
// 64) of them, which the kernel leaves zero again.
int flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, void* part, void* counters,
                      const long long* strides, int B, int T, int nh, int kh, int S, int Tc,
                      int layer, int span, float scale, void* stream) {
  return tc::launch<false>(q, k_cache, v_cache, nullptr, nullptr, chunk_k, chunk_v, cache_len,
                           t_real, q_offset, out, part, counters, strides, B, T, nh, kh, S, Tc,
                           layer, span, scale, stream);
}

// The int8 cache: k_cache / v_cache are int8 (L, B, kh, S, hd), k_scale /
// v_scale f32 (L, B, kh, S) (or views); everything else as above.
int flash_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, void* part, void* counters,
                      const long long* strides, int B, int T, int nh, int kh, int S, int Tc,
                      int layer, int span, float scale, void* stream) {
  return tc::launch<true>(q, k_cache, v_cache, k_scale, v_scale, chunk_k, chunk_v, cache_len,
                          t_real, q_offset, out, part, counters, strides, B, T, nh, kh, S, Tc,
                          layer, span, scale, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
