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
// on that shard's view of q, out, cache, chunk and scales, with a grid of
// (tiles, local kv heads, local lanes). No cache operand is copied, and a
// (lane, head) program does the same arithmetic in the same order whichever
// launch it belongs to, so a sharded run is bit-equal to one launch.
//
// Two kernels, by cache type:
//
// **bf16 cache (`flash_decode_bf16`): tensor-core tiles, split over the
// cache when the rows are few.** A block is one warpgroup (128 threads) on
// 64 GQA rows of one (lane, kv head) and one span of the cache. Both
// products are `wgmma`: S = Q K^T m64n64k16 from 128-byte-swizzled shared
// memory (8 steps over hd), O += P V m64n128k16 with P from registers,
// rounded to bf16 as in the Pallas kernel, and V untransposed through the
// MN-major descriptor. Keys stream in 64-key tiles through two-stage K and
// V rings (80 KB of shared memory with the resident Q: two blocks an SM).
// A tile's products and softmax run one after the other, and the copies of
// the next tile land meanwhile; the second block on an SM keeps its tensor
// cores busy through a block's softmax. Copies are `cp.async` of 16 bytes a
// thread into the swizzled layout: no tensor map to encode per call (a call
// takes q, out and chunk pointers that change every layer, and the sharded
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
//   The split (flash-decoding): the cache is cut into spans of a fixed
//   number of slots that depends only on the rows of a (lane, head), T times
//   the GQA group, and on S (`ops/attention.py::decode_split_span`): 256
//   slots when the rows fit one tile (a decode step: 7 rows), 2048 up to 16
//   tiles (a frame or joiner step: 448 rows), else one span (the 8- and
//   32-frame blocks: 43 and 172 tiles a head are work enough). The grid is
//   (row tiles, ceil(S / span), lanes x kv heads), sized from S: the wrapper
//   never reads a cursor. A block whose span starts past its lane's
//   cache_len exits at once. With one live span a block writes its rows
//   directly; else each live block writes f32 partials (acc, m, l) into
//   scratch, and the last one of its (lane, head, row tile), found by a
//   counter that it resets to 0, combines them in span order. So a (lane,
//   head) is computed the same way in any launch, and a sharded run stays
//   bit-equal to one launch (the split depends on nothing a shard changes).
//
// **int8 cache (`flash_decode_int8`): CUDA cores.** One thread block per
// (query-row tile, kv head, lane); 4 warps x 4 query rows; K/V tiles of 64
// keys staged in shared memory and shared by the 16 rows; f32
// online-softmax state (m, l, acc) per row, with each lane owning 4 of the
// 128 output dims; p stays in f32 for the value product. The chunk is
// processed first so that every real row has a finite running max before
// any fully masked cache tile (masked scores are a finite -1e30, as in the
// JAX code).
//
// The int8 cache (the Pallas kernel's `quantized=True` variant): the cache
// holds int8 K/V rows with one f32 scale per (layer, lane, head, slot). A
// tile arrives as int8 (half the bytes, 16 values per 16-byte load) and is
// widened to bf16 in shared memory, exactly; a block loads the scales of
// its own head's slots. The algebra is the reference's: the K scale
// multiplies the score as a column scaling, s = (q . k_int) * scale *
// ks[col]; the V scale is folded into the numerator, acc += (p * vs[col]) *
// v_int; the denominator sums the unscaled p. The chunk stays bf16 and goes
// first.
//
// Later work: the int8 cache on the tensor-core path (the tile loads would
// widen int8 to bf16 in shared memory, the scales ride on S's columns and
// P's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;              // head dim (the only one supported)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;               // query rows per warp
constexpr int ROWS = WARPS * RPW;    // query rows per block
constexpr int KT = 64;               // keys per shared-memory tile
constexpr int KPAD = HD + 2;         // K row stride: 65 words, so lane j
                                     // reading key j hits bank (j + d) % 32
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

struct __align__(16) Smem {
  float q[ROWS][HD];                 // queries of this tile, f32
  __nv_bfloat16 k[KT][KPAD];
  __nv_bfloat16 v[KT][HD];
  float p[WARPS][RPW][KT];           // softmax numerators of the tile
  float ks[KT];                      // int8 cache: the tile's K and V scales
  float vs[KT];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage keys [j0, j0 + KT) of one (HD-contiguous rows) K/V source; rows at
// or past n are zero-filled and masked later.
__device__ __forceinline__ void load_tile(Smem& sm, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int j0, int n) {
  constexpr int CHUNKS = HD / 8;     // 16-byte pieces per row
  for (int c = threadIdx.x; c < KT * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u);
    uint4 vv = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + row < n) {
      const size_t off = (size_t)(j0 + row) * HD + col;
      kv = *reinterpret_cast<const uint4*>(kb + off);
      vv = *reinterpret_cast<const uint4*>(vb + off);
    }
    uint32_t* kd = reinterpret_cast<uint32_t*>(&sm.k[row][col]);
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<uint4*>(&sm.v[row][col]) = vv;
  }
}

// 16 int8 values -> 16 bf16 values (exact), as 8 packed pairs
__device__ __forceinline__ void widen16(const uint4& raw, uint32_t (&out)[8]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn((float)b[2 * i], (float)b[2 * i + 1]);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The int8 cache's form of `load_tile`: keys [j0, j0 + KT) of one head's
// int8 rows widened to bf16, and their f32 scales (rows at or past n: zeros).
__device__ __forceinline__ void load_tile_int8(Smem& sm, const int8_t* kb, const int8_t* vb,
                                               const float* ksb, const float* vsb,
                                               int j0, int n) {
  constexpr int CHUNKS = HD / 16;    // 16-byte pieces per int8 row
  for (int c = threadIdx.x; c < KT * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 16;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u);
    uint4 vv = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + row < n) {
      const size_t off = (size_t)(j0 + row) * HD + col;
      kv = *reinterpret_cast<const uint4*>(kb + off);
      vv = *reinterpret_cast<const uint4*>(vb + off);
    }
    uint32_t kw[8], vw[8];
    widen16(kv, kw);
    widen16(vv, vw);
    uint32_t* kd = reinterpret_cast<uint32_t*>(&sm.k[row][col]);
    uint32_t* vd = reinterpret_cast<uint32_t*>(&sm.v[row][col]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      kd[i] = kw[i];
      vd[i] = vw[i];
    }
  }
  if (threadIdx.x < KT) {
    const int j = j0 + threadIdx.x;
    sm.ks[threadIdx.x] = j < n ? ksb[j] : 0.f;
    sm.vs[threadIdx.x] = j < n ? vsb[j] : 0.f;
  }
}

// One staged tile into the warp's online-softmax state. `limit[r]` is the
// last key index row r may see (exclusive), `n` the source's valid keys.
// SCALED: the tile is an int8 cache tile, with its scales in sm.ks / sm.vs.
template <bool SCALED>
__device__ __forceinline__ void attend_tile(const Smem& sm, int j0, int n,
                                            const int (&limit)[RPW], float scale,
                                            float (&m)[RPW], float (&l)[RPW],
                                            float (&acc)[RPW][4], float (&pbuf)[RPW][KT]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float s[RPW][2];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;

  const __nv_bfloat162* k0 = reinterpret_cast<const __nv_bfloat162*>(&sm.k[lane][0]);
  const __nv_bfloat162* k1 = reinterpret_cast<const __nv_bfloat162*>(&sm.k[lane + 32][0]);
#pragma unroll 8
  for (int d2 = 0; d2 < HD / 2; ++d2) {
    const float2 a = __bfloat1622float2(k0[d2]);
    const float2 b = __bfloat1622float2(k1[d2]);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float2 qq = *reinterpret_cast<const float2*>(&sm.q[warp * RPW + r][2 * d2]);
      s[r][0] = fmaf(qq.x, a.x, fmaf(qq.y, a.y, s[r][0]));
      s[r][1] = fmaf(qq.x, b.x, fmaf(qq.y, b.y, s[r][1]));
    }
  }

  const int c0 = j0 + lane;
  const int c1 = j0 + lane + 32;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float x0 = s[r][0] * scale;
    float x1 = s[r][1] * scale;
    if (SCALED) {                    // K's per-token scale: a column scaling
      x0 *= sm.ks[lane];
      x1 *= sm.ks[lane + 32];
    }
    if (!(c0 < n && c0 < limit[r])) x0 = NEG;
    if (!(c1 < n && c1 < limit[r])) x1 = NEG;
    const float mn = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
    const float alpha = expf(m[r] - mn);
    const float p0 = expf(x0 - mn);
    const float p1 = expf(x1 - mn);
    l[r] = l[r] * alpha + warp_sum(p0 + p1);
    m[r] = mn;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    // V's per-token scale rides on the numerator; l keeps the unscaled p
    pbuf[r][lane] = SCALED ? p0 * sm.vs[lane] : p0;
    pbuf[r][lane + 32] = SCALED ? p1 * sm.vs[lane + 32] : p1;
  }
  __syncwarp();

  const int jn = min(KT, n - j0);
  for (int j = 0; j < jn; ++j) {
    const uint2 raw = *reinterpret_cast<const uint2*>(&sm.v[j][lane * 4]);
    const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float pj = pbuf[r][j];
      acc[r][0] = fmaf(pj, v01.x, acc[r][0]);
      acc[r][1] = fmaf(pj, v01.y, acc[r][1]);
      acc[r][2] = fmaf(pj, v23.x, acc[r][2]);
      acc[r][3] = fmaf(pj, v23.y, acc[r][3]);
    }
  }
  __syncwarp();
}

// The int8 cache: int8 (L, B, kh, S, hd) rows with f32 scales (L, B, kh, S).
__global__ void __launch_bounds__(THREADS)
flash_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const void* __restrict__ k_cache,
                         const void* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const __nv_bfloat16* __restrict__ chunk_k,
                         const __nv_bfloat16* __restrict__ chunk_v,
                         const int* __restrict__ cache_len,
                         const int* __restrict__ t_real,
                         const int* __restrict__ q_offset,
                         __nv_bfloat16* __restrict__ out, const Strides st,
                         int T, int nh, int kh, int S, int Tc, int layer,
                         float scale) {
  __shared__ Smem sm;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nh / kh;
  const int rows = group * T;
  const int row0 = tile * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int clen = min(max(cache_len[b], 0), S);
  const int treal = min(max(t_real[b], 0), Tc);
  const int qoff = q_offset[b];

  // queries of this tile -> shared memory (rows past `rows` are zeros)
  for (int idx = threadIdx.x; idx < ROWS * (HD / 2); idx += THREADS) {
    const int rr = idx / (HD / 2);
    const int d2 = idx % (HD / 2);
    const int row = row0 + rr;
    float2 val = make_float2(0.f, 0.f);
    if (row < rows) {
      const int g = row / T;
      const int t = row % T;
      const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(
          q + (size_t)b * st.q_b + (size_t)t * st.q_t + (size_t)(h * group + g) * HD);
      val = __bfloat1622float2(qp[d2]);
    }
    *reinterpret_cast<float2*>(&sm.q[rr][2 * d2]) = val;
  }

  // causal limit of each of this warp's rows inside the chunk, and the
  // last chunk column any row of the block can see
  int limit[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    limit[r] = qoff + (row < rows ? row % T : T - 1) + 1;
  }
  const int last = min(row0 + ROWS, rows) - 1;
  const int t_max = (row0 / T != last / T) ? T - 1 : last % T;
  const int chunk_end = max(0, min(treal, qoff + t_max + 1));

  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  const size_t head = (size_t)b * st.k_b + (size_t)h * st.k_h;
  const __nv_bfloat16* ckb = chunk_k + head;
  const __nv_bfloat16* cvb = chunk_v + head;
  for (int j0 = 0; j0 < chunk_end; j0 += KT) {
    __syncthreads();
    load_tile(sm, ckb, cvb, j0, chunk_end);
    __syncthreads();
    attend_tile<false>(sm, j0, chunk_end, limit, scale, m, l, acc, sm.p[warp]);
  }

  // cache history: every query row sits after it, so only cache_len masks
  const size_t lay = (size_t)layer * st.c_l + (size_t)b * st.c_b + (size_t)h * st.c_h;
  const size_t slay = (size_t)layer * st.s_l + (size_t)b * st.s_b + (size_t)h * st.s_h;
  int no_limit[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) no_limit[r] = clen;
  for (int j0 = 0; j0 < clen; j0 += KT) {
    __syncthreads();
    load_tile_int8(sm, static_cast<const int8_t*>(k_cache) + lay,
                   static_cast<const int8_t*>(v_cache) + lay, k_scale + slay, v_scale + slay,
                   j0, clen);
    __syncthreads();
    attend_tile<true>(sm, j0, clen, no_limit, scale, m, l, acc, sm.p[warp]);
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    if (row >= rows) continue;
    const int g = row / T;
    const int t = row % T;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat162 o01 = __floats2bfloat162_rn(acc[r][0] / denom, acc[r][1] / denom);
    __nv_bfloat162 o23 = __floats2bfloat162_rn(acc[r][2] / denom, acc[r][3] / denom);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&o01);
    packed.y = *reinterpret_cast<uint32_t*>(&o23);
    *reinterpret_cast<uint2*>(out + (size_t)b * st.o_b + (size_t)t * st.o_t +
                              (size_t)(h * group + g) * HD + lane * 4) = packed;
  }
}

// ---- bf16 cache: tensor-core tiles, split over the cache ------------------

namespace hp = hopper;

namespace tc {

constexpr int THREADS = 128;            // one warpgroup
constexpr int BR = 64;                  // GQA rows of a block
constexpr int BKT = 64;                 // keys of a streamed tile
constexpr int NST = 2;                  // ring stages of K and of V
constexpr uint32_t HALF = 64 * 128;     // bytes of 64 rows x 64 columns
constexpr uint32_t TILE = 2 * HALF;     // a 64 x 128 bf16 tile
// Shared memory, in bytes from a 1024-byte aligned base: Q | K[NST] | V[NST]
constexpr uint32_t SM_K = TILE;
constexpr uint32_t SM_V = SM_K + NST * TILE;
constexpr size_t SMEM = SM_V + NST * TILE + 1024;
static_assert(THREADS == HD, "the combine gives each thread one column");

__global__ void __launch_bounds__(THREADS, 2)
flash_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_cache,
                       const __nv_bfloat16* __restrict__ v_cache,
                       const __nv_bfloat16* __restrict__ chunk_k,
                       const __nv_bfloat16* __restrict__ chunk_v,
                       const int* __restrict__ cache_len, const int* __restrict__ t_real,
                       const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters, const Strides st,
                       int T, int nh, int kh, int S, int Tc, int layer, int span, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int ticket;
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int bh = blockIdx.z;
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
  const __nv_bfloat16* kcb = k_cache + lay;
  const __nv_bfloat16* vcb = v_cache + lay;

  // K or V of key tile i (the chunk's tiles first) into its ring stage i %
  // NST; rows past the source's end are zeros. Thread x copies the 16-byte
  // chunk x % 16 of rows x / 16 + 8 k: one swizzled offset, 1024 bytes
  // further for each k (unrolled: on an H100 a strided loop over the tile
  // took 15-20 % longer at the 8- and 32-frame blocks)
  const int cr = threadIdx.x >> 4, cc = threadIdx.x & 15;
  const uint32_t cdst = hp::swizzled(cr, cc, HALF);
  auto load = [&](int i, bool v_tile) {
    const bool chunk = i < nct;
    const __nv_bfloat16* src = v_tile ? (chunk ? cvb : vcb) : (chunk ? ckb : kcb);
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

  // the block's query rows (row = g * T + t; zeros past `rows`) with K and
  // V of tile 0, then K and V of tile 1, each set its own group of copies
  for (int idx = threadIdx.x; idx < BR * 16; idx += THREADS) {
    const int r = idx >> 4, ch = idx & 15;
    const int row = row0 + r;
    const bool ok = row < rows;
    const int g = ok ? row / T : 0, t = ok ? row % T : 0;
    const __nv_bfloat16* src =
        q + (size_t)b * st.q_b + (size_t)t * st.q_t + (size_t)(h * group + g) * HD + ch * 8;
    hp::cp_async16(base + hp::swizzled(r, ch, HALF), src, ok);
  }
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
    hp::cp_async_wait<1>();  // K and V of tile i (and, at i = 0, Q) have landed
    hp::fence_proxy_async();
    __syncthreads();
    float sc[32];
    const uint64_t kdesc = hp::desc_kmajor(base + SM_K + (i % NST) * TILE);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss(sc, qdesc + hp::kstep(kk, HALF), kdesc + hp::kstep(kk, HALF), kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::acc_fence(sc);

    const bool chunk = i < nct;
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
    uint32_t pa[4][4];
    hp::pack_a(pa, sc);
    const uint64_t vdesc = hp::desc_mnmajor(base + SM_V + (i % NST) * TILE, HALF);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::wgmma_rs(acc, pa[kk], vdesc + hp::rowstep(kk));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::acc_fence(acc);
    refill(i);
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
  const size_t all_rows = (size_t)gridDim.z * nsplit * rows;
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
  // in span order
  const int d = threadIdx.x;
  const size_t bh0 = (size_t)bh * nsplit * rows;
  for (int r = row0; r <= last; ++r) {
    float mx = NEG;
    for (int sp = 0; sp < n_live; ++sp)
      mx = fmaxf(mx, __ldcg(part + all_rows * HD + (bh0 + (size_t)sp * rows + r) * 2));
    float lt = 0.f, o = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const size_t at = bh0 + (size_t)sp * rows + r;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(part + all_rows * HD + at * 2));
      const float w = hp::ex2((ml.x - mx) * c);
      lt += w * ml.y;
      o += w * __ldcg(part + at * HD + d);
    }
    out_row(r)[d] = __float2bfloat16_rn(o / fmaxf(lt, 1e-30f));
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

}  // namespace tc

Strides load_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers of bf16 / int32 tensors or of strided views
// of them; `strides` points to the 12 element strides of `Strides`, in its
// order, on the host. B, nh and kh are the view's own (a shard's local)
// counts. The caller checks shapes, dtypes, strides, alignment and hd ==
// 128.
//
// The bf16 cache: `span` is the split's slots (`decode_split_span`); with
// ceil(S / span) > 1 spans, `part` is f32 scratch of B kh ceil(S / span)
// (nh / kh) T (hd + 2) values and `counters` int32 zeros, B kh ceil((nh /
// kh) T / 64) of them, which the kernel leaves zero again.
int flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, void* part, void* counters,
                      const long long* strides, int B, int T, int nh, int kh, int S, int Tc,
                      int layer, int span, float scale, void* stream) {
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      tc::flash_decode_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::SMEM);
  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
  if (span < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (nh / kh) * T;
  const int nsplit = (S + span - 1) / span;
  if (nsplit > 1 && (part == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + tc::BR - 1) / tc::BR, nsplit, B * kh);
  const Strides st = load_strides(strides);
  tc::flash_decode_tc_kernel<<<grid, tc::THREADS, tc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const __nv_bfloat16*>(chunk_k),
      static_cast<const __nv_bfloat16*>(chunk_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(t_real), static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
      st, T, nh, kh, S, Tc, layer, span, scale);
  return static_cast<int>(cudaGetLastError());
}

// The int8-cache variant: k_cache / v_cache are int8 (L, B, kh, S, hd),
// k_scale / v_scale f32 (L, B, kh, S) (or views); everything else as above.
int flash_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, const long long* strides,
                      int B, int T, int nh, int kh, int S, int Tc, int layer,
                      float scale, void* stream) {
  const int rows = (nh / kh) * T;
  const dim3 grid((rows + ROWS - 1) / ROWS, kh, B);
  const Strides st = load_strides(strides);
  flash_decode_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(chunk_k),
      static_cast<const __nv_bfloat16*>(chunk_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(t_real), static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), st, T, nh, kh, S, Tc, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
