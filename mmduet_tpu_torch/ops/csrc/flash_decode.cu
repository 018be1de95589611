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
//   The split (flash-decoding), for the shapes a rank's shard gives it (B / D
//   lanes, 4 / M kv heads, so few blocks a row tile): the grid is (row
//   tiles, lanes x kv heads, nsplit), sized from shapes, since the wrapper
//   never reads a cursor (`ops/attention.py::decode_split`). Its choices:
//   - a lane cuts its cache by its own cursor: ceil(cache_len / span_min)
//     spans, at most nsplit, of equal whole 64-slot key tiles
//     (`lane_spans`), so a short cursor still spreads over many blocks and
//     a long one is cut no finer than the scratch sized from S holds;
//   - span_min and nsplit come from the rows of a (lane, head) alone: 128
//     slots and at most 128 spans for one row tile (a decode step), 256 and
//     16 up to 16 tiles (a frame or joiner step), 4096 and 2 up to 64 (an
//     8-frame block splits only past 4096 slots: its 43 tiles a head fill
//     the card at the whole model's heads, and more z-slices without work
//     slowed it by a fifth at 2 kv heads on an H100), one span above (a
//     32-frame block's 172 tiles), never from B or kh, so a shard's (lane,
//     head) computes what it computes in one launch, bit for bit, and A'
//     stays bit-equal to one launch;
//   - the splits are the grid's outer dimension, so the blocks of the first
//     spans, those with work, are dispatched first; a block past its lane's
//     live spans exits at once;
//   - with one live span a block writes its rows; else it writes f32
//     partials (acc, m, l), and one thread's acquire-release ticket after
//     the block's barrier finds the last block of its (lane, head, row
//     tile), which resets the ticket to 0 for the next launch;
//   - that block combines with all its threads, not one warp a row: the
//     spans' (m, l) into shared memory, a warp a row for the weights (a
//     fixed butterfly), then four columns of a row a thread with 32 float4
//     loads in flight, the first already on their way during the weights,
//     each output summed over the spans in order;
//   - more than 16 live spans combine in two levels, so that no one block
//     reads them all: the last block of each group of 16 spans (its own
//     ticket) combines them into a partial in the group's first slots, and
//     the last group's block combines the groups in order.

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

// atomicAdd with acquire and release at the scope of the device: after a
// barrier of the block, one thread's release publishes every thread's
// stores, and its acquire makes the others' visible to the block
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

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
// Spans of a (lane, head) at most; spans combined together, a group (more
// live spans combine in two levels: each group, then the groups); counters
// a (lane, head, row tile): the last level's, then a group's each; float4
// values and (m, l) pairs a thread of the combine has in flight together
constexpr int MAX_SPLIT = 128;
constexpr int GROUP = 16;
constexpr int COUNTERS = 1 + MAX_SPLIT / GROUP;
constexpr int COMBINE_LOADS = 32;
constexpr int ML_LOADS = 4;
static_assert(HD == 4 * 32, "the combine gives each lane four columns");
static_assert(GROUP <= 32 && MAX_SPLIT / GROUP <= 32, "a lane of the weights' warp takes one item");
static_assert((2 * 32 + 2) * BR * sizeof(float) <= 2 * NST * TILE,
              "the combine's (m, l) fit in the key and value stages");

// One level of the combine, by the last block of a (lane, head, row tile) or
// of one of its groups, with all its threads: n items (spans or group
// partials) of nr rows, `acc` item 0's first row of f32 values (HD a row),
// `ml` its (m, l) pair, an item `step` rows further on. `smem` takes the
// items' (m, l) and two values a row. The first values go on their way;
// meanwhile every (item, row)'s (m, l) comes into shared memory, and a warp
// a row, lane j on item j, turns them into w = exp2((m - max m) c) and the
// row's total of w l (a fixed butterfly). Then unit u < nr * 32, four
// columns of row u / 32, goes to thread u % 128, PER units a thread a pass,
// so that a warp reads 512 contiguous bytes of a row; the values of SG items
// are in flight together, and each output sums its items in order.
// `emit(r, u4, o, mx, lt)` takes row r's four columns u4 of the sum; a last
// level divides by the total, a group's writes its partial for the next.
template <int PER, int SG, typename Emit>
__device__ __forceinline__ void combine_level(const float* __restrict__ acc,
                                              const float* __restrict__ ml, size_t step, int n,
                                              int nr, float c, float* smem, Emit emit) {
  float* const w = smem;             // (item, row): m, then w
  float* const l = w + 32 * BR;      // (item, row)
  float* const mrow = l + 32 * BR;   // a row's max m
  float* const lrow = mrow + BR;     // a row's total of w l
  const int lane = threadIdx.x & 31, nu = nr * 32;
  float4 a[SG][PER];
  auto fetch = [&](int u0, int s0) {
#pragma unroll
    for (int j = 0; j < SG; ++j) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int u = u0 + threadIdx.x + THREADS * k;
        a[j][k] = s0 + j < n && u < nu
                      ? __ldcg(reinterpret_cast<const float4*>(
                            acc + ((s0 + j) * step + (u >> 5)) * HD + 4 * (u & 31)))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  fetch(0, 0);
  for (int i0 = threadIdx.x; i0 < n * nr; i0 += ML_LOADS * THREADS) {
    float2 x[ML_LOADS];  // loaded together, then stored
#pragma unroll
    for (int k = 0; k < ML_LOADS; ++k) {
      const int i = i0 + k * THREADS, it = i / nr;
      x[k] = i < n * nr ? __ldcg(reinterpret_cast<const float2*>(
                              ml + (it * step + (i - it * nr)) * 2))
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < ML_LOADS; ++k) {
      const int i = i0 + k * THREADS, it = i / nr;
      if (i < n * nr) {
        w[it * BR + i - it * nr] = x[k].x;
        l[it * BR + i - it * nr] = x[k].y;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < nr; r += THREADS / 32) {
    const bool in = lane < n;
    const float m = in ? w[lane * BR + r] : NEG;
    float mx = m;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    const float wi = in ? hp::ex2((m - mx) * c) : 0.f;
    float lt = in ? wi * l[lane * BR + r] : 0.f;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, x);
    if (in) w[lane * BR + r] = wi;
    if (lane == 0) {
      mrow[r] = mx;
      lrow[r] = lt;
    }
  }
  __syncthreads();
  for (int u0 = 0; u0 < nu; u0 += PER * THREADS) {
    float4 o[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n; s0 += SG) {
      if (u0 > 0 || s0 > 0) fetch(u0, s0);
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        if (s0 + j < n) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const float wk =
                w[(s0 + j) * BR + min((u0 + static_cast<int>(threadIdx.x) + THREADS * k) >> 5,
                                      BR - 1)];
            o[k].x += wk * a[j][k].x;
            o[k].y += wk * a[j][k].y;
            o[k].z += wk * a[j][k].z;
            o[k].w += wk * a[j][k].w;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int u = u0 + threadIdx.x + THREADS * k;
      if (u < nu) emit(u >> 5, u & 31, o[k], mrow[u >> 5], lrow[u >> 5]);
    }
  }
}

// A level of n items, with more units a thread a pass when the items are few.
template <typename Emit>
__device__ __forceinline__ void combine(const float* acc, const float* ml, size_t step, int n,
                                        int nr, float c, float* smem, Emit emit) {
  if (n <= COMBINE_LOADS / 4)
    combine_level<4, COMBINE_LOADS / 4>(acc, ml, step, n, nr, c, smem, emit);
  else
    combine_level<2, COMBINE_LOADS / 2>(acc, ml, step, n, nr, c, smem, emit);
}

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
                       int T, int nh, int kh, int S, int Tc, int layer, int span_min,
                       float scale) {
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
  // the lane's spans: one for every span_min slots of its cursor, at most
  // the grid's nsplit, each the same whole number of key tiles
  int span = S, n_live = 1;  // n_live: the spans that hold live slots
  if (nsplit > 1) {
    const int want = min(nsplit, max(1, (clen + span_min - 1) / span_min));
    span = max(BKT, ((clen + want - 1) / want + BKT - 1) / BKT * BKT);
    n_live = max(1, (clen + span - 1) / span);
  }
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
  // the block's partials are published by one thread's release after the
  // barrier, and the last block's acquire makes every other's visible
  const int n_groups = (n_live + GROUP - 1) / GROUP, g = split / GROUP;
  int* const cnt = counters + ((size_t)bh * gridDim.x + tile) * COUNTERS;
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomic_add_acq_rel(cnt + (n_groups > 1 ? 1 + g : 0), 1);
  __syncthreads();
  const size_t first0 = (size_t)bh * nsplit * rows + row0;
  float* const pa = part + first0 * HD;              // span 0's values
  float* const pm = part + all_rows * HD + first0 * 2;  // and (m, l)
  float* const csm = reinterpret_cast<float*>(sbase + SM_K);
  const int nr = last - row0 + 1;
  auto write_out = [&](int r, int u4, const float4& o, float, float lt) {
    const float d = fmaxf(lt, 1e-30f);
    *reinterpret_cast<uint2*>(out_row(row0 + r) + 4 * u4) =
        make_uint2(hp::pack(o.x / d, o.y / d), hp::pack(o.z / d, o.w / d));
  };
  if (n_groups > 1) {
    // the last block of group g: its spans into a partial in the slots of
    // the group's first span (each value read before it is written over)
    const int g_live = min(GROUP, n_live - g * GROUP);
    if (ticket != g_live - 1) return;
    float* const ga = pa + (size_t)g * GROUP * rows * HD;
    float* const gm = pm + (size_t)g * GROUP * rows * 2;
    combine(ga, gm, rows, g_live, nr, c, csm,
            [&](int r, int u4, const float4& o, float mx, float lt) {
              *reinterpret_cast<float4*>(ga + (size_t)r * HD + 4 * u4) = o;
              if (u4 == 0) *reinterpret_cast<float2*>(gm + 2 * r) = make_float2(mx, lt);
            });
    __syncthreads();
    if (threadIdx.x == 0) {
      cnt[1 + g] = 0;  // ready for the next launch
      ticket = atomic_add_acq_rel(cnt, 1);
    }
    __syncthreads();
    if (ticket != n_groups - 1) return;
    // the last group's block: the groups' partials, in group order
    combine(pa, pm, (size_t)GROUP * rows, n_groups, nr, c, csm, write_out);
  } else {
    if (ticket != n_live - 1) return;
    combine(pa, pm, rows, n_live, nr, c, csm, write_out);
  }
  if (threadIdx.x == 0) cnt[0] = 0;  // ready for the next launch
}

// One launch of the kernel for the cache type INT8 (see flash_decode_bf16).
template <bool INT8>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* chunk_k, const void* chunk_v, const void* cache_len,
           const void* t_real, const void* q_offset, void* out, void* part, void* counters,
           const long long* s, int B, int T, int nh, int kh, int S, int Tc, int layer,
           int span_min, int nsplit, float scale, void* stream) {
  constexpr size_t smem = INT8 ? SMEM_INT8 : SMEM;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      flash_decode_tc_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
  if (span_min < 1 || nsplit < 1 || nsplit > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsplit > 1 && (part == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (nh / kh) * T;
  const dim3 grid((rows + BR - 1) / BR, B * kh, nsplit);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  flash_decode_tc_kernel<INT8><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(chunk_k), static_cast<const __nv_bfloat16*>(chunk_v),
      static_cast<const int*>(cache_len), static_cast<const int*>(t_real),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), st, T, nh, kh, S, Tc, layer,
      span_min, scale);
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
// 128. `span_min` and `nsplit` are the split's (`decode_split`): a lane
// takes one span for every span_min slots of its cursor, at most nsplit (at
// most 128); with nsplit > 1, `part` is f32 scratch of B kh nsplit (nh / kh)
// T (hd + 2) values and `counters` int32 zeros, B kh ceil((nh / kh) T / 64)
// x 9 of them, which the kernel leaves zero again.
int flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, void* part, void* counters,
                      const long long* strides, int B, int T, int nh, int kh, int S, int Tc,
                      int layer, int span_min, int nsplit, float scale, void* stream) {
  return tc::launch<false>(q, k_cache, v_cache, nullptr, nullptr, chunk_k, chunk_v, cache_len,
                           t_real, q_offset, out, part, counters, strides, B, T, nh, kh, S, Tc,
                           layer, span_min, nsplit, scale, stream);
}

// The int8 cache: k_cache / v_cache are int8 (L, B, kh, S, hd), k_scale /
// v_scale f32 (L, B, kh, S) (or views); everything else as above.
int flash_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out, void* part, void* counters,
                      const long long* strides, int B, int T, int nh, int kh, int S, int Tc,
                      int layer, int span_min, int nsplit, float scale, void* stream) {
  return tc::launch<true>(q, k_cache, v_cache, k_scale, v_scale, chunk_k, chunk_v, cache_len,
                          t_real, q_offset, out, part, counters, strides, B, T, nh, kh, S, Tc,
                          layer, span_min, nsplit, scale, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
