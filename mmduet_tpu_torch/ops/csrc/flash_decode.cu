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
// What bounds it: bytes. Every query tile streams the live K/V of its
// (lane, kv head) from device memory / L2 (cache_len * hd * 4 bytes), and a
// decode step (T = 1) does two FMAs per byte read. The design reads only the
// live part of the cache: each block loads its lane's cursors itself and
// loops to cache_len[b], so the buffer's capacity S costs nothing. The layer
// offset into the stacked cache comes from `layer` and the strides; no
// per-layer copy is made.
//
// Design (simple and correct first): one thread block per (query-row tile,
// kv head, lane); 4 warps x 4 query rows; K/V tiles of 64 keys staged in
// shared memory and shared by the 16 rows; f32 online-softmax state
// (m, l, acc) per row, with each lane owning 4 of the 128 output dims.
// Scores use the CUDA cores, not the tensor cores. The chunk is processed
// first so that every real row has a finite running max before any fully
// masked cache tile (masked scores are a finite -1e30, as in the JAX code).
//
// int8 cache (`flash_decode_int8`, the Pallas kernel's `quantized=True`
// variant): the cache holds int8 K/V rows with one f32 scale per (layer,
// lane, head, slot). A tile arrives as int8 (half the bytes, 16 values per
// 16-byte load) and is widened to bf16 in shared memory, exactly; a block
// loads the scales of its own head's slots. The algebra is the reference's:
// the K scale multiplies the score as a column scaling, s = (q . k_int) *
// scale * ks[col]; the V scale is folded into the numerator, acc += (p *
// vs[col]) * v_int; the denominator sums the unscaled p. The chunk stays
// bf16 and goes first.
//
// Later work: a B = 1 decode step launches only 4 (lane, kv-head) programs
// against the H100's 132 SMs. A split over cache blocks with a second
// reduction pass (flash-decoding), and wgmma / TMA for the block-scoring
// shapes, are left to later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// INT8: the cache is int8 with f32 scales (L, B, kh, S); else bf16, and the
// scale pointers are not read.
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_cache,
                    const void* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const __nv_bfloat16* __restrict__ chunk_k,
                    const __nv_bfloat16* __restrict__ chunk_v,
                    const int* __restrict__ cache_len,
                    const int* __restrict__ t_real,
                    const int* __restrict__ q_offset,
                    __nv_bfloat16* __restrict__ out,
                    int B, int T, int nh, int kh, int S, int Tc, int layer,
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
          q + ((size_t)(b * T + t) * nh + h * group + g) * HD);
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

  const size_t head = (size_t)b * kh + h;
  const __nv_bfloat16* ckb = chunk_k + head * Tc * HD;
  const __nv_bfloat16* cvb = chunk_v + head * Tc * HD;
  for (int j0 = 0; j0 < chunk_end; j0 += KT) {
    __syncthreads();
    load_tile(sm, ckb, cvb, j0, chunk_end);
    __syncthreads();
    attend_tile<false>(sm, j0, chunk_end, limit, scale, m, l, acc, sm.p[warp]);
  }

  // cache history: every query row sits after it, so only cache_len masks
  const size_t lay = ((size_t)layer * B + b) * kh + h;
  int no_limit[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) no_limit[r] = clen;
  for (int j0 = 0; j0 < clen; j0 += KT) {
    __syncthreads();
    if constexpr (INT8) {
      load_tile_int8(sm, static_cast<const int8_t*>(k_cache) + lay * S * HD,
                     static_cast<const int8_t*>(v_cache) + lay * S * HD,
                     k_scale + lay * S, v_scale + lay * S, j0, clen);
    } else {
      load_tile(sm, static_cast<const __nv_bfloat16*>(k_cache) + lay * S * HD,
                static_cast<const __nv_bfloat16*>(v_cache) + lay * S * HD, j0, clen);
    }
    __syncthreads();
    attend_tile<INT8>(sm, j0, clen, no_limit, scale, m, l, acc, sm.p[warp]);
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
    *reinterpret_cast<uint2*>(out + ((size_t)(b * T + t) * nh + h * group + g) * HD + lane * 4) =
        packed;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers of contiguous bf16 / int32 tensors; the
// caller checks shapes, dtypes, alignment and hd == 128.
int flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out,
                      int B, int T, int nh, int kh, int S, int Tc, int layer,
                      float scale, void* stream) {
  const int rows = (nh / kh) * T;
  const dim3 grid((rows + ROWS - 1) / ROWS, kh, B);
  flash_decode_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache, nullptr, nullptr,
      static_cast<const __nv_bfloat16*>(chunk_k),
      static_cast<const __nv_bfloat16*>(chunk_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(t_real), static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), B, T, nh, kh, S, Tc, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

// The int8-cache variant: k_cache / v_cache are int8 (L, B, kh, S, hd),
// k_scale / v_scale f32 (L, B, kh, S); everything else as above.
int flash_decode_int8(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* chunk_k, const void* chunk_v,
                      const void* cache_len, const void* t_real,
                      const void* q_offset, void* out,
                      int B, int T, int nh, int kh, int S, int Tc, int layer,
                      float scale, void* stream) {
  const int rows = (nh / kh) * T;
  const dim3 grid((rows + ROWS - 1) / ROWS, kh, B);
  flash_decode_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(chunk_k),
      static_cast<const __nv_bfloat16*>(chunk_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(t_real), static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), B, T, nh, kh, S, Tc, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
