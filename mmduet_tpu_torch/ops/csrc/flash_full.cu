// Causal GQA flash attention over a padded batch, forward and backward, for
// Hopper.
//
// Replaces the stock Pallas TPU flash kernel behind
// `mmduet_tpu/ops/attention.py::flash_full_attention` (the training
// attention of the decoder's full mode), forward and backward. Contract
// (the JAX wrapper's segment ids): key s is visible to query t iff s <= t
// and seg[b, s] == seg[b, t]. Real rows then equal the masked attention
// `causal & mask[s] & mask[t]`; pad rows form their own causal segment, so
// every row sees at least itself and no softmax is empty. q is (B, T, nh,
// hd), k and v are (B, T, kh, hd), all bf16 and contiguous, hd = 128. A q
// head h reads kv head h / (nh / kh): no K/V repeat. T needs no padding to
// a tile multiple; the ragged edge is masked here.
//
// What bounds it on this card: operations. At the training shapes (T up to
// 5924, 28 q heads) the QK^T and PV products are ~4 T^2 hd nh / 2 flop per
// layer, far above the bytes of q, k, v and o. The design keeps the T x T
// scores out of device memory (the plain version writes them in f32) and
// runs every product on the tensor cores with `mma.sync.m16n8k16` (bf16 in,
// f32 accumulate); the softmax and the score algebra stay in f32 registers.
// Key tiles above a query tile's diagonal are never loaded.
//
// Kernels (one entry point and one launch each; all on the caller's stream,
// none allocates):
//   fwd   one block per (64-query tile, q head, lane); 4 warps x 16 rows.
//         Loops over 64-key tiles up to the diagonal with an f32 online
//         softmax; writes O (bf16) and the row log-sum-exp (f32, (B,nh,T)).
//   pre   D = rowsum(dO * O) per (lane, head, row), f32 (B, nh, T).
//   dkdv  one block per (64-key tile, kv head, lane); 4 warps x 16 keys.
//         Loops over the group's q heads and the 32-query tiles at or after
//         the key tile, recomputes P from Q, K and the LSE, and accumulates
//         dV = P^T dO and dK = dS^T Q in f32 registers: the GQA sum happens
//         inside the block, with no atomics.
//   dq    one block per (64-query tile, q head, lane); loops over key tiles
//         up to the diagonal and accumulates dQ = dS K.
// Masked scores get a finite -1e30 and an explicit zero probability, so a
// row whose first tiles are fully masked (left padding) carries m = -1e30,
// l = 0 until its first visible key and never takes exp(0) = 1 from a mask.
//
// Later work: wgmma/TMA tiles, a split of the dK/dV key blocks over q heads
// (the causal load is unbalanced: the first key tile does T/32 query tiles
// per head, the last one), and ldmatrix for the transposed operand reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;             // head dim (the only one supported)
constexpr int STRIDE = HD + 8;      // smem row stride in bf16: 272 B keeps rows
                                    // 16-byte aligned and the fragment reads
                                    // of 8 rows x 4 columns on 32 banks
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;              // query rows per fwd / dq block (16 a warp)
constexpr int BK = 64;              // keys per tile (fwd, dq) and per dkdv block
constexpr int BQB = 32;             // query rows per inner dkdv tile
constexpr int NT = HD / 8;          // 8-wide n-tiles across hd
constexpr int KS = HD / 16;         // 16-deep k-steps across hd
constexpr float NEG = -1e30f;

constexpr size_t DKDV_SMEM = (size_t)(2 * BK + 2 * BQB) * STRIDE * sizeof(bf16)
                             + 3 * BQB * sizeof(float);
constexpr size_t DQ_SMEM = (size_t)(2 * BQ + 2 * BK) * STRIDE * sizeof(bf16)
                           + BK * sizeof(int);

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment coordinates of this lane: g = row group (0..7), c = 2 * column
// pair (0, 2, 4, 6).
__device__ __forceinline__ int frag_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int frag_c() { return 2 * (threadIdx.x & 3); }

// A operand: rows r0.. r0+15, columns c0.. c0+15 of a row-major smem tile.
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* x, int r0, int c0) {
  const int g = frag_g(), c = frag_c();
  a[0] = ld32(x + (r0 + g) * STRIDE + c0 + c);
  a[1] = ld32(x + (r0 + g + 8) * STRIDE + c0 + c);
  a[2] = ld32(x + (r0 + g) * STRIDE + c0 + 8 + c);
  a[3] = ld32(x + (r0 + g + 8) * STRIDE + c0 + 8 + c);
}

// B operand with B[k][n] = X[n0 + n][k0 + k]: the tile used transposed
// (K in Q K^T). Two consecutive bf16 of one row per register.
__device__ __forceinline__ void ld_bt(uint32_t& b0, uint32_t& b1, const bf16* x,
                                     int n0, int k0) {
  const int g = frag_g(), c = frag_c();
  b0 = ld32(x + (n0 + g) * STRIDE + k0 + c);
  b1 = ld32(x + (n0 + g) * STRIDE + k0 + 8 + c);
}

// B operand with B[k][n] = X[k0 + k][n0 + n]: the tile used as is (V in
// P V). One bf16 from each of two consecutive rows per register.
__device__ __forceinline__ uint32_t col2(const bf16* p) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + STRIDE);
  return lo | (hi << 16);
}
__device__ __forceinline__ void ld_b(uint32_t& b0, uint32_t& b1, const bf16* x,
                                    int k0, int n0) {
  const int g = frag_g(), c = frag_c();
  b0 = col2(x + (k0 + c) * STRIDE + n0 + g);
  b1 = col2(x + (k0 + 8 + c) * STRIDE + n0 + g);
}

// Accumulator tiles n = 2j, 2j+1 (16 rows x 16 columns, f32) as the bf16 A
// operand of the next product: the C layout of m16n8 equals the A layout.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows [row0, row0 + ROWS) of a (rows, HD) slab with row stride `gstride`
// elements into a row-major smem tile; rows at or past n are zeros.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t gstride,
                                          int row0, int n) {
  constexpr int CH = HD / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int col = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * gstride + col);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + col) = v;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores an accumulator row pair (columns c, c+1 of each n-tile) as bf16.
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[NT][4], int half,
                                          float mul) {
  const int c = frag_c();
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<uint32_t*>(dst + n * 8 + c) =
        pack(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
}

__global__ void __launch_bounds__(THREADS)
flash_full_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ seg,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int T, int nh, int kh, float scale) {
  __shared__ __align__(16) bf16 sk[BK * STRIDE];
  __shared__ __align__(16) bf16 sv[BK * STRIDE];
  __shared__ int sseg[BK];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (nh / kh);
  const int warp = threadIdx.x >> 5;
  const int g = frag_g(), c = frag_c();
  const size_t qs = (size_t)nh * HD, ks = (size_t)kh * HD;
  const bf16* qb = q + ((size_t)b * T * nh + h) * HD;
  const bf16* kb = k + ((size_t)b * T * kh + hk) * HD;
  const bf16* vb = v + ((size_t)b * T * kh + hk) * HD;
  const int* sg = seg + (size_t)b * T;

  // this warp's 16 query rows as A fragments, staged through sk
  load_rows<BQ>(sk, qb, qs, q0, T);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ld_a(qa[kk], sk, warp * 16, kk * 16);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int rseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rseg[i] = row[i] < T ? sg[row[i]] : 0;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int q_last = min(q0 + BQ, T) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += BK) {
    __syncthreads();  // everyone is done with the previous tile (and qa)
    load_rows<BK>(sk, kb, ks, k0, T);
    load_rows<BK>(sv, vb, ks, k0, T);
    if (threadIdx.x < BK) sseg[threadIdx.x] = k0 + threadIdx.x < T ? sg[k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        ld_bt(b0, b1, sk, n * 8, kk * 16);
        mma(s[n], qa[kk], b0, b1);
      }
    }

    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n * 8 + c + (e & 1);
        const int key = k0 + col;
        const bool vis = key <= row[i] && row[i] < T && key < T && sseg[col] == rseg[i];
        s[n][e] = vis ? s[n][e] * scale : NEG;
        tmax[i] = fmaxf(tmax[i], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(tmax[i]));
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[n][e] = s[n][e] > 0.5f * NEG ? expf(s[n][e] - m[i]) : 0.f;
        rsum[i] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ld_b(b0, b1, sv, j * 16, n * 8);
        mma(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = quad_sum(l[i]);
    if (row[i] >= T) continue;
    store_row(o + ((size_t)b * T + row[i]) * qs + (size_t)h * HD, acc, i, 1.f / denom);
    if ((threadIdx.x & 3) == 0) lse[((size_t)b * nh + h) * T + row[i]] = m[i] + logf(denom);
  }
}

// D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; one warp per row.
__global__ void __launch_bounds__(THREADS)
flash_full_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, int rows, int T, int nh) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint2 ov = *reinterpret_cast<const uint2*>(o + (size_t)r * HD + lane * 4);
  const uint2 dv = *reinterpret_cast<const uint2*>(dout + (size_t)r * HD + lane * 4);
  const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
  const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
  const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.x));
  const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.y));
  float x = o01.x * d01.x + o01.y * d01.y + o23.x * d23.x + o23.y * d23.y;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  if (lane == 0) {
    const int b = r / (T * nh);
    const int t = (r / nh) % T;
    const int h = r % nh;
    delta[((size_t)b * nh + h) * T + t] = x;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_full_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ seg,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int T, int nh, int kh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + BK * STRIDE;
  bf16* sq = sv + BK * STRIDE;
  bf16* sdo = sq + BQB * STRIDE;
  float* slse = reinterpret_cast<float*>(sdo + BQB * STRIDE);
  float* sdel = slse + BQB;
  int* sseg = reinterpret_cast<int*>(sdel + BQB);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nh / kh;
  const int warp = threadIdx.x >> 5;
  const int g = frag_g(), c = frag_c();
  const size_t qs = (size_t)nh * HD, ks = (size_t)kh * HD;
  const int* sg = seg + (size_t)b * T;

  load_rows<BK>(sk, k + ((size_t)b * T * kh + hk) * HD, ks, k0, T);
  load_rows<BK>(sv, v + ((size_t)b * T * kh + hk) * HD, ks, k0, T);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = key[i] < T ? sg[key[i]] : 0;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const bf16* qb = q + ((size_t)b * T * nh + h) * HD;
    const bf16* dob = dout + ((size_t)b * T * nh + h) * HD;
    const float* lse_h = lse + ((size_t)b * nh + h) * T;
    const float* del_h = delta + ((size_t)b * nh + h) * T;
    for (int q0 = k0; q0 < T; q0 += BQB) {
      __syncthreads();  // the previous query tile is consumed
      load_rows<BQB>(sq, qb, qs, q0, T);
      load_rows<BQB>(sdo, dob, qs, q0, T);
      if (threadIdx.x < BQB) {
        const int t = q0 + threadIdx.x;
        slse[threadIdx.x] = t < T ? lse_h[t] : 0.f;
        sdel[threadIdx.x] = t < T ? del_h[t] : 0.f;
        sseg[threadIdx.x] = t < T ? sg[t] : 0;
      }
      __syncthreads();

      // S^T (this warp's 16 keys x 32 queries) = K Q^T
      float p[BQB / 8][4];
#pragma unroll
      for (int n = 0; n < BQB / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4];
        ld_a(ka, sk, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < BQB / 8; ++n) {
          uint32_t b0, b1;
          ld_bt(b0, b1, sq, n * 8, kk * 16);
          mma(p[n], ka, b0, b1);
        }
      }
      // P^T = exp(scale S^T - lse[query]) where visible, else 0
#pragma unroll
      for (int n = 0; n < BQB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = n * 8 + c + (e & 1);
          const int t = q0 + col;
          const bool vis = key[i] <= t && t < T && key[i] < T && sseg[col] == kseg[i];
          p[n][e] = vis ? expf(p[n][e] * scale - slse[col]) : 0.f;
        }
      }
      // dV += P^T dO
#pragma unroll
      for (int j = 0; j < BQB / 16; ++j) {
        uint32_t pa[4];
        c_to_a(pa, p[2 * j], p[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          ld_b(b0, b1, sdo, j * 16, n * 8);
          mma(dva[n], pa, b0, b1);
        }
      }
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D[query])
      float ds[BQB / 8][4];
#pragma unroll
      for (int n = 0; n < BQB / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t va[4];
        ld_a(va, sv, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < BQB / 8; ++n) {
          uint32_t b0, b1;
          ld_bt(b0, b1, sdo, n * 8, kk * 16);
          mma(ds[n], va, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < BQB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - sdel[n * 8 + c + (e & 1)]);
      // dK += dS^T Q (the softmax scale is applied at the store)
#pragma unroll
      for (int j = 0; j < BQB / 16; ++j) {
        uint32_t da[4];
        c_to_a(da, ds[2 * j], ds[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          ld_b(b0, b1, sq, j * 16, n * 8);
          mma(dka[n], da, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T) continue;
    const size_t off = ((size_t)b * T + key[i]) * ks + (size_t)hk * HD;
    store_row(dk + off, dka, i, scale);
    store_row(dv + off, dva, i, 1.f);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_full_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int T, int nh, int kh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + BQ * STRIDE;
  bf16* sk = sdo + BQ * STRIDE;
  bf16* sv = sk + BK * STRIDE;
  int* sseg = reinterpret_cast<int*>(sv + BK * STRIDE);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (nh / kh);
  const int warp = threadIdx.x >> 5;
  const int g = frag_g(), c = frag_c();
  const size_t qs = (size_t)nh * HD, ks = (size_t)kh * HD;
  const bf16* kb = k + ((size_t)b * T * kh + hk) * HD;
  const bf16* vb = v + ((size_t)b * T * kh + hk) * HD;
  const int* sg = seg + (size_t)b * T;

  load_rows<BQ>(sq, q + ((size_t)b * T * nh + h) * HD, qs, q0, T);
  load_rows<BQ>(sdo, dout + ((size_t)b * T * nh + h) * HD, qs, q0, T);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int rseg[2];
  float rlse[2], rdel[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < T;
    rseg[i] = in ? sg[row[i]] : 0;
    rlse[i] = in ? lse[((size_t)b * nh + h) * T + row[i]] : 0.f;
    rdel[i] = in ? delta[((size_t)b * nh + h) * T + row[i]] : 0.f;
  }
  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int q_last = min(q0 + BQ, T) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += BK) {
    __syncthreads();
    load_rows<BK>(sk, kb, ks, k0, T);
    load_rows<BK>(sv, vb, ks, k0, T);
    if (threadIdx.x < BK) sseg[threadIdx.x] = k0 + threadIdx.x < T ? sg[k0 + threadIdx.x] : 0;
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 rows x 64 keys each)
    float p[BK / 8][4], ds[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ld_a(qa, sq, warp * 16, kk * 16);
      ld_a(da, sdo, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        ld_bt(b0, b1, sk, n * 8, kk * 16);
        mma(p[n], qa, b0, b1);
        ld_bt(b0, b1, sv, n * 8, kk * 16);
        mma(ds[n], da, b0, b1);
      }
    }
    // dS = P (dP - D[row]), P = exp(scale S - lse[row]) where visible
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n * 8 + c + (e & 1);
        const int key = k0 + col;
        const bool vis = key <= row[i] && row[i] < T && key < T && sseg[col] == rseg[i];
        const float pe = vis ? expf(p[n][e] * scale - rlse[i]) : 0.f;
        ds[n][e] = pe * (ds[n][e] - rdel[i]);
      }
    }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      c_to_a(a, ds[2 * j], ds[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ld_b(b0, b1, sk, j * 16, n * 8);
        mma(dqa[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T) continue;
    store_row(dq + ((size_t)b * T + row[i]) * qs + (size_t)h * HD, dqa, i, scale);
  }
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns the launch's
// cudaError_t (0 = accepted). Pointers are device pointers
// of contiguous tensors: q, o, dout, dq (B, T, nh, 128) bf16; k, v, dk, dv
// (B, T, kh, 128) bf16; seg (B, T) int32; lse, delta (B, nh, T) f32. The
// caller checks shapes, dtypes, alignment and nh % kh == 0.

int flash_full_fwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                        void* o, void* lse, int B, int T, int nh, int kh, float scale,
                        void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, nh, B);
  flash_full_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(lse), T, nh,
      kh, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward is three launches, in this order: the preprocess (D), then
// dK/dV and dQ, which both read D.
int flash_full_bwd_pre_bf16(const void* o, const void* dout, void* delta, int B, int T,
                            int nh, void* stream) {
  const int rows = B * T * nh;
  flash_full_pre_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows, T, nh);
  return static_cast<int>(cudaGetLastError());
}

int flash_full_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int T, int nh, int kh, float scale,
                             void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_full_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_full_dkdv_kernel<<<dim3((T + BK - 1) / BK, kh, B), THREADS, DKDV_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, nh, kh, scale);
  return static_cast<int>(cudaGetLastError());
}

int flash_full_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg,
                           const void* dout, const void* lse, const void* delta, void* dq,
                           int B, int T, int nh, int kh, float scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_full_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_full_dq_kernel<<<dim3((T + BQ - 1) / BQ, nh, B), THREADS, DQ_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, nh, kh, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_full_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
