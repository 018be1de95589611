// Non-causal multi-head flash attention for the ViT towers, forward only, for
// Hopper.
//
// Replaces the TPU flash kernel behind `mmduet_tpu/ops/attention.py::
// flash_vision_attention` (called from `siglip._attend`). q, k, v and o are
// (N, T, nh, hd) bf16 and contiguous; every token is real, every query sees
// every key, each head attends on its own: o = softmax(q k^T / sqrt(hd)) v.
// It computes what the TPU kernel computes and is not carried over block by
// block: that wrapper pads hd to 128 and T to a block multiple in device
// memory behind segment ids; here hd is any multiple of 8 up to 128 and T
// is any length, and nothing is padded outside shared memory.
//
// What bounds it on this card: operations. At the serving shape (N = 32
// frames, T = 729 patches, 16 heads of 72) the two products are 4 N nh T^2
// hd = 7.8e10 flop against 215 MB of q, k, v and o. The design keeps the
// T x T scores out of device memory (the plain version writes them in f32,
// 1.1 GB a layer at that shape) and runs both products on the tensor cores
// with `mma.sync.m16n8k16` (bf16 in, f32 accumulate); the online softmax
// stays in f32 registers.
//
// One block per (64-query tile, head, image); 4 warps x 16 query rows. A
// block loops over 64-key tiles of its head's K and V, staged in shared
// memory and shared by the 64 rows.
//   hd = 72 is not a multiple of the 16-deep reduction step of Q K^T: the
//   shared-memory rows are HDP = 16 * ceil(hd / 16) wide and columns [hd,
//   HDP) are zero-filled, so they add nothing to a score; a global row is
//   hd * 2 bytes, a multiple of 16, so the 16-byte loads stay aligned. The
//   P V product's output columns are hd / 8 tiles of 8 (9 for hd = 72): the
//   last of the HDP / 8 tiles is skipped when hd stops short of it.
//   T = 729 is ragged on both sides: query rows at or past T are computed
//   on zeros and never stored; keys at or past T are zero-filled, masked to
//   a finite -1e30 and given an explicit zero probability.
// The softmax scale uses the true hd.
//
// Later work: wgmma / TMA tiles, ldmatrix for the operand reads, exp2 with a
// folded scale, and a second K/V stage so that loads overlap the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;              // query rows per block (16 a warp)
constexpr int BK = 64;              // keys per tile
constexpr float NEG = -1e30f;

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
template <int STRIDE>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* x, int r0, int c0) {
  const int g = frag_g(), c = frag_c();
  a[0] = ld32(x + (r0 + g) * STRIDE + c0 + c);
  a[1] = ld32(x + (r0 + g + 8) * STRIDE + c0 + c);
  a[2] = ld32(x + (r0 + g) * STRIDE + c0 + 8 + c);
  a[3] = ld32(x + (r0 + g + 8) * STRIDE + c0 + 8 + c);
}

// B operand with B[k][n] = X[n0 + n][k0 + k]: the tile used transposed
// (K in Q K^T). Two consecutive bf16 of one row per register.
template <int STRIDE>
__device__ __forceinline__ void ld_bt(uint32_t& b0, uint32_t& b1, const bf16* x,
                                     int n0, int k0) {
  const int g = frag_g(), c = frag_c();
  b0 = ld32(x + (n0 + g) * STRIDE + k0 + c);
  b1 = ld32(x + (n0 + g) * STRIDE + k0 + 8 + c);
}

// B operand with B[k][n] = X[k0 + k][n0 + n]: the tile used as is (V in
// P V). One bf16 from each of two consecutive rows per register.
template <int STRIDE>
__device__ __forceinline__ uint32_t col2(const bf16* p) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + STRIDE);
  return lo | (hi << 16);
}
template <int STRIDE>
__device__ __forceinline__ void ld_b(uint32_t& b0, uint32_t& b1, const bf16* x,
                                    int k0, int n0) {
  const int g = frag_g(), c = frag_c();
  b0 = col2<STRIDE>(x + (k0 + c) * STRIDE + n0 + g);
  b1 = col2<STRIDE>(x + (k0 + 8 + c) * STRIDE + n0 + g);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + 64) of a slab of hd-wide rows, `gstride` elements apart,
// into a row-major smem tile of 16 * KS-wide rows; rows at or past n and
// columns at or past hd are zeros.
template <int KS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t gstride,
                                          int row0, int n, int hd) {
  constexpr int STRIDE = 16 * KS + 8;
  constexpr int CH = 2 * KS;  // 16-byte pieces per smem row
  const int real = hd / 8;    // of them, in the global row
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH;
    const int p = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && p < real)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * gstride + p * 8);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + p * 8) = v;
  }
}

// KS: 16-deep steps across the padded head dim, 16 * KS >= hd > 16 * (KS - 1).
template <int KS>
__global__ void __launch_bounds__(THREADS)
flash_vision_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int T, int nh, int hd, float scale) {
  constexpr int STRIDE = 16 * KS + 8;  // smem row stride in bf16: rows stay 16-byte
                                       // aligned, and the fragment reads of 8 rows x
                                       // 4 words fall on 32 different banks
  constexpr int NT = 2 * KS;           // 8-wide output tiles across the padded hd
  __shared__ __align__(16) bf16 sk[BK * STRIDE];
  __shared__ __align__(16) bf16 sv[BK * STRIDE];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int img = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = frag_g(), c = frag_c();
  const int nt = hd / 8;               // real output tiles: NT or NT - 1
  const size_t rs = (size_t)nh * hd;   // elements between two tokens of one head
  const size_t base = ((size_t)img * T * nh + h) * hd;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // this warp's 16 query rows as A fragments, staged through sk
  load_rows<KS>(sk, qb, rs, q0, T, hd);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ld_a<STRIDE>(qa[kk], sk, warp * 16, kk * 16);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // everyone is done with the previous tile (and qa)
    load_rows<KS>(sk, kb, rs, k0, T, hd);
    load_rows<KS>(sv, vb, rs, k0, T, hd);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        ld_bt<STRIDE>(b0, b1, sk, n * 8, kk * 16);
        mma(s[n], qa[kk], b0, b1);
      }
    }

    // only the last key tile is ragged
    const int live = T - k0;
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + c + (e & 1);
        s[n][e] = col < live ? s[n][e] * scale : NEG;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
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
        if (n < nt) {  // uniform over the block: false only for the last tile
          uint32_t b0, b1;
          ld_b<STRIDE>(b0, b1, sv, j * 16, n * 8);
          mma(acc[n], pa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / quad_sum(l[i]);
    if (row[i] >= T) continue;
    bf16* dst = o + base + (size_t)row[i] * rs;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt)
        *reinterpret_cast<uint32_t*>(dst + n * 8 + c) =
            pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int KS>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N, int T, int nh,
           int hd, float scale, cudaStream_t stream) {
  const dim3 grid((T + BQ - 1) / BQ, nh, N);
  flash_vision_kernel<KS><<<grid, THREADS, 0, stream>>>(q, k, v, o, T, nh, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched; -1 for
// a head dim the kernel does not take). Pointers are device pointers of
// contiguous, 16-byte aligned bf16 (N, T, nh, hd) tensors; hd is a multiple
// of 8 in [8, 128]. The caller checks shapes, dtypes and contiguity.
int flash_vision_bf16(const void* q, const void* k, const void* v, void* o,
                      int N, int T, int nh, int hd, float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  switch ((hd + 15) / 16) {
    case 1: return launch<1>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 2: return launch<2>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 3: return launch<3>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 4: return launch<4>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 5: return launch<5>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 6: return launch<6>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    case 7: return launch<7>(qp, kp, vp, op, N, T, nh, hd, scale, st);
    default: return launch<8>(qp, kp, vp, op, N, T, nh, hd, scale, st);
  }
}

const char* flash_vision_error_string(int code) {
  if (code == -1) return "head dim must be a multiple of 8 in [8, 128]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
