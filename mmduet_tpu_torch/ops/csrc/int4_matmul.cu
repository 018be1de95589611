// W4A16 matrix product for Hopper: bf16 activations times group-wise int4
// weights, f32 out.
//
// Replaces the Pallas TPU kernel `mmduet_tpu/ops/quant_matmul.py::int4_matmul`
// (its `_kernel` body). Computes
//   out[r, o] = sum_G  qs[G, o] * ( sum_{i < g} y[r, G g + i] * q[G, i, o] )
// for y (R, H) bf16, the nibble-packed weights qw4 int8 (G, g/2, O) and the
// scales qs bf16 (G, 1, O), H = G g. Byte j of group G holds q[G, j, o] in
// its low nibble and q[G, j + g/2, o] in its high nibble, both 4-bit two's
// complement (the split-halves order of `models/quant.py::pack_int4`).
//
// Numerics (the grouped form): the int4 values are exact in bf16 and in f32,
// so each product y * q is exact in f32; a group's partial sum accumulates
// in f32, is multiplied by the group's scale in f32 and added to the f32
// output sum. The weight is never rounded after scaling. The plain version
// `ops/quant_matmul.py::int4_matmul_ref` does the same arithmetic; only the
// order of the f32 sums differs.
//
// What bounds it: bytes for few rows (a decode step reads every packed
// weight once, H O / 2 bytes, for 2 H O flop per row), operations for the
// multi-frame blocks (R = 392, 1568). The packed tile and its scales are
// decoded in registers / shared memory and never written to device memory,
// so the traffic stays at the packed bytes.
//
// Two kernels, chosen by the row count:
//  * R <= 4, `int4_gemv_kernel`: CUDA cores. A block owns 256 output columns
//    and a range of groups; its 8 warps take the packed rows of a group in
//    turn, each lane loading 8 bytes (8 columns, 16 weights) of a row that
//    the warp reads as one contiguous 256-byte piece. The rows of y for the
//    block's groups sit in shared memory as f32. The warps' sums are added
//    through shared memory in a fixed order.
//  * R > 4, `int4_mma_kernel`: tensor cores, `mma.sync.m16n8k16` (bf16 in,
//    f32 accumulate). A block owns a 64-row by 128-column output tile and a
//    range of groups. Per group it stages the y tile (64 x g bf16) and the
//    packed tile (g/2 x 128 bytes) in shared memory; each thread decodes the
//    nibbles of its B fragments to bf16 (0x4300 | (nibble ^ 8) is 128 + q +
//    8 in bf16; minus 136 is q, exactly). The k order inside a 16-deep step
//    is [8 low-nibble values | 8 high-nibble values] of 8 packed rows, and
//    the A fragments (one ldmatrix each) read y in the same order, so no
//    nibble is shuffled. Each weight is decoded once per 64 rows. Two
//    stages of tiles take turns: cp.async copies the next group's tiles
//    while the tensor cores work on the current group's.
// Blocks share nothing, so where the output tiles alone would leave most of
// the 132 SMs idle the groups are split over `ks` blocks that write f32
// partial outputs, and `int4_reduce_kernel` adds them in a fixed order (no
// atomics: the result does not change from run to run).
//
// Later work: TMA pipelining of the tiles with more stages, wgmma and
// 128-row tiles for the block shapes, and byte-permute nibble-to-bf16
// tricks for the decode path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_G = 128;             // largest group size

// ---------------------------------------------------------------------------
// R <= 4: CUDA cores
// ---------------------------------------------------------------------------

constexpr int V_WARPS = 8;
constexpr int V_THREADS = V_WARPS * 32;
constexpr int V_COLS = 8;              // columns per lane: one 8-byte load
constexpr int V_OT = 32 * V_COLS;      // columns per block
constexpr int V_KC = 1024;             // y values per row staged at a time

template <int RB>
__global__ void __launch_bounds__(V_THREADS)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ qw4,
                 const __nv_bfloat16* __restrict__ qs, float* __restrict__ dst,
                 int R, int H, int O, int g, int gpb) {
  // first the staged rows of y [RB][V_KC], then the warps' sums
  // [V_WARPS][RB][V_OT]; the second use is the larger
  __shared__ __align__(16) float sm[V_WARPS * RB * V_OT];
  float (*ys)[V_KC] = reinterpret_cast<float (*)[V_KC]>(sm);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g2 = g / 2;
  const int G = H / g;
  const int G0 = blockIdx.y * gpb;
  const int G1 = min(G, G0 + gpb);
  const int col0 = blockIdx.x * V_OT + lane * V_COLS;
  const bool live = col0 < O;

  float acc[RB][V_COLS];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < V_COLS; ++c) acc[r][c] = 0.f;

  for (int k0 = G0 * g; k0 < G1 * g; k0 += V_KC) {
    const int n = min(V_KC, G1 * g - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < RB * n; idx += V_THREADS) {
      const int r = idx / n;
      const int kk = idx % n;
      ys[r][kk] = r < R ? __bfloat162float(y[(size_t)r * H + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int kg = 0; kg < n; kg += g) {
      const int Gi = (k0 + kg) / g;
      float tmp[RB][V_COLS];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < V_COLS; ++c) tmp[r][c] = 0.f;
      const int8_t* wrow = qw4 + (size_t)Gi * g2 * O + col0;
#pragma unroll 4
      for (int j = warp; j < g2; j += V_WARPS) {
        const uint2 pk = __ldg(reinterpret_cast<const uint2*>(wrow + (size_t)j * O));
        float ylo[RB], yhi[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          ylo[r] = ys[r][kg + j];
          yhi[r] = ys[r][kg + g2 + j];
        }
#pragma unroll
        for (int c = 0; c < V_COLS; ++c) {
          const uint32_t w = c < 4 ? pk.x : pk.y;
          const int sh = (c % 4) * 8;
          // both nibbles sign-extended: shift the nibble to the top, then
          // an arithmetic shift back
          const float lo = (float)(((int32_t)(w << (28 - sh))) >> 28);
          const float hi = (float)(((int32_t)(w << (24 - sh))) >> 28);
#pragma unroll
          for (int r = 0; r < RB; ++r)
            tmp[r][c] = fmaf(ylo[r], lo, fmaf(yhi[r], hi, tmp[r][c]));
        }
      }
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(qs + (size_t)Gi * O + col0));
      const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
      for (int c2 = 0; c2 < V_COLS / 2; ++c2) {
        const float2 s = __bfloat1622float2(sp[c2]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r][2 * c2] = fmaf(tmp[r][2 * c2], s.x, acc[r][2 * c2]);
          acc[r][2 * c2 + 1] = fmaf(tmp[r][2 * c2 + 1], s.y, acc[r][2 * c2 + 1]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the staged rows of y
  float (*red)[RB][V_OT] = reinterpret_cast<float (*)[RB][V_OT]>(sm);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < V_COLS; ++c) red[warp][r][lane * V_COLS + c] = acc[r][c];
  __syncthreads();
  const int col = blockIdx.x * V_OT + threadIdx.x;
  if (col < O) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= R) break;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < V_WARPS; ++w) sum += red[w][r][threadIdx.x];
      dst[((size_t)blockIdx.y * R + r) * O + col] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// R > 4: tensor cores
// ---------------------------------------------------------------------------

constexpr int M_THREADS = 256;         // 8 warps, each 64 rows x 16 columns
constexpr int BM = 64;
constexpr int BN = 128;
constexpr int YPAD = MAX_G + 8;        // y row stride, 272 bytes: the 8 row pieces
                                       // of 16 bytes that one ldmatrix phase
                                       // reads cover the 32 banks
constexpr int WPAD = BN + 16;          // packed row stride, 36 words: rows 0, 2,
                                       // 4, 6 of a B fragment hit different banks

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two packed bytes (in bits 0-7 and 16-23 of v) to their two B fragment
// registers: the low nibbles as one bf16 pair, the high nibbles as the
// other. For a 4-bit two's complement nibble n, n ^ 8 = q + 8, and the bf16
// bits 0x4300 | (q + 8) are 128 + q + 8 exactly; minus 136 is q.
__device__ __forceinline__ void nibbles_to_bf162(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const uint32_t l = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t h = ((v >> 4) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias);
  const __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), bias);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
}

// The four 8x8 b16 matrices of one A fragment in one instruction: lanes
// 8i .. 8i+7 give the row addresses of matrix i, register i is its fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// One group's tiles in shared memory. Two of these take turns: while the
// tensor cores work on one, cp.async fills the other with the next group.
struct __align__(16) Stage {
  __nv_bfloat16 y[BM][YPAD];           // activations, rows past R are zeros
  uint8_t w[MAX_G / 2][WPAD];          // packed weights, columns past O are zeros
  __nv_bfloat16 s[BN];                 // the group's scales
};
constexpr int MMA_SMEM = 2 * sizeof(Stage);

// 16 bytes from device memory to shared memory, asynchronously; zeros
// instead when `live` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool live) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

// Start the copies of group Gi's tiles into `st` (one commit group).
template <int g>
__device__ __forceinline__ void fetch_group(Stage& st, const __nv_bfloat16* __restrict__ y,
                                            const int8_t* __restrict__ qw4,
                                            const __nv_bfloat16* __restrict__ qs,
                                            int Gi, int r0, int n0, int R, int H, int O) {
  constexpr int g2 = g / 2;
  constexpr int ychunks = g / 8;       // 16-byte pieces per y row
  for (int idx = threadIdx.x; idx < BM * ychunks; idx += M_THREADS) {
    const int row = idx / ychunks;
    const int ch = idx % ychunks;
    const bool live = r0 + row < R;
    cp_async16(&st.y[row][ch * 8],
               live ? y + (size_t)(r0 + row) * H + (size_t)Gi * g + ch * 8 : y, live);
  }
  for (int idx = threadIdx.x; idx < g2 * (BN / 16); idx += M_THREADS) {
    const int row = idx / (BN / 16);
    const int ch = idx % (BN / 16);
    const bool live = n0 + ch * 16 < O;
    cp_async16(&st.w[row][ch * 16],
               live ? qw4 + ((size_t)Gi * g2 + row) * O + n0 + ch * 16 : qw4, live);
  }
  if (threadIdx.x < BN / 8) {
    const bool live = n0 + threadIdx.x * 8 < O;
    cp_async16(&st.s[threadIdx.x * 8],
               live ? qs + (size_t)Gi * O + n0 + threadIdx.x * 8 : qs, live);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// g, the group size, is a template parameter so that the loop over a
// group's k steps unrolls and the next step's loads start early.
template <int g>
__global__ void __launch_bounds__(M_THREADS, 2)
int4_mma_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ qw4,
                const __nv_bfloat16* __restrict__ qs, float* __restrict__ dst,
                int R, int H, int O, int gpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;            // the fragment's row (A, C) or column (B)
  const int tig = lane % 4;
  constexpr int g2 = g / 2;
  const int G = H / g;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int G0 = blockIdx.z * gpb;
  const int G1 = min(G, G0 + gpb);
  // this lane's row address inside an A fragment's four 8x8 matrices: rows
  // 0-7 / 8-15 of the 16-row tile, k slots 0-7 (the low-nibble values) /
  // 8-15 (the high-nibble values, g/2 further along the group)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * g2;

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (G0 < G1) fetch_group<g>(stages[0], y, qw4, qs, G0, r0, n0, R, H, O);
  for (int Gi = G0; Gi < G1; ++Gi) {
    const Stage& st = stages[(Gi - G0) & 1];
    // this group's copies have landed (the only ones in flight), for every
    // thread; and every thread is done with the other stage, which the
    // next group's copies now overwrite while this group is multiplied
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (Gi + 1 < G1)
      fetch_group<g>(stages[(Gi + 1 - G0) & 1], y, qw4, qs, Gi + 1, r0, n0, R, H, O);

    float tmp[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) tmp[mt][nt][i] = 0.f;

#pragma unroll
    for (int ks = 0; ks < g / 16; ++ks) {
      // k slots 0..7 of this step: low nibbles of packed rows ks*8 .. +7
      // (values ks*8 + s); slots 8..15: their high nibbles (values g/2 +
      // ks*8 + s)
      const int j = ks * 8 + tig * 2;
      uint32_t b0[2], b1[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = warp * 16 + nt * 8 + gid;
        const uint32_t byte0 = st.w[j][col];
        const uint32_t byte1 = st.w[j + 1][col];
        nibbles_to_bf162(byte0 | (byte1 << 16), b0[nt], b1[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &st.y[mt * 16 + a_row][ks * 8 + a_col]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma(tmp[mt][nt], a, b0[nt], b1[nt]);
      }
    }
    // the group's scale on its f32 partial sums, then into the output sum
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &st.s[warp * 16 + nt * 8 + tig * 2]));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][nt][0] = fmaf(tmp[mt][nt][0], s.x, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(tmp[mt][nt][1], s.y, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(tmp[mt][nt][2], s.x, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(tmp[mt][nt][3], s.y, acc[mt][nt][3]);
      }
    }
  }

  float* base = dst + (size_t)blockIdx.z * R * O;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + tig * 2;
      if (col >= O) continue;
      const int row = r0 + mt * 16 + gid;
      if (row < R)
        *reinterpret_cast<float2*>(base + (size_t)row * O + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < R)
        *reinterpret_cast<float2*>(base + (size_t)(row + 8) * O + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

template <int g>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const __nv_bfloat16* y, const int8_t* qw4,
                       const __nv_bfloat16* qs, float* dst, int R, int H, int O, int gpb) {
  const cudaError_t err = cudaFuncSetAttribute(
      int4_mma_kernel<g>, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
  if (err != cudaSuccess) return err;
  int4_mma_kernel<g><<<grid, M_THREADS, MMA_SMEM, st>>>(y, qw4, qs, dst, R, H, O, gpb);
  return cudaGetLastError();
}

// out[i] = sum over the ks partial outputs, in order; n4 = R O / 4
__global__ void int4_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                                   size_t n4, int ks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int k = 1; k < ks; ++k) {
    const float4 p = partial[(size_t)k * n4 + i];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first launch's cudaError_t that is
// not 0 (0 = all accepted). y (R, H) bf16, qw4 (H / g, g / 2, O) int8, qs
// (H / g, 1, O) bf16, out (R, O) f32, all contiguous and 16-byte aligned;
// g one of 16, 32, 64, 128 and a divisor of H, O a multiple of 16. With
// ks > 1 the groups are split over ks blocks that write `partial` (ks, R,
// O) f32, which a second kernel adds into `out`; with ks == 1 `partial` is
// not read.
int int4_matmul_bf16(const void* y, const void* qw4, const void* qs, void* out, void* partial,
                     int R, int H, int O, int g, int ks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* yp = static_cast<const __nv_bfloat16*>(y);
  const int8_t* wp = static_cast<const int8_t*>(qw4);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(qs);
  float* dst = static_cast<float*>(ks > 1 ? partial : out);
  const int G = H / g;
  const int gpb = (G + ks - 1) / ks;
  if (R <= 4) {
    const dim3 grid((O + V_OT - 1) / V_OT, ks);
    if (R == 1)
      int4_gemv_kernel<1><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, dst, R, H, O, g, gpb);
    else if (R == 2)
      int4_gemv_kernel<2><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, dst, R, H, O, g, gpb);
    else
      int4_gemv_kernel<4><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, dst, R, H, O, g, gpb);
  } else {
    const dim3 grid((O + BN - 1) / BN, (R + BM - 1) / BM, ks);
    const cudaError_t err =
        g == 128  ? launch_mma<128>(grid, st, yp, wp, sp, dst, R, H, O, gpb)
        : g == 64 ? launch_mma<64>(grid, st, yp, wp, sp, dst, R, H, O, gpb)
        : g == 32 ? launch_mma<32>(grid, st, yp, wp, sp, dst, R, H, O, gpb)
                  : launch_mma<16>(grid, st, yp, wp, sp, dst, R, H, O, gpb);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks <= 1) return static_cast<int>(err);
  const size_t n4 = (size_t)R * O / 4;
  int4_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out), n4, ks);
  return static_cast<int>(cudaGetLastError());
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
