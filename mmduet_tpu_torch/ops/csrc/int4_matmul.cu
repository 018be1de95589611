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
// in f32 from zero, is multiplied by the group's scale in f32 and added to
// the f32 output sum. The weight is never rounded after scaling. The plain
// version `ops/quant_matmul.py::int4_matmul_ref` does the same arithmetic;
// only the order of the f32 sums differs.
//
// What bounds it: bytes for few rows (a decode step reads every packed
// weight once, H O / 2 bytes, for 2 H O flop per row), operations for the
// multi-frame blocks (R = 392, 1568). The packed tile is decoded in
// registers and never written to device memory, so the traffic stays at the
// packed bytes.
//
// Two kernels, chosen by the row count; `ops/quant_matmul.py::int4_plan`
// computes the same cut on the host. Either is one launch a call:
//  * R <= 4, `int4_gemv_kernel`: CUDA cores (a 64-row `wgmma` would waste
//    60 of every 64 rows, and the work is bound by bytes). A block owns 256
//    output columns and a range of groups; its 8 warps take the packed rows
//    of a group in turn, each lane loading 8 bytes (8 columns, 16 weights)
//    of a row that the warp reads as one contiguous 256-byte piece. The rows
//    of y for the block's groups sit in shared memory as f32. The warps'
//    sums are added through shared memory in a fixed order.
//  * R > 4, `int4_wgmma_kernel`: tensor cores, `wgmma.mma_async m64nNk16`
//    (bf16 in, f32 accumulate) with the weights as A, from registers, and y
//    as B, from shared memory. A block is three warpgroups, 192 output
//    columns (64 each, wgmma's M) by N rows of y, N = 64 up to 64 rows and
//    104 above (`int4_plan` picks it; 392 rows: 4 x 104; 104 is what the
//    registers allow, 168 a thread at 384 threads), over a range of k-steps of KC = max(g, 64)
//    values (one group, or 64 / g groups). Thread 0 keeps a four-stage
//    mbarrier ring of TMA loads two steps ahead of the products: per step
//    y's N x KC tile (K-major, 128-byte swizzled; rows past R and columns
//    past H arrive as zeros), the packed tile as [16-column block][packed
//    row][16 bytes] (columns past O arrive as zeros) and the step's scales.
//    Each thread decodes the A fragments of its own two adjacent columns
//    straight from the packed bytes, so every weight is decoded once per
//    block, in registers: two 2-byte loads and a byte permute give a bf16
//    pair's nibbles; the low nibbles of packed rows 16 s + {2t, 2t + 1,
//    2t + 8, 2t + 9} are step s of the group and their high nibbles step
//    s + g / 32, which is the group's natural k order, so y is read as it
//    lies. The decode is 0x4300 | (nibble ^ 8), 128 + q + 8 in bf16, minus
//    136: q exactly. Each group's g / 16 products go into a fresh
//    accumulator (scale-d = 0 on the first); after the wait the total takes
//    acc * qs[G] in f32. The warpgroups only meet at the ring's barriers,
//    so one's decode and rescale run under the others' products.
// Blocks share nothing but a ticket: the k-steps of a tile are split over
// ks blocks where that shortens the call's waves of 132 blocks
// (`int4_plan`). Each writes its f32 partial tile to scratch; the last one
// to take the tile's atomic ticket (it resets the ticket to 0) adds the ks
// partials in split order, so the result is the same in every run.
//
// What holds the tensor-core kernel back (dev calls on an H100 80GB HBM3 at
// 700 W): not its loads (leaving out y's, or the packed tile's, gained
// little) and not its products alone (leaving out the products, or the
// decode, gained somewhat more), but a warpgroup's chain of decode,
// products, wait and rescale, which more warpgroups hide. Later work: a
// persistent grid whose epilogue overlaps the next tile's loads, and the
// k-split's combine spread over more than the last block; wider tiles with
// the scale folded into the decode would free the group accumulator's
// registers, but change the numerics. Tried and slower on that card: a
// decoded bf16 tile in shared memory read by both of two warpgroups,
// clusters of two blocks sharing y by TMA multicast, two 64-row halves a
// warpgroup, two warpgroups with the next group's decode under the
// products, a producer warp beside the warpgroups (the compiler then caps
// a thread as for a whole fourth warpgroup), and, in the GEMV, a
// magic-number f32 decode or a deeper unroll.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = hopper;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Whether this block is the last of the `ks` blocks of its output tile to
// have written its partial (every one of the block's `threads` threads,
// which meet at barrier `bar`, calls it). That block resets `ticket` to 0
// for the next launch.
__device__ __forceinline__ bool last_of_split(int* ticket, int ks, int* flag, int bar,
                                              int threads) {
  __threadfence();  // this thread's partials, visible to the device
  bar_sync(bar, threads);
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    *flag = t == ks - 1;
    if (t == ks - 1) *ticket = 0;
  }
  bar_sync(bar, threads);
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

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
                 const __nv_bfloat16* __restrict__ qs, float* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ tickets, int R, int H, int O,
                 int g, int gpb) {
  // first the staged rows of y [RB][V_KC], then the warps' sums
  // [V_WARPS][RB][V_OT]; the second use is the larger
  __shared__ __align__(16) float sm[V_WARPS * RB * V_OT];
  __shared__ int last_flag;
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
  const int ks = gridDim.y;
  float* dst = ks > 1 ? part + (size_t)blockIdx.y * R * O : out;
  if (col < O) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= R) break;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < V_WARPS; ++w) sum += red[w][r][threadIdx.x];
      dst[(size_t)r * O + col] = sum;
    }
  }
  if (ks == 1 || !last_of_split(tickets + blockIdx.x, ks, &last_flag, 0, V_THREADS)) return;
  // the last block of these columns: the partials in split order
  if (col < O) {
    for (int r = 0; r < R; ++r) {
      float sum = 0.f;
      for (int k = 0; k < ks; ++k) sum += __ldcg(part + ((size_t)k * R + r) * O + col);
      out[(size_t)r * O + col] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// R > 4: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int CWG = 3;                     // warpgroups of a block, 64 output columns each
constexpr int BO = 64 * CWG;               // output columns of a block
constexpr int THREADS = 128 * CWG;         // thread 0 also loads
constexpr int NS = 4;                      // ring stages
constexpr int LAG = 2;                     // a stage is loaded again 2 steps after its use
constexpr int KC_MAX = 128;                // k values of a step
constexpr uint32_t W_BYTES = KC_MAX / 2 * BO;       // packed tile
constexpr uint32_t S_BYTES = (4 * BO * 2 + 1023) / 1024 * 1024;  // up to 4 groups' scales

// Shared memory of a block with BR rows of y (wgmma's N), in bytes from a
// 1024-byte aligned base: stages[NS] (y | packed | scales) | barriers.
template <int BR>
struct Layout {
  static constexpr uint32_t Y_HALF = BR * 128;      // BR rows x 64 bf16
  static constexpr uint32_t Y_BYTES = 2 * Y_HALF;
  static constexpr uint32_t STAGE = Y_BYTES + W_BYTES + S_BYTES;
  static constexpr uint32_t BARS = NS * STAGE;
  static constexpr size_t SMEM = BARS + 16 * NS + 1024;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned for the swizzle");
  static_assert(SMEM <= 232448, "a block may take 227 KB of shared memory");
};

// d (64 x 64, f32) = or += A (64 x 16, bf16 register fragments) * B (64
// x 16, smem, K-major).
__device__ __forceinline__ void wgmma_rk(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 104, f32) = or += A (64 x 16, bf16 register fragments) * B (104
// x 16, smem, K-major).
__device__ __forceinline__ void wgmma_rk(float (&d)[52], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps the A fragments of products in flight where they are until the
// wait that completes the products: wgmma reads them asynchronously.
template <int N>
__device__ __forceinline__ void frag_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Two packed bytes (in bits 0-7 and 16-23 of v) to two bf16 pairs: the low
// nibbles, and the high nibbles. For a 4-bit two's complement nibble n,
// n ^ 8 = q + 8, and the bf16 bits 0x4300 | (q + 8) are 128 + q + 8
// exactly; minus 136 is q.
__device__ __forceinline__ void nibbles_to_bf162(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const uint32_t l = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t h = ((v >> 4) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias);
  const __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), bias);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
}

// The A fragments of one or two of a group's steps from the packed tile,
// in registers. A fragment row is an output column and its k slots are the
// group's natural k, as y's are: slots 2t, 2t + 1 (registers 0, 1) and
// 2t + 8, 2t + 9 (registers 2, 3) of step s hold k = 16 s + those, and the
// rows of a thread, lane / 4 and lane / 4 + 8 of its warp's 16, are the
// adjacent columns 2 (lane / 4) and 2 (lane / 4) + 1. For g >= 32 the low
// nibbles of packed rows 16 s + {2t, 2t + 1, 2t + 8, 2t + 9} are step s (s
// < g / 32) and their high nibbles step s + g / 32 (`lo`, `hi`); for g = 16
// the low nibbles of rows 2t, 2t + 1 are slots 2t, 2t + 1 of the group's
// one step and their high nibbles slots 2t + 8, 2t + 9 (`lo` only). `w`
// points at the thread's two columns of packed row 0 of the group; packed
// rows are 16 bytes apart (a warp's 16 columns), so the four rows a step
// pair reads fall in different banks.
template <int g>
__device__ __forceinline__ void decode_steps(const unsigned char* w, int t, int s,
                                             uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  auto row = [&](int p) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(w + 16 * p));
  };
  if constexpr (g == 16) {
    const uint32_t w0 = row(2 * t), w1 = row(2 * t + 1);
    nibbles_to_bf162(__byte_perm(w0, w1, 0x0400), lo[0], lo[2]);
    nibbles_to_bf162(__byte_perm(w0, w1, 0x0501), lo[1], lo[3]);
  } else {
    const int p = 16 * s + 2 * t;
    const uint32_t w0 = row(p), w1 = row(p + 1), w8 = row(p + 8), w9 = row(p + 9);
    nibbles_to_bf162(__byte_perm(w0, w1, 0x0400), lo[0], hi[0]);
    nibbles_to_bf162(__byte_perm(w0, w1, 0x0501), lo[1], hi[1]);
    nibbles_to_bf162(__byte_perm(w8, w9, 0x0400), lo[2], hi[2]);
    nibbles_to_bf162(__byte_perm(w8, w9, 0x0501), lo[3], hi[3]);
  }
}

// g, the group size, and BR, the block's rows of y, are template
// parameters so that a step's loops unroll.
template <int g, int BR>
__global__ void __launch_bounds__(THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap my, const __grid_constant__ CUtensorMap mw,
                  const __grid_constant__ CUtensorMap ms, float* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ tickets, int R, int H, int O,
                  int per) {
  using L = Layout<BR>;
  constexpr int KC = g > 64 ? g : 64;      // k values of a step
  constexpr int NG = KC / g;               // groups of a step
  constexpr int HALVES = KC / 64;          // 64-wide halves of the y tile
  constexpr int STEPS = g / 16;            // 16-deep products of a group
  constexpr int PAIRS = STEPS > 1 ? STEPS / 2 : 1;
  constexpr int NR = BR / 2;               // accumulator registers of a thread
  constexpr uint32_t TX = HALVES * L::Y_HALF + KC / 2 * BO + NG * BO * 2;
  static_assert(NG <= 4, "the stage holds at most 4 rows of scales");
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_flag;
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t full = base + L::BARS, empty = full + 8 * NS;

  const int o0 = blockIdx.x * BO;
  const int r0 = blockIdx.y * BR;
  const int G = H / g;
  const int c0 = blockIdx.z * per;
  const int n = min((H + KC - 1) / KC, c0 + per) - c0;  // this block's steps, at least 1

  // step j's tiles into stage j % NS, by thread 0
  auto load = [&](int j) {
    const uint32_t st = base + (j % NS) * L::STAGE;
    const uint32_t bar = full + 8 * (j % NS);
    const int k0 = (c0 + j) * KC;
    hp::mbar_expect_tx(bar, TX);
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      hp::tma_load_2d(st + h * L::Y_HALF, &my, bar, k0 + 64 * h, r0);
    hp::tma_load_3d(st + L::Y_BYTES, &mw, bar, 0, k0 / 2, o0 / 16);
    hp::tma_load_2d(st + L::Y_BYTES + W_BYTES, &ms, bar, o0, k0 / g);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, THREADS / 32);  // one arrival from each warp
    }
    hp::fence_barrier_init();
    for (int j = 0; j < min(n, NS - LAG); ++j) load(j);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;       // output columns 16 warp .. + 15
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int oc = warp * 16 + 2 * (lane >> 2);  // this thread's two columns: oc, oc + 1

  // a group's A fragments (`decode_steps`): step kk in frag[kk]
  auto decode = [&](int gi, uint32_t (&frag)[2 * PAIRS][4]) {
    const int j = (gi - c0 * NG) / NG, a = (gi - c0 * NG) % NG;
    // the packed tile is [column block of 16][packed row][16 bytes]
    const unsigned char* w = gbase + (j % NS) * L::STAGE + L::Y_BYTES + warp * (KC / 2 * 16) +
                             2 * (lane >> 2) + a * (g / 2) * 16;
#pragma unroll
    for (int sp = 0; sp < PAIRS; ++sp) decode_steps<g>(w, t, sp, frag[sp], frag[PAIRS + sp]);
  };

  float total[NR], acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) total[i] = acc[i] = 0.f;
  const int g_first = c0 * NG, g_end = min(G, (c0 + n) * NG);
  for (int gi = g_first; gi < g_end; ++gi) {
    const int j = (gi - g_first) / NG, a = (gi - g_first) % NG, s = j % NS;
    // at a step's first group, thread 0 loads step j + NS - LAG into the
    // stage that step j - LAG used, once every warp is done with it
    if (threadIdx.x == 0 && a == 0 && j + NS - LAG < n) {
      if (j >= LAG) hp::mbar_wait(empty + 8 * ((j - LAG) % NS), ((j - LAG) / NS) & 1);
      load(j + NS - LAG);
    }
    if (a == 0) hp::mbar_wait(full + 8 * s, (j / NS) & 1);
    uint32_t frag[2 * PAIRS][4];
    decode(gi, frag);
    // the group's products, from a fresh sum
    const uint64_t ydesc = hp::desc_kmajor(base + s * L::STAGE);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk)
      wgmma_rk(acc, frag[kk], ydesc + hp::kstep(a * STEPS + kk, L::Y_HALF), kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::acc_fence(acc);
    frag_fence(frag);
    // the group's scale on its f32 sums, then into the total: registers
    // 4 n + e hold row 8 n + 2 t + (e & 1), column oc + (e >> 1)
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        gbase + s * L::STAGE + L::Y_BYTES + W_BYTES + (a * BO + oc) * 2));
#pragma unroll
    for (int nn = 0; nn < NR / 4; ++nn) {
      total[4 * nn] = fmaf(acc[4 * nn], f.x, total[4 * nn]);
      total[4 * nn + 1] = fmaf(acc[4 * nn + 1], f.x, total[4 * nn + 1]);
      total[4 * nn + 2] = fmaf(acc[4 * nn + 2], f.y, total[4 * nn + 2]);
      total[4 * nn + 3] = fmaf(acc[4 * nn + 3], f.y, total[4 * nn + 3]);
    }
    if (a == NG - 1 || gi + 1 == g_end) {  // this warp is done with the stage
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + 8 * s);
    }
  }

  const int ks = gridDim.z;
  float* dst = ks > 1 ? part + (size_t)blockIdx.z * R * O : out;
  const int col = o0 + oc;
  if (col < O) {
#pragma unroll
    for (int nn = 0; nn < NR / 4; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * nn + 2 * t + e;
        if (row < R)
          *reinterpret_cast<float2*>(dst + (size_t)row * O + col) =
              make_float2(total[4 * nn + e], total[4 * nn + 2 + e]);
      }
    }
  }
  if (ks == 1 ||
      !last_of_split(tickets + blockIdx.y * gridDim.x + blockIdx.x, ks, &last_flag, 0, THREADS))
    return;
  // the last block of this output tile: the partials in split order
  const int rows = min(BR, R - r0);
  const int cols4 = min(BO, O - o0) / 4;
  const size_t plane = (size_t)R * O;
  for (int idx = threadIdx.x; idx < rows * (BO / 4); idx += THREADS) {
    const int r = idx / (BO / 4), c4 = idx % (BO / 4);
    if (c4 >= cols4) continue;
    const size_t at = (size_t)(r0 + r) * O + o0 + 4 * c4;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(part + at));
    for (int k = 1; k < ks; ++k) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(part + k * plane + at));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    *reinterpret_cast<float4*>(out + at) = sum;
  }
}

// A tensor map of `rank` dimensions (extents from the innermost, the
// strides in bytes of all but the innermost) with a box of `box`; what lies
// past the extents reads as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
              CUtensorMapSwizzle swizzle) {
  const hp::EncodeTiled encode = hp::encoder();
  if (encode == nullptr) return false;
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int g, int BR>
int launch(const void* y, const void* qw4, const void* qs, float* out, float* part,
           int* tickets, int R, int H, int O, int ks, cudaStream_t stream) {
  static const cudaError_t smem_ok =
      cudaFuncSetAttribute(int4_wgmma_kernel<g, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Layout<BR>::SMEM);
  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
  constexpr int KC = g > 64 ? g : 64;
  // y (R, H): 64-column halves of BR rows, 128-byte swizzled; qw4 as
  // (H / 2, O) bytes in blocks of 16 columns: (16 bytes, packed row, column
  // block), so that a warp's 16 columns of a packed row are 16 bytes and
  // its rows 16 bytes apart; qs as (H / g, O). Past R, H and O: zeros.
  const cuuint64_t y_dims[2] = {(cuuint64_t)H, (cuuint64_t)R};
  const cuuint64_t y_strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t y_box[2] = {64, BR};
  const cuuint64_t w_dims[3] = {16, (cuuint64_t)H / 2, (cuuint64_t)O / 16};
  const cuuint64_t w_strides[2] = {(cuuint64_t)O, 16};
  const cuuint32_t w_box[3] = {16, KC / 2, BO / 16};
  const cuuint64_t s_dims[2] = {(cuuint64_t)O, (cuuint64_t)(H / g)};
  const cuuint64_t s_strides[1] = {(cuuint64_t)O * 2};
  const cuuint32_t s_box[2] = {BO, KC / g};
  CUtensorMap my, mw, ms;
  if (!make_map(&my, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, 2, y_dims, y_strides, y_box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw4, 3, w_dims, w_strides, w_box,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qs, 2, s_dims, s_strides, s_box,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  const int units = (H + KC - 1) / KC;
  const int per = (units + ks - 1) / ks;
  const dim3 grid((O + BO - 1) / BO, (R + BR - 1) / BR, (units + per - 1) / per);
  int4_wgmma_kernel<g, BR><<<grid, THREADS, Layout<BR>::SMEM, stream>>>(
      my, mw, ms, out, part, tickets, R, H, O, per);
  return static_cast<int>(cudaGetLastError());
}

template <int g>
int launch_rows(const void* y, const void* qw4, const void* qs, float* out, float* part,
                int* tickets, int R, int H, int O, int ks, int rows, cudaStream_t stream) {
  switch (rows) {
    case 64: return launch<g, 64>(y, qw4, qs, out, part, tickets, R, H, O, ks, stream);
    case 104: return launch<g, 104>(y, qw4, qs, out, part, tickets, R, H, O, ks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches one kernel on `stream` and returns its cudaError_t (0 =
// launched; cudaErrorNotSupported where libcuda's tensor-map encoder is
// missing or refuses an operand). y (R, H) bf16, qw4 (H / g, g / 2, O)
// int8, qs (H / g, 1, O) bf16, out (R, O) f32, all contiguous and 16-byte
// aligned; g one of 16, 32, 64, 128 and a divisor of H, O a multiple of 16.
// `int4_plan` gives ks and, for R > 4, the rows of y a block takes (64 or
// 104). With ks > 1 the k-steps are split over ks blocks: `part` is f32
// scratch of ks R O values and `tickets` int32 zeros, one per output tile,
// which the kernel leaves zero again; with ks == 1 neither is read.
int int4_matmul_bf16(const void* y, const void* qw4, const void* qs, void* out, void* part,
                     void* tickets, int R, int H, int O, int g, int ks, int rows,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* t = static_cast<int*>(tickets);
  if (ks < 1 || (ks > 1 && (p == nullptr || t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 4) {
    switch (g) {
      case 128: return tc::launch_rows<128>(y, qw4, qs, o, p, t, R, H, O, ks, rows, st);
      case 64: return tc::launch_rows<64>(y, qw4, qs, o, p, t, R, H, O, ks, rows, st);
      case 32: return tc::launch_rows<32>(y, qw4, qs, o, p, t, R, H, O, ks, rows, st);
      default: return tc::launch_rows<16>(y, qw4, qs, o, p, t, R, H, O, ks, rows, st);
    }
  }
  const __nv_bfloat16* yp = static_cast<const __nv_bfloat16*>(y);
  const int8_t* wp = static_cast<const int8_t*>(qw4);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(qs);
  const int G = H / g;
  const int gpb = (G + ks - 1) / ks;
  const dim3 grid((O + V_OT - 1) / V_OT, (G + gpb - 1) / gpb);
  if (R == 1)
    int4_gemv_kernel<1><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, o, p, t, R, H, O, g, gpb);
  else if (R == 2)
    int4_gemv_kernel<2><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, o, p, t, R, H, O, g, gpb);
  else
    int4_gemv_kernel<4><<<grid, V_THREADS, 0, st>>>(yp, wp, sp, o, p, t, R, H, O, g, gpb);
  return static_cast<int>(cudaGetLastError());
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
