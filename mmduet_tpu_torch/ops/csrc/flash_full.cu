// Causal GQA flash attention over a padded batch, forward and backward, for
// Hopper (sm_90a): TMA loads, mbarrier rings and `wgmma` products.
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
// a tile multiple: TMA fills the rows past T with zeros and the kernels
// mask them.
//
// What bounds it on this card: operations. At the training shapes (T up to
// 5924, 28 q heads) the forward is 2 T^2 hd nh flop per layer and the
// backward twice that at least, far above the bytes of q, k, v and o. The
// T x T scores never reach device memory (the plain version writes them in
// f32). The backward recomputes S and dP in both of its large kernels (7
// products against the 4 the bound counts): fusing dQ into the dK/dV kernel
// would need float atomics on dQ and lose the fixed summation order, so the
// reachable floor of the backward is 7/4 of its bound.
//
// Design, the same in all three large kernels. A block is two warpgroups
// (256 threads, so that each thread may hold 255 registers: with a third
// warpgroup for a producer warp the compiler keeps every thread within 168
// whatever `setmaxnreg` asks for, and the backward's four accumulators
// spill). Each warpgroup owns 64 rows of the block's 128-row resident tile
// (queries in fwd and dq, keys in dkdv) and runs every product as
// `wgmma.mma_async` m64nNk16 (bf16 in, f32 accumulate): operands from
// 128-byte-swizzled shared memory, P and dS fed from registers as the A
// operand, and the untransposed tiles (V in P V, dO in P^T dO, Q in dS^T Q,
// K in dS K) through the descriptor's MN-major form, so nothing is
// transposed by hand. The streamed tiles go through a ring in shared memory
// that TMA fills (tile loads, and bulk copies of the tile's segment ids and
// row statistics) and mbarriers guard: a `full` barrier per stage that the
// loads complete, a `free` barrier that all threads arrive on when the
// stage's products have finished. Thread 0 starts the loads, and only at
// points where none of its warpgroup's products are in flight (a branch that
// some threads take, between a product's start and its wait, makes the
// compiler wait after every single `wgmma`); it refills a stage one tile
// after its release, so the other warpgroup may lag a tile behind without
// stopping it. The softmax runs on exp2 with scale * log2(e) folded into
// one fma per score. The visibility test runs only on tiles that need it: a
// warp decides for its own 16 rows by a vote (the tile lies on the diagonal,
// or the rows' and the tile's segment ids are not one and the same id).
// Blocks are ordered heaviest first.
//
// One warpgroup alone keeps the tensor cores half busy at these widths (a
// 64 x 128 x 16 step takes it 128 cycles, measured), so a warpgroup's
// products must run beside the other's or under its own arithmetic: the
// forward starts O += P(j-1) V(j-1) behind S(j) and does tile j's softmax
// under it; dkdv and dq leave a tile's last products in flight into the
// next tile's first.
//
// Kernels (one entry point and one launch each; all on the caller's stream,
// none allocates):
//   fwd    block = (q head, 128-query tile, lane). Streams 128-key K and V
//          tiles up to the diagonal through two three-stage rings (224 KB of
//          shared memory with the resident Q); f32 online softmax; writes O
//          (bf16) and the row log-sum-exp in natural-log units (f32,
//          (B, nh, T)).
//   pre    row statistics for the backward, (2, B, nh, T padded to 128) f32:
//          the LSE in log2 units and D = rowsum(dO * O), zeros past T, so
//          that a tile's run of them is one aligned bulk copy.
//   dkdv   block = (q head, 128-key tile, lane): the GQA group's q heads are
//          split over blocks, so T/128 * nh blocks of graded weight are in
//          flight (644 at T = 2944 on 132 SMs). K and V stay resident; Q,
//          dO, LSE and D of 64-query tiles from the diagonal on stream
//          through a four-stage ring. Computes S^T = K Q^T and dP^T =
//          V dO^T directly, so P^T and dS^T are the register A operands of
//          dV += P^T dO and dK += dS^T Q. Writes its f32 partial dK and dV
//          into scratch (2, B, T, nh, 128): 170 MB at B = 1, T = 5924.
//   reduce sums the group's partials in q-head order (a fixed order: two
//          runs give the same bits; no float atomics anywhere), applies the
//          softmax scale to dK and writes bf16 dK and dV.
//   dq     block = (q head, 128-query tile, lane); Q and dO resident, 128-key
//          K and V tiles streamed through a two-stage ring; dQ += dS K.
// Masked scores get a finite -1e30, and a row whose keys so far are all
// masked (left padding) keeps m = -1e30, l = 0 and takes a zero from the
// exponent, never exp(0) = 1 from a mask. Rows past T arrive as zeros and
// carry the segment id -2; what they compute is finite and never stored.
//
// A wait on an mbarrier that lasts a few seconds traps, so a lost arrival
// shows as a failed launch and not as a hung device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;             // head dim (the only one supported)
constexpr int BM = 128;             // rows of a block's resident tile, 64 a consumer warpgroup
constexpr int BKV = 128;            // keys per streamed tile (fwd, dq)
constexpr int BQS = 64;             // queries per streamed tile (dkdv)
constexpr int NSF = 3;              // ring stages of the forward (K and V rings)
constexpr int NSQ = 2;              // ring stages of dq (K and V together)
constexpr int NSB = 4;              // ring stages of dkdv (Q, dO and the rows' statistics)
constexpr int THREADS = 256;        // two warpgroups; thread 0 also starts the loads
constexpr int PRE_WARPS = 4;        // rows per block of the preprocess kernel
constexpr uint32_t HALF128 = 128 * 128;  // bytes of 128 rows x 64 columns (one swizzle-wide half)
constexpr uint32_t HALF64 = 64 * 128;    // bytes of 64 rows x 64 columns
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory plans, in bytes from a 1024-byte aligned base (the swizzle
// pattern repeats every 1024 bytes, so every tile starts on a multiple).
constexpr uint32_t TILE128 = 2 * HALF128;  // a 128 x 128 bf16 tile
constexpr uint32_t TILE64 = 2 * HALF64;    // a 64 x 128 bf16 tile
// fwd: Q | K[NSF] | V[NSF] | ids[NSF][128] | barriers
constexpr uint32_t FWD_K = TILE128;
constexpr uint32_t FWD_V = FWD_K + NSF * TILE128;
constexpr uint32_t FWD_SEG = FWD_V + NSF * TILE128;
constexpr uint32_t FWD_BARS = FWD_SEG + NSF * BKV * 4;
constexpr size_t FWD_SMEM = FWD_BARS + 128 + 1024;
// dq: Q | dO | K[NSQ] | V[NSQ] | ids[NSQ][128] | barriers
constexpr uint32_t DQ_DO = TILE128;
constexpr uint32_t DQ_K = 2 * TILE128;
constexpr uint32_t DQ_V = DQ_K + NSQ * TILE128;
constexpr uint32_t DQ_SEG = DQ_V + NSQ * TILE128;
constexpr uint32_t DQ_BARS = DQ_SEG + NSQ * BKV * 4;
constexpr size_t DQ_SMEM = DQ_BARS + 128 + 1024;
// dkdv: K | V | Q[NSB] | dO[NSB] | (lse2, D, ids)[NSB][64] | barriers
constexpr uint32_t AUX_BYTES = 3 * BQS * 4;
constexpr uint32_t DKV_V = TILE128;
constexpr uint32_t DKV_Q = 2 * TILE128;
constexpr uint32_t DKV_DO = DKV_Q + NSB * TILE64;
constexpr uint32_t DKV_AUX = DKV_DO + NSB * TILE64;
constexpr uint32_t DKV_BARS = DKV_AUX + NSB * AUX_BYTES;
constexpr size_t DKV_SMEM = DKV_BARS + 128 + 1024;
static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 && DKV_SMEM <= 232448,
              "a block may take 227 KB of shared memory");

// The sequence length that segment ids and row statistics are padded to, so
// that every tile's run of them starts on a 16-byte boundary for a bulk copy.
inline int padded_len(int T) { return (T + BM - 1) / BM * BM; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 4000000000LL) __trap();
  } while (!done);
}

// Makes the barriers' initial state visible to the TMA unit.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}

// Rows [row0, row0 + box rows) of head `head`, lane `b`, all 128 columns, as
// two 64-column halves `half` bytes apart; rows past T arrive as zeros.
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t half, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0, int b) {
  tma_load(dst, map, bar, 0, head, row0, b);
  tma_load(dst + half, map, bar, 64, head, row0, b);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on the barrier like a tile load.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// In dkdv the two warpgroups take turns at a tile's first products: one
// starts them when the other's have finished, so that they run under the
// other's exponentials instead of beside its products. Named barriers 1 and
// 2 hand the turn over; warpgroup 1 gives the first turn away before its
// loop. (In fwd and dq the turns cost more than they save.)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}

// Pins the accumulators behind the wait that completes them: without it the
// compiler may read them before the asynchronous product has written them.
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled tile whose rows are 128 bytes (64 bf16)
// wide, 8-row groups 1024 bytes apart. K-major: the rows are the M or N index
// and the product runs along the row; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// MN-major: the rows are the product's K index (8-row groups 1024 bytes
// apart) and the 128 columns, two halves `half` bytes apart, are N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t half) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(half >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Offset, in descriptor units of 16 bytes, of the kk-th 16-column step
// across hd = 128 in a K-major tile of two halves.
__device__ __forceinline__ uint64_t kstep(int kk, uint32_t half) {
  return (uint64_t)(((kk >> 2) * half + (kk & 3) * 32) >> 4);
}

// d (64 x 64, f32) = or += A (64 x 16, smem) * B (64 x 16, smem, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) = or += A (64 x 16, smem) * B (128 x 16, smem, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 register fragments) * B (16 x 128,
// smem, MN-major: the tile is used untransposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) = A (64 rows of a K-major tile) * B^T (N rows of a K-major
// tile) over hd = 128; the halves of A and B are ahalf and bhalf bytes apart.
template <int NR>
__device__ __forceinline__ void gemm_ss(float (&d)[NR], uint64_t a, uint32_t ahalf, uint64_t b,
                                        uint32_t bhalf) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(d, a + kstep(kk, ahalf), b + kstep(kk, bhalf), kk);
}

// d (64 x 128) += A (64 x 16 KSTEPS, register fragments) * B (16 KSTEPS rows
// of an MN-major tile).
template <int KSTEPS>
__device__ __forceinline__ void gemm_rs(float (&d)[64], const uint32_t (&a)[KSTEPS][4],
                                        uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_rs(d, a[kk], b + (uint64_t)(kk * ((16 * 128) >> 4)));
}

// A 64 x (2 NR) f32 accumulator as the bf16 A fragments of the next product:
// the accumulator layout of two 8-column blocks is the A layout of one
// 16-deep step.
template <int NR>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NR / 8][4], const float (&x)[NR]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk) {
    a[kk][0] = pack(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// ---- what every kernel's threads share ----------------------------------------

// Thread coordinates: warpgroup, the row of the warpgroup's 64 that this
// thread's accumulator pair starts at (second row: + 8), and the first of
// its two columns in every 8-column block.
struct Lane {
  int wg, row, col, lane;
  __device__ Lane() {
    const int t = threadIdx.x;
    wg = t >> 7;
    lane = t & 31;
    row = ((t >> 5) & 3) * 16 + (lane >> 2);
    col = 2 * (t & 3);
  }
};

// The segment id that this warp's 16 rows share (ids a, b of this thread's
// two rows), or -1 where they differ or lie past T (where the id is -2).
__device__ __forceinline__ int warp_rows_id(int a, int b) {
  const int first = __shfl_sync(0xffffffffu, a, 0);
  return __all_sync(0xffffffffu, a == first && b == first) ? first : -1;
}

// The segment id that the N staged ids of a streamed tile share (-2, past T,
// counts as any id), or -1 where they differ. Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ int tile_id(const int* ids, int lane) {
  const int first = ids[0];
  bool same = true;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int id = ids[lane + 32 * i];
    same = same && (id == first || id == -2);
  }
  return __all_sync(0xffffffffu, same) ? first : -1;
}

// ---- forward ----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_full_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const int* __restrict__ seg,
                      bf16* __restrict__ o, float* __restrict__ lse, int T, int Tp, int nh,
                      int kh, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  const int* sseg = reinterpret_cast<const int*>(sm + FWD_SEG);
  const uint32_t bars = base + FWD_BARS;
  const uint32_t bar_q = bars, bar_k = bars + 8, bar_v = bar_k + 8 * NSF,
                 bar_k_free = bar_v + 8 * NSF, bar_v_free = bar_k_free + 8 * NSF;

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) query tiles first
  const int b = blockIdx.z;
  const int hk = h / (nh / kh);
  const int q0 = qt * BM;
  const int nk = qt + 1;  // key tiles up to the diagonal
  const int* sg = seg + (size_t)b * Tp;
  const bool loader = threadIdx.x == 0;

  auto load_k = [&](int t) {  // K and the segment ids of key tile t
    const int s = t % NSF;
    mbar_expect_tx(bar_k + 8 * s, TILE128 + BKV * 4);
    load_tile(base + FWD_K + s * TILE128, HALF128, &mk, bar_k + 8 * s, hk, t * BKV, b);
    bulk_load(base + FWD_SEG + s * BKV * 4, sg + t * BKV, BKV * 4, bar_k + 8 * s);
  };
  auto load_v = [&](int t) {
    const int s = t % NSF;
    mbar_expect_tx(bar_v + 8 * s, TILE128);
    load_tile(base + FWD_V + s * TILE128, HALF128, &mv, bar_v + 8 * s, hk, t * BKV, b);
  };

  if (loader) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSF; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_free + 8 * s, THREADS);
      mbar_init(bar_v_free + 8 * s, THREADS);
    }
    fence_barrier_init();
    mbar_expect_tx(bar_q, TILE128);
    load_tile(base, HALF128, &mq, bar_q, h, q0, b);
    for (int t = 0; t < min(NSF, nk); ++t) {
      load_k(t);
      load_v(t);
    }
  }
  __syncthreads();

  const Lane ln;
  const int row[2] = {q0 + ln.wg * 64 + ln.row, q0 + ln.wg * 64 + ln.row + 8};
  const int rseg[2] = {sg[row[0]], sg[row[1]]};  // -2 past T: the ids are padded to Tp
  const int qid = warp_rows_id(rseg[0], rseg[1]);
  const float c = scale * LOG2E;
  const uint64_t qdesc = desc_kmajor(base + ln.wg * (64 * 128));

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t pa[8][4];  // the previous tile's probabilities, bf16 A fragments

  // Tile j's softmax on its scores sc (f32, in place: they become the
  // probabilities): the mask where the tile needs one, the running maximum
  // and sum, and alpha, the factor that O takes for the new maximum.
  auto softmax = [&](int j, float (&sc)[64], float (&alpha)[2]) {
    const int s = j % NSF;
    const int k0 = j * BKV;
    const int* ss = sseg + s * BKV;
    const int kid = tile_id<BKV>(ss, ln.lane);
    if (j == qt || kid != qid || qid < 0) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = n * 8 + ln.col + (e & 1);
          if (!((k0 + col <= row[i]) & (ss[col] == rseg[i]))) sc[4 * n + e] = NEG;
        }
      }
    }
    mbar_arrive(bar_k_free + 8 * s);
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      tmax[0] = fmaxf(tmax[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    float mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(tmax[i]));
      alpha[i] = ex2((m[i] - mn) * c);
      m[i] = mn;
      // a row with no visible key yet subtracts 0, so its masked scores
      // give exp2(-1e30 c) = 0 and not exp2(0)
      mc[i] = mn > 0.5f * NEG ? mn * c : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], c, -mc[i]));
        rsum[i] += sc[4 * n + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
  };

  mbar_wait(bar_q, 0);
  {  // tile 0: O is still zero
    float sc[64], alpha[2];
    mbar_wait(bar_k, 0);
    wgmma_fence();
    gemm_ss(sc, qdesc, HALF128, desc_kmajor(base + FWD_K), HALF128);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(sc);
    softmax(0, sc, alpha);
    pack_a(pa, sc);
  }
  for (int j = 1; j < nk; ++j) {
    const int s = j % NSF, sp = (j - 1) % NSF;
    // S(j) = Q K(j)^T, and behind it O += P(j-1) V(j-1), which runs under
    // this tile's softmax. Nothing but the softmax sits between the start and
    // the wait: the loads, and every branch that only some threads take, come
    // after it (the compiler would otherwise wait after every single product).
    float sc[64], alpha[2];
    mbar_wait(bar_k + 8 * s, (j / NSF) & 1);
    mbar_wait(bar_v + 8 * sp, ((j - 1) / NSF) & 1);
    wgmma_fence();
    gemm_ss(sc, qdesc, HALF128, desc_kmajor(base + FWD_K + s * TILE128), HALF128);
    wgmma_commit();
    gemm_rs(acc, pa, desc_mnmajor(base + FWD_V + sp * TILE128, HALF128));
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence(sc);
    softmax(j, sc, alpha);
    wgmma_wait<0>();
    acc_fence(acc);
    mbar_arrive(bar_v_free + 8 * sp);
    // the loader refills a stage one tile after its release, so that the
    // other warpgroup may lag a tile behind without stopping this one
    if (loader && j - 1 + NSF < nk) {
      mbar_wait(bar_k_free + 8 * sp, ((j - 1) / NSF) & 1);
      load_k(j - 1 + NSF);
    }
    if (loader && j >= 2 && j - 2 + NSF < nk) {
      mbar_wait(bar_v_free + 8 * ((j - 2) % NSF), ((j - 2) / NSF) & 1);
      load_v(j - 2 + NSF);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    pack_a(pa, sc);
  }
  {
    const int s = (nk - 1) % NSF;
    mbar_wait(bar_v + 8 * s, ((nk - 1) / NSF) & 1);
    wgmma_fence();
    gemm_rs(acc, pa, desc_mnmajor(base + FWD_V + s * TILE128, HALF128));
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = quad_sum(l[i]);
    if (row[i] >= T) continue;
    const float inv = 1.f / denom;
    bf16* dst = o + (((size_t)b * T + row[i]) * nh + h) * HD + ln.col;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    if (ln.col == 0) lse[((size_t)b * nh + h) * T + row[i]] = (m[i] * c + log2f(denom)) * LN2;
  }
}

// ---- backward: D = rowsum(dO * O), and the LSE in log2 units -------------------

// One warp per (lane, row, head) of the padded sequence: rowstats[0][b, h, t]
// = lse[b, h, t] log2(e) and rowstats[1][b, h, t] = sum_d dO[b, t, h, d] *
// O[b, t, h, d] for t < T, zeros for T <= t < Tp. Both are (B, nh, Tp) f32,
// so every 64-row run of them starts on a 256-byte boundary.
__global__ void __launch_bounds__(PRE_WARPS * 32)
flash_full_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ rowstats, int rows,
                      int B, int T, int Tp, int nh) {
  const int r = blockIdx.x * PRE_WARPS + (threadIdx.x >> 5);  // (b * Tp + t) * nh + h
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int b = r / (Tp * nh);
  const int t = (r / nh) % Tp;
  const int h = r % nh;
  float x = 0.f;
  if (t < T) {
    const size_t at = (((size_t)b * T + t) * nh + h) * HD + lane * 4;
    const uint2 ov = *reinterpret_cast<const uint2*>(o + at);
    const uint2 dv = *reinterpret_cast<const uint2*>(dout + at);
    const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
    const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
    const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.x));
    const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.y));
    x = o01.x * d01.x + o01.y * d01.y + o23.x * d23.x + o23.y * d23.y;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  }
  if (lane == 0) {
    const size_t at = ((size_t)b * nh + h) * Tp + t;
    rowstats[at] = t < T ? lse[((size_t)b * nh + h) * T + t] * LOG2E : 0.f;
    rowstats[(size_t)B * nh * Tp + at] = x;
  }
}

// ---- backward: per-q-head partial dK and dV -------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_full_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo, const int* __restrict__ seg,
                       const float* __restrict__ rowstats, float* __restrict__ dk_part,
                       float* __restrict__ dv_part, int B, int T, int Tp, int nh, int kh,
                       float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  const float* aux = reinterpret_cast<const float*>(sm + DKV_AUX);  // per stage: lse2, D, ids
  const uint32_t bars = base + DKV_BARS;
  const uint32_t bar_kv = bars, bar_full = bars + 8, bar_free = bar_full + 8 * NSB;

  const int h = blockIdx.x;
  const int kt = blockIdx.y;  // the first key tiles meet the most queries: heaviest first
  const int b = blockIdx.z;
  const int hk = h / (nh / kh);
  const int k0 = kt * BM;
  const int it0 = 2 * kt;                    // first 64-query tile at the diagonal
  const int nq = (T + BQS - 1) / BQS - it0;  // query tiles from there on
  const int* sg = seg + (size_t)b * Tp;
  const float* lse2_h = rowstats + ((size_t)b * nh + h) * Tp;
  const float* del_h = lse2_h + (size_t)B * nh * Tp;
  const bool loader = threadIdx.x == 0;

  auto load = [&](int it) {  // Q, dO, lse2, D and the segment ids of query tile it0 + it
    const int s = it % NSB;
    const int q0 = (it0 + it) * BQS;
    const uint32_t bar = bar_full + 8 * s, a = base + DKV_AUX + s * AUX_BYTES;
    mbar_expect_tx(bar, 2 * TILE64 + AUX_BYTES);
    load_tile(base + DKV_Q + s * TILE64, HALF64, &mq, bar, h, q0, b);
    load_tile(base + DKV_DO + s * TILE64, HALF64, &mdo, bar, h, q0, b);
    bulk_load(a, lse2_h + q0, BQS * 4, bar);
    bulk_load(a + BQS * 4, del_h + q0, BQS * 4, bar);
    bulk_load(a + 2 * BQS * 4, sg + q0, BQS * 4, bar);
  };

  if (loader) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NSB; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, THREADS);
    }
    fence_barrier_init();
    mbar_expect_tx(bar_kv, 2 * TILE128);
    load_tile(base, HALF128, &mk, bar_kv, hk, k0, b);
    load_tile(base + DKV_V, HALF128, &mv, bar_kv, hk, k0, b);
    for (int it = 0; it < min(NSB, nq); ++it) load(it);
  }
  __syncthreads();

  const Lane ln;
  const int kw0 = k0 + ln.wg * 64;  // this warpgroup's first key
  const int key[2] = {kw0 + ln.row, kw0 + ln.row + 8};
  const int kseg[2] = {sg[key[0]], sg[key[1]]};  // -2 past T
  const int kid = warp_rows_id(kseg[0], kseg[1]);
  const int warp_last_key = kw0 + (ln.row | 7) + 8;
  const float c = scale * LOG2E;
  const uint64_t kdesc = desc_kmajor(base + ln.wg * (64 * 128));
  const uint64_t vdesc = desc_kmajor(base + DKV_V + ln.wg * (64 * 128));

  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_kv, 0);
  if (ln.wg == 1) turn_pass(1);
  int busy = -1;  // the stage that the products in flight still read
  for (int it = 0; it < nq; ++it) {
    const int s = it % NSB;
    const int q0 = (it0 + it) * BQS;
    mbar_wait(bar_full + 8 * s, (it / NSB) & 1);
    turn_wait(ln.wg);
    if (q0 + BQS - 1 < kw0) {  // every query of the tile precedes every key here
      turn_pass(ln.wg);
      mbar_arrive(bar_free + 8 * s);
      continue;
    }
    const uint32_t sq = base + DKV_Q + s * TILE64, sdo = base + DKV_DO + s * TILE64;
    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each), queued
    // behind the previous tile's dV and dK products
    float p[32], dp[32];
    wgmma_fence();
    gemm_ss(p, kdesc, HALF128, desc_kmajor(sq), HALF64);
    gemm_ss(dp, vdesc, HALF128, desc_kmajor(sdo), HALF64);
    wgmma_commit();
    wgmma_wait<0>();
    turn_pass(ln.wg);
    acc_fence(p);
    acc_fence(dp);
    if (busy >= 0) mbar_arrive(bar_free + 8 * busy);
    busy = s;
    // the loader refills a stage one tile after its release, so that the
    // other warpgroup may lag a tile behind without stopping this one
    if (loader && it >= 2 && it - 2 + NSB < nq) {
      mbar_wait(bar_free + 8 * ((it - 2) % NSB), ((it - 2) / NSB) & 1);
      load(it - 2 + NSB);
    }

    // P^T = exp2(c S^T - lse2[query]) where visible, else 0;
    // dS^T = P^T (dP^T - D[query])
    const float* a = aux + s * (AUX_BYTES / 4);
    const int* ss = reinterpret_cast<const int*>(a + 2 * BQS);
    const int qid = tile_id<BQS>(ss, ln.lane);
    const bool masked = q0 < warp_last_key || qid != kid || kid < 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(a + n * 8 + ln.col);
      const float2 d2 = *reinterpret_cast<const float2*>(a + BQS + n * 8 + ln.col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(fmaf(p[4 * n + e], c, (e & 1) ? -l2.y : -l2.x));
        if (masked) {
          const int col = n * 8 + ln.col + (e & 1);
          if (!((key[e >> 1] <= q0 + col) & (ss[col] == kseg[e >> 1]))) pe = 0.f;
        }
        p[4 * n + e] = pe;
        dp[4 * n + e] = pe * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    // dV += P^T dO and dK += dS^T Q (the softmax scale is applied in the
    // reduction); they run while the next tile is awaited
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, p);
    pack_a(da, dp);
    wgmma_fence();
    gemm_rs(dva, pa, desc_mnmajor(sdo, HALF64));
    gemm_rs(dka, da, desc_mnmajor(sq, HALF64));
    wgmma_commit();
  }
  wgmma_wait<0>();
  acc_fence(dka);
  acc_fence(dva);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T) continue;
    const size_t off = (((size_t)b * T + key[i]) * nh + h) * HD + ln.col;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<float2*>(dk_part + off + n * 8) =
          make_float2(dka[4 * n + 2 * i], dka[4 * n + 2 * i + 1]);
      *reinterpret_cast<float2*>(dv_part + off + n * 8) =
          make_float2(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
    }
  }
}

// ---- backward: the GQA sum of the partials, in q-head order ---------------------

// One thread per 4 columns of one (lane, key, kv head) row of dK and dV.
__global__ void __launch_bounds__(128)
flash_full_reduce_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, size_t rows, int group,
                         float scale) {
  const size_t idx = (size_t)blockIdx.x * 128 + threadIdx.x;
  const size_t r = idx / (HD / 4);  // (b * T + key) * kh + kv head
  if (r >= rows) return;
  const int d = (idx % (HD / 4)) * 4;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < group; ++g) {
    const size_t off = (r * group + g) * HD + d;
    const float4 a = *reinterpret_cast<const float4*>(dk_part + off);
    const float4 e = *reinterpret_cast<const float4*>(dv_part + off);
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += e.x, sv.y += e.y, sv.z += e.z, sv.w += e.w;
  }
  uint2 ok, ov;
  ok.x = pack(sk.x * scale, sk.y * scale);
  ok.y = pack(sk.z * scale, sk.w * scale);
  ov.x = pack(sv.x, sv.y);
  ov.y = pack(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + r * HD + d) = ok;
  *reinterpret_cast<uint2*>(dv + r * HD + d) = ov;
}

// ---- backward: dQ ---------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_full_dq_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo, const int* __restrict__ seg,
                     const float* __restrict__ rowstats, bf16* __restrict__ dq, int B, int T,
                     int Tp, int nh, int kh, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  const int* sseg = reinterpret_cast<const int*>(sm + DQ_SEG);
  const uint32_t bars = base + DQ_BARS;
  const uint32_t bar_q = bars, bar_full = bars + 8, bar_free = bar_full + 8 * NSQ;

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (last) query tiles first
  const int b = blockIdx.z;
  const int hk = h / (nh / kh);
  const int q0 = qt * BM;
  const int nk = qt + 1;
  const int* sg = seg + (size_t)b * Tp;
  const bool loader = threadIdx.x == 0;

  auto load = [&](int t) {  // K, V and the segment ids of key tile t
    const int s = t % NSQ;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 2 * TILE128 + BKV * 4);
    load_tile(base + DQ_K + s * TILE128, HALF128, &mk, bar, hk, t * BKV, b);
    load_tile(base + DQ_V + s * TILE128, HALF128, &mv, bar, hk, t * BKV, b);
    bulk_load(base + DQ_SEG + s * BKV * 4, sg + t * BKV, BKV * 4, bar);
  };

  if (loader) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSQ; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, THREADS);
    }
    fence_barrier_init();
    mbar_expect_tx(bar_q, 2 * TILE128);
    load_tile(base, HALF128, &mq, bar_q, h, q0, b);
    load_tile(base + DQ_DO, HALF128, &mdo, bar_q, h, q0, b);
    for (int t = 0; t < min(NSQ, nk); ++t) load(t);
  }
  __syncthreads();

  const Lane ln;
  const int row[2] = {q0 + ln.wg * 64 + ln.row, q0 + ln.wg * 64 + ln.row + 8};
  const int rseg[2] = {sg[row[0]], sg[row[1]]};  // -2 past T
  const int qid = warp_rows_id(rseg[0], rseg[1]);
  const float* st = rowstats + ((size_t)b * nh + h) * Tp;
  const float lse2[2] = {st[row[0]], st[row[1]]};  // zeros past T, where dO and Q are zeros too
  const float del[2] = {st[(size_t)B * nh * Tp + row[0]], st[(size_t)B * nh * Tp + row[1]]};
  const float c = scale * LOG2E;
  const uint64_t qdesc = desc_kmajor(base + ln.wg * (64 * 128));
  const uint64_t dodesc = desc_kmajor(base + DQ_DO + ln.wg * (64 * 128));

  float dqa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % NSQ;
    const int k0 = j * BKV;
    mbar_wait(bar_full + 8 * s, (j / NSQ) & 1);
    const uint32_t sk = base + DQ_K + s * TILE128, sv = base + DQ_V + s * TILE128;
    // S = Q K^T and dP = dO V^T (64 rows x 128 keys each), queued behind
    // the previous tile's dQ product
    float p[64], dp[64];
    wgmma_fence();
    gemm_ss(p, qdesc, HALF128, desc_kmajor(sk), HALF128);
    gemm_ss(dp, dodesc, HALF128, desc_kmajor(sv), HALF128);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(p);
    acc_fence(dp);
    if (j > 0) {
      const int sp = (j - 1) % NSQ;
      mbar_arrive(bar_free + 8 * sp);
      if (loader && j - 1 + NSQ < nk) {
        mbar_wait(bar_free + 8 * sp, ((j - 1) / NSQ) & 1);
        load(j - 1 + NSQ);
      }
    }
    // dS = P (dP - D[row]) with P = exp2(c S - lse2[row]) where visible, else 0
    const int* ss = sseg + s * BKV;
    const int kid = tile_id<BKV>(ss, ln.lane);
    const bool masked = j == qt || kid != qid || qid < 0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pe = ex2(fmaf(p[4 * n + e], c, -lse2[i]));
        if (masked) {
          const int col = n * 8 + ln.col + (e & 1);
          if (!((k0 + col <= row[i]) & (ss[col] == rseg[i]))) pe = 0.f;
        }
        dp[4 * n + e] = pe * (dp[4 * n + e] - del[i]);
      }
    }
    // dQ += dS K; it runs while the next tile is awaited
    uint32_t da[8][4];
    pack_a(da, dp);
    wgmma_fence();
    gemm_rs(dqa, da, desc_mnmajor(sk, HALF128));
    wgmma_commit();
  }
  wgmma_wait<0>();
  acc_fence(dqa);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T) continue;
    bf16* dst = dq + (((size_t)b * T + row[i]) * nh + h) * HD + ln.col;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(dqa[4 * n + 2 * i] * scale, dqa[4 * n + 2 * i + 1] * scale);
  }
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up in the library that the
// process has loaded already (nothing is linked against it).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous (B, T, heads, 128) bf16 tensor whose box is
// `rows` rows of one head of one lane, 64 columns wide, 128-byte swizzled.
// Coordinates are (column, head, row, lane); rows past T read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)T * heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns the launch's
// cudaError_t (0 = accepted; cudaErrorNotSupported where libcuda's
// tensor-map encoder is missing or refuses the tensor). Pointers are device
// pointers of contiguous tensors: q, o, dout, dq (B, T, nh, 128) bf16; k, v,
// dk, dv (B, T, kh, 128) bf16; seg (B, padded) int32 with -2 past T, where
// padded is T rounded up to 128; lse (B, nh, T) f32; rowstats (2, B, nh,
// padded) f32, written by the preprocess; dk_part, dv_part (B, T, nh, 128)
// f32. The caller checks
// shapes, dtypes, alignment and nh % kh == 0.

int flash_full_fwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                        void* o, void* lse, int B, int T, int nh, int kh, float scale,
                        void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, T, nh, BM) || !make_map(&mk, k, B, T, kh, BKV) ||
      !make_map(&mv, v, B, T, kh, BKV))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t err = allow_smem(flash_full_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_full_fwd_kernel<<<dim3(nh, (T + BM - 1) / BM, B), THREADS, FWD_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const int*>(seg), static_cast<bf16*>(o),
      static_cast<float*>(lse), T, padded_len(T), nh, kh, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward is four launches, in this order: the preprocess (row
// statistics), dK/dV partials, their reduction, and dQ.
int flash_full_bwd_pre_bf16(const void* o, const void* dout, const void* lse, void* rowstats,
                            int B, int T, int nh, void* stream) {
  const int Tp = padded_len(T);
  const int rows = B * Tp * nh;
  flash_full_pre_kernel<<<(rows + PRE_WARPS - 1) / PRE_WARPS, PRE_WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(rowstats), rows, B, T, Tp, nh);
  return static_cast<int>(cudaGetLastError());
}

int flash_full_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg,
                             const void* dout, const void* rowstats, void* dk_part,
                             void* dv_part, int B, int T, int nh, int kh, float scale,
                             void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, T, nh, BQS) || !make_map(&mk, k, B, T, kh, BM) ||
      !make_map(&mv, v, B, T, kh, BM) || !make_map(&mdo, dout, B, T, nh, BQS))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t err = allow_smem(flash_full_dkdv_kernel, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_full_dkdv_kernel<<<dim3(nh, (T + BM - 1) / BM, B), THREADS, DKV_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const int*>(seg), static_cast<const float*>(rowstats),
      static_cast<float*>(dk_part), static_cast<float*>(dv_part), B, T, padded_len(T), nh, kh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int flash_full_bwd_reduce_bf16(const void* dk_part, const void* dv_part, void* dk, void* dv,
                               int B, int T, int nh, int kh, float scale, void* stream) {
  const size_t rows = (size_t)B * T * kh;
  const size_t threads = rows * (HD / 4);
  flash_full_reduce_kernel<<<(unsigned)((threads + 127) / 128), 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), rows, nh / kh, scale);
  return static_cast<int>(cudaGetLastError());
}

int flash_full_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg,
                           const void* dout, const void* rowstats, void* dq, int B, int T,
                           int nh, int kh, float scale, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, T, nh, BM) || !make_map(&mk, k, B, T, kh, BKV) ||
      !make_map(&mv, v, B, T, kh, BKV) || !make_map(&mdo, dout, B, T, nh, BM))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t err = allow_smem(flash_full_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_full_dq_kernel<<<dim3(nh, (T + BM - 1) / BM, B), THREADS, DQ_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const int*>(seg), static_cast<const float*>(rowstats),
      static_cast<bf16*>(dq), B, T, padded_len(T), nh, kh, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_full_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
