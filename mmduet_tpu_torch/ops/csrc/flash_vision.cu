// Non-causal multi-head flash attention for the ViT towers, forward only, for
// Hopper (sm_90a): TMA loads into mbarrier rings and `wgmma` products.
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
// hd = 7.8e10 flop against 109 MB of q, k, v and o. The T x T scores never
// reach device memory (the plain version writes them in f32).
//
// Design (the choices, each against the alternative):
// - A block is three warpgroups (384 threads, 155 registers a thread at hd =
//   72; at 384 threads the compiler caps a thread at 168, so the n128
//   instantiations for hd 88-128, which no model of the repository runs,
//   spill 240-272 bytes), each owning 64 rows of the block's 192-query tile; thread 0 also
//   starts the loads, as in kernel C (`flash_full.cu`). Keys stream in
//   128-key tiles through a two-stage K ring and a two-stage V ring (176 KB
//   of shared memory with the resident Q: one block an SM). The grid is
//   (ceil(T / 192), nh, N): 2048 blocks at the serving shape, where T = 729
//   is 3 x 192 + 153 queries and 5 x 128 + 89 keys. Against two warpgroups
//   of 64-key tiles two blocks an SM (0.3016 ms at the serving shape on an
//   H100 at 700 W), three warpgroups of 128-key tiles took 0.2523; a third
//   stage at one block an SM with 64-key tiles cost time (0.3489); a third
//   warpgroup lets the tensor cores run one warpgroup's products under
//   another's softmax, and 128-key tiles halve the barrier waits and the
//   shared-memory reads of Q per key.
// - Loads are TMA boxes of a 4-D tensor map (hd, nh, T, N) per operand,
//   128-byte swizzled. A swizzled row holds 64 bf16, so hd is loaded as two
//   64-wide halves; the second half reads columns 64-127 of a map whose
//   extent is hd, and TMA fills what lies past hd with zeros (columns 72-127
//   at hd = 72), as it fills the rows past T. For hd <= 64 the second half is
//   not loaded. The three maps are encoded per call on the host. Thread 0
//   refills a stage at the top of a tile, before the tile's products start,
//   if every warpgroup has released it by then (the copy then has a whole
//   tile's work to land); else after the tile's products, waiting for the
//   release.
// - S = Q K^T is `wgmma m64n128k16` from shared memory, ceil(hd / 16) steps
//   (5 at hd = 72, not 8): the zero-filled columns past hd add nothing.
// - O += P V is `wgmma m64nNk16` with P from registers (rounded to bf16, as
//   the plain version rounds it) and V untransposed through the MN-major
//   descriptor. N is hd itself at SigLIP's 72 (n72) and CLIP-L's 64, else
//   the next of 64, 80 and 128 (the other head dims are not instantiated
//   on their own; their zero columns cost a little).
// - The softmax runs on exp2 with scale * log2(e) folded into one fma per
//   score, in f32. As in kernel C's forward, S(j) is started before
//   O += P(j-1) V(j-1), and tile j's softmax runs under that product.
// - Ragged T: the tiles past T arrive as zeros. Only the last key tile can
//   hold keys past T; they get a finite -1e30 score and so a zero weight.
//   Query rows past T compute finite values that are never stored. Key 0
//   is in every row's first tile, so every row's running max is finite from
//   the first tile on.
// The softmax scale uses the true hd.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WGS = 3;                   // consumer warpgroups; thread 0 also starts the loads
constexpr int THREADS = 128 * WGS;
constexpr int BQ = 64 * WGS;             // query rows per block, 64 a warpgroup
constexpr int BK = 128;                  // keys per streamed tile
constexpr int NS = 2;                    // ring stages of K and of V
constexpr int SR = BK / 2;               // S's accumulator registers a thread
constexpr uint32_t Q_HALF = BQ * 128;    // bytes of BQ rows x 64 columns
constexpr uint32_t KV_HALF = BK * 128;   // bytes of BK rows x 64 columns
// Shared memory, in bytes from a 1024-byte aligned base:
// Q | K[NS] | V[NS] | barriers
constexpr uint32_t SM_K = 2 * Q_HALF;
constexpr uint32_t SM_V = SM_K + NS * 2 * KV_HALF;
constexpr uint32_t SM_BARS = SM_V + NS * 2 * KV_HALF;
constexpr size_t SMEM = SM_BARS + 128 + 1024;
static_assert(SMEM <= 232448, "a block may take 227 KB of shared memory");

// KS: 16-deep steps of Q K^T, ceil(hd / 16). NV: columns of O (64, 72, 80, 128).
template <int KS, int NV>
__global__ void __launch_bounds__(THREADS, 1)
flash_vision_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int T,
                    int nh, int hd, float scale) {
  constexpr int HALVES = KS > 4 ? 2 : 1;  // 64-wide halves loaded
  constexpr int NR = NV / 2;              // O's accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + SM_BARS;
  const uint32_t bar_q = bars, bar_k = bars + 8, bar_v = bar_k + 8 * NS,
                 bar_k_free = bar_v + 8 * NS, bar_v_free = bar_k_free + 8 * NS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int img = blockIdx.z;
  const int nk = (T + BK - 1) / BK;
  const bool ragged = T % BK != 0;
  const bool loader = threadIdx.x == 0;

  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int t) {
    mbar_expect_tx(bar, HALVES * KV_HALF);
#pragma unroll
    for (int i = 0; i < HALVES; ++i) tma_load(dst + i * KV_HALF, map, bar, 64 * i, h, t * BK, img);
  };
  auto load_k = [&](int t) {
    const int s = t % NS;
    load(&mk, base + SM_K + s * 2 * KV_HALF, bar_k + 8 * s, t);
  };
  auto load_v = [&](int t) {
    const int s = t % NS;
    load(&mv, base + SM_V + s * 2 * KV_HALF, bar_v + 8 * s, t);
  };

  if (loader) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_free + 8 * s, THREADS);
      mbar_init(bar_v_free + 8 * s, THREADS);
    }
    fence_barrier_init();
    mbar_expect_tx(bar_q, HALVES * Q_HALF);
#pragma unroll
    for (int i = 0; i < HALVES; ++i) tma_load(base + i * Q_HALF, &mq, bar_q, 64 * i, h, q0, img);
    for (int t = 0; t < min(NS, nk); ++t) {
      load_k(t);
      load_v(t);
    }
  }
  __syncthreads();

  // this thread's rows (second: + 8) of its warpgroup's 64, and the first
  // of its two columns in every 8-column block
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (threadIdx.x & 3);
  const int row[2] = {q0 + wg * 64 + r, q0 + wg * 64 + r + 8};
  const float c = scale * LOG2E;
  const uint64_t qdesc = desc_kmajor(base + wg * (64 * 128));

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  uint32_t pa[BK / 16][4];  // the previous tile's probabilities, bf16 A fragments

  auto scores = [&](float (&sc)[SR], int s) {
    const uint64_t kdesc = desc_kmajor(base + SM_K + s * 2 * KV_HALF);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(sc, qdesc + kstep(kk, Q_HALF), kdesc + kstep(kk, KV_HALF), kk);
  };
  auto values = [&](int s) {
    const uint64_t vdesc = desc_mnmajor(base + SM_V + s * 2 * KV_HALF, KV_HALF);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, pa[kk], vdesc + rowstep(kk));
  };
  // Tile j's softmax on its scores (in place: they become the
  // probabilities), the running maximum and sum, and alpha, the factor
  // that O takes for the new maximum.
  auto softmax = [&](int j, float (&sc)[SR], float (&alpha)[2]) {
    if (ragged && j == nk - 1) {
      const int live = T - j * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + col + (e & 1) >= live) sc[4 * n + e] = NEG;
      }
    }
    mbar_arrive(bar_k_free + 8 * (j % NS));
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      tmax[0] = fmaxf(tmax[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    float mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(tmax[i]));
      alpha[i] = ex2((m[i] - mn) * c);
      m[i] = mn;
      mc[i] = mn * c;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], c, -mc[e >> 1]));
        rsum[e >> 1] += sc[4 * n + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
  };

  mbar_wait(bar_q, 0);
  {  // tile 0: O is still zero
    float sc[SR], alpha[2];
    mbar_wait(bar_k, 0);
    wgmma_fence();
    scores(sc, 0);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(sc);
    softmax(0, sc, alpha);
    pack_a(pa, sc);
  }
  for (int j = 1; j < nk; ++j) {
    const int s = j % NS, sp = (j - 1) % NS;
    // the loads, where none of this warpgroup's products is in flight: K of
    // tile j + NS - 1 into the stage that S(j-1) has left, V of tile j + NS
    // - 2 into the one that P(j-2) V(j-2) has left. Here, at the top of the
    // tile, if the other warpgroup has released the stage already (then the
    // load has a whole tile's work to land), else after this tile's
    // products, waiting for the release.
    const bool want_k = loader && j + NS - 1 < nk;
    const bool want_v = loader && j >= 2 && j + NS - 2 < nk;
    const uint32_t kf = bar_k_free + 8 * ((j - 1) % NS), kf_par = ((j - 1) / NS) & 1;
    const uint32_t vf = bar_v_free + 8 * ((j - 2 + NS) % NS), vf_par = ((j - 2) / NS) & 1;
    const bool k_now = want_k && mbar_test(kf, kf_par);
    const bool v_now = want_v && mbar_test(vf, vf_par);
    if (k_now) load_k(j + NS - 1);
    if (v_now) load_v(j + NS - 2);
    // S(j), and behind it O += P(j-1) V(j-1), which runs under this tile's
    // softmax
    float sc[SR], alpha[2];
    mbar_wait(bar_k + 8 * s, (j / NS) & 1);
    mbar_wait(bar_v + 8 * sp, ((j - 1) / NS) & 1);
    wgmma_fence();
    scores(sc, s);
    wgmma_commit();
    values(sp);
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence(sc);
    softmax(j, sc, alpha);
    wgmma_wait<0>();
    acc_fence(acc);
    mbar_arrive(bar_v_free + 8 * sp);
    if (want_k && !k_now) {
      mbar_wait(kf, kf_par);
      load_k(j + NS - 1);
    }
    if (want_v && !v_now) {
      mbar_wait(vf, vf_par);
      load_v(j + NS - 2);
    }
#pragma unroll
    for (int n = 0; n < NR / 4; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    pack_a(pa, sc);
  }
  {
    const int s = (nk - 1) % NS;
    mbar_wait(bar_v + 8 * s, ((nk - 1) / NS) & 1);
    wgmma_fence();
    values(s);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / quad_sum(l[i]);
    if (row[i] >= T) continue;
    bf16* dst = o + (((size_t)img * T + row[i]) * nh + h) * hd + col;
#pragma unroll
    for (int n = 0; n < NR / 4; ++n) {
      if (n * 8 < hd)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

// A tensor map over a contiguous (N, T, nh, hd) bf16 tensor whose box is
// `rows` rows of one head of one image, 64 columns wide, 128-byte swizzled.
// Coordinates are (column, head, row, image); what lies past hd or T reads
// as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int N, int T, int nh, int hd, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)nh, (cuuint64_t)T, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)nh * hd * 2,
                                 (cuuint64_t)T * nh * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS, int NV>
int launch(const void* q, const void* k, const void* v, void* o, int N, int T, int nh, int hd,
           float scale, cudaStream_t stream) {
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      flash_vision_kernel<KS, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, N, T, nh, hd, BQ) || !make_map(&mk, k, N, T, nh, hd, BK) ||
      !make_map(&mv, v, N, T, nh, hd, BK))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid((T + BQ - 1) / BQ, nh, N);
  flash_vision_kernel<KS, NV><<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), T, nh, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = launched;
// -1 for a head dim the kernel does not take; cudaErrorNotSupported where
// libcuda's tensor-map encoder is missing or refuses the tensor). Pointers
// are device pointers of contiguous, 16-byte aligned bf16 (N, T, nh, hd)
// tensors; hd is a multiple of 8 in [8, 128]. The caller checks shapes,
// dtypes and contiguity.
int flash_vision_bf16(const void* q, const void* k, const void* v, void* o,
                      int N, int T, int nh, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  switch ((hd + 15) / 16) {
    case 1: return launch<1, 64>(q, k, v, o, N, T, nh, hd, scale, st);
    case 2: return launch<2, 64>(q, k, v, o, N, T, nh, hd, scale, st);
    case 3: return launch<3, 64>(q, k, v, o, N, T, nh, hd, scale, st);
    case 4: return launch<4, 64>(q, k, v, o, N, T, nh, hd, scale, st);
    case 5:
      return hd == 72 ? launch<5, 72>(q, k, v, o, N, T, nh, hd, scale, st)
                      : launch<5, 80>(q, k, v, o, N, T, nh, hd, scale, st);
    case 6: return launch<6, 128>(q, k, v, o, N, T, nh, hd, scale, st);
    case 7: return launch<7, 128>(q, k, v, o, N, T, nh, hd, scale, st);
    default: return launch<8, 128>(q, k, v, o, N, T, nh, hd, scale, st);
  }
}

const char* flash_vision_error_string(int code) {
  if (code == -1) return "head dim must be a multiple of 8 in [8, 128]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
