// The ViT encoder layer's elementwise chains between its GEMMs, fused into
// three passes over bf16 rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them into the matrix products' neighbours on the TPU. Eager PyTorch
// runs each step as its own kernel, with f32 copies in device memory (the
// LayerNorm's `.float()`, mean, sub, pow, mean, rsqrt, sub, mul, mul, add,
// `.to()`; the GELU's `.float()` and `.to()`). Called from
// `models/siglip.py` `encoder_layer` through `ops/vision_fused.py`, for the
// SigLIP and the CLIP towers alike.
//
// What bounds them on this card: bytes. Each pass reads every operand once
// and writes every output once, in bf16; the f32 intermediates live in
// registers. At the serving shape (32 frames x 729 patches = 23328 rows of
// 1152, an MLP of 4304) a layer's passes move 1.15 GB, against about 6.9 GB
// for the eager chains.
//
// The passes, each with the eager chain's roundings (a bf16 rounding where
// the eager chain writes a bf16 tensor, f32 arithmetic in between):
// - `bias_add3`: q, k and v each get their bias, round(p + b), in one launch
//   (grid.y picks the tensor); three contiguous outputs, as kernel D takes.
//   The tensor is picked by selects in registers: an indexed array of the
//   pointers went to local memory and held the pass at 38 % of its bound
//   (0.2555 ms against 0.0963 at the serving shape, H100 at 700 W).
// - `residual_ln`: h_new = round(h + round(p + b)), then y = round(LN(h_new)
//   * scale + shift), the LN in f32 two-pass over the row (mean, then the
//   mean of squared deviations), rsqrtf(var + eps). Bias, residual and the
//   LN are each optional: with none of the first two it is a LayerNorm of
//   p; without the LN it writes h_new only. One warp a row: the row's 16-byte
//   vectors stay in registers as bf16 between the sums (VPT vectors a lane,
//   VPT instantiated up to 18, rows up to 4608 wide).
// - `bias_act`: round(act(float(round(p + b)))), act a template parameter:
//   tanh-GELU (PyTorch's `gelu(approximate="tanh")` expression, written as
//   its CUDA kernel writes it) or quick_gelu, x * sigmoid(1.702 x), as three
//   eager f32 kernels compute it (each product rounded on its own).
// Widths are multiples of 8, so a 16-byte vector never straddles two rows;
// the elementwise passes are one vector a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack(const uint4& u, float f[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = lo(w[j]);
    f[2 * j + 1] = hi(w[j]);
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
}

// round(a + b) elementwise, the sum in f32
__device__ __forceinline__ uint4 add_round(const uint4& a, const uint4& b) {
  float x[8], y[8];
  unpack(a, x);
  unpack(b, y);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __fadd_rn(x[j], y[j]);
  return pack8(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// ---- bias_add3 -------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) bias_add3_kernel(
    const uint4* __restrict__ q, const uint4* __restrict__ k, const uint4* __restrict__ v,
    const uint4* __restrict__ bq, const uint4* __restrict__ bk, const uint4* __restrict__ bv,
    uint4* __restrict__ oq, uint4* __restrict__ ok, uint4* __restrict__ ov, int nvec, int cvec) {
  // the tensor picked by selects in registers (an indexed array of the
  // pointers would live in local memory)
  const int which = blockIdx.y;
  const uint4* in = which == 0 ? q : which == 1 ? k : v;
  const uint4* bias = which == 0 ? bq : which == 1 ? bk : bv;
  uint4* out = which == 0 ? oq : which == 1 ? ok : ov;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < nvec; i += gridDim.x * THREADS)
    out[i] = add_round(in[i], __ldg(bias + i % cvec));
}

// ---- residual_ln -----------------------------------------------------------

template <int VPT>
__global__ void __launch_bounds__(THREADS) residual_ln_kernel(
    const uint4* __restrict__ p, const uint4* __restrict__ bias, const uint4* __restrict__ res,
    const uint4* __restrict__ scale, const uint4* __restrict__ shift, uint4* __restrict__ h_out,
    uint4* __restrict__ y, int rows, int cvec, float inv_c, float eps) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * cvec;
  uint4 x[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + 32 * i;
    if (v < cvec) {
      uint4 a = p[base + v];
      if (bias) a = add_round(a, __ldg(bias + v));
      if (res) a = add_round(res[base + v], a);
      x[i] = a;
      if (h_out) h_out[base + v] = a;
      float f[8];
      unpack(a, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
  }
  if (!y) return;
  const float mu = warp_sum(sum) * inv_c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + 32 * i < cvec) {
      float f[8];
      unpack(x[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(f[j], mu);
        sq = __fmaf_rn(d, d, sq);
      }
    }
  }
  const float r = rsqrtf(__fadd_rn(warp_sum(sq) * inv_c, eps));
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + 32 * i;
    if (v < cvec) {
      float f[8], s[8], b[8];
      unpack(x[i], f);
      unpack(__ldg(scale + v), s);
      unpack(__ldg(shift + v), b);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j], mu), r), s[j]), b[j]);
      y[base + v] = pack8(f);
    }
  }
}

template <int VPT>
cudaError_t launch_ln(const void* p, const void* bias, const void* res, const void* scale,
                      const void* shift, void* h_out, void* y, int rows, int cols, float eps,
                      cudaStream_t stream) {
  const int blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  residual_ln_kernel<VPT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(p), static_cast<const uint4*>(bias),
      static_cast<const uint4*>(res), static_cast<const uint4*>(scale),
      static_cast<const uint4*>(shift), static_cast<uint4*>(h_out), static_cast<uint4*>(y),
      rows, cols / 8, 1.0f / (float)cols, eps);
  return cudaGetLastError();
}

// ---- bias_act --------------------------------------------------------------

enum { GELU_TANH = 0, QUICK_GELU = 1 };

template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == GELU_TANH) {  // ATen's GeluCUDAKernelImpl, approximate="tanh", in f32
    constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5f;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  // x * sigmoid(1.702 x): three f32 kernels, so no product is fused into a sum
  const float t = __fmul_rn(x, 1.702f);
  return __fmul_rn(x, 1.0f / (1.0f + expf(-t)));
}

template <int ACT>
__global__ void __launch_bounds__(THREADS) bias_act_kernel(const uint4* __restrict__ p,
                                                           const uint4* __restrict__ bias,
                                                           uint4* __restrict__ out, int nvec,
                                                           int cvec) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < nvec; i += gridDim.x * THREADS) {
    float f[8];
    unpack(add_round(p[i], __ldg(bias + i % cvec)), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = act<ACT>(f[j]);
    out[i] = pack8(f);
  }
}

unsigned grid_for(int nvec) {
  const int blocks = (nvec + THREADS - 1) / THREADS;
  return (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
}

// (rows, cols) in 16-byte vectors, or -1 where the count leaves int32 (the
// passes index in 32 bits) or cols is no positive multiple of 8
int vectors(long long rows, int cols) {
  if (cols <= 0 || cols % 8 || rows < 0 || rows * (cols / 8) > 0x7fffffffLL) return -1;
  return (int)(rows * (cols / 8));
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns the launch's cudaError_t (0 =
// launched; -1 for a width the pass does not take). Pointers are device
// pointers of contiguous, 16-byte aligned bf16 tensors: (rows, cols)
// operands and outputs, (cols,) biases and LayerNorm parameters; cols is a
// multiple of 8. The caller checks devices, dtypes, shapes and contiguity.

// out_i = round(in_i + bias_i) for i = q, k, v, each (rows, cols).
int vision_bias_add3_bf16(const void* q, const void* k, const void* v, const void* bq,
                          const void* bk, const void* bv, void* oq, void* ok, void* ov,
                          long long rows, int cols, void* stream) {
  const int nvec = vectors(rows, cols);
  if (nvec < 0) return -1;
  typedef const uint4* In;
  bias_add3_kernel<<<dim3(grid_for(nvec), 3), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<In>(q), static_cast<In>(k), static_cast<In>(v), static_cast<In>(bq),
      static_cast<In>(bk), static_cast<In>(bv), static_cast<uint4*>(oq), static_cast<uint4*>(ok),
      static_cast<uint4*>(ov), nvec, cols / 8);
  return static_cast<int>(cudaGetLastError());
}

// h_out = round(res + round(p + bias)) (bias and res may be null: then that
// step is left out), y = round(LN(h_out) * scale + shift) with the LN in f32.
// h_out null: h_out is not written; y null (scale and shift unread): no LN.
int vision_residual_ln_bf16(const void* p, const void* bias, const void* res, const void* scale,
                            const void* shift, void* h_out, void* y, int rows, int cols,
                            float eps, void* stream) {
  if (vectors(rows, cols) < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = (cols / 8 + 31) / 32;  // 16-byte vectors a lane
  cudaError_t err;
  if (need <= 1) err = launch_ln<1>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 2) err = launch_ln<2>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 3) err = launch_ln<3>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 4) err = launch_ln<4>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 5) err = launch_ln<5>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 6) err = launch_ln<6>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 8) err = launch_ln<8>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 12) err = launch_ln<12>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else if (need <= 18) err = launch_ln<18>(p, bias, res, scale, shift, h_out, y, rows, cols, eps, st);
  else return -1;
  return static_cast<int>(err);
}

// out = round(act(round(p + bias))), act 0 = tanh-GELU, 1 = quick_gelu.
int vision_bias_act_bf16(const void* p, const void* bias, void* out, long long rows, int cols,
                         int act, void* stream) {
  const int nvec = vectors(rows, cols);
  if (nvec < 0 || (act != GELU_TANH && act != QUICK_GELU)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* pp = static_cast<const uint4*>(p);
  const uint4* bb = static_cast<const uint4*>(bias);
  uint4* oo = static_cast<uint4*>(out);
  if (act == GELU_TANH)
    bias_act_kernel<GELU_TANH><<<grid_for(nvec), THREADS, 0, st>>>(pp, bb, oo, nvec, cols / 8);
  else
    bias_act_kernel<QUICK_GELU><<<grid_for(nvec), THREADS, 0, st>>>(pp, bb, oo, nvec, cols / 8);
  return static_cast<int>(cudaGetLastError());
}

const char* vision_fused_error_string(int code) {
  if (code == -1)
    return "width must be a positive multiple of 8 (a LayerNorm row at most 4608), and the "
           "operand under 2^31 16-byte vectors";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
