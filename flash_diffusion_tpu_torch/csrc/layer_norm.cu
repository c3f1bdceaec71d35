// LayerNorm forward for Hopper (sm_90a): one read and one write per row.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/norms.py
// _ln_fwd_kernel (via _ln_pallas_call), with its math: fp32 row statistics
// mean = E[x], var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * rsqrt(var +
// eps), the optional affine in fp32, and one cast on store.
//
// What bounds it on this card: memory. Each row is read from device memory
// once and written once; the arithmetic is a few operations per element,
// far below the card's compute. One warp takes one row (four rows per
// 128-thread block). Where the row allows it (16-byte aligned rows) the
// lanes move 16 bytes per load and store; they reduce sum(x) and sum(x^2)
// with warp shuffles, then walk the row again to normalise. The second walk
// finds the row in L1/L2 (a row is at most a few KB), so device traffic
// stays one read and one write. Unlike the JAX dispatch, every width and
// row count is taken (C = 320 included).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRowsPerBlock = 4;

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kV elements of T per load: 16 bytes when VEC, else one element.
template <typename T, bool VEC>
struct Pack {
  static constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  alignas(16) T v[kV];
  __device__ inline void load(const T* p) {
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    } else {
      v[0] = p[0];
    }
  }
  __device__ inline void store(T* p) const {
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
    } else {
      p[0] = v[0];
    }
  }
};

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                  T* __restrict__ y, int rows, int cols, float eps) {
  typedef Pack<T, VEC> P;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  T* yr = y + (size_t)row * cols;
  const int packs = cols / P::kV;

  float s = 0.0f, ss = 0.0f;
  for (int i = lane; i < packs; i += 32) {
    P p;
    p.load(xr + i * P::kV);
#pragma unroll
    for (int j = 0; j < P::kV; ++j) {
      const float v = to_f(p.v[j]);
      s += v;
      ss += v * v;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / cols;
  const float var = fmaxf(ss / cols - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
  for (int i = lane; i < packs; i += 32) {
    P p;
    p.load(xr + i * P::kV);
#pragma unroll
    for (int j = 0; j < P::kV; ++j) {
      const int c = i * P::kV + j;
      float v = (to_f(p.v[j]) - mean) * rstd;
      if (w != nullptr) v *= to_f(w[c]);
      if (b != nullptr) v += to_f(b[c]);
      p.v[j] = from_f<T>(v);
    }
    p.store(yr + i * P::kV);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int cols, float eps,
           bool vec, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec) {
    layer_norm_kernel<T, W, true><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
        static_cast<T*>(y), rows, cols, eps);
  } else {
    layer_norm_kernel<T, W, false><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
        static_cast<T*>(y), rows, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [rows, cols] contiguous, bf16 (x_bf16 = 1) or fp32. w, b: [cols] or
// null, bf16 (w_bf16 = 1) or fp32. vec = 1 takes 16-byte loads and stores:
// the caller sets it only when x and y are 16-byte aligned and cols * the
// element size is a multiple of 16. Returns the CUDA error code of the
// launch (0 on success).
int fdt_layer_norm(const void* x, const void* w, const void* b, void* y, int rows, int cols,
                   float eps, int x_bf16, int w_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_bf16) {
    return w_bf16 ? launch<bf16, bf16>(x, w, b, y, rows, cols, eps, v, s)
                  : launch<bf16, float>(x, w, b, y, rows, cols, eps, v, s);
  }
  return w_bf16 ? launch<float, bf16>(x, w, b, y, rows, cols, eps, v, s)
                : launch<float, float>(x, w, b, y, rows, cols, eps, v, s);
}

}  // extern "C"
