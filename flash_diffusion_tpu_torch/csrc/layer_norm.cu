// LayerNorm forward for Hopper (sm_90a): one read and one write per row,
// the row held in registers between them.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/norms.py
// _ln_fwd_kernel (via _ln_pallas_call), with its math: fp32 row statistics
// mean = E[x], var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * rsqrt(var +
// eps), the optional affine in fp32, and one cast on store.
//
// What bounds it on this card: memory. Each row is read from device memory
// once and written once; the arithmetic is a few operations per element,
// far below the card's compute. So the kernel keeps every lane busy on its
// loads and keeps them in flight: `tpr` lanes (8, 16 or 32 of one warp)
// take one row, each holding PPT packs (16 bytes where the row allows it)
// in registers from the loads, through the statistics (lane sums, then an
// xor-shuffle tree over the row's lanes), to the store. The caller
// (ops/norms.py layer_norm_plan) picks tpr and PPT by the width so that
// tpr * PPT packs cover the row exactly at the paths' widths (bf16 C = 320:
// 8 x 5; 640, 1152: 16 x 5, 16 x 9; 1280: 32 x 5; fp32 768, 1280: 32 x 6,
// 32 x 10). The affine is loaded once per thread as 16-byte vectors and
// kept across the rows the thread takes (the grid is capped at the card's
// resident blocks; rows past it loop). A row's sums depend on its width
// alone, never on its slot or the row count. Rows wider than 16 packs a
// lane take the wide kernel: one warp a row, walking the row twice (the
// second walk finds it in L1/L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWideRows = 4;  // rows (warps) per block of the wide kernel

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }

// K elements of E held in 32-bit words (bf16 two to a word), so that a
// thread's packs and affine stay packed in its registers. VEC packs are
// 16-byte loads and stores (p aligned to their bytes).
template <typename E, int K>
struct Raw {
  static constexpr int kBytes = K * (int)sizeof(E);
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t w[kWords];
  __device__ inline void load(const E* p) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) reinterpret_cast<uint4*>(w)[i] = reinterpret_cast<const uint4*>(p)[i];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(p);
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {  // one bf16
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ inline void store(E* p) const {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(w)[i];
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
    }
  }
  __device__ inline float get(int i) const {
    if constexpr (sizeof(E) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float(((w[i >> 1] >> ((i & 1) * 16)) & 0xffffu) << 16);
    }
  }
  __device__ inline void set(int i, float v) {
    if constexpr (sizeof(E) == 4) {
      w[i] = __float_as_uint(v);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v));
      w[i >> 1] = (w[i >> 1] & ~(0xffffu << ((i & 1) * 16))) | (h << ((i & 1) * 16));
    }
  }
};

// rstd of a row from its fp32 sums (JAX's formula); mean through *mean
__device__ inline float row_rstd(float s, float ss, int cols, float eps, float* mean) {
  *mean = s / cols;
  const float var = fmaxf(ss / cols - *mean * *mean, 0.0f);
  return rsqrtf(var + eps);
}

// One row per `tpr` lanes (8, 16 or 32), PPT packs of kV elements per lane:
// lane l of a row takes packs l, l + tpr, ... (neighbouring lanes on
// neighbouring 16 bytes). VEC: 16-byte packs (cols * sizeof(T) a multiple of
// 16, x, y, w and b 16-byte aligned), else packs of one element.
template <typename T, typename W, int PPT, bool VEC>
__global__ void __launch_bounds__(256)
layer_norm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                       T* __restrict__ y, int rows, int cols, int tpr, float eps) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const int packs = cols / kV;
  const int lane = threadIdx.x % tpr;
  const int rows_per_warp = 32 / tpr;
  // the first row of this thread's warp, and the step between its rows:
  // warp-uniform, so that every lane of a warp joins every shuffle
  const int warp_row = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * rows_per_warp;
  const int step = gridDim.x * (blockDim.x / 32) * rows_per_warp;
  const int my = (threadIdx.x % 32) / tpr;
  bool ok[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) ok[j] = j * tpr + lane < packs;
  Raw<W, kV> wv[PPT], bv[PPT];  // the affine, loaded once
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (ok[j] && w != nullptr) wv[j].load(w + (j * tpr + lane) * kV);
    if (ok[j] && b != nullptr) bv[j].load(b + (j * tpr + lane) * kV);
  }
  for (int row0 = warp_row; row0 < rows; row0 += step) {
    const int row = row0 + my;
    const bool live = row < rows;
    const T* xr = x + (size_t)row * cols;
    Raw<T, kV> v[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {  // every load in flight before the first sum
      if (live && ok[j]) v[j].load(xr + (j * tpr + lane) * kV);
    }
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (live && ok[j]) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float f = v[j].get(e);
          s += f;
          ss += f * f;
        }
      }
    }
    for (int o = tpr / 2; o > 0; o >>= 1) {  // the row's lanes: a fixed xor tree
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    float mean;
    const float rstd = row_rstd(s, ss, cols, eps, &mean);
    T* yr = y + (size_t)row * cols;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (live && ok[j]) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          float u = (v[j].get(e) - mean) * rstd;
          if (w != nullptr) u *= wv[j].get(e);
          if (b != nullptr) u += bv[j].get(e);
          v[j].set(e, u);
        }
        v[j].store(yr + (j * tpr + lane) * kV);
      }
    }
  }
}

// Rows wider than 16 packs a lane: one warp a row, 16-byte packs where the
// row allows it, the row walked twice.
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(32 * kWideRows)
layer_norm_wide_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                       T* __restrict__ y, int rows, int cols, float eps) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWideRows + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  T* yr = y + (size_t)row * cols;
  const int packs = cols / kV;
  float s = 0.0f, ss = 0.0f;
  for (int i = lane; i < packs; i += 32) {
    Raw<T, kV> v;
    v.load(xr + i * kV);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float f = v.get(e);
      s += f;
      ss += f * f;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  float mean;
  const float rstd = row_rstd(s, ss, cols, eps, &mean);
  for (int i = lane; i < packs; i += 32) {
    Raw<T, kV> v;
    v.load(xr + i * kV);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int c = i * kV + e;
      float u = (v.get(e) - mean) * rstd;
      if (w != nullptr) u *= to_f(w[c]);
      if (b != nullptr) u += to_f(b[c]);
      v.set(e, u);
    }
    v.store(yr + i * kV);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <typename T, typename W, int PPT, bool VEC>
int launch_rows(const T* x, const W* w, const W* b, T* y, int rows, int cols, int tpr, float eps,
                cudaStream_t stream) {
  // warps of a block: up to 8, fewer where the rows would not fill the card
  // with two blocks an SM; the grid is capped at the blocks the card holds,
  // and the threads loop over the rest
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int rows_per_warp = 32 / tpr;
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  int wpb = 8;
  while (wpb > 1 && warps < (long long)wpb * 2 * sms) wpb /= 2;
  const long long blocks = (warps + wpb - 1) / wpb;
  const long long cap = (long long)sms * (2048 / (32 * wpb));
  layer_norm_rows_kernel<T, W, PPT, VEC><<<(unsigned)(blocks < cap ? blocks : cap), 32 * wpb, 0, stream>>>(
      x, w, b, y, rows, cols, tpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, bool VEC>
int dispatch(const void* xv, const void* wv, const void* bv, void* yv, int rows, int cols, float eps, int tpr,
             int ppt, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const W* w = static_cast<const W*>(wv);
  const W* b = static_cast<const W*>(bv);
  T* y = static_cast<T*>(yv);
  if (ppt != 0 && tpr != 8 && tpr != 16 && tpr != 32) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!VEC) {  // packs of one element: 32 lanes of 1, 2, 4, 8 or 16
    if (ppt != 0 && (tpr != 32 || (ppt & (ppt - 1)) != 0)) return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (ppt) {
    case 0:  // the wide kernel
      layer_norm_wide_kernel<T, W, VEC><<<(rows + kWideRows - 1) / kWideRows, 32 * kWideRows, 0, stream>>>(
          x, w, b, y, rows, cols, eps);
      return static_cast<int>(cudaGetLastError());
    case 1: return launch_rows<T, W, 1, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
    case 2: return launch_rows<T, W, 2, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
    case 4: return launch_rows<T, W, 4, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
    case 5: if constexpr (VEC) return launch_rows<T, W, 5, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 6: if constexpr (VEC) return launch_rows<T, W, 6, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 8: return launch_rows<T, W, 8, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
    case 9: if constexpr (VEC) return launch_rows<T, W, 9, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 10: if constexpr (VEC) return launch_rows<T, W, 10, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 16: return launch_rows<T, W, 16, VEC>(x, w, b, y, rows, cols, tpr, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename W>
int by_vec(const void* x, const void* w, const void* b, void* y, int rows, int cols, float eps, bool vec, int tpr,
           int ppt, cudaStream_t stream) {
  return vec ? dispatch<T, W, true>(x, w, b, y, rows, cols, eps, tpr, ppt, stream)
             : dispatch<T, W, false>(x, w, b, y, rows, cols, eps, tpr, ppt, stream);
}

}  // namespace

extern "C" {

// x, y: [rows, cols] contiguous, bf16 (x_bf16 = 1) or fp32. w, b: [cols] or
// null, bf16 (w_bf16 = 1) or fp32. vec = 1 takes 16-byte packs: the caller
// sets it only when x, y, w and b are 16-byte aligned and cols * the element
// size is a multiple of 16. (tpr, ppt): lanes a row and packs a lane of the
// row kernel (ops/norms.py layer_norm_plan: tpr * ppt packs cover the row;
// ppt in 1, 2, 4, 5, 6, 8, 9, 10, 16 with vec, else tpr = 32 and ppt a
// power of two up to 16), or ppt = 0 for the wide kernel. Returns the
// CUDA error code of the launch (0 on success).
int fdt_layer_norm(const void* x, const void* w, const void* b, void* y, int rows, int cols, float eps, int x_bf16,
                   int w_bf16, int vec, int tpr, int ppt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_bf16) {
    return w_bf16 ? by_vec<bf16, bf16>(x, w, b, y, rows, cols, eps, v, tpr, ppt, s)
                  : by_vec<bf16, float>(x, w, b, y, rows, cols, eps, v, tpr, ppt, s);
  }
  return w_bf16 ? by_vec<float, bf16>(x, w, b, y, rows, cols, eps, v, tpr, ppt, s)
                : by_vec<float, float>(x, w, b, y, rows, cols, eps, v, tpr, ppt, s);
}

}  // extern "C"
