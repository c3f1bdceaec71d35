// GroupNorm for Hopper (sm_90a): the per-channel statistics kernel (K9) and
// the normalize pass that applies the folded per-channel scale and shift.
// Both take the two layouts the port's activations come in: NCHW, and
// channels-last NHWC (what cuDNN's convolutions hand on when their input
// is a permuted NHWC tensor, as the UNet's and the VAE's inputs are).
//
// Statistics: replaces the Pallas TPU kernel flash_diffusion_tpu/ops/norms.py
// _gn_stats_kernel (via _gn_stats_pallas): per (batch, channel) fp32 sums
// Σx and Σx² over the spatial extent. The JAX kernel walks the [B·N, C]
// view with a sequential grid and carries its sums in VMEM scratch; here
// blocks run in parallel, so each sample's N is cut into fixed parts (the
// caller's constants, never a function of B or C) whose partial sums a
// second kernel adds in a fixed order (lane-strided, then an xor-shuffle
// tree). NCHW: each (b, c) row of N elements is contiguous; one warp sums
// one chunk of a row with 16-byte loads, then a fixed xor-shuffle tree.
// NHWC: each sample is an [N, C] matrix; a block takes `rows` rows of 64
// (bf16) or 32 (fp32) channels, 32 row lanes by 8 column threads of 16-byte
// loads, and adds its row lanes in a fixed shared-memory tree. No atomics:
// a row's sums depend only on its own N values and the layout, so a sample's
// statistics are bit-identical alone, in any batch and at any slot, and
// from run to run. A sample of one part skips the second kernel (that
// choice depends on N alone).
//
// Apply: the port's own fused elementwise pass, not a TPU kernel (JAX leaves
// it to XLA, which fuses it into the next convolution). y = x·w[b,c] +
// shift[b,c], then an optional SiLU, in one read and one write, in x's
// layout. It rounds where the plain PyTorch version rounds: x·w to x's
// dtype, then + shift to x's dtype, then SiLU x / (1 + exp(-x)) in fp32
// with one rounding.
//
// What bounds both on this card: memory. The statistics read each element
// once (2 bytes in bf16) and write 8 bytes per (b, c); the apply reads and
// writes each element once. The arithmetic is a few operations an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;  // warps (work items) per 256-thread block
constexpr int kApplyThreads = 256;

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T and back: the rounding of one PyTorch op in T's dtype
template <typename T> __device__ inline float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per (row, chunk): partial Σx and Σx² of elements [part·chunk,
// min(n, (part+1)·chunk)) of the row. VEC: 16-byte loads (n·sizeof(T) and
// chunk·sizeof(T) multiples of 16, x 16-byte aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
gn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                        long long items, int n, int chunk, int parts) {
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= items) return;
  const int lane = threadIdx.x % 32;
  const long long row = item / parts;
  const int begin = (int)(item % parts) * chunk;
  const int end = min(n, begin + chunk);
  const T* xr = x + row * (long long)n;
  float s = 0.0f, ss = 0.0f;
  if constexpr (VEC) {
    constexpr int kV = 16 / sizeof(T);
#pragma unroll 4
    for (int i = begin + lane * kV; i < end; i += 32 * kV) {
      alignas(16) T v[kV];
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(xr + i));
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(v[j]);
        s += f;
        ss += f * f;
      }
    }
  } else {
    for (int i = begin + lane; i < end; i += 32) {
      const float f = to_f(xr[i]);
      s += f;
      ss += f * f;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    psum[item] = s;
    psq[item] = ss;
  }
}

// NHWC: block (column tile, part, b) sums rows [part·rows, min(n, (part+1)·
// rows)) of sample b's [n, c] matrix for 8·kV channels: thread (row lane
// r, column thread j) takes rows r, r + 32, ... and channels
// [(tile·8 + j)·kV, +kV); the 32 row lanes then add in a fixed tree. The
// partial of (b, ch) goes to [b·c + ch][part] (the layout the final kernel
// reads), or straight to the sums when there is one part. VEC: 16-byte loads
// (c·sizeof(T) a multiple of 16, x 16-byte aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
gn_stats_nhwc_partial_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                             int n, int c, int rows, int parts) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  constexpr int kCols = 8, kLanes = 32 * kWarps / kCols;
  __shared__ float sh_s[kLanes][kCols * kV], sh_q[kLanes][kCols * kV];
  const int col = threadIdx.x % kCols, lane = threadIdx.x / kCols;
  const int b = blockIdx.z, part = blockIdx.y;
  const int c0 = (blockIdx.x * kCols + col) * kV;
  const int r1 = min(n, (part + 1) * rows);
  float s[kV], ss[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) s[j] = ss[j] = 0.0f;
  if (c0 < c) {
    const T* xb = x + (long long)b * n * c + c0;
#pragma unroll 4
    for (int r = part * rows + lane; r < r1; r += kLanes) {
      alignas(16) T v[kV];
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(xb + (long long)r * c));
      } else {
        v[0] = xb[(long long)r * c];
      }
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(v[j]);
        s[j] += f;
        ss[j] += f * f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sh_s[lane][col * kV + j] = s[j];
    sh_q[lane][col * kV + j] = ss[j];
  }
  __syncthreads();
  for (int stride = kLanes / 2; stride > 0; stride >>= 1) {
    if (lane < stride) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        sh_s[lane][col * kV + j] += sh_s[lane + stride][col * kV + j];
        sh_q[lane][col * kV + j] += sh_q[lane + stride][col * kV + j];
      }
    }
    __syncthreads();
  }
  if (lane == 0 && c0 < c) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const long long at = ((long long)b * c + c0 + j) * parts + part;
      psum[at] = sh_s[0][col * kV + j];
      psq[at] = sh_q[0][col * kV + j];
    }
  }
}

// One warp per row: the sum of its `parts` partials, lane-strided then the
// xor tree.
__global__ void __launch_bounds__(32 * kWarps)
gn_stats_final_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                      float* __restrict__ sum, float* __restrict__ sumsq, int rows, int parts) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* ps = psum + (long long)row * parts;
  const float* pq = psq + (long long)row * parts;
  float s = 0.0f, ss = 0.0f;
  for (int p = lane; p < parts; p += 32) {
    s += ps[p];
    ss += pq[p];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    sum[row] = s;
    sumsq[row] = ss;
  }
}

// y = x·w[b, ch] + shift[b, ch] (+ SiLU) over [B, C, n] (NCHW) or [B, n, C]
// (NHWC) elements; w and shift are [B, C]. One thread per kV elements (VEC:
// 16 bytes; n, or C for NHWC, a multiple of kV), grid-stride.
template <typename T, bool VEC, bool SILU, bool NHWC>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                T* __restrict__ y, long long total, int n, int c) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const long long packs = total / kV;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < packs;
       p += (long long)gridDim.x * blockDim.x) {
    const long long i = p * kV;
    // the (b, ch) of the first element: NCHW shares it across the pack,
    // NHWC steps one channel per element
    const long long at = NHWC ? i / ((long long)n * c) * c + i % c : i / n;
    alignas(16) T v[kV];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(x + i));
    } else {
      v[0] = x[i];
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float wr = to_f(w[NHWC ? at + j : at]), br = to_f(b[NHWC ? at + j : at]);
      // explicit roundings: no fused multiply-add, as PyTorch's separate ops
      float u = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(to_f(v[j]), wr)), br));
      if constexpr (SILU) u = __fdiv_rn(u, 1.0f + expf(-u));
      v[j] = from_f<T>(u);
    }
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(y + i) = *reinterpret_cast<const uint4*>(v);
    } else {
      y[i] = v[0];
    }
  }
}

template <typename T, bool VEC>
void stats_nchw(const T* x, float* out_s, float* out_q, int rows, int n, int chunk, int parts,
                cudaStream_t stream) {
  const long long items = (long long)rows * parts;
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  gn_stats_partial_kernel<T, VEC><<<blocks, 32 * kWarps, 0, stream>>>(x, out_s, out_q, items, n, chunk, parts);
}

template <typename T, bool VEC>
void stats_nhwc(const T* x, float* out_s, float* out_q, int batch, int c, int n, int rows, int parts,
                cudaStream_t stream) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const dim3 grid((c + 8 * kV - 1) / (8 * kV), parts, batch);
  gn_stats_nhwc_partial_kernel<T, VEC><<<grid, 32 * kWarps, 0, stream>>>(x, out_s, out_q, n, c, rows, parts);
}

template <typename T>
int stats(const void* xv, float* sum, float* sumsq, float* psum, float* psq, int batch, int c, int n,
          int chunk, bool nhwc, bool vec, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const int rows = batch * c;
  const int parts = (n + chunk - 1) / chunk;
  // one part a sample: the partials are the sums
  float* out_s = parts == 1 ? sum : psum;
  float* out_q = parts == 1 ? sumsq : psq;
  if (nhwc) {
    if (vec) {
      stats_nhwc<T, true>(x, out_s, out_q, batch, c, n, chunk, parts, stream);
    } else {
      stats_nhwc<T, false>(x, out_s, out_q, batch, c, n, chunk, parts, stream);
    }
  } else if (vec) {
    stats_nchw<T, true>(x, out_s, out_q, rows, n, chunk, parts, stream);
  } else {
    stats_nchw<T, false>(x, out_s, out_q, rows, n, chunk, parts, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  gn_stats_final_kernel<<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      psum, psq, sum, sumsq, rows, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, bool NHWC>
void apply_launch(const void* x, const void* w, const void* b, void* y, long long total, int n, int c,
                  bool silu, cudaStream_t stream) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const long long packs = total / kV;
  const unsigned blocks =
      (unsigned)std::min<long long>((packs + kApplyThreads - 1) / kApplyThreads, 1LL << 20);
  const T *xp = static_cast<const T*>(x), *wp = static_cast<const T*>(w), *bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (silu) {
    gn_apply_kernel<T, VEC, true, NHWC><<<blocks, kApplyThreads, 0, stream>>>(xp, wp, bp, yp, total, n, c);
  } else {
    gn_apply_kernel<T, VEC, false, NHWC><<<blocks, kApplyThreads, 0, stream>>>(xp, wp, bp, yp, total, n, c);
  }
}

template <typename T>
int apply(const void* x, const void* w, const void* b, void* y, int batch, int c, int n, bool silu,
          bool nhwc, bool vec, cudaStream_t stream) {
  const long long total = (long long)batch * c * n;
  if (nhwc) {
    if (vec) {
      apply_launch<T, true, true>(x, w, b, y, total, n, c, silu, stream);
    } else {
      apply_launch<T, false, true>(x, w, b, y, total, n, c, silu, stream);
    }
  } else if (vec) {
    apply_launch<T, true, false>(x, w, b, y, total, n, c, silu, stream);
  } else {
    apply_launch<T, false, false>(x, w, b, y, total, n, c, silu, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, c, n] contiguous (nhwc = 0) or [batch, n, c] (nhwc = 1: a
// channels-last tensor), bf16 (x_bf16 = 1) or fp32. sum, sumsq: [batch, c]
// fp32 out. psum, psq: [batch·c, ceil(n / chunk)] fp32 scratch (unused when
// n <= chunk). chunk: elements of an NCHW row that one warp sums (a multiple
// of 8), or NHWC rows that one block sums. vec = 1 takes 16-byte loads: the
// caller sets it only when x is 16-byte aligned and the contiguous extent (n
// for NCHW, c for NHWC) times the element size is a multiple of 16. Returns
// the CUDA error code of the launches (0 on success).
int fdt_group_norm_stats(const void* x, void* sum, void* sumsq, void* psum, void* psq, int batch,
                         int c, int n, int chunk, int x_bf16, int nhwc, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *o_s = static_cast<float*>(sum), *o_q = static_cast<float*>(sumsq);
  float *p_s = static_cast<float*>(psum), *p_q = static_cast<float*>(psq);
  return x_bf16 ? stats<bf16>(x, o_s, o_q, p_s, p_q, batch, c, n, chunk, nhwc != 0, vec != 0, s)
                : stats<float>(x, o_s, o_q, p_s, p_q, batch, c, n, chunk, nhwc != 0, vec != 0, s);
}

// x, y: [batch, c, n] or (nhwc = 1) [batch, n, c], contiguous; w, b: [batch,
// c] (the folded scale and shift), all bf16 (x_bf16 = 1) or all fp32. silu
// = 1 applies SiLU after the shift. vec as above (y 16-byte aligned too).
int fdt_group_norm_apply(const void* x, const void* w, const void* b, void* y, int batch, int c,
                         int n, int silu, int x_bf16, int nhwc, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? apply<bf16>(x, w, b, y, batch, c, n, silu != 0, nhwc != 0, vec != 0, s)
                : apply<float>(x, w, b, y, batch, c, n, silu != 0, nhwc != 0, vec != 0, s);
}

}  // extern "C"
