// W8A8 int8 GEMM with the dequant epilogue fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/gemm.py
// _int8_gemm_kernel (via int8_gemm): y[M, N] = act(float(sum_k xq[m, k] *
// wq[n, k]) * sx[m] * sw[n] + bias[n]), int8 operands, exact int32
// accumulation, the per-token and per-channel scales, the bias and the
// optional tanh-gelu applied in registers before one bf16 store (a second
// epilogue stores the raw int32 sums, for checks). The weight is
// [N, K], the nn.Linear layout, which is exactly the ".col" B operand of
// mma.sync, so nothing is transposed. Every W8A8 product of the int8
// serving path (attention q/k/v/out, the feed-forward's two projections,
// the spatial transformers' proj_in/proj_out) lands here, whatever its
// shape.
//
// What bounds it on this card: at the SDXL shapes (M = 4096-16384 tokens,
// K and N 640-10240) the product is far above the H100's ridge (1979 int8
// TOP/s over 3.35 TB/s), so the tensor cores bound it. The design is the plain
// Ampere-style one: a 128 x 128 output tile per block of 8 warps (2 x 4,
// 64 x 32 each), K in steps of 64 bytes, mma.sync m16n8k32 (s8 in, s32
// accumulate) fed by ldmatrix from shared memory, the next K step loaded
// with cp.async behind the current one (two stages). wgmma with s8
// operands, TMA and a persistent schedule come later.
//
// Design points:
//   - ldmatrix moves 8 x 16-byte rows; for int8 a 16-byte row is 16 values
//     of K, and the fragment it hands each thread (4 bytes of row lane/4 at
//     byte 4*(lane%4)) is exactly the s8 A (and, on the [N, K] weight, B)
//     fragment of m16n8k32. Shared rows are 80 bytes apart, so the 8 row
//     addresses of one ldmatrix fall in distinct banks.
//   - Rows of M and N past the end load as zeros (cp.async with a zero
//     source size) and are never stored; K % 32 == 0 (the host checks), and
//     a K step past K loads zeros.
//   - The epilogue multiplies and adds with explicit round-to-nearest
//     intrinsics, in the order of the plain version (acc * sx * sw + bias),
//     so that no fused multiply-add changes the fp32 value before the store.

#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile; K step in bytes
constexpr int kThreads = 256;                  // 8 warps: 2 along M x 4 along N
constexpr int kLD = kBK + 16;                  // shared row stride (bytes)
constexpr int kStage = (kBM + kBN) * kLD;      // bytes of one stage's A and B tiles
constexpr int kSmemBytes = 2 * kStage;         // 40 KB: no opt-in needed

enum OutKind { kOutBf16 = 0, kOutInt32 = 1 };

__device__ __forceinline__ void ldmatrix_x4_b8(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x32, row) . b (32x8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a row-major [rows, k]
// int8 matrix into a shared tile of row stride kLD; out of range -> zeros.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int row0, int rows,
                                          int k0, int k) {
  constexpr int kChunks = kBK / 16;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 16;
    const bool valid = row0 + r < rows && k0 + c < k;
    cp_async16(dst + r * kLD + c, valid ? src + (size_t)(row0 + r) * k + k0 + c : src, valid);
  }
}

__device__ __forceinline__ float gelu_tanh(float y) {
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.0f + tanhf(u));
}

template <int OUT>
__device__ __forceinline__ void store2(void* out, size_t at, float y0, float y1, int a0, int a1,
                                       bool pair, bool second) {
  if (OUT == kOutBf16) {
    bf16* o = static_cast<bf16*>(out) + at;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
    } else {
      o[0] = __float2bfloat16_rn(y0);
      if (second) o[1] = __float2bfloat16_rn(y1);
    }
  } else {
    int* o = static_cast<int*>(out) + at;
    if (pair) {
      *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
    } else {
      o[0] = a0;
      if (second) o[1] = a1;
    }
  }
}

template <int OUT, bool GELU>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, void* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // this warp's first row and column in the tile
  const int wn = (warp % 4) * 32;

  int acc[4][4][4];  // [m-tile of 16][n-tile of 8][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_steps = (k + kBK - 1) / kBK;
  load_tile(tiles, xq, m0, m, 0, k);
  load_tile(tiles + kBM * kLD, wq, n0, n, 0, k);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int8_t* as = tiles + (step & 1) * kStage;
    const int8_t* bs = as + kBM * kLD;
    if (step + 1 < n_steps) {
      int8_t* next = tiles + ((step + 1) & 1) * kStage;
      load_tile(next, xq, m0, m, (step + 1) * kBK, k);
      load_tile(next + kBM * kLD, wq, n0, n, (step + 1) * kBK, k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_b8(a[mt], as + (wm + mt * 16 + lane % 16) * kLD + kk + (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // one ldmatrix: two n-tiles x both K halves
        uint32_t r[4];
        ldmatrix_x4_b8(r, bs + (wn + np * 16 + (lane / 16) * 8 + lane % 8) * kLD + kk +
                              ((lane / 8) % 2) * 16);
        b[2 * np][0] = r[0], b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: element e of a fragment sits at row lane/4 (+8 for e >= 2),
  // column 2*(lane%4) + (e&1)
  const bool even_n = n % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + lane / 4 + half * 8;
      if (row >= m) continue;
      const float xs = OUT == kOutInt32 ? 0.0f : sx[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * (lane % 4);
        if (col >= n) continue;
        const bool second = col + 1 < n;
        const int a0 = acc[mt][nt][2 * half], a1 = acc[mt][nt][2 * half + 1];
        float y[2] = {0.0f, 0.0f};
        if (OUT != kOutInt32) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 1 && !second) break;
            float v = __fmul_rn(__fmul_rn(static_cast<float>(e ? a1 : a0), xs), sw[col + e]);
            if (bias != nullptr) v = __fadd_rn(v, bias[col + e]);
            y[e] = GELU ? gelu_tanh(v) : v;
          }
        }
        store2<OUT>(out, (size_t)row * n + col, y[0], y[1], a0, a1, second && even_n, second);
      }
    }
  }
}

template <int OUT, bool GELU>
int launch(const void* xq, const void* wq, const void* sx, const void* sw, const void* bias,
           void* out, int m, int n, int k, cudaStream_t stream) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<OUT, GELU><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xq [m, k] and wq [n, k] int8, row-major, 16-byte aligned, k % 32 == 0;
// sx [m], sw [n] and bias [n] (or null) fp32. out [m, n]: bf16
// (out_kind 0) with the epilogue, tanh-gelu when gelu != 0; or the raw
// int32 sums (1: scales, bias and gelu unused). Returns the CUDA
// error code of the launch (0 on success).
int fdt_int8_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                  const void* bias, void* out, int m, int n, int k, int out_kind, int gelu,
                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind * 2 + (gelu ? 1 : 0)) {
    case 0: return launch<kOutBf16, false>(xq, wq, sx, sw, bias, out, m, n, k, s);
    case 1: return launch<kOutBf16, true>(xq, wq, sx, sw, bias, out, m, n, k, s);
    case 2: return launch<kOutInt32, false>(xq, wq, sx, sw, bias, out, m, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
