// Block-level tile helpers shared by the flash-attention backward kernels
// (flash_bwd.cu: K6 dK/dV and K7 dQ; flash_bwd_oneshot.cu: K8).
//
// Every tile lives in shared memory; products are warp-level bf16 MMAs
// (nvcuda::wmma 16x16x16, fp32 accumulate) that read their operands from
// shared memory and, for the sums that run over many tiles (dK, dV, dQ),
// load and store their fp32 accumulators there too, so that no accumulator
// width is bounded by registers (the VAE's D = 512 included). Scores are
// kept in the [q, kv] orientation in all three kernels; the transposed
// products (P^T.dO, dS^T.Q) read P and dS as column-major A fragments, so
// nothing is transposed in memory.
//
// Shared-memory layout: every buffer starts on a 128-byte boundary. The
// Python planner (ops/attention.py bwd_smem_bytes) mirrors this arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace fdt_bwd {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Tiles of one block: q and dO [bq, dp] and k and v [bkv, dp] (bf16, row
// stride dp + 8), the q rows' lse and delta (fp32), the scores S and dP
// [bq, bkv] (fp32, stride bkv + 4), P and dS [bq, bkv] (bf16, stride
// bkv + 8), n_acc fp32 accumulators of [acc_rows, dc], and a scratch area.
struct BwdLayout {
  int ld_x, ld_s, ld_p;
  int off_q, off_do, off_k, off_v, off_lse, off_delta, off_s, off_dp, off_p, off_ds, off_acc,
      off_scratch;
  int acc_floats;  // floats of one accumulator
  int bytes;

  __host__ __device__ BwdLayout(int bq, int bkv, int dp, int acc_rows, int dc, int n_acc,
                                int scratch) {
    ld_x = dp + 8;
    ld_s = bkv + 4;
    ld_p = bkv + 8;
    acc_floats = acc_rows * dc;
    int off = 0;
    off_q = off; off += align128(bq * ld_x * 2);
    off_do = off; off += align128(bq * ld_x * 2);
    off_k = off; off += align128(bkv * ld_x * 2);
    off_v = off; off += align128(bkv * ld_x * 2);
    off_lse = off; off += align128(bq * 4);
    off_delta = off; off += align128(bq * 4);
    off_s = off; off += align128(bq * ld_s * 4);
    off_dp = off; off += align128(bq * ld_s * 4);
    off_p = off; off += align128(bq * ld_p * 2);
    off_ds = off; off += align128(bq * ld_p * 2);
    off_acc = off; off += n_acc * align128(acc_floats * 4);
    off_scratch = off; off += align128(scratch);
    bytes = off;
  }
};

// Rows [row0, row0 + nrows) of a row-major [*, d] bf16 matrix into a
// [nrows, dp] shared tile of stride ld; rows >= valid_rows and columns >= d
// become zeros. d % 8 == 0 and a 16-byte aligned source (the host checks).
__device__ inline void load_rows(bf16* dst, int ld, const bf16* src, int row0, int nrows,
                                 int valid_rows, int d, int dp) {
  const int chunks = dp / 8;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < valid_rows && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// dst[r] = src[row0 + r], 0 past valid_rows.
__device__ inline void load_vec(float* dst, const float* src, int row0, int n, int valid_rows) {
  for (int r = threadIdx.x; r < n; r += kThreads) dst[r] = row0 + r < valid_rows ? src[row0 + r] : 0.0f;
}

__device__ inline void zero_floats(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.0f;
}

// C[m, n] (fp32, stride ldc) = A.B, or += when accumulate, one 16x16 tile
// of C per warp turn; m, n and k are multiples of 16. A is [m][k] row-major
// (kATrans false) or stored [k][m] (kATrans true: the transpose of a
// row-major tile); B is [k][n] row-major (kBTrans false) or stored [n][k]
// (kBTrans true).
template <bool kATrans, bool kBTrans>
__device__ inline void mma_tiles(float* c, int ldc, const bf16* a, int lda, const bf16* b,
                                 int ldb, int m, int n, int k, bool accumulate) {
  typedef typename std::conditional<kATrans, wmma::col_major, wmma::row_major>::type LA;
  typedef typename std::conditional<kBTrans, wmma::col_major, wmma::row_major>::type LB;
  const int warp = threadIdx.x / 32;
  const int tn = n / 16;
  const int tiles = (m / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int r0 = (t / tn) * 16;
    const int c0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, c + r0 * ldc + c0, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
    for (int k0 = 0; k0 < k; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, kATrans ? a + k0 * lda + r0 : a + r0 * lda + k0, lda);
      wmma::load_matrix_sync(fb, kBTrans ? b + c0 * ldb + k0 : b + k0 * ldb + c0, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + r0 * ldc + c0, acc, ldc, wmma::mem_row_major);
  }
}

// The scores of one (q tile, kv tile) pair, after S = Q.K^T and dP = dO.V^T:
// P = exp(S * scale - lse) in fp32 (exactly 0 for q rows >= q_valid and keys
// >= kv_valid, the -1e30 mask of the TPU kernels), dS = P * (dP - delta);
// both rounded to bf16 for the products that follow.
__device__ inline void softmax_grad(const BwdLayout& L, const float* s, const float* dpv, bf16* p,
                                    bf16* ds, const float* lse, const float* delta, int bq,
                                    int bkv, int q_valid, int kv_valid, float scale) {
  for (int idx = threadIdx.x; idx < bq * bkv; idx += kThreads) {
    const int r = idx / bkv;
    const int c = idx - r * bkv;
    float pv = 0.0f;
    if (r < q_valid && c < kv_valid) pv = __expf(s[r * L.ld_s + c] * scale - lse[r]);
    p[r * L.ld_p + c] = __float2bfloat16(pv);
    ds[r * L.ld_p + c] = __float2bfloat16(pv * (dpv[r * L.ld_s + c] - delta[r]));
  }
}

}  // namespace fdt_bwd
