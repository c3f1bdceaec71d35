// One-shot flash-attention forward for Hopper (sm_90a): bf16 in, fp32
// softmax, the whole KV of one (batch*head) in shared memory.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py
// _flash_fwd_oneshot_kernel (via _flash_fwd_oneshot_bhsd): softmax(q.k^T *
// scale).v over the whole, zero-padded KV in one pass, exact (no running
// max); out [BH, Sq, D] (bf16) and the per-row logsumexp lse [BH, Sq]
// (fp32); KV positions >= kv_len masked to -1e30 before the softmax. SD1.5
// sends it every cross-attention (77 text tokens) and the 64- and 256-token
// self-attention. Longer KV streams through flash_fwd_mma.cu.
//
// What bounds it on this card: the two matrix products (q.k^T and p.v) and
// the fp32 softmax over every score; K/V are read once per 16..64 q rows,
// so device traffic stays below the tensor-core time. The limit of this
// first version is issue rate: tiles live in shared memory, the products
// use the warp-level bf16 MMA (nvcuda::wmma 16x16x16, fp32 accumulate), and
// the softmax runs on plain threads between them, with a block-wide barrier
// between phases. No TMA, no wgmma: later work.
//
// Design points:
//   - Head dims 40 and 80 are not multiples of the MMA depth (16). D is
//     zero-padded to DP = round_up(D, 16) in shared memory; the loader
//     writes zeros for the padded columns and never reads past a row.
//   - K and V rows at or beyond kv_len (kv_valid masking, the ragged tail,
//     the padding to a multiple of 16) are written as zeros and their
//     scores set to -1e30, so p = exp(-1e30 - m) = 0 exactly and 0 * V adds
//     nothing. Every shared tile that is read was written first.
//   - The scale is applied to the fp32 scores (never folded into bf16 q).
//   - The host picks the q tile (ops/attention.py attention_plan): 64 rows
//     where the tile set fits 227 KB, else 32 or 16.
//   - The grid is (ceil(Sq / BQ), B*H): at Sq = 4096 cross-attention with
//     B*H = 32 and BQ = 64 that is 2048 blocks for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout, computed identically on the host (to size the
// launch) and on the device (to carve the buffer). Every buffer starts on a
// 128-byte boundary, which covers the 32-byte alignment wmma needs. The
// Python planner in ops/attention.py mirrors this arithmetic.
struct Layout {
  int ld_qkv;  // bf16 row stride of the Q, K and V tiles (DP + 8)
  int ld_s;    // fp32 row stride of the score tile (KVP + 4)
  int ld_p;    // bf16 row stride of the probability tile (KVP + 8)
  int off_q, off_k, off_v, off_s, off_p, off_scratch, off_m, off_l;
  int bytes;

  __host__ __device__ Layout(int bq, int kvp, int dp) {
    ld_qkv = dp + 8;
    ld_s = kvp + 4;
    ld_p = kvp + 8;
    int off = 0;
    off_q = off; off += align128(bq * ld_qkv * 2);
    off_k = off; off += align128(kvp * ld_qkv * 2);
    off_v = off; off += align128(kvp * ld_qkv * 2);
    off_s = off; off += align128(bq * ld_s * 4);
    off_p = off; off += align128(bq * ld_p * 2);
    off_scratch = off; off += align128(kWarps * 16 * 16 * 4);
    off_m = off; off += align128(bq * 4);
    off_l = off; off += align128(bq * 4);
    bytes = off;
  }
};

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + nrows) of a row-major [*, d] bf16 matrix into a
// [nrows, dp] shared tile with row stride ld. Rows >= valid_rows and columns
// >= d are written as zeros. Needs d % 8 == 0 and a 16-byte aligned source
// (the host checks both): each thread moves 16 bytes at a time.
__device__ inline void load_rows(bf16* dst, int ld, const bf16* src, int row0, int nrows,
                                 int valid_rows, int d, int dp) {
  const int chunks = dp / 8;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < valid_rows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[bq, kvp] = Q[bq, dp] . K[kvp, dp]^T in fp32, one 16x16 tile per warp turn.
__device__ inline void qk_scores(const bf16* qs, const bf16* ks, float* ss, const Layout& L,
                                 int bq, int kvp, int dp) {
  const int warp = threadIdx.x / 32;
  const int tiles_n = kvp / 16;
  const int tiles = (bq / 16) * tiles_n;
  for (int t = warp; t < tiles; t += kWarps) {
    const int r0 = (t / tiles_n) * 16;
    const int c0 = (t % tiles_n) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < dp; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + r0 * L.ld_qkv + k0, L.ld_qkv);
      // K stored [n][k] row-major is K^T [k][n] in column-major order
      wmma::load_matrix_sync(b, ks + c0 * L.ld_qkv + k0, L.ld_qkv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ss + r0 * L.ld_s + c0, acc, L.ld_s, wmma::mem_row_major);
  }
}

// Softmax over the score tile, one warp per row: scales and masks the
// scores, writes the bf16 probabilities P = exp(s - m), and leaves the row
// max m and denominator l = sum(P) (from the fp32 values) for the epilogue.
__device__ inline void softmax_rows(float* ss, bf16* ps, float* m_s, float* l_s, const Layout& L,
                                    int bq, int kvp, int kv_len, float scale) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < bq; r += kWarps) {
    float* srow = ss + r * L.ld_s;
    bf16* prow = ps + r * L.ld_p;
    float mx = kNegInf;
    for (int c = lane; c < kvp; c += 32) {
      const float s = c < kv_len ? srow[c] * scale : kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < kvp; c += 32) {
      const float p = __expf(srow[c] - mx);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_oneshot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int sq, int skv, int d, int dp, int kv_len,
                         float scale, int bq, int kvp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(bq, kvp, dp);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.off_k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.off_p);
  float* scratch = reinterpret_cast<float*>(smem + L.off_scratch);
  float* m_s = reinterpret_cast<float*>(smem + L.off_m);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rows(qs, L.ld_qkv, q + bh * sq * d, q0, bq, sq, d, dp);
  load_rows(ks, L.ld_qkv, k + bh * skv * d, 0, kvp, kv_len, d, dp);
  load_rows(vs, L.ld_qkv, v + bh * skv * d, 0, kvp, kv_len, d, dp);
  __syncthreads();
  qk_scores(qs, ks, ss, L, bq, kvp, dp);
  __syncthreads();
  softmax_rows(ss, ps, m_s, l_s, L, bq, kvp, kv_len, scale);
  __syncthreads();

  // out = (P . V) / l, one 16x16 output tile per warp turn, staged through
  // the warp's own 16x16 fp32 scratch so that rows can be divided by l.
  bf16* oh = out + bh * sq * d;
  float* wscratch = scratch + warp * 256;
  const int tiles_n = dp / 16;
  const int tiles = (bq / 16) * tiles_n;
  for (int t = warp; t < tiles; t += kWarps) {
    const int r0 = (t / tiles_n) * 16;
    const int c0 = (t % tiles_n) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < kvp; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + r0 * L.ld_p + k0, L.ld_p);
      wmma::load_matrix_sync(b, vs + k0 * L.ld_qkv + c0, L.ld_qkv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(wscratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16;
      const int c = c0 + e % 16;
      if (q0 + r < sq && c < d) {
        oh[(size_t)(q0 + r) * d + c] = __float2bfloat16(wscratch[e] / l_s[r]);
      }
    }
    __syncwarp();
  }
  for (int r = threadIdx.x; r < bq; r += kThreads) {
    if (q0 + r < sq) lse[bh * sq + q0 + r] = m_s[r] + logf(l_s[r]);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for the given tiles.
int fdt_attn_smem_bytes(int bq, int kvp, int dp) { return Layout(bq, kvp, dp).bytes; }

// One-shot forward: the whole KV (kv_len rows, zero-padded to kvp, a
// multiple of 16) in shared memory. q [bh, sq, d], k/v [bh, skv, d] bf16;
// out [bh, sq, d] bf16; lse [bh, sq] fp32. Returns the CUDA error code of
// the launch (0 on success).
int fdt_flash_fwd_oneshot(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int sq, int skv, int d, int kv_len, float scale, int bq,
                          int kvp, void* stream) {
  const int dp = (d + 15) / 16 * 16;
  const int bytes = Layout(bq, kvp, dp).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_oneshot_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + bq - 1) / bq, bh);
  flash_fwd_oneshot_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), sq, skv, d, dp, kv_len, scale, bq,
      kvp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
