// One-shot flash-attention backward for Hopper (sm_90a): K8, dQ, dK and dV
// of heads whose whole KV fits one block.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py
// _flash_bwd_oneshot_kernel (via _flash_bwd_oneshot_bhsd). Same math and
// rounding points as K6/K7 (flash_bwd.cu): P = exp(S * scale - lse) in fp32,
// dS = P * (dP - delta), dV = P^T(bf16).dO, dK = dS^T(bf16).Q * scale,
// dQ = dS(bf16).K * scale. SD1.5 training sends it every cross-attention
// over the 77 text tokens (D = 40, 80, 160) and the mid block's 64-token
// self-attention.
//
// The TPU kernel holds three [KV, Sq] fp32 tiles of one head in VMEM
// (about 12 MB); a Hopper block has 227 KB. Here a block keeps the head's
// K and V (kv_len rows, zero-padded to kvp, a multiple of 16) and fp32 dK
// and dV accumulators in shared memory, and walks q tiles of bq rows: each
// q tile's dQ is complete inside the block (no atomics) and is written
// straight out. dK and dV are sums over all of Sq. One block per head would
// leave most of the 132 SMs idle (32 or 64 heads on the slice), so Sq is
// split across nsplit blocks per head; each writes its partial fp32 dK and
// dV to a workspace, and a second, small kernel sums the partials in a fixed
// order and rounds once to bf16. Deterministic, at the cost of one fp32
// round trip of [nsplit, BH, kvp, dp] through device memory (a few MB).
//
// What bounds it on this card: tensor-core products from shared memory
// (S, dP, dQ, dV, dK: five of 2.Sq.KV.D) and the softmax gradient between
// them; K and V are read from device memory once per split.
//
// Design points: the host (ops/attention.py attention_bwd_plan) picks bq
// (64 or 32) so that the layout fits; dQ goes through a per-warp 16x16 fp32
// scratch tile to be scaled and rounded on store; rows past Sq or kv_len
// are zero-filled and their P set to 0.

#include "bwd_tiles.cuh"

namespace {

using namespace fdt_bwd;

constexpr int kScratch = kWarps * 16 * 16 * 4;

__global__ void __launch_bounds__(kThreads)
flash_bwd_oneshot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, float* __restrict__ ws, int bh_total, int sq,
                         int skv, int d, int dp, int kv_len, float scale, int bq, int kvp,
                         int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(bq, kvp, dp, kvp, dp, 2, kScratch);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* dos = reinterpret_cast<bf16*>(smem + L.off_do);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.off_k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);
  float* lse_s = reinterpret_cast<float*>(smem + L.off_lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.off_delta);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* dps = reinterpret_cast<float*>(smem + L.off_dp);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.off_p);
  bf16* dss = reinterpret_cast<bf16*>(smem + L.off_ds);
  float* acc_k = reinterpret_cast<float*>(smem + L.off_acc);
  float* acc_v = acc_k + align128(L.acc_floats * 4) / 4;
  float* scratch = reinterpret_cast<float*>(smem + L.off_scratch);

  const size_t bh = blockIdx.y;
  const int split = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  zero_floats(acc_k, L.acc_floats);
  zero_floats(acc_v, L.acc_floats);
  load_rows(ks, L.ld_x, k + bh * skv * d, 0, kvp, kv_len, d, dp);
  load_rows(vs, L.ld_x, v + bh * skv * d, 0, kvp, kv_len, d, dp);

  const int n_q_tiles = (sq + bq - 1) / bq;
  const int t_end = min(n_q_tiles, (split + 1) * tiles_per_split);
  bf16* dqh = dq + bh * sq * d;
  float* wscratch = scratch + warp * 256;
  for (int t = split * tiles_per_split; t < t_end; ++t) {
    const int q0 = t * bq;
    load_rows(qs, L.ld_x, q + bh * sq * d, q0, bq, sq, d, dp);
    load_rows(dos, L.ld_x, dout + bh * sq * d, q0, bq, sq, d, dp);
    load_vec(lse_s, lse + bh * sq, q0, bq, sq);
    load_vec(delta_s, delta + bh * sq, q0, bq, sq);
    __syncthreads();
    mma_tiles<false, true>(ss, L.ld_s, qs, L.ld_x, ks, L.ld_x, bq, kvp, dp, false);
    mma_tiles<false, true>(dps, L.ld_s, dos, L.ld_x, vs, L.ld_x, bq, kvp, dp, false);
    __syncthreads();
    softmax_grad(L, ss, dps, ps, dss, lse_s, delta_s, bq, kvp, sq - q0, kv_len, scale);
    __syncthreads();
    // dQ = dS.K for this q tile, complete here: through the warp's scratch
    // tile, scaled and rounded on store
    const int tn = dp / 16;
    for (int tile = warp; tile < (bq / 16) * tn; tile += kWarps) {
      const int r0 = (tile / tn) * 16;
      const int c0 = (tile % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k0 = 0; k0 < kvp; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, dss + r0 * L.ld_p + k0, L.ld_p);
        wmma::load_matrix_sync(fb, ks + k0 * L.ld_x + c0, L.ld_x);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(wscratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = q0 + r0 + e / 16;
        const int c = c0 + e % 16;
        if (r < sq && c < d) dqh[(size_t)r * d + c] = __float2bfloat16(wscratch[e] * scale);
      }
      __syncwarp();
    }
    // this split's partial dV += P^T.dO and dK += dS^T.Q
    mma_tiles<true, false>(acc_v, dp, ps, L.ld_p, dos, L.ld_x, kvp, dp, bq, true);
    mma_tiles<true, false>(acc_k, dp, dss, L.ld_p, qs, L.ld_x, kvp, dp, bq, true);
    __syncthreads();
  }
  __syncthreads();
  // partials to the workspace: [2][nsplit][bh_total][kvp][dp] fp32
  const size_t part = (size_t)kvp * dp;
  const size_t half = (size_t)gridDim.x * bh_total * part;
  float* wk = ws + ((size_t)split * bh_total + bh) * part;
  float* wv = wk + half;
  for (int i = threadIdx.x; i < L.acc_floats; i += kThreads) {
    wk[i] = acc_k[i];
    wv[i] = acc_v[i];
  }
}

// dk, dv [bh, skv, d] bf16 = the sums of the nsplit partials (dk times
// scale); rows >= kvp (keys past kv_len) are zeros.
__global__ void flash_bwd_oneshot_reduce_kernel(const float* __restrict__ ws,
                                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                                int nsplit, int bh_total, int skv, int d, int dp,
                                                int kvp, float scale) {
  const size_t n = (size_t)bh_total * skv * d;
  const size_t part = (size_t)kvp * dp;
  const size_t half = (size_t)nsplit * bh_total * part;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = idx % d;
    const int r = (idx / d) % skv;
    const size_t bh = idx / ((size_t)d * skv);
    float sk = 0.0f, sv = 0.0f;
    if (r < kvp) {
      for (int s = 0; s < nsplit; ++s) {
        const size_t at = ((size_t)s * bh_total + bh) * part + (size_t)r * dp + c;
        sk += ws[at];
        sv += ws[half + at];
      }
    }
    dk[idx] = __float2bfloat16(sk * scale);
    dv[idx] = __float2bfloat16(sv);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one K8 block (BwdLayout); the planner
// (ops/attention.py bwd_smem_bytes) mirrors it.
int fdt_flash_bwd_smem_bytes(int bq, int bkv, int dp, int acc_rows, int dc, int n_acc,
                             int scratch) {
  return BwdLayout(bq, bkv, dp, acc_rows, dc, n_acc, scratch).bytes;
}

// K8: dq [bh, sq, d], dk, dv [bh, skv, d] bf16 from q, dout [bh, sq, d],
// k, v [bh, skv, d] bf16 and lse, delta [bh, sq] fp32; kvp = round_up(
// kv_len, 16) keys per block, q tiles of bq rows, Sq split over nsplit
// blocks per head (tiles_per_split q tiles each), ws an fp32 workspace of
// 2 * nsplit * bh * kvp * round_up(d, 16) floats. Two launches (the blocks, then the sum of
// their partials); returns the CUDA error code (0 on success).
int fdt_flash_bwd_oneshot(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, void* ws, void* dk,
                          void* dv, int bh, int sq, int skv, int d, int kv_len, float scale,
                          int bq, int kvp, int nsplit, int tiles_per_split, void* stream) {
  const int dp = (d + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = BwdLayout(bq, kvp, dp, kvp, dp, 2, kScratch).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_oneshot_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_oneshot_kernel<<<dim3(nsplit, bh), kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<float*>(ws), bh, sq,
      skv, d, dp, kv_len, scale, bq, kvp, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)bh * skv * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_bwd_oneshot_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(dk), static_cast<bf16*>(dv), nsplit, bh,
      skv, d, dp, kvp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
