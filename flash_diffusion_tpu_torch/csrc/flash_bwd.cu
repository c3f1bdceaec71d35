// Streaming flash-attention backward for Hopper (sm_90a): K6 (dK, dV) and
// K7 (dQ), from the forward's lse and delta = rowsum(dO * O).
//
// Replaces the Pallas TPU kernels flash_diffusion_tpu/ops/attention.py
// _flash_bwd_dkv_kernel (K6) and _flash_bwd_dq_kernel (K7), both called
// from _flash_bwd_bhsd. Same math and rounding points:
//   S = Q.K^T (fp32), P = exp(S * scale - lse) (fp32; keys >= kv_len give
//   P = 0 exactly), dP = dO.V^T (fp32), dS = P * (dP - delta) (fp32);
//   dV = P^T(bf16).dO, dK = dS^T(bf16).Q * scale, dQ = dS(bf16).K * scale,
//   each summed in fp32 and rounded to bf16 once, on store.
// SD1.5 training sends them the 1024- and 4096-token self-attention of the
// UNet (D = 80, 40) and of the VAE decoder's single-head D = 512 mid-block
// (the LPIPS loss differentiates the decode); everything whose KV fits one
// block takes the one-shot K8 (flash_bwd_oneshot.cu).
//
// What bounds it on this card: the tensor cores, and before them shared
// memory. K6 recomputes S and dP per (kv tile, q tile) and does two more
// products (P^T.dO, dS^T.Q); K7 recomputes S and dP again and does dS.K:
// seven products of 2.Sq.KV.D where the work needs five, as on the TPU. A
// block holds its resident tiles (K6: a kv tile of K and V; K7: a q tile of
// Q, dO, lse, delta) and walks the other side's tiles; the sum over that
// walk stays in the block (fp32 accumulators in shared memory), so there
// are no atomics and the result is deterministic. The TPU carried the same
// sum across sequential grid steps in VMEM scratch.
//
// Design points:
//   - wmma 16x16x16 products from shared memory, block-wide barriers
//     between phases (load, S and dP, softmax gradient, accumulate); no
//     cp.async pipelining, TMA or wgmma yet: later work.
//   - D is zero-padded to DP = round_up(D, 16); rows past Sq or kv_len are
//     zero-filled and their P set to 0.
//   - The accumulators' output columns can be split across blocks (grid.z,
//     chunks of dc columns): at D = 512 a kv tile's fp32 dK and dV would not
//     fit 227 KB at any useful tile size. Each chunk's block recomputes S and
//     dP over the full D. The host (ops/attention.py attention_bwd_plan)
//     picks the tiles and dc so that the layout fits.

#include "bwd_tiles.cuh"

namespace {

using namespace fdt_bwd;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int d,
                     int dp, int kv_len, float scale, int bq, int bkv, int dc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(bq, bkv, dp, bkv, dc, 2, 0);
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

  const size_t bh = blockIdx.y;
  const int kv0 = blockIdx.x * bkv;
  const int c0 = blockIdx.z * dc;
  zero_floats(acc_k, L.acc_floats);
  zero_floats(acc_v, L.acc_floats);
  if (kv0 < kv_len) {
    load_rows(ks, L.ld_x, k + bh * skv * d, kv0, bkv, kv_len, d, dp);
    load_rows(vs, L.ld_x, v + bh * skv * d, kv0, bkv, kv_len, d, dp);
    for (int q0 = 0; q0 < sq; q0 += bq) {
      load_rows(qs, L.ld_x, q + bh * sq * d, q0, bq, sq, d, dp);
      load_rows(dos, L.ld_x, dout + bh * sq * d, q0, bq, sq, d, dp);
      load_vec(lse_s, lse + bh * sq, q0, bq, sq);
      load_vec(delta_s, delta + bh * sq, q0, bq, sq);
      __syncthreads();
      mma_tiles<false, true>(ss, L.ld_s, qs, L.ld_x, ks, L.ld_x, bq, bkv, dp, false);
      mma_tiles<false, true>(dps, L.ld_s, dos, L.ld_x, vs, L.ld_x, bq, bkv, dp, false);
      __syncthreads();
      softmax_grad(L, ss, dps, ps, dss, lse_s, delta_s, bq, bkv, sq - q0, kv_len - kv0, scale);
      __syncthreads();
      // dV += P^T.dO and dK += dS^T.Q over this block's dc columns
      mma_tiles<true, false>(acc_v, dc, ps, L.ld_p, dos + c0, L.ld_x, bkv, dc, bq, true);
      mma_tiles<true, false>(acc_k, dc, dss, L.ld_p, qs + c0, L.ld_x, bkv, dc, bq, true);
      __syncthreads();
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bkv * dc; idx += kThreads) {
    const int r = idx / dc;
    const int c = idx - r * dc;
    const int gr = kv0 + r;
    const int gc = c0 + c;
    if (gr < skv && gc < d) {
      const size_t at = (bh * skv + gr) * d + gc;
      dk[at] = __float2bfloat16(acc_k[idx] * scale);
      dv[at] = __float2bfloat16(acc_v[idx]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int skv, int d, int dp, int kv_len,
                    float scale, int bq, int bkv, int dc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(bq, bkv, dp, bq, dc, 1, 0);
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
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int c0 = blockIdx.z * dc;
  zero_floats(acc, L.acc_floats);
  load_rows(qs, L.ld_x, q + bh * sq * d, q0, bq, sq, d, dp);
  load_rows(dos, L.ld_x, dout + bh * sq * d, q0, bq, sq, d, dp);
  load_vec(lse_s, lse + bh * sq, q0, bq, sq);
  load_vec(delta_s, delta + bh * sq, q0, bq, sq);
  for (int kv0 = 0; kv0 < kv_len; kv0 += bkv) {
    load_rows(ks, L.ld_x, k + bh * skv * d, kv0, bkv, kv_len, d, dp);
    load_rows(vs, L.ld_x, v + bh * skv * d, kv0, bkv, kv_len, d, dp);
    __syncthreads();
    mma_tiles<false, true>(ss, L.ld_s, qs, L.ld_x, ks, L.ld_x, bq, bkv, dp, false);
    mma_tiles<false, true>(dps, L.ld_s, dos, L.ld_x, vs, L.ld_x, bq, bkv, dp, false);
    __syncthreads();
    softmax_grad(L, ss, dps, ps, dss, lse_s, delta_s, bq, bkv, sq - q0, kv_len - kv0, scale);
    __syncthreads();
    // dQ += dS.K over this block's dc columns
    mma_tiles<false, false>(acc, dc, dss, L.ld_p, ks + c0, L.ld_x, bq, dc, bkv, true);
    __syncthreads();
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bq * dc; idx += kThreads) {
    const int r = idx / dc;
    const int c = idx - r * dc;
    const int gr = q0 + r;
    const int gc = c0 + c;
    if (gr < sq && gc < d) dq[(bh * sq + gr) * d + gc] = __float2bfloat16(acc[idx] * scale);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one backward block (all three kernels).
int fdt_flash_bwd_smem_bytes(int bq, int bkv, int dp, int acc_rows, int dc, int n_acc,
                             int scratch) {
  return BwdLayout(bq, bkv, dp, acc_rows, dc, n_acc, scratch).bytes;
}

// K6: dk, dv [bh, skv, d] bf16 from q, dout [bh, sq, d], k, v [bh, skv, d]
// bf16 and lse, delta [bh, sq] fp32. Tiles bq x bkv (multiples of 16),
// output columns in chunks of dc (dc divides round_up(d, 16)). Returns the
// CUDA error code of the launch (0 on success).
int fdt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                      int skv, int d, int kv_len, float scale, int bq, int bkv, int dc,
                      void* stream) {
  const int dp = (d + 15) / 16 * 16;
  const int bytes = BwdLayout(bq, bkv, dp, bkv, dc, 2, 0).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((skv + bkv - 1) / bkv, bh, dp / dc);
  flash_bwd_dkv_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv,
      d, dp, kv_len, scale, bq, bkv, dc);
  return static_cast<int>(cudaGetLastError());
}

// K7: dq [bh, sq, d] bf16 from the same inputs and tiles as K6.
int fdt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int sq, int skv, int d,
                     int kv_len, float scale, int bq, int bkv, int dc, void* stream) {
  const int dp = (d + 15) / 16 * 16;
  const int bytes = BwdLayout(bq, bkv, dp, bq, dc, 1, 0).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + bq - 1) / bq, bh, dp / dc);
  flash_bwd_dq_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), sq, skv, d, dp, kv_len, scale,
      bq, bkv, dc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
