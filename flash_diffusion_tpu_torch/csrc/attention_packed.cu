// Packed one-shot attention forward for Hopper (sm_90a): short KV (text
// cross-attention), all heads read and written in the projection-native
// [B, S, H*D] layout, so no head transposes around the call.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py
// _flash_fwd_oneshot_packed_kernel (via _flash_fwd_packed), the inference
// primal that _attn_primal picks when _packed_cross_eligible holds (head
// dim 64 or 128, at least 2 heads, KV padded to 128 at most 256, no
// kv_valid). For every head h:
//   out[b, s, h*D:(h+1)*D] = (bf16(p) . v_h) / l,  p = exp(s_h - m),
//   s_h = q_h . k_h^T * scale (fp32), m = max over keys, l = sum of p (fp32)
// exact softmax over the whole KV in one pass (no running max), no lse
// output. SDXL sends it every cross-attention over the 77 text tokens: [B,
// 4096, 10*64] at level 1 and [B, 1024, 20*64] at level 2 and in the mid
// block, 70 calls per UNet forward.
//
// What bounds it on this card: at KV = 77 a q row meets 80 keys, so the
// two products are ~20 kFLOP per 128 bytes of q read and 128 bytes of out
// written per head; with K and V of a head (20 KB) re-read by every q tile
// from L2, the kernel sits near the memory side of the roofline, and the
// products run on the warp-level bf16 MMA (mma.sync m16n8k16, fp32
// accumulate) fed by ldmatrix, as in flash_fwd_mma.cu.
//
// Design points:
//   - The TPU blocking does not carry over: JAX keeps every head's K and V
//     in one VMEM block, which at level 2 (80 padded keys x 1280 columns x
//     K and V) is 410 KB, beyond the 227 KB of shared memory a block has.
//     A block here takes 64 q rows of one head and that head's whole
//     padded KV (32 KB at D = 64, KV = 77; 156 KB at D = 128, KV = 256).
//     The grid is (ceil(Sq / 64), H, B): at level 1, batch 4, 2560 blocks
//     for 132 SMs. Rows of q, K, V and out are read and written with stride
//     H*D, the head's D columns as one contiguous run. Groups of 2, 4 and 5
//     heads per block (K/V of the group loaded once, heads looped inside)
//     measured 1.3x to 2.3x slower at SDXL's shapes: fewer, larger blocks
//     hide less load latency.
//   - Exact one-shot softmax with scores in registers: each warp owns 16 q
//     rows and walks the keys in chunks of 16 twice, first for the row max
//     m, then for p = exp(s - m), l and the p.v product (q.k^T is computed
//     twice, in place of keeping up to 256 scores a row in registers or
//     shared memory). p is rounded to bf16 before p.v and the sum of fp32 p
//     divides the output, as in the Pallas kernel.
//   - KV is padded to KVP = round_up(KV, 16) in shared memory: rows at or
//     beyond KV are zero-filled by cp.async and their scores set to -1e30,
//     so p = exp2(-1e30 - m) = 0 exactly. q rows beyond Sq are zero-filled
//     and never written out.
//   - q and K arrive in one cp.async group and V in a second, so the max
//     pass runs while V is still loading.
//   - The softmax runs in base 2 (scores scaled by scale * log2(e),
//     ex2.approx), as flash_fwd_mma.cu does.
//   - 16-byte loads need H*D*2 and the column offsets to be multiples of
//     16 bytes: true for D in {64, 128}; the host checks the base pointers.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kBQ = 64;  // q rows per block: one 16-row group per warp
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block: a [kBQ, D] q tile and [KVP, D] K and V
// tiles, rows padded by 8 bf16 (16 bytes) so that the eight rows an
// ldmatrix reads fall in distinct banks. ops/attention.py mirrors this.
__host__ __device__ inline int packed_smem_bytes(int d, int kvp) {
  return (kBQ + 2 * kvp) * (d + 8) * 2;
}

// Rows [row0, row0 + nrows) of a row-major bf16 matrix with row stride
// `stride`, `width` columns starting at src, into a shared tile of row
// stride ld; rows >= valid_rows become zeros. width % 8 == 0 and 16-byte
// aligned rows (the host checks).
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int stride,
                                          int row0, int nrows, int valid_rows, int width) {
  const int chunks = width / 8;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < valid_rows;
    cp_async16(dst + r * ld + c, valid ? src + (size_t)gr * stride + c : src, valid);
  }
}

// Scores of this warp's 16 q rows against 16 keys: s[0] keys 0..7, s[1]
// keys 8..15 of the chunk whose ldmatrix row pointer is kp.
template <int KD>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], const uint32_t (&qf)[KD][4],
                                             const bf16* kp) {
#pragma unroll
  for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, kp + kk * 16);
    mma16816(s[0], qf[kk], b[0], b[1]);
    mma16816(s[1], qf[kk], b[2], b[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_oneshot_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
                                int skv, int hd, int kvp, float scale_log2) {
  constexpr int KD = D / 16;  // k-steps of q.k^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int ld = D + 8;   // shared row stride
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * ld;
  bf16* vs = ks + kvp * ld;

  const int q0 = blockIdx.x * kBQ;
  const int col0 = blockIdx.y * D;  // this head's first column
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rows(qs, ld, q + b * sq * hd + col0, hd, q0, kBQ, sq, D);
  load_rows(ks, ld, k + b * skv * hd + col0, hd, 0, kvp, skv, D);
  cp_async_commit();
  load_rows(vs, ld, v + b * skv * hd + col0, hd, 0, kvp, skv, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int n_chunks = kvp / 16;
  const int row = q0 + warp * 16 + lane / 4;  // and row + 8
  bf16* orow = out + (b * sq + row) * hd + col0 + 2 * (lane % 4);
  // ldmatrix row pointers (see flash_fwd_mma.cu): q rows of this warp; K
  // rows as the B operand of q.k^T; V rows, transposed, as that of p.v
  const bf16* qrow = qs + (warp * 16 + lane % 16) * ld + (lane / 16) * 8;
  const bf16* krow = ks + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  const bf16* vrow = vs + (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);

  // pass 1: the row max of the scaled, masked scores
  float mx[2] = {kNegInf, kNegInf};
  for (int ci = 0; ci < n_chunks; ++ci) {
    float s[2][4];
    chunk_scores<KD>(s, qf, krow + ci * 16 * ld);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ci * 16 + nt * 8 + 2 * (lane % 4) + (e & 1);
        mx[e >> 1] = fmaxf(mx[e >> 1], col < skv ? s[nt][e] * scale_log2 : kNegInf);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  cp_async_wait<0>();  // V, for every warp, before p.v
  __syncthreads();

  // pass 2: p = exp2(s - m), l = sum(p), o = bf16(p) . v
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float l[2] = {0.0f, 0.0f};
  for (int ci = 0; ci < n_chunks; ++ci) {
    float s[2][4];
    chunk_scores<KD>(s, qf, krow + ci * 16 * ld);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ci * 16 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const float x = col < skv ? s[nt][e] * scale_log2 : kNegInf;
        const float p = fast_exp2(x - mx[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    const bf16* vb = vrow + ci * 16 * ld;
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vb + nd * 8);
      mma16816(o[nd], a, bv[0], bv[1]);
      mma16816(o[nd + 1], a, bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (row < sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
          __floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);
    if (row + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)8 * hd + nd * 8) =
          __floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv, int h,
           float scale, cudaStream_t stream) {
  const int kvp = (skv + 15) / 16 * 16;
  const int bytes = packed_smem_bytes(D, kvp);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_oneshot_packed_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_oneshot_packed_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, skv, h * D, kvp, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at head dim d and kvp (a
// multiple of 16) padded keys.
int fdt_packed_smem_bytes(int d, int kvp) { return packed_smem_bytes(d, kvp); }

// Packed one-shot forward. q [b, sq, h*d], k/v [b, skv, h*d], out [b, sq,
// h*d], all bf16 and contiguous; d in {64, 128}. Returns the CUDA error
// code of the launch (0 on success).
int fdt_flash_fwd_oneshot_packed(const void* q, const void* k, const void* v, void* out, int b,
                                 int sq, int skv, int h, int d, float scale, void* stream) {
  if (skv < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, b, sq, skv, h, scale, s);
    case 128: return launch<128>(q, k, v, out, b, sq, skv, h, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
