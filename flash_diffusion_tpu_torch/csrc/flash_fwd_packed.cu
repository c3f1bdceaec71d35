// Packed streaming flash-attention forward for Hopper (sm_90a): long KV
// (self-attention), every head read and written in the projection-native
// [B, S, H*D] layout, so no head transposes around the call.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py
// _flash_fwd_packed_kernel (via _flash_fwd_packed), the inference primal
// that _attn_primal picks under FLASH_TPU_ATTN_PACKED=1 (head dim 64 or
// 128, at least 2 heads, no kv_valid, no gradient). For every head h:
//   out[b, s, h*D:(h+1)*D] = softmax(q_h . k_h^T * scale) . v_h
// by online softmax over KV tiles (running max m, denominator l and an
// fp32 accumulator), p rounded to bf16 before p.v, keys past the end of KV
// masked to -1e30, no lse output. SDXL sends it its self-attention under
// the switch: [B, 4096, 10*64] at level 1 and [B, 1024, 20*64] at level 2
// and in the mid block (the port routes the 1024-token call here too:
// ops/attention.py).
//
// What bounds it on this card: 4*B*H*Sq*KV*D operations at 989 TFLOP/s
// (171.8 GFLOP, 0.174 ms at [4, 4096, 4096, 10*64]): tensor-core issue and
// the exp of every score. The design is flash_fwd_mma.cu's (K2), with the
// row stride of the packed layout in place of D: a block takes 64 q rows
// of one head (16 per warp), walks that head's K and V in tiles of 64
// keys, double-buffered with cp.async, q.k^T and p.v on mma.sync m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix, scores and accumulator in
// registers (the q.k^T accumulator fragment, after the softmax, is the A
// fragment of p.v), softmax in base 2 (scores scaled by scale * log2(e),
// ex2.approx). The grid is (ceil(Sq / 64), H, B): at [4, 4096, 10*64],
// 2560 blocks for 132 SMs.
//
// Design points:
//   - The TPU blocking does not carry over: JAX loops every head inside a
//     (bq, H*D) block with one (bq, 128) scratch column per head for m and
//     l; a block here holds one head, which keeps a warp's accumulator at
//     16 x D in registers. Rows of q, K, V and out are read and written
//     with stride H*D, the head's D columns as one contiguous 16-byte-
//     aligned run (H*D*2 and h*D*2 are multiples of 16 for D in {64, 128};
//     the host checks the base pointers).
//   - K/V rows >= KV are zero-filled and their scores set to -1e30, so p =
//     0 exactly and never meets garbage V; q rows >= Sq are zero-filled and
//     never written.
//   - The scale is applied to the fp32 scores, never folded into bf16 q.
//   - Each thread keeps partial row sums; the 4 threads of a row reduce
//     them once, at the end, and the output is divided by the fp32 sum.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kBQ = 64;   // q rows per block: one 16-row group per warp
constexpr int kBKV = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// q tile, then two K and two V tiles, rows padded by 8 bf16 (16 bytes) so
// that the eight rows one ldmatrix reads fall in distinct banks: 46,080
// bytes at D = 64, 87,040 at D = 128.
template <int D>
constexpr int smem_bytes() { return (kBQ + 4 * kBKV) * (D + 8) * 2; }

// Rows [row0, row0 + nrows) of a row-major bf16 matrix with row stride
// `stride`, D columns starting at src, into a shared tile of row stride
// D + 8; rows >= valid_rows become zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int stride, int row0,
                                          int nrows, int valid_rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < valid_rows;
    cp_async16(dst + r * (D + 8) + c, valid ? src + (size_t)gr * stride + c : src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int skv,
                        int hd, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;    // k-steps of q.k^T
  constexpr int ND = D / 8;     // n-tiles of the output
  constexpr int NT = kBKV / 8;  // n-tiles of the scores
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * LD;       // [2][kBKV * LD]
  bf16* vs = ks + 2 * kBKV * LD;  // [2][kBKV * LD]

  const int q0 = blockIdx.x * kBQ;
  const int col0 = blockIdx.y * D;  // this head's first column
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* kh = k + b * skv * hd + col0;
  const bf16* vh = v + b * skv * hd + col0;

  load_rows<D>(qs, q + b * sq * hd + col0, hd, q0, kBQ, sq);
  load_rows<D>(ks, kh, hd, 0, kBKV, skv);
  load_rows<D>(vs, vh, hd, 0, kBKV, skv);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows lane/4 and lane/4 + 8
  float l[2] = {0.0f, 0.0f};        // this thread's partial row sums

  const int n_tiles = (skv + kBKV - 1) / kBKV;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<D>(ks + (buf ^ 1) * kBKV * LD, kh, hd, (j + 1) * kBKV, kBKV, skv);
      load_rows<D>(vs + (buf ^ 1) * kBKV * LD, vh, hd, (j + 1) * kBKV, kBKV, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }

    // scores s = q . k^T for this warp's 16 rows x kBKV keys
    const bf16* kb = ks + buf * kBKV * LD;
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, kb + (nt * 8 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 +
                             ((lane / 8) % 2) * 8);
        mma16816(s[nt], qf[kk], bfr[0], bfr[1]);
        mma16816(s[nt + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // online softmax (base 2) on the fragments: element e of n-tile nt is
    // row lane/4 (+8 for e >= 2), key kv0 + nt*8 + 2*(lane%4) + (e&1)
    const int kv0 = j * kBKV;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const float x = col < skv ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // o += p . v: the score fragments of keys 16kc..16kc+15 are the A fragment
    const bf16* vb = vs + buf * kBKV * LD;
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vb + (kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + nd * 8 +
                                   (lane / 16) * 8);
        mma16816(o[nd], a, bfr[0], bfr[1]);
        mma16816(o[nd + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = q0 + warp * 16 + lane / 4;
  bf16* orow = out + (b * sq + row) * hd + col0 + 2 * (lane % 4);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (row < sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
          __floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);
    if (row + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * (size_t)hd + nd * 8) =
          __floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv, int h,
           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_packed_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_packed_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, skv, h * D, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Packed streaming forward. q [b, sq, h*d], k/v [b, skv, h*d], out [b, sq,
// h*d], all bf16 and contiguous; d in {64, 128}. Returns the CUDA error
// code of the launch (0 on success).
int fdt_flash_fwd_packed(const void* q, const void* k, const void* v, void* out, int b, int sq,
                         int skv, int h, int d, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || h < 1 || h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, b, sq, skv, h, scale, s);
    case 128: return launch<128>(q, k, v, out, b, sq, skv, h, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
