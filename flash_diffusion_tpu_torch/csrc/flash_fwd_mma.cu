// Streaming flash-attention forward for Hopper (sm_90a) at head dims 129
// to 512: scores, probabilities and the output accumulator stay in
// registers.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py:85
// _flash_fwd_kernel (via _flash_fwd_bhsd) above D = 128 (the VAE's
// single-head D = 512 attention); head dims up to 128 take the wgmma kernel
// of flash_fwd_wgmma.cu, whose one-warpgroup accumulator of 64 rows x D
// would not fit the registers here. Online softmax over KV tiles with a
// running max, denominator and fp32 accumulator; out [BH, Sq, D] bf16 and
// lse [BH, Sq] fp32; KV positions >= kv_len masked to -1e30.
//
// What bounds it on this card: tensor-core issue and the exp of every score.
// The design is FlashAttention-2's: 64 q rows per block, 16 per warp; q·k^T
// and p·v are warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed
// by ldmatrix from shared memory; the scores never leave registers (the
// accumulator fragment of q·k^T is, after the softmax, exactly the A
// fragment p·v needs), so a KV tile costs one barrier and no shared-memory
// round trip of scores or output. K and V tiles are double-buffered with
// cp.async, so the next tile loads behind the current tile's products. The
// softmax runs in base 2 (scores pre-scaled by scale * log2(e), ex2.approx).
//
// Head dims above 160 do not fit one warp's registers (a 16 x 512 fp32
// accumulator is 128 registers a thread on its own). There two warps share
// each 16-row group and split the output columns; each computes the group's
// scores itself (q·k^T twice, 1.5x the products of the unsplit kernel, in
// place of a shared-memory exchange), q fragments are re-read from shared
// memory per tile, and KV tiles are 32 keys so that all tiles fit 227 KB.
//
// Design points:
//   - D is zero-padded to DP (a multiple of 16; of 64 above 160) in shared
//     memory (cp.async with a zero source size writes zeros); nothing is
//     read past a row.
//   - K/V rows >= kv_len are zero-filled and their scores set to -1e30, so
//     p = 0 exactly and never meets garbage V.
//   - The scale is applied to the fp32 scores, never folded into bf16 q.
//   - Each thread keeps partial row sums; the 4 threads of a row reduce them
//     once, at the end.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kBQ = 64;  // q rows per block: 4 row groups of 16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiling for a padded head dim DP.
template <int DP>
struct Tiles {
  static constexpr int kWarpsD = DP <= 160 ? 1 : 2;  // warps splitting the output columns
  static constexpr int kThreads = 128 * kWarpsD;
  static constexpr int kBKV = DP <= 160 ? 64 : 32;
  static constexpr bool kQInRegs = kWarpsD == 1;  // q fragments held for the whole block
  static constexpr int kLD = DP + 8;              // shared row stride (16-byte multiple)
  static constexpr int kSmemBytes = (kBQ + 4 * kBKV) * kLD * 2;
};

// Rows [row0, row0 + nrows) of a row-major [*, d] matrix into a [nrows, DP]
// shared tile of row stride DP + 8; rows >= valid_rows and columns >= d
// become zeros. d % 8 == 0 and a 16-byte aligned source (the host checks).
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int nrows,
                                          int valid_rows, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += Tiles<DP>::kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < valid_rows && c < d;
    cp_async16(dst + r * (DP + 8) + c, valid ? src + (size_t)gr * d + c : src, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(Tiles<DP>::kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int sq, int skv, int d, int kv_len,
                     float scale_log2) {
  typedef Tiles<DP> T;
  constexpr int LD = T::kLD;
  constexpr int BKV = T::kBKV;
  constexpr int KD = DP / 16;                // k-steps of q.k^T
  constexpr int DO = DP / T::kWarpsD;        // output columns of one warp
  constexpr int ND = DO / 8;                 // n-tiles of a warp's output
  constexpr int NT = BKV / 8;                // n-tiles of the scores
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * LD;      // [2][BKV * LD]
  bf16* vs = ks + 2 * BKV * LD;  // [2][BKV * LD]

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % 4;  // this warp's 16-row group
  const int c0 = (warp / 4) * DO;  // and the first of its output columns
  const bf16* kh = k + bh * skv * d;
  const bf16* vh = v + bh * skv * d;
  const bf16* qrow = qs + (rg * 16 + (lane % 16)) * LD + (lane / 16) * 8;

  load_tile<DP>(qs, q + bh * sq * d, q0, kBQ, sq, d);
  load_tile<DP>(ks, kh, 0, BKV, kv_len, d);
  load_tile<DP>(vs, vh, 0, BKV, kv_len, d);
  cp_async_commit();

  uint32_t qf[T::kQInRegs ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows lane/4 and lane/4 + 8
  float l[2] = {0.0f, 0.0f};        // this thread's partial row sums

  const int n_tiles = (kv_len + BKV - 1) / BKV;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<DP>(ks + (buf ^ 1) * BKV * LD, kh, (j + 1) * BKV, BKV, kv_len, d);
      load_tile<DP>(vs + (buf ^ 1) * BKV * LD, vh, (j + 1) * BKV, BKV, kv_len, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (T::kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }

    // scores s = q . k^T for this warp's 16 rows x BKV keys
    const bf16* kb = ks + buf * BKV * LD;
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (T::kQInRegs) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (nt * 8 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma16816(s[nt], a, b[0], b[1]);
        mma16816(s[nt + 1], a, b[2], b[3]);
      }
    }

    // online softmax (base 2) on the fragments: element e of n-tile nt is
    // row lane/4 (+8 for e >= 2), key kv0 + nt*8 + 2*(lane%4) + (e&1)
    const int kv0 = j * BKV;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const float x = col < kv_len ? s[nt][e] * scale_log2 : kNegInf;
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

    // o += p . v over this warp's columns: the score fragments of keys
    // 16kc..16kc+15 are the A fragment
    const bf16* vb = vs + buf * BKV * LD + c0;
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (kc * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + nd * 8 +
                                 (lane / 16) * 8);
        mma16816(o[nd], a, b[0], b[1]);
        mma16816(o[nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = q0 + rg * 16 + lane / 4;
  bf16* oh = out + bh * sq * d;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = c0 + nd * 8 + 2 * (lane % 4);
    if (col < d) {
      if (row < sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * d + col) =
            __floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);
      if (row + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(row + 8) * d + col) =
            __floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);
    }
  }
  if (c0 == 0 && lane % 4 == 0) {
    if (row < sq) lse[bh * sq + row] = m[0] * kLn2 + logf(l[0]);
    if (row + 8 < sq) lse[bh * sq + row + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
           int skv, int d, int kv_len, float scale, cudaStream_t stream) {
  typedef Tiles<DP> T;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_mma_kernel<DP><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), sq, skv, d, kv_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Streaming forward for head dims 128 < d <= 512 (d % 8 == 0). q [bh, sq,
// d], k/v [bh, skv, d] bf16; out [bh, sq, d] bf16; lse [bh, sq] fp32.
// Returns the CUDA error code of the launch (0 on success).
int fdt_flash_fwd_stream_mma(const void* q, const void* k, const void* v, void* out, void* lse,
                             int bh, int sq, int skv, int d, int kv_len, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 || d <= 128 || d > 512) return static_cast<int>(cudaErrorInvalidValue);
  switch (d <= 160 ? (d + 15) / 16 * 16 : (d + 63) / 64 * 64) {
    case 144: return launch<144>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 160: return launch<160>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 192: return launch<192>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 256: return launch<256>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 320: return launch<320>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 384: return launch<384>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 448: return launch<448>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    case 512: return launch<512>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
