// One-shot flash-attention forward for Hopper (sm_90a): K1, bf16 in, fp32
// softmax, the whole KV of one (batch*head) resident in shared memory.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py:171
// _flash_fwd_oneshot_kernel (via _flash_fwd_oneshot_bhsd, :491):
// softmax(q.k^T * scale).v over the whole, zero-padded KV; out [BH, Sq, D]
// (bf16) and the per-row logsumexp lse [BH, Sq] (fp32); KV positions >=
// kv_len masked to -1e30 before the softmax. SD1.5 sends it every
// cross-attention (77 text tokens) and the 64- and 256-token
// self-attention. Longer KV streams through flash_fwd_mma.cu (K2).
//
// What bounds it on this card: at the UNet's shapes the bytes (q, k, v and
// out once: 4.BH.(Sq + KV).D against 4.BH.Sq.KV.D operations, 77 keys
// are far below the card's 295 operations a byte), then the issue of the
// products and the exps. So the block must not spend its time moving the
// same K and V again, or moving scores through shared memory:
//   - Scores in registers. Each warp owns 16 q rows: q.k^T is mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix, and its fp32
//     accumulator fragments, exponentiated and packed to bf16, are exactly
//     the A fragments of p.v (the trick of K2, flash_fwd_mma.cu). Scores,
//     probabilities and the output accumulator never leave registers; the
//     output is divided by the row sum there and stored as bf16 pairs.
//   - Where a row's scores and its output fit registers together (up to
//     128 keys at D <= 80, 80 keys above), the softmax is exact over the
//     whole row in one pass, as the TPU kernel's is. Past that (256 keys at
//     D = 160) a second set of warps takes the upper half of the keys for
//     the same q rows (8 warps a block, so that the SM holding the block's
//     193 KB has twice the warps in flight); each walks its half of the
//     resident K and V in chunks with a running max and row sum, and the
//     halves merge at the end: the same function to rounding.
//   - K and V of the head are copied into shared memory once per block by
//     cp.async, in two commit groups: V lands behind the first chunk's
//     scores and softmax. Only Q, K and V live in shared memory, so the q
//     tile is not bounded by a score tile: 64 rows (4 warps) wherever that
//     fits. Smaller tiles that would fill the card at Sq = 64 (128 blocks
//     of 16 rows for 32 heads, not 32 of 64) measured slower on an H100:
//     each block reloads the head's K and V. A row's result does not
//     depend on the tile.
//   - No block-wide barrier between the products: one after Q and K land,
//     one after V lands.
//
// Design points:
//   - D is zero-padded to DP = round_up(D, 16) in shared memory (cp.async
//     with a zero source size writes zeros); nothing is read past a row.
//   - K and V rows at or beyond kv_len (kv_valid masking, the ragged tail,
//     the padding to a multiple of 16) are written as zeros and their
//     scores set to -1e30, so p = 0 exactly and never meets garbage V.
//   - The scale is applied to the fp32 scores, never folded into bf16 q;
//     the softmax runs in base 2 (scores times scale * log2(e), ex2.approx).
//   - Head dims up to 160 (the output accumulator of a 16-row band is D / 2
//     registers a thread); the host routes larger ones to K2.
//   - The dynamic shared-memory limit is raised once per process and card.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kMaxThreads = 256;  // at most 8 warps: a 64-row q tile, two key halves
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keys of one chunk: a warp's scores are kChunk / 2 registers a thread,
// its output accumulator DP / 2.
template <int DP>
struct OneshotCfg {
  static constexpr int kLD = DP + 8;  // shared row stride (16-byte multiple; ldmatrix rows hit every bank)
  static constexpr int kChunk = DP <= 80 ? 128 : 80;
};

// Key halves of a block: 1, or 2 where the keys take more than one chunk;
// then a second set of warps takes the upper half of the keys for the same
// q rows, and the two halves' (max, sum, output) merge at the end.
template <int DP>
__host__ __device__ inline int key_halves(int kvp) {
  return kvp > OneshotCfg<DP>::kChunk ? 2 : 1;
}

// Bytes of dynamic shared memory of a block: Q [bq, DP], K and V [kvp, DP]
// in bf16, row stride DP + 8. The planner (ops/attention.py smem_bytes)
// mirrors it.
__host__ __device__ inline int smem_bytes(int bq, int kvp, int dp) { return (bq + 2 * kvp) * (dp + 8) * 2; }

// Rows [row0, row0 + nrows) of a row-major [*, d] matrix into a [nrows, DP]
// shared tile of row stride DP + 8 by cp.async; rows >= valid_rows and
// columns >= d become zeros. d % 8 == 0 and a 16-byte aligned source (the
// host checks both).
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int nrows, int valid_rows, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < valid_rows && c < d;
    cp_async16(dst + r * (DP + 8) + c, valid ? src + (size_t)gr * d + c : src, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_oneshot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         bf16* __restrict__ out, float* __restrict__ lse, int sq, int skv, int d, int kv_len,
                         float scale_log2) {
  typedef OneshotCfg<DP> C;
  constexpr int LD = C::kLD;
  constexpr int KD = DP / 16;           // k-steps of q.k^T
  constexpr int ND = DP / 8;            // n-tiles of the output
  constexpr int NT = C::kChunk / 8;     // n-tiles of a chunk's scores
  extern __shared__ __align__(128) unsigned char smem[];
  const int kvp = (kv_len + 15) / 16 * 16;
  const int kh = key_halves<DP>(kvp);
  const int bq = blockDim.x / (2 * kh);  // 16 q rows a warp of each half
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + bq * LD;
  bf16* vs = ks + kvp * LD;

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int band = warp % (bq / 16);  // this warp's 16 q rows
  const int half = warp / (bq / 16);  // and its keys: [0, mid) or [mid, kvp)
  const int mid = kh == 1 ? kvp : (kvp / 16 + 1) / 2 * 16;
  const int lo = half == 0 ? 0 : mid, hi = half == 0 ? mid : kvp;

  // group 0: Q and K; group 1: V, which lands behind the first scores
  load_rows<DP>(qs, q + bh * sq * d, q0, bq, sq, d);
  load_rows<DP>(ks, k + bh * skv * d, 0, kvp, kv_len, d);
  cp_async_commit();
  load_rows<DP>(vs, v + bh * skv * d, 0, kvp, kv_len, d);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const bf16* qrow = qs + (band * 16 + lane % 16) * LD + (lane / 16) * 8;
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows lane/4 and lane/4 + 8
  float l[2] = {0.0f, 0.0f};        // this thread's partial row sums

  for (int kv0 = lo; kv0 < hi; kv0 += C::kChunk) {
    const int nk = min(C::kChunk, hi - kv0) / 16;  // 16-key steps in this chunk
    const int lim = min(kv_len, kv0 + nk * 16);    // keys at or past it get -1e30

    // scores s = q . k^T for this warp's 16 rows x the chunk's keys
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qrow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        if (nt / 2 < nk) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (kv0 + nt * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
          mma16816(s[nt], a, b[0], b[1]);
          mma16816(s[nt + 1], a, b[2], b[3]);
        }
      }
    }

    // the softmax on the fragments: element e of n-tile nt is row lane/4
    // (+8 for e >= 2), key kv0 + nt*8 + 2*(lane%4) + (e&1); keys at or past
    // kv_len, and those past the chunk's last step, get -1e30, so p = 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const float x = c < lim ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);  // 0 on the first chunk
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
    if (kv0 == lo) {  // every warp takes this branch once: V has landed everywhere after it
      cp_async_wait<0>();
      __syncthreads();
    }

    // o += p . v: the score fragments of keys 16kc..16kc+15 are the A fragment
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      if (kc < nk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kv0 + kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + nd * 8 + (lane / 16) * 8);
          mma16816(o[nd], a, b[0], b[1]);
          mma16816(o[nd + 1], a, b[2], b[3]);
        }
      }
    }
  }

  if (kh == 2) {  // the second half's (m, l, o) into the first's, through the dead Q, K and V
    float* buf = reinterpret_cast<float*>(smem) + band * (ND * 4 + 4) * 32 + lane;
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(nd * 4 + e) * 32] = o[nd][e];
      }
      buf[ND * 128] = m[0], buf[ND * 128 + 32] = m[1], buf[ND * 128 + 64] = l[0], buf[ND * 128 + 96] = l[1];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = buf[ND * 128 + 32 * r], mx = fmaxf(m[r], m1);
      const float a0 = fast_exp2(m[r] - mx), a1 = fast_exp2(m1 - mx);
      l[r] = l[r] * a0 + buf[ND * 128 + 64 + 32 * r] * a1;
      m[r] = mx;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * r] = o[nd][2 * r] * a0 + buf[(nd * 4 + 2 * r) * 32] * a1;
        o[nd][2 * r + 1] = o[nd][2 * r + 1] * a0 + buf[(nd * 4 + 2 * r + 1) * 32] * a1;
      }
    }
  }

  // out = o / l in registers, stored as bf16 pairs; lse = m ln 2 + ln l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  const int row = q0 + band * 16 + lane / 4;
  bf16* oh = out + bh * sq * d;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * (lane % 4);
    if (col < d) {  // d % 8 == 0: a pair is inside d or past it
      if (row < sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * d + col) =
            __floats2bfloat162_rn(o[nd][0] * inv[0], o[nd][1] * inv[0]);
      if (row + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(row + 8) * d + col) =
            __floats2bfloat162_rn(o[nd][2] * inv[1], o[nd][3] * inv[1]);
    }
  }
  if (lane % 4 == 0) {
    if (row < sq) lse[bh * sq + row] = m[0] * kLn2 + logf(l[0]);
    if (row + 8 < sq) lse[bh * sq + row + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq, int skv, int d,
           int kv_len, float scale, int bq, cudaStream_t stream) {
  static unsigned done = 0;
  cudaError_t err = allow_max_smem(flash_fwd_oneshot_kernel<DP>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kvp = (kv_len + 15) / 16 * 16, threads = bq * 2 * key_halves<DP>(kvp);
  if (bq % 16 || bq < 16 || threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((sq + bq - 1) / bq, bh);
  flash_fwd_oneshot_kernel<DP><<<grid, threads, smem_bytes(bq, kvp, DP), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, skv, d, kv_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a q tile of bq rows
// and kvp keys at padded head dim dp.
int fdt_attn_smem_bytes(int bq, int kvp, int dp) { return smem_bytes(bq, kvp, dp); }

// One-shot forward: the whole KV (kv_len rows, zero-padded to a multiple
// of 16) in shared memory, q tiles of bq rows (16, 32, 48 or 64). q [bh,
// sq, d], k/v [bh, skv, d] bf16, d % 8 == 0 and d <= 160; out [bh, sq, d]
// bf16; lse [bh, sq] fp32. Returns the CUDA error code of the launch (0 on
// success).
int fdt_flash_fwd_oneshot(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
                          int skv, int d, int kv_len, float scale, int bq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d % 8 ? 0 : (d + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 2: return launch<32>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 3: return launch<48>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 4: return launch<64>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 5: return launch<80>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 6: return launch<96>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 7: return launch<112>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 8: return launch<128>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 9: return launch<144>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    case 10: return launch<160>(q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, bq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
