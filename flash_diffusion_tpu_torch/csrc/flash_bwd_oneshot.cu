// One-shot flash-attention backward for Hopper (sm_90a): K8, dQ, dK and dV
// of heads whose whole KV fits one block.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py:769
// _flash_bwd_oneshot_kernel (via _flash_bwd_oneshot_bhsd, :813). Same math
// and rounding points as K6/K7 (flash_bwd.cu) and attention_bwd_reference:
// P = exp(S * scale - lse) in fp32 (0 for keys >= kv_len), dS = P * (dP -
// delta), dV = P^T(bf16).dO, dK = dS^T(bf16).Q * scale, dQ = dS(bf16).K *
// scale, each summed in fp32 and rounded to bf16 once. SD1.5 training sends
// it every cross-attention over the 77 text tokens (D = 40, 80, 160) and
// the mid block's 64-token self-attention.
//
// What bounds it on this card: at 77 keys the bytes (q, dO and dq of every
// row against 10.KV.D operations a row), then the issue of the products
// and exps. The design is K6's (flash_bwd.cu) with the head's whole KV in
// the block, so that nothing is recomputed and no atomics are needed:
//   - K and V of the head (kv_len rows, zero-padded to kvp, a multiple of
//     16) stay in shared memory. Each warp owns a 16-row band of them (two
//     warps a band above D = 80, each on half the columns) and keeps the
//     band's fp32 dK and dV accumulators in registers for the block's life.
//   - q tiles of 32 rows (16 at D = 160; Q, dO, O and lse) stream through
//     a two-stage cp.async ring: tile t + 1 lands behind tile t's products. The block
//     computes the tile's delta = rowsum(dO * O) itself (fp32, a warp a
//     row, read after the first products and a barrier): no pass over dO
//     and O before the kernel.
//   - Per tile, in the transposed orientation (as the TPU kernel): S^T =
//     K.Q^T and dP^T = V.dO^T for the band (mma.sync m16n8k16 fed by
//     ldmatrix); their accumulator fragments, exponentiated, masked and
//     packed to bf16, are exactly the A fragments of dV += P^T.dO and
//     dK += dS^T.Q (the trick of K2), so S, dP, P and dS never leave
//     registers for those products.
//   - dQ = dS.K sums over every band, so dS crosses shared memory once, in
//     bf16 (as dS^T, [kvp, q rows], written straight from the fragments), behind
//     one barrier; then the warps take 16 x 16 blocks of the tile's dQ
//     (A from dS^T by ldmatrix.trans, B from the resident K), scale them and
//     write them out. Five products a (q, kv) pair, none recomputed.
//   - Sq is split over nsplit blocks per head, chosen by the host from Sq and
//     the card's SM count alone (never from BH, so a head's sums do not
//     depend on its batch). Each block writes its partial fp32 dK and dV to a
//     workspace; a second, small kernel sums them in a fixed order and rounds
//     once to bf16; with one split (Sq <= 128) the block stores dK and dV
//     itself. No atomics: bit-equal run to run and alone vs batched.
//
// Design points: D is padded to DP (a multiple of 16 up to 80; 96, 128 or
// 160 above, so that half of it is whole 16-column blocks); rows past Sq or
// kv_len and columns past D are zero-filled (cp.async with a zero source
// size), and the P of a q row past Sq or a key past kv_len is 0 exactly;
// kvp is at most 128 (D <= 80) or 80 (above), at most 10 warps a block; the
// dynamic shared-memory limit is raised once per process and card.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kMaxThreads = 320;   // 10 warps: 5 bands of 80 keys, two warps a band
constexpr float kLog2e = 1.4426950408889634f;

// q rows of a streamed tile: 32, or 16 at DP = 160, where the block's 10
// warps have 168 registers a thread and 80 of them hold dK and dV.
__host__ __device__ constexpr int q_tile_rows(int dp) { return dp > 128 ? 16 : 32; }

// The padded head dim for head dim d <= 160.
constexpr int oneshot_dp(int d) { return d <= 80 ? (d + 15) / 16 * 16 : d <= 96 ? 96 : d <= 128 ? 128 : 160; }

template <int DP>
struct Cfg {
  static constexpr int kWB = DP <= 80 ? 1 : 2;       // warps on one 16-row kv band
  static constexpr int kWC = DP / kWB;               // dK and dV columns of a warp
  static constexpr int kMaxKV = DP <= 80 ? 128 : 80;  // padded keys a block takes
  static constexpr int kLD = DP + 8;                  // bf16 row stride of Q, dO, O, K, V
  static constexpr int kBS = q_tile_rows(DP);
  static constexpr int kLDS = kBS + 8;                // bf16 row stride of dS^T [kvp, kBS]
  static_assert(kWC % 16 == 0 && kMaxKV / 16 * kWB * 32 <= kMaxThreads, "tile shape");
};

// Shared memory of a block: K and V [kvp, DP] bf16, two stages of (Q, dO,
// O [bs, DP] bf16; lse, delta [bs] fp32), dS^T [kvp, bs] bf16 (bs =
// q_tile_rows(DP)); every row stride a multiple of 16 bytes.
// ops/attention.py bwd_smem_bytes mirrors it.
__host__ __device__ constexpr int stage_bytes(int dp) {
  return 3 * q_tile_rows(dp) * (dp + 8) * 2 + 2 * q_tile_rows(dp) * 4;
}
__host__ __device__ inline int smem_bytes(int kvp, int dp) {
  return 2 * kvp * (dp + 8) * 2 + 2 * stage_bytes(dp) + kvp * (q_tile_rows(dp) + 8) * 2;
}

// Rows [row0, row0 + nrows) of a row-major [*, d] matrix into a [nrows, DP]
// shared tile of row stride DP + 8 by cp.async; rows >= valid_rows and
// columns >= d become zeros. d % 8 == 0 and a 16-byte aligned source.
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
flash_bwd_oneshot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse, const bf16* __restrict__ o,
                         bf16* __restrict__ dq, float* __restrict__ ws, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int bh_total, int sq, int skv, int d, int kv_len, float scale, int tiles_per_split) {
  typedef Cfg<DP> C;
  constexpr int LD = C::kLD;
  constexpr int KD = DP / 16;    // k-steps of S^T and dP^T
  constexpr int kBS = C::kBS, kLDS = C::kLDS;
  constexpr int NS = kBS / 8;    // n-tiles of S^T: q columns
  constexpr int NW = C::kWC / 8; // n-tiles of a warp's dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  const int kvp = (kv_len + 15) / 16 * 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kvp * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kvp * LD);
  bf16* dst = reinterpret_cast<bf16*>(ring + 2 * stage_bytes(DP));  // dS^T [kvp, kLDS]

  const size_t bh = blockIdx.y;
  const int split = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int band = warp / C::kWB;
  const int cw = (warp % C::kWB) * C::kWC;  // this warp's first dK, dV column
  const int r0 = band * 16 + lane / 4;      // this thread's kv rows r0, r0 + 8
  const float scale_log2 = scale * kLog2e;

  const int n_q_tiles = (sq + kBS - 1) / kBS;
  const int t0 = split * tiles_per_split;
  const int t_end = min(n_q_tiles, t0 + tiles_per_split);
  auto load_stage = [&](int s, int qrow0) {
    unsigned char* p = ring + s * stage_bytes(DP);
    bf16* qt = reinterpret_cast<bf16*>(p);
    load_rows<DP>(qt, q + bh * sq * d, qrow0, kBS, sq, d);
    load_rows<DP>(qt + kBS * LD, dout + bh * sq * d, qrow0, kBS, sq, d);
    load_rows<DP>(qt + 2 * kBS * LD, o + bh * sq * d, qrow0, kBS, sq, d);
    float* lse_s = reinterpret_cast<float*>(qt + 3 * kBS * LD);
    for (int r = threadIdx.x; r < kBS; r += blockDim.x) {
      const bool ok = qrow0 + r < sq;
      cp_async4(lse_s + r, ok ? lse + bh * sq + qrow0 + r : lse, ok);
    }
    cp_async_commit();
  };
  // K and V land with the first tile
  load_rows<DP>(ks, k + bh * skv * d, 0, kvp, kv_len, d);
  load_rows<DP>(vs, v + bh * skv * d, 0, kvp, kv_len, d);
  if (t0 < t_end) {
    load_stage(0, t0 * kBS);
  } else {
    cp_async_commit();
  }

  float acc_k[NW][4], acc_v[NW][4];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.0f;
  }
  // the key mask: P = 0 for kv rows at or past kv_len
  const bool key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};
  const int arow = (band * 16 + lane % 16) * LD + (lane / 16) * 8;  // this lane's ldmatrix row of K and V
  for (int t = t0; t < t_end; ++t) {
    const int j = t - t0;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed everywhere; every warp is done with tile t - 1's stage and dS^T
    if (t + 1 < t_end) load_stage((j + 1) & 1, (t + 1) * kBS);
    unsigned char* stage = ring + (j & 1) * stage_bytes(DP);
    const bf16* qt = reinterpret_cast<const bf16*>(stage);
    const bf16* dot = qt + kBS * LD;
    const bf16* ot = qt + 2 * kBS * LD;
    const float* lse_t = reinterpret_cast<const float*>(stage + 3 * kBS * LD * 2);
    float* delta_t = reinterpret_cast<float*>(stage + 3 * kBS * LD * 2) + kBS;
    const int q0 = t * kBS;

    // delta = rowsum(dO * O) of the tile's rows, a warp a row (read after
    // the barrier below); rows past Sq are zeros and give 0
#pragma unroll 1
    for (int r = warp; r < kBS; r += nwarps) {
      float acc = 0.0f;
#pragma unroll 1
      for (int c = lane; c < DP; c += 32)
        acc += __bfloat162float(dot[r * LD + c]) * __bfloat162float(ot[r * LD + c]);
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) delta_t[r] = acc;
    }

    // S^T = K.Q^T and dP^T = V.dO^T: this band's 16 kv rows x kBS q
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, ks + arow + kk * 16);
      ldmatrix_x4(av, vs + arow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        const int at = (nt * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, qt + at);
        mma16816(st[nt], ak, b[0], b[1]);
        mma16816(st[nt + 1], ak, b[2], b[3]);
        ldmatrix_x4(b, dot + at);
        mma16816(dpt[nt], av, b[0], b[1]);
        mma16816(dpt[nt + 1], av, b[2], b[3]);
      }
    }

    __syncthreads();  // delta landed

    // P^T and dS^T as bf16 A fragments: element e of n-tile nt is kv row
    // r0 (+8 for e >= 2), q row q0 + nt*8 + 2*(lane%4) + (e&1)
    uint32_t pa[NS / 2][4], dsa[NS / 2][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const int c = nt * 8 + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool q_ok = q0 + c + (e & 1) < sq;
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        pv[e] = key_ok[e >> 1] && q_ok ? fast_exp2(st[nt][e] * scale_log2 - lv * kLog2e) : 0.0f;
        dsv[e] = pv[e] * (dpt[nt][e] - dl);
      }
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsa[nt / 2][(nt & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dV += P^T.dO and dK += dS^T.Q over this warp's columns
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
#pragma unroll
      for (int nd = 0; nd < NW; nd += 2) {
        const int at = (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + cw + nd * 8 + (lane / 16) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, dot + at);
        mma16816(acc_v[nd], pa[kc], b[0], b[1]);
        mma16816(acc_v[nd + 1], pa[kc], b[2], b[3]);
        ldmatrix_x4_trans(b, qt + at);
        mma16816(acc_k[nd], dsa[kc], b[0], b[1]);
        mma16816(acc_k[nd + 1], dsa[kc], b[2], b[3]);
      }
    }

    // dS^T to shared memory, once a band, straight from the fragments
    if (warp % C::kWB == 0) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const int c = nt * 8 + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dst + r0 * kLDS + c) = dsa[nt / 2][(nt & 1) * 2];
        *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * kLDS + c) = dsa[nt / 2][(nt & 1) * 2 + 1];
      }
    }
    __syncthreads();

    // dQ = dS.K * scale for this tile, in 16 x 16 blocks spread over the
    // warps: A (dS, [q, kv]) from dS^T by ldmatrix.trans, B from K
    bf16* dqh = dq + bh * sq * d;
    for (int u = warp; u < (kBS / 16) * (DP / 16); u += nwarps) {
      const int qb = u / (DP / 16), cb = u % (DP / 16);
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int kc = 0; kc < kvp / 16; ++kc) {
        uint32_t a[4], b[4];
        ldmatrix_x4_trans(a, dst + (kc * 16 + (lane / 16) * 8 + lane % 8) * kLDS + qb * 16 + ((lane / 8) % 2) * 8);
        ldmatrix_x4_trans(b, ks + (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + cb * 16 + (lane / 16) * 8);
        mma16816(acc[0], a, b[0], b[1]);
        mma16816(acc[1], a, b[2], b[3]);
      }
      const int row = q0 + qb * 16 + lane / 4;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        const int col = cb * 16 + nd * 8 + 2 * (lane % 4);
        if (col >= d) continue;  // d % 8 == 0: a pair is inside d or past it
        if (row < sq)
          *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)row * d + col) =
              __floats2bfloat162_rn(acc[nd][0] * scale, acc[nd][1] * scale);
        if (row + 8 < sq)
          *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)(row + 8) * d + col) =
              __floats2bfloat162_rn(acc[nd][2] * scale, acc[nd][3] * scale);
      }
    }
  }

  if (gridDim.x == 1) {  // one split: dK (times scale) and dV straight out; rows past kvp are zeros
    const size_t at = bh * skv * d;
#pragma unroll
    for (int nd = 0; nd < NW; ++nd) {
      const int col = cw + nd * 8 + 2 * (lane % 4);
      if (col >= d) continue;  // d % 8 == 0: a pair is inside d or past it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= skv) continue;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc_k[nd][2 * h] * scale, acc_k[nd][2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
      }
    }
    for (int i = kvp * d + threadIdx.x; i < skv * d; i += blockDim.x) {
      dk[at + i] = __float2bfloat16(0.0f);
      dv[at + i] = __float2bfloat16(0.0f);
    }
    return;
  }
  // else this split's partial dK and dV to the workspace: [2][nsplit][bh_total][kvp][DP] fp32
  const size_t part = (size_t)kvp * DP;
  float* wk = ws + ((size_t)split * bh_total + bh) * part;
  float* wv = wk + (size_t)gridDim.x * bh_total * part;
#pragma unroll
  for (int nd = 0; nd < NW; ++nd) {
    const int col = cw + nd * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)(r0 + 8 * h) * DP + col;
      *reinterpret_cast<float2*>(wk + at) = make_float2(acc_k[nd][2 * h], acc_k[nd][2 * h + 1]);
      *reinterpret_cast<float2*>(wv + at) = make_float2(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
    }
  }
}

// dk, dv [bh, skv, d] bf16 = the sums of the nsplit partials in split order
// (dk times scale); rows >= kvp (keys past kv_len) are zeros.
__global__ void flash_bwd_oneshot_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ dk,
                                                bf16* __restrict__ dv, int nsplit, int bh_total, int skv, int d,
                                                int dp, int kvp, float scale) {
  const size_t n = (size_t)bh_total * skv * d;
  const size_t part = (size_t)kvp * dp;
  const size_t half = (size_t)nsplit * bh_total * part;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n; idx += (size_t)gridDim.x * blockDim.x) {
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

struct Args {
  const void *q, *k, *v, *dout, *lse, *o;
  void *dq, *ws, *dk, *dv;
  int bh, sq, skv, d, kv_len;
  float scale;
  int nsplit, tiles_per_split;
  cudaStream_t stream;
};

template <int DP>
int launch(const Args& a) {
  typedef Cfg<DP> C;
  static unsigned done = 0;
  cudaError_t err = allow_max_smem(flash_bwd_oneshot_kernel<DP>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kvp = (a.kv_len + 15) / 16 * 16;
  if (kvp > C::kMaxKV || a.nsplit < 1 || a.tiles_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_oneshot_kernel<DP><<<dim3(a.nsplit, a.bh), kvp / 16 * C::kWB * 32, smem_bytes(kvp, DP), a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse), static_cast<const bf16*>(a.o),
      static_cast<bf16*>(a.dq), static_cast<float*>(a.ws), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.bh,
      a.sq, a.skv, a.d, a.kv_len, a.scale, a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  const long long n = (long long)a.bh * a.skv * a.d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_bwd_oneshot_reduce_kernel<<<blocks, 256, 0, a.stream>>>(static_cast<const float*>(a.ws),
                                                                 static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                                                                 a.nsplit, a.bh, a.skv, a.d, DP, kvp, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Returns F<DP>(args...) for the padded head dim DP of d; falls through
// where d is not a head dim K8 takes.
#define FDT_ONESHOT_DISPATCH(F, d, ...)                        \
  switch ((d) % 8 || (d) < 8 || (d) > 160 ? 0 : oneshot_dp(d)) { \
    case 16: return F<16>(__VA_ARGS__);                        \
    case 32: return F<32>(__VA_ARGS__);                        \
    case 48: return F<48>(__VA_ARGS__);                        \
    case 64: return F<64>(__VA_ARGS__);                        \
    case 80: return F<80>(__VA_ARGS__);                        \
    case 96: return F<96>(__VA_ARGS__);                        \
    case 128: return F<128>(__VA_ARGS__);                      \
    case 160: return F<160>(__VA_ARGS__);                      \
    default: break;                                            \
  }

// K8's tiles for kv_len keys at head dim d into out[5]: padded KV, padded
// D, q rows of a streamed tile, threads of a block, dynamic shared memory
// (bytes).
template <int DP>
int tiles(int kv_len, int* out) {
  const int kvp = (kv_len + 15) / 16 * 16;
  if (kvp > Cfg<DP>::kMaxKV) return static_cast<int>(cudaErrorInvalidValue);
  const int t[5] = {kvp, DP, Cfg<DP>::kBS, kvp / 16 * Cfg<DP>::kWB * 32, smem_bytes(kvp, DP)};
  for (int i = 0; i < 5; ++i) out[i] = t[i];
  return 0;
}

}  // namespace

extern "C" {

// K8's tiles (see tiles above); the planner (ops/attention.py
// bwd_oneshot_tiles) mirrors them. Returns cudaErrorInvalidValue where K8
// does not take the head.
int fdt_flash_bwd_oneshot_tiles(int kv_len, int d, int* out) {
  FDT_ONESHOT_DISPATCH(tiles, d, kv_len, out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8: dq [bh, sq, d], dk, dv [bh, skv, d] bf16 from q, dout [bh, sq, d],
// k, v [bh, skv, d] bf16, the forward's out o [bh, sq, d] bf16 and lse
// [bh, sq] fp32; kv_len keys (padded
// to a multiple of 16: at most 128 at d <= 80, 80 up to d = 160); Sq in q
// tiles of 32 rows (16 above d = 128), split over nsplit blocks per head (tiles_per_split
// tiles each); ws an fp32 workspace of 2 * nsplit * bh * kvp * dp floats
// (kvp, dp as fdt_flash_bwd_oneshot_tiles gives them; unused when nsplit
// is 1). Two launches (the blocks, then the sum of their partials), one
// when nsplit is 1; returns the CUDA error code (0 on success).
int fdt_flash_bwd_oneshot(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                          const void* o, void* dq, void* ws, void* dk, void* dv, int bh, int sq, int skv, int d,
                          int kv_len, float scale, int nsplit, int tiles_per_split, void* stream) {
  const Args a{q, k, v, dout, lse, o, dq, ws, dk, dv, bh, sq, skv, d, kv_len, scale, nsplit, tiles_per_split,
               static_cast<cudaStream_t>(stream)};
  FDT_ONESHOT_DISPATCH(launch, d, a)
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
