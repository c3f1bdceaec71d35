// Streaming flash-attention backward for Hopper (sm_90a): K6 (dK, dV) and
// K7 (dQ), from the forward's lse and delta = rowsum(dO * O).
//
// Replaces the Pallas TPU kernels flash_diffusion_tpu/ops/attention.py:635
// _flash_bwd_dkv_kernel (K6) and :703 _flash_bwd_dq_kernel (K7), both
// called from _flash_bwd_bhsd (:888-975). Same math and rounding points as
// they and attention_bwd_reference (ops/attention.py) have:
//   S = Q.K^T (fp32), P = exp(S * scale - lse) (fp32; keys >= kv_len give
//   P = 0 exactly), dP = dO.V^T (fp32), dS = P * (dP - delta) (fp32);
//   dV = P^T(bf16).dO, dK = dS^T(bf16).Q * scale, dQ = dS(bf16).K * scale,
//   each summed in fp32 and rounded to bf16 once, on store.
// SD1.5 training sends them the UNet's 256-, 1024- and 4096-token
// self-attention (D = 160, 80, 40) and the VAE decoder's single-head
// D = 512 mid-block (the LPIPS loss differentiates the decode); everything
// whose KV fits one block takes the one-shot K8 (flash_bwd_oneshot.cu).
//
// What bounds it on this card: the tensor cores, then the exponentials and
// the streamed tiles between them. Per (q, kv) pair K6 does four products
// of 2.D (S, dP, dV, dK) and K7 three (S, dP, dQ): 14.BH.Sq.KV.D operations
// where JAX's pl.CostEstimate counts 5 for each kernel.
//
// Design:
//   - A block owns resident rows and streams the other side's tiles: K6
//     holds kv rows of K and V and walks q tiles of Q, dO, lse and delta;
//     K7 holds q rows of Q and dO and walks kv tiles of K and V.
//   - K6 works in the transposed orientation, as the JAX kernel does
//     (attention.py:669-700): S^T = K.Q^T and dP^T = V.dO^T for its kv rows.
//     Their fp32 accumulator fragments, once exponentiated, masked and
//     packed to bf16, are exactly the A fragments of dV += P^T.dO and
//     dK += dS^T.Q (the trick of K2, flash_fwd_mma.cu), so S, dP, P and dS
//     never leave registers. K7 does the same in the [q, kv] orientation:
//     dS in registers is the A operand of dQ += dS.K. The B operands of the
//     accumulating products (dO, Q; K) are the same shared tiles read
//     MN-major, never transposed in memory.
//   - The products are wgmma (wgmma.cuh) up to D = 128: two warpgroups a
//     block, each on 64 resident rows, both reading each streamed tile (half
//     the streamed bytes a product of one warpgroup a block). S and dP are
//     shared-memory x shared-memory products; the accumulating ones take A
//     from registers. Above D = 128, where a warpgroup's accumulators would
//     not fit its registers, mma.sync m16n8k16 fed by ldmatrix, four warps
//     of 16 rows; at D = 160 in K6 and above 160, two warps share each band
//     and split its output columns (each computing the band's scores
//     itself), and above 160 K6 also splits the columns across two blocks
//     (grid z), each recomputing S and dP over the full D.
//   - dK and dV (K6) and dQ (K7) are fp32 register accumulators for the
//     block's whole life, stored once.
//   - The tiles are filled by TMA (one box of 16 columns by the tile's rows
//     per 16-column block, 32-byte swizzled: each row read is one 32-byte
//     sector) into a ring of two stages, each completing on its mbarrier:
//     tile j + 1 loads behind tile j's products, and a tile costs one block
//     barrier. Rows past Sq or kv_len and columns past D arrive as zeros (D
//     is padded to DP: a multiple of 16 up to 128, 160 up to 160, of 64
//     above; the kernels are templated on DP). PairCfg keeps every
//     instantiation at 0 spill bytes and inside 227 KB of shared memory;
//     ops/attention.py bwd_pair_tiles mirrors it.
//   - No atomics, and no split that follows B or the batch slot, so the
//     outputs are bit-equal run to run and alone vs batched. That is why
//     dQ stays a separate kernel that recomputes S and dP (seven products
//     where five would do): FlashAttention-2 and -3 add dQ across kv blocks
//     with fp32 atomics, whose order changes from run to run. The TPU
//     carried the same sums across sequential grid steps in VMEM.

#include "tma.cuh"

namespace {

using namespace fdt;

constexpr float kLog2e = 1.4426950408889634f;

// The padded head dim of the pair for head dim d (d % 8 == 0, d <= 512).
constexpr int pair_dp(int d) {
  return d <= 128 ? (d + 15) / 16 * 16 : d <= 160 ? 160 : (d + 63) / 64 * 64;
}

// Tiles of K6 (KERNEL 0: kv rows resident, q tiles streamed) and K7
// (KERNEL 1: q rows resident, kv tiles streamed) at padded head dim DP.
// Registers a thread: K6 about kWC (dK, dV) + kStream (S^T, dP^T), K7 about
// kWC / 2 (dQ) + kStream (S, dP), plus addresses; each at most ~160.
template <int DP, int KERNEL>
struct PairCfg {
  // the products: wgmma where a warpgroup owns 64 whole rows (two
  // warpgroups a block, which halves the streamed bytes a product), else
  // mma.sync with four warps
  static constexpr bool kWgmma = DP <= 128;
  static constexpr int kGroups = kWgmma ? 2 : 1;  // warpgroups of a block
  static constexpr int kWarps = 4 * kGroups;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWB = KERNEL == 0 ? (DP <= 128 ? 1 : 2) : (DP <= 160 ? 1 : 2);  // warps a band
  static constexpr int kStream = KERNEL == 0 ? (DP <= 96 || DP == 160 ? 64 : 32) : (DP <= 128 ? 64 : 32);
  static constexpr int kDC = KERNEL == 0 && DP > 160 ? DP / 2 : DP;  // output columns of a block
  static constexpr int kRows = 16 * kWarps / kWB;                   // resident rows of a block
  static constexpr int kWC = kDC / kWB;                             // output columns of a warp
  // shared memory (the 32-byte-swizzled layout below): two resident
  // [kRows, DP] tiles, two stages of two streamed [kStream, DP] tiles, K6's
  // lse and delta of each stage's q rows, then the stages' two mbarriers
  static constexpr int kResBytes = kRows * DP * 2;
  static constexpr int kTileBytes = kStream * DP * 2;
  static constexpr int kStatOffset = 2 * kResBytes + 4 * kTileBytes;
  static constexpr int kBarOffset = kStatOffset + (KERNEL == 0 ? 2 * 2 * kStream * 4 : 0);
  static constexpr int kSmemBytes = kBarOffset + 16;
  static_assert(kWC % 16 == 0 && DP % kDC == 0 && kStream % 16 == 0, "tile shape");
  static_assert(!kWgmma || kWB == 1, "a wgmma warpgroup owns 64 whole rows");
  static_assert(kResBytes % 1024 == 0 && kTileBytes % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// ---- shared-memory tiles: the 32-byte-swizzled attention tiles of
// tma.cuh, filled by TMA (tma_tile) into a ring completing on mbarriers.

// dst[r] = src[row0 + r] for r < N, 0 past valid, by cp.async.
template <int N, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int valid) {
  for (int r = threadIdx.x; r < N; r += THREADS) {
    const bool ok = row0 + r < valid;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// ---- the products

// sa = A1.B1^T and sb = A2.B2^T: A1, A2 rows a0.. of two resident [RA, DP]
// tiles (the band's 16 with mma.sync, the warpgroup's 64 with wgmma); B1,
// B2 two streamed [NS * 8, DP] tiles; summed over DP. Element e of n-tile
// nt of a result is row lane/4 (+8 for e >= 2) of the warp's 16, column
// nt*8 + 2*(lane%4) + (e&1).
template <bool WG, int DP, int RA, int NS>
__device__ __forceinline__ void scores(float (&sa)[NS][4], float (&sb)[NS][4], const bf16* a1,
                                       const bf16* a2, int a0, const bf16* b1, const bf16* b2, int lane) {
  constexpr int RB = NS * 8;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[i][e] = sb[i][e] = 0.0f;
  }
  if constexpr (WG) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t db1 = desc_k(at_byte(b1, kk * 32 * RB)), db2 = desc_k(at_byte(b2, kk * 32 * RB));
      wgmma_ss(sa, desc_k(at_byte(a1, kk * 32 * RA + a0 * 32)), db1);
      wgmma_ss(sb, desc_k(at_byte(a2, kk * 32 * RA + a0 * 32)), db2);
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    // lane -> row a0 + lane%16, half lane/16; B: row nt*8 + (lane/16)*8 + lane%8, half (lane/8)%2
    const int arow = (a0 + lane % 16) * 32 + (((lane / 16) ^ ((lane % 16) >> 2)) & 1) * 16;
    const int brow = ((lane / 16) * 8 + lane % 8) * 32 + ((((lane / 8) % 2) ^ ((lane % 8) >> 2)) & 1) * 16;
#pragma unroll 4
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t x[4], y[4];
      ldmatrix_x4(x, at_byte(a1, kk * 32 * RA + arow));
      ldmatrix_x4(y, at_byte(a2, kk * 32 * RA + arow));
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, at_byte(b1, kk * 32 * RB + nt * 256 + brow));
        mma16816(sa[nt], x, b[0], b[1]);
        mma16816(sa[nt + 1], x, b[2], b[3]);
        ldmatrix_x4(b, at_byte(b2, kk * 32 * RB + nt * 256 + brow));
        mma16816(sb[nt], y, b[0], b[1]);
        mma16816(sb[nt + 1], y, b[2], b[3]);
      }
    }
  }
}

// acc1 += A1.X1 and acc2 += A2.X2 (acc2 and X2 only where N2): A1, A2
// [16 or 64, NS * 8] in registers (the packed bf16 fragments of scores(),
// k-step kc in a[kc]), X1, X2 streamed [NS * 8, DP] tiles from column col0
// (a multiple of 16) on, read MN-major (wgmma) or with ldmatrix.trans.
template <bool WG, int NS, int NW, bool N2>
__device__ __forceinline__ void accumulate(float (&acc1)[NW][4], const uint32_t (&a1)[NS / 2][4], const bf16* x1,
                                           float (&acc2)[NW][4], const uint32_t (&a2)[NS / 2][4], const bf16* x2,
                                           int col0, int lane) {
  constexpr int RB = NS * 8;
  const int c0 = (col0 / 16) * 32 * RB;
  if constexpr (WG) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      wgmma_rs(acc1, a1[kc], desc_mn(at_byte(x1, c0 + kc * 512), RB));
      if constexpr (N2) wgmma_rs(acc2, a2[kc], desc_mn(at_byte(x2, c0 + kc * 512), RB));
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    // lane -> row kc*16 + ((lane/8)%2)*8 + lane%8, half lane/16 of block col0/16 + nd/2
    const int xrow = c0 + (((lane / 8) % 2) * 8 + lane % 8) * 32 + (((lane / 16) ^ ((lane % 8) >> 2)) & 1) * 16;
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
#pragma unroll
      for (int nd = 0; nd < NW; nd += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, at_byte(x1, kc * 512 + (nd / 2) * 32 * RB + xrow));
        mma16816(acc1[nd], a1[kc], b[0], b[1]);
        mma16816(acc1[nd + 1], a1[kc], b[2], b[3]);
        if constexpr (N2) {
          ldmatrix_x4_trans(b, at_byte(x2, kc * 512 + (nd / 2) * 32 * RB + xrow));
          mma16816(acc2[nd], a2[kc], b[0], b[1]);
          mma16816(acc2[nd + 1], a2[kc], b[2], b[3]);
        }
      }
    }
  }
}

template <int NW>
__device__ __forceinline__ void zero(float (&acc)[NW][4]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
}

// Rows row0 (+8) and columns col0 + nd*8 + 2*(lane%4) of acc * mul, as
// bf16, into a row-major [rows, d] matrix; rows >= rows and columns >= d
// are skipped.
template <int NW>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NW][4], float mul, int row0,
                                           int rows, int col0, int d, int lane) {
#pragma unroll
  for (int nd = 0; nd < NW; ++nd) {
    const int col = col0 + nd * 8 + 2 * (lane % 4);
    if (col >= d) continue;  // d % 8 == 0: a pair is inside d or past it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc[nd][2 * h] * mul, acc[nd][2 * h + 1] * mul);
    }
  }
}

// The maps of q and dO ([BH, Sq, D]; rows past Sq read as zeros) and of k and
// v ([BH, Skv, D] read up to kv_len; keys past it read as zeros), each with
// its kernel's box rows.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int DP>
__global__ void __launch_bounds__(PairCfg<DP, 0>::kThreads)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int sq, int skv, int d, int kv_len, float scale) {
  typedef PairCfg<DP, 0> C;
  constexpr int BS = C::kStream;
  constexpr int NS = BS / 8;
  constexpr int NW = C::kWC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + C::kResBytes);
  unsigned char* ring = smem + 2 * C::kResBytes;  // stage s: q, dO [BS, DP]
  float* stats = reinterpret_cast<float*>(smem + C::kStatOffset);  // stage s: lse [BS], delta [BS]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * C::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int band = warp / C::kWB;
  const int cw = blockIdx.z * C::kDC + (warp % C::kWB) * C::kWC;  // first output column
  const int r0 = kv0 + band * 16 + lane / 4;                       // this thread's kv rows r0, r0 + 8
  float acc_k[NW][4], acc_v[NW][4];
  zero(acc_k);
  zero(acc_v);
  if (kv0 < kv_len) {
    // one thread starts the tiles' copies (and expects `extra` more bytes);
    // every thread copies its share of lse and delta
    auto load_stage = [&](int s, int q0, int extra) {
      unsigned char* p = ring + s * 2 * C::kTileBytes;
      if (threadIdx.x == 0) {
        mbar_expect(bar + s, 2 * C::kTileBytes + extra);
        tma_tile<DP, BS>(reinterpret_cast<bf16*>(p), &maps.q, q0, bh, bar + s);
        tma_tile<DP, BS>(reinterpret_cast<bf16*>(p + C::kTileBytes), &maps.dout, q0, bh, bar + s);
      }
      load_vec<BS, C::kThreads>(stats + s * 2 * BS, lse + (size_t)bh * sq, q0, sq);
      load_vec<BS, C::kThreads>(stats + s * 2 * BS + BS, delta + (size_t)bh * sq, q0, sq);
      cp_async_commit();
    };
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init(bar + 1, 1);
      mbar_fence_init();
    }
    __syncthreads();
    load_stage(0, 0, 2 * C::kResBytes);
    if (threadIdx.x == 0) {  // the resident tiles land on stage 0's barrier
      tma_tile<DP, C::kRows>(ks, &maps.k, kv0, bh, bar);
      tma_tile<DP, C::kRows>(vs, &maps.v, kv0, bh, bar);
    }
    const float scale_log2 = scale * kLog2e;
    // the key mask: P = 0 for kv rows at or past kv_len
    const bool key_ok[2] = {r0 < kv_len, r0 + 8 < kv_len};
    const int n_tiles = (sq + BS - 1) / BS;
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(bar + (j & 1), (j >> 1) & 1);
      cp_async_wait<0>();
      __syncthreads();  // tile j landed everywhere; every warp is done with tile j - 1's stage
      if (j + 1 < n_tiles) load_stage((j + 1) & 1, (j + 1) * BS, 0);
      const bf16* qt = reinterpret_cast<const bf16*>(ring + (j & 1) * 2 * C::kTileBytes);
      const bf16* dot = qt + BS * DP;
      const float* lse_t = stats + (j & 1) * 2 * BS;
      const float* delta_t = lse_t + BS;

      float st[NS][4], dpt[NS][4];  // S^T and dP^T of this warp's 16 kv rows x BS q
      scores<C::kWgmma, DP, C::kRows, NS>(st, dpt, ks, vs, C::kWgmma ? (warp / 4) * 64 : band * 16, qt, dot,
                                          lane);
      uint32_t pa[NS / 2][4], dsa[NS / 2][4];  // P^T and dS^T, bf16 A fragments
      const int q0 = j * BS;
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
      // dV += P^T.dO, dK += dS^T.Q
      accumulate<C::kWgmma, NS, NW, true>(acc_v, pa, dot, acc_k, dsa, qt, cw, lane);
    }
  }
  const size_t at = (size_t)bh * skv * d;
  store_rows(dk + at, acc_k, scale, r0, skv, cw, d, lane);
  store_rows(dv + at, acc_v, 1.0f, r0, skv, cw, d, lane);
}

template <int DP>
__global__ void __launch_bounds__(PairCfg<DP, 1>::kThreads)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int d, int kv_len,
                    float scale) {
  typedef PairCfg<DP, 1> C;
  constexpr int BS = C::kStream;
  constexpr int NS = BS / 8;
  constexpr int NW = C::kWC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = reinterpret_cast<bf16*>(smem + C::kResBytes);
  unsigned char* ring = smem + 2 * C::kResBytes;  // stage s: k, v [BS, DP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int band = warp / C::kWB;
  const int cw = blockIdx.z * C::kDC + (warp % C::kWB) * C::kWC;
  const int r0 = q0 + band * 16 + lane / 4;  // this thread's q rows r0, r0 + 8
  auto load_stage = [&](int s, int kv0, int extra) {  // one thread; `extra` more bytes expected
    unsigned char* p = ring + s * 2 * C::kTileBytes;
    mbar_expect(bar + s, 2 * C::kTileBytes + extra);
    tma_tile<DP, BS>(reinterpret_cast<bf16*>(p), &maps.k, kv0, bh, bar + s);
    tma_tile<DP, BS>(reinterpret_cast<bf16*>(p + C::kTileBytes), &maps.v, kv0, bh, bar + s);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the resident tiles land on stage 0's barrier
    load_stage(0, 0, 2 * C::kResBytes);
    tma_tile<DP, C::kRows>(qs, &maps.q, q0, bh, bar);
    tma_tile<DP, C::kRows>(dos, &maps.dout, q0, bh, bar);
  }
  const float scale_log2 = scale * kLog2e;
  float lse_l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = r0 + 8 * h < sq;
    lse_l2[h] = ok ? lse[(size_t)bh * sq + r0 + 8 * h] * kLog2e : 0.0f;
    dl[h] = ok ? delta[(size_t)bh * sq + r0 + 8 * h] : 0.0f;
  }
  float acc[NW][4];
  zero(acc);
  const int n_tiles = (kv_len + BS - 1) / BS;
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(bar + (j & 1), (j >> 1) & 1);
    __syncthreads();  // every warp is done with tile j - 1's stage
    if (threadIdx.x == 0 && j + 1 < n_tiles) load_stage((j + 1) & 1, (j + 1) * BS, 0);
    const bf16* kt = reinterpret_cast<const bf16*>(ring + (j & 1) * 2 * C::kTileBytes);
    const bf16* vt = kt + BS * DP;

    float s[NS][4], dp[NS][4];  // S and dP of this warp's 16 q rows x BS kv
    scores<C::kWgmma, DP, C::kRows, NS>(s, dp, qs, dos, C::kWgmma ? (warp / 4) * 64 : band * 16, kt, vt, lane);
    uint32_t dsa[NS / 2][4];  // dS, bf16 A fragments
    const int kv0 = j * BS;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const int c = kv0 + nt * 8 + 2 * (lane % 4);
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the key mask: P = 0 for keys at or past kv_len
        const bool key_ok = c + (e & 1) < kv_len;
        const float pv = key_ok ? fast_exp2(s[nt][e] * scale_log2 - lse_l2[e >> 1]) : 0.0f;
        dsv[e] = pv * (dp[nt][e] - dl[e >> 1]);
      }
      dsa[nt / 2][(nt & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
    accumulate<C::kWgmma, NS, NW, false>(acc, dsa, kt, acc, dsa, kt, cw, lane);  // dQ += dS.K
  }
  store_rows(dq + (size_t)bh * sq * d, acc, scale, r0, sq, cw, d, lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int bh, sq, skv, d, kv_len;
  float scale;
  cudaStream_t stream;
};

template <int DP, int KERNEL>
int launch(const Args& a) {
  typedef PairCfg<DP, KERNEL> C;
  const int q_box = KERNEL == 0 ? C::kStream : C::kRows, kv_box = KERNEL == 0 ? C::kRows : C::kStream;
  Maps maps;
  if (!(make_map(&maps.q, a.q, a.bh, a.sq, a.sq, a.d, q_box) &&
        make_map(&maps.dout, a.dout, a.bh, a.sq, a.sq, a.d, q_box) &&
        make_map(&maps.k, a.k, a.bh, a.kv_len, a.skv, a.d, kv_box) &&
        make_map(&maps.v, a.v, a.bh, a.kv_len, a.skv, a.d, kv_box)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *lse = static_cast<const float*>(a.lse), *delta = static_cast<const float*>(a.delta);
  dim3 grid(((KERNEL == 0 ? a.skv : a.sq) + C::kRows - 1) / C::kRows, a.bh, DP / C::kDC);
  cudaError_t err;
  if constexpr (KERNEL == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_kernel<DP><<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        maps, lse, delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.sq, a.skv, a.d, a.kv_len,
        a.scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_kernel<DP><<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        maps, lse, delta, static_cast<bf16*>(a.out0), a.sq, a.d, a.kv_len, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tiles of PairCfg<DP, KERNEL> into out[7].
template <int DP, int KERNEL>
int tiles(int* out) {
  typedef PairCfg<DP, KERNEL> C;
  const int t[7] = {DP, C::kRows, C::kStream, C::kDC, C::kWB, C::kWgmma, C::kSmemBytes};
  for (int i = 0; i < 7; ++i) out[i] = t[i];
  return 0;
}

// Returns F<DP, KERNEL>(args...) for the padded head dim DP of d; falls
// through where d is not a head dim of the pair.
#define FDT_PAIR_DISPATCH(F, KERNEL, d, ...)                         \
  switch ((d) % 8 || (d) < 8 || (d) > 512 ? 0 : pair_dp(d)) {        \
    case 16: return F<16, KERNEL>(__VA_ARGS__);                      \
    case 32: return F<32, KERNEL>(__VA_ARGS__);                      \
    case 48: return F<48, KERNEL>(__VA_ARGS__);                      \
    case 64: return F<64, KERNEL>(__VA_ARGS__);                      \
    case 80: return F<80, KERNEL>(__VA_ARGS__);                      \
    case 96: return F<96, KERNEL>(__VA_ARGS__);                      \
    case 112: return F<112, KERNEL>(__VA_ARGS__);                    \
    case 128: return F<128, KERNEL>(__VA_ARGS__);                    \
    case 160: return F<160, KERNEL>(__VA_ARGS__);                    \
    case 192: return F<192, KERNEL>(__VA_ARGS__);                    \
    case 256: return F<256, KERNEL>(__VA_ARGS__);                    \
    case 320: return F<320, KERNEL>(__VA_ARGS__);                    \
    case 384: return F<384, KERNEL>(__VA_ARGS__);                    \
    case 448: return F<448, KERNEL>(__VA_ARGS__);                    \
    case 512: return F<512, KERNEL>(__VA_ARGS__);                    \
    default: break;                                                  \
  }

}  // namespace

extern "C" {

// The tiles of K6 (which = 0) or K7 (which = 1) at head dim d into out[7]:
// padded D, resident rows of a block, rows of a streamed tile, output
// columns of a block, warps a 16-row band, 1 for wgmma (0: mma.sync),
// dynamic shared memory (bytes).
// Returns 0, or cudaErrorInvalidValue for a head dim the pair does not take.
int fdt_flash_bwd_pair_tiles(int which, int d, int* out) {
  if (which == 0) {
    FDT_PAIR_DISPATCH(tiles, 0, d, out)
  } else {
    FDT_PAIR_DISPATCH(tiles, 1, d, out)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6: dk, dv [bh, skv, d] bf16 from q, dout [bh, sq, d], k, v [bh, skv, d]
// bf16 and lse, delta [bh, sq] fp32; rows of dk, dv at or past kv_len are
// zeros. d % 8 == 0, d <= 512. Returns the CUDA error code of the launch
// (0 on success).
int fdt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                      int skv, int d, int kv_len, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, sq, skv, d, kv_len, scale,
               static_cast<cudaStream_t>(stream)};
  FDT_PAIR_DISPATCH(launch, 0, d, a)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: dq [bh, sq, d] bf16 from the same inputs as K6.
int fdt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int sq, int skv, int d,
                     int kv_len, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, skv, d, kv_len, scale,
               static_cast<cudaStream_t>(stream)};
  FDT_PAIR_DISPATCH(launch, 1, d, a)
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
