// Streaming flash-attention forward for Hopper (sm_90a), head dims up to
// 128: wgmma fed by a TMA ring, a producer warpgroup, and two consumer
// warpgroups in ping-pong (FlashAttention-3, arXiv:2407.08608 §3.1). One
// kernel, two layouts of a head's rows (the template's kPacked): K2 on
// [BH, S, D] and K5 on the projection-native [B, S, H*D].
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/attention.py:85
// _flash_fwd_kernel (via _flash_fwd_bhsd) for D <= 128: online softmax over
// KV tiles with a running max, denominator and fp32 accumulator; out [BH,
// Sq, D] bf16 and lse [BH, Sq] fp32 (natural log); keys at or past kv_len
// scored -1e30, so p = 0 exactly; the scale applied to the fp32 scores,
// never folded into bf16 q; p rounded to bf16 for p.v while the row sum
// takes it in fp32. SD1.5 sends it the 4096- and 1024-token self-attention
// (D = 40, 80), SDXL the 4096- and 1024-token one (D = 64), Pixart-α the
// DiT's 4096-token one (D = 72). Head dims 144 to 512 (the VAE's D = 512)
// stay on flash_fwd_mma.cu: a 64 x 512 fp32 accumulator does not fit one
// warpgroup's registers.
//
// Also replaces flash_diffusion_tpu/ops/attention.py:223
// _flash_fwd_packed_kernel (via _flash_fwd_packed), the inference primal
// that _attn_primal picks under FLASH_TPU_ATTN_PACKED=1 (head dim 64 or
// 128, at least 2 heads, no kv_valid, no gradient): the same function per
// head h on q, k, v and out [B, S, H*D], out[b, s, h*D:(h+1)*D], with no
// lse. SDXL sends it its self-attention under the switch, [B, 4096, 10*64]
// at level 1 and [B, 1024, 20*64] at level 2 and in the mid block. The
// packed instantiation reads its tiles through 4-D tensor maps over [B, S,
// H, D] (tma.cuh make_map_packed), whose boxes land as the same swizzled
// slabs as the 3-D maps', so the consumers' code is K2's; it stores out at
// row stride H*D from column h*D and compiles the lse store out. Its grid
// is (ceil(Sq / 128), H, B), and its tiles are K2's at the same D (FwdCfg),
// so nothing follows B, Sq or KV.
//
// What bounds it on this card: the tensor cores (4.BH.Sq.KV.D operations
// at 989 TFLOP/s) and, close behind, the exponentials of the softmax,
// which run on the SM's far slower multi-function units. The design keeps
// both busy at once:
//   - A block owns 128 q rows: two consumer warpgroups of 64 rows and a
//     producer warpgroup, whose registers go to the consumers (setmaxnreg).
//     One producer thread loads Q once, then streams K and V tiles of kBKV
//     keys by TMA into a four-stage ring of full and empty mbarriers, ahead
//     of the consumers: a stage comes free only when both warpgroups' P.V
//     of it is done, so two stages would leave each tile's copy latency
//     exposed.
//   - S = Q.K^T is a wgmma with both operands in shared memory, K-major;
//     O += P.V takes P from registers as the A operand (the m64 accumulator
//     fragments of S, exponentiated and packed to bf16, are the A
//     fragments) and V as an MN-major operand. Q, K and V are the 32-byte-
//     swizzled attention tiles of tma.cuh, D padded to DP (a multiple of
//     16) by TMA's zero fill; the maps are 3-D [BH, S, D], so rows past a
//     head's Sq or kv_len arrive as zeros, never as the next head's rows.
//   - Each warpgroup issues tile j's S and tile j - 1's P.V together, then
//     computes tile j's softmax in S's registers while P.V runs, and packs
//     P only once P.V is done: no instruction but a wgmma writes a wgmma's
//     registers while one is in flight, so ptxas keeps them in flight. The
//     two warpgroups take turns at issuing (named barriers 1 and 2), so
//     one's exponentials overlap the other's products.
//   - Keys at or past kv_len (K5: KV) in the last tile are masked in registers:
//     they count -1e30 in the row max and p = 0 exactly (their zero-filled
//     rows would score 0); stores of out and lse are masked by row.
//   - No split of KV across blocks and no atomics: every output row is one
//     block's fixed-order pass over its head's keys, bit-equal run to run
//     and alone vs batched. FwdCfg keeps every instantiation unspilled and
//     inside 227 KB; ops/attention.py stream_fwd_tiles mirrors it.

#include "tma.cuh"

namespace {

using namespace fdt;

constexpr int kBQ = 128;           // q rows of a block: two consumer warpgroups of 64
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;      // and a producer warpgroup
// registers a thread, moved from the producer to the consumers once the
// roles split (setmaxnreg): 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles at padded head dim DP. Registers a consumer thread: S (kBKV / 2),
// P in bf16 (kBKV / 4), O (DP / 2), plus addresses, within the consumers'
// 232. Above D = 80 the stages of 128-key tiles would not fit 227 KB four
// times over, so the tiles there are 64 keys.
template <int DP>
struct FwdCfg {
  static constexpr int kBKV = DP <= 80 ? 128 : 64;  // keys of a streamed tile
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBKV * DP * 2;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmemBytes = kBarOffset + (1 + 2 * kStages) * 8;  // Q's barrier, full and empty
  static_assert(DP % 16 == 0 && DP <= 128, "head dims of the wgmma forward");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

// Rows [row0, row0 + R) of this block's head into an [R, DP] tile: K2's
// head blockIdx.y through a 3-D map, K5's head blockIdx.y of batch
// blockIdx.z through a 4-D one.
template <int DP, int R, bool kPacked>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, int row0, uint64_t* bar) {
  if constexpr (kPacked)
    tma_tile_packed<DP, R>(dst, map, row0, blockIdx.y, blockIdx.z, bar);
  else
    tma_tile<DP, R>(dst, map, row0, blockIdx.y, bar);
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// kPacked: K5 on [B, S, H*D] (grid (Sq tiles, H, B); out at row stride ld
// = H*D from column h*D; no lse); else K2 on [BH, S, D] (grid (Sq tiles,
// BH); ld = d).
template <int DP, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, bf16* __restrict__ out, float* __restrict__ lse,
                       int sq, int d, int ld, int kv_len, float scale_log2) {
  typedef FwdCfg<DP> C;
  constexpr int BKV = C::kBKV;
  constexpr int NS = BKV / 8;  // n-tiles of the scores
  constexpr int ND = DP / 8;   // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::kQBytes;  // stage s: K, V [BKV, DP]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + C::kStages;

  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (kv_len + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the role by warpgroup, broadcast from lane 0 so that ptxas sees it
  // warp-uniform: only then does it give each role the registers of its
  // setmaxnreg (with threadIdx.x / 32 it held every warpgroup to 168)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {  // the producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect(q_bar, C::kQBytes);
      load_tile<DP, kBQ, kPacked>(qs, &maps.q, q0, q_bar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::kStages;
        if (j >= C::kStages) mbar_wait(empty + s, (j / C::kStages - 1) & 1);
        bf16* kt = reinterpret_cast<bf16*>(ring + s * 2 * C::kTileBytes);
        mbar_expect(full + s, 2 * C::kTileBytes);
        load_tile<DP, BKV, kPacked>(kt, &maps.k, j * BKV, full + s);
        load_tile<DP, BKV, kPacked>(kt + BKV * DP, &maps.v, j * BKV, full + s);
      }
    }
  } else {  // the consumers: warpgroup wg owns q rows 64wg..64wg+63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int me = 1 + wg, other = 2 - wg;  // the named barriers of the turns
    auto k_tile = [&](int j) { return reinterpret_cast<const bf16*>(ring + (j % C::kStages) * 2 * C::kTileBytes); };
    float o[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf};  // running max of rows lane/4 and lane/4 + 8 (scaled, base 2)
    float l[2] = {0.0f, 0.0f};        // this thread's partial row sums
    uint32_t p[NS / 2][4];            // P of the tile whose P.V is in flight, bf16 A fragments
    float s[NS][4];                   // the scores of the tile in hand

    // S = Q.K_j^T, issued (the first k step overwrites S: no instruction but
    // a wgmma writes it, so none has to wait for the products in flight)
    auto issue_scores = [&](int j) {
      const bf16* kt = k_tile(j);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, desc_k(at_byte(qs, kk * 32 * kBQ + wg * 64 * 32)), desc_k(at_byte(kt, kk * 32 * BKV)), kk > 0);
      wgmma_commit();
    };
    // O += P.V_j, issued
    auto issue_pv = [&](int j) {
      const bf16* vt = k_tile(j) + BKV * DP;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) wgmma_rs(o, p[kc], desc_mn(at_byte(vt, kc * 512), BKV));
      wgmma_commit();
    };
    // online softmax (base 2) of tile j's scores, in place: S becomes p =
    // exp2(S * scale - max), l takes p's row sums, and alpha is the factor
    // that takes O from the old running max to the new. Keys at or past
    // kv_len (in the last tile only) score -1e30 first, so p = 0 there.
    // Element e of n-tile nt is row lane/4 (+8 for e >= 2), key kv0 + nt*8
    // + 2*(lane%4) + (e&1). P.V of the tile before may still run: it reads p
    // and writes O, which are left alone here. Per score: a max, one fma,
    // one exp2 and an add (the scale > 0 commutes with the max).
    auto softmax = [&](int j, float(&alpha)[2]) {
      const int kv0 = j * BKV;
      if (kv0 + BKV > kv_len) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + nt * 8 + 2 * (lane % 4) + (e & 1) >= kv_len) s[nt][e] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = fast_exp2(fmaf(s[nt][e], scale_log2, -m[e >> 1]));
          l[e >> 1] += s[nt][e];
        }
      }
    };
    // p as bf16 A fragments: keys 16kc..16kc+15 are fragment kc
    auto pack_p = [&]() {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        p[nt / 2][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
        p[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }
    };

    if (wg == 1) named_arrive(1);  // warpgroup 0 takes the first turn
    mbar_wait(q_bar, 0);
    {  // tile 0: its scores alone in the turn
      float alpha[2];
      mbar_wait(full, 0);
      named_sync(me);
      issue_scores(0);
      named_arrive(other);
      wgmma_wait<0>();
      fence_operand(s);
      softmax(0, alpha);
      pack_p();
    }
    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(full + j % C::kStages, (j / C::kStages) & 1);
      // this warpgroup's turn: S_j = Q.K_j^T, then O += P_{j-1}.V_{j-1}
      named_sync(me);
      issue_scores(j);
      issue_pv(j - 1);
      named_arrive(other);
      wgmma_wait<1>();  // S_j is done; P_{j-1}.V_{j-1} runs on behind the softmax
      fence_operand(s);
      float alpha[2];
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_operand(o);
      if (lane == 0) mbar_arrive(empty + (j - 1) % C::kStages);  // tile j - 1's stage may be refilled
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }
      pack_p();
    }
    // the last turn: O += P.V of the last tile
    named_sync(me);
    issue_pv(n_tiles - 1);
    if (wg == 0) named_arrive(other);  // warpgroup 1 has no turn left to wait for
    wgmma_wait<0>();
    fence_operand(o);
    if (lane == 0) mbar_arrive(empty + (n_tiles - 1) % C::kStages);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    // K2: head blockIdx.y's [sq, d]; K5: batch blockIdx.z's rows from column h*D
    bf16* oh = out + (kPacked ? (size_t)blockIdx.z * sq * ld + blockIdx.y * d : (size_t)blockIdx.y * sq * d);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * (lane % 4);
      if (col < d) {  // d % 8 == 0: a pair is inside d or past it
        if (row < sq)
          *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * ld + col) =
              __floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);
        if (row + 8 < sq)
          *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(row + 8) * ld + col) =
              __floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);
      }
    }
    if constexpr (!kPacked) {
      if (lane % 4 == 0) {
        const size_t bh = blockIdx.y;
        if (row < sq) lse[bh * sq + row] = m[0] * kLn2 + logf(l[0]);
        if (row + 8 < sq) lse[bh * sq + row + 8] = m[1] * kLn2 + logf(l[1]);
      }
    }
  }
}

template <int DP, bool kPacked>
int start(const FwdMaps& maps, dim3 grid, void* out, void* lse, int sq, int d, int ld, int kv_len, float scale,
          cudaStream_t stream) {
  typedef FwdCfg<DP> C;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, kPacked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wgmma_kernel<DP, kPacked><<<grid, kThreads, C::kSmemBytes, stream>>>(
      maps, static_cast<bf16*>(out), static_cast<float*>(lse), sq, d, ld, kv_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq, int skv, int d,
           int kv_len, float scale, cudaStream_t stream) {
  typedef FwdCfg<DP> C;
  FwdMaps maps;
  if (!(make_map(&maps.q, q, bh, sq, sq, d, kBQ) && make_map(&maps.k, k, bh, kv_len, skv, d, C::kBKV) &&
        make_map(&maps.v, v, bh, kv_len, skv, d, C::kBKV)))
    return static_cast<int>(cudaErrorInvalidValue);
  return start<DP, false>(maps, dim3((sq + kBQ - 1) / kBQ, bh), out, lse, sq, d, d, kv_len, scale, stream);
}

template <int DP>
int launch_packed(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv, int h, int d,
                  float scale, cudaStream_t stream) {
  typedef FwdCfg<DP> C;
  FwdMaps maps;
  if (!(make_map_packed(&maps.q, q, b, sq, h, d, kBQ) && make_map_packed(&maps.k, k, b, skv, h, d, C::kBKV) &&
        make_map_packed(&maps.v, v, b, skv, h, d, C::kBKV)))
    return static_cast<int>(cudaErrorInvalidValue);
  return start<DP, true>(maps, dim3((sq + kBQ - 1) / kBQ, h, b), out, nullptr, sq, d, h * d, skv, scale, stream);
}

template <int DP>
int tiles(int* out) {
  typedef FwdCfg<DP> C;
  const int t[6] = {DP, kBQ, C::kBKV, C::kStages, kThreads, C::kSmemBytes};
  for (int i = 0; i < 6; ++i) out[i] = t[i];
  return 0;
}

// Returns F<DP>(args...) for the padded head dim DP of d; falls through
// where d is not a head dim of this kernel.
#define FDT_FWD_DISPATCH(F, d, ...)                      \
  switch ((d) % 8 || (d) < 8 || (d) > 128 ? 0 : ((d) + 15) / 16 * 16) { \
    case 16: return F<16>(__VA_ARGS__);                   \
    case 32: return F<32>(__VA_ARGS__);                   \
    case 48: return F<48>(__VA_ARGS__);                   \
    case 64: return F<64>(__VA_ARGS__);                   \
    case 80: return F<80>(__VA_ARGS__);                   \
    case 96: return F<96>(__VA_ARGS__);                   \
    case 112: return F<112>(__VA_ARGS__);                 \
    case 128: return F<128>(__VA_ARGS__);                 \
    default: break;                                       \
  }

}  // namespace

extern "C" {

// The tiles at head dim d into out[6]: padded D, q rows of a block, keys of
// a streamed tile, ring stages, threads of a block, dynamic shared memory
// (bytes). Returns 0, or cudaErrorInvalidValue for a head dim this kernel
// does not take (d % 8 != 0 or d > 128: flash_fwd_mma.cu's).
int fdt_flash_fwd_wgmma_tiles(int d, int* out) {
  FDT_FWD_DISPATCH(tiles, d, out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// Streaming forward for head dims d <= 128 (d % 8 == 0). q [bh, sq, d],
// k/v [bh, skv, d] bf16, read up to kv_len keys; out [bh, sq, d] bf16; lse
// [bh, sq] fp32. Returns the CUDA error code of the launch (0 on success).
int fdt_flash_fwd_stream_wgmma(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
                               int skv, int d, int kv_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDT_FWD_DISPATCH(launch, d, q, k, v, out, lse, bh, sq, skv, d, kv_len, scale, s)
  return static_cast<int>(cudaErrorInvalidValue);
}

// Packed streaming forward (K5). q [b, sq, h*d], k/v [b, skv, h*d], out [b,
// sq, h*d], all bf16 and contiguous; d in {64, 128}; b and h at most 65535
// (the grid's z and y). Returns the CUDA error code of the launch (0 on
// success).
int fdt_flash_fwd_packed(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv, int h,
                         int d, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || h < 1 || h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_packed<64>(q, k, v, out, b, sq, skv, h, d, scale, s);
    case 128: return launch_packed<128>(q, k, v, out, b, sq, skv, h, d, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
