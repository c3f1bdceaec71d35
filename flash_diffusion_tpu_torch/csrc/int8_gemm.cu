// W8A8 int8 GEMM with the dequant epilogue fused, for Hopper (sm_90a):
// wgmma with s8 operands fed by a TMA ring, warp-specialised; persistent,
// or split along K across a thread block cluster where the output has few
// tiles.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/gemm.py:171
// _int8_gemm_kernel (K11, via int8_gemm at :226): y[M, N] =
// act(float(sum_k xq[m, k] * wq[n, k]) * sx[m] * sw[n] + bias[n]), int8
// operands, exact int32 accumulation, the per-token and per-channel scales,
// the bias and the optional tanh-gelu applied in registers before one bf16
// store (a second epilogue stores the raw int32 sums, for checks). Every
// W8A8 product of the int8 serving path (attention q/k/v/out, the
// feed-forward's two projections, the spatial transformers'
// proj_in/proj_out) lands here, whatever its shape.
//
// What bounds it on this card: 2*M*K*N int8 operations at 1979 TOP/s
// against M*K + K*N bytes read and M*N*2 written at 3.35 TB/s. SDXL's
// products at M = 4096-16384 tokens are above the ridge (the tensor cores
// bound them); the cross-attention's k/v at M = 308 (4 x 77 text tokens) are
// far below it, and there only filling the card matters. So K10's design
// (gemm_sm90.cu) in int8:
//   - Both operands are K-major (xq rows and nn.Linear's wq rows), the only
//     layout int8 wgmma takes. A K step is 128 bytes deep: one 128-byte
//     swizzle atom (wgmma.cuh smem_desc_sw128) of 128 int8 values, copied
//     by TMA as one box of xq (128 rows) and one of wq (128 rows), and four
//     wgmma.mma_async m64n128k32 .s32.s8.s8 per 64 rows. Rows past M and N
//     and columns past K arrive as zeros (K % 32 == 0 keeps the row stride a
//     multiple of 16 bytes, as TMA needs).
//   - A ring of kStages such steps (5: as many as 227 KB hold beside the
//     output tiles), a full and an empty mbarrier each; one producer warp
//     (one thread of it) keeps it full, in the order the tiles are taken.
//   - Persistent: one block per SM walks its 128 x 128 tiles (N fastest).
//     Its two consumer warpgroups take the tiles in turn, each all 128 rows
//     of its tile (two m64 accumulators), and their products take turns at
//     the tensor cores: at SDXL's K = 640 the output is as large as both
//     inputs together, and its epilogue (the int32 -> fp32 conversions run
//     at a quarter of the FMA rate) took as long as the products when both
//     warpgroups shared a tile; now one warpgroup's epilogue runs beside the
//     other's products.
//   - The epilogue: the warpgroup dequantizes its tile into 128-byte-
//     swizzled boxes of [64, 64] bf16 in shared memory (conflict-free
//     4-byte writes, the layout TMA reads), and one thread stores them by
//     TMA, which runs on while the warpgroup waits for its next turn; each
//     thread's column scales and biases are loaded two n-tiles at a time,
//     ahead of their use (the two accumulators leave little room: ptxas
//     holds this block of 288 threads to 168 registers a thread). Stored
//     from the registers instead: the int32 sums, rows that are not whole
//     16-byte chunks (N % 8 != 0), and the split path.
//   - Split (few tiles, such as M = 308): a cluster of `split` blocks (2, 4
//     or 8) shares one output tile, each block summing its own share of the
//     K steps, its two warpgroups 64 rows each. Each writes its int32
//     partial sums into its shared memory (the drained ring); after a
//     cluster barrier, block r reads rows [r * 128 / split, (r + 1) * 128 /
//     split) of every peer's partials through distributed shared memory,
//     adds them, and runs the epilogue on its rows. No global atomics, no
//     second launch.
//   - Exactness: int32 sums of int8 products are exact in any order (|sum|
//     <= 127^2 * K stays far below 2^31 at the port's K), so the sums, and
//     the bf16 output computed from them alone, do not depend on the split,
//     the warpgroup or how M is cut: a row's bits are the same alone and
//     batched under any plan, which is why the plan may follow M here (K10
//     and K12, whose fp32 sums depend on their order, may not).
//   - The epilogue multiplies and adds with explicit round-to-nearest
//     intrinsics, in the order of the plain version (acc * sx * sw + bias,
//     then tanh-gelu), so that no fused multiply-add changes the fp32 value
//     before the store; stores are masked by row and column (pairs where N
//     is even, single elements where it is odd).

#include "tma.cuh"

namespace {

using namespace fdt;

constexpr int kBM = 128, kBN = 128, kBK = 128;  // output tile; K step (bytes = int8 values)
constexpr int kConsumerWarps = 8;             // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // and the producer warp
constexpr int kSmemLimit = 232448;

enum OutKind { kOutBf16 = 0, kOutInt32 = 1 };

struct Cfg {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + kBN * kBK;
  // each warpgroup's bf16 output tile [kBM, kBN] on its way out: 2 x 2
  // boxes of [64 rows, 64 columns], 128-byte swizzled (8 KB each)
  static constexpr int kOutBytes = kBM * kBN * 2;
  // 1024 bytes of slack to align the stages to a swizzle atom, the two
  // output tiles and the warpgroups' two turn barriers, then as many stages
  // (with a full and an empty barrier each) as fit
  static constexpr int kFixed = 1024 + 2 * kOutBytes + 16;
  static constexpr int kFit = (kSmemLimit - kFixed) / (kStageBytes + 16);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmemBytes = kFixed + kStages * (kStageBytes + 16);
  // the split path's int32 partial sums [kBM, kBN] over the drained ring; a
  // row stride of kBN + 8 words puts the 8 rows of a warp's stores on
  // distinct banks
  static constexpr int kPartStride = kBN + 8;
  static_assert(kStageBytes % 1024 == 0 && kStages >= 4, "stage shape");
  static_assert(kBM * kPartStride * 4 <= kStages * kStageBytes, "the partial sums fit the ring");
};

__device__ __forceinline__ float gelu_tanh(float y) {
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.0f + tanhf(u));
}

// One output value from its int32 sum, its row's and column's scales and
// its column's bias, in the plain version's order.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, bool has_bias, float b, int gelu) {
  float v = __fmul_rn(__fmul_rn(static_cast<float>(acc), xs), ws);
  if (has_bias) v = __fadd_rn(v, b);
  return gelu ? gelu_tanh(v) : v;
}

// 64 rows of the bf16 output tile from an accumulator of m64n128 into two
// swizzled boxes of [64, 64] in shared memory (the layout the TMA store
// reads): rows r0 and r0 + 8 of the 64, scales xs of those rows. Column
// (nt * 8 + 2 * (lane % 4)) lands in box nt / 8, 16-byte chunk nt % 8
// swizzled by the row, so the 8 rows of a warp's writes hit distinct banks.
// gelu a template argument: as a runtime flag it kept tanhf in the loop
// (the epilogue took as long as the products).
template <bool kGelu>
__device__ __forceinline__ void dequant_rows(const int (&acc)[kBN / 8][4], unsigned char* boxes, int r0,
                                             const float (&xs)[2], const float* sw, const float* bias, int n0, int n,
                                             int lane) {
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int nc = 0; nc < kBN / 8; nc += 2) {  // two n-tiles' scales and biases in flight at once
    float ws[2][2], b[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + (nc + i) * 8 + 2 * (lane % 4) + e;
        ws[i][e] = col < n ? __ldg(sw + col) : 0.0f;
        b[i][e] = has_bias && col < n ? __ldg(bias + col) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, nt = nc + i;
        *reinterpret_cast<__nv_bfloat162*>(boxes + (nt / 8) * 8192 + r * 128 + (((nt % 8) ^ (r % 8)) * 16) +
                                           4 * (lane % 4)) =
            __floats2bfloat162_rn(dequant(acc[nt][2 * half], xs[half], ws[i][0], has_bias, b[i][0], kGelu),
                                  dequant(acc[nt][2 * half + 1], xs[half], ws[i][1], has_bias, b[i][1], kGelu));
      }
  }
}

// Output elements (r, c) and (r, c + 1) from their sums a0, a1: the raw
// sums (int32 out) or the epilogue's bf16; masked by row and column.
__device__ __forceinline__ void store2(void* out, const float* sx, const float* sw, const float* bias, int r, int c,
                                       int m, int n, int a0, int a1, int out_kind, int gelu) {
  if (r >= m || c >= n) return;
  const bool second = c + 1 < n, pair = second && n % 2 == 0;  // pair: 4- or 8-byte aligned (c is even)
  const size_t at = (size_t)r * n + c;
  if (out_kind == kOutInt32) {
    int* o = static_cast<int*>(out) + at;
    if (pair) {
      *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
    } else {
      o[0] = a0;
      if (second) o[1] = a1;
    }
    return;
  }
  const float xs = sx[r];
  const bool has_bias = bias != nullptr;
  const float y0 = dequant(a0, xs, sw[c], has_bias, has_bias ? bias[c] : 0.0f, gelu);
  bf16* o = static_cast<bf16*>(out) + at;
  if (!second) {
    o[0] = __float2bfloat16_rn(y0);
    return;
  }
  const float y1 = dequant(a1, xs, sw[c + 1], has_bias, has_bias ? bias[c + 1] : 0.0f, gelu);
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
  } else {
    o[0] = __float2bfloat16_rn(y0);
    o[1] = __float2bfloat16_rn(y1);
  }
}

// Products of one 128-byte K step of a stage into acc (m64n128, rows a_row..
// a_row + 63 of the stage's A tile).
__device__ __forceinline__ void step_products(int (&acc)[kBN / 8][4], const unsigned char* st, int a_row) {
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk)
    wgmma_ss(acc, smem_desc_sw128(st + a_row * kBK + kk * 32), smem_desc_sw128(st + Cfg::kABytes + kk * 32));
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ sx,
                 const float* __restrict__ sw, const float* __restrict__ bias, void* __restrict__ out, int m, int n,
                 int k, int out_kind, int gelu, int split) {
  typedef Cfg C;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* tiles_out = smem + C::kStages * C::kStageBytes;  // the warpgroups' output tiles
  uint64_t* turn = reinterpret_cast<uint64_t*>(tiles_out + 2 * C::kOutBytes);
  uint64_t* full = turn + 2;
  uint64_t* empty = full + C::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int steps = (k + kBK - 1) / kBK;
  // persistent: tiles blockIdx.x, + gridDim.x, ...; split: the cluster's one
  // tile, and this block's share [ks0, ks1) of its K steps
  const int rank = kSplit ? static_cast<int>(cluster_ctarank()) : 0;
  const int first = kSplit ? blockIdx.x / split : blockIdx.x;
  const int stride = kSplit ? tiles : gridDim.x;
  const int ks0 = kSplit ? rank * steps / split : 0;
  const int ks1 = kSplit ? (rank + 1) * steps / split : steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSplit ? kConsumerWarps : kConsumerWarps / 2);  // the warps that read the stage
    }
    mbar_init(turn, 1);
    mbar_init(turn + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: the K steps of this block's tiles, in order
    if (lane == 0) {
      int it = 0;
      for (int t = first; t < tiles; t += stride) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
        for (int ks = ks0; ks < ks1; ++ks, ++it) {
          const int s = it % C::kStages;
          if (it >= C::kStages) mbar_wait(empty + s, (it / C::kStages - 1) & 1);
          unsigned char* st = smem + s * C::kStageBytes;
          mbar_expect(full + s, C::kStageBytes);
          tma_2d(st, &map_x, ks * kBK, m0, full + s);
          tma_2d(st + C::kABytes, &map_w, ks * kBK, n0, full + s);
        }
      }
    }
    if constexpr (!kSplit) return;
  } else if constexpr (kSplit) {
    // the cluster's one tile: warpgroup wg owns its rows 64wg..64wg+63 over
    // this block's K steps, then writes its partial sums into the drained ring
    const int wg = warp / 4;
    int acc[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
    for (int it = 0; it < ks1 - ks0; ++it) {
      const int s = it % C::kStages;
      mbar_wait(full + s, (it / C::kStages) & 1);
      wgmma_fence();
      step_products(acc, smem + s * C::kStageBytes, wg * 64);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: its stage may be refilled
      fence_operand(acc);
      if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % C::kStages);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    __syncwarp();
    named_barrier(1, kConsumerWarps * 32);  // every consumer is done reading the ring
    int* part = reinterpret_cast<int*>(smem);
    const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int c = nt * 8 + 2 * (lane % 4);
      *reinterpret_cast<int2*>(part + row * C::kPartStride + c) = make_int2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<int2*>(part + (row + 8) * C::kPartStride + c) = make_int2(acc[nt][2], acc[nt][3]);
    }
  } else {
    // persistent: the warpgroups take this block's tiles in turn (local
    // tile i to warpgroup i % 2), each all 128 rows of its tile. Their
    // products take turns at the tensor cores (warpgroup wg starts its
    // tile's products once the other has issued its previous tile's, on
    // turn[wg]), so that one's epilogue runs beside the other's products;
    // the turns also keep a warpgroup from waiting on a stage's barrier
    // before the other has consumed the stage's earlier fills.
    const int wg = warp / 4, wt = threadIdx.x % 128;
    const int r0 = (warp % 4) * 16 + lane / 4;  // rows r0 and r0 + 8 of each 64-row half
    unsigned char* boxes = tiles_out + wg * C::kOutBytes;
    int acc[2][kBN / 8][4];
    for (int i = wg, done = 0; first + i * stride < tiles; i += 2, ++done) {
      const int t = first + i * stride, m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      if (i > 0) mbar_wait(turn + wg, (wg == 0 ? done - 1 : done) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0;
      for (int ks = 0; ks < steps; ++ks) {
        const int it = i * steps + ks, s = it % C::kStages;  // the block's K steps run through the ring in tile order
        mbar_wait(full + s, (it / C::kStages) & 1);
        const unsigned char* st = smem + s * C::kStageBytes;
        wgmma_fence();
        step_products(acc[0], st, 0);
        step_products(acc[1], st, 64);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: its stage may be refilled
        fence_operand(acc[0]);
        fence_operand(acc[1]);
        if (ks > 0 && lane == 0) mbar_arrive(empty + (it - 1) % C::kStages);
      }
      if (wt == 0) mbar_arrive(turn + 1 - wg);  // every product of this tile is issued: the other's turn
      wgmma_wait<0>();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (steps > 0 && lane == 0) mbar_arrive(empty + (i * steps + steps - 1) % C::kStages);

      // element e of n-tile nt is row r0 (+8 for e >= 2) of a half's 64,
      // column nt*8 + 2*(lane%4) + (e&1)
      if (out_kind == kOutBf16 && n % 8 == 0) {
        // bf16 rows of whole 16-byte chunks: the warpgroup dequantizes its
        // tile into its swizzled boxes, and one thread stores them by TMA
        // while the warpgroup goes on to its next tile
        if (wt == 0) bulk_wait_read();  // its previous tile's stores have read the boxes
        named_barrier(2 + wg, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * h + r0;
          const float xs[2] = {row < m ? sx[row] : 0.0f, row + 8 < m ? sx[row + 8] : 0.0f};
          if (gelu)
            dequant_rows<true>(acc[h], boxes + h * 2 * 8192, r0, xs, sw, bias, n0, n, lane);
          else
            dequant_rows<false>(acc[h], boxes + h * 2 * 8192, r0, xs, sw, bias, n0, n, lane);
        }
        fence_proxy_async();  // these writes, visible to the TMA store
        named_barrier(2 + wg, 128);
        if (wt == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (m0 + 64 * h < m && n0 + 64 * b < n)
                tma_store_2d(&map_out, boxes + (2 * h + b) * 8192, n0 + 64 * b, m0 + 64 * h);
          bulk_commit();
        }
      } else {  // int32 sums, or rows not a whole number of 16-byte chunks
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              store2(out, sx, sw, bias, m0 + 64 * h + r0 + 8 * e, n0 + nt * 8 + 2 * (lane % 4), m, n,
                     acc[h][nt][2 * e], acc[h][nt][2 * e + 1], out_kind, gelu);
      }
    }
    if (wt == 0) bulk_wait();  // the last tile's stores are done
  }

  if constexpr (kSplit) {
    __syncwarp();
    cluster_sync();  // every block's partial sums are in its shared memory
    const int m0 = first / tiles_n * kBM, n0 = first % tiles_n * kBN;
    const int rows = kBM / split;
    const int* part = reinterpret_cast<const int*>(smem);
    for (int i = threadIdx.x; i < rows * (kBN / 4); i += kThreads) {
      const int r = rank * rows + i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const void* at = part + r * C::kPartStride + c;
      int4 sum = make_int4(0, 0, 0, 0);
      for (int p = 0; p < split; ++p) {  // exact in any order
        const int4 v = ld_cluster_v4(peer_addr(at, p));
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      store2(out, sx, sw, bias, m0 + r, n0 + c, m, n, sum.x, sum.y, out_kind, gelu);
      store2(out, sx, sw, bias, m0 + r, n0 + c + 2, m, n, sum.z, sum.w, out_kind, gelu);
    }
    __syncwarp();
    cluster_sync();  // no block leaves while its peers read its shared memory
  }
}

// K11's plan for [m, k] x [n, k]^T on `sms` SMs into out[6]: tile width (128),
// split (1: persistent), ring stages, dynamic shared memory (bytes),
// threads and blocks of the launch. Few tiles (at most half the SMs) and at
// least two K steps: the widest split of 8, 4 or 2 that divides the K steps
// and keeps tiles * split within the SMs; else persistent. split != 0 asks
// for that split instead. Returns 0, or cudaErrorInvalidValue for a split
// not built.
int plan(int m, int n, int k, int sms, int split, int* out) {
  const int tiles = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN), steps = (k + kBK - 1) / kBK;
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (split == 0) {
    split = 1;
    if (2 * tiles <= sms && steps >= 2)
      for (int s = 8; s >= 2 && split == 1; s /= 2)
        if (steps % s == 0 && tiles * s <= sms) split = s;
  }
  if (split != 1 && split != 2 && split != 4 && split != 8) return static_cast<int>(cudaErrorInvalidValue);
  const int t[6] = {kBN, split, Cfg::kStages, Cfg::kSmemBytes, kThreads,
                    split > 1 ? tiles * split : (tiles < sms ? tiles : sms)};
  for (int i = 0; i < 6; ++i) out[i] = t[i];
  return 0;
}

template <bool kSplit>
int launch(const void* xq, const void* wq, const void* sx, const void* sw, const void* bias, void* out, int m, int n,
           int k, int out_kind, int gelu, int split, int blocks, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_out = {};  // map_out: bf16 rows of whole 16-byte chunks only
  if (!make_map_2d(&map_x, xq, m, k, kBM, 1) || !make_map_2d(&map_w, wq, n, k, kBN, 1) ||
      (!kSplit && out_kind == kOutBf16 && n % 8 == 0 && !make_map_2d(&map_out, out, m, n, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const float*, const float*, const float*,
                 void*, int, int, int, int, int, int) = int8_gemm_kernel<kSplit>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg::kSmemBytes;
  cfg.stream = stream;
  if constexpr (kSplit) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, map_out, static_cast<const float*>(sx),
                           static_cast<const float*>(sw), static_cast<const float*>(bias), out, m, n, k, out_kind, gelu,
                           split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K11's plan (above) for [m, k] x [n, k]^T into out[6] = {BN, split,
// stages, shared bytes, threads, blocks}, on `sms` SMs (0: this card's).
int fdt_int8_gemm_plan(int m, int n, int k, int sms, int split, int* out) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return plan(m, n, k, sms ? sms : sm_count(), split, out);
}

// xq [m, k] and wq [n, k] int8, row-major, 16-byte aligned, k % 32 == 0;
// sx [m], sw [n] and bias [n] (or null) fp32. out [m, n]: bf16
// (out_kind 0) with the epilogue, tanh-gelu when gelu != 0; or the raw
// int32 sums (1: scales, bias and gelu unused). split as in
// fdt_int8_gemm_plan (0: the plan's). Returns the CUDA error code of the
// launch (0 on success).
int fdt_int8_gemm(const void* xq, const void* wq, const void* sx, const void* sw, const void* bias, void* out, int m,
                  int n, int k, int out_kind, int gelu, int split, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || (out_kind != kOutBf16 && out_kind != kOutInt32))
    return static_cast<int>(cudaErrorInvalidValue);
  int p[6];
  const int err = plan(m, n, k, sm_count(), split, p);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p[1] > 1) return launch<true>(xq, wq, sx, sw, bias, out, m, n, k, out_kind, gelu, p[1], p[5], s);
  return launch<false>(xq, wq, sx, sw, bias, out, m, n, k, out_kind, gelu, 1, p[5], s);
}

}  // extern "C"
