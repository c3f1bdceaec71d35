// bf16 GEMMs of the feed-forward's down projection, for Hopper (sm_90a):
// wgmma fed by a TMA ring, warp-specialised; K10 on x as it is, K12 on h =
// a * gelu_tanh(g) made by a producer warpgroup on the way into the ring.
//
// Replaces two Pallas TPU kernels of flash_diffusion_tpu/ops/gemm.py:
//   - :36 _gemm_kernel (K10, via down_proj_gemm): y[M, N] = x[M, K] .
//     w[N, K]^T + b[N], fp32 accumulator, the bias added in fp32 (acc +
//     float(b), rounded to nearest), one cast to bf16:
//     down_proj_gemm_reference's contract. The JAX `act` prologue is never
//     set by a caller. SDXL's feed-forwards send it [16384, 2560] -> 640 and
//     [4096, 5120] -> 1280 at batch 4, 1024²; DownProjGemmFunction's
//     backward sends it dW = x^T . dy at [2560, 16384] -> 640 and [5120,
//     4096] -> 1280.
//   - :271 _geglu_gemm_kernel (K12, via geglu_down_proj at :374): the same
//     product and epilogue on h = a * gelu_tanh(g), where [a | g] are the
//     two halves of one row-major [M, 2K] array (the up projection's raw
//     output; no split copy), and h never goes to device memory. h is made
//     in fp32 from the bf16 inputs (torch's tanh form, tanh.approx.f32 for
//     tanhf) and rounded once to bf16, the wgmma operand:
//     geglu_down_proj_reference's rounding contract (ops/gemm.py). SDXL's feed-forwards send it [16384, 2 * 2560] -> 640 and
//     [4096, 2 * 5120] -> 1280.
//
// What bounds them on this card: 2*M*K*N operations at 989 TFLOP/s against
// (M*K + K*N + M*N) * 2 bytes at 3.35 TB/s (K12 reads 2*M*K): the tensor
// cores, and for K12 at [16384, 2 * 2560] -> 640 the bytes about as much.
// So the design is the one that reaches them on Hopper:
//   - Both operands are K-major (x rows and nn.Linear's w rows), as wgmma
//     reads them from shared memory. A K step is 64 deep: one 128-byte
//     swizzle atom (wgmma.cuh smem_desc_sw128) of the A tile (128 rows) and
//     of w (BN rows); rows past M and N arrive as zeros and are never
//     stored.
//   - A ring of kStages such steps (K10: 4 to 7, as many as 227 KB hold),
//     each with a full mbarrier (the step's operands are in place) and an
//     empty one (the consumer warpgroups are done with it).
//   - Two consumer warpgroups each own 64 rows of the 128 x BN output tile
//     and issue wgmma.mma_async m64nBNk16, four per K step, with one step's
//     products still running while the next step's are issued; the
//     epilogue adds the bias, rounds once and stores bf16 pairs, masked by
//     row and column. K10 and K12 share this code.
//   - K10: one producer warp (one thread of it) copies x's and w's boxes by
//     TMA. Persistent: one block per SM walks the output tiles (N fastest,
//     so the blocks in flight share x rows and all of w in L2); the
//     producer fills the next tile's steps during the epilogue.
//   - K12: two loader warps, four h-maker warps and a copier warp. One
//     loader copies w's box by TMA into the stage as K10's producer does,
//     the other the a and g boxes of the block's rows of h into a staging
//     ring (kStagingSlots deep), each running ahead as far as its ring lets
//     it. Each h-maker warp turns its quarter of a staging slot into h (16
//     bytes at a time, at the same offsets: both tiles are 128-byte
//     swizzled and start on an 8-row boundary) and writes it into the A
//     stage, then runs fence.proxy.async.shared::cta before it arrives on
//     the stage's full barrier: wgmma reads through the async proxy, and
//     without the fence it may read stale shared memory. Each role has a
//     warp of its own and waits only on its own barriers: one thread that
//     issued every copy, a warpgroup barrier each step, or two roles in one
//     warp (a lane blocked in its wait holds the other's back) kept the
//     ring empty on the card.
//   - K12 makes each h once or a few times: a cluster of kCluster blocks
//     along N shares one 128-row block of x (N = 640: all 4 of its tiles;
//     N = 1280: 2 of its 8, since the card holds only 15 clusters of 8, on
//     120 SMs, which leaves a third round). Block r makes rows [r * 128 /
//     kCluster, (r + 1) * 128 / kCluster) of h; once the four h-maker warps
//     have arrived on the stage's made barrier, the copier warp copies them
//     into the peers' A stages by bulk copies (cp.async.bulk.shared::cluster,
//     one lane a peer), which complete on the peers' full barriers. Every
//     block writes into every block's A stages, so each consumer warp
//     arrives on the stage's empty barrier in every block of the cluster
//     (lane p on block p's). kCluster = 1 is the other variant: each block
//     makes all 128 rows of h, once per N tile. One cluster tile a cluster
//     (not persistent).
//   - No split of K, no atomics: each output element is one block's sum over
//     K in a fixed order, so a row's bits do not depend on M (alone vs
//     batched), and the plans follow N and K only (plan_bn and
//     plan_geglu, mirrored by ops/gemm.py gemm_plan and geglu_gemm_plan).

#include "tma.cuh"

namespace {

using namespace fdt;

constexpr int kBM = 128, kBK = 64;            // tile rows (two warpgroups of 64); K step (one swizzle atom)
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kSmemLimit = 232448;

template <int BN, int kCluster, bool kGeglu>
struct GemmCfg {
  // K12: a w loader warp, a staging loader warp, four h-maker warps and,
  // with a cluster, a copier warp (each of these waits on its own barriers:
  // two roles in one warp stall each other's waits)
  static constexpr int kProducerWarps = kGeglu ? (kCluster > 1 ? 7 : 6) : 1;
  static constexpr int kThreads = 32 * (kConsumerWarps + kProducerWarps);
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  // K12: the rows of h a block makes, their bytes (one 128-byte row each),
  // and the staging ring of their a and g boxes with two barriers each
  static constexpr int kSlice = kBM / kCluster;
  static constexpr int kSliceBytes = kSlice * kBK * 2;
  // as many slots as 40 KB hold, 2 to 8: the a and g boxes come from device
  // memory and take some steps to land
  static constexpr int kSlotsFit = 40960 / (2 * kSliceBytes);
  static constexpr int kStagingSlots = !kGeglu ? 0 : kSlotsFit < 2 ? 2 : kSlotsFit > 8 ? 8 : kSlotsFit;
  static constexpr int kStaging = kStagingSlots * 2 * kSliceBytes;
  // the stages with their barriers (full and empty; K12 also made), 1024
  // bytes of slack to align them to a swizzle atom, and the staging ring
  // with its two barriers a slot
  static constexpr int kStageTotal = kStageBytes + (kGeglu ? 24 : 16);
  static constexpr int kFixed = 1024 + kStaging + 16 * kStagingSlots;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageTotal;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmemBytes = kFixed + kStages * kStageTotal;
  static_assert(kStageBytes % 1024 == 0 && kSliceBytes % 1024 == 0 && kStages >= 3, "stage shape");
};

// The tile width of K10 for a product of depth k into n columns, from K and
// N alone. At SDXL's four shapes, the fastest of a sweep on the card
// (PERF.md): the width sets the wave count there (132 SMs), and the wave
// count at these M is what the sweep measured. Elsewhere 160 where it
// divides N, else 128 (n % 128 == 0 on the eligible shapes; any even n
// runs).
int plan_bn(int k, int n) {
  if (n == 640) return k == 16384 ? 112 : 160;  // dW at M = 2560: 120 tiles; the forward at K = 2560
  if (n == 1280 && k == 4096) return 224;       // dW at M = 5120: 240 tiles
  return n % 160 == 0 ? 160 : 128;
}

// K12's tile width and cluster, from N alone (K does not change them): 160
// where it divides N, else 128 without a cluster. At SDXL's widths the
// fastest of a sweep on the card (PERF.md): at N = 640 a cluster of all 4
// tiles (each h made once); at N = 1280 a cluster of 2 (each h made 4
// times), since the card holds only 15 clusters of 8 at once (120 SMs),
// which leaves 32 row blocks a third, mostly empty round, and 66 of 2.
// Elsewhere 2 where it divides N's tiles, else 1.
void plan_geglu(int n, int* bn, int* cluster) {
  *bn = n % 160 == 0 ? 160 : 128;
  const int tiles_n = (n + *bn - 1) / *bn;
  *cluster = *bn == 128 ? 1 : n == 640 ? 4 : tiles_n % 2 == 0 ? 2 : 1;
}

// torch's tanh-approximated gelu in fp32 (aten's GeluCUDAKernelImpl's
// form), with the hardware's tanh.approx.f32 for tanhf: tanhf's ~20
// instructions an element made the h-makers the slowest role at N = 640;
// the approximation leaves gemm_gate's relative L2 error where tanhf had it
// (ops/gemm.py's rounding contract).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(inner));
  return 0.5f * x * (1.0f + t);
}

// h = a * gelu_tanh(g) on 8 bf16 pairs of lanes, in fp32, rounded once.
__device__ __forceinline__ uint4 geglu8(uint4 av, const uint4 gv) {
  __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(&av);
  const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 af = __bfloat1622float2(ap[e]);
    const float2 gf = __bfloat1622float2(gp[e]);
    ap[e] = __floats2bfloat162_rn(__fmul_rn(af.x, gelu_tanh(gf.x)), __fmul_rn(af.y, gelu_tanh(gf.y)));
  }
  return av;
}

// K12's a and g boxes of x = [a | g] at K step ks, rows [row, row +
// kSliceBytes / 128), into a staging slot (one thread).
template <int kSliceBytes>
__device__ __forceinline__ void stage_ag(unsigned char* slot, const CUtensorMap* map, int k, int ks, int row,
                                         uint64_t* bar) {
  mbar_expect(bar, 2 * kSliceBytes);
  tma_2d(slot, map, ks * kBK, row, bar);                    // a
  tma_2d(slot + kSliceBytes, map, k + ks * kBK, row, bar);  // g
}

// One consumer warp's arrival on a stage's empty barrier (by lane): this
// block's, or with a cluster every block's, lane p arriving on block p's
// (each block writes rows of h into every A stage); the lanes arrive side
// by side, where one lane's loop over the blocks cost the step ~1.3x.
template <int kCluster>
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if constexpr (kCluster == 1) {
    if (lane == 0) mbar_arrive(bar);
  } else {
    if (lane < kCluster) mbar_arrive_cluster(peer_addr(bar, lane));
  }
}

// x: K10 [m, k]; K12 [m, 2k] (a = columns [0, k), g = [k, 2k)). w [n, k];
// bias [n]; out [m, n]; all bf16, row-major.
template <int BN, int kCluster, bool kGeglu>
__global__ void __launch_bounds__(GemmCfg<BN, kCluster, kGeglu>::kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int n, int k) {
  typedef GemmCfg<BN, kCluster, kGeglu> C;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::kStaging);
  uint64_t* empty = full + C::kStages;
  uint64_t* staged = empty + C::kStages;         // K12: a staging slot's a and g landed
  uint64_t* freed = staged + C::kStagingSlots;   // K12: a staging slot's a and g are read
  uint64_t* made = freed + C::kStagingSlots;     // K12: a stage's rows of h from this block are written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (n + BN - 1) / BN;
  const int steps = k / kBK;
  // tiles in groups of kCluster along N (one block each), walked from the
  // cluster's index by the clusters' count: K10 (kCluster 1) persistent, K12
  // one group a cluster
  const int rank = kCluster > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int groups_n = tiles_n / kCluster;
  const int groups = (m + kBM - 1) / kBM * groups_n;
  const int first = blockIdx.x / kCluster, stride = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, kGeglu ? 5 : 1);  // K12: the w copy's arrival and the four quarters of the rows of h
      mbar_init(empty + s, kConsumerWarps * kCluster);
    }
    for (int q = 0; q < C::kStagingSlots; ++q) {
      mbar_init(staged + q, 1);
      mbar_init(freed + q, 4);
    }
    for (int s = 0; s < (kGeglu ? C::kStages : 0); ++s) mbar_init(made + s, 4);
    mbar_fence_init();
  }
  if constexpr (kCluster > 1)
    cluster_sync();  // the peers' barriers are initialised before any block arrives on them
  else
    __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer
    if constexpr (!kGeglu) {
      if (lane == 0) {
        int it = 0;  // K steps issued by this block, over all its tiles
        for (int g = first; g < groups; g += stride) {
          const int m0 = g / groups_n * kBM, n0 = (g % groups_n * kCluster + rank) * BN;
          for (int ks = 0; ks < steps; ++ks, ++it) {
            const int s = it % C::kStages;
            if (it >= C::kStages) mbar_wait(empty + s, (it / C::kStages - 1) & 1);
            unsigned char* st = smem + s * C::kStageBytes;
            mbar_expect(full + s, C::kStageBytes);
            tma_2d(st, &map_x, ks * kBK, m0, full + s);
            tma_2d(st + C::kABytes, &map_w, ks * kBK, n0, full + s);
          }
        }
      }
    } else if (const int total = (first < groups ? (groups - 1 - first) / stride + 1 : 0) * steps;  // this block's K steps
               warp == kConsumerWarps) {  // K12's w loader (one thread), running ahead as far as the ring lets it
      if (lane == 0) {
        for (int j = 0; j < total; ++j) {
          const int g = first + j / steps * stride, s = j % C::kStages;
          // every block's consumers are done with stage s (its A stage takes
          // rows of h from every block)
          if (j >= C::kStages) mbar_wait(empty + s, (j / C::kStages - 1) & 1);
          mbar_expect(full + s, BN * kBK * 2 + (kCluster - 1) * C::kSliceBytes);
          tma_2d(smem + s * C::kStageBytes + C::kABytes, &map_w, j % steps * kBK,
                 (g % groups_n * kCluster + rank) * BN, full + s);
        }
      }
    } else if (warp == kConsumerWarps + 1) {  // K12's staging loader (one thread), as far ahead as its ring lets it
      if (lane == 0) {
        const CUtensorMap* mx = &map_x;
        for (int j = 0; j < total; ++j) {
          const int g = first + j / steps * stride, q = j % C::kStagingSlots;
          if (j >= C::kStagingSlots) mbar_wait(freed + q, (j / C::kStagingSlots - 1) & 1);
          stage_ag<C::kSliceBytes>(staging + q * 2 * C::kSliceBytes, mx, k, j % steps,
                                   g / groups_n * kBM + rank * C::kSlice, staged + q);
        }
      }
    } else if (warp == kConsumerWarps + 6) {  // K12's copier: this block's rows of h into the peers' A stages
      for (int j = 0; j < total; ++j) {
        const int s = j % C::kStages;
        unsigned char* h = smem + s * C::kStageBytes + rank * C::kSliceBytes;
        mbar_wait(made + s, (j / C::kStages) & 1);
        if (lane < kCluster - 1) {  // one lane a peer
          const uint32_t peer = (rank + 1 + lane) % kCluster;
          bulk_copy_to_peer(peer_addr(h, peer), h, C::kSliceBytes, peer_addr(full + s, peer));
        }
      }
    } else {  // K12's h-makers: four warps, each a quarter of the block's rows of h
      const int quarter = C::kSliceBytes / 4, off = (warp - kConsumerWarps - 2) * quarter;
      for (int j = 0; j < total; ++j) {
        const int s = j % C::kStages, q = j % C::kStagingSlots;
        unsigned char* h = smem + s * C::kStageBytes + rank * C::kSliceBytes + off;
        const unsigned char* slot = staging + q * 2 * C::kSliceBytes + off;
        if (j >= C::kStages) mbar_wait(empty + s, (j / C::kStages - 1) & 1);
        mbar_wait(staged + q, (j / C::kStagingSlots) & 1);
        for (int o = lane * 16; o < quarter; o += 32 * 16)
          *reinterpret_cast<uint4*>(h + o) = geglu8(*reinterpret_cast<const uint4*>(slot + o),
                                                    *reinterpret_cast<const uint4*>(slot + C::kSliceBytes + o));
        fence_proxy_async();  // these writes of h, visible to wgmma and the bulk copies
        __syncwarp();         // the warp's quarter is written; its staging bytes are read
        if (lane == 0) {
          mbar_arrive(full + s);  // this quarter of the block's rows of h is in place
          mbar_arrive(freed + q);
          if (kCluster > 1) mbar_arrive(made + s);
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64wg..64wg+63 of each tile
    const int wg = warp / 4;
    float acc[BN / 8][4];
    int it = 0;
    for (int g = first; g < groups; g += stride) {
      const int m0 = g / groups_n * kBM, n0 = (g % groups_n * kCluster + rank) * BN;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % C::kStages;
        mbar_wait(full + s, (it / C::kStages) & 1);
        const unsigned char* st = smem + s * C::kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss(acc, smem_desc_sw128(st + wg * 64 * 128 + kk * 32), smem_desc_sw128(st + C::kABytes + kk * 32));
        wgmma_commit();
        // the previous step's products are done: its stage may be refilled
        wgmma_wait<1>();
        fence_operand(acc);
        if (ks > 0) release<kCluster>(empty + (it - 1) % C::kStages, lane);
      }
      wgmma_wait<0>();
      fence_operand(acc);
      release<kCluster>(empty + (it - 1) % C::kStages, lane);

      // epilogue: element e of n-tile nt is row lane/4 (+8 for e >= 2) of the
      // warp's 16, column nt*8 + 2*(lane%4) + (e&1); n is even (the host checks)
      const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * (lane % 4);
        if (col >= n) continue;
        const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row + 8 * half;
          if (r < m)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * n + col) = __floats2bfloat162_rn(
                __fadd_rn(acc[nt][2 * half], bf.x), __fadd_rn(acc[nt][2 * half + 1], bf.y));
        }
      }
    }
  }
  if constexpr (kCluster > 1) {
    __syncwarp();
    cluster_sync();  // no block leaves while its peers may still arrive on its barriers
  }
}

template <int BN, int kCluster, bool kGeglu>
int launch(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, cudaStream_t stream) {
  typedef GemmCfg<BN, kCluster, kGeglu> C;
  const int tiles_n = (n + BN - 1) / BN;
  if (tiles_n % kCluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map_2d(&map_x, x, m, kGeglu ? 2 * k : k, kGeglu ? C::kSlice : kBM) || !make_map_2d(&map_w, w, n, k, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const bf16*, bf16*, int, int, int) =
      gemm_sm90_kernel<BN, kCluster, kGeglu>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (m + kBM - 1) / kBM * (tiles_n / kCluster);
  int blocks = groups * kCluster;  // K12: one group a cluster
  if constexpr (!kGeglu) {         // K10: persistent, one block per SM
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    blocks = groups < sms ? groups : sms;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  if constexpr (kCluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, n,
                           k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int kCluster, bool kGeglu>
int plan(int* out) {
  typedef GemmCfg<BN, kCluster, kGeglu> C;
  const int t[5] = {BN, kCluster, C::kStages, C::kSmemBytes, C::kThreads};
  for (int i = 0; i < 5; ++i) out[i] = t[i];
  return 0;
}

template <int BN>
int launch_k10(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, cudaStream_t stream) {
  return launch<BN, 1, false>(x, w, bias, out, m, n, k, stream);
}

template <int BN>
int plan_k10(int* out) {
  int t[5];
  plan<BN, 1, false>(t);
  out[0] = t[0], out[1] = t[2], out[2] = t[3], out[3] = t[4];
  return 0;
}

// Returns F<BN>(args...) for BN in K10's built set; falls through otherwise.
#define FDT_GEMM_DISPATCH(F, bn, ...)          \
  switch (bn) {                                \
    case 112: return F<112>(__VA_ARGS__);      \
    case 128: return F<128>(__VA_ARGS__);      \
    case 160: return F<160>(__VA_ARGS__);      \
    case 224: return F<224>(__VA_ARGS__);      \
    case 256: return F<256>(__VA_ARGS__);      \
    default: break;                            \
  }

// Returns F<BN, cluster, true>(args...) for K12's built (BN, cluster): the
// plan's (160 with 8 or 4, 128 with 1), 160 with 2 (the sweep) and 160 with
// 1, the variant that makes every row of h in every block; falls through
// otherwise.
#define FDT_GEGLU_DISPATCH(F, bn, cluster, ...)                     \
  switch (bn * 16 + cluster) {                                      \
    case 160 * 16 + 8: return F<160, 8, true>(__VA_ARGS__);         \
    case 160 * 16 + 4: return F<160, 4, true>(__VA_ARGS__);         \
    case 160 * 16 + 2: return F<160, 2, true>(__VA_ARGS__);         \
    case 160 * 16 + 1: return F<160, 1, true>(__VA_ARGS__);         \
    case 128 * 16 + 1: return F<128, 1, true>(__VA_ARGS__);         \
    default: break;                                                 \
  }

// The most clusters of K12's (BN, cluster) that the card holds at once
// (cudaOccupancyMaxActiveClusters) into out[0]: what a cluster of blocks
// that each take a whole SM leaves of the SMs.
template <int BN, int kCluster, bool kGeglu>
int occupancy(int* out) {
  typedef GemmCfg<BN, kCluster, kGeglu> C;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const bf16*, bf16*, int, int, int) =
      gemm_sm90_kernel<BN, kCluster, kGeglu>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(kernel), &cfg));
}

void geglu_choice(int n, int* bn, int* cluster) {
  int pbn, pc;
  plan_geglu(n, &pbn, &pc);
  if (*bn == 0) *bn = pbn;
  if (*cluster == 0) *cluster = *bn == pbn ? pc : 1;
}

}  // namespace

extern "C" {

// K10's plan for a product of depth k into n columns into out[4]: tile
// width BN, ring stages, dynamic shared memory (bytes), threads of a block;
// bn != 0 asks for that width instead of the plan's (112, 128, 160, 224, 256).
// Returns 0, or cudaErrorInvalidValue for a width not built.
int fdt_gemm_plan(int k, int n, int bn, int* out) {
  FDT_GEMM_DISPATCH(plan_k10, bn ? bn : plan_bn(k, n), out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10: y [m, n] = x [m, k] . w [n, k]^T + bias [n], all bf16, contiguous,
// 16-byte aligned; k % 64 == 0, n even. bn as in fdt_gemm_plan. Returns the
// CUDA error code of the launch (0 on success).
int fdt_gemm_sm90(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, int bn,
                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK != 0 || n % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDT_GEMM_DISPATCH(launch_k10, bn ? bn : plan_bn(k, n), x, w, bias, out, m, n, k, s)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12's plan for a product of depth k into n columns into out[5]: tile
// width BN, cluster, ring stages, dynamic shared memory (bytes), threads of
// a block; bn, cluster != 0 ask for that one instead. Returns 0, or
// cudaErrorInvalidValue for one not built.
int fdt_geglu_gemm_plan(int k, int n, int bn, int cluster, int* out) {
  (void)k;
  geglu_choice(n, &bn, &cluster);
  FDT_GEGLU_DISPATCH(plan, bn, cluster, out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12's occupancy (above) for a built (bn, cluster) into out[0]; 0 or a
// CUDA error code.
int fdt_geglu_gemm_occupancy(int bn, int cluster, int* out) {
  FDT_GEGLU_DISPATCH(occupancy, bn, cluster, out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12: y [m, n] = (a * gelu_tanh(g)) . w [n, k]^T + bias [n] with x = [a | g]
// of shape [m, 2k]. All bf16, contiguous, 16-byte aligned; k % 64 == 0, n
// even. bn and cluster as in fdt_geglu_gemm_plan. Returns the CUDA error
// code of the launch (0 on success).
int fdt_geglu_gemm(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, int bn, int cluster,
                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK != 0 || n % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  geglu_choice(n, &bn, &cluster);
  FDT_GEGLU_DISPATCH(launch, bn, cluster, x, w, bias, out, m, n, k, static_cast<cudaStream_t>(stream))
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
