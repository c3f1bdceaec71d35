// bf16 GEMM for the feed-forward's down projection, for Hopper (sm_90a):
// wgmma fed by a TMA ring, warp-specialised and persistent.
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/gemm.py:36
// _gemm_kernel (K10, via down_proj_gemm): y[M, N] = x[M, K] . w[N, K]^T +
// b[N], fp32 accumulator, the bias added in fp32 (acc + float(b), rounded
// to nearest), one cast to bf16: down_proj_gemm_reference's contract. The
// JAX `act` prologue is never set by a caller. SDXL's feed-forwards send
// it [16384, 2560] -> 640 and [4096, 5120] -> 1280 at batch 4, 1024²;
// DownProjGemmFunction's backward sends it dW = x^T . dy at [2560, 16384]
// -> 640 and [5120, 4096] -> 1280.
//
// What bounds it on this card: 2*M*K*N operations at 989 TFLOP/s against
// (M*K + K*N + M*N) * 2 bytes at 3.35 TB/s: the tensor cores at all four
// shapes. So the design is the one that reaches them on Hopper:
//   - Both operands are K-major (x rows and nn.Linear's w rows), as wgmma
//     reads them from shared memory. A K step is 64 deep: one 128-byte
//     swizzle atom (wgmma.cuh smem_desc_sw128), copied by TMA as one box of
//     x (128 rows) and one of w (BN rows); rows past M and N arrive as
//     zeros and are never stored.
//   - A ring of kStages such steps (4 to 7: as many as 227 KB hold), each
//     with a full mbarrier (the copy landed) and an empty one (both
//     consumer warpgroups are done with it).
//   - One producer warp (one thread of it) keeps the ring full; two
//     consumer warpgroups each own 64 rows of the 128 x BN output tile and
//     issue wgmma.mma_async m64nBNk16, four per K step, with one step's
//     products still running while the next step's are issued.
//   - Persistent: one block per SM walks the output tiles in a fixed order
//     (N fastest, so the blocks in flight share x rows and all of w in L2);
//     the producer fills the next tile's steps during the epilogue.
//   - The epilogue adds the bias, rounds once and stores bf16 pairs, masked
//     by row and column.
//   - No split of K, no atomics: each output element is one block's sum over
//     K in a fixed order, so a row's bits do not depend on M (alone vs
//     batched), and the tile width BN follows N and K only (plan_bn,
//     mirrored by ops/gemm.py gemm_plan).

#include "tma.cuh"

namespace {

using namespace fdt;

constexpr int kBM = 128, kBK = 64;            // tile rows (two warpgroups of 64); K step (one swizzle atom)
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // and the producer warp
constexpr int kSmemLimit = 232448;

template <int BN>
struct GemmCfg {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  // the stages, 1024 bytes of slack to align them to a swizzle atom, and the
  // full and empty barriers of each
  static constexpr int kStages = (kSmemLimit - 1024) / (kStageBytes + 16) < 8 ? (kSmemLimit - 1024) / (kStageBytes + 16) : 8;
  static constexpr int kSmemBytes = 1024 + kStages * (kStageBytes + 16);
  static_assert(kStageBytes % 1024 == 0 && kStages >= 4, "stage shape");
};

// The tile width for a product of depth k into n columns, from K and N
// alone. At SDXL's four shapes, the fastest of a sweep on the card
// (PERF.md): the width sets the wave count there (132 SMs), and the wave
// count at these M is what the sweep measured. Elsewhere 160 where it
// divides N, else 128 (n % 128 == 0 on the eligible shapes; any even n
// runs).
int plan_bn(int k, int n) {
  if (n == 640) return k == 16384 ? 112 : 160;  // dW at M = 2560: 120 tiles; the forward at K = 2560
  if (n == 1280 && k == 4096) return 224;       // dW at M = 5120: 240 tiles
  return n % 160 == 0 ? 160 : 128;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int n, int k) {
  typedef GemmCfg<BN> C;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int steps = k / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      int it = 0;  // K steps issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * BN;
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
    return;
  }

  // the consumers: warpgroup wg owns rows 64wg..64wg+63 of each tile
  const int wg = warp / 4;
  float acc[BN / 8][4];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * BN;
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
      if (ks > 0 && lane == 0) mbar_arrive(empty + (it - 1) % C::kStages);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % C::kStages);

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

// The SMs of the current card, or 0 on an error: the persistent grid.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int BN>
int launch(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, cudaStream_t stream) {
  typedef GemmCfg<BN> C;
  CUtensorMap map_x, map_w;
  if (!make_map_2d(&map_x, x, m, k, kBM) || !make_map_2d(&map_w, w, n, k, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gemm_sm90_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kBM - 1) / kBM * ((n + BN - 1) / BN);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  gemm_sm90_kernel<BN><<<tiles < sms ? tiles : sms, kThreads, C::kSmemBytes, stream>>>(
      map_x, map_w, static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int plan(int* out) {
  typedef GemmCfg<BN> C;
  const int t[4] = {BN, C::kStages, C::kSmemBytes, kThreads};
  for (int i = 0; i < 4; ++i) out[i] = t[i];
  return 0;
}

// Returns F<BN>(args...) for BN in the built set; falls through otherwise.
#define FDT_GEMM_DISPATCH(F, bn, ...)          \
  switch (bn) {                                \
    case 112: return F<112>(__VA_ARGS__);      \
    case 128: return F<128>(__VA_ARGS__);      \
    case 160: return F<160>(__VA_ARGS__);      \
    case 224: return F<224>(__VA_ARGS__);      \
    case 256: return F<256>(__VA_ARGS__);      \
    default: break;                            \
  }

}  // namespace

extern "C" {

// K10's plan for a product of depth k into n columns into out[4]: tile
// width BN, ring stages, dynamic shared memory (bytes), threads of a block;
// bn != 0 asks for that width instead of the plan's (112, 128, 160, 224, 256).
// Returns 0, or cudaErrorInvalidValue for a width not built.
int fdt_gemm_plan(int k, int n, int bn, int* out) {
  FDT_GEMM_DISPATCH(plan, bn ? bn : plan_bn(k, n), out)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10: y [m, n] = x [m, k] . w [n, k]^T + bias [n], all bf16, contiguous,
// 16-byte aligned; k % 64 == 0, n even. bn as in fdt_gemm_plan. Returns the
// CUDA error code of the launch (0 on success).
int fdt_gemm_sm90(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, int bn,
                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK != 0 || n % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDT_GEMM_DISPATCH(launch, bn ? bn : plan_bn(k, n), x, w, bias, out, m, n, k, s)
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
