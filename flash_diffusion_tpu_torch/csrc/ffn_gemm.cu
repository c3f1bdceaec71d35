// bf16 GEMM for the feed-forward's down projection with a GEGLU prologue
// on the A operand (K12), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_diffusion_tpu/ops/gemm.py:271
// _geglu_gemm_kernel (K12, via geglu_down_proj): y[M, N] = h . w[N, K]^T +
// b[N] on h = a * gelu_tanh(g), where [a | g] are the two halves of one
// row-major [M, 2K] array (the up projection's raw output; no split copy),
// and h never goes to device memory; fp32 accumulator, the bias added in
// fp32 in the epilogue, one cast to bf16. The plain down projection (K10)
// is gemm_sm90.cu, a wgmma kernel; this one keeps the first port's
// Ampere-style design until it gets K10's core. The weight is [N, K], the
// nn.Linear layout, which is exactly the ".col" B operand of mma.sync, so
// nothing is transposed. SDXL's feed-forwards send it [16384, 2 * 2560] ->
// 640 and [4096, 2 * 5120] -> 1280 at batch 4, 1024².
//
// What bounds it on this card: 2*M*K*N operations at 989 TFLOP/s against
// (2*M*K + K*N + M*N) * 2 bytes at 3.35 TB/s: the tensor cores at the
// 1280-wide shape, the bytes (just) at [16384, 2*2560] -> 640, where a and
// g are read once. The design is the plain Ampere-style one of
// int8_gemm.cu, in bf16: a 128 x 128 output tile per block of 8 warps (2 x
// 4, 64 x 32 each), K in steps of 64, mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from shared memory, the next K step loaded
// with cp.async behind the current one (two stages).
//
// Design points:
//   - The GEGLU prologue runs once per element per block: after a stage's
//     a and g tiles land in shared memory, every thread turns 8-element
//     runs of them into h in fp32 (h = a * gelu_tanh(g), torch's tanh
//     form, with tanhf) and writes h, rounded once to bf16, over the a
//     tile; the warps then read h as the A operand. That is the port's
//     rounding contract (ops/gemm.py): the plain version rounds h at the
//     same point. Doing it on the ldmatrix fragments instead would repeat
//     every gelu on the 4 warps that share a row of the tile.
//   - Rows of M past the end load as zeros (cp.async with a zero source
//     size) and are never stored, so M may be ragged; N rows of the weight
//     likewise. K % 64 == 0 (the host checks; eligibility gives K % 128).
//   - Each output element is one block's fixed-order sum over K: no split
//     of K, so a row's bits do not depend on M (alone vs batched).
//   - Shared rows are 72 bf16 (144 bytes) apart, so the 8 row addresses of
//     one ldmatrix fall in distinct banks.
//   - The epilogue adds the bias with an explicit round-to-nearest add, as
//     the plain version does (acc + float(b)), then rounds once to bf16.

#include "mma_tiles.cuh"

namespace {

using namespace fdt;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile; K step
constexpr int kThreads = 256;                  // 8 warps: 2 along M x 4 along N
constexpr int kLD = kBK + 8;                   // shared row stride (bf16)
constexpr int kTile = kBM * kLD;               // bf16 of one 128-row tile

// Tiles of one stage: a and g, then B; 110,592 bytes in two stages, so two
// blocks fit an SM.
constexpr int kStage = 3 * kTile;
constexpr int kSmemBytes = 2 * kStage * 2;

// Rows [row0, row0 + 128) x columns [k0, k0 + 64) of a row-major bf16
// matrix of row stride ld into a shared tile; rows >= rows load zeros.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int rows,
                                          size_t ld, int k0) {
  constexpr int kChunks = kBK / 8;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * kLD + c, valid ? src + (size_t)(row0 + r) * ld + k0 + c : src, valid);
  }
}

// torch's tanh-approximated gelu, in fp32 (aten's GeluCUDAKernelImpl).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

// h = a * gelu_tanh(g) over one stage's 128 x 64 tiles, written over a.
__device__ __forceinline__ void geglu_tile(bf16* a, const bf16* g) {
  constexpr int kChunks = kBK / 8;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int at = (idx / kChunks) * kLD + (idx % kChunks) * 8;
    uint4 av = *reinterpret_cast<const uint4*>(a + at);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + at);
    __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(&av);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 af = __bfloat1622float2(ap[e]);
      const float2 gf = __bfloat1622float2(gp[e]);
      ap[e] = __floats2bfloat162_rn(__fmul_rn(af.x, gelu_tanh(gf.x)), __fmul_rn(af.y, gelu_tanh(gf.y)));
    }
    *reinterpret_cast<uint4*>(a + at) = av;
  }
}

// x: [m, 2k] (a = columns [0, k), g = [k, 2k)); w [n, k]; bias [n]; out
// [m, n]; all bf16, row-major.
__global__ void __launch_bounds__(kThreads)
geglu_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  constexpr int kB = 2 * kTile;  // offset of B in a stage
  const size_t ldx = 2 * (size_t)k;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // this warp's first row and column in the tile
  const int wn = (warp % 4) * 32;

  auto load_stage = [&](bf16* st, int k0) {
    load_tile(st, x, m0, m, ldx, k0);
    load_tile(st + kTile, x + k, m0, m, ldx, k0);
    load_tile(st + kB, w, n0, n, (size_t)k, k0);
    cp_async_commit();
  };

  float acc[4][4][4];  // [m-tile of 16][n-tile of 8][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int n_steps = k / kBK;
  load_stage(tiles, 0);
  for (int step = 0; step < n_steps; ++step) {
    bf16* as = tiles + (step & 1) * kStage;
    const bf16* bs = as + kB;
    if (step + 1 < n_steps) {
      load_stage(tiles + ((step + 1) & 1) * kStage, (step + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    geglu_tile(as, as + kTile);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], as + (wm + mt * 16 + lane % 16) * kLD + kk + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // one ldmatrix: two n-tiles x both k halves
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + np * 16 + (lane / 16) * 8 + lane % 8) * kLD + kk +
                           ((lane / 8) % 2) * 8);
        b[2 * np][0] = r[0], b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: element e of a fragment sits at row lane/4 (+8 for e >= 2),
  // column 2*(lane%4) + (e&1); n is even (the host checks)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * (lane % 4);
    if (col >= n) continue;
    const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + lane / 4 + half * 8;
        if (row >= m) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) = __floats2bfloat162_rn(
            __fadd_rn(acc[mt][nt][2 * half], bf.x), __fadd_rn(acc[mt][nt][2 * half + 1], bf.y));
      }
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(geglu_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  geglu_gemm_kernel<<<grid, kThreads, kSmemBytes, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                                           static_cast<const bf16*>(bias), static_cast<bf16*>(out), m,
                                                           n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K12: y [m, n] = (a * gelu_tanh(g)) . w [n, k]^T + bias [n] with x = [a | g]
// of shape [m, 2k]. All bf16, contiguous, 16-byte aligned; k % 64 == 0, n
// even. Returns the CUDA error code of the launch (0 on success).
int fdt_geglu_gemm(const void* x, const void* w, const void* bias, void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK != 0 || n % 2 != 0 || m > 65535 * kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, bias, out, m, n, k, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
