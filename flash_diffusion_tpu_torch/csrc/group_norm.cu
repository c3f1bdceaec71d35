// GroupNorm for Hopper (sm_90a): the per-channel statistics (K9), the fold
// into a per-channel scale and shift, and the normalize pass, in one launch
// where a group fits a thread block cluster's shared memory, else in two.
// Every kernel takes the two layouts the port's activations come in: NCHW,
// and channels-last NHWC (what cuDNN's convolutions hand on when their
// input is a permuted NHWC tensor, as the UNet's and the VAE's inputs are).
//
// Statistics: replaces the Pallas TPU kernel flash_diffusion_tpu/ops/norms.py
// _gn_stats_kernel (via _gn_stats_pallas): per (batch, channel) fp32 sums
// Σx and Σx² over the spatial extent. The fold and the normalize pass are
// what JAX leaves to XLA (norms.py _gn_fold_stats, then x·w + shift, SiLU):
// per group the sum of its channel sums in channel order, mean, var =
// max(E[x²] − mean², 0), inv = rsqrt(var + eps), then per channel w =
// inv·weight and shift = bias − mean·inv·weight, each rounded to x's dtype,
// and y = x·w + shift (+ SiLU), rounding where the plain PyTorch version
// rounds: x·w to x's dtype, then + shift, then SiLU x / (1 + exp(-x)) in
// fp32 with one rounding.
//
// What bounds it on this card: memory. The whole op must read x once and
// write y once; its arithmetic is a few operations an element. Two plans
// (ops/norms.py group_norm_plan, by N, C, G, the layout and the dtype, never
// by B):
//
// (a) Resident (gn_resident_*_kernel), where a block's share of a slice
//     fits 100 KB: one cluster of 1-8 blocks per (sample, group-aligned
//     channel slice) loads the slice once into its blocks' shared memory by
//     TMA (NHWC: 3-D tensor-map boxes of the slice's channels, rows of whole
//     32-byte sectors so that no two clusters share one, by up to 256 rows,
//     the rows split over the cluster's blocks; NCHW: one bulk copy of each
//     block's whole channel rows, the group's channels split over the
//     blocks). Each block sums its part per channel in a fixed order (lanes,
//     a fixed shuffle chain or xor tree, then the warps in order); the
//     blocks add each other's sums through distributed shared memory in
//     rank order, fold, and apply from shared memory. One read, one write,
//     one launch, and no co-residency across clusters, so any B.
// (b) Streaming, where a slice does not fit (SDXL's 128² UNet level, the
//     VAE's larger levels): the statistics kernel (gn_stats_*_kernel) sums
//     NCHW rows a block each, and NHWC samples in fixed parts of rows (a
//     function of N and the layout) whose partials the last block of each
//     column tile adds; the last block of a sample folds. Arrival counters
//     pick those blocks; they decide who adds, never the order of a sum.
//     Then the apply kernel (gn_apply_*_kernel) reads x again: NCHW rows
//     with their scale and shift loaded once a thread, NHWC threads on fixed
//     channels with their scale and shift loaded once as 16-byte vectors and
//     rows walked by multiplication, with no divide per pack.
//
// The statistics kernel alone (fold off) is group_norm_stats, K9's own
// entry: the channel sums. No atomics touch a sum: a sample's bits depend
// only on its own values, N, C, G, the layout and the dtype, alone or in any
// batch, at any slot and from run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // independent 16-byte loads a thread keeps in flight (apply)
constexpr int kBatch = 8;   // partials a thread of the last block loads at once
constexpr int kResThreads = 512, kResWarps = kResThreads / 32;  // a resident block
constexpr int kSmemLimit = 232448;

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T and back: the rounding of one PyTorch op in T's dtype
template <typename T> __device__ inline float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// weight or bias [C], bf16 or fp32
__device__ inline float param(const void* p, int i, bool bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// kV elements of T (16 bytes when VEC, else one)
template <typename T, bool VEC>
__device__ inline void load_pack(T* v, const T* p) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
    v[0] = p[0];
  }
}
template <typename T, bool VEC>
__device__ inline void store_pack(T* p, const T* v) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
    p[0] = v[0];
  }
}

// ---- the fold (the plain _gn_fold_stats, with its roundings explicit)

// The sums of a group's cg channel sums, in channel order from its first:
// the fold's fixed order (ops/norms.py group_norm_fold_reference).
__device__ inline float2 group_sums(const float* s, const float* q, int first, int cg) {
  float a = 0.0f, b = 0.0f;
  for (int j = 0; j < cg; ++j) {
    const int ch = first + j;
    a += s[ch];
    b += q[ch];
  }
  return make_float2(a, b);
}

struct GroupStats {
  float mean, inv;
};
__device__ inline GroupStats fold_group(float2 sums, float count, float eps) {
  const float mean = __fdiv_rn(sums.x, count);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(sums.y, count), __fmul_rn(mean, mean)), 0.0f);
  return {mean, rsqrtf(__fadd_rn(var, eps))};
}
// w = inv·weight, shift = bias − (mean·inv)·weight, each rounded to T
template <typename T>
__device__ inline float2 fold_channel(GroupStats st, float wc, float bc) {
  return make_float2(round_to<T>(__fmul_rn(st.inv, wc)),
                     round_to<T>(__fsub_rn(bc, __fmul_rn(__fmul_rn(st.mean, st.inv), wc))));
}
// y of one element: x·w, then + shift, each rounded to T, then the SiLU
template <typename T, bool SILU>
__device__ inline T gn_out(float x, float w, float shift) {
  float u = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, w)), shift));
  if constexpr (SILU) u = __fdiv_rn(u, 1.0f + expf(-u));
  return from_f<T>(u);
}

// ---- plan (b): the statistics kernel, with the fold in its last block

struct StatsArgs {
  const void* x;
  float* psum;             // NHWC: [B, C, parts] partial Σx
  float* psq;              // NHWC: [B, C, parts] partial Σx²
  unsigned* counter;       // NHWC: [B, tiles] arrivals of a column tile's parts, then [B] of a sample's
                           // blocks; 0 between launches
  float* sum;              // [B, C] Σx
  float* sumsq;            // [B, C] Σx²
  const void* weight;      // fold = 1: [C]
  const void* bias;        // fold = 1: [C]
  void* w_out;             // fold = 1: [B, C] scale in x's dtype
  void* shift_out;         // fold = 1: [B, C] shift in x's dtype
  float* mean_out;         // fold = 1: [B, G]
  float* inv_out;          // fold = 1: [B, G]
  int c, n, g, chunk, parts, w_bf16, fold;
  float eps;
};

// Whether this block is the last of `arrivals` to pass *counter (which it
// then resets to 0 for the next launch on this stream); the counter decides
// who goes on, never the order of a sum. Every thread's global writes before
// it are visible to the last block after it.
__device__ inline bool last_to_arrive(unsigned* counter, int arrivals) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == static_cast<unsigned>(arrivals - 1);
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The fold of sample b from its channel sums (sum, sumsq): per group the
// sums of its channel sums, mean and inv, then per channel the scale and
// shift. Dynamic shared memory: 2C + 2G floats.
template <typename T>
__device__ void fold_sample(const StatsArgs& a, int b) {
  extern __shared__ float fold_smem[];
  float *cs = fold_smem, *cq = fold_smem + a.c, *gm = fold_smem + 2 * a.c, *gv = gm + a.g;
  for (int ch = threadIdx.x; ch < a.c; ch += blockDim.x) {
    cs[ch] = __ldcg(a.sum + (long long)b * a.c + ch);
    cq[ch] = __ldcg(a.sumsq + (long long)b * a.c + ch);
  }
  __syncthreads();
  const int cg = a.c / a.g;
  const float count = static_cast<float>((long long)a.n * cg);
  for (int gi = threadIdx.x; gi < a.g; gi += blockDim.x) {
    const GroupStats st = fold_group(group_sums(cs, cq, gi * cg, cg), count, a.eps);
    gm[gi] = st.mean;
    gv[gi] = st.inv;
    a.mean_out[(long long)b * a.g + gi] = st.mean;
    a.inv_out[(long long)b * a.g + gi] = st.inv;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < a.c; ch += blockDim.x) {
    const float2 f = fold_channel<T>({gm[ch / cg], gv[ch / cg]}, param(a.weight, ch, a.w_bf16),
                                     param(a.bias, ch, a.w_bf16));
    static_cast<T*>(a.w_out)[(long long)b * a.c + ch] = from_f<T>(f.x);
    static_cast<T*>(a.shift_out)[(long long)b * a.c + ch] = from_f<T>(f.y);
  }
}

// NCHW: grid (C, B); block (channel, b) sums its channel's row of n: warp w
// takes elements [w·chunk, min(n, (w+1)·chunk)) (chunk = ceil(n / 8) in
// whole packs), lane-strided, then the xor tree, then the warps in order.
// VEC: 16-byte loads (n·sizeof(T) a multiple of 16, x 16-byte aligned). With
// fold, the last block of a sample folds.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) gn_stats_nchw_kernel(StatsArgs a) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  __shared__ float red[2][kWarps];
  const int ch = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int begin = warp * a.chunk, end = min(a.n, begin + a.chunk);
  const T* xr = static_cast<const T*>(a.x) + ((long long)b * a.c + ch) * a.n;
  float s = 0.0f, ss = 0.0f;
#pragma unroll 4
  for (int i = begin + lane * kV; i < end; i += 32 * kV) {
    alignas(16) T v[kV];
    load_pack<T, VEC>(v, xr + i);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float f = to_f(v[j]);
      s += f;
      ss += f * f;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tq = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ts += red[0][w];
      tq += red[1][w];
    }
    a.sum[(long long)b * a.c + ch] = ts;
    a.sumsq[(long long)b * a.c + ch] = tq;
  }
  if (a.fold && last_to_arrive(a.counter + b, gridDim.x)) fold_sample<T>(a, b);
}

// NHWC: grid (tiles = ceil(C / 8kV), parts, B); block (tile, part, b) sums
// rows [part·chunk, min(n, (part+1)·chunk)) of sample b's [n, C] matrix for
// 8·kV channels: thread (row lane r, column thread j) takes rows r, r + 32,
// ... and channels [(tile·8 + j)·kV, +kV); the 32 row lanes then add in a
// fixed tree, into partials [B, C, parts]. The last block of a (tile, b) to
// arrive adds the tile's partials: thread (quarter qi, channel) the parts
// qi, qi + Q, ... in order, then the quarters in order. With fold, the last
// tile of a sample folds. VEC: 16-byte loads (C·sizeof(T) a multiple of 16).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) gn_stats_nhwc_kernel(StatsArgs a) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  constexpr int kCols = 8, kLanes = kThreads / kCols, kTile = kCols * kV, kQuarters = kThreads / kTile;
  __shared__ float sh_s[kLanes][kTile], sh_q[kLanes][kTile];
  const int col = threadIdx.x % kCols, lane = threadIdx.x / kCols;
  const int b = blockIdx.z, part = blockIdx.y, tile = blockIdx.x;
  const int c0 = (tile * kCols + col) * kV;
  const int r1 = min(a.n, (part + 1) * a.chunk);
  float s[kV], ss[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) s[j] = ss[j] = 0.0f;
  if (c0 < a.c) {
    const T* xb = static_cast<const T*>(a.x) + (long long)b * a.n * a.c + c0;
#pragma unroll 4
    for (int r = part * a.chunk + lane; r < r1; r += kLanes) {
      alignas(16) T v[kV];
      load_pack<T, VEC>(v, xb + (long long)r * a.c);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(v[j]);
        s[j] += f;
        ss[j] += f * f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sh_s[lane][col * kV + j] = s[j];
    sh_q[lane][col * kV + j] = ss[j];
  }
  __syncthreads();
  for (int stride = kLanes / 2; stride > 0; stride >>= 1) {
    if (lane < stride) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        sh_s[lane][col * kV + j] += sh_s[lane + stride][col * kV + j];
        sh_q[lane][col * kV + j] += sh_q[lane + stride][col * kV + j];
      }
    }
    __syncthreads();
  }
  if (lane == 0 && c0 < a.c) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (c0 + j < a.c) {
        const long long at = ((long long)b * a.c + c0 + j) * a.parts + part;
        a.psum[at] = sh_s[0][col * kV + j];
        a.psq[at] = sh_q[0][col * kV + j];
      }
    }
  }
  const int tiles = gridDim.x;
  if (!last_to_arrive(a.counter + (long long)b * tiles + tile, a.parts)) return;
  // the tile's channel sums from their partials
  const int ch = tile * kTile + threadIdx.x % kTile, qi = threadIdx.x / kTile;
  float ts = 0.0f, tq = 0.0f;
  if (ch < a.c) {
    const long long at = ((long long)b * a.c + ch) * a.parts;
    for (int p0 = qi; p0 < a.parts; p0 += kBatch * kQuarters) {  // kBatch loads in flight, added in part order
      float ps[kBatch], pq[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int p = p0 + k * kQuarters;
        ps[k] = p < a.parts ? __ldcg(a.psum + at + p) : 0.0f;
        pq[k] = p < a.parts ? __ldcg(a.psq + at + p) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (p0 + k * kQuarters < a.parts) {
          ts += ps[k];
          tq += pq[k];
        }
      }
    }
  }
  __syncthreads();  // the tree's last reads of sh_s, sh_q are done
  sh_s[qi][threadIdx.x % kTile] = ts;
  sh_q[qi][threadIdx.x % kTile] = tq;
  __syncthreads();
  if (threadIdx.x < kTile && ch < a.c) {
    float cs = 0.0f, cq = 0.0f;
    for (int k = 0; k < kQuarters; ++k) {
      cs += sh_s[k][threadIdx.x];
      cq += sh_q[k][threadIdx.x];
    }
    a.sum[(long long)b * a.c + ch] = cs;
    a.sumsq[(long long)b * a.c + ch] = cq;
  }
  if (a.fold && last_to_arrive(a.counter + (long long)gridDim.z * tiles + b, tiles)) fold_sample<T>(a, b);
}

// ---- plan (b): the apply kernels

// NCHW: grid (ceil(B·C / (256 / tpr)), ceil(packs / (tpr·kUnroll))); `tpr`
// threads (a power of two up to 256) a (b, c) row of the [B·C, n] rows, 256
// / tpr rows a block, each row's scale and shift loaded once a thread.
template <typename T, bool VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_nchw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ shift,
                     T* __restrict__ y, int n, int rows, int tpr) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const long long row = (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const float wr = to_f(w[row]), sr = to_f(shift[row]);
  const int packs = n / kV;
  const T* xr = x + row * n;
  T* yr = y + row * n;
  const int p0 = blockIdx.y * (tpr * kUnroll) + threadIdx.x % tpr;
  alignas(16) T v[kUnroll][kV];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = p0 + u * tpr;
    if (p < packs) load_pack<T, VEC>(v[u], xr + (long long)p * kV);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = p0 + u * tpr;
    if (p < packs) {
#pragma unroll
      for (int j = 0; j < kV; ++j) v[u][j] = gn_out<T, SILU>(to_f(v[u][j]), wr, sr);
      store_pack<T, VEC>(yr + (long long)p * kV, v[u]);
    }
  }
}

// NHWC: grid (ceil(n / rows), B); block (row segment, b) of sample b's
// [n, C] matrix: thread (tx, ty) of tx_n = min(C / kV, 256) by 256 / tx_n
// takes channel packs tx, tx + tx_n, ..., each with its scale and shift in
// registers, over rows ty, ty + ty_n, ... of the segment.
template <typename T, bool VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ shift,
                     T* __restrict__ y, int n, int c, int rows) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const int cpacks = c / kV;
  const int tx_n = min(cpacks, kThreads), ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  if (ty >= ty_n) return;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  const long long base = (long long)b * n * c;
  for (int cp = tx; cp < cpacks; cp += tx_n) {
    alignas(16) T wp[kV], sp[kV];
    load_pack<T, VEC>(wp, w + (long long)b * c + cp * kV);
    load_pack<T, VEC>(sp, shift + (long long)b * c + cp * kV);
    float wf[kV], sf[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      wf[j] = to_f(wp[j]);
      sf[j] = to_f(sp[j]);
    }
    const T* xc = x + base + cp * kV;
    T* yc = y + base + cp * kV;
    for (int r = r0 + ty; r < r1; r += ty_n * kUnroll) {
      alignas(16) T v[kUnroll][kV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ru = r + u * ty_n;
        if (ru < r1) load_pack<T, VEC>(v[u], xc + (long long)ru * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ru = r + u * ty_n;
        if (ru < r1) {
#pragma unroll
          for (int j = 0; j < kV; ++j) v[u][j] = gn_out<T, SILU>(to_f(v[u][j]), wf[j], sf[j]);
          store_pack<T, VEC>(yc + (long long)ru * c, v[u]);
        }
      }
    }
  }
}

// ---- plan (a): the resident kernels

struct ResidentArgs {
  const void* x;           // NCHW: the input (the bulk copies' source)
  void* y;
  const void* weight;      // [C]
  const void* bias;        // [C]
  float* mean_out;         // [B, G]
  float* inv_out;          // [B, G]
  int c, n, g;
  int cs;                  // NHWC: channels of a slice (whole groups, 16-byte rows); NCHW: channels of a block
  int rows;                // NHWC: rows a block takes
  int box_rows, boxes;     // NHWC: the TMA boxes of a block's rows (set by the launcher)
  int cluster, w_bf16;
  float eps;
};

__device__ inline float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ inline void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }
__device__ inline void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          fdt::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(fdt::smem_addr(bar))
      : "memory");
}
__device__ inline void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   fdt::smem_addr(dst)),
               "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes), "r"(fdt::smem_addr(bar))
               : "memory");
}

// Shared memory of a resident block, in bytes past its 128-byte aligned
// base. NHWC: the data [boxes·box_rows, cs], the warps' sums [warps, cs]
// twice, the block's sums (which the peers read), the cluster's, the scale
// and the shift [cs] each, the groups' mean and inv, one mbarrier a box.
// NCHW: the data [cs, n], the warps' sums [warps] twice, the block's sums
// [cs] twice, the group's channel sums [C/G] twice, the scale and shift
// [cs], mean and inv, one mbarrier.
struct ResidentLayout {
  int red, part, tot, wsh, gst, bar, total;
  __host__ __device__ ResidentLayout(bool nhwc, int cs, int cg, int rows, int boxes, int elem, int groups) {
    const int data = cs * rows * elem;  // NHWC: rows = boxes·box_rows; NCHW: rows = n
    red = data;
    part = red + 2 * (nhwc ? kResWarps * cs : kResWarps) * 4;
    tot = part + 2 * cs * 4;
    wsh = tot + 2 * (nhwc ? cs : cg) * 4;
    gst = wsh + 2 * cs * 4;
    bar = (gst + 2 * groups * 4 + 7) / 8 * 8;
    total = bar + 8 * (nhwc ? boxes : 1) + 128;  // + the base's alignment slack
  }
};

// NHWC: grid (cluster, B·C / cs), clusters of `cluster` blocks along x.
// Block (rank, b·slices + slice) takes rows [rank·rows, min(n, +rows)) of
// channels [slice·cs, +cs) of sample b: TMA boxes of cs channels by
// box_rows rows land in shared memory, each on its own mbarrier (rows past
// n as zeros, never read). Lane l of a warp takes channels [(l % cols)·kV,
// +kV) (cols = cs / kV) of sub-row l / cols of the warp's rows (32 / cols
// rows at a time; the last lanes idle where cols does not divide 32), so
// that the sums start on a box as it lands; a warp's sub-rows add in a fixed
// shuffle chain, the warps in warp order.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kResThreads, 2)
gn_resident_nhwc_kernel(const __grid_constant__ CUtensorMap map, ResidentArgs a) {
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ unsigned char gn_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(gn_smem_raw) + 127) & ~uintptr_t(127));
  const int cg = a.c / a.g, groups = a.cs / cg;
  const ResidentLayout lay(true, a.cs, cg, a.boxes * a.box_rows, a.boxes, sizeof(T), groups);
  T* data = reinterpret_cast<T*>(base);
  float* red_s = reinterpret_cast<float*>(base + lay.red);  // [warps][cs]
  float* red_q = red_s + kResWarps * a.cs;
  float* part_s = reinterpret_cast<float*>(base + lay.part);
  float* part_q = part_s + a.cs;
  float* tot_s = reinterpret_cast<float*>(base + lay.tot);
  float* tot_q = tot_s + a.cs;
  float* wsh = reinterpret_cast<float*>(base + lay.wsh);
  float* ssh = wsh + a.cs;
  float* gst = reinterpret_cast<float*>(base + lay.gst);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + lay.bar);

  const int rank = static_cast<int>(fdt::cluster_ctarank());
  const int slices = a.c / a.cs;
  const int b = blockIdx.y / slices, c0 = blockIdx.y % slices * a.cs;
  const int r0 = rank * a.rows;
  const int rows = min(a.rows, a.n - r0);
  const int boxes = (rows + a.box_rows - 1) / a.box_rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cols = a.cs / kV, rpw = 32 / cols;
  const int col = lane % cols, sub = lane / cols;
  const bool active = sub < rpw;
  const int first = warp * rpw + sub, step = kResWarps * rpw;
  if (threadIdx.x == 0) {
    for (int i = 0; i < boxes; ++i) fdt::mbar_init(&bars[i], 1);
    fdt::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < boxes; ++i) {
      fdt::mbar_expect(&bars[i], a.box_rows * a.cs * static_cast<int>(sizeof(T)));
      tma_3d(data + i * a.box_rows * a.cs, &map, c0, r0 + i * a.box_rows, b, &bars[i]);
    }
  }

  // this block's channel sums
  float s[kV], q[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) s[j] = q[j] = 0.0f;
  int landed = 0;  // boxes this thread has waited for
  if (active) {
    for (int r = first; r < rows; r += step) {
      while (landed <= r / a.box_rows) fdt::mbar_wait(&bars[landed++], 0);
      alignas(16) T v[kV];
      load_pack<T, true>(v, data + r * a.cs + col * kV);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(v[j]);
        s[j] += f;
        q[j] += f * f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {  // the warp's sub-rows, in order
    float ts = s[j], tq = q[j];
    for (int k = 1; k < rpw; ++k) {
      const float os = __shfl_sync(0xffffffffu, s[j], col + k * cols);
      const float oq = __shfl_sync(0xffffffffu, q[j], col + k * cols);
      ts += os;
      tq += oq;
    }
    if (sub == 0) {
      red_s[warp * a.cs + col * kV + j] = ts;
      red_q[warp * a.cs + col * kV + j] = tq;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < a.cs; ch += kResThreads) {  // the warps, in order
    float ts = 0.0f, tq = 0.0f;
    for (int w = 0; w < kResWarps; ++w) {
      ts += red_s[w * a.cs + ch];
      tq += red_q[w * a.cs + ch];
    }
    part_s[ch] = ts;
    part_q[ch] = tq;
  }
  fdt::cluster_sync();  // every block's sums are in place

  // the cluster's channel sums: every (rank, channel) read at once into the
  // warps' rows, then added in rank order; then the fold
  for (int t = threadIdx.x; t < a.cluster * a.cs; t += kResThreads) {
    red_s[t] = ld_cluster_f32(fdt::peer_addr(&part_s[t % a.cs], t / a.cs));
    red_q[t] = ld_cluster_f32(fdt::peer_addr(&part_q[t % a.cs], t / a.cs));
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < a.cs; ch += kResThreads) {
    float ts = 0.0f, tq = 0.0f;
    for (int r = 0; r < a.cluster; ++r) {
      ts += red_s[r * a.cs + ch];
      tq += red_q[r * a.cs + ch];
    }
    tot_s[ch] = ts;
    tot_q[ch] = tq;
  }
  __syncthreads();
  const float count = static_cast<float>((long long)a.n * cg);
  for (int gi = threadIdx.x; gi < groups; gi += kResThreads) {
    const GroupStats st = fold_group(group_sums(tot_s, tot_q, gi * cg, cg), count, a.eps);
    gst[gi] = st.mean;
    gst[groups + gi] = st.inv;
    if (rank == 0) {
      a.mean_out[(long long)b * a.g + c0 / cg + gi] = st.mean;
      a.inv_out[(long long)b * a.g + c0 / cg + gi] = st.inv;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < a.cs; ch += kResThreads) {
    const int gi = ch / cg;
    const float2 f = fold_channel<T>({gst[gi], gst[groups + gi]}, param(a.weight, c0 + ch, a.w_bf16),
                                     param(a.bias, c0 + ch, a.w_bf16));
    wsh[ch] = f.x;
    ssh[ch] = f.y;
  }
  cluster_arrive();  // this block is done with its peers' shared memory
  __syncthreads();

  // the apply, from shared memory, two rows in flight
  if (active) {
    float wf[kV], sf[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      wf[j] = wsh[col * kV + j];
      sf[j] = ssh[col * kV + j];
    }
    T* yb = static_cast<T*>(a.y) + ((long long)b * a.n + r0) * a.c + c0 + col * kV;
    for (int r = first; r < rows; r += 2 * step) {
      alignas(16) T v[2][kV];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (r + u * step < rows) load_pack<T, true>(v[u], data + (r + u * step) * a.cs + col * kV);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (r + u * step < rows) {
#pragma unroll
          for (int j = 0; j < kV; ++j) v[u][j] = gn_out<T, SILU>(to_f(v[u][j]), wf[j], sf[j]);
          store_pack<T, true>(yb + (long long)(r + u * step) * a.c, v[u]);
        }
      }
    }
  }
  cluster_wait();  // no block leaves while a peer may still read its sums
}

// NCHW: grid (cluster, B·G), clusters of `cluster` blocks along x. Block
// (rank, b·G + group) takes channels [rank·cs, +cs) of the group (cs = C/G
// / cluster), whole rows of n, by one bulk copy. The channel sums: warps
// split the block's channels (wpc warps a channel where the warps outnumber
// them, each on every wpc-th 32 packs; lanes, the xor tree, then the warps
// in order); the group's channel sums come from their blocks through
// distributed shared memory. The apply walks the block's packs with every
// thread.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kResThreads, 2) gn_resident_nchw_kernel(ResidentArgs a) {
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ unsigned char gn_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(gn_smem_raw) + 127) & ~uintptr_t(127));
  const int cg = a.c / a.g;
  const ResidentLayout lay(false, a.cs, cg, a.n, 1, sizeof(T), 1);
  T* data = reinterpret_cast<T*>(base);
  float* red_s = reinterpret_cast<float*>(base + lay.red);  // [warps]
  float* red_q = red_s + kResWarps;
  float* part_s = reinterpret_cast<float*>(base + lay.part);
  float* part_q = part_s + a.cs;
  float* tot_s = reinterpret_cast<float*>(base + lay.tot);  // [cg]
  float* tot_q = tot_s + cg;
  float* wsh = reinterpret_cast<float*>(base + lay.wsh);
  float* ssh = wsh + a.cs;
  float* gst = reinterpret_cast<float*>(base + lay.gst);  // mean, inv
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + lay.bar);

  const int rank = static_cast<int>(fdt::cluster_ctarank());
  const int b = blockIdx.y / a.g, gi = blockIdx.y % a.g;
  const int ch0 = gi * cg + rank * a.cs;  // this block's first channel
  const long long at = ((long long)b * a.c + ch0) * a.n;
  if (threadIdx.x == 0) {
    fdt::mbar_init(bar, 1);
    fdt::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int bytes = a.cs * a.n * static_cast<int>(sizeof(T));
    fdt::mbar_expect(bar, bytes);
    bulk_load(data, static_cast<const T*>(a.x) + at, bytes, bar);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ppr = a.n / kV;  // packs a row
  const int wpc = a.cs >= kResWarps ? 1 : kResWarps / a.cs;
  fdt::mbar_wait(bar, 0);
  for (int ch = warp / wpc; ch < a.cs && warp < a.cs * wpc; ch += kResWarps / wpc) {
    float s = 0.0f, q = 0.0f;
    for (int p = warp % wpc * 32 + lane; p < ppr; p += wpc * 32) {
      alignas(16) T v[kV];
      load_pack<T, true>(v, data + (long long)ch * a.n + p * kV);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(v[j]);
        s += f;
        q += f * f;
      }
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0 && wpc == 1) {
      part_s[ch] = s;
      part_q[ch] = q;
    } else if (lane == 0) {
      red_s[warp] = s;
      red_q[warp] = q;
    }
  }
  if (wpc > 1) {
    __syncthreads();
    for (int ch = threadIdx.x; ch < a.cs; ch += kResThreads) {  // the channel's warps, in order
      float s = 0.0f, q = 0.0f;
      for (int k = 0; k < wpc; ++k) {
        s += red_s[ch * wpc + k];
        q += red_q[ch * wpc + k];
      }
      part_s[ch] = s;
      part_q[ch] = q;
    }
  }
  fdt::cluster_sync();
  for (int j = threadIdx.x; j < cg; j += kResThreads) {
    tot_s[j] = ld_cluster_f32(fdt::peer_addr(&part_s[j % a.cs], j / a.cs));
    tot_q[j] = ld_cluster_f32(fdt::peer_addr(&part_q[j % a.cs], j / a.cs));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const GroupStats st = fold_group(group_sums(tot_s, tot_q, 0, cg), static_cast<float>((long long)a.n * cg),
                                     a.eps);
    gst[0] = st.mean;
    gst[1] = st.inv;
    if (rank == 0) {
      a.mean_out[blockIdx.y] = st.mean;
      a.inv_out[blockIdx.y] = st.inv;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < a.cs; ch += kResThreads) {
    const float2 f = fold_channel<T>({gst[0], gst[1]}, param(a.weight, ch0 + ch, a.w_bf16),
                                     param(a.bias, ch0 + ch, a.w_bf16));
    wsh[ch] = f.x;
    ssh[ch] = f.y;
  }
  cluster_arrive();
  __syncthreads();
  T* yb = static_cast<T*>(a.y) + at;
  const int total = a.cs * ppr;
  for (int i = threadIdx.x; i < total; i += 2 * kResThreads) {  // two packs in flight
    alignas(16) T v[2][kV];
    int ch[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = i + u * kResThreads;
      ch[u] = k / ppr;
      if (k < total) load_pack<T, true>(v[u], data + (long long)k * kV);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = i + u * kResThreads;
      if (k < total) {
#pragma unroll
        for (int j = 0; j < kV; ++j) v[u][j] = gn_out<T, SILU>(to_f(v[u][j]), wsh[ch[u]], ssh[ch[u]]);
        store_pack<T, true>(yb + (long long)k * kV, v[u]);
      }
    }
  }
  cluster_wait();
}

// ---- host side

// A 3-D map {C, n, B} of an NHWC tensor, in boxes of cs channels by
// box_rows rows of one sample, no swizzle (the box lands as [box_rows, cs]).
bool make_nhwc_map(CUtensorMap* map, const void* x, int batch, int n, int c, int cs, int box_rows, bool bf) {
  fdt::EncodeTiled encode = fdt::encode_tiled();
  if (encode == nullptr) return false;
  const int elem = bf ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * elem, (cuuint64_t)n * c * elem};
  const cuuint32_t box[3] = {(cuuint32_t)cs, (cuuint32_t)box_rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x),
                dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, dim3 grid, int cluster, int smem, cudaStream_t stream, Args... args) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SILU>
int resident(ResidentArgs a, int batch, bool nhwc, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (a.cluster < 1 || a.cluster > 8 || a.c % a.g != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = a.c / a.g;
  if (nhwc) {
    // the slice: whole groups in rows of whole 32-byte sectors, at most 32
    // 16-byte packs; the rows
    // of a block in boxes of at most 256 rows, a multiple of 8 (128-byte
    // aligned box slots)
    if (a.cs % cg != 0 || a.cs % (2 * kV) != 0 || a.c % a.cs != 0 || a.cs / kV > 32 || a.cs > 256 ||
        (long long)(a.cluster - 1) * a.rows >= a.n)
      return static_cast<int>(cudaErrorInvalidValue);
    a.boxes = (a.rows + 255) / 256;
    a.box_rows = ((a.rows + a.boxes - 1) / a.boxes + 7) / 8 * 8;
    const ResidentLayout lay(true, a.cs, cg, a.boxes * a.box_rows, a.boxes, sizeof(T), a.cs / cg);
    CUtensorMap map;
    if (!make_nhwc_map(&map, a.x, batch, a.n, a.c, a.cs, a.box_rows, sizeof(T) == 2))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(gn_resident_nhwc_kernel<T, SILU>, dim3(a.cluster, batch * (a.c / a.cs)), a.cluster,
                          lay.total, stream, map, a);
  }
  // NCHW: the group's channels split over the cluster, whole rows each
  if (cg % a.cluster != 0 || a.cs != cg / a.cluster || a.n % kV != 0 ||
      (long long)a.cs * a.n * sizeof(T) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const ResidentLayout lay(false, a.cs, cg, a.n, 1, sizeof(T), 1);
  return launch_cluster(gn_resident_nchw_kernel<T, SILU>, dim3(a.cluster, batch * a.g), a.cluster, lay.total, stream,
                        a);
}

template <typename T, bool VEC>
int stats(StatsArgs a, int batch, bool nhwc, cudaStream_t stream) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  a.parts = nhwc ? (a.n + a.chunk - 1) / a.chunk : 1;
  const int smem = a.fold ? (2 * a.c + 2 * a.g) * 4 : 0;
  void (*kernel)(StatsArgs) = nhwc ? gn_stats_nhwc_kernel<T, VEC> : gn_stats_nchw_kernel<T, VEC>;
  if (smem > 32768) {  // the fold of a wide C
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nhwc) {
    kernel<<<dim3((a.c + 8 * kV - 1) / (8 * kV), a.parts, batch), kThreads, smem, stream>>>(a);
  } else {
    if (a.chunk % 8 != 0 || (long long)kWarps * a.chunk < a.n) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<dim3(a.c, batch), kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, bool SILU>
void apply_launch(const void* x, const void* w, const void* b, void* y, int batch, int c, int n, bool nhwc,
                  cudaStream_t stream) {
  constexpr int kV = VEC ? 16 / sizeof(T) : 1;
  const T *xp = static_cast<const T*>(x), *wp = static_cast<const T*>(w), *bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (nhwc) {
    // rows a block: at most about 64 KB of x, fewer where that would leave
    // the card under 8 blocks an SM; at least the rows its threads span
    const int sms = fdt::sm_count();
    const long long fill = ((long long)n * batch + 8LL * sms - 1) / (8LL * sms);
    const int rows = std::max<long long>(kThreads / std::min(c / kV, kThreads),
                                         std::min<long long>(65536 / (c * (int)sizeof(T)), fill));
    gn_apply_nhwc_kernel<T, VEC, SILU><<<dim3((n + rows - 1) / rows, batch), kThreads, 0, stream>>>(
        xp, wp, bp, yp, n, c, rows);
  } else {
    const int packs = n / kV;
    int tpr = kThreads;  // threads a row: the least power of two holding its packs kUnroll a thread
    while (tpr > 1 && (tpr / 2) * kUnroll >= packs) tpr /= 2;
    const int rows = batch * c, per_block = kThreads / tpr;
    gn_apply_nchw_kernel<T, VEC, SILU><<<dim3((rows + per_block - 1) / per_block,
                                              (packs + tpr * kUnroll - 1) / (tpr * kUnroll)),
                                         kThreads, 0, stream>>>(xp, wp, bp, yp, n, rows, tpr);
  }
}

template <typename T, bool VEC>
int apply(const void* x, const void* w, const void* b, void* y, int batch, int c, int n, bool silu, bool nhwc,
          cudaStream_t stream) {
  if (silu) {
    apply_launch<T, VEC, true>(x, w, b, y, batch, c, n, nhwc, stream);
  } else {
    apply_launch<T, VEC, false>(x, w, b, y, batch, c, n, nhwc, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plan (b)'s first launch, or K9's own entry. x: [batch, c, n] contiguous
// (nhwc = 0) or [batch, n, c] (nhwc = 1: a channels-last tensor), bf16
// (x_bf16 = 1) or fp32. chunk (ops/norms.py gn_stream_plan): NCHW, the
// elements of a row each of its block's 8 warps sums (a multiple of 8, 8
// chunks covering n); NHWC, the rows of a part. psum, psq (NHWC): [batch·c·
// ceil(n / chunk)] fp32 scratch. counter: [batch·(tiles + 1)] unsigned
// (tiles = ceil(c / (8·16 / element size)) for NHWC with vec, c / 8 without;
// 0 for NCHW), zero, and zero again after the launch. Writes the channel
// sums sum, sumsq [batch, c]; fold = 1 also the scale and shift w_out,
// shift_out [batch, c] in x's dtype and the groups' mean_out, inv_out
// [batch, g] fp32, from weight and bias [c] (bf16 when w_bf16 = 1, else
// fp32) and eps. vec = 1 takes 16-byte loads: only when x is 16-byte aligned
// and the contiguous extent (n for NCHW, c for NHWC) times the element size
// is a multiple of 16. Returns the CUDA error code of the launch (0 on
// success).
int fdt_group_norm_stats(const void* x, void* sum, void* sumsq, const void* weight, const void* bias, void* w_out,
                         void* shift_out, void* mean_out, void* inv_out, void* psum, void* psq, void* counter,
                         int batch, int c, int n, int g, int chunk, int x_bf16, int w_bf16, int nhwc, int vec,
                         int fold, float eps, void* stream) {
  StatsArgs a = {x, static_cast<float*>(psum), static_cast<float*>(psq), static_cast<unsigned*>(counter),
                 static_cast<float*>(sum), static_cast<float*>(sumsq), weight, bias, w_out, shift_out,
                 static_cast<float*>(mean_out), static_cast<float*>(inv_out), c, n, g, chunk, 0, w_bf16, fold, eps};
  if (chunk <= 0 || (fold && (g <= 0 || c % g != 0))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool nh = nhwc != 0;
  if (x_bf16) return vec ? stats<bf16, true>(a, batch, nh, s) : stats<bf16, false>(a, batch, nh, s);
  return vec ? stats<float, true>(a, batch, nh, s) : stats<float, false>(a, batch, nh, s);
}

// Plan (b)'s second launch. x, y: [batch, c, n] or (nhwc = 1) [batch, n, c],
// contiguous; w, b: [batch, c] (the folded scale and shift), all bf16
// (x_bf16 = 1) or all fp32. silu = 1 applies SiLU after the shift. vec as
// above (y, w and b 16-byte aligned too).
int fdt_group_norm_apply(const void* x, const void* w, const void* b, void* y, int batch, int c, int n, int silu,
                         int x_bf16, int nhwc, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool si = silu != 0, nh = nhwc != 0;
  if (x_bf16) return vec ? apply<bf16, true>(x, w, b, y, batch, c, n, si, nh, s) : apply<bf16, false>(x, w, b, y, batch, c, n, si, nh, s);
  return vec ? apply<float, true>(x, w, b, y, batch, c, n, si, nh, s) : apply<float, false>(x, w, b, y, batch, c, n, si, nh, s);
}

// Plan (a): the whole GroupNorm in one launch. x, y as above (16-byte
// aligned; NCHW: n, NHWC: c and `channels` times the element size multiples
// of 16); weight, bias [c] (bf16 when w_bf16 = 1, else fp32); mean_out,
// inv_out [batch, g] fp32. cluster: blocks of a cluster (1-8). NHWC:
// `channels` of a slice (whole groups), `rows` a block takes (the last
// block's first row inside n); NCHW: `channels` a block takes (C/G /
// cluster), rows unused (ops/norms.py gn_resident_plan). Returns the CUDA
// error code of the launch (0 on success): a plan whose shared memory
// exceeds the block's limit, or a cluster the card cannot hold, is refused.
int fdt_group_norm_resident(const void* x, const void* weight, const void* bias, void* y, void* mean_out,
                            void* inv_out, int batch, int c, int n, int g, int cluster, int channels, int rows,
                            int x_bf16, int w_bf16, int nhwc, int silu, float eps, void* stream) {
  ResidentArgs a = {x, y, weight, bias, static_cast<float*>(mean_out), static_cast<float*>(inv_out), c, n, g,
                    channels, rows, 0, 0, cluster, w_bf16, eps};
  if (g <= 0 || channels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool nh = nhwc != 0;
  if (x_bf16) return silu ? resident<bf16, true>(a, batch, nh, s) : resident<bf16, false>(a, batch, nh, s);
  return silu ? resident<float, true>(a, batch, nh, s) : resident<float, false>(a, batch, nh, s);
}

}  // extern "C"
