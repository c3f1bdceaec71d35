// Tensor Memory Accelerator (TMA) copies and the mbarriers they complete
// on, shared by the Hopper kernels that fill shared-memory rings by TMA:
// the attention backward pair (flash_bwd.cu), the streaming attention
// forward on both layouts (flash_fwd_wgmma.cu: K2 and the packed K5), the
// feed-forward GEMMs (gemm_sm90.cu: K10 and K12) and the int8 GEMM
// (int8_gemm.cu: K11).
//
// Two layouts:
//   - The attention tiles: an [R, DP] tile of a [BH, rows, d] bf16 tensor
//     is DP / 16 TMA boxes of 16 columns by R rows, 32-byte swizzled (each
//     32-byte row's two 16-byte halves swapped on rows 4..7 of every 8).
//     Byte offset of element (r, c): (c / 16) * 32R + 32r + (((c / 8) ^
//     (r / 4)) & 1) * 16 + (c % 8) * 2. Reads of 8 rows x 16 bytes
//     (ldmatrix, wgmma) hit every bank once, and the tile is both a K-major
//     and an MN-major wgmma operand (desc_k, desc_mn). The map is 3-D, so
//     rows past a head's row count arrive as zeros and never as the next
//     head's rows; columns past d arrive as zeros too. On the packed [B, S,
//     H*D] layout the map is 4-D over [B, S, H, D] (make_map_packed), with
//     boxes of 16 columns by 1 head by R rows by 1 batch: each lands as the
//     same [R, 16] swizzled slab, rows past S arrive as zeros and never as
//     the next batch's rows, and columns past d never as the next head's.
//   - The GEMM tiles: boxes of 128 bytes (64 bf16 or 128 int8 columns) by R
//     rows of a 2-D row-major matrix, 128-byte swizzled (wgmma.cuh
//     smem_desc_sw128); rows and columns past the matrix arrive as zeros.
//
// Also the cluster helpers of the GEMMs: K11's split of K reduces its int32
// partials through distributed shared memory, and K12's blocks push their
// rows of h into their peers' stages.

#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types (looked up at run time)
#include <dlfcn.h>

#include "wgmma.cuh"

namespace fdt {

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA); one
// thread, after its mbar_inits and before the block's barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more of TMA traffic.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the phase of the given parity to complete; a copy that never
// lands (some seconds of polling) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1 << 22)) __trap();
  }
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, bulk copies) that reads them next.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Named barrier `id` over `threads` threads of the block (id 0 is
// __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread block clusters

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: writes before it (to any
// block's shared memory) are seen by reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The shared::cluster address of p (in this block's shared memory) in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// One arrival on an mbarrier of any block of the cluster (peer_addr), with
// the default (.release.cta) semantics: it orders nothing across blocks, so
// it serves where the arriving thread's own reads are already done (a
// consumer whose wgmma has completed frees a stage). A .release.cluster
// arrival costs a cluster-scope fence each time: it made K12 1.9-3.3x
// slower on the card.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// Copies `bytes` (a multiple of 16) of this block's shared memory to a
// peer's (dst, peer_addr), completing on the peer's mbarrier bar.
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes), "r"(bar)
               : "memory");
}

// ---- copies (one thread starts each)

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// Rows [row0, row0 + R) of head bh into an [R, DP] attention tile, one box
// of 16 columns by R rows per 16-column block.
template <int DP, int R>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int row0, int bh, uint64_t* bar) {
#pragma unroll 4
  for (int cb = 0; cb < DP / 16; ++cb) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst + cb * 16 * R)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(cb * 16), "r"(row0), "r"(bh), "r"(smem_addr(bar))
        : "memory");
  }
}

// The same tile of head h of batch b through a packed map (make_map_packed):
// one box of 16 columns by 1 head by R rows by 1 batch per 16-column block.
template <int DP, int R>
__device__ __forceinline__ void tma_tile_packed(bf16* dst, const CUtensorMap* map, int row0, int h, int b,
                                                uint64_t* bar) {
#pragma unroll 4
  for (int cb = 0; cb < DP / 16; ++cb) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst + cb * 16 * R)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(cb * 16), "r"(h), "r"(row0), "r"(b), "r"(smem_addr(bar))
        : "memory");
  }
}

// A TMA store of a box of a 2-D map from shared memory (one thread), in
// this thread's bulk async-group; rows and columns past the matrix are not
// written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// This thread's bulk stores have read their shared memory (it may be
// written again), or (bulk_wait) have completed.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---- wgmma descriptors of the attention tiles (wgmma.cuh smem_desc)

__device__ __forceinline__ const bf16* at_byte(const bf16* tile, int bytes) {
  return reinterpret_cast<const bf16*>(reinterpret_cast<const unsigned char*>(tile) + bytes);
}
// K-major: 8-row groups 256 bytes apart. MN-major: 16-column blocks 32R
// bytes apart along N and 8-row groups 256 bytes apart along K.
__device__ __forceinline__ uint64_t desc_k(const bf16* p) { return smem_desc(p, 16, 256) | (3ull << 62); }
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, int rows) {
  return smem_desc(p, 32 * rows, 256) | (3ull << 62);
}

// ---- tensor maps (host)

// cuTensorMapEncodeTiled, found at run time in libcuda (which the CUDA
// runtime has loaded), so that the library needs no link to it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW);
    if (libcuda != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A map of rows [0, rows) of each head of a [bh, stride_rows, d] bf16
// tensor, in attention boxes of 16 columns by box_rows rows; false on
// failure.
inline bool make_map(CUtensorMap* map, const void* base, int bh, int rows, int stride_rows, int d, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)stride_rows * d * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of the packed [b, rows, h * d] bf16 tensor as [b, rows, h, d], in
// attention boxes of 16 columns by one head by box_rows rows (tma_tile_packed):
// dims {d, h, rows, b}, strides {2d, 2hd, 2hd.rows} bytes (multiples of 16
// for d % 8 == 0); false on failure.
inline bool make_map_packed(CUtensorMap* map, const void* base, int b, int rows, int h, int d, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2, (cuuint64_t)rows * h * d * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a row-major [rows, cols] matrix of bf16 (elem_bytes 2) or int8
// (1) in GEMM boxes of 128 bytes (64 bf16 or 128 int8 columns) by box_rows
// rows; the row stride (cols * elem_bytes) must be a multiple of 16 bytes.
// False on failure.
inline bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows, int elem_bytes = 2) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current card, or 0 on an error: the persistent grids.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace fdt
