// Tensor Memory Accelerator (TMA) copies and the mbarriers they complete
// on, shared by the Hopper kernels that fill shared-memory rings by TMA:
// the attention backward pair (flash_bwd.cu), the streaming attention
// forward on both layouts (flash_fwd_wgmma.cu: K2 and the packed K5) and
// the down-projection GEMM (gemm_sm90.cu).
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
//   - The GEMM tiles: boxes of 64 columns (128 bytes) by R rows of a 2-D
//     row-major matrix, 128-byte swizzled (wgmma.cuh smem_desc_sw128); rows
//     past the matrix arrive as zeros.

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

// A map of a row-major [rows, cols] bf16 matrix in GEMM boxes of 64
// columns by box_rows rows; false on failure.
inline bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fdt
