// What the tensor-core kernels share: TMA tile copies into the 128-byte
// swizzle, the wgmma shared-memory descriptor of such a tile, the wgmma
// products and their fences, and the tensor maps that describe the tiles.
// Included by replica.cu and centroid_scan.cu, each inside its own
// anonymous namespace, after slab_ring.cuh (the mbarrier primitives).
//
// A tile is K-major: rows of 128 bytes (64 bf16 or 32 tf32 columns, a
// "slice" of the row), written by TMA with the 128-byte swizzle, so the
// tile starts 1,024-byte aligned.  Every product below reads 32 bytes of
// each row per k-step (k16 bf16, k8 tf32), so a slice is 4 k-steps in both
// types and the descriptor advances 32 bytes a step.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <stdint.h>

constexpr int kRowBytes = 128;  // bytes of a slice row: the swizzle span

// One TMA copy of a (rows x 128-byte) box at column c0, row r0 into shared
// memory; completion is counted in bytes on `bar`.  Out-of-bounds elements
// read 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// TMA writes: rows of 128 bytes, 8-row atoms 1,024 bytes apart (SBO), the
// start address advanced 32 bytes per k-step inside the atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the async MMAs.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SPF_WGMMA_OUT32                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SPF_WGMMA_OUT64                                                                    \
  SPF_WGMMA_OUT32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SPF_WGMMA_REGS32                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SPF_WGMMA_REGS64                                                                   \
  SPF_WGMMA_REGS32                                                                         \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x N, f32 registers) (+)= A (64 x k, shared) . B (N x k, shared)^T,
// both K-major.  `accumulate` 0 overwrites D.  bf16: k 16; tf32: k 8 (the
// tf32 form takes no transpose operands).
__device__ __forceinline__ void wgmma_m64n64_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SPF_WGMMA_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SPF_WGMMA_OUT32
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SPF_WGMMA_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SPF_WGMMA_OUT64
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" SPF_WGMMA_REGS64
      "}, %64, %65, p, 1, 1;\n}\n"
      : SPF_WGMMA_OUT64
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SPF_WGMMA_OUT32
#undef SPF_WGMMA_OUT64
#undef SPF_WGMMA_REGS32
#undef SPF_WGMMA_REGS64

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda on the link line).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool ok = err == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major matrix of `elem_bytes`-byte elements read in
// boxes of box_rows x (128 / elem_bytes) columns with the 128-byte swizzle;
// elements past rows or cols read 0.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype,
                            int elem_bytes, int rows, int cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
