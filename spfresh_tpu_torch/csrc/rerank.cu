// Slab rerank: distances from each query to every row of each probed
// posting slab.
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/rerank.py ::
// padded_rerank_distances, both its float path (_make_kernel(quantized=
// False)) and its quantized IVF-SQ8 path (quantized=True).
//
//   float path:
//     queries   (Q, d_pad)          f32
//     vectors3d (Cpad, pad, d_pad)  f32 or bf16
//     distance  reduce(v - q)
//   quantized path (int8 slabs of residual codes r = round((x - c_j) / s_j)):
//     queries   (Q, nprobe, d_pad)  f32   centered rows qc = q - c_j
//     scales    (Q, nprobe)         f32   s_j of each probed slab
//     vectors3d (Cpad, pad, d_pad)  int8
//     distance  reduce(s_j * r - qc)        (= reduce(x - q) up to rounding)
//   rows      (Q, nprobe)         i32   slab index per (query, probe)
//   out       (Q, nprobe, pad)    f32   sum diff^2 | sum |diff| | max |diff|
//
// What bounds it on Hopper: bytes.  Each (query, probe) streams one whole
// (pad, d_pad) slab once and does ~2-3 flops per element, far below the
// ~300 flop/byte an H100 needs before its ALUs, not HBM, are the limit.
// int8 slabs are half the bytes of bf16 ones.
//
// What the design does about it: one block per (query, probe) reads its
// own slab index (the TPU kernel's scalar prefetch becomes one load), keeps
// its query row in shared memory (the query, or for int8 this probe's one
// centered row, plus one scale), and lets a group of lanes walk each slab
// row with 16-byte read-only loads along d: 4 f32, 8 bf16 or 16 int8 values
// per lane.  A row is 16 lanes for f32/bf16 and 8 lanes for int8, so at
// d_pad 128 no lane of an int8 row idles (a 128-byte row is 8 loads).
// Sums are f32 and reduced with shuffles.  65k+ independent blocks at the
// main path's shapes keep enough loads in flight to cover HBM latency
// without the TPU kernel's manual DMA ring.  The output (one f32 per row)
// is small next to the bytes read.  The dequantizing multiply s_j * r is a
// separately rounded __fmul_rn, so nvcc cannot contract it with the
// subtraction into an FMA: the kernel rounds as the plain version does.
//
// Rows beyond the true nprobe must still be valid slab indices; callers
// mask their distances.  An out-of-range row index yields NaN distances
// instead of reading outside the slab array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Metric { kEuclidean = 0, kManhattan = 1, kChebyshev = 2 };

template <int M>
__device__ __forceinline__ float accumulate(float acc, float diff) {
  if (M == kEuclidean) return fmaf(diff, diff, acc);
  if (M == kManhattan) return acc + fabsf(diff);
  return fmaxf(acc, fabsf(diff));
}

template <int M>
__device__ __forceinline__ float combine(float a, float b) {
  return M == kChebyshev ? fmaxf(a, b) : a + b;
}

// 16 bytes of a slab row as f32 values; kLanes lanes share one slab row.
struct F32 {
  static constexpr int kVals = 4;
  static constexpr int kLanes = 16;
  static constexpr bool kQuantized = false;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
struct BF16 {
  static constexpr int kVals = 8;
  static constexpr int kLanes = 16;
  static constexpr bool kQuantized = false;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// int8 residual codes, little-endian: byte b of word i is value 4 i + b.
// Sign-extending shifts give the exact integer, and every int8 is an f32.
struct I8 {
  static constexpr int kVals = 16;
  static constexpr int kLanes = 8;
  static constexpr bool kQuantized = true;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] = (float)((int32_t)(w[i] << (24 - 8 * b)) >> 24);
  }
};

template <typename S, int M>
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ queries, const int* __restrict__ rows,
              const float* __restrict__ scales, const uint4* __restrict__ slabs,
              float* __restrict__ out, int nprobe, int cpad, int pad, int d_pad) {
  constexpr int kLanesPerRow = S::kLanes;
  constexpr int kRowsPerPass = kThreads / kLanesPerRow;
  extern __shared__ __align__(16) float qs[];  // this block's query (or centered) row
  const int qj = blockIdx.x;                   // q * nprobe + j
  // Float path: the query row q.  Quantized path: the centered row (q, j).
  const float* qrow = queries + (size_t)(S::kQuantized ? qj : qj / nprobe) * d_pad;
  for (int t = threadIdx.x; t < d_pad; t += kThreads) qs[t] = qrow[t];
  const float scale = S::kQuantized ? scales[qj] : 1.f;
  const int row = rows[qj];
  float* o = out + (size_t)qj * pad;
  if (row < 0 || row >= cpad) {
    for (int r = threadIdx.x; r < pad; r += kThreads) o[r] = __int_as_float(0x7fc00000);
    return;
  }
  __syncthreads();

  constexpr int V = S::kVals;
  const int chunks = d_pad / V;  // 16-byte chunks per slab row
  const uint4* slab = slabs + (size_t)row * pad * chunks;
  const int lane = threadIdx.x % kLanesPerRow;
  const int group = threadIdx.x / kLanesPerRow;
  // The pass loop is uniform across the block so every shuffle below runs
  // with all 32 lanes of each warp present.
  for (int r0 = 0; r0 < pad; r0 += kRowsPerPass) {
    const int r = r0 + group;
    float acc = 0.f;
    if (r < pad) {
      const uint4* src = slab + (size_t)r * chunks;
      for (int c = lane; c < chunks; c += kLanesPerRow) {
        float v[V];
        S::unpack(__ldg(src + c), v);
        if (S::kQuantized) {
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = __fmul_rn(v[e], scale);
        }
        const float4* qv = reinterpret_cast<const float4*>(qs + c * V);
#pragma unroll
        for (int e = 0; e < V / 4; ++e) {
          const float4 qq = qv[e];
          acc = accumulate<M>(acc, v[4 * e + 0] - qq.x);
          acc = accumulate<M>(acc, v[4 * e + 1] - qq.y);
          acc = accumulate<M>(acc, v[4 * e + 2] - qq.z);
          acc = accumulate<M>(acc, v[4 * e + 3] - qq.w);
        }
      }
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
      acc = combine<M>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (r < pad && lane == 0) o[r] = acc;
  }
}

template <typename S>
cudaError_t launch_metric(int metric, const float* queries, const int* rows, const float* scales,
                          const uint4* slabs, float* out, int Q, int nprobe, int cpad, int pad,
                          int d_pad, cudaStream_t stream) {
  const dim3 grid((unsigned)Q * (unsigned)nprobe);
  const size_t smem = (size_t)d_pad * sizeof(float);
  switch (metric) {
    case kEuclidean:
      rerank_kernel<S, kEuclidean><<<grid, kThreads, smem, stream>>>(
          queries, rows, scales, slabs, out, nprobe, cpad, pad, d_pad);
      break;
    case kManhattan:
      rerank_kernel<S, kManhattan><<<grid, kThreads, smem, stream>>>(
          queries, rows, scales, slabs, out, nprobe, cpad, pad, d_pad);
      break;
    case kChebyshev:
      rerank_kernel<S, kChebyshev><<<grid, kThreads, smem, stream>>>(
          queries, rows, scales, slabs, out, nprobe, cpad, pad, d_pad);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// metric: 0 Euclidean (squared), 1 Manhattan, 2 Chebyshev.  slab_dtype:
// 0 float32, 1 bfloat16, 2 int8 (then ``queries`` is the (Q, nprobe, d_pad)
// centered block and ``scales`` the (Q, nprobe) scale table; else scales
// is unused).  d_pad must be a multiple of 16 bytes' worth of slab
// elements; the wrapper checks shapes, alignment and contiguity.
extern "C" int spf_rerank(const void* queries, const void* rows, const void* scales,
                          const void* vectors3d, void* out, int Q, int nprobe, int cpad, int pad,
                          int d_pad, int metric, int slab_dtype, void* stream) {
  if (Q <= 0 || nprobe <= 0 || pad <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(queries);
  const int* r = static_cast<const int*>(rows);
  const float* sc = static_cast<const float*>(scales);
  const uint4* v = static_cast<const uint4*>(vectors3d);
  float* o = static_cast<float*>(out);
  switch (slab_dtype) {
    case 0:
      return (int)launch_metric<F32>(metric, qf, r, sc, v, o, Q, nprobe, cpad, pad, d_pad, s);
    case 1:
      return (int)launch_metric<BF16>(metric, qf, r, sc, v, o, Q, nprobe, cpad, pad, d_pad, s);
    case 2:
      return (int)launch_metric<I8>(metric, qf, r, sc, v, o, Q, nprobe, cpad, pad, d_pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* spf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
