// Windowed centroid scan: per-query minima of the stage-1 rank over
// 128-centroid windows.
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/centroid_scan.py ::
// pallas_centroid_window_scan (kernel _make_kernel), pass 1 of
// windowed_centroid_topk.
//
//   caug (Cpad, d_pad) f32   [centroid | 0 pad]; invalid rows 1e18 throughout
//   qaug (Q, d_pad)    f32   [-2 q | 0 pad]
//   out  (Q, Cpad/128) f32   min over window w of  |c|^2 + c . (-2 q)
//
// Two rank modes, as in the TPU kernel: bf16 (both dot operands rounded to
// bf16, products exact in f32, f32 sums: the index stores bf16) and f32
// (full f32 FMAs, the counterpart of Precision.HIGHEST).  |c|^2 is always
// the f32 sum over the unrounded row.  Only the (Q, Cpad/128) minima reach
// memory; the (Q, Cpad) rank matrix is never written.
//
// What bounds it on Hopper: arithmetic.  2 * Q * Cpad * d_pad flops (92
// GFLOP at Q 8,192, Cpad 44,032, d_pad 128) against (Q + Cpad) * d_pad * 4
// bytes of operands, which the 50 MB L2 holds, and Q * Cpad / 32 bytes of
// output.
//
// What the design does about it: a register-tiled f32 GEMM whose epilogue
// is the window minimum.  A block owns one window (128 centroids) and 128
// queries; 256 threads stage both tiles through shared memory in 16-deep
// slices of d (k-major, so a thread's operands are float4 reads: centroid
// reads are unique and conflict-free, query reads are half-warp
// broadcasts), and each thread accumulates 8 centroids x 8 queries (64 FMAs
// per four 16-byte shared-memory reads).  Staging computes |c|^2 from the
// unrounded values before the bf16 rounding.  The minimum over the block's
// 128 centroids is a register min over a thread's 8 followed by a shuffle
// butterfly across the 16 lanes that share a query group.  1e18 rows give
// |c|^2 ~ 1.3e38 (inf from d_pad 384 on); fminf never turns that into NaN
// and such a window never wins.  Tensor cores (wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;        // centroids per window = the block's centroid tile
constexpr int kBQ = 128;       // queries per block
constexpr int kBK = 16;        // depth of a staged slice of d
constexpr int kThreads = 256;  // 16 centroid groups x 16 query groups
constexpr int kTM = 8;         // centroids per thread
constexpr int kTN = 8;         // queries per thread

template <bool kBf16>
__device__ __forceinline__ float rank_operand(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Column of a thread's i-th of 8 values: two runs of 4, at 4 g and 64 + 4 g,
// so eight neighbouring threads read 128 contiguous bytes of a tile row.
__device__ __forceinline__ int tile_col(int g, int i) { return (i < 4 ? 0 : 60) + 4 * g + i; }

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
window_scan_kernel(const float* __restrict__ caug, const float* __restrict__ qaug,
                   float* __restrict__ out, int Q, int W, int d_pad) {
  __shared__ __align__(16) float Cs[kBK][kL + 4];   // centroid slice, k-major
  __shared__ __align__(16) float Qs[kBK][kBQ + 4];  // query slice, k-major
  __shared__ float cn2_half[2][kL];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // centroid group
  const int ty = tid / 16;  // query group; the 16 lanes of a half-warp share it
  const int w = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;

  // Staging: thread (sr, sh) loads 8 consecutive values of row sr of both
  // tiles, at depth sh * 8 of each 16-deep slice.
  const int sr = tid % kL;
  const int sh = tid / kL;
  const float* crow = caug + ((size_t)w * kL + sr) * d_pad + sh * 8;
  const bool q_ok = q0 + sr < Q;
  const float* qrow = qaug + (size_t)(q_ok ? q0 + sr : 0) * d_pad + sh * 8;
  float cn2 = 0.f;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d_pad; k0 += kBK) {
    const float4 c_lo = __ldg(reinterpret_cast<const float4*>(crow + k0));
    const float4 c_hi = __ldg(reinterpret_cast<const float4*>(crow + k0 + 4));
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 q_lo = q_ok ? __ldg(reinterpret_cast<const float4*>(qrow + k0)) : zero;
    const float4 q_hi = q_ok ? __ldg(reinterpret_cast<const float4*>(qrow + k0 + 4)) : zero;
    const float cv[8] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
    const float qv[8] = {q_lo.x, q_lo.y, q_lo.z, q_lo.w, q_hi.x, q_hi.y, q_hi.z, q_hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      cn2 = fmaf(cv[e], cv[e], cn2);  // exact f32 |c|^2 of the unrounded row
      Cs[sh * 8 + e][sr] = rank_operand<kBf16>(cv[e]);
      Qs[sh * 8 + e][sr] = rank_operand<kBf16>(qv[e]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Cs[kk][tile_col(tx, 0)]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Cs[kk][tile_col(tx, 4)]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Qs[kk][tile_col(ty, 0)]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Qs[kk][tile_col(ty, 4)]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cn2_half[sh][sr] = cn2;
  __syncthreads();

  float m[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) m[j] = INFINITY;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int c = tile_col(tx, i);
    const float c2 = cn2_half[0][c] + cn2_half[1][c];
#pragma unroll
    for (int j = 0; j < kTN; ++j) m[j] = fminf(m[j], c2 + acc[i][j]);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < kTN; ++j) m[j] = fminf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
  if (tx == 0) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int q = q0 + tile_col(ty, j);
      if (q < Q) out[(size_t)q * W + w] = m[j];
    }
  }
}

}  // namespace

// caug (Cpad, d_pad) and qaug (Q, d_pad) f32, row-major, 16-byte aligned;
// Cpad a multiple of 128 and d_pad of 16 (the wrapper checks).  out
// (Q, Cpad / 128) f32.  bf16: rank with bf16-rounded dot operands.
extern "C" int spf_window_scan(const void* caug, const void* qaug, void* out, int Q, int cpad,
                               int d_pad, int bf16, void* stream) {
  if (Q <= 0 || cpad <= 0) return 0;
  if (cpad % kL || d_pad % kBK || d_pad <= 0) return (int)cudaErrorInvalidValue;
  const int W = cpad / kL;
  const dim3 grid((unsigned)W, (unsigned)((Q + kBQ - 1) / kBQ));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(caug);
  const float* q = static_cast<const float*>(qaug);
  float* o = static_cast<float*>(out);
  if (bf16)
    window_scan_kernel<true><<<grid, kThreads, 0, s>>>(c, q, o, Q, W, d_pad);
  else
    window_scan_kernel<false><<<grid, kThreads, 0, s>>>(c, q, o, Q, W, d_pad);
  return (int)cudaGetLastError();
}
