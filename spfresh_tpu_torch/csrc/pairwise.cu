// L1 / Linf pairwise distances: out[i, j] = sum_k |x_ik - y_jk|  (Manhattan)
//                                         or max_k |x_ik - y_jk|  (Chebyshev)
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/pairwise.py ::
// pallas_l1_linf_pairwise (kernel _make_kernel).
//
//   x   (n, d) f32 or bf16, row-major
//   y   (m, d) same dtype
//   out (n, m) f32
//
// bf16 inputs are widened to f32 when staged (exact); differences, sums and
// maxima are f32.  A Linf maximum is order-free, so it is bit-equal to any
// other evaluation; an L1 sum runs over k = 0 .. d-1 in order.
//
// What bounds it on Hopper: arithmetic.  These metrics have no matmul
// form, so the tensor cores cannot help: every (i, j, k) costs a subtract
// and an add (or max) of the absolute value on the CUDA cores, 3 n m d
// operations as the TPU kernel's cost estimate counts them (7.8e10 triples
// at the Manhattan stage-1 shape Q 8,192 x C 9,945 x d 960), against
// (n + m) d input bytes, which the 50 MB L2 serves, and 4 n m output bytes.
//
// What the design does about it: the register tile of csrc/centroid_scan.cu.
// The TPU kernel transposes y so its d-reduction runs down sublanes; here a
// block owns 128 x rows and 128 y rows, stages both through shared memory
// in 16-deep slices of d (k-major, so a thread's operands are float4
// reads), and each of its 256 threads accumulates an 8 x 8 block of
// outputs in registers: 64 |x - y| accumulations per four 16-byte
// shared-memory reads.  Out-of-range rows and depths stage as zeros, and
// |0 - 0| changes neither metric.  Only the (n, m) result reaches memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBX = 128;       // x rows per block
constexpr int kBY = 128;       // y rows per block
constexpr int kBK = 16;        // depth of a staged slice of d
constexpr int kThreads = 256;  // 16 x groups x 16 y groups
constexpr int kT = 8;          // rows (and columns) per thread

struct F32 {
  using T = float;
  __device__ __forceinline__ static float get(const float* p, size_t i) { return __ldg(p + i); }
};

struct BF16 {
  using T = uint16_t;
  __device__ __forceinline__ static float get(const uint16_t* p, size_t i) {
    return __uint_as_float(((uint32_t)__ldg(p + i)) << 16);
  }
};

// Row of a thread's i-th of 8 values: two runs of 4, at 4 g and 64 + 4 g,
// so sixteen neighbouring threads cover 64 contiguous rows of a tile.
__device__ __forceinline__ int tile_row(int g, int i) { return (i < 4 ? 0 : 60) + 4 * g + i; }

template <typename S, bool kL1>
__global__ void __launch_bounds__(kThreads)
l1_linf_kernel(const typename S::T* __restrict__ x, const typename S::T* __restrict__ y,
               float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float Xs[kBK][kBX + 4];  // x slice, k-major
  __shared__ __align__(16) float Ys[kBK][kBY + 4];  // y slice, k-major

  const int tid = threadIdx.x;
  const int ty = tid % 16;  // y group: the 16 lanes of a half-warp differ here
  const int tx = tid / 16;  // x group
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // Staging: consecutive threads read consecutive depths of one row.
    for (int e = tid; e < kBX * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, k = k0 + kk;
      const int xr = x0 + r, yr = y0 + r;
      Xs[kk][r] = (xr < n && k < d) ? S::get(x, (size_t)xr * d + k) : 0.f;
      Ys[kk][r] = (yr < m && k < d) ? S::get(y, (size_t)yr * d + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][tile_row(tx, 0)]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][tile_row(tx, 4)]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ys[kk][tile_row(ty, 0)]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ys[kk][tile_row(ty, 4)]);
      const float a[kT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const float diff = fabsf(a[i] - b[j]);
          acc[i][j] = kL1 ? acc[i][j] + diff : fmaxf(acc[i][j], diff);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int r = x0 + tile_row(tx, i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int c = y0 + tile_row(ty, j);
      if (c < m) out[(size_t)r * m + c] = acc[i][j];
    }
  }
}

template <typename S>
void launch(const void* x, const void* y, float* out, int n, int m, int d, int l1,
            cudaStream_t s) {
  using T = typename S::T;
  const dim3 grid((unsigned)((n + kBX - 1) / kBX), (unsigned)((m + kBY - 1) / kBY));
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  if (l1)
    l1_linf_kernel<S, true><<<grid, kThreads, 0, s>>>(xp, yp, out, n, m, d);
  else
    l1_linf_kernel<S, false><<<grid, kThreads, 0, s>>>(xp, yp, out, n, m, d);
}

}  // namespace

// x (n, d), y (m, d): bf16 ? bfloat16 : float32, row-major.  out (n, m)
// f32.  l1: 1 Manhattan, 0 Chebyshev.  m <= 65,535 * 128 (grid y).
extern "C" int spf_l1_linf_pairwise(const void* x, const void* y, void* out, int n, int m, int d,
                                    int l1, int bf16, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (d <= 0 || (m + kBY - 1) / kBY > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16)
    launch<BF16>(x, y, o, n, m, d, l1, s);
  else
    launch<F32>(x, y, o, n, m, d, l1, s);
  return (int)cudaGetLastError();
}
