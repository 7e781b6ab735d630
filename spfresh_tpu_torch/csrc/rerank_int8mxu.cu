// Expansion-form IVF-SQ8 rerank: squared Euclidean distances from each
// quantized centered query to every row of each probed int8 slab.
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/rerank.py ::
// padded_rerank_distances_int8mxu (both of its forms, native_int8 True and
// False: their dots are exact, so they agree bit for bit).
//
//   qcodes   (Q, nprobe, d)   int8   codes of qc = q - c_row, per (q, probe)
//   qscale   (Q, nprobe)      f32    the query codes' scale s_q
//   qnorm2   (Q, nprobe)      f32    exact |q - c_row|^2
//   rows     (Q, nprobe)      i32    slab index per (query, probe)
//   codesT3d (C, d, pad)      int8   residual codes, TRANSPOSED: pad contiguous
//   norms2   (C, pad)         i32    per slab row |r|^2 of the codes
//   scales   (C,)             f32    per slab dequant scale s_j
//   out      (Q, nprobe, pad) f32    qn2 - (2 s_j s_q) dot + (s_j^2) n2,
//                                    dot = sum_k qcodes[q,j,k] codesT3d[row,k,p]
//
// What bounds it on Hopper: bytes.  Each (query, probe) streams one whole
// (d, pad) int8 slab and does one multiply-add per byte.
//
// What the design does about it: one block per (query, probe) keeps its d
// query codes in shared memory as packed 4-byte words.  Each thread owns
// four adjacent slab columns p..p+3 and, for four consecutive k, loads one
// 4-byte word per k (a warp reads 128 contiguous bytes per k, coalesced),
// transposes the 4 x 4 bytes with __byte_perm so each word holds one
// column's four k values, and accumulates it against the query's word with
// __dp4a: int8 x int8 into an exact int32 dot, as the TPU kernel's MXU
// does.  |dot| <= 127^2 d and n2 <= 127^2 d are exact in f32 up to d 1,040.
// The final combine uses __fmul_rn / __fsub_rn / __fadd_rn in the oracle's
// order, so nvcc cannot contract it into FMAs and the kernel rounds as the
// plain version does.  A tensor-core (int8 mma) form is later work.
//
// d and pad must be multiples of 4 and the code and norm tables 4-byte
// aligned; the wrapper checks.  An out-of-range row index yields NaN
// distances instead of reading outside the slab array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
int8mxu_kernel(const uint32_t* __restrict__ qcodes, const float* __restrict__ qscale,
               const float* __restrict__ qnorm2, const int* __restrict__ rows,
               const uint32_t* __restrict__ codesT, const int* __restrict__ norms2,
               const float* __restrict__ scales, float* __restrict__ out, int cpad, int d,
               int pad) {
  extern __shared__ uint32_t qs[];  // this (query, probe)'s d codes, 4 per word
  const int qj = blockIdx.x;        // q * nprobe + j
  const int kw = d / 4;             // 4-byte words per query row
  const int cw = pad / 4;           // 4-column groups per slab row
  for (int t = threadIdx.x; t < kw; t += blockDim.x) qs[t] = qcodes[(size_t)qj * kw + t];
  const int row = rows[qj];
  float* o = out + (size_t)qj * pad;
  if (row < 0 || row >= cpad) {
    for (int p = threadIdx.x; p < pad; p += blockDim.x) o[p] = __int_as_float(0x7fc00000);
    return;
  }
  __syncthreads();

  const float sj = scales[row];
  const float k2 = __fmul_rn(__fmul_rn(2.0f, sj), qscale[qj]);
  const float s2 = __fmul_rn(sj, sj);
  const float qn2 = qnorm2[qj];
  const uint32_t* slab = codesT + (size_t)row * d * cw;  // (d, pad) as (d, cw) words
  const int* n2row = norms2 + (size_t)row * pad;
  for (int g = threadIdx.x; g < cw; g += blockDim.x) {
    int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
    const uint32_t* src = slab + g;
#pragma unroll 4
    for (int k4 = 0; k4 < kw; ++k4) {
      // Words w_i hold columns p..p+3 at k = 4 k4 + i (byte c = column c).
      const uint32_t w0 = __ldg(src + (size_t)(4 * k4 + 0) * cw);
      const uint32_t w1 = __ldg(src + (size_t)(4 * k4 + 1) * cw);
      const uint32_t w2 = __ldg(src + (size_t)(4 * k4 + 2) * cw);
      const uint32_t w3 = __ldg(src + (size_t)(4 * k4 + 3) * cw);
      // 4 x 4 byte transpose: t_c holds column c's codes at k = 4 k4 .. +3.
      const uint32_t a01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
      const uint32_t a23 = __byte_perm(w2, w3, 0x5140);  // w2.b0 w3.b0 w2.b1 w3.b1
      const uint32_t b01 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
      const uint32_t b23 = __byte_perm(w2, w3, 0x7362);  // w2.b2 w3.b2 w2.b3 w3.b3
      const int q4 = (int)qs[k4];
      acc0 = __dp4a((int)__byte_perm(a01, a23, 0x5410), q4, acc0);
      acc1 = __dp4a((int)__byte_perm(a01, a23, 0x7632), q4, acc1);
      acc2 = __dp4a((int)__byte_perm(b01, b23, 0x5410), q4, acc2);
      acc3 = __dp4a((int)__byte_perm(b01, b23, 0x7632), q4, acc3);
    }
    const int acc[4] = {acc0, acc1, acc2, acc3};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = 4 * g + c;
      const float t = __fsub_rn(qn2, __fmul_rn(k2, (float)acc[c]));
      o[p] = __fadd_rn(t, __fmul_rn(s2, (float)n2row[p]));
    }
  }
}

}  // namespace

// All pointers are device pointers of the shapes above; the wrapper checks
// shapes, dtypes, contiguity, alignment and d % 4 == pad % 4 == 0.
extern "C" int spf_rerank_int8mxu(const void* qcodes, const void* qscale, const void* qnorm2,
                                  const void* rows, const void* codesT3d, const void* norms2,
                                  const void* scales, void* out, int Q, int nprobe, int cpad,
                                  int d, int pad, void* stream) {
  if (Q <= 0 || nprobe <= 0 || pad <= 0) return 0;
  if (d % 4 || pad % 4) return (int)cudaErrorInvalidValue;
  int threads = ((pad / 4 + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((unsigned)Q * (unsigned)nprobe);
  const size_t smem = (size_t)d;  // d / 4 words
  int8mxu_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qcodes), static_cast<const float*>(qscale),
      static_cast<const float*>(qnorm2), static_cast<const int*>(rows),
      static_cast<const uint32_t*>(codesT3d), static_cast<const int*>(norms2),
      static_cast<const float*>(scales), static_cast<float*>(out), cpad, d, pad);
  return (int)cudaGetLastError();
}
