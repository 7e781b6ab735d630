// Closure-replica top-k and nearest centroid: for every corpus point, the
// n_extra best replica clusters under SPANN's boundary-closure rule, or its
// nearest centroid.
//
// Replaces the TPU kernels of spfresh_tpu/ops/pallas/replica.py:
// pallas_replica_topk (_replica_topk_impl, kernel _make_kernel) and
// pallas_nearest_centroid (_nearest_centroid_impl, _make_assign_kernel).
//
// Replica.  For point p with base cluster b, over every centroid j (squared
// L2 by the expansion, clamped >= 0):
//   D  = |c_j|^2 + |p|^2   - 2 c_j.p
//   CC = |c_j|^2 + |c_b|^2 - 2 c_j.c_b
//   admit j  iff  D < bt*db  and  CC >= D  and  j != b      (db = dist(p, c_b))
//   rank = D, or with SOAR  D + lambda * (0.5 (db + D - CC))^2 / max(db, 1e-30)
// and keep the n_extra smallest ranks, ascending, equal ranks to the lower
// centroid id (the tie rule of lax.top_k and of the TPU kernel's
// _select_rounds).  Missing replicas come back as (id -1, rank +inf).
// Nearest: D_j as above, base = argmin_j D_j (equal D to the lowest j),
// db = D_base.
//
// What bounds them on Hopper: operations.  Two dot products per (point,
// centroid) pair for the replica, one for the nearest centroid: 4 n C d
// and 2 n C d flops (1.1e13 and 5.4e12 at an out-of-core tile, 262,144 x
// 104,425 and x 66,599, d 96) against ~(n + C) d bf16 bytes read.  The
// (n, C) distance space never reaches device memory.
//
// Each input dtype has one kernel; neither falls back to the other.
//
// bf16 (every build path): tc_kernel.  The TPU kernels multiply bf16 by
// bf16 into f32 on the MXU at default precision; here wgmma does the same
// on the tensor cores (bf16 products are exact in f32, only the summation
// order differs).  A block of two consumer warpgroups owns 128 points (64
// each) and walks every centroid in ascending-id tiles (64 centroids for
// the replica's two products, 128 for the nearest centroid's one); one
// thread of a producer warpgroup feeds it with TMA copies (128-byte
// swizzle, 64-column slices; d 96 reads a zero-filled half slice, and rows
// and columns past the ends read as zero) through a ring of shared-memory
// buffers guarded by mbarriers.  The producer warpgroup hands its
// registers to the consumers (setmaxnreg 40 / 232): capped at 128, the
// epilogue spilled to local memory.  The point-side tiles (X and, for the
// replica, the gathered base centroids
// Cb = cents[base]) stay resident in shared memory for the whole walk
// while they fit (d <= 320 for the replica, <= 576 for the nearest
// centroid); past that they stream slice by slice beside the centroid
// slices.  Both replica products share each centroid slice.  The epilogue
// runs on the accumulators in registers: the closure test, CC and the SOAR
// rank with the arithmetic of the f32 kernel, a sorted (rank, id) insert
// per row, or a running (D, id) argmin; the 4 lanes that share a row merge
// by shuffles at the end.  No atomics: every run gives the same result.
// Squared norms come from one pass per row (sqnorm_kernel) into scratch.
// Measured on an out-of-core tile (H100 80GB HBM3, 700 W; chip_smoke.py):
// replica 146.5 TFLOP/s (71.9 ms), nearest centroid 132.3 TFLOP/s (25.3
// ms), 13-15% of the tensor-core peak.  The CUDA-core epilogue, not the
// tensor cores, sets that pace: a warpgroup's epilogue does not overlap
// its own next products.
//
// f32 (the exact build): replica_kernel and nearest_kernel, register-tiled
// f32 GEMMs on the CUDA cores.  Their contract is the reference's
// Precision.HIGHEST, which TF32 tensor cores would break.  A replica block
// owns 64 points and walks every centroid in ascending-id tiles of 128,
// staged with the points and their base centroids through shared memory in
// 16-deep slices of d; each thread accumulates a 4-point x 8-centroid block
// of both dot products (64 FMAs per 16 shared-memory reads) and keeps its
// points' running top-n_extra in registers with a (rank, id) lexicographic
// insertion; the 16 threads that share a point merge their lists with
// shuffles at the end.  C is a run-time argument; columns past C are masked.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "slab_ring.cuh"    // the mbarrier primitives
#include "tensor_tile.cuh"  // TMA tiles, wgmma, tensor maps

constexpr int BM = 64;    // points per block
constexpr int BN = 128;   // centroids per tile
constexpr int BK = 16;    // depth of a staged slice of d
constexpr int TM = 4;     // points per thread
constexpr int TN = 8;     // centroids per thread
constexpr int NT = 256;   // threads: 16 (points) x 16 (centroids)
constexpr int kIdNone = 0x7fffffff;

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

// One warp per row: out[r] = sum_k A[r, k]^2 in f32.
template <typename S>
__global__ void sqnorm_kernel(const typename S::T* __restrict__ A, int rows, int d,
                              float* __restrict__ out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = S::get(A, (size_t)r * d + k);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[r] = acc;
}

// x2 = |X rows|^2 (n,) and cn2 = |cents rows|^2 (C,) into scratch.
template <typename S>
cudaError_t sqnorms(const void* X, int n, const void* cents, int C, int d, float* x2, float* cn2,
                    cudaStream_t s) {
  using T = typename S::T;
  constexpr int kWarpsPerBlock = 8;
  sqnorm_kernel<S><<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(X), n, d, x2);
  if (C > 0)
    sqnorm_kernel<S><<<(C + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const T*>(cents), C, d, cn2);
  return cudaGetLastError();
}

// Sorted insert by (rank, id): strict lexicographic order, so the kept set
// is the NE smallest pairs whatever order candidates arrive in.
template <int NE>
__device__ __forceinline__ void insert(float (&v)[NE], int (&id)[NE], float nv, int ni) {
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const bool lt = nv < v[t] || (nv == v[t] && ni < id[t]);
    if (lt) {
      const float tv = v[t];
      const int ti = id[t];
      v[t] = nv;
      id[t] = ni;
      nv = tv;
      ni = ti;
    }
  }
}

template <typename S, int NE>
__global__ void __launch_bounds__(NT)
replica_kernel(const typename S::T* __restrict__ X, const int* __restrict__ base,
               const typename S::T* __restrict__ cents, const float* __restrict__ db_in,
               const float* __restrict__ x2g, const float* __restrict__ cn2g,
               int* __restrict__ out_idx, float* __restrict__ out_rank, int n, int C, int d,
               int n_extra, float bt, float lam) {
  __shared__ __align__(16) float Xs[BK][BM + 4];  // point slice, k-major
  __shared__ __align__(16) float Bs[BK][BM + 4];  // base-centroid slice
  __shared__ __align__(16) float Cs[BK][BN + 4];  // centroid-tile slice
  __shared__ int base_s[BM];
  __shared__ float x2_s[BM], cb2_s[BM], db_s[BM], thr_s[BM];
  __shared__ float cn2_s[BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // point group: rows ty*TM .. +TM
  const int tx = tid % 16;  // centroid group: cols tx*TN .. +TN (ascending ids)
  const int p0 = blockIdx.x * BM;

  if (tid < BM) {
    const int p = p0 + tid;
    int b = 0;
    float x2 = 0.f, cb2 = 0.f, db = 0.f, thr = -INFINITY;  // padding rows admit nothing
    if (p < n) {
      b = base[p];
      x2 = x2g[p];
      cb2 = cn2g[b];
      if (db_in != nullptr) {
        db = db_in[p];
      } else {
        float pb = 0.f;  // dist(p, c_b) in the same expansion the tiles use
        for (int k = 0; k < d; ++k)
          pb = fmaf(S::get(X, (size_t)p * d + k), S::get(cents, (size_t)b * d + k), pb);
        db = fmaxf((x2 + cb2) - 2.f * pb, 0.f);
      }
      thr = bt * db;
    }
    base_s[tid] = b;
    x2_s[tid] = x2;
    cb2_s[tid] = cb2;
    db_s[tid] = db;
    thr_s[tid] = thr;
  }

  float best_v[TM][NE];
  int best_i[TM][NE];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < NE; ++t) {
      best_v[i][t] = INFINITY;
      best_i[i][t] = kIdNone;
    }

  for (int c0 = 0; c0 < C; c0 += BN) {
    float accx[TM][TN], accb[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accx[i][j] = accb[i][j] = 0.f;
    __syncthreads();  // previous tile's readers are done with cn2_s
    if (tid < BN) cn2_s[tid] = (c0 + tid < C) ? cn2g[c0 + tid] : 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK, p = p0 + r, k = k0 + kk;
        float xv = 0.f, bv = 0.f;
        if (p < n && k < d) {
          xv = S::get(X, (size_t)p * d + k);
          bv = S::get(cents, (size_t)base_s[r] * d + k);
        }
        Xs[kk][r] = xv;
        Bs[kk][r] = bv;
      }
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, kk = e % BK, c = c0 + r, k = k0 + kk;
        Cs[kk][r] = (c < C && k < d) ? S::get(cents, (size_t)c * d + k) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 xa = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM]);
        const float4 ba = *reinterpret_cast<const float4*>(&Bs[kk][ty * TM]);
        const float4 ca = *reinterpret_cast<const float4*>(&Cs[kk][tx * TN]);
        const float4 cb = *reinterpret_cast<const float4*>(&Cs[kk][tx * TN + 4]);
        const float xr[TM] = {xa.x, xa.y, xa.z, xa.w};
        const float br[TM] = {ba.x, ba.y, ba.z, ba.w};
        const float cr[TN] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            accx[i][j] = fmaf(xr[i], cr[j], accx[i][j]);
            accb[i][j] = fmaf(br[i], cr[j], accb[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      const float x2 = x2_s[r], cb2 = cb2_s[r], thr = thr_s[r], db = db_s[r];
      const int b = base_s[r];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cl = tx * TN + j;
        const int col = c0 + cl;
        if (col >= C) continue;
        const float cn2 = cn2_s[cl];
        const float D = fmaxf((cn2 + x2) - 2.f * accx[i][j], 0.f);
        const float CC = fmaxf((cn2 + cb2) - 2.f * accb[i][j], 0.f);
        if (D < thr && CC >= D && col != b) {
          float rank = D;
          if (lam != 0.f) {
            const float rd = 0.5f * ((db + D) - CC);
            rank = D + (lam * rd * rd) / fmaxf(db, 1e-30f);
          }
          insert<NE>(best_v[i], best_i[i], rank, col);
        }
      }
    }
  }

  // The 16 threads sharing a point row are lanes of one half-warp: a
  // butterfly over lane bits 3..0 leaves every lane with the merged list.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float ov[NE];
      int oi[NE];
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        ov[t] = __shfl_xor_sync(0xffffffffu, best_v[i][t], off);
        oi[t] = __shfl_xor_sync(0xffffffffu, best_i[i][t], off);
      }
#pragma unroll
      for (int t = 0; t < NE; ++t) insert<NE>(best_v[i], best_i[i], ov[t], oi[t]);
    }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = p0 + ty * TM + i;
      if (p >= n) continue;
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        if (t >= n_extra) break;
        const bool found = best_v[i][t] < INFINITY;
        out_rank[(size_t)p * n_extra + t] = found ? best_v[i][t] : INFINITY;
        out_idx[(size_t)p * n_extra + t] = found ? best_i[i][t] : -1;
      }
    }
  }
}

template <typename S, int NE>
void launch_main(const void* X, const int* base, const void* cents, const float* db,
                 const float* x2, const float* cn2, int* oi, float* orank, int n, int C, int d,
                 int n_extra, float bt, float lam, cudaStream_t s) {
  using T = typename S::T;
  const dim3 grid((unsigned)((n + BM - 1) / BM));
  replica_kernel<S, NE><<<grid, NT, 0, s>>>(static_cast<const T*>(X), base,
                                            static_cast<const T*>(cents), db, x2, cn2, oi, orank,
                                            n, C, d, n_extra, bt, lam);
}

template <typename S>
cudaError_t launch_all(const void* X, const int* base, const void* cents, const float* db,
                       float* x2, float* cn2, int* oi, float* orank, int n, int C, int d,
                       int n_extra, float bt, float lam, cudaStream_t s) {
  const cudaError_t err = sqnorms<S>(X, n, cents, C, d, x2, cn2, s);
  if (err != cudaSuccess) return err;
  // The running list is the next power of two >= n_extra; the first
  // n_extra entries of a sorted top-4 are the sorted top-3.
  if (n_extra <= 1)
    launch_main<S, 1>(X, base, cents, db, x2, cn2, oi, orank, n, C, d, n_extra, bt, lam, s);
  else if (n_extra <= 2)
    launch_main<S, 2>(X, base, cents, db, x2, cn2, oi, orank, n, C, d, n_extra, bt, lam, s);
  else if (n_extra <= 4)
    launch_main<S, 4>(X, base, cents, db, x2, cn2, oi, orank, n, C, d, n_extra, bt, lam, s);
  else
    launch_main<S, 8>(X, base, cents, db, x2, cn2, oi, orank, n, C, d, n_extra, bt, lam, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 nearest centroid: the top-1 sibling of replica_kernel.  For every
// point p:  D_j = max(|c_j|^2 + |p|^2 - 2 c_j.p, 0),  base = argmin_j D_j
// (equal D to the lowest j), db = D_base.  replica_kernel's register-tiled
// f32 GEMM with one accumulator instead of two, so a block owns 128 points
// (8 per thread) and each thread does 64 FMAs per four 16-byte
// shared-memory reads; its epilogue keeps one running (D, id) per point in
// registers with the lexicographic order of insert(), merged over the 16
// lanes that share a point by shuffles.  Columns past C are masked.

constexpr int kNBM = 128;  // points per block
constexpr int kNT = 8;     // points (and centroids) per thread

// Row of a thread's i-th of 8 values: two runs of 4, at 4 g and 64 + 4 g.
__device__ __forceinline__ int tile_row(int g, int i) { return (i < 4 ? 0 : 60) + 4 * g + i; }

// (v, i) before (bv, bi) in the lexicographic order of insert().
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <typename S>
__global__ void __launch_bounds__(NT)
nearest_kernel(const typename S::T* __restrict__ X, const typename S::T* __restrict__ cents,
               const float* __restrict__ x2g, const float* __restrict__ cn2g,
               int* __restrict__ out_idx, float* __restrict__ out_dist, int n, int C, int d) {
  __shared__ __align__(16) float Xs[BK][kNBM + 4];  // point slice, k-major
  __shared__ __align__(16) float Cs[BK][BN + 4];    // centroid-tile slice
  __shared__ float cn2_s[BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // point group
  const int tx = tid % 16;  // centroid group; the 16 lanes of a half-warp differ here
  const int p0 = blockIdx.x * kNBM;

  float x2[kNT], best_v[kNT];
  int best_i[kNT];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int p = p0 + tile_row(ty, i);
    x2[i] = p < n ? x2g[p] : 0.f;
    best_v[i] = INFINITY;
    best_i[i] = kIdNone;
  }

  for (int c0 = 0; c0 < C; c0 += BN) {
    float acc[kNT][kNT];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) acc[i][j] = 0.f;
    __syncthreads();  // previous tile's readers are done with cn2_s
    if (tid < BN) cn2_s[tid] = (c0 + tid < C) ? cn2g[c0 + tid] : 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < kNBM * BK; e += NT) {
        const int r = e / BK, kk = e % BK, p = p0 + r, c = c0 + r, k = k0 + kk;
        Xs[kk][r] = (p < n && k < d) ? S::get(X, (size_t)p * d + k) : 0.f;
        Cs[kk][r] = (c < C && k < d) ? S::get(cents, (size_t)c * d + k) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 xa = *reinterpret_cast<const float4*>(&Xs[kk][tile_row(ty, 0)]);
        const float4 xb = *reinterpret_cast<const float4*>(&Xs[kk][tile_row(ty, 4)]);
        const float4 ca = *reinterpret_cast<const float4*>(&Cs[kk][tile_row(tx, 0)]);
        const float4 cb = *reinterpret_cast<const float4*>(&Cs[kk][tile_row(tx, 4)]);
        const float xr[kNT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float cr[kNT] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) acc[i][j] = fmaf(xr[i], cr[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int cl = tile_row(tx, j);
      const int col = c0 + cl;
      if (col >= C) continue;
      const float cn2 = cn2_s[cl];
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const float D = fmaxf((cn2 + x2[i]) - 2.f * acc[i][j], 0.f);
        if (before(D, col, best_v[i], best_i[i])) {
          best_v[i] = D;
          best_i[i] = col;
        }
      }
    }
  }

  // The 16 threads sharing a point group are lanes of one half-warp.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (before(ov, oi, best_v[i], best_i[i])) {
        best_v[i] = ov;
        best_i[i] = oi;
      }
    }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int p = p0 + tile_row(ty, i);
      if (p < n) {
        out_idx[p] = best_i[i];
        out_dist[p] = best_v[i];
      }
    }
  }
}

template <typename S>
cudaError_t launch_nearest(const void* X, const void* cents, float* x2, float* cn2, int* oi,
                           float* od, int n, int C, int d, cudaStream_t s) {
  using T = typename S::T;
  const cudaError_t err = sqnorms<S>(X, n, cents, C, d, x2, cn2, s);
  if (err != cudaSuccess) return err;
  nearest_kernel<S><<<(unsigned)((n + kNBM - 1) / kNBM), NT, 0, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(cents), x2, cn2, oi, od, n, C, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor-core products (wgmma), the closure or the argmin fused
// into the epilogue.  See the note at the top of the file.

constexpr int kTcWarps = 8;                    // consumer warps: two warpgroups
constexpr int kTcThreads = 32 * kTcWarps + 128;  // and one producer warpgroup
constexpr int kTcBM = 64 * (kTcWarps / 4);       // points per block, 64 per warpgroup
// setmaxnreg: the producer warpgroup gives its registers to the consumers,
// 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSliceCols = 64;                  // bf16 columns of one swizzled slice
constexpr int kMaxStages = 8;
constexpr int kMinStages = 4;
constexpr int kSmemBudget = 220 * 1024;  // resident tiles + ring; 1 KB more for alignment
// Centroids per tile: the replica's two m64n64 accumulators or the nearest
// centroid's one m64n128 are 64 registers a thread (on the out-of-core tile
// the replica took 84 ms at 64, 104 ms at 128).
constexpr int kReplicaBN = 64;
constexpr int kNearestBN = 128;
constexpr CUtensorMapDataType kBf16Map = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

struct TcShape {
  int n, C;
  int slices;    // ceil(d / 64): 64-column slices of a row
  int stages;    // depth of the shared-memory ring
  int resident;  // 1: the point-side tiles stay in shared memory for the whole walk
};

template <int N>
struct Mma;
template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n64_bf16(d, a, b, acc);
  }
};
template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n128_bf16(d, a, b, acc);
  }
};

// The accumulator fragment of m64nN: a thread holds rows r and r + 8
// (r = 16 * warp + lane / 4 of its warpgroup's 64) and, for each 8-column
// group j, columns 8 j + 2 (lane % 4) + {0, 1}: element 4 j + 2 h + e is
// (row r + 8 h, column 8 j + 2 (lane % 4) + e).  So each point row is spread
// over the 4 lanes that share lane / 4.

// The closure rule of replica_kernel on the two products X.c_j and c_b.c_j.
template <int NE>
struct ReplicaEpilogue {
  static constexpr int kOps = 2;
  struct Params {
    const int* base;
    const float* db;
    const float* x2;
    const float* cn2;
    int* out_idx;
    float* out_rank;
    int n_extra;
    float bt, lam;
  };
  int b[2];
  float x2[2], cb2[2], db[2], thr[2];
  float v[2][NE];
  int id[2][NE];

  __device__ __forceinline__ void init(const Params& P, const int (&p)[2], int n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b[h] = 0;
      x2[h] = cb2[h] = db[h] = 0.f;
      thr[h] = -INFINITY;  // padding rows admit nothing
      if (p[h] < n) {
        b[h] = P.base[p[h]];
        x2[h] = P.x2[p[h]];
        cb2[h] = P.cn2[b[h]];
        db[h] = P.db[p[h]];
        thr[h] = P.bt * db[h];
      }
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        v[h][t] = INFINITY;
        id[h][t] = kIdNone;
      }
    }
  }

  template <int K>
  __device__ __forceinline__ void tile(const Params& P, const float (&acc)[kOps][K],
                                       const float (&cn2)[K / 2], int c0, int C, int lane) {
    // Few pairs pass D < bt*db (the base's own column and a handful of
    // neighbours per point): test that branch-free first, and walk the
    // closure and the inserts only when one does.
    bool any = false;
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          any |= fmaxf((cn2[2 * j + e] + x2[h]) - 2.f * acc[0][4 * j + 2 * h + e], 0.f) < thr[h];
    if (!any) return;
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * (lane & 3) + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float D = fmaxf((cn2[2 * j + e] + x2[h]) - 2.f * acc[0][4 * j + 2 * h + e], 0.f);
          const float CC = fmaxf((cn2[2 * j + e] + cb2[h]) - 2.f * acc[1][4 * j + 2 * h + e], 0.f);
          if (col < C && D < thr[h] && CC >= D && col != b[h]) {
            float rank = D;
            if (P.lam != 0.f) {
              const float rd = 0.5f * ((db[h] + D) - CC);
              rank = D + (P.lam * rd * rd) / fmaxf(db[h], 1e-30f);
            }
            insert<NE>(v[h], id[h], rank, col);
          }
        }
      }
  }

  __device__ __forceinline__ void finish(const Params& P, const int (&p)[2], int n, int lane) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ov[NE];
        int oi[NE];
#pragma unroll
        for (int t = 0; t < NE; ++t) {
          ov[t] = __shfl_xor_sync(0xffffffffu, v[h][t], off);
          oi[t] = __shfl_xor_sync(0xffffffffu, id[h][t], off);
        }
#pragma unroll
        for (int t = 0; t < NE; ++t) insert<NE>(v[h], id[h], ov[t], oi[t]);
      }
    if ((lane & 3) != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p[h] >= n) continue;
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        if (t >= P.n_extra) break;
        const bool found = v[h][t] < INFINITY;
        P.out_rank[(size_t)p[h] * P.n_extra + t] = found ? v[h][t] : INFINITY;
        P.out_idx[(size_t)p[h] * P.n_extra + t] = found ? id[h][t] : -1;
      }
    }
  }
};

// The running argmin of nearest_kernel on the one product X.c_j.
struct NearestEpilogue {
  static constexpr int kOps = 1;
  struct Params {
    const float* x2;
    const float* cn2;
    int* out_idx;
    float* out_dist;
  };
  float x2[2], v[2];
  int id[2];

  __device__ __forceinline__ void init(const Params& P, const int (&p)[2], int n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x2[h] = p[h] < n ? P.x2[p[h]] : 0.f;
      v[h] = INFINITY;
      id[h] = kIdNone;
    }
  }

  template <int K>
  __device__ __forceinline__ void tile(const Params& P, const float (&acc)[kOps][K],
                                       const float (&cn2)[K / 2], int c0, int C, int lane) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * (lane & 3) + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float D = fmaxf((cn2[2 * j + e] + x2[h]) - 2.f * acc[0][4 * j + 2 * h + e], 0.f);
          if (col < C && before(D, col, v[h], id[h])) {
            v[h] = D;
            id[h] = col;
          }
        }
      }
  }

  __device__ __forceinline__ void finish(const Params& P, const int (&p)[2], int n, int lane) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float ov = __shfl_xor_sync(0xffffffffu, v[h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, id[h], off);
        if (before(ov, oi, v[h], id[h])) {
          v[h] = ov;
          id[h] = oi;
        }
      }
    if ((lane & 3) != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (p[h] < n) {
        P.out_idx[p[h]] = id[h];
        P.out_dist[p[h]] = v[h];
      }
  }
};

// One block: kTcBM points (64 per consumer warpgroup) against every centroid
// in ascending-id tiles of TileN.  One thread of the producer warpgroup
// issues the TMA copies: the point-side slices once (resident) or with each
// centroid slice
// (streamed), each centroid tile as `slices` 64-column slices through a
// ring of `stages` buffers (full barriers: bytes landed; empty barriers: the
// consumer warps are done).  Each consumer warpgroup multiplies its 64
// rows by the slice (kOps products sharing the B tile), waits, releases the
// buffer, and after the tile's last slice runs the epilogue on its registers.
template <class Epi, int TileN>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_cb, const TcShape sh,
          const typename Epi::Params P) {
  constexpr int kOps = Epi::kOps;
  constexpr uint32_t kBBytes = TileN * kRowBytes;  // a centroid slice
  constexpr uint32_t kABytes = kTcBM * kRowBytes;  // a point-side slice
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], a_ready;
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B.
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = smem + (sh.resident ? kOps * sh.slices * kABytes : 0u);
  const uint32_t stage_bytes = kBBytes + (sh.resident ? 0u : kOps * kABytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kTcBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kTcWarps);
    }
    mbar_init(smem_u32(&a_ready), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTcWarps) {  // producer warpgroup; one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kTcWarps || lane != 0) return;
    const CUtensorMap* amap[2] = {&map_x, &map_cb};
    if (sh.resident) {
      const uint32_t bar = smem_u32(&a_ready);
      mbar_expect_tx(bar, kOps * sh.slices * kABytes);
      for (int op = 0; op < kOps; ++op)
        for (int s = 0; s < sh.slices; ++s)
          tma_load(smem + (op * sh.slices + s) * kABytes, amap[op], bar, s * kSliceCols, p0);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < sh.C; c0 += TileN)
      for (int s = 0; s < sh.slices; ++s) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);  // the first round passes
        const uint32_t dst = ring + stage * stage_bytes, bar = smem_u32(&full[stage]);
        mbar_expect_tx(bar, stage_bytes);
        tma_load(dst, &map_c, bar, s * kSliceCols, c0);
        if (!sh.resident)
          for (int op = 0; op < kOps; ++op)
            tma_load(dst + kBBytes + op * kABytes, amap[op], bar, s * kSliceCols, p0);
        if (++stage == sh.stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    return;
  }

  // Consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r = p0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int p[2] = {r, r + 8};
  Epi epi;
  epi.init(P, p, sh.n);
  if (sh.resident) mbar_wait(smem_u32(&a_ready), 0);
  const uint32_t wg_rows = wg * 64 * kRowBytes;  // this warpgroup's rows of a point-side slice
  float acc[kOps][TileN / 2];
#pragma unroll
  for (int op = 0; op < kOps; ++op)
#pragma unroll
    for (int i = 0; i < TileN / 2; ++i) acc[op][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int c0 = 0; c0 < sh.C; c0 += TileN) {
    // |c|^2 of this thread's columns, loaded together before the products
    // so their latency hides behind them (past C: any valid row, masked).
    float cn2[TileN / 4];
#pragma unroll
    for (int j = 0; j < TileN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        cn2[2 * j + e] = __ldg(P.cn2 + min(c0 + 8 * j + 2 * (lane & 3) + e, sh.C - 1));
    for (int s = 0; s < sh.slices; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t bsl = ring + stage * stage_bytes;
      uint32_t asl[kOps];
#pragma unroll
      for (int op = 0; op < kOps; ++op)
        asl[op] = wg_rows + (sh.resident ? smem + (op * sh.slices + s) * kABytes
                                         : bsl + kBBytes + op * kABytes);
#pragma unroll
      for (int op = 0; op < kOps; ++op) fence_regs(acc[op]);
      wgmma_fence();
      // Every k-step of the slice: columns past d read as zero.  (Skipping
      // them under a run-time test makes ptxas serialize the wgmmas.)
#pragma unroll
      for (int k = 0; k < kSliceCols / 16; ++k) {
        const uint64_t bdesc = sw128_desc(bsl + 32 * k);
#pragma unroll
        for (int op = 0; op < kOps; ++op)
          Mma<TileN>::run(acc[op], sw128_desc(asl[op] + 32 * k), bdesc, (s > 0 || k > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int op = 0; op < kOps; ++op) fence_regs(acc[op]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
      if (++stage == sh.stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    epi.tile(P, acc, cn2, c0, sh.C, lane);
  }
  epi.finish(P, p, sh.n, lane);
}

// X (n, d) and, for two products, Cb (n, d); cents (C, d); bf16, d a
// multiple of 16, 16-byte aligned rows.
template <class Epi, int TileN>
cudaError_t launch_tc(const void* X, const void* Cb, const void* cents, int n, int C, int d,
                      const typename Epi::Params& P, cudaStream_t s) {
  constexpr int kOps = Epi::kOps;
  const int slices = (d + kSliceCols - 1) / kSliceCols;
  const int a_bytes = kOps * slices * kTcBM * kRowBytes;
  const int b_bytes = TileN * kRowBytes;
  const bool resident = a_bytes + kMinStages * b_bytes <= kSmemBudget;
  const int stage_bytes = b_bytes + (resident ? 0 : kOps * kTcBM * kRowBytes);
  const int fit = (kSmemBudget - (resident ? a_bytes : 0)) / stage_bytes;
  const int stages = fit < kMaxStages ? fit : kMaxStages;
  const int smem = (resident ? a_bytes : 0) + stages * stage_bytes + 1024;
  CUtensorMap mc, mx, mb;
  cudaError_t err = make_map(&mc, cents, kBf16Map, 2, C, d, TileN);
  if (err == cudaSuccess) err = make_map(&mx, X, kBf16Map, 2, n, d, kTcBM);
  if (err == cudaSuccess) err = make_map(&mb, kOps > 1 ? Cb : X, kBf16Map, 2, n, d, kTcBM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tc_kernel<Epi, TileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const TcShape sh{n, C, slices, stages, resident ? 1 : 0};
  const unsigned grid = (unsigned)((n + kTcBM - 1) / kTcBM);
  tc_kernel<Epi, TileN><<<grid, kTcThreads, smem, s>>>(mc, mx, mb, sh, P);
  return cudaGetLastError();
}

// One warp per row: db[r] = max((|x_r|^2 + |c_b|^2) - 2 x_r.c_b, 0), the
// expansion the tiles use (the reference's dot_general of X and Cb).
__global__ void base_dist_kernel(const uint16_t* __restrict__ X, const int* __restrict__ base,
                                 const uint16_t* __restrict__ cents, const float* __restrict__ x2,
                                 const float* __restrict__ cn2, int n, int d,
                                 float* __restrict__ db) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n) return;  // whole warps leave together
  const int b = base[r];
  float acc = 0.f;
  for (int k = lane; k < d; k += 32)
    acc = fmaf(BF16::get(X, (size_t)r * d + k), BF16::get(cents, (size_t)b * d + k), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) db[r] = fmaxf((x2[r] + cn2[b]) - 2.f * acc, 0.f);
}

template <int NE>
cudaError_t launch_replica_tc(const void* X, const void* Cb, const void* cents, const int* base,
                              float* db, bool db_given, float* x2, float* cn2, int* oi,
                              float* orank, int n, int C, int d, int n_extra, float bt, float lam,
                              cudaStream_t s) {
  constexpr int kWarpsPerBlock = 8;
  const unsigned grid = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (!db_given) {
    base_dist_kernel<<<grid, 32 * kWarpsPerBlock, 0, s>>>(static_cast<const uint16_t*>(X), base,
                                                          static_cast<const uint16_t*>(cents), x2,
                                                          cn2, n, d, db);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const typename ReplicaEpilogue<NE>::Params P{base, db, x2, cn2, oi, orank, n_extra, bt, lam};
  return launch_tc<ReplicaEpilogue<NE>, kReplicaBN>(X, Cb, cents, n, C, d, P, s);
}

}  // namespace

// X (n, d) and cents (C, d): bf16 ? bfloat16 : float32, row-major (bf16: d a
// multiple of 16, rows 16-byte aligned).  x2 (n,), cn2 (C,) f32 scratch.
// out_idx (n,) i32, out_dist (n,) f32.
extern "C" int spf_nearest_centroid(const void* X, const void* cents, void* x2, void* cn2,
                                    void* out_idx, void* out_dist, int n, int C, int d, int bf16,
                                    void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || d <= 0 || (bf16 && d % 16 != 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x2p = static_cast<float*>(x2);
  float* cn2p = static_cast<float*>(cn2);
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  if (!bf16) return (int)launch_nearest<F32>(X, cents, x2p, cn2p, oi, od, n, C, d, s);
  const cudaError_t err = sqnorms<BF16>(X, n, cents, C, d, x2p, cn2p, s);
  if (err != cudaSuccess) return (int)err;
  const NearestEpilogue::Params P{x2p, cn2p, oi, od};
  return (int)launch_tc<NearestEpilogue, kNearestBN>(X, nullptr, cents, n, C, d, P, s);
}

// X (n, d) and cents (C, d): bf16 ? bfloat16 : float32, row-major.  base (n,)
// i32 in [0, C).  Cb (n, d) = cents[base], bf16 only (null for f32).  db
// (n,) f32: dist(p, c_base) when db_given, else scratch the kernel fills.
// x2 (n,), cn2 (C,) f32 scratch.  out_idx (n, n_extra) i32, out_rank
// (n, n_extra) f32.  bf16: d a multiple of 16, rows 16-byte aligned.
extern "C" int spf_replica_topk(const void* X, const void* base, const void* cents,
                                const void* Cb, void* db, int db_given, void* x2, void* cn2,
                                void* out_idx, void* out_rank, int n, int C, int d, int n_extra,
                                float bt, float lam, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (n_extra < 1 || n_extra > 8 || d <= 0) return (int)cudaErrorInvalidValue;
  if (bf16 && (d % 16 != 0 || Cb == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(base);
  float* dbp = static_cast<float*>(db);
  float* x2p = static_cast<float*>(x2);
  float* cn2p = static_cast<float*>(cn2);
  int* oi = static_cast<int*>(out_idx);
  float* orank = static_cast<float*>(out_rank);
  if (!bf16)
    return (int)launch_all<F32>(X, b, cents, db_given ? dbp : nullptr, x2p, cn2p, oi, orank, n, C,
                                d, n_extra, bt, lam, s);
  const cudaError_t err = sqnorms<BF16>(X, n, cents, C, d, x2p, cn2p, s);
  if (err != cudaSuccess) return (int)err;
  // The running list is the next power of two >= n_extra, as in launch_all.
  const bool given = db_given != 0;
  if (n_extra <= 1)
    return (int)launch_replica_tc<1>(X, Cb, cents, b, dbp, given, x2p, cn2p, oi, orank, n, C, d,
                                     n_extra, bt, lam, s);
  if (n_extra <= 2)
    return (int)launch_replica_tc<2>(X, Cb, cents, b, dbp, given, x2p, cn2p, oi, orank, n, C, d,
                                     n_extra, bt, lam, s);
  if (n_extra <= 4)
    return (int)launch_replica_tc<4>(X, Cb, cents, b, dbp, given, x2p, cn2p, oi, orank, n, C, d,
                                     n_extra, bt, lam, s);
  return (int)launch_replica_tc<8>(X, Cb, cents, b, dbp, given, x2p, cn2p, oi, orank, n, C, d,
                                   n_extra, bt, lam, s);
}
