// Closure-replica top-k: for every corpus point, the n_extra best replica
// clusters under SPANN's boundary-closure rule.
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/replica.py ::
// pallas_replica_topk (_replica_topk_impl, kernel _make_kernel).
//
// For point p with base cluster b, over every centroid j (squared L2 by the
// expansion, clamped >= 0):
//   D  = |c_j|^2 + |p|^2   - 2 c_j.p
//   CC = |c_j|^2 + |c_b|^2 - 2 c_j.c_b
//   admit j  iff  D < bt*db  and  CC >= D  and  j != b      (db = dist(p, c_b))
//   rank = D, or with SOAR  D + lambda * (0.5 (db + D - CC))^2 / max(db, 1e-30)
// and keep the n_extra smallest ranks, ascending, equal ranks to the lower
// centroid id (the tie rule of lax.top_k and of the TPU kernel's
// _select_rounds).  Missing replicas come back as (id -1, rank +inf).
//
// What bounds it on Hopper: arithmetic.  Two dot products per
// (point, centroid) pair, 2*n*C*d fused multiply-adds (2.8e12 at the main
// path's 1M x 10.8k x 128), against ~n*d + (n/64)*C*d bytes read.
//
// What the design does about it: a register-tiled f32 GEMM.  A block owns
// 64 points and walks every centroid in ascending-id tiles of 128, staged
// with the points and their base centroids through shared memory in
// 16-deep slices of d; each thread accumulates a 4-point x 8-centroid block
// of both dot products (64 FMAs per 16 shared-memory reads).  bf16 inputs
// are widened to f32 when staged, so products are exact and sums f32; f32
// inputs run full f32 FMAs (the reference's Precision.HIGHEST).  Squared
// norms come from one pass per row (sqnorm_kernel) into scratch, so |c_j|^2
// is computed once, not per tile.  Each thread keeps its points' running
// top-n_extra in registers with a (rank, id) lexicographic insertion; the 16
// threads that share a point merge their lists with shuffles at the end.
// The (n, C) distance space never reaches device memory.  C is a run-time
// argument; columns past C are masked.  Tensor cores (wgmma) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  using T = typename S::T;
  constexpr int kWarpsPerBlock = 8;
  sqnorm_kernel<S><<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(X), n, d, x2);
  if (C > 0)
    sqnorm_kernel<S><<<(C + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const T*>(cents), C, d, cn2);
  cudaError_t err = cudaGetLastError();
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
// Nearest centroid: the top-1 sibling of replica_kernel.
//
// Replaces the TPU kernel spfresh_tpu/ops/pallas/replica.py ::
// pallas_nearest_centroid (kernel _make_assign_kernel), the out-of-core
// build's base assignment.  For every point p:
//   D_j = max(|c_j|^2 + |p|^2 - 2 c_j.p, 0)
//   base = argmin_j D_j (equal D to the lowest j), db = D_base.
//
// What bounds it on Hopper: arithmetic, 2*n*C*d flops of one dot product
// per (point, centroid) pair against n*d + (n/128)*C*d bytes read.
//
// What the design does about it: replica_kernel's register-tiled f32 GEMM
// with one accumulator instead of two, so a block owns 128 points (8 per
// thread) and each thread does 64 FMAs per four 16-byte shared-memory
// reads; its epilogue keeps one running (D, id) per point in registers with
// the lexicographic order of insert(), merged over the 16 lanes that share
// a point by shuffles.  C is a run-time argument; columns past C are
// masked, so no centroid padding is needed.  Tensor cores are later work.

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
  constexpr int kWarpsPerBlock = 8;
  sqnorm_kernel<S><<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(X), n, d, x2);
  sqnorm_kernel<S><<<(C + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(cents), C, d, cn2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nearest_kernel<S><<<(unsigned)((n + kNBM - 1) / kNBM), NT, 0, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(cents), x2, cn2, oi, od, n, C, d);
  return cudaGetLastError();
}

}  // namespace

// X (n, d) and cents (C, d): bf16 ? bfloat16 : float32, row-major.  x2 (n,),
// cn2 (C,) f32 scratch.  out_idx (n,) i32, out_dist (n,) f32.
extern "C" int spf_nearest_centroid(const void* X, const void* cents, void* x2, void* cn2,
                                    void* out_idx, void* out_dist, int n, int C, int d, int bf16,
                                    void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x2p = static_cast<float*>(x2);
  float* cn2p = static_cast<float*>(cn2);
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  return bf16 ? (int)launch_nearest<BF16>(X, cents, x2p, cn2p, oi, od, n, C, d, s)
              : (int)launch_nearest<F32>(X, cents, x2p, cn2p, oi, od, n, C, d, s);
}

// X (n, d) and cents (C, d): bf16 ? bfloat16 : float32, row-major.  base (n,)
// i32 in [0, C).  db (n,) f32 or null (computed).  x2 (n,), cn2 (C,) f32
// scratch.  out_idx (n, n_extra) i32, out_rank (n, n_extra) f32.
extern "C" int spf_replica_topk(const void* X, const void* base, const void* cents,
                                const void* db, void* x2, void* cn2, void* out_idx,
                                void* out_rank, int n, int C, int d, int n_extra, float bt,
                                float lam, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (n_extra < 1 || n_extra > 8 || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(base);
  const float* dbp = static_cast<const float*>(db);
  float* x2p = static_cast<float*>(x2);
  float* cn2p = static_cast<float*>(cn2);
  int* oi = static_cast<int*>(out_idx);
  float* orank = static_cast<float*>(out_rank);
  return bf16 ? (int)launch_all<BF16>(X, b, cents, dbp, x2p, cn2p, oi, orank, n, C, d, n_extra,
                                      bt, lam, s)
              : (int)launch_all<F32>(X, b, cents, dbp, x2p, cn2p, oi, orank, n, C, d, n_extra,
                                     bt, lam, s);
}
