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
// What bounds it on Hopper: the bytes of the probed slabs.  A (query,
// probe) pair does 2-3 f32 operations per slab element, far below the
// ~300 operations per byte an H100 needs before its ALUs, not HBM, are
// the limit; so the least time is every probed slab read once.  Many
// pairs of a batch probe the same slab (queries near one another pick
// the same postings), so a kernel that reads a slab per pair moves
// several times the bytes it needs.
//
// What the design does about it:
// - Slab-major schedule.  A counting sort groups the Q * nprobe pairs by
//   slab (histogram, one-block scan, scatter) and cuts each slab's pairs
//   into work items of at most kGroup; a hot posting becomes several
//   items, so skewed rows still spread over the SMs.
//   ops/rerank.py::rerank_schedule is the same index logic on the CPU.
// - One read of the slab per item.  Persistent blocks take items from a
//   counter.  In each, a producer warp streams the item's slab through a
//   ring of up to kMaxStages row tiles in shared memory: a tile is whole
//   slab rows, contiguous in memory, so one 1-D cp.async.bulk fills it
//   and counts its bytes on the stage's full mbarrier (no tensor map, no
//   registers spent on the copy), and the consumer warps release it on
//   its empty mbarrier.  The producer also stages the next item's pairs
//   and query rows in a second buffer, so an item's start-up latency
//   hides behind the previous item's work.  Tiles of 16 KB (16 rows past
//   1 KB a row) and a 3-deep ring leave room for 3 blocks an SM at d_pad
//   128.
// - The item's query rows (f32; int8: its centered rows and scales) sit
//   in shared memory.  `lanes` threads share a slab row; each converts a
//   16-byte chunk of it to f32 once and runs the item's pairs over it in
//   passes of 16, 8, 4, 2 and 1 (the bits of the count, each pass a fixed
//   number of accumulators, fully unrolled), reading the matching query
//   chunks from shared memory.  The rows of a warp read the same query
//   values (a broadcast), and the query rows are stored in planes so the
//   lanes of a row read consecutive bytes.  The sums are reduced over a
//   row's lanes with shuffles.  A (pair, row) distance is summed in the
//   same order whatever the grouping, so the result does not depend on
//   the schedule.
// - Wide rows.  When kGroup query rows (twice, for the prefetch) and a
//   2-stage ring of whole rows do not fit a block's shared memory (past
//   d_pad ~1,200 for f32 slabs, ~1,450 bf16, ~1,600 int8), the row is cut
//   into `slices` column slices of `width` elements and an item runs once
//   per slice: its query rows are staged a slice at a time, a tile is
//   `rows` row slices (one bulk copy each), and slices after the first
//   fold into the distances the same thread wrote for the slice before.
//   So every d_pad runs, each probed slab still read once per item.
// - int8 codes become f32 by the exact magic-number form (a byte
//   permute into the mantissa of 2^23 and one subtraction), not by
//   I2F, which issues at a quarter of the f32 rate.  The dequantizing
//   multiply s_j * r stays a separately rounded __fmul_rn per pair, so
//   nvcc cannot contract it into an FMA: the kernel rounds as the plain
//   version does.
//
// Pairs whose slab index is out of range form no item; the blocks past
// the last item write their distances as NaN instead of reading outside
// the slab array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "slab_ring.cuh"  // kGroup, kMaxSmem, the mbarrier and bulk-copy helpers

constexpr int kThreads = 256;
constexpr int kMaxStages = 3;     // depth of the shared-memory ring

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

// 16 bytes of a slab row as kVals f32 values.
struct F32 {
  static constexpr int kVals = 4;
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
// Flipping the sign bits maps code c to the byte c + 128; permuted under
// the exponent byte 0x4B it is the f32 2^23 + c + 128, and subtracting
// 2^23 + 128 leaves exactly c.
struct I8 {
  static constexpr int kVals = 16;
  static constexpr bool kQuantized = true;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                           r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | b)) - 8388736.0f;
  }
};

// Tile geometry for slab rows of d_pad elements of `esize` bytes, taken in
// `slices` column slices of `width` elements (the last may be narrower; one
// slice, of the whole row, whenever that fits).  A tile is the rows =
// kThreads / lanes row slices the block covers at once, `lanes` threads to
// a row: the fewest lanes whose tile fits 16 KB, or 16 rows when a row
// slice is longer than 1 KB.  The rows of one warp read the same query
// values (32 / lanes rows share each shared-memory read), so at least 2
// rows share them even at d_pad 1,024.  Shared memory holds the ring of
// `stages` tiles (2 to kMaxStages) and two buffers of kGroup f32 query
// row slices.
struct Geometry {
  int width, slices, lanes, rows, row_bytes, srow_bytes, tile_bytes, qbytes, stages, smem;
};

inline Geometry slice_geometry(int d_pad, int esize, int width) {
  Geometry g;
  g.width = width;
  g.slices = (d_pad + width - 1) / width;
  g.row_bytes = d_pad * esize;
  g.srow_bytes = width * esize;
  g.qbytes = kGroup * width * (int)sizeof(float);  // one item's query row slices
  const int tile_max = 16 * g.srow_bytes > 16384 ? 16 * g.srow_bytes : 16384;
  g.lanes = 1;
  while (g.lanes < 16 && (kThreads / g.lanes) * g.srow_bytes > tile_max) g.lanes *= 2;
  for (;;) {  // two query buffers and at least two stages, or more lanes to a row
    g.rows = kThreads / g.lanes;
    g.tile_bytes = g.rows * g.srow_bytes;
    g.stages = (kMaxSmem - 2 * g.qbytes) / g.tile_bytes;
    if (g.stages >= 2 || g.lanes == 32) break;
    g.lanes *= 2;
  }
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = g.stages * g.tile_bytes + 2 * g.qbytes;
  return g;
}

// The fewest slices that fit, each a whole number of 16-byte chunks.
inline Geometry geometry(int d_pad, int esize) {
  const int vals = 16 / esize;
  Geometry g = slice_geometry(d_pad, esize, d_pad);
  for (int s = 2; g.stages < 2 && s <= d_pad / vals; ++s) {
    const int per = (d_pad + s - 1) / s;
    g = slice_geometry(d_pad, esize, (per + vals - 1) / vals * vals);
  }
  return g;
}

// ---------------------------------------------------------------------------
// The slab-major schedule: a counting sort of the P pairs by slab.
//   hist:    hist[s] = pairs on slab s (out-of-range slabs are not counted)
//   scan:    offs[s] = first position of slab s in `order`; a slab of c pairs
//            gets ceil(c / kGroup) work items {slab, first position, count};
//            totals = {items, in-range pairs, 0 (the rerank's item counter)};
//            hist is zeroed as the cursor
//   scatter: order[offs[s] + cursor[s]++] = pair; out-of-range pairs after
//            the in-range ones (position totals[1] + cursor[cpad]++)
// A slab's pairs land in any order (atomics); the distances do not depend
// on it.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;  // slabs per thread per step of the scan

__global__ void schedule_hist_kernel(const int* __restrict__ rows, int* __restrict__ hist, int P,
                                     int cpad) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    const int r = rows[i];
    if (r >= 0 && r < cpad) atomicAdd(hist + r, 1);
  }
}

// One block: exclusive scans of the pair counts and of the item counts over
// the cpad slabs, kScanThreads * kScanPer slabs a step, and the item list.
__global__ void __launch_bounds__(kScanThreads)
schedule_scan_kernel(int* __restrict__ hist, int* __restrict__ offs, int4* __restrict__ items,
                     int* __restrict__ totals, int cpad) {
  __shared__ int wsum[2][32];
  __shared__ int carry[2];
  __shared__ int sh[kScanThreads * kScanPer];  // one step's counts, then offsets
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry[0] = carry[1] = 0;
  for (int base = 0; base < cpad; base += kScanThreads * kScanPer) {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {  // coalesced
      const int i = base + k * kScanThreads + tid;
      sh[k * kScanThreads + tid] = i < cpad ? hist[i] : 0;
    }
    __syncthreads();
    int c[kScanPer], a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {  // thread tid scans slabs base + tid * kScanPer + k
      c[k] = sh[tid * kScanPer + k];
      a += c[k];
      b += (c[k] + kGroup - 1) / kGroup;
    }
    int ia = a, ib = b;  // inclusive scans within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, ia, off);
      const int y = __shfl_up_sync(0xffffffffu, ib, off);
      if (lane >= off) ia += x, ib += y;
    }
    if (lane == 31) wsum[0][warp] = ia, wsum[1][warp] = ib;
    __syncthreads();
    if (warp == 0) {
      int wa = wsum[0][lane], wb = wsum[1][lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, wa, off);
        const int y = __shfl_up_sync(0xffffffffu, wb, off);
        if (lane >= off) wa += x, wb += y;
      }
      wsum[0][lane] = wa, wsum[1][lane] = wb;
    }
    __syncthreads();
    int pa = carry[0] + (warp ? wsum[0][warp - 1] : 0) + ia - a;
    int pb = carry[1] + (warp ? wsum[1][warp - 1] : 0) + ib - b;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = base + tid * kScanPer + k;
      for (int f = 0; f < c[k]; f += kGroup)
        items[pb++] = make_int4(i, pa + f, min(kGroup, c[k] - f), 0);
      sh[tid * kScanPer + k] = pa;
      pa += c[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {  // coalesced
      const int i = base + k * kScanThreads + tid;
      if (i < cpad) offs[i] = sh[k * kScanThreads + tid], hist[i] = 0;
    }
    if (tid == 0) carry[0] += wsum[0][31], carry[1] += wsum[1][31];
    __syncthreads();
  }
  if (tid == 0) {
    offs[cpad] = carry[0];
    hist[cpad] = 0;
    totals[0] = carry[1];
    totals[1] = carry[0];
    totals[2] = 0;
  }
}

__global__ void schedule_scatter_kernel(const int* __restrict__ rows, const int* __restrict__ offs,
                                        int* __restrict__ cursor, int* __restrict__ order, int P,
                                        int cpad) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    int r = rows[i];
    if (r < 0 || r >= cpad) r = cpad;
    order[offs[r] + atomicAdd(cursor + r, 1)] = i;
  }
}

// ---------------------------------------------------------------------------
// The distances.
// ---------------------------------------------------------------------------

// One pass of NG pairs (g0 .. g0 + NG - 1 of the item) over one tile row
// (slice): each lane walks its 16-byte chunks of the row, converts each to
// f32 once and accumulates it against the NG query chunks, read from
// shared memory in planes (float4 e of chunk c at e * chunks + c of the
// pair's qstride float4s), so the lanes of a row read consecutive 16
// bytes.  Then the row's lanes reduce with shuffles and lane (g & (lanes -
// 1)) writes pair g's distance, or folds it into the earlier slices' when
// `fold`.
template <typename S, int M, int NG>
__device__ __forceinline__ void pair_pass(const uint4* row_chunks, const float4* qs4,
                                          const float* scale_s, const int* pair_s, int g0,
                                          int lane, int lanes, int chunks, int qstride, bool fold,
                                          bool live, int row, int pad, float* __restrict__ out) {
  constexpr int V = S::kVals, E = V / 4;
  float acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.f;
  if (live) {
    for (int c = lane; c < chunks; c += lanes) {
      float v[V];
      S::unpack(row_chunks[c], v);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float sc = S::kQuantized ? scale_s[g0 + g] : 1.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float4 q = qs4[(g0 + g) * qstride + e * chunks + c];
          const float x0 = S::kQuantized ? __fmul_rn(v[4 * e + 0], sc) : v[4 * e + 0];
          const float x1 = S::kQuantized ? __fmul_rn(v[4 * e + 1], sc) : v[4 * e + 1];
          const float x2 = S::kQuantized ? __fmul_rn(v[4 * e + 2], sc) : v[4 * e + 2];
          const float x3 = S::kQuantized ? __fmul_rn(v[4 * e + 3], sc) : v[4 * e + 3];
          acc[g] = accumulate<M>(acc[g], x0 - q.x);
          acc[g] = accumulate<M>(acc[g], x1 - q.y);
          acc[g] = accumulate<M>(acc[g], x2 - q.z);
          acc[g] = accumulate<M>(acc[g], x3 - q.w);
        }
      }
    }
  }
  // Uniform across the block (lanes), so every shuffle runs with all 32
  // lanes of each warp present; a row's lanes are aligned in a warp.
#pragma unroll
  for (int g = 0; g < NG; ++g)
    for (int off = lanes >> 1; off > 0; off >>= 1)
      acc[g] = combine<M>(acc[g], __shfl_xor_sync(0xffffffffu, acc[g], off));
  if (live) {
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (((g0 + g) & (lanes - 1)) == lane) {
        float* o = out + (size_t)pair_s[g0 + g] * pad + row;
        *o = fold ? combine<M>(*o, acc[g]) : acc[g];
      }
  }
}

// One unit's metadata (an item's slice), written by the producer warp
// before it releases the unit's query buffer to the consumers.
struct ItemMeta {
  int cnt;     // < 0: no more items
  int slice;   // the column slice
  int chunks;  // 16-byte chunks in a row of the slice
  int pair[kGroup];
  float scale[kGroup];
};

static_assert(2 * sizeof(ItemMeta) + (2 * kMaxStages + 4) * sizeof(uint64_t) <= 1024,
              "the kernel's static shared memory fits the 1 KB kMaxSmem leaves");

constexpr int kConsumers = kThreads / 32;  // consumer warps
constexpr int kBlock = kThreads + 32;      // and one producer warp

// A persistent block: warp 0 produces, warps 1..kConsumers consume.  A
// unit is one column slice of a work item (the whole item when the
// geometry has one slice); a block runs all slices of the items it takes.
//   producer: per unit, waits for the unit's query buffer (two,
//     alternating) to be released; at an item's first slice takes the
//     next item from the counter totals[2]; writes the pairs and scales
//     and copies the query row slices (in planes) into the buffer,
//     releases it (qfull), then feeds the slab's row slices into the
//     ring, each stage as soon as the consumers have released it
//     (empty).  So the next unit's query rows and first tiles are in
//     flight while the consumers finish the current one.
//   consumers: per unit, wait for its buffer, run each tile as it lands
//     (full), release the stage, and release the buffer at the end.
// order (P,): the pairs (q * nprobe + j) sorted by slab, the totals[1]
// in-range ones first; items: {slab, first position, count} of each work
// item; totals = {items, in-range pairs, item counter (0)}.  After the
// items, the consumers write the NaN rows of the out-of-range pairs.
template <typename S, int M>
__global__ void __launch_bounds__(kBlock)
rerank_kernel(const float* __restrict__ queries, const float* __restrict__ scales,
              const unsigned char* __restrict__ slabs, const int* __restrict__ order,
              const int4* __restrict__ items, int* __restrict__ totals,
              float* __restrict__ out, const Geometry geo, int P, int nprobe, int pad,
              int d_pad) {
  constexpr int V = S::kVals, E = V / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], qfull[2], qempty[2];
  __shared__ ItemMeta meta[2];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (pad + geo.rows - 1) / geo.rows;
  const int qstride = geo.width / 4;  // float4s of a pair's query slice in a buffer
  float4* qbuf = reinterpret_cast<float4*>(smem + geo.stages * geo.tile_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(qfull + b), 1);
      mbar_init(smem_u32(qempty + b), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // producer
    const int n_items = totals[0];
    int seq = 0;  // tiles issued, over all units
    int slice = geo.slices, cnt = 0, pair = 0;
    float scale = 0.f;
    int4 item = make_int4(0, 0, 0, 0);  // {slab, first position, count}
    for (int k = 0;; ++k) {
      const int b = k & 1;
      mbar_wait(smem_u32(qempty + b), (uint32_t)(((k >> 1) & 1) ^ 1));  // the first round passes
      ItemMeta& m = meta[b];
      if (slice == geo.slices) {  // the next item
        int it = 0;
        if (lane == 0) it = atomicAdd(totals + 2, 1);
        it = __shfl_sync(0xffffffffu, it, 0);
        if (it >= n_items) {
          if (lane == 0) {
            m.cnt = -1;
            mbar_arrive(smem_u32(qfull + b));
          }
          return;
        }
        item = items[it];
        cnt = item.z;
        slice = 0;
        if (lane < cnt) {
          pair = order[item.y + lane];
          if (S::kQuantized) scale = scales[pair];
        }
      }
      const int col0 = slice * geo.width;  // the slice's first element
      const int wid = min(geo.width, d_pad - col0);
      const int chunks = wid / V;
      if (lane < cnt) {
        m.pair[lane] = pair;
        if (S::kQuantized) m.scale[lane] = scale;
      }
      if (lane == 0) m.cnt = cnt, m.slice = slice, m.chunks = chunks;
      __syncwarp();
      // Query row slices (the float path: query q of pair q * nprobe + j;
      // int8: the pair's own centered row) in planes: float4 f of a slice
      // (chunk f / E, plane f % E) goes to (f % E) * chunks + f / E.
      float4* q = qbuf + b * (kGroup * qstride);
      const int vec = wid / 4;
#pragma unroll 4
      for (int i = lane; i < cnt * vec; i += 32) {
        const int g = i / vec;
        const int f = i - g * vec;
        const int p = m.pair[g];
        const float4* row = reinterpret_cast<const float4*>(
            queries + (size_t)(S::kQuantized ? p : p / nprobe) * d_pad + col0);
        q[g * qstride + (f % E) * chunks + f / E] = __ldg(row + f);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(qfull + b));  // releases the stores above
      if (lane == 0) {
        const unsigned char* slab = slabs + (size_t)item.x * pad * geo.row_bytes;
        const int sbytes = wid * (16 / V);  // bytes of a row slice
        for (int t = 0; t < ntiles; ++t, ++seq) {
          const int stage = seq % geo.stages;
          mbar_wait(smem_u32(empty + stage), (uint32_t)(((seq / geo.stages) & 1) ^ 1));
          const int rows = min(geo.rows, pad - t * geo.rows);
          const uint32_t bar = smem_u32(full + stage);
          const uint32_t dst = smem_u32(smem + stage * geo.tile_bytes);
          mbar_expect_tx(bar, (uint32_t)(rows * sbytes));
          if (geo.slices == 1) {  // whole rows: the tile is contiguous
            bulk_load(dst, slab + (size_t)t * geo.tile_bytes, (uint32_t)(rows * sbytes), bar);
          } else {
            const unsigned char* src =
                slab + (size_t)t * geo.rows * geo.row_bytes + col0 * (16 / V);
            for (int r = 0; r < rows; ++r)
              bulk_load(dst + r * geo.srow_bytes, src + (size_t)r * geo.row_bytes,
                        (uint32_t)sbytes, bar);
          }
        }
      }
      seq = __shfl_sync(0xffffffffu, seq, 0);
      ++slice;
    }
  }

  // consumers
  const int tid = threadIdx.x - 32;
  const int lanes = geo.lanes;
  const int rl = tid & (lanes - 1);  // lane within the row
  const int slot = tid / lanes;
  int seq = 0;
  for (int k = 0;; ++k) {
    const int b = k & 1;
    mbar_wait(smem_u32(qfull + b), (uint32_t)((k >> 1) & 1));
    const ItemMeta& m = meta[b];
    const int cnt = m.cnt;
    if (cnt < 0) break;
    const int chunks = m.chunks;
    const bool fold = m.slice > 0;
    const float4* qs4 = qbuf + b * (kGroup * qstride);
    for (int t = 0; t < ntiles; ++t, ++seq) {
      const int stage = seq % geo.stages;
      mbar_wait(smem_u32(full + stage), (uint32_t)((seq / geo.stages) & 1));
      const int row = t * geo.rows + slot;
      const uint4* r = reinterpret_cast<const uint4*>(smem + stage * geo.tile_bytes +
                                                      slot * geo.srow_bytes);
      const bool live = row < pad;
      // The item's pairs in passes of 16, 8, 4, 2 and 1 (the bits of cnt):
      // each pass is unrolled over a fixed number of accumulators.
      int g0 = 0;
      if (cnt & 16) {
        pair_pass<S, M, 16>(r, qs4, m.scale, m.pair, g0, rl, lanes, chunks, qstride, fold, live,
                            row, pad, out);
        g0 += 16;
      }
      if (cnt & 8) {
        pair_pass<S, M, 8>(r, qs4, m.scale, m.pair, g0, rl, lanes, chunks, qstride, fold, live,
                           row, pad, out);
        g0 += 8;
      }
      if (cnt & 4) {
        pair_pass<S, M, 4>(r, qs4, m.scale, m.pair, g0, rl, lanes, chunks, qstride, fold, live,
                           row, pad, out);
        g0 += 4;
      }
      if (cnt & 2) {
        pair_pass<S, M, 2>(r, qs4, m.scale, m.pair, g0, rl, lanes, chunks, qstride, fold, live,
                           row, pad, out);
        g0 += 2;
      }
      if (cnt & 1)
        pair_pass<S, M, 1>(r, qs4, m.scale, m.pair, g0, rl, lanes, chunks, qstride, fold, live,
                           row, pad, out);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + stage));  // this warp is done with the stage
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(qempty + b));
  }
  // NaN rows for the out-of-range pairs, positions totals[1] .. P - 1.
  for (int pos = totals[1] + blockIdx.x; pos < P; pos += gridDim.x) {
    float* o = out + (size_t)order[pos] * pad;
    for (int r = tid; r < pad; r += kThreads) o[r] = __int_as_float(0x7fc00000);
  }
}

// The kernel of (slab type, metric).
template <typename S>
const void* kernel_for(int metric) {
  switch (metric) {
    case kEuclidean:
      return reinterpret_cast<const void*>(rerank_kernel<S, kEuclidean>);
    case kManhattan:
      return reinterpret_cast<const void*>(rerank_kernel<S, kManhattan>);
    case kChebyshev:
      return reinterpret_cast<const void*>(rerank_kernel<S, kChebyshev>);
    default:
      return nullptr;
  }
}

const void* kernel_for(int slab_dtype, int metric) {
  switch (slab_dtype) {
    case 0:
      return kernel_for<F32>(metric);
    case 1:
      return kernel_for<BF16>(metric);
    case 2:
      return kernel_for<I8>(metric);
    default:
      return nullptr;
  }
}

int element_size(int slab_dtype) {
  return slab_dtype == 0 ? 4 : slab_dtype == 1 ? 2 : slab_dtype == 2 ? 1 : 0;
}

}  // namespace

// The work-item size and the tile geometry for slabs of d_pad elements of
// slab_dtype (0 float32, 1 bfloat16, 2 int8): out = {group, lanes, rows
// per tile, stages, dynamic shared memory bytes, slice width, slices}.
// Returns cudaErrorInvalidValue if the geometry does not fit a block.
extern "C" int spf_rerank_geometry(int d_pad, int slab_dtype, int* out) {
  const int esize = element_size(slab_dtype);
  if (esize == 0 || d_pad <= 0 || (d_pad * esize) % 16) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(d_pad, esize);
  out[0] = kGroup;
  out[1] = g.lanes;
  out[2] = g.rows;
  out[3] = g.stages;
  out[4] = g.smem;
  out[5] = g.width;
  out[6] = g.slices;
  return g.stages >= 2 && g.smem <= kMaxSmem ? 0 : (int)cudaErrorInvalidValue;
}

// Readies the kernel of (d_pad, slab_dtype, metric) on the current device:
// lets it take a block's whole dynamic shared memory (the attribute is the
// function's, shared by every d_pad, so it is never lowered) and writes to
// *blocks the persistent blocks the card holds at once at this d_pad's
// geometry (occupancy x SMs).  Callers keep the result per device, so a
// launch does none of this.
extern "C" int spf_rerank_prepare(int d_pad, int slab_dtype, int metric, int* blocks) {
  const int esize = element_size(slab_dtype);
  const void* fn = kernel_for(slab_dtype, metric);
  if (esize == 0 || fn == nullptr || d_pad <= 0 || (d_pad * esize) % 16)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(d_pad, esize);
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock, g.smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// The schedule of the P pairs of ``rows`` (int32, flat q * nprobe + j) over
// cpad slabs: order (P,), items (n_slots, 4) {slab, first position, count,
// 0}, totals {items, in-range pairs, 0}; hist and offs are cpad + 1 ints of
// workspace.  n_slots bounds the item count, so the scan's writes stay in
// ``items``.
extern "C" int spf_rerank_schedule(const void* rows, void* order, void* items, void* totals,
                                   void* hist, void* offs, int P, int cpad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)(cpad + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = P > 256 * 132 * 8 ? 132 * 8 : P > 0 ? (P + 255) / 256 : 1;
  const int* r = static_cast<const int*>(rows);
  int* h = static_cast<int*>(hist);
  int* o = static_cast<int*>(offs);
  schedule_hist_kernel<<<blocks, 256, 0, s>>>(r, h, P, cpad);
  schedule_scan_kernel<<<1, kScanThreads, 0, s>>>(h, o, static_cast<int4*>(items),
                                                  static_cast<int*>(totals), cpad);
  schedule_scatter_kernel<<<blocks, 256, 0, s>>>(r, o, h, static_cast<int*>(order), P, cpad);
  return (int)cudaGetLastError();
}

// metric: 0 Euclidean (squared), 1 Manhattan, 2 Chebyshev.  slab_dtype:
// 0 float32, 1 bfloat16, 2 int8 (then ``queries`` is the (Q, nprobe, d_pad)
// centered block and ``scales`` the (Q, nprobe) scale table; else scales
// is unused).  order, items and totals are the schedule of the P = Q *
// nprobe pairs (spf_rerank_schedule), used once: the kernel counts its
// items off totals[2].  n_slots is the length of items; blocks is what
// spf_rerank_prepare gave for this kernel on this device.  The wrapper
// checks shapes, alignment, contiguity and the geometry.
extern "C" int spf_rerank(const void* queries, const void* scales, const void* vectors3d,
                          const void* order, const void* items, void* totals, void* out,
                          int P, int n_slots, int blocks, int nprobe, int pad, int d_pad,
                          int metric, int slab_dtype, void* stream) {
  if (P <= 0 || pad <= 0) return 0;
  const int esize = element_size(slab_dtype);
  const void* fn = kernel_for(slab_dtype, metric);
  if (esize == 0 || fn == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
  Geometry geo = geometry(d_pad, esize);
  int grid = blocks < n_slots ? blocks : n_slots;
  void* args[] = {&queries, &scales, &vectors3d, &order, &items, &totals, &out,
                  &geo, &P, &nprobe, &pad, &d_pad};
  cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(kBlock), args, (size_t)geo.smem,
                                   static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* spf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
