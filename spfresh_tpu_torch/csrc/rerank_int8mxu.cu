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
//   codesT3d (C, d, pad)      int8   residual codes, TRANSPOSED: pad contiguous
//   norms2   (C, pad)         i32    per slab row |r|^2 of the codes
//   scales   (C,)             f32    per slab dequant scale s_j
//   out      (Q, nprobe, pad) f32    qn2 - (2 s_j s_q) dot + (s_j^2) n2,
//                                    dot = sum_k qcodes[q,j,k] codesT3d[row,k,p]
//   order, items, totals: the slab-major schedule of the pairs' rows
//                         (spf_rerank_schedule in rerank.cu, kGroup pairs
//                         at most an item)
//
// What bounds it on Hopper: the bytes of the probed slabs.  A (query,
// probe) pair does one multiply-add per code byte, so the least time is
// every probed slab read once; many pairs of a batch probe the same slab,
// and a kernel that reads a slab per pair moves several times that.
//
// What the design does about it:
// - Slab-major schedule, the rerank's own: a counting sort groups the Q *
//   nprobe pairs by slab into work items of at most kGroup pairs, so each
//   probed slab is read once per item, not once per pair.
// - Persistent blocks take items from the counter totals[2].  A producer
//   warp streams the item's slab into a ring of shared-memory stages: in
//   codesT3d's layout a run of whole k-rows (k0..k1 x all pad) is
//   contiguous, so one 1-D cp.async.bulk fills a stage's codes, counted in
//   bytes on the stage's full mbarrier; the consumer warps release it on
//   its empty mbarrier.  With each stage's codes the producer stages the
//   item's query codes of those k (ordinary 4-byte cp.async, since a
//   pair's row q * d is not 16-byte aligned for every d, completing on the
//   same barrier).  Before the item's first stage it writes the item's
//   pairs, the scalars 2 s_j s_q and |qc|^2 of each and s_j^2 into a
//   second buffer and bulk-copies the slab's |r|^2 row beside them, so the
//   next item's start-up overlaps the current item's work.  The dot runs
//   over k-chunks, so no d is too deep for shared memory.
// - Each consumer thread owns four adjacent slab columns and keeps the
//   item's int32 dots for them in registers across the stages.  Per staged
//   4 x 4 block (four k-rows' words of its columns) it does the byte
//   transpose once (__byte_perm) and runs the item's pairs over it with
//   __dp4a, in one of the fixed accumulator counts 16, 8, 4, 2, 1 (the
//   item's count rounded up; the spare accumulators are dropped).  A block
//   has as many consumer warps as a pass of columns needs (up to 8, 1,024
//   columns); wider pads run in column passes, each staging only its
//   columns (a bulk copy per k-row, of the 16-byte-aligned span around
//   them), so each probed slab is still read once per item.
// - Why dp4a on CUDA cores and not int8 tensor cores: the kernel is bound
//   by bytes (at the large index's shape ~0.7 G dp4a thread-instructions,
//   ~0.05 ms, against a ~0.37 ms bytes bound); an item averages 2.5-3.2
//   pairs, so an mma.sync m16n8k32 tile (M = 16) would be ~80% empty; and
//   int8 mma / wgmma take B only K-major, while codesT3d is N-major, so
//   every staged tile would need a byte transpose first anyway.
// - Exact.  The int32 dot is exact in any order and converts to f32
//   exactly up to d 1,040 (|dot| <= 127^2 d < 2^24), so the grouping cannot
//   change a result.  The final combine uses __fmul_rn / __fsub_rn /
//   __fadd_rn in the oracle's order, so nvcc cannot contract it into FMAs
//   and the kernel rounds as the plain version does: bit-equal to it.
//
// d and pad must be multiples of 4, codesT3d and norms2 16-byte aligned,
// qcodes 4-byte aligned; the wrapper checks.  Pairs whose slab index is out
// of range form no item and get NaN rows instead of reading outside the
// slab array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "slab_ring.cuh"  // kGroup, kMaxSmem, the mbarrier and bulk-copy helpers

constexpr int kMaxConsumers = 8;                 // consumer warps of a block, at most
constexpr int kMaxCols = kMaxConsumers * 32 * 4;  // slab columns of one pass
constexpr int kStageBytes = 8192;                // a stage's target size
constexpr int kMaxStages = 4;                    // depth of the ring

// A pass of `width` columns (the last may be narrower) and `passes` of them
// cover pad.  A stage is `kc` k-rows (a multiple of 4): first the item's
// query words of those k (kGroup words per 4 k), then the codes, row r at
// r * rstride (pad, or in column passes a 16-byte-aligned slot with the
// row's span).  `nk` stages cover d.  Two item buffers of `meta` bytes
// (the |r|^2 row of a pass) follow the ring.
struct Geometry {
  int width, passes, rstride, kc, nk, stage_bytes, stages, meta, smem, consumers;
};

Geometry geometry(int d, int pad) {
  Geometry g;
  g.passes = (pad + kMaxCols - 1) / kMaxCols;
  if (g.passes < 1) g.passes = 1;
  g.width = ((pad + g.passes - 1) / g.passes + 3) / 4 * 4;
  g.rstride = g.passes == 1 ? pad : (g.width + 15) / 16 * 16 + 16;
  g.consumers = (g.width / 4 + 31) / 32;
  if (g.consumers < 1) g.consumers = 1;
  const int per_row = g.rstride + kGroup;  // code bytes and query bytes of a k-row
  int kc = kStageBytes / per_row / 4 * 4;
  if (kc < 4) kc = 4;
  g.nk = (d + kc - 1) / kc;
  if (g.nk > 0) kc = ((d + g.nk - 1) / g.nk + 3) / 4 * 4;  // even chunks
  g.kc = kc;
  g.stage_bytes = kc * per_row;
  g.meta = g.width * 4;
  g.stages = (kMaxSmem - 2 * g.meta) / g.stage_bytes;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = g.stages * g.stage_bytes + 2 * g.meta;
  return g;
}

// One unit's metadata (an item's column pass), written by the producer warp
// before it releases the unit's buffer to the consumers.
struct ItemMeta {
  int cnt;    // < 0: no more items
  int c0;     // the pass's first column
  int wid;    // its columns
  float s2;   // s_j^2
  int pair[kGroup];
  float k2[kGroup];   // 2 s_j s_q of each pair
  float qn2[kGroup];  // |qc|^2 of each pair
};

static_assert(2 * sizeof(ItemMeta) + (2 * kMaxStages + 4) * sizeof(uint64_t) <= 1024,
              "the kernel's static shared memory fits the 1 KB kMaxSmem leaves");

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// An arrival on `bar` once this thread's earlier cp.asyncs have landed,
// counted against the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// The consumers' side of one unit with NG accumulator sets (NG >= cnt):
// every stage of the pass, then the combine of its pairs' distances.
template <int NG>
__device__ __forceinline__ void consume(const unsigned char* ring, const int* n2s,
                                        const ItemMeta& m, const uint64_t* full,
                                        uint64_t* empty, const Geometry& geo, int& seq, int d,
                                        int pad, int tid, int lane, float* __restrict__ out) {
  int acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0;
  const bool live = 4 * tid < m.wid;
  const bool sliced = geo.passes > 1;
  for (int kt = 0; kt < geo.nk; ++kt, ++seq) {
    const int stage = seq % geo.stages;
    mbar_wait(smem_u32(full + stage), (uint32_t)((seq / geo.stages) & 1));
    if (live) {
      const unsigned char* base = ring + stage * geo.stage_bytes;
      const int* qw = reinterpret_cast<const int*>(base);  // [k4][kGroup]
      const unsigned char* codes = base + geo.kc * kGroup + 4 * tid;
      const int k0 = kt * geo.kc;
      const int k4n = min(geo.kc, d - k0) / 4;
      for (int k4 = 0; k4 < k4n; ++k4) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * k4 + i;
          // In a column pass the row's span starts (k * pad + c0) mod 16
          // bytes into its slot.
          const int mis = sliced ? (((k0 + r) * pad + m.c0) & 15) : 0;
          w[i] = *reinterpret_cast<const uint32_t*>(codes + r * geo.rstride + mis);
        }
        // 4 x 4 byte transpose: t_c holds column c's codes at k = 4 k4 .. +3.
        const uint32_t a01 = __byte_perm(w[0], w[1], 0x5140);
        const uint32_t a23 = __byte_perm(w[2], w[3], 0x5140);
        const uint32_t b01 = __byte_perm(w[0], w[1], 0x7362);
        const uint32_t b23 = __byte_perm(w[2], w[3], 0x7362);
        const int t0 = (int)__byte_perm(a01, a23, 0x5410);
        const int t1 = (int)__byte_perm(a01, a23, 0x7632);
        const int t2 = (int)__byte_perm(b01, b23, 0x5410);
        const int t3 = (int)__byte_perm(b01, b23, 0x7632);
        int q[NG];
        if (NG >= 4) {
#pragma unroll
          for (int g = 0; g < NG; g += 4) {
            const int4 v = *reinterpret_cast<const int4*>(qw + k4 * kGroup + g);
            q[g] = v.x, q[g + 1] = v.y, q[g + 2] = v.z, q[g + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < NG; ++g) q[g] = qw[k4 * kGroup + g];
        }
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[g][0] = __dp4a(t0, q[g], acc[g][0]);
          acc[g][1] = __dp4a(t1, q[g], acc[g][1]);
          acc[g][2] = __dp4a(t2, q[g], acc[g][2]);
          acc[g][3] = __dp4a(t3, q[g], acc[g][3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + stage));  // this warp is done with the stage
  }
  if (!live) return;
  const int4 n2 = *reinterpret_cast<const int4*>(n2s + 4 * tid);
  const float s2 = m.s2;
  const float n2f[4] = {__fmul_rn(s2, (float)n2.x), __fmul_rn(s2, (float)n2.y),
                        __fmul_rn(s2, (float)n2.z), __fmul_rn(s2, (float)n2.w)};
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < m.cnt) {
      const float k2 = m.k2[g], qn2 = m.qn2[g];
      float4 o;
      o.x = __fadd_rn(__fsub_rn(qn2, __fmul_rn(k2, (float)acc[g][0])), n2f[0]);
      o.y = __fadd_rn(__fsub_rn(qn2, __fmul_rn(k2, (float)acc[g][1])), n2f[1]);
      o.z = __fadd_rn(__fsub_rn(qn2, __fmul_rn(k2, (float)acc[g][2])), n2f[2]);
      o.w = __fadd_rn(__fsub_rn(qn2, __fmul_rn(k2, (float)acc[g][3])), n2f[3]);
      *reinterpret_cast<float4*>(out + (size_t)m.pair[g] * pad + m.c0 + 4 * tid) = o;
    }
  }
}

// A persistent block: warp 0 produces, warps 1..geo.consumers consume.  A
// unit is one column pass of a work item (the whole item when pad fits one
// pass).
//   producer: per unit, waits for the unit's buffer (two, alternating) to
//     be released; at an item's first pass takes the next item from the
//     counter totals[2]; writes the pairs and scalars, bulk-copies the
//     pass's |r|^2 span into the buffer (qfull: one arrival and its
//     bytes), then feeds the stages of the slab's k-chunks into the ring as
//     the consumers release them (empty): the pairs' query words by
//     cp.async from all 32 lanes and the codes by bulk copy from lane 0
//     (full: 33 arrivals and the copy's bytes).
//   consumers: per unit, wait for its buffer, run each stage as it lands,
//     release it, write the distances and release the buffer.
// order (P,): the pairs sorted by slab, the totals[1] in-range ones first;
// items: {slab, first position, count} of each work item; totals = {items,
// in-range pairs, item counter (0)}.  After the items, the consumers write
// the NaN rows of the out-of-range pairs.
__global__ void __launch_bounds__(32 * (kMaxConsumers + 1))
int8mxu_kernel(const unsigned char* __restrict__ qcodes, const float* __restrict__ qscale,
               const float* __restrict__ qnorm2, const unsigned char* __restrict__ codesT,
               const int* __restrict__ norms2, const float* __restrict__ scales,
               const int* __restrict__ order, const int4* __restrict__ items,
               int* __restrict__ totals, float* __restrict__ out, const Geometry geo, int P,
               int d, int pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], qfull[2], qempty[2];
  __shared__ ItemMeta meta[2];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* n2buf = reinterpret_cast<int*>(smem + geo.stages * geo.stage_bytes);  // [2][width]
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(smem_u32(full + s), 33);
      mbar_init(smem_u32(empty + s), geo.consumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(qfull + b), 1);
      mbar_init(smem_u32(qempty + b), geo.consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // producer
    const int n_items = totals[0];
    int seq = 0;  // stages issued, over all units
    int pass = geo.passes, cnt = 0, pair = 0;
    int4 item = make_int4(0, 0, 0, 0);  // {slab, first position, count}
    float sj = 0.f, k2 = 0.f, qn2 = 0.f;
    for (int k = 0;; ++k) {
      const int b = k & 1;
      mbar_wait(smem_u32(qempty + b), (uint32_t)(((k >> 1) & 1) ^ 1));  // the first round passes
      ItemMeta& m = meta[b];
      if (pass == geo.passes) {  // the next item
        int it = 0;
        if (lane == 0) it = atomicAdd(totals + 2, 1);
        it = __shfl_sync(0xffffffffu, it, 0);
        if (it >= n_items) {
          if (lane == 0) {
            m.cnt = -1;
            mbar_arrive(smem_u32(qfull + b));
          }
          asm volatile("cp.async.wait_all;" ::: "memory");  // no copy outlives its issuer
          return;
        }
        item = items[it];
        cnt = item.z;
        pass = 0;
        sj = scales[item.x];
        if (lane < cnt) {
          pair = order[item.y + lane];
          k2 = __fmul_rn(__fmul_rn(2.0f, sj), qscale[pair]);
          qn2 = qnorm2[pair];
        }
      }
      const int c0 = pass * geo.width;
      const int wid = min(geo.width, pad - c0);
      if (lane < cnt) m.pair[lane] = pair, m.k2[lane] = k2, m.qn2[lane] = qn2;
      if (lane == 0) m.cnt = cnt, m.c0 = c0, m.wid = wid, m.s2 = __fmul_rn(sj, sj);
      __syncwarp();
      if (lane == 0) {  // releases the stores above once the |r|^2 span lands
        const uint32_t bar = smem_u32(qfull + b);
        mbar_expect_tx(bar, (uint32_t)(wid * 4));
        bulk_load(smem_u32(n2buf + b * geo.width), norms2 + (size_t)item.x * pad + c0,
                  (uint32_t)(wid * 4), bar);
      }
      const unsigned char* slab = codesT + (size_t)item.x * d * pad;
      for (int kt = 0; kt < geo.nk; ++kt, ++seq) {
        const int stage = seq % geo.stages;
        mbar_wait(smem_u32(empty + stage), (uint32_t)(((seq / geo.stages) & 1) ^ 1));
        const int k0 = kt * geo.kc;
        const int rows = min(geo.kc, d - k0);
        unsigned char* base = smem + stage * geo.stage_bytes;
        const uint32_t bar = smem_u32(full + stage);
        // Query words [k4][pair]: pair g's codes k0 + 4 k4 .. + 3.
        const int k4n = rows / 4;
        for (int i = lane; i < cnt * k4n; i += 32) {
          const int g = i / k4n, k4 = i - g * k4n;
          cp_async4(smem_u32(base + 4 * (k4 * kGroup + g)),
                    qcodes + (size_t)m.pair[g] * d + k0 + 4 * k4);
        }
        cp_async_arrive(bar);
        if (lane == 0) {
          const uint32_t dst = smem_u32(base + geo.kc * kGroup);
          if (geo.passes == 1) {  // whole k-rows: one contiguous run
            mbar_expect_tx(bar, (uint32_t)(rows * pad));
            bulk_load(dst, slab + (size_t)k0 * pad, (uint32_t)(rows * pad), bar);
          } else {  // each row's 16-byte-aligned span around the pass's columns
            uint32_t bytes = 0;
            for (int r = 0; r < rows; ++r) {
              const size_t a = (size_t)(k0 + r) * pad + c0;
              bytes += (uint32_t)(((a + wid + 15) & ~(size_t)15) - (a & ~(size_t)15));
            }
            mbar_expect_tx(bar, bytes);
            for (int r = 0; r < rows; ++r) {
              const size_t a = (size_t)(k0 + r) * pad + c0;
              const size_t lo = a & ~(size_t)15, hi = (a + wid + 15) & ~(size_t)15;
              bulk_load(dst + r * geo.rstride, slab + lo, (uint32_t)(hi - lo), bar);
            }
          }
        }
      }
      ++pass;
    }
  }

  // consumers
  const int tid = threadIdx.x - 32;
  int seq = 0;
  for (int k = 0;; ++k) {
    const int b = k & 1;
    mbar_wait(smem_u32(qfull + b), (uint32_t)((k >> 1) & 1));
    const ItemMeta& m = meta[b];
    const int cnt = m.cnt;
    if (cnt < 0) break;
    const int* n2s = n2buf + b * geo.width;
    if (cnt > 8)
      consume<16>(smem, n2s, m, full, empty, geo, seq, d, pad, tid, lane, out);
    else if (cnt > 4)
      consume<8>(smem, n2s, m, full, empty, geo, seq, d, pad, tid, lane, out);
    else if (cnt > 2)
      consume<4>(smem, n2s, m, full, empty, geo, seq, d, pad, tid, lane, out);
    else if (cnt > 1)
      consume<2>(smem, n2s, m, full, empty, geo, seq, d, pad, tid, lane, out);
    else
      consume<1>(smem, n2s, m, full, empty, geo, seq, d, pad, tid, lane, out);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(qempty + b));
  }
  // NaN rows for the out-of-range pairs, positions totals[1] .. P - 1.
  const int threads = 32 * geo.consumers;
  for (int pos = totals[1] + blockIdx.x; pos < P; pos += gridDim.x) {
    float* o = out + (size_t)order[pos] * pad;
    for (int r = tid; r < pad; r += threads) o[r] = __int_as_float(0x7fc00000);
  }
}

}  // namespace

// The geometry for slabs of (d, pad): out = {group, column pass width,
// passes, k-rows a stage, stages an item pass, ring stages, dynamic shared
// memory bytes, consumer warps}.  Returns cudaErrorInvalidValue unless d
// and pad are multiples of 4.
extern "C" int spf_rerank_int8mxu_geometry(int d, int pad, int* out) {
  if (d < 0 || pad <= 0 || d % 4 || pad % 4) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(d, pad);
  const int vals[8] = {kGroup, g.width, g.passes, g.kc, g.nk, g.stages, g.smem, g.consumers};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return g.stages >= 2 ? 0 : (int)cudaErrorInvalidValue;
}

// Readies the kernel on the current device: lets it take a block's whole
// dynamic shared memory (the attribute is the function's, shared by every
// (d, pad), so it is set once to the most and never lowered) and writes to
// *blocks the persistent blocks the card holds at once at this geometry
// (occupancy x SMs).  Callers keep the result per device, so a launch does
// none of this.
extern "C" int spf_rerank_int8mxu_prepare(int d, int pad, int* blocks) {
  if (d < 0 || pad <= 0 || d % 4 || pad % 4) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(d, pad);
  const void* fn = reinterpret_cast<const void*>(int8mxu_kernel);
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * (g.consumers + 1),
                                                         g.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// All pointers are device pointers of the shapes above.  order, items and
// totals are the schedule of the P = Q * nprobe pairs (spf_rerank_schedule
// with kGroup), used once: the kernel counts its items off totals[2].
// n_slots is the length of items; blocks is what spf_rerank_int8mxu_prepare
// gave for (d, pad) on this device.  The wrapper checks shapes, dtypes,
// contiguity and alignment.
extern "C" int spf_rerank_int8mxu(const void* qcodes, const void* qscale, const void* qnorm2,
                                  const void* codesT3d, const void* norms2, const void* scales,
                                  const void* order, const void* items, void* totals, void* out,
                                  int P, int n_slots, int blocks, int d, int pad, void* stream) {
  if (P <= 0 || pad <= 0) return 0;
  if (d < 0 || d % 4 || pad % 4 || blocks < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  Geometry geo = geometry(d, pad);
  const int grid = blocks < n_slots ? blocks : n_slots;
  void* args[] = {&qcodes, &qscale, &qnorm2, &codesT3d, &norms2, &scales, &order,
                  &items,  &totals, &out,    &geo,      &P,      &d,      &pad};
  const void* fn = reinterpret_cast<const void*>(int8mxu_kernel);
  cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(32 * (geo.consumers + 1)), args,
                                   (size_t)geo.smem, static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
