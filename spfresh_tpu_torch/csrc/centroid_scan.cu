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
// Two rank modes, as in the TPU kernel, whose products run on its matrix
// unit: bf16 (both dot operands rounded to nearest-even bf16, products
// exact, f32 sums: one MXU pass; the index stores bf16) and f32
// (Precision.HIGHEST, a multi-pass bf16 expansion on the MXU).  |c|^2 is
// always the f32 sum over the unrounded row.  Only the (Q, Cpad/128) minima
// reach memory; the (Q, Cpad) rank matrix is never written.
//
// What bounds it on Hopper: the tensor cores.  The product is 2 Q Cpad
// d_pad flops (92.3 GFLOP at Q 8,192, Cpad 44,032, d_pad 128) against
// (Q + Cpad) d_pad 4 bytes of operands and Q Cpad / 32 bytes of minima:
// 0.093 ms at 989 TFLOP/s in bf16.  An f32-grade product on tensor cores
// is three TF32 products (3xTF32): 0.560 ms at 495 TFLOP/s.  Below that,
// shared memory: a wgmma m64n128 reading both operands from shared memory
// takes 96 of the SM's 128 bytes a clock at the tensor cores' full rate,
// and the TMA writes that fill the ring come on top.
//
// What the design does about it:
// - A first pass (operand_kernel, one warp a row) writes the operands the
//   tensor cores read into scratch: bf16 rows, or the TF32 split hi =
//   tf32_rna(x), lo = tf32_rna(x - hi) as two f32 arrays, and |c|^2 of
//   the unrounded centroid rows.  With few query tiles (Q <= 512, the disk
//   tier's batches) the f32 centroid slices are split in the scan instead
//   (split_in_scan), so the 8 bytes an element of hi and lo never reach
//   memory.
// - The scan (window_scan_kernel) is a wgmma product whose epilogue is the
//   window minimum.  M is queries (64 rows a consumer warpgroup, two
//   warpgroups; each holds two m64 tiles in bf16, one in f32), N is one
//   window (m64n128), K is d_pad in 128-byte swizzled slices (64 bf16 or
//   32 tf32 columns, 4 k-steps each).  The f32 mode accumulates lo.hi +
//   hi.lo + hi.hi per k-step (k8 tf32): products of 11-bit mantissas are
//   exact, the dropped lo.lo term is ~2^-22 of a product, and each slice's
//   12 products are added into f32 registers (the tensor cores round
//   toward zero as they accumulate, which over d_pad 1,024 drifts past
//   1e-5 of a rank).
// - The query tile stays in shared memory while it fits (d_pad 128: 64 KB
//   of bf16 for 256 queries, 128 KB of hi and lo for 128); past that it
//   streams slice by slice beside the centroid slices.  Centroid slices
//   (one window's 128 rows) stream through a ring of up to 8 stages,
//   filled by TMA from one thread of a producer warpgroup that gives its
//   registers to the consumers (setmaxnreg 56 / 224) and guarded by
//   full/empty mbarriers.  A bf16 consumer releases a stage once the next
//   slice's products are issued and its own have finished.
// - A block walks a run of windows for its queries, so the producer
//   loads the next window while the warpgroups run their epilogue.  Blocks
//   are (query tile, window run) pairs, the runs cut so the grid fills
//   the SMs once: at Q 8,192, 32 query tiles x 4 runs (bf16) or 64 x 2
//   (f32); at Q 64, one tile x ~130 runs of 2-3 windows.
// - The epilogue is one add (|c|^2) and one fminf per accumulator, then
//   two shuffles across the 4 lanes of a row and one f32 store per
//   (query, window).  No branch surrounds a wgmma: ptxas serializes every
//   product of the kernel otherwise.
// - 1e18 rows give |c|^2 ~ 1.3e38 (inf from d_pad 384 on) and finite dot
//   products; the sum is never NaN and such a window never wins.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's SCAN_CASES,
// CUDA events, first pass included): at Q 8,192, Cpad 44,032, d_pad 128
// the f32 rank 0.7592 ms (74% of its bound) and the bf16 rank 0.2053 ms
// (45%: the two warpgroups reach their epilogues together, so the tensor
// cores idle through it, and shared memory carries the rest); Cpad 54,272
// 0.9244 and 0.2485 ms; Q 64 0.0318 and 0.0284 ms (the host's launch work
// is about as long); d_pad 1,024 6.1669 and 1.0659 ms (73% and 70%).  The
// CUDA-core kernel this replaces took 2.47-2.52 ms at the first shape in
// either mode (tools/scan_compare.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "slab_ring.cuh"    // the mbarrier primitives, kMaxSmem
#include "tensor_tile.cuh"  // TMA tiles, wgmma, tensor maps

constexpr int kL = 128;                               // centroids per window: N of a product
constexpr int kConsumerWarps = 8;                     // two consumer warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and one producer warpgroup
// setmaxnreg: 2 x 128 x 224 + 128 x 56 = 64,512 of the SM's 65,536 (the
// f32 producer warpgroup splits slices).
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kMaxStages = 8;
constexpr int kRaw = 2;  // f32: raw centroid slices in flight before the split
constexpr int kSmemBudget = kMaxSmem - 1024;  // resident tile + ring; 1 KB for alignment

// bf16 rank: one bf16 operand array a side, one product per k16 step.
struct Bf16Rank {
  static constexpr bool kBf16 = true;
  static constexpr int kParts = 1;  // operand arrays a side
  static constexpr int kElem = 2;   // bytes an element
  static constexpr int kMT = 2;     // m64 query tiles a consumer warpgroup
  static constexpr bool kPromote = false;  // sums stay in the tensor cores' accumulators
  static constexpr bool kSplit = false;    // centroid rows come from the first pass
};

// f32 rank: hi and lo tf32 arrays a side, three products per k8 step.
// kSplitC: the centroid slices are split in the scan from raw caug (few
// query tiles: each slice is used once or a few times), else by the first
// pass (many query tiles share one split).
template <bool kSplitC>
struct Tf32x3Rank {
  static constexpr bool kBf16 = false;
  static constexpr int kParts = 2;
  static constexpr int kElem = 4;
  static constexpr int kMT = 1;
  static constexpr bool kPromote = true;  // each slice's sums added into f32 registers
  static constexpr bool kSplit = kSplitC;
};

template <class R>
__host__ __device__ constexpr int block_queries() {
  return 64 * R::kMT * (kConsumerWarps / 4);
}

struct ScanShape {
  int Q, W;      // queries, windows
  int slices;    // 128-byte slices of a row
  int stages;    // depth of the ring
  int resident;  // 1: the query tile stays in shared memory
  int run;       // windows a block walks
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// One warp per row of src (rows, d_pad) f32: the row's rank operands into
// op0 (bf16, or the tf32 hi) and op1 (the tf32 lo), and, when norms is
// given, |row|^2 in f32 over the unrounded values.
template <bool kBf16>
__global__ void operand_kernel(const float* __restrict__ src, int rows, int d_pad,
                               void* __restrict__ op0, float* __restrict__ op1,
                               float* __restrict__ norms) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps leave together
  const size_t base = (size_t)r * (d_pad / 4);
  const float4* row = reinterpret_cast<const float4*>(src) + base;
  float acc = 0.f;
  for (int c = lane; c < d_pad / 4; c += 32) {
    const float4 x = __ldg(row + c);
    acc = fmaf(x.x, x.x, acc);
    acc = fmaf(x.y, x.y, acc);
    acc = fmaf(x.z, x.z, acc);
    acc = fmaf(x.w, x.w, acc);
    if (kBf16) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
      const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&a);
      v.y = *reinterpret_cast<const uint32_t*>(&b);
      static_cast<uint2*>(op0)[base + c] = v;
    } else {
      const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
      static_cast<float4*>(op0)[base + c] = h;
      reinterpret_cast<float4*>(op1)[base + c] = make_float4(
          tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
    }
  }
  if (norms == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) norms[r] = acc;
}

// D (64 x 128) (+)= this k-step's products of one query tile (a0, a1 =
// hi, lo) with one centroid slice (b0, b1).  f32: lo.hi + hi.lo, then
// hi.hi, so the small terms enter first.
template <class R>
__device__ __forceinline__ void step_products(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t b0, uint32_t b1, int accumulate) {
  if constexpr (R::kBf16) {
    wgmma_m64n128_bf16(d, sw128_desc(a0), sw128_desc(b0), accumulate);
  } else {
    wgmma_m64n128_tf32(d, sw128_desc(a1), sw128_desc(b0), accumulate);
    wgmma_m64n128_tf32(d, sw128_desc(a0), sw128_desc(b1), 1);
    wgmma_m64n128_tf32(d, sw128_desc(a0), sw128_desc(b0), 1);
  }
}

// One block: BQ queries (64 R::kMT per consumer warpgroup) against the
// windows [blockIdx.y * run, +run), each window as `slices` 128-row slices
// through a ring of `stages` buffers (full barriers: a slice is ready;
// empty barriers: the consumer warps are done with it).  One thread of the
// producer warpgroup issues the TMA copies: the query tile once (resident)
// or each query slice beside its centroid slice (streamed).  bf16: the
// centroid slices are copied as they are (bf16 rows from the first pass).
// f32: the raw f32 slices of caug land in a second ring of kRaw buffers and
// the producer warpgroup's 128 threads split them, a thread a centroid row,
// into the stage's hi and lo tiles (the 128-byte swizzle permutes 16-byte
// chunks within a row, so each element keeps its offset), summing |c|^2 of
// the unrounded row on the way.  Shared memory: [query tile (part, slice) |
// ring | raw ring (f32) | |c|^2 a stage (f32)]; a stage is [centroid slice
// (part) | query slice (part), streamed only].
template <class R>
__global__ void __launch_bounds__(kThreads, 1)
window_scan_kernel(const __grid_constant__ CUtensorMap cmap0,
                   const __grid_constant__ CUtensorMap cmap1,
                   const __grid_constant__ CUtensorMap qmap0,
                   const __grid_constant__ CUtensorMap qmap1, const float* __restrict__ cn2g,
                   float* __restrict__ out, const ScanShape sh) {
  constexpr int kBQ = block_queries<R>();
  constexpr int kCols = kRowBytes / R::kElem;       // columns of a slice
  constexpr uint32_t kBBytes = kL * kRowBytes;      // a centroid slice, one part
  constexpr uint32_t kABytes = kBQ * kRowBytes;     // a query slice, one part
  constexpr uint32_t kWgBytes = 64 * R::kMT * kRowBytes;  // a warpgroup's rows of a query slice
  constexpr uint32_t kConverters = R::kSplit ? 4 : 0;     // producer warps that split slices
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], a_ready;
  __shared__ __align__(8) uint64_t raw_full[kRaw], raw_empty[kRaw];
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B.
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_tile = R::kParts * sh.slices * kABytes;
  const uint32_t ring = smem + (sh.resident ? a_tile : 0u);
  const uint32_t q_bytes = sh.resident ? 0u : R::kParts * kABytes;  // streamed query slices
  const uint32_t stage_bytes = R::kParts * kBBytes + q_bytes;
  const uint32_t raw = ring + sh.stages * stage_bytes;               // f32: kRaw raw slices
  float* const cn2s = reinterpret_cast<float*>(smem_raw + (raw + kRaw * kBBytes - smem_u32(smem_raw)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int w0 = blockIdx.y * sh.run;
  const int w1 = min(w0 + sh.run, sh.W);

  if (threadIdx.x == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      // bf16: the issuing thread's expect_tx; f32: the converter warps, and
      // the issuing thread's when query slices stream.
      mbar_init(smem_u32(&full[s]), R::kSplit ? kConverters + (sh.resident ? 0 : 1) : 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    for (int r = 0; r < (R::kSplit ? kRaw : 0); ++r) {
      mbar_init(smem_u32(&raw_full[r]), 1);
      mbar_init(smem_u32(&raw_empty[r]), kConverters);
    }
    mbar_init(smem_u32(&a_ready), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int t = threadIdx.x - 32 * kConsumerWarps;  // f32: this thread's row of a slice
    const bool issuer = t == 0;
    if (!R::kSplit && !issuer) return;
    const CUtensorMap* cmap[2] = {&cmap0, &cmap1};
    const CUtensorMap* qmap[2] = {&qmap0, &qmap1};
    if (issuer && sh.resident) {
      const uint32_t bar = smem_u32(&a_ready);
      mbar_expect_tx(bar, a_tile);
      for (int p = 0; p < R::kParts; ++p)
        for (int s = 0; s < sh.slices; ++s)
          tma_load(smem + (p * sh.slices + s) * kABytes, qmap[p], bar, s * kCols, q0);
    }
    const int total = (w1 - w0) * sh.slices;  // the block's slices, window-major
    // f32: raw slice j into raw buffer j % kRaw, once its last use is released.
    auto load_raw = [&](int j) {
      const int b = j % kRaw;
      mbar_wait(smem_u32(&raw_empty[b]), ((j / kRaw) & 1) ^ 1u);  // the first round passes
      const uint32_t bar = smem_u32(&raw_full[b]);
      mbar_expect_tx(bar, kBBytes);
      tma_load(raw + b * kBBytes, &cmap0, bar, (j % sh.slices) * kCols, (w0 + j / sh.slices) * kL);
    };
    if (R::kSplit && issuer)
      for (int j = 0; j < kRaw - 1 && j < total; ++j) load_raw(j);
    int stage = 0;
    uint32_t phase = 0;
    float x2 = 0.f;
    for (int i = 0; i < total; ++i) {
      const int s = i % sh.slices;
      if (R::kSplit && issuer && i + kRaw - 1 < total) load_raw(i + kRaw - 1);
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);  // the first round passes
      const uint32_t dst = ring + stage * stage_bytes, bar = smem_u32(&full[stage]);
      if (issuer) {
        const int w = w0 + i / sh.slices;
        const uint32_t tx = (R::kSplit ? 0u : R::kParts * kBBytes) + q_bytes;
        if (tx) mbar_expect_tx(bar, tx);
        if (!R::kSplit)
          for (int p = 0; p < R::kParts; ++p) tma_load(dst + p * kBBytes, cmap[p], bar, s * kCols, w * kL);
        if (!sh.resident)
          for (int p = 0; p < R::kParts; ++p)
            tma_load(dst + R::kParts * kBBytes + p * kABytes, qmap[p], bar, s * kCols, q0);
      }
      if constexpr (R::kSplit) {
        const int b = i % kRaw;
        mbar_wait(smem_u32(&raw_full[b]), (i / kRaw) & 1);
        const uint32_t row = t * kRowBytes;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t off = row + 16 * (j ^ (t & 7));  // conflict-free across 8 rows
          float4 x;
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                       : "r"(raw + b * kBBytes + off));
          x2 = fmaf(x.x, x.x, x2);
          x2 = fmaf(x.y, x.y, x2);
          x2 = fmaf(x.z, x.z, x2);
          x2 = fmaf(x.w, x.w, x2);
          const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
          const float4 l = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y),
                                       tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(dst + off), "f"(h.x),
                       "f"(h.y), "f"(h.z), "f"(h.w)
                       : "memory");
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(dst + kBBytes + off),
                       "f"(l.x), "f"(l.y), "f"(l.z), "f"(l.w)
                       : "memory");
        }
        if (s == sh.slices - 1) {  // the window's |c|^2, read by the consumers with this stage
          cn2s[stage * kL + t] = x2;
          x2 = 0.f;
        }
        // The split tiles are read by wgmma (the async proxy).
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bar);
          mbar_arrive(smem_u32(&raw_empty[b]));
        }
      }
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
  const int qwg = q0 + wg * 64 * R::kMT;  // this warpgroup's first query
  if (sh.resident) mbar_wait(smem_u32(&a_ready), 0);
  // acc: the tensor cores' sums.  f32 rank: they round toward zero as they
  // accumulate, which over d_pad 1,024 (384 TF32 products a k-row) drifts
  // past 1e-5 of a rank, so each slice's products (12) start from zero and
  // are added into `sum` by an f32 add (round to nearest).
  float acc[R::kMT][64], sum[R::kMT][64];
#pragma unroll
  for (int mt = 0; mt < R::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = sum[mt][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = w0; w < w1; ++w) {
    // |c|^2 of this thread's 32 columns.  bf16: from the first pass, loaded
    // before the products so their latency hides behind them; split in the
    // scan: from the converters, with the window's last slice.
    float cn2[32];
    if (!R::kSplit) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) cn2[2 * j + e] = __ldg(cn2g + w * kL + 8 * j + 2 * (lane & 3) + e);
    }
    int prev = -1;  // the stage whose products may still run (bf16)
    for (int s = 0; s < sh.slices; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      if (R::kSplit && s == sh.slices - 1) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) cn2[2 * j + e] = cn2s[stage * kL + 8 * j + 2 * (lane & 3) + e];
      }
      const uint32_t bsl = ring + stage * stage_bytes;
      const uint32_t asl = sh.resident ? smem + s * kABytes : bsl + R::kParts * kBBytes;
      const uint32_t a_part = sh.resident ? sh.slices * kABytes : kABytes;  // hi -> lo
#pragma unroll
      for (int mt = 0; mt < R::kMT; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int mt = 0; mt < R::kMT; ++mt) {
          const uint32_t a0 = asl + wg * kWgBytes + mt * 64 * kRowBytes + 32 * k;
          step_products<R>(acc[mt], a0, a0 + a_part, bsl + 32 * k, bsl + kBBytes + 32 * k,
                           (k > 0 || (s > 0 && !R::kPromote)) ? 1 : 0);
        }
      wgmma_commit();
      if constexpr (R::kPromote) {
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < R::kMT; ++mt) {
          fence_regs(acc[mt]);
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[mt][i] = s > 0 ? sum[mt][i] + acc[mt][i] : acc[mt][i];
        }
        prev = stage;  // its products have finished
      } else {
        wgmma_wait<1>();  // every slice's products but this one's have finished
#pragma unroll
        for (int mt = 0; mt < R::kMT; ++mt) fence_regs(acc[mt]);
      }
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      }
      prev = R::kPromote ? -1 : stage;
      if (++stage == sh.stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    if (!R::kPromote) {
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < R::kMT; ++mt) fence_regs(acc[mt]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
    }
    // Epilogue.  Every warpgroup ran the products, also one whose rows all
    // lie past Q (a branch around them makes ptxas serialize every wgmma);
    // only rows below Q are written.  Accumulator element 4 j + 2 h + e is
    // (query row r + 8 h, centroid 8 j + 2 (lane % 4) + e), r = 16 (warp %
    // 4) + lane / 4.
#pragma unroll
    for (int mt = 0; mt < R::kMT; ++mt) {
      const float(&v)[64] = R::kPromote ? sum[mt] : acc[mt];
      float m[2] = {INFINITY, INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) m[h] = fminf(m[h], cn2[2 * j + e] + v[4 * j + 2 * h + e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      }
      if ((lane & 3) == 0) {
        const int q = qwg + mt * 64 + (warp % 4) * 16 + lane / 4;
        if (q < sh.Q) out[(size_t)q * sh.W + w] = m[0];
        if (q + 8 < sh.Q) out[(size_t)(q + 8) * sh.W + w] = m[1];
      }
    }
  }
}

// Scratch of one call: [centroid operands (part) | query operands (part) |
// |c|^2]; with the split in the scan, the query operands alone.
template <class R>
size_t scratch_bytes(int Q, int cpad, int d_pad) {
  if (R::kSplit) return (size_t)Q * d_pad * R::kElem * R::kParts;
  return ((size_t)cpad + Q) * d_pad * R::kElem * R::kParts + (size_t)cpad * 4;
}

// The ring's geometry: (resident, stages, dynamic shared bytes); stages 0
// if even two do not fit.
template <class R>
void scan_geometry(int d_pad, int* resident, int* stages, int* smem) {
  constexpr int kBQ = block_queries<R>();
  const int slices = d_pad * R::kElem / kRowBytes;
  const int a_tile = R::kParts * slices * kBQ * kRowBytes;
  const int b_bytes = R::kParts * kL * kRowBytes;
  const int raw = R::kSplit ? kRaw * kL * kRowBytes : 0;
  const int per_stage = R::kSplit ? kL * 4 : 0;  // |c|^2 of a window
  *resident = a_tile + 2 * (b_bytes + per_stage) + raw <= kSmemBudget;
  const int stage_bytes = b_bytes + (*resident ? 0 : R::kParts * kBQ * kRowBytes);
  const int fit = (kSmemBudget - (*resident ? a_tile : 0) - raw) / (stage_bytes + per_stage);
  *stages = fit < 2 ? 0 : (fit < kMaxStages ? fit : kMaxStages);
  *smem = (*resident ? a_tile : 0) + *stages * (stage_bytes + per_stage) + raw + 1024;
}

template <class R>
cudaError_t launch_scan(const float* caug, const float* qaug, float* out, uint8_t* scratch, int Q,
                        int cpad, int d_pad, cudaStream_t s) {
  constexpr int kBQ = block_queries<R>();
  constexpr CUtensorMapDataType kType =
      R::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const size_t c_part = R::kSplit ? 0 : (size_t)cpad * d_pad * R::kElem;
  const size_t q_part = (size_t)Q * d_pad * R::kElem;
  uint8_t* cops = scratch;
  uint8_t* qops = cops + R::kParts * c_part;
  float* cn2 = reinterpret_cast<float*>(qops + R::kParts * q_part);  // bf16 only
  constexpr int kRowsPerBlock = 8;  // one warp a row
  if (!R::kSplit)
    operand_kernel<R::kBf16><<<(cpad + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                               s>>>(caug, cpad, d_pad, cops, reinterpret_cast<float*>(cops + c_part),
                                    cn2);
  operand_kernel<R::kBf16><<<(Q + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      qaug, Q, d_pad, qops, reinterpret_cast<float*>(qops + q_part), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Split in the scan: the raw caug; else the first pass's parts.  One
  // part: the second map repeats the first.
  CUtensorMap cm[2], qm[2];
  for (int p = 0; p < R::kParts && err == cudaSuccess; ++p) {
    if (p == 0 || !R::kSplit)
      err = make_map(&cm[p], R::kSplit ? static_cast<const void*>(caug) : cops + p * c_part, kType,
                     R::kElem, cpad, d_pad, kL);
    if (err == cudaSuccess)
      err = make_map(&qm[p], qops + p * q_part, kType, R::kElem, Q, d_pad, kBQ);
  }
  if (err != cudaSuccess) return err;
  if (R::kParts == 1) qm[1] = qm[0];
  if (R::kParts == 1 || R::kSplit) cm[1] = cm[0];
  int resident = 0, stages = 0, smem = 0;
  scan_geometry<R>(d_pad, &resident, &stages, &smem);
  if (stages == 0) return cudaErrorInvalidValue;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // Per device: the SM count and the kernel's shared-memory opt-in (the
  // most any shape takes), looked up once.
  static int sms[64] = {};
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_scan_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget + 1024);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }

  // Runs of windows: as many per query tile as fill the SMs once.
  const int W = cpad / kL;
  const int qtiles = (Q + kBQ - 1) / kBQ;
  int runs = sms[dev] / qtiles;
  runs = runs < 1 ? 1 : (runs > W ? W : runs);
  const int run = (W + runs - 1) / runs;
  runs = (W + run - 1) / run;
  const ScanShape sh{Q, W, d_pad * R::kElem / kRowBytes, stages, resident, run};
  window_scan_kernel<R><<<dim3((unsigned)qtiles, (unsigned)runs), kThreads, smem, s>>>(
      cm[0], cm[1], qm[0], qm[1], cn2, out, sh);
  return cudaGetLastError();
}

bool scan_shape_ok(int Q, int cpad, int d_pad) {
  return Q >= 0 && cpad >= 0 && cpad % 1024 == 0 && d_pad > 0 && d_pad % 128 == 0;
}

// f32: the centroid slices are split in the scan up to this many query
// tiles (Q <= 512), by the first pass past it.  The first pass writes and
// the scan reads hi and lo of every centroid (8 bytes an element), which a
// few query tiles do not amortize; split in the scan, every query tile
// splits every slice again, and the split's shared-memory traffic beside
// three products' operand reads makes the scan shared-memory bound.
constexpr int kSplitMaxTiles = 4;

bool split_in_scan(int Q) {
  return (Q + block_queries<Tf32x3Rank<true>>() - 1) / block_queries<Tf32x3Rank<true>>() <=
         kSplitMaxTiles;
}

}  // namespace

// Bytes of scratch spf_window_scan needs for these shapes, or -1 if the
// kernel does not take them (Cpad a multiple of 1,024, d_pad of 128).
extern "C" long long spf_window_scan_scratch(int Q, int cpad, int d_pad, int bf16) {
  if (!scan_shape_ok(Q, cpad, d_pad)) return -1;
  if (bf16) return (long long)scratch_bytes<Bf16Rank>(Q, cpad, d_pad);
  return (long long)(split_in_scan(Q) ? scratch_bytes<Tf32x3Rank<true>>(Q, cpad, d_pad)
                                      : scratch_bytes<Tf32x3Rank<false>>(Q, cpad, d_pad));
}

// caug (Cpad, d_pad) and qaug (Q, d_pad) f32, row-major, 16-byte aligned;
// Cpad a multiple of 1,024 and d_pad of 128.  out (Q, Cpad / 128) f32.
// scratch: spf_window_scan_scratch(...) bytes, 16-byte aligned.  bf16: rank
// with bf16-rounded dot operands, else 3xTF32.
extern "C" int spf_window_scan(const void* caug, const void* qaug, void* out, void* scratch, int Q,
                               int cpad, int d_pad, int bf16, void* stream) {
  if (!scan_shape_ok(Q, cpad, d_pad)) return (int)cudaErrorInvalidValue;
  if (Q == 0 || cpad == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(caug);
  const float* q = static_cast<const float*>(qaug);
  float* o = static_cast<float*>(out);
  uint8_t* w = static_cast<uint8_t*>(scratch);
  if (bf16) return (int)launch_scan<Bf16Rank>(c, q, o, w, Q, cpad, d_pad, s);
  if (split_in_scan(Q)) return (int)launch_scan<Tf32x3Rank<true>>(c, q, o, w, Q, cpad, d_pad, s);
  return (int)launch_scan<Tf32x3Rank<false>>(c, q, o, w, Q, cpad, d_pad, s);
}
