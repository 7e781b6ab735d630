// Tie-stable row top-k: the k smallest entries of each f32 row, ascending,
// ties to the lower column, as (values, int64 columns).
//
// Replaces no TPU kernel.  The JAX package selects with lax.top_k
// (spfresh_tpu/ops/topk.py::smallest_k), left to XLA.  The port's plain
// version (spfresh_tpu_torch/ops/topk.py::smallest_k_plain) runs
// torch.topk on a unique int64 key, (order bits << 32) | column, built by
// five elementwise passes; on the card that selection was ~55-60% of the
// batch search's device time.  This kernel takes its place for every CUDA
// tensor and returns the same bits.
//
//   x     (rows, n) f32, row-major
//   vals  (rows, k) f32: the selected entries as x holds them (-0.0 and
//         NaN payloads as given)
//   idx   (rows, k) int64: their columns
//
// Order: the plain version's 32-bit key.  v + 0.0f folds -0.0 into +0.0
// (and gives the card's canonical NaN, as the plain version's add does);
// the sign-magnitude bits become an unsigned order (negatives flipped), so
// -inf < finite < +inf < NaN.  Equal keys go to the lower column: the
// column is the second sort key, compared beside the key, never packed
// with it into one word.
//
// Bound: bytes.  Each row is read once (4 n bytes) and k (value, column)
// pairs are written (12 k bytes); an entry costs a few integer operations a
// pass.  At the batch search's stage 1 (8,192 x 11,008, k 8) that is 361 MB,
// 0.108 ms at 3.35 TB/s.
//
// Design: a group of threads owns a row; one algorithm whose parameters
// follow (n, k).  Rows up to 1,024 columns: a warp a row, four rows a
// block.  Longer rows: a block of 64-1,024 threads (about 32 columns a
// thread).  Rows up to 32,768 columns are read once, as keys, into shared
// memory; longer rows are cut into tiles or read from global memory (L2)
// in every pass (below).
//  1. Load: the keys, and their minimum and maximum.  Every key shares the
//     leading bits of min and max, so the radix passes start below them
//     (stage-1 distances share their sign and top exponent bits, which
//     would put every entry in one bin).
//  2. Select the (key, column) pair of rank r: 8-bit digit passes over the
//     key with histograms in shared memory (one a warp), a warp scan for
//     the digit where rank r falls.  Once the bucket holds exactly the
//     ranks left to take it is taken whole; if ties remain at the full key,
//     the same passes run over the tied entries' column bits.
//  3. Compact every pair in (previous threshold, threshold] into shared
//     memory (a ballot and one atomic a warp), sort them by (key, column)
//     in a bitonic network, write values (read back from x) and columns.
//  A block takes k past 2,048 in rounds of 2,048 ranks (full-probe stage 1,
//  k = n): round j selects the pair of rank 2,048 (j + 1) and compacts what
//  lies above round j - 1's pair.
//  Rows past 32,768 columns whose tiles' selections fit one shared-memory
//  row (ceil(n / 32,768) k <= 32,768) are cut into 32,768-column tiles,
//  each a block's row: a first launch writes each tile's top k (columns of
//  the whole row; a short last tile padded with NaN, which sorts after
//  every real entry at the row's end) to scratch, and a second selects from
//  the tiles' k each.  Tile order and each tile's sorted order keep equal
//  keys in column order, so the merge's position order is the row's column
//  order, and its result the row's.  A few long rows (a brute-force search
//  of a few queries) then fill the card instead of a block each.  Other
//  long rows are read from global memory in every pass.
//
// Callers on the card, (n, k) of their rows:
//  ops/topk.py centroid_topk, dense route: n = C <= 32,768 (or past it
//    where nprobe > 1,024, or > 128 for a non-Euclidean metric), k = nprobe
//    <= n (k = n at full probe);
//  chunked_centroid_topk: n = nprobe + 8,192, k = nprobe <= 1,024;
//  ops/centroid_scan.py windowed_centroid_topk: the window minima, n = W <=
//    2,048, k = min(nprobe + 8, W); the windows' centroids, n = S * 128 <=
//    17,408, k = nprobe <= 128; the merge, n = 2 nprobe, k = nprobe;
//  index/spann.py _probe_candidates' probe-chunk fold: n = kk + chunk * pad,
//    k = kk = max(k, min(k * max_dup, nprobe * pad));
//  ops/topk.py smallest_k_unique: the prefilter, n = the candidates
//    (nprobe * pad, or kk), k = min(k * max_dup, n); the final select,
//    n = that k, k = min(k, n);
//  parallel/sharded.py: global nprobe, n = shards * nprobe, k = global_k,
//    and smallest_k_unique per shard and over the shards' k each;
//  index/lazy.py: smallest_k_unique over nprobe * pad;
//  index/spann.py brute_force_search: exact, n <= 10,000 and k; two-stage,
//    n = kc + 65,536 (Euclidean; kc = min(max(32 k, 256), n)) or k + 8,192,
//    k = kc, then n = kc, k;
//  ops/replica.py replica_topk_elementwise (Manhattan and Chebyshev builds
//    on the card): n = C, k = n_extra.
// All of them: 1 <= k <= n < 2^31, any number of rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDigit = 8;                // key bits a radix pass
constexpr int kBins = 1 << kDigit;
constexpr int kWarpRowMax = 1024;        // rows up to this many columns: a warp each
constexpr int kWarpRows = 4;             // warp-owned rows a block
constexpr int kSmemRowMax = 32768;       // rows past this are read from global memory a pass
constexpr int kChunk = 2048;             // ranks a block sorts in shared memory a round
constexpr int kScal = 8;                 // words: the scan's bin, before, count; the slot counter
constexpr int kRed = 64;                 // words: a warp's minimum and maximum
constexpr int kSmemOptIn = 200 * 1024;   // the most any plan takes (~181 KB), opted into once
constexpr uint32_t kAll = 0xFFFFFFFFu;

struct Shape {
  int rows;         // rows selected: the input's rows times tiles
  int n;            // columns of an input row
  int k;            // ranks a row (fewer in a shorter tile), the output's row stride
  int tiles;        // tiles a row (1: the whole row)
  int tile_w;       // columns a tile (n when tiles is 1)
  int chunk;        // ranks a round
  int cap;          // sort buffer: the power of two at or above chunk
  int group_words;  // shared words a group owns
};

struct Pair {
  uint32_t key, col;
};

__host__ __device__ __forceinline__ uint32_t lo_mask(int bits) {
  return bits >= 32 ? kAll : (1u << bits) - 1u;
}

// The top `known` bits set.
__host__ __device__ __forceinline__ uint32_t hi_mask(int known) { return ~lo_mask(32 - known); }

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool at_most(uint32_t key, uint32_t col, Pair t) {
  return key < t.key || (key == t.key && col <= t.col);
}

template <bool kWarp>
__device__ __forceinline__ void group_sync() {
  if (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

template <bool kSmemRow>
__device__ __forceinline__ uint32_t key_at(const float* xr, const uint32_t* keys, int i) {
  if (kSmemRow) return keys[i];
  return order_key(__ldg(xr + i));
}

// One warp: the bin of the kBins counts h where rank rem (1-based) falls,
// as scal[0] = bin, scal[1] = the count in the bins below, scal[2] = its
// count.  Bins go in columns of 32 so every lane reads its own bank.
__device__ __forceinline__ void find_bin(const uint32_t* h, uint32_t rem, uint32_t* scal) {
  const int lane = threadIdx.x & 31;
  uint32_t run = 0;
  for (int c = 0; c < kBins; c += 32) {
    const uint32_t v = h[c + lane];
    uint32_t incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t excl = incl - v;
    const bool hit = run + excl < rem && rem <= run + incl;
    if (__ballot_sync(kAll, hit)) {
      if (hit) {
        scal[0] = c + lane;
        scal[1] = run + excl;
        scal[2] = v;
      }
      return;
    }
    run += __shfl_sync(kAll, incl, 31);
  }
}

// The histogram of one digit, (v >> shift) & dmask, over the entries that
// match: keys whose top bits equal `prefix` under `hm` or, for kCol, keys
// equal to `kprefix` whose columns match.  Returns where rank rem falls.
template <bool kWarp, bool kSmemRow, bool kCol>
__device__ __forceinline__ void radix_pass(const float* xr, const uint32_t* keys, uint32_t* hist,
                                           uint32_t* scal, int n, int t, int G, int nw, int w,
                                           uint32_t kprefix, uint32_t hm, uint32_t prefix,
                                           int shift, uint32_t dmask, uint32_t rem,
                                           uint32_t& bin, uint32_t& before, uint32_t& cnt) {
  for (int j = t; j < nw * kBins; j += G) hist[j] = 0;
  group_sync<kWarp>();
  uint32_t* mine = hist + w * kBins;
#pragma unroll 4
  for (int i = t; i < n; i += G) {
    const uint32_t key = key_at<kSmemRow>(xr, keys, i);
    if (kCol) {
      if (key == kprefix && ((uint32_t)i & hm) == prefix)
        atomicAdd(mine + (((uint32_t)i >> shift) & dmask), 1u);
    } else if ((key & hm) == prefix) {
      atomicAdd(mine + ((key >> shift) & dmask), 1u);
    }
  }
  group_sync<kWarp>();
  if (!kWarp) {
    for (int j = t; j < kBins; j += G) {
      uint32_t s = 0;
      for (int q = 0; q < nw; ++q) s += hist[q * kBins + j];
      hist[j] = s;
    }
    __syncthreads();
  }
  if (w == 0) find_bin(hist, rem, scal);
  group_sync<kWarp>();
  bin = scal[0];
  before = scal[1];
  cnt = scal[2];
}

// The (key, column) pair of rank `rank` (1-based) in the row; every key
// shares its top `known` bits with `prefix`.
template <bool kWarp, bool kSmemRow>
__device__ Pair select_rank(const float* xr, const uint32_t* keys, uint32_t* hist, uint32_t* scal,
                            int n, int t, int G, int nw, int w, uint32_t rank, uint32_t prefix,
                            int known) {
  uint32_t rem = rank, cnt = (uint32_t)n, bin, before;
  while (known < 32 && cnt != rem) {
    const int bits = min(kDigit, 32 - known);
    const int shift = 32 - known - bits;
    radix_pass<kWarp, kSmemRow, false>(xr, keys, hist, scal, n, t, G, nw, w, 0u, hi_mask(known),
                                       prefix, shift, lo_mask(bits), rem, bin, before, cnt);
    prefix |= bin << shift;
    known += bits;
    rem -= before;
  }
  if (cnt == rem) return {prefix | lo_mask(32 - known), kAll};
  // Ties at the full key: the same passes over the tied entries' columns,
  // which are distinct, so they end with one entry of rank rem.
  uint32_t cprefix = 0;
  int cknown = __clz(n - 1);  // n >= 2 here: the leading zero bits of every column
  while (cknown < 32 && cnt != rem) {
    const int bits = min(kDigit, 32 - cknown);
    const int shift = 32 - cknown - bits;
    radix_pass<kWarp, kSmemRow, true>(xr, keys, hist, scal, n, t, G, nw, w, prefix,
                                      hi_mask(cknown), cprefix, shift, lo_mask(bits), rem, bin,
                                      before, cnt);
    cprefix |= bin << shift;
    cknown += bits;
    rem -= before;
  }
  return {prefix, cprefix | lo_mask(32 - cknown)};
}

// colmap (optional, (rows, n) int64): the column written for entry c of
// row r is colmap[r n + c] (the merge of tiles); else the column itself.
template <bool kWarp, bool kSmemRow>
__global__ void __launch_bounds__(1024)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                   int64_t* __restrict__ idx, const int64_t* __restrict__ colmap, Shape sh) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int G = kWarp ? 32 : (int)blockDim.x;
  const int nw = G >> 5;
  const int t = kWarp ? lane : (int)threadIdx.x;
  const int w = t >> 5;  // warp in the group
  const long long row =
      kWarp ? (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5) : (long long)blockIdx.x;
  if (row >= sh.rows) return;  // a whole warp, and only in the warp form
  uint32_t* g = smem + (kWarp ? (size_t)(threadIdx.x >> 5) * sh.group_words : 0);
  uint32_t* scal = g;
  uint32_t* red = scal + kScal;
  uint32_t* hist = red + kRed;
  uint32_t* skey = hist + nw * kBins;
  uint32_t* scol = skey + sh.cap;
  uint32_t* keys = scol + sh.cap;
  // This group's columns: tile `row % tiles` of input row `row / tiles`.
  const long long xrow = row / sh.tiles;
  const int t0 = (int)(row % sh.tiles) * sh.tile_w;
  const int n = min(sh.tile_w, sh.n - t0);
  const int k = min(sh.k, n);
  const float* xr = x + xrow * (long long)sh.n + t0;

  // 1. Keys and their range; four loads in flight a thread.
  uint32_t kmin = kAll, kmax = 0;
  int i0 = t;
  for (; i0 + 3 * G < n; i0 += 4 * G) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(xr + i0 + u * G);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t key = order_key(v[u]);
      if (kSmemRow) keys[i0 + u * G] = key;
      kmin = min(kmin, key);
      kmax = max(kmax, key);
    }
  }
  for (; i0 < n; i0 += G) {
    const uint32_t key = order_key(__ldg(xr + i0));
    if (kSmemRow) keys[i0] = key;
    kmin = min(kmin, key);
    kmax = max(kmax, key);
  }
  kmin = __reduce_min_sync(kAll, kmin);
  kmax = __reduce_max_sync(kAll, kmax);
  if (!kWarp) {
    if (lane == 0) {
      red[w] = kmin;
      red[32 + w] = kmax;
    }
    __syncthreads();
    for (int j = 0; j < nw; ++j) {
      kmin = min(kmin, red[j]);
      kmax = max(kmax, red[32 + j]);
    }
  } else {
    __syncwarp();
  }
  const int common = kmin == kmax ? 32 : __clz(kmin ^ kmax);
  const uint32_t base = kmin & hi_mask(common);

  Pair prev{0u, 0u};
  bool have_prev = false;
  for (int r0 = 0; r0 < k; r0 += sh.chunk) {
    const int r1 = min(k, r0 + sh.chunk);
    const int m = r1 - r0;
    int p2 = 1;
    while (p2 < m) p2 <<= 1;
    // 2. The threshold pair of rank r1.
    const Pair th = select_rank<kWarp, kSmemRow>(xr, keys, hist, scal, n, t, G, nw, w,
                                                 (uint32_t)r1, base, common);
    // 3. The m pairs in (prev, th], padded with pairs above any entry.
    if (t == 0) scal[3] = 0;
    for (int i = m + t; i < p2; i += G) {
      skey[i] = kAll;
      scol[i] = kAll;
    }
    group_sync<kWarp>();
    for (int b0 = 0; b0 < n; b0 += G) {
      const int i = b0 + t;
      uint32_t key = 0;
      bool sel = false;
      if (i < n) {
        key = key_at<kSmemRow>(xr, keys, i);
        sel = at_most(key, (uint32_t)i, th) && !(have_prev && at_most(key, (uint32_t)i, prev));
      }
      const uint32_t ballot = __ballot_sync(kAll, sel);
      uint32_t off = 0;
      if (lane == 0 && ballot) off = atomicAdd(scal + 3, (uint32_t)__popc(ballot));
      off = __shfl_sync(kAll, off, 0);
      const uint32_t slot = off + (uint32_t)__popc(ballot & ((1u << lane) - 1u));
      if (sel && slot < (uint32_t)sh.cap) {
        skey[slot] = key;
        scol[slot] = (uint32_t)i;
      }
    }
    group_sync<kWarp>();
    // Bitonic sort of p2 pairs by (key, column).
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int j = t; j < (p2 >> 1); j += G) {
          const int lo = 2 * j - (j & (stride - 1));
          const int hi = lo + stride;
          const uint32_t ka = skey[lo], kb = skey[hi], ca = scol[lo], cb = scol[hi];
          const bool greater = ka > kb || (ka == kb && ca > cb);
          if (greater != ((lo & size) != 0)) {
            skey[lo] = kb;
            skey[hi] = ka;
            scol[lo] = cb;
            scol[hi] = ca;
          }
        }
        group_sync<kWarp>();
      }
    }
    const long long out = row * (long long)sh.k + r0;
    for (int i = t; i < m; i += G) {
      const uint32_t c = scol[i];
      idx[out + i] = colmap ? colmap[xrow * (long long)sh.n + t0 + c] : (int64_t)(t0 + c);
      vals[out + i] = __ldg(xr + c);
    }
    group_sync<kWarp>();  // the buffers are the next round's
    prev = th;
    have_prev = true;
  }
  // A tile shorter than k: NaN (after every real entry) and column -1.
  for (int i = k + t; i < sh.k; i += G) {
    idx[row * (long long)sh.k + i] = -1;
    vals[row * (long long)sh.k + i] = __int_as_float(0x7FFFFFFF);
  }
}

struct Plan {
  bool warp, smem_row;
  int threads;
  unsigned grid;
  size_t smem;
  Shape sh;
};

// `rows` rows (input rows times tiles) of `tile_w` columns of input rows of
// n columns, k ranks each.
Plan plan(int rows, int n, int tiles, int tile_w, int k) {
  Plan p{};
  p.warp = tile_w <= kWarpRowMax;
  p.smem_row = tile_w <= kSmemRowMax;
  int G = 32;
  if (!p.warp) {
    G = 64;
    while (G < 1024 && G * 32 < tile_w) G <<= 1;
  }
  const int nw = G / 32;
  p.sh.rows = rows;
  p.sh.n = n;
  p.sh.k = k;
  p.sh.tiles = tiles;
  p.sh.tile_w = tile_w;
  p.sh.chunk = p.warp ? k : (k < kChunk ? k : kChunk);
  p.sh.cap = 1;
  while (p.sh.cap < p.sh.chunk) p.sh.cap <<= 1;
  const size_t words = kScal + kRed + (size_t)nw * kBins + 2 * (size_t)p.sh.cap +
                       (p.smem_row ? (size_t)tile_w : 0);
  p.sh.group_words = (int)words;
  p.threads = p.warp ? 32 * kWarpRows : G;
  p.smem = words * sizeof(uint32_t) * (p.warp ? kWarpRows : 1);
  p.grid = p.warp ? (unsigned)((rows + kWarpRows - 1) / kWarpRows) : (unsigned)rows;
  return p;
}

// Lets the kernel form `which` take up to kSmemOptIn bytes of dynamic
// shared memory, once per device.
cudaError_t opt_in(const void* fn, int which) {
  static bool ready[64][3] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev][which]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
    if (e != cudaSuccess) return e;
    ready[dev][which] = true;
  }
  return cudaSuccess;
}

cudaError_t launch(const Plan& p, const float* x, float* vals, int64_t* idx,
                   const int64_t* colmap, cudaStream_t s) {
  cudaError_t e;
  if (p.warp) {
    if ((e = opt_in((const void*)topk_select_kernel<true, true>, 0)) != cudaSuccess) return e;
    topk_select_kernel<true, true><<<p.grid, p.threads, p.smem, s>>>(x, vals, idx, colmap, p.sh);
  } else if (p.smem_row) {
    if ((e = opt_in((const void*)topk_select_kernel<false, true>, 1)) != cudaSuccess) return e;
    topk_select_kernel<false, true><<<p.grid, p.threads, p.smem, s>>>(x, vals, idx, colmap, p.sh);
  } else {
    if ((e = opt_in((const void*)topk_select_kernel<false, false>, 2)) != cudaSuccess) return e;
    topk_select_kernel<false, false><<<p.grid, p.threads, p.smem, s>>>(x, vals, idx, colmap,
                                                                       p.sh);
  }
  return cudaGetLastError();
}

}  // namespace

// Tiles a row of n columns is cut into for a k-select (1: none).  The
// wrapper gives spf_topk_select (rows * tiles, k) f32 and int64 scratch
// when this is above 1.
extern "C" int spf_topk_select_tiles(int rows, int n, int k) {
  if (n <= kSmemRowMax || k <= 0) return 1;
  const long long tiles = (n + (long long)kSmemRowMax - 1) / kSmemRowMax;
  if (tiles * k > kSmemRowMax || tiles * rows >= (1LL << 31)) return 1;
  return (int)tiles;
}

// x (rows, n) f32 row-major; vals (rows, k) f32 and idx (rows, k) int64
// written; tile_vals and tile_idx: spf_topk_select_tiles' scratch (null
// when it is 1).  1 <= k <= n; the wrapper checks dtype, contiguity and
// ranges.
extern "C" int spf_topk_select(const void* x, void* vals, void* idx, void* tile_vals,
                               void* tile_idx, int rows, int n, int k, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int64_t* ip = static_cast<int64_t*>(idx);
  const int tiles = spf_topk_select_tiles(rows, n, k);
  if (tiles == 1) return (int)launch(plan(rows, n, 1, n, k), xp, vp, ip, nullptr, s);
  if (tile_vals == nullptr || tile_idx == nullptr) return (int)cudaErrorInvalidValue;
  float* tv = static_cast<float*>(tile_vals);
  int64_t* ti = static_cast<int64_t*>(tile_idx);
  const cudaError_t e =
      launch(plan(rows * tiles, n, tiles, kSmemRowMax, k), xp, tv, ti, nullptr, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(plan(rows, tiles * k, 1, tiles * k, k), tv, vp, ip, ti, s);
}
