// spfresh_native — host-side native runtime of spfresh_tpu_torch's disk tier
// (a copy owned by the port of spfresh_tpu/native/src/spfresh_native.cpp,
// with the same C ABI and file formats).
//
// The compute path runs on the card (csrc/*.cu); the host runtime around it
// is native here: mmap'd posting storage, vecs-format IO, and an async
// batched gather that stages posting slabs in RAM ahead of the upload (the
// host half of the disk -> host -> device streaming pipeline).
//
// Exposed as a C ABI consumed via ctypes; built at first use by
// spfresh_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC -pthread.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

struct MappedFile {
  void* base = nullptr;
  size_t size = 0;
};

bool map_file(const char* path, MappedFile* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return false;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return false;
  out->base = base;
  out->size = static_cast<size_t>(st.st_size);
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Packed CSR postings file (format: spfresh_tpu_torch/index/posting_store.py)
//   magic "SPFCSR1\0" | C:i32 | P:i64 | dim:i32 | cluster_ids[C]:i64 |
//   offsets[C+1]:i64 | ids[P]:i64 | vectors[P*dim]:f32
// ---------------------------------------------------------------------------

struct CsrHandle {
  MappedFile map;
  int32_t num_clusters = 0;
  int64_t num_points = 0;
  int32_t dim = 0;
  const int64_t* cluster_ids = nullptr;
  const int64_t* offsets = nullptr;
  const int64_t* ids = nullptr;
  const float* vectors = nullptr;
};

API void* spf_csr_open(const char* path) {
  auto* h = new CsrHandle();
  if (!map_file(path, &h->map)) {
    delete h;
    return nullptr;
  }
  const char* p = static_cast<const char*>(h->map.base);
  if (h->map.size < 24 || memcmp(p, "SPFCSR1\0", 8) != 0) {
    munmap(h->map.base, h->map.size);
    delete h;
    return nullptr;
  }
  memcpy(&h->num_clusters, p + 8, 4);
  memcpy(&h->num_points, p + 12, 8);
  memcpy(&h->dim, p + 20, 4);
  const char* cur = p + 24;
  h->cluster_ids = reinterpret_cast<const int64_t*>(cur);
  cur += 8ll * h->num_clusters;
  h->offsets = reinterpret_cast<const int64_t*>(cur);
  cur += 8ll * (h->num_clusters + 1);
  h->ids = reinterpret_cast<const int64_t*>(cur);
  cur += 8ll * h->num_points;
  h->vectors = reinterpret_cast<const float*>(cur);
  return h;
}

API void spf_csr_close(void* handle) {
  auto* h = static_cast<CsrHandle*>(handle);
  if (!h) return;
  munmap(h->map.base, h->map.size);
  delete h;
}

API int32_t spf_csr_num_clusters(void* handle) {
  return static_cast<CsrHandle*>(handle)->num_clusters;
}
API int64_t spf_csr_num_points(void* handle) {
  return static_cast<CsrHandle*>(handle)->num_points;
}
API int32_t spf_csr_dim(void* handle) {
  return static_cast<CsrHandle*>(handle)->dim;
}
API const int64_t* spf_csr_cluster_ids(void* handle) {
  return static_cast<CsrHandle*>(handle)->cluster_ids;
}
API const int64_t* spf_csr_offsets(void* handle) {
  return static_cast<CsrHandle*>(handle)->offsets;
}

// Zero-copy pointers into the mapping for one posting list.
API int64_t spf_csr_posting(void* handle, int32_t index, const int64_t** ids,
                            const float** vectors) {
  auto* h = static_cast<CsrHandle*>(handle);
  if (index < 0 || index >= h->num_clusters) return -1;
  int64_t s = h->offsets[index], e = h->offsets[index + 1];
  *ids = h->ids + s;
  *vectors = h->vectors + s * h->dim;
  return e - s;
}

// Copy a batch of posting lists into a caller-provided padded slab
// (count, pad, dim) — the host-side staging step before device upload.
API int32_t spf_csr_gather_padded(void* handle, const int32_t* indices,
                                  int32_t count, int32_t pad, float* out_vecs,
                                  int64_t* out_ids, int32_t* out_lens) {
  auto* h = static_cast<CsrHandle*>(handle);
  const int32_t dim = h->dim;
  for (int32_t i = 0; i < count; ++i) {
    int32_t idx = indices[i];
    if (idx < 0 || idx >= h->num_clusters) return -1;
    int64_t s = h->offsets[idx];
    int64_t len = h->offsets[idx + 1] - s;
    if (len > pad) len = pad;
    out_lens[i] = static_cast<int32_t>(len);
    memcpy(out_vecs + (int64_t)i * pad * dim, h->vectors + s * dim,
           (size_t)len * dim * sizeof(float));
    memset(out_vecs + ((int64_t)i * pad + len) * dim, 0,
           (size_t)(pad - len) * dim * sizeof(float));
    memcpy(out_ids + (int64_t)i * pad, h->ids + s, (size_t)len * sizeof(int64_t));
    for (int64_t j = len; j < pad; ++j) out_ids[(int64_t)i * pad + j] = -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// vecs-format IO (fvecs / ivecs / bvecs): [dim:i32][payload]*
// ---------------------------------------------------------------------------

API int64_t spf_vecs_shape(const char* path, int32_t elem_size, int32_t* dim_out) {
  MappedFile m;
  if (!map_file(path, &m)) return -1;
  if (m.size < 4) {
    munmap(m.base, m.size);
    return -1;
  }
  int32_t dim;
  memcpy(&dim, m.base, 4);
  size_t rec = 4 + (size_t)dim * elem_size;
  int64_t n = (dim > 0 && m.size % rec == 0) ? (int64_t)(m.size / rec) : -1;
  munmap(m.base, m.size);
  *dim_out = dim;
  return n;
}

// Strided copy of every record's payload into a dense (n, dim) buffer.
API int32_t spf_vecs_read(const char* path, int32_t elem_size, void* out) {
  MappedFile m;
  if (!map_file(path, &m)) return -1;
  int32_t dim;
  memcpy(&dim, m.base, 4);
  size_t rec = 4 + (size_t)dim * elem_size;
  if (dim <= 0 || m.size % rec != 0) {
    munmap(m.base, m.size);
    return -1;
  }
  int64_t n = m.size / rec;
  const char* src = static_cast<const char*>(m.base);
  char* dst = static_cast<char*>(out);
  size_t payload = (size_t)dim * elem_size;
  for (int64_t i = 0; i < n; ++i) {
    int32_t rdim;
    memcpy(&rdim, src + i * rec, 4);
    if (rdim != dim) {
      munmap(m.base, m.size);
      return -2;  // inconsistent record dims
    }
    memcpy(dst + i * payload, src + i * rec + 4, payload);
  }
  munmap(m.base, m.size);
  return 0;
}

// ---------------------------------------------------------------------------
// Async padded gather: stage the NEXT query batch's posting slabs on a
// background thread while the device reranks the current one (the host half
// of the disk -> host -> device double-buffer pipeline).  The caller owns the
// output buffers and must keep them alive until spf_csr_gather_join.
// ---------------------------------------------------------------------------

struct GatherJob {
  std::thread worker;
  int32_t rc = 0;
};

API void* spf_csr_gather_async(void* handle, const int32_t* indices,
                               int32_t count, int32_t pad, float* out_vecs,
                               int64_t* out_ids, int32_t* out_lens) {
  auto* job = new GatherJob();
  // Copy the index list: the caller's array may be freed before the join.
  std::vector<int32_t> idx(indices, indices + count);
  job->worker = std::thread([=, idx = std::move(idx)]() mutable {
    job->rc = spf_csr_gather_padded(handle, idx.data(), count, pad, out_vecs,
                                    out_ids, out_lens);
  });
  return job;
}

API int32_t spf_csr_gather_join(void* j) {
  auto* job = static_cast<GatherJob*>(j);
  job->worker.join();
  int32_t rc = job->rc;
  delete job;
  return rc;
}

API const char* spf_version() { return "spfresh-native 0.1.0 (spfresh_tpu_torch)"; }
