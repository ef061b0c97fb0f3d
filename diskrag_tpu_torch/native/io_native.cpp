// Native host-tier IO for diskrag_tpu_torch (a copy of the JAX package's
// diskrag_tpu/native/io_native.cpp; the two read the same record file).
//
// The batched equivalent of the reference's disk tier
// (MMapNodeReader: mmap + per-node seek + Python OrderedDict LRU,
// reference pydiskann/io/diskann_persist.py:209-235). The host tier
// must feed *batched* rerank fetches, so the unit of work here is a
// batched gather: given a list of node ids, return their full-precision
// vectors (and optionally neighbor lists) in one call, served from an
// mmap'd record file through a sharded LRU cache, with multi-threaded
// copy-out for large batches.
//
// Record format: float32[dim] vector ‖ uint32[R] neighbors,
// record_size = 4*(dim+R), padding slot = 0xFFFFFFFF
// (see diskrag_tpu_torch/index/persist.py write_compat_records).
//
// C ABI (used via ctypes from diskrag_tpu_torch.native):
//   void* drag_open(const char* path, int64 n, int32 dim, int32 r,
//                   int64 cache_capacity);
//   int   drag_get_vectors(void* h, const int64* ids, int64 count,
//                          float* out /* [count, dim] */, int32 n_threads);
//   int   drag_get_nodes(void* h, const int64* ids, int64 count,
//                        float* out_vecs, int32* out_nbrs, int32 n_threads);
//   int64 drag_cache_hits(void* h);
//   int64 drag_cache_misses(void* h);
//   void  drag_close(void* h);
//
// Returns 0 on success, negative on error. Out-of-range ids fill zeros /
// -1 neighbors. The LRU exists to serve skewed (hot-node) traversal
// workloads; sequential rerank scans mostly stream past it, so it is
// sharded and lock-cheap rather than strictly exact.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <list>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct LruShard {
  // id -> cache slot index; slots hold copies of full records
  std::mutex mu;
  std::unordered_map<int64_t, std::list<int64_t>::iterator> pos;
  std::list<int64_t> order;  // front = most recent
  std::unordered_map<int64_t, std::vector<uint8_t>> data;
  size_t capacity = 0;

  bool get(int64_t id, uint8_t* out, size_t record_size) {
    std::lock_guard<std::mutex> g(mu);
    auto it = pos.find(id);
    if (it == pos.end()) return false;
    order.splice(order.begin(), order, it->second);
    std::memcpy(out, data[id].data(), record_size);
    return true;
  }

  void put(int64_t id, const uint8_t* rec, size_t record_size) {
    std::lock_guard<std::mutex> g(mu);
    if (pos.count(id)) return;
    if (capacity && order.size() >= capacity) {
      int64_t victim = order.back();
      order.pop_back();
      pos.erase(victim);
      data.erase(victim);
    }
    order.push_front(id);
    pos[id] = order.begin();
    data[id].assign(rec, rec + record_size);
  }
};

constexpr int kShards = 16;

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;
  int64_t n = 0;
  int32_t dim = 0;
  int32_t r = 0;
  size_t record_size = 0;
  LruShard lru[kShards];
  std::atomic<int64_t> hits{0}, misses{0};
  bool use_cache = false;
  size_t cache_capacity = 0;

  const uint8_t* record(int64_t id) const {
    return base + (size_t)id * record_size;
  }
};

// Initiate kernel readahead for the pages the gather will touch.
// Only runs when ids are ascending (the rerank path dedups+sorts);
// nearby records coalesce into ranges so one madvise covers many page
// faults. Without this, MADV_RANDOM on the mapping means every 4 KB
// page faults synchronously: measured 7 MB/s cold vs ~2 GB/s warm.
void prefetch_sorted(Reader* rd, const int64_t* ids, int64_t count) {
  constexpr int64_t kMergeGap = 128 * 1024;  // bytes
  const int64_t page_mask = ~(int64_t)4095;
  int64_t start = -1, end = -1;
  for (int64_t i = 0; i < count; ++i) {
    int64_t id = ids[i];
    if (id < 0 || id >= rd->n) continue;
    if (i > 0 && ids[i] < ids[i - 1]) return;  // not sorted: skip entirely
    int64_t off = (int64_t)((size_t)id * rd->record_size) & page_mask;
    int64_t stop =
        ((int64_t)((size_t)(id + 1) * rd->record_size) + 4095) & page_mask;
    if (start < 0) {
      start = off;
      end = stop;
    } else if (off - end <= kMergeGap) {
      if (stop > end) end = stop;
    } else {
      madvise(const_cast<uint8_t*>(rd->base) + start, end - start,
              MADV_WILLNEED);
      start = off;
      end = stop;
    }
  }
  if (start >= 0)
    madvise(const_cast<uint8_t*>(rd->base) + start, end - start,
            MADV_WILLNEED);
}

void fetch_range(Reader* rd, const int64_t* ids, int64_t lo, int64_t hi,
                 float* out_vecs, int32_t* out_nbrs, bool use_cache) {
  const size_t vec_bytes = (size_t)rd->dim * 4;
  std::vector<uint8_t> tmp(rd->record_size);
  for (int64_t i = lo; i < hi; ++i) {
    int64_t id = ids[i];
    float* vdst = out_vecs + (size_t)i * rd->dim;
    int32_t* ndst = out_nbrs ? out_nbrs + (size_t)i * rd->r : nullptr;
    if (id < 0 || id >= rd->n) {
      std::memset(vdst, 0, vec_bytes);
      if (ndst)
        for (int32_t j = 0; j < rd->r; ++j) ndst[j] = -1;
      continue;
    }
    const uint8_t* rec = nullptr;
    if (use_cache) {
      LruShard& shard = rd->lru[id % kShards];
      if (shard.get(id, tmp.data(), rd->record_size)) {
        rd->hits.fetch_add(1, std::memory_order_relaxed);
        rec = tmp.data();
      } else {
        rd->misses.fetch_add(1, std::memory_order_relaxed);
        rec = rd->record(id);
        shard.put(id, rec, rd->record_size);
      }
    } else {
      rec = rd->record(id);
    }
    std::memcpy(vdst, rec, vec_bytes);
    if (ndst) {
      const uint32_t* nb =
          reinterpret_cast<const uint32_t*>(rec + vec_bytes);
      for (int32_t j = 0; j < rd->r; ++j)
        ndst[j] = nb[j] == 0xFFFFFFFFu ? -1 : (int32_t)nb[j];
    }
  }
}

int gather(Reader* rd, const int64_t* ids, int64_t count, float* out_vecs,
           int32_t* out_nbrs, int32_t n_threads) {
  if (!rd || !ids || !out_vecs || count < 0) return -1;
  // The LRU serves skewed small-batch traversal lookups. A large batch
  // (the deduped rerank gather) streams past any cache: hit rates are
  // low and the per-record mutex+hashmap+copy costs ~5x the read
  // itself (measured 195 ms vs 35 ms for a warm 144k-row gather), so
  // bypass when the batch would churn a meaningful share of the cache.
  bool use_cache =
      rd->use_cache && (size_t)count < rd->cache_capacity / 4;
  if (count >= 1024) prefetch_sorted(rd, ids, count);
  if (n_threads <= 1 || count < 4096) {
    fetch_range(rd, ids, 0, count, out_vecs, out_nbrs, use_cache);
    return 0;
  }
  int32_t t = n_threads;
  int64_t chunk = (count + t - 1) / t;
  std::vector<std::thread> threads;
  for (int32_t i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min<int64_t>(count, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fetch_range, rd, ids, lo, hi, out_vecs, out_nbrs,
                         use_cache);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // namespace

extern "C" {

void* drag_open(const char* path, int64_t n, int32_t dim, int32_t r,
                int64_t cache_capacity) {
  auto* rd = new Reader();
  rd->n = n;
  rd->dim = dim;
  rd->r = r;
  rd->record_size = 4 * ((size_t)dim + r);
  rd->fd = open(path, O_RDONLY);
  if (rd->fd < 0) {
    delete rd;
    return nullptr;
  }
  struct stat st;
  if (fstat(rd->fd, &st) != 0 ||
      (size_t)st.st_size < rd->record_size * (size_t)n) {
    close(rd->fd);
    delete rd;
    return nullptr;
  }
  rd->file_size = st.st_size;
  void* m = mmap(nullptr, rd->file_size, PROT_READ, MAP_SHARED, rd->fd, 0);
  if (m == MAP_FAILED) {
    close(rd->fd);
    delete rd;
    return nullptr;
  }
  madvise(m, rd->file_size, MADV_RANDOM);
  rd->base = static_cast<const uint8_t*>(m);
  rd->use_cache = cache_capacity > 0;
  rd->cache_capacity = rd->use_cache ? (size_t)cache_capacity : 0;
  if (rd->use_cache) {
    size_t per = (size_t)cache_capacity / kShards + 1;
    for (auto& s : rd->lru) s.capacity = per;
  }
  return rd;
}

int drag_get_vectors(void* h, const int64_t* ids, int64_t count, float* out,
                     int32_t n_threads) {
  return gather(static_cast<Reader*>(h), ids, count, out, nullptr, n_threads);
}

int drag_get_nodes(void* h, const int64_t* ids, int64_t count,
                   float* out_vecs, int32_t* out_nbrs, int32_t n_threads) {
  return gather(static_cast<Reader*>(h), ids, count, out_vecs, out_nbrs,
                n_threads);
}

int64_t drag_cache_hits(void* h) {
  return static_cast<Reader*>(h)->hits.load();
}

int64_t drag_cache_misses(void* h) {
  return static_cast<Reader*>(h)->misses.load();
}

void drag_close(void* h) {
  auto* rd = static_cast<Reader*>(h);
  if (!rd) return;
  if (rd->base) munmap(const_cast<uint8_t*>(rd->base), rd->file_size);
  if (rd->fd >= 0) close(rd->fd);
  delete rd;
}

}  // extern "C"
