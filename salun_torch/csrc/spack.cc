// spack — a memory-mapped packed-dataset reader for the salun_torch data
// layer (the port's own copy of the JAX package's reader; the same SPK1
// format, so a file written by either package reads in the other).
//
// Native-equivalent of the reference's LMDB pipeline
// (Classification/lmdb_dataset.py:22-128 ImageFolderLMDB + folder2lmdb):
// one file holds N fixed- or variable-size records plus labels; readers
// mmap it and gather batches with multithreaded memcpy — the host-side hot
// path that feeds uint8 batches to the GPU without Python per-sample
// overhead.
//
// Layout (little endian):
//   [0..4)    magic "SPK1"
//   [4..12)   u64 record count N
//   [12..20)  u64 index offset
//   [20..)    record payloads (back to back)
//   index:    N × { u64 offset, u64 size, i64 label }
//
// Built at first use by salun_torch/kernels/_build.py:
//   g++ -O3 -fPIC -shared -std=c++17 -pthread

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct IndexEntry {
  uint64_t offset;
  uint64_t size;
  int64_t label;
};

struct Pack {
  int fd = -1;
  const uint8_t *base = nullptr;
  size_t file_size = 0;
  uint64_t count = 0;
  const IndexEntry *index = nullptr;
};

struct GatherJob {
  const Pack *pack;
  const int64_t *indices;
  uint8_t *out;
  uint64_t record_size;
  uint64_t begin, end;
};

void *gather_worker(void *arg) {
  auto *job = static_cast<GatherJob *>(arg);
  for (uint64_t i = job->begin; i < job->end; ++i) {
    const IndexEntry &e = job->pack->index[job->indices[i]];
    uint64_t n = e.size < job->record_size ? e.size : job->record_size;
    std::memcpy(job->out + i * job->record_size, job->pack->base + e.offset,
                n);
  }
  return nullptr;
}

}  // namespace

extern "C" {

void *spack_open(const char *path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void *base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t *b = static_cast<const uint8_t *>(base);
  if (st.st_size < 20 || std::memcmp(b, "SPK1", 4) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  // the header, the index and every record must lie inside the file: a
  // truncated or corrupt file is refused here, so that no later read
  // leaves the mapping
  const uint64_t size = static_cast<uint64_t>(st.st_size);
  uint64_t count, index_offset;
  std::memcpy(&count, b + 4, 8);
  std::memcpy(&index_offset, b + 12, 8);
  bool ok = index_offset >= 20 && index_offset <= size &&
            count <= (size - index_offset) / sizeof(IndexEntry);
  const IndexEntry *index =
      ok ? reinterpret_cast<const IndexEntry *>(b + index_offset) : nullptr;
  for (uint64_t i = 0; ok && i < count; ++i) {
    IndexEntry e;
    std::memcpy(&e, index + i, sizeof(e));
    ok = e.offset <= size && e.size <= size - e.offset;
  }
  if (!ok) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto *p = new Pack();
  p->fd = fd;
  p->base = b;
  p->file_size = st.st_size;
  p->count = count;
  p->index = index;
  // advise the kernel we'll read randomly
  madvise(base, st.st_size, MADV_RANDOM);
  return p;
}

uint64_t spack_count(void *handle) {
  return handle ? static_cast<Pack *>(handle)->count : 0;
}

int64_t spack_label(void *handle, uint64_t i) {
  auto *p = static_cast<Pack *>(handle);
  return p->index[i].label;
}

uint64_t spack_record_size(void *handle, uint64_t i) {
  auto *p = static_cast<Pack *>(handle);
  return p->index[i].size;
}

// Copy record i into out (caller allocates >= size). Returns bytes copied.
uint64_t spack_get(void *handle, uint64_t i, uint8_t *out, uint64_t cap) {
  auto *p = static_cast<Pack *>(handle);
  const IndexEntry &e = p->index[i];
  uint64_t n = e.size < cap ? e.size : cap;
  std::memcpy(out, p->base + e.offset, n);
  return n;
}

// Gather `n` fixed-size records given by `indices` into a contiguous batch
// buffer, with `threads` workers. Also fills `labels`.
void spack_gather(void *handle, const int64_t *indices, uint64_t n,
                  uint8_t *out, uint64_t record_size, int64_t *labels,
                  int threads) {
  auto *p = static_cast<Pack *>(handle);
  if (n == 0) return;
  for (uint64_t i = 0; i < n; ++i) labels[i] = p->index[indices[i]].label;
  if (threads < 1) threads = 1;
  if (static_cast<uint64_t>(threads) > n) threads = static_cast<int>(n);
  GatherJob jobs[64];
  pthread_t tids[64];
  if (threads > 64) threads = 64;
  uint64_t chunk = (n + threads - 1) / threads;
  int spawned = 0;
  for (int t = 0; t < threads; ++t) {
    uint64_t b = t * chunk;
    uint64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    jobs[t] = GatherJob{p, indices, out, record_size, b, e};
    if (t == threads - 1 || (t + 1) * chunk >= n) {
      gather_worker(&jobs[t]);  // run the last chunk inline
    } else {
      pthread_create(&tids[spawned], nullptr, gather_worker, &jobs[t]);
      ++spawned;
    }
  }
  for (int t = 0; t < spawned; ++t) pthread_join(tids[t], nullptr);
}

void spack_close(void *handle) {
  auto *p = static_cast<Pack *>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t *>(p->base), p->file_size);
  ::close(p->fd);
  delete p;
}

}  // extern "C"
