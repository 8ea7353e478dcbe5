// Native dataset I/O of raft_tpu_torch (host code, no CUDA): the
// reference's C++ dataset machinery (bench/ann/src/common/dataset.hpp:
// BinFile<T> mmap loader with header parse + subset windows, and the
// conversion tooling under raft-ann-bench/get_dataset/).
//
// A plain C ABI consumed from Python via ctypes (raft_tpu_torch/io/
// binfile.py), built by raft_tpu_torch/ops/_build.py with
// `g++ -O3 -std=c++17 -shared -fPIC -pthread`. Formats:
//   .fbin / .u8bin / .i8bin / .ibin : int32 n_rows, int32 dim, then the
//   row-major payload of float32 / uint8 / int8 / int32 (the
//   big-ann-benchmarks layout).
//
// Capabilities beyond np.memmap (why this is native):
//   - threaded strided reads: subsetting a row range fans out across
//     N threads of pread(2), saturating NVMe/page-cache far better than
//     a single-thread numpy copy for 100M+ row datasets;
//   - a background thread that reads chunk i+1 while chunk i is used
//     (rt_io_pipeline_*);
//   - bounds-checked header validation with errno-style reporting;
//   - a streaming writer that fixes up the header count at close.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct BinFile {
  int fd = -1;
  void* map = nullptr;
  size_t file_bytes = 0;
  int64_t n_rows = 0;
  int64_t dim = 0;
  int64_t elem_size = 0;  // bytes per element
  std::string error;
};

thread_local std::string g_last_error;

void set_error(BinFile* f, const std::string& msg) {
  if (f) f->error = msg;
  g_last_error = msg;
}

}  // namespace

extern "C" {

// Open a *.bin file (fbin/u8bin/i8bin): parses the (n, dim) header and
// mmaps the payload read-only. elem_size selects the dtype width.
// Returns an opaque handle or nullptr (see rt_io_last_error).
void* rt_io_open(const char* path, int64_t elem_size) {
  auto* f = new BinFile();
  f->elem_size = elem_size;
  f->fd = ::open(path, O_RDONLY);
  if (f->fd < 0) {
    set_error(nullptr, std::string("open failed: ") + std::strerror(errno));
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0) {
    set_error(nullptr, std::string("fstat failed: ") + std::strerror(errno));
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->file_bytes = static_cast<size_t>(st.st_size);
  if (f->file_bytes < 8) {
    set_error(nullptr, "file too small for (n, dim) header");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  int32_t header[2];
  if (pread(f->fd, header, 8, 0) != 8) {
    set_error(nullptr, "header read failed");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->n_rows = header[0];
  f->dim = header[1];
  if (f->n_rows < 0 || f->dim <= 0) {
    set_error(nullptr, "invalid header: negative n or non-positive dim");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  size_t expected =
      8 + static_cast<size_t>(f->n_rows) * f->dim * f->elem_size;
  if (expected > f->file_bytes) {
    set_error(nullptr, "file truncated: header promises " +
                           std::to_string(expected) + " bytes, have " +
                           std::to_string(f->file_bytes));
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->map = mmap(nullptr, f->file_bytes, PROT_READ, MAP_SHARED, f->fd, 0);
  if (f->map == MAP_FAILED) {
    f->map = nullptr;  // reads fall back to pread
  } else {
    madvise(f->map, f->file_bytes, MADV_SEQUENTIAL);
  }
  return f;
}

int64_t rt_io_rows(void* handle) { return static_cast<BinFile*>(handle)->n_rows; }
int64_t rt_io_dim(void* handle) { return static_cast<BinFile*>(handle)->dim; }

const char* rt_io_last_error() { return g_last_error.c_str(); }

// Copy rows [row_start, row_start + n) into out. Fans the copy out over
// n_threads (0 = hardware concurrency, capped at 16). Returns 0 on
// success, -1 on bounds error.
int rt_io_read_rows(void* handle, int64_t row_start, int64_t n, void* out,
                    int n_threads) {
  auto* f = static_cast<BinFile*>(handle);
  if (row_start < 0 || n < 0 || row_start + n > f->n_rows) {
    set_error(f, "read_rows out of bounds");
    return -1;
  }
  const int64_t row_bytes = f->dim * f->elem_size;
  const size_t offset = 8 + static_cast<size_t>(row_start) * row_bytes;
  const size_t total = static_cast<size_t>(n) * row_bytes;

  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc == 0 ? 4 : static_cast<int>(hc);
  }
  if (n_threads > 16) n_threads = 16;
  if (total < (1u << 22)) n_threads = 1;  // small read: threads not worth it

  std::atomic<int> failed{0};
  auto worker = [&](int t) {
    size_t chunk = total / n_threads;
    size_t begin = t * chunk;
    size_t end = (t == n_threads - 1) ? total : begin + chunk;
    if (f->map != nullptr) {
      std::memcpy(static_cast<char*>(out) + begin,
                  static_cast<const char*>(f->map) + offset + begin,
                  end - begin);
    } else {
      size_t pos = begin;
      while (pos < end) {
        ssize_t got = pread(f->fd, static_cast<char*>(out) + pos,
                            end - pos, offset + pos);
        if (got <= 0) {
          failed.store(1);
          return;
        }
        pos += static_cast<size_t>(got);
      }
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  if (failed.load()) {
    set_error(f, "pread failed mid-copy");
    return -1;
  }
  return 0;
}

void rt_io_close(void* handle) {
  auto* f = static_cast<BinFile*>(handle);
  if (f->map != nullptr) munmap(f->map, f->file_bytes);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

// Streaming writer: create a bin file with a (n, dim) header; rows are
// appended with rt_io_append_rows and the header count is fixed up at
// close (n passed here may be 0 when unknown).
void* rt_io_create(const char* path, int64_t n_rows, int64_t dim,
                   int64_t elem_size) {
  auto* f = new BinFile();
  f->elem_size = elem_size;
  f->dim = dim;
  f->n_rows = 0;
  f->fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (f->fd < 0) {
    set_error(nullptr, std::string("create failed: ") + std::strerror(errno));
    delete f;
    return nullptr;
  }
  int32_t header[2] = {static_cast<int32_t>(n_rows),
                       static_cast<int32_t>(dim)};
  if (write(f->fd, header, 8) != 8) {
    set_error(nullptr, "header write failed");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  return f;
}

int rt_io_append_rows(void* handle, const void* data, int64_t n) {
  auto* f = static_cast<BinFile*>(handle);
  size_t bytes = static_cast<size_t>(n) * f->dim * f->elem_size;
  size_t pos = 0;
  while (pos < bytes) {
    ssize_t put = write(f->fd, static_cast<const char*>(data) + pos,
                        bytes - pos);
    if (put <= 0) {
      set_error(f, std::string("write failed: ") + std::strerror(errno));
      return -1;
    }
    pos += static_cast<size_t>(put);
  }
  f->n_rows += n;
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetching chunk pipeline: a background thread reads chunk i+1 while
// the caller consumes chunk i (double-buffered). This is the streaming
// ingestion path for 100M+-row datasets — the role the reference's
// subset-window BinFile plays for its batched index builds, plus
// read-ahead the reference leaves to the page cache.
// ---------------------------------------------------------------------------

namespace {

struct Pipeline {
  BinFile* file = nullptr;
  int64_t chunk_rows = 0;
  int n_threads = 0;
  int64_t next_row = 0;          // next row the reader will fetch
  std::vector<char> buf[2];
  int64_t buf_rows[2] = {0, 0};  // rows in each buffer (0 = empty)
  int64_t buf_first[2] = {-1, -1};
  bool buf_ready[2] = {false, false};
  int consume_slot = 0;          // next slot handed to the caller
  int last_returned = -1;        // slot whose lifetime ends on next call
  bool done = false;             // reader reached EOF
  bool failed = false;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv;
  std::thread reader;
};

void pipeline_reader(Pipeline* p) {
  int fill_slot = 0;
  for (;;) {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->stop || !p->buf_ready[fill_slot]; });
    if (p->stop) return;
    int64_t row = p->next_row;
    if (row >= p->file->n_rows) {
      p->done = true;
      p->cv.notify_all();
      return;
    }
    int64_t n = p->file->n_rows - row;
    if (n > p->chunk_rows) n = p->chunk_rows;
    p->next_row = row + n;
    lk.unlock();

    int rc = rt_io_read_rows(p->file, row, n, p->buf[fill_slot].data(),
                             p->n_threads);

    lk.lock();
    if (rc != 0) {
      p->failed = true;
      p->cv.notify_all();
      return;
    }
    p->buf_rows[fill_slot] = n;
    p->buf_first[fill_slot] = row;
    p->buf_ready[fill_slot] = true;
    p->cv.notify_all();
    fill_slot ^= 1;
  }
}

}  // namespace

// Start a prefetching reader over an open rt_io handle. The pipeline
// owns read positions [0, n_rows) in chunk_rows steps.
void* rt_io_pipeline_start(void* handle, int64_t chunk_rows, int n_threads) {
  auto* f = static_cast<BinFile*>(handle);
  if (chunk_rows <= 0) {
    set_error(f, "pipeline chunk_rows must be positive");
    return nullptr;
  }
  auto* p = new Pipeline();
  p->file = f;
  p->chunk_rows = chunk_rows;
  p->n_threads = n_threads;
  size_t bytes = static_cast<size_t>(chunk_rows) * f->dim * f->elem_size;
  p->buf[0].resize(bytes);
  p->buf[1].resize(bytes);
  p->reader = std::thread(pipeline_reader, p);
  return p;
}

// Block until the next chunk is ready. On success returns 0 and fills
// (*data, *first_row, *n_rows); the buffer stays valid until the NEXT
// rt_io_pipeline_next call. Returns 1 at end-of-file, -1 on read error.
int rt_io_pipeline_next(void* pipe, void** data, int64_t* first_row,
                        int64_t* n_rows) {
  auto* p = static_cast<Pipeline*>(pipe);
  std::unique_lock<std::mutex> lk(p->mu);
  // the buffer handed out by the previous call dies now — release it
  // so the reader can refill it
  if (p->last_returned >= 0) {
    p->buf_ready[p->last_returned] = false;
    p->last_returned = -1;
    p->cv.notify_all();
  }
  int slot = p->consume_slot;
  p->cv.wait(lk, [&] {
    return p->buf_ready[slot] || p->done || p->failed;
  });
  if (p->failed) return -1;
  if (!p->buf_ready[slot]) return 1;  // done and nothing buffered
  *data = p->buf[slot].data();
  *first_row = p->buf_first[slot];
  *n_rows = p->buf_rows[slot];
  p->last_returned = slot;
  p->consume_slot = slot ^ 1;
  return 0;
}

void rt_io_pipeline_close(void* pipe) {
  auto* p = static_cast<Pipeline*>(pipe);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv.notify_all();
  if (p->reader.joinable()) p->reader.join();
  delete p;
}

int rt_io_close_writer(void* handle) {
  auto* f = static_cast<BinFile*>(handle);
  int32_t n = static_cast<int32_t>(f->n_rows);
  int rc = 0;
  if (pwrite(f->fd, &n, 4, 0) != 4) {
    set_error(f, "header fixup failed");
    rc = -1;
  }
  ::close(f->fd);
  delete f;
  return rc;
}

}  // extern "C"
