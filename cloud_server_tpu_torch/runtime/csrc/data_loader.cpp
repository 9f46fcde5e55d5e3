// Native shard reader + threaded batch prefetcher for the flat binary
// token format (see cloud_server_tpu_torch/data/dataset.py). Exposed as a
// plain C API consumed via ctypes (runtime/native.py).
//
// Reader: pread()-based window reads (thread-safe, no shared file offset),
// widening u16/u32 token files to the int32 the device pipeline wants.
//
// Prefetcher: N worker threads claim batch jobs in submission order and
// deposit finished buffers into a bounded reorder window; the consumer
// drains strictly in order. Workers gate on `job < next_out + depth` so
// the window can always accept the batch the consumer needs next —
// without that, depth filled-ahead slots could deadlock against an
// unfinished earlier job.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <new>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Reader {
  int fd = -1;
  uint64_t n_tokens = 0;
  uint64_t seq_len = 0;
  int dtype_size = 2;  // 2 = uint16 token files, 4 = int32
};

// Read one seq_len window of tokens at token offset `start` into out
// (int32). Returns 0 on success.
int read_window(const Reader& r, uint64_t start, int32_t* out) {
  const uint64_t nbytes = r.seq_len * r.dtype_size;
  std::vector<uint8_t> raw(nbytes);
  uint64_t off = start * r.dtype_size, got = 0;
  while (got < nbytes) {
    ssize_t n = pread(r.fd, raw.data() + got, nbytes - got, off + got);
    if (n <= 0) return -1;
    got += static_cast<uint64_t>(n);
  }
  if (r.dtype_size == 2) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(raw.data());
    for (uint64_t i = 0; i < r.seq_len; ++i) out[i] = p[i];
  } else {
    std::memcpy(out, raw.data(), nbytes);
  }
  return 0;
}

struct Prefetcher {
  Reader* reader = nullptr;
  std::vector<uint64_t> indices;  // window indices, already shuffled/sharded
  uint64_t batch = 0;
  uint64_t n_batches = 0;
  int depth = 2;

  std::atomic<uint64_t> next_job{0};
  uint64_t next_out = 0;
  std::map<uint64_t, std::vector<int32_t>> ready;
  std::mutex mu;
  std::condition_variable cv_ready;  // consumer waits: ready[next_out]
  std::condition_variable cv_space;  // workers wait: job < next_out + depth
  bool stopped = false;
  int error = 0;
  std::vector<std::thread> workers;
};

void prefetch_worker(Prefetcher* p) {
  const uint64_t batch_tokens = p->batch * p->reader->seq_len;
  for (;;) {
    const uint64_t job = p->next_job.fetch_add(1);
    if (job >= p->n_batches) return;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_space.wait(lk, [&] {
        return p->stopped || job < p->next_out + (uint64_t)p->depth;
      });
      if (p->stopped) return;
    }
    std::vector<int32_t> buf(batch_tokens);
    int err = 0;
    for (uint64_t b = 0; b < p->batch && !err; ++b) {
      const uint64_t w = p->indices[job * p->batch + b];
      err = read_window(*p->reader, w * p->reader->seq_len,
                        buf.data() + b * p->reader->seq_len);
    }
    std::lock_guard<std::mutex> lk(p->mu);
    if (err) p->error = err;
    p->ready.emplace(job, std::move(buf));
    p->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* csr_open(const char* path, uint64_t seq_len, int dtype_size) {
  if (seq_len == 0 || (dtype_size != 2 && dtype_size != 4)) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  auto* r = new (std::nothrow) Reader();
  if (!r) { close(fd); return nullptr; }
  r->fd = fd;
  r->n_tokens = static_cast<uint64_t>(st.st_size) / dtype_size;
  r->seq_len = seq_len;
  r->dtype_size = dtype_size;
  if (r->n_tokens / seq_len == 0) { close(fd); delete r; return nullptr; }
  return r;
}

uint64_t csr_num_windows(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->n_tokens / r->seq_len;
}

// Gather n windows by index into out (n * seq_len int32). Returns 0 on ok.
int csr_read_windows(void* h, const uint64_t* indices, uint64_t n,
                     int32_t* out) {
  auto* r = static_cast<Reader*>(h);
  const uint64_t nw = r->n_tokens / r->seq_len;
  for (uint64_t i = 0; i < n; ++i) {
    if (indices[i] >= nw) return -2;
    if (read_window(*r, indices[i] * r->seq_len, out + i * r->seq_len))
      return -1;
  }
  return 0;
}

void csr_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  close(r->fd);
  delete r;
}

void* csr_prefetch_start(void* h, const uint64_t* indices, uint64_t n_total,
                         uint64_t batch, int depth, int n_threads) {
  auto* r = static_cast<Reader*>(h);
  if (batch == 0 || n_total < batch || depth < 1 || n_threads < 1)
    return nullptr;
  const uint64_t nw = r->n_tokens / r->seq_len;
  for (uint64_t i = 0; i < n_total; ++i)
    if (indices[i] >= nw) return nullptr;
  auto* p = new (std::nothrow) Prefetcher();
  if (!p) return nullptr;
  p->reader = r;
  p->indices.assign(indices, indices + n_total);
  p->batch = batch;
  p->n_batches = n_total / batch;  // trailing partial batch dropped
  p->depth = depth;
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back(prefetch_worker, p);
  return p;
}

// Blocks for the next in-order batch -> out (batch * seq_len int32).
// Returns 1 when a batch was written, 0 at end of stream, <0 on IO error.
int csr_prefetch_next(void* ph, int32_t* out) {
  auto* p = static_cast<Prefetcher*>(ph);
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_out >= p->n_batches) return 0;
    p->cv_ready.wait(lk, [&] {
      return p->error || p->ready.count(p->next_out) > 0;
    });
    if (p->error) return p->error;
    buf = std::move(p->ready[p->next_out]);
    p->ready.erase(p->next_out);
    p->next_out += 1;
    p->cv_space.notify_all();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  return 1;
}

void csr_prefetch_stop(void* ph) {
  auto* p = static_cast<Prefetcher*>(ph);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopped = true;
    p->cv_space.notify_all();
    p->cv_ready.notify_all();
  }
  // Unblock workers parked on cv_space and let claimed jobs drain.
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
