// Asynchronous field exporter — the native data-writer of the runtime.
//
// The reference binds solver textures straight to the renderer
// (OceanRenderer.cs:308-315); our consumers are files. Writing 40+ MB
// snapshots synchronously would stall the device step loop, so submissions are
// copied into a bounded ring and flushed to .npy files from a background
// thread — the host stays off the critical path the same way the reference's
// GPU pipeline never waits for the screen.
//
// API (ctypes, see tpu_ocean/native.py):
//   h   = exporter_create(dir, capacity_bytes)
//   ok  = exporter_submit(h, name, step, data, ndim, dims)  // non-blocking copy
//   n   = exporter_pending(h)
//   exporter_flush(h)      // block until queue drained
//   exporter_destroy(h)    // flush + join

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<int64_t> dims;
  std::vector<double> data;
};

struct Exporter {
  std::string dir;
  size_t capacity;
  size_t queued_bytes = 0;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_drain;
  std::thread worker;
  bool stop = false;
  bool busy = false;  // a popped job is still being written
  // submissions that reserved capacity but have not enqueued yet: the
  // drain predicate must count them or flush()/destroy() can declare the
  // queue empty while a copy is in flight (use-after-free on destroy —
  // review finding, r5)
  size_t reserved_pending = 0;
  std::atomic<int64_t> write_errors{0};  // failed opens/writes/renames

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_push.wait(lock, [&] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
        queued_bytes -= job.data.size() * sizeof(double);
        busy = true;
      }
      if (!write_npy(job)) write_errors.fetch_add(1);
      {
        std::lock_guard<std::mutex> lock(mu);
        busy = false;
      }
      cv_drain.notify_all();
    }
  }

  static bool write_npy(const Job& job) {
    // Minimal NPY v1.0 writer: float64, C-order.
    std::string shape = "(";
    for (size_t i = 0; i < job.dims.size(); ++i) {
      shape += std::to_string(job.dims[i]);
      shape += (job.dims.size() == 1 || i + 1 < job.dims.size()) ? "," : "";
    }
    shape += ")";
    std::string header = "{'descr': '<f8', 'fortran_order': False, 'shape': " +
                         shape + ", }";
    size_t total = 10 + header.size() + 1;
    size_t pad = (64 - (total % 64)) % 64;
    header += std::string(pad, ' ');
    header += '\n';

    std::string tmp = job.path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return false;
    const unsigned char magic[8] = {0x93, 'N', 'U', 'M', 'P', 'Y', 1, 0};
    const uint16_t hlen = static_cast<uint16_t>(header.size());
    // every write checked: a short write (disk full, I/O error) must NOT
    // be renamed over the final path — the .tmp+rename dance exists to
    // guarantee consumers only ever see complete files (review finding,
    // r5: the unchecked writes defeated it)
    bool ok = std::fwrite(magic, 1, 8, f) == 8 &&
              std::fwrite(&hlen, 2, 1, f) == 1 &&
              std::fwrite(header.data(), 1, header.size(), f) ==
                  header.size() &&
              std::fwrite(job.data.data(), sizeof(double),
                          job.data.size(), f) == job.data.size();
    ok = (std::fclose(f) == 0) && ok;
    if (!ok) {
      std::remove(tmp.c_str());
      return false;
    }
    return std::rename(tmp.c_str(), job.path.c_str()) == 0;
  }
};

}  // namespace

extern "C" {

void* exporter_create(const char* dir, int64_t capacity_bytes) {
  auto* e = new Exporter;
  e->dir = dir;
  e->capacity = capacity_bytes > 0 ? static_cast<size_t>(capacity_bytes)
                                   : (256u << 20);
  e->worker = std::thread([e] { e->run(); });
  return e;
}

// Returns 1 on accept, 0 if the ring is full (caller may retry or drop).
int32_t exporter_submit(void* handle, const char* name, int64_t step,
                        const double* data, int64_t ndim,
                        const int64_t* dims) {
  auto* e = static_cast<Exporter*>(handle);
  int64_t count = 1;
  Job job;
  for (int64_t i = 0; i < ndim; ++i) {
    job.dims.push_back(dims[i]);
    count *= dims[i];
  }
  const size_t bytes = static_cast<size_t>(count) * sizeof(double);
  {
    // capacity check BEFORE the copy: a rejected submission must not cost
    // the step loop a multi-MB memcpy. The reservation also counts toward
    // the drain predicate (reserved_pending) so a concurrent flush/destroy
    // cannot race past an in-flight copy.
    std::lock_guard<std::mutex> lock(e->mu);
    if (e->queued_bytes + bytes > e->capacity) return 0;
    e->queued_bytes += bytes;  // reserve
    e->reserved_pending += 1;
  }
  char fname[512];
  const int written = std::snprintf(fname, sizeof(fname), "%s/%s_%08lld.npy",
                                    e->dir.c_str(), name,
                                    static_cast<long long>(step));
  if (written < 0 || written >= static_cast<int>(sizeof(fname))) {
    // truncated path would silently collide distinct snapshots onto one
    // file (review finding, r5): refuse, un-reserve, count the error
    std::lock_guard<std::mutex> lock(e->mu);
    e->queued_bytes -= bytes;
    e->reserved_pending -= 1;
    e->write_errors.fetch_add(1);
    e->cv_drain.notify_all();
    return 0;
  }
  job.path = fname;
  job.data.assign(data, data + count);
  {
    std::lock_guard<std::mutex> lock(e->mu);
    e->queue.push_back(std::move(job));
    e->reserved_pending -= 1;
  }
  e->cv_push.notify_one();
  return 1;
}

int64_t exporter_pending(void* handle) {
  auto* e = static_cast<Exporter*>(handle);
  std::lock_guard<std::mutex> lock(e->mu);
  return static_cast<int64_t>(e->queue.size());
}

void exporter_flush(void* handle) {
  auto* e = static_cast<Exporter*>(handle);
  std::unique_lock<std::mutex> lock(e->mu);
  e->cv_drain.wait(lock, [&] {
    return e->queue.empty() && !e->busy && e->reserved_pending == 0;
  });
}

// Failed opens/short writes/renames/truncated paths since creation — a
// flush() that returns with errors == 0 guarantees every accepted
// submission is a complete .npy on disk.
int64_t exporter_errors(void* handle) {
  auto* e = static_cast<Exporter*>(handle);
  return e->write_errors.load();
}

void exporter_destroy(void* handle) {
  auto* e = static_cast<Exporter*>(handle);
  {
    std::unique_lock<std::mutex> lock(e->mu);
    e->cv_drain.wait(lock, [&] {
      return e->queue.empty() && !e->busy && e->reserved_pending == 0;
    });
    e->stop = true;
  }
  e->cv_push.notify_all();
  e->worker.join();
  delete e;
}

}  // extern "C"
