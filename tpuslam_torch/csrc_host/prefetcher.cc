// Threaded dataset prefetcher: a worker pool decodes images ahead of the
// consumer into a bounded ring, so per-frame tracking never stalls on disk
// IO or PNG decode. This is the native runtime counterpart of the
// reference's synchronous per-frame cv::imread in the dataset drivers
// (reference Examples/Monocular/mono_tum.cc:85), redesigned as a
// pipeline stage so that a fast tracker never waits on decode.
//
// API (C, ctypes-friendly):
//   h = tpuslam_prefetch_create(paths, n_paths, n_threads, capacity, scale16)
//   tpuslam_prefetch_next(h, &buf, &w, &hgt)  // blocks; returns index or -1
//   tpuslam_release_frame(h, buf)
//   tpuslam_prefetch_destroy(h)
// Frames are delivered strictly in sequence order.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int tpuslam_decode_png_gray(const uint8_t*, size_t, float**, int*,
                                       int*, float);
extern "C" void tpuslam_free(void*);

namespace {

struct Slot {
  float* data = nullptr;
  int w = 0, h = 0;
  int status = 0;  // 0 = empty, 1 = ready, 2 = failed
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  size_t next_decode = 0;   // next sequence index a worker may claim
  size_t next_consume = 0;  // next sequence index the consumer wants
  size_t capacity;
  float scale16;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop || (next_decode < paths.size() &&
                          next_decode < next_consume + capacity);
        });
        if (stop) return;
        idx = next_decode++;
      }
      // Read + decode outside the lock.
      float* out = nullptr;
      int w = 0, h = 0;
      int status = 2;
      FILE* f = fopen(paths[idx].c_str(), "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long len = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> buf(len > 0 ? size_t(len) : 0);
        if (len > 0 && fread(buf.data(), 1, size_t(len), f) == size_t(len)) {
          if (tpuslam_decode_png_gray(buf.data(), buf.size(), &out, &w, &h,
                                      scale16) == 0) {
            status = 1;
          }
        }
        fclose(f);
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        Slot& s = slots[idx % capacity];
        s.data = out;
        s.w = w;
        s.h = h;
        s.status = status;
        cv_consumer.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* tpuslam_prefetch_create(const char** paths, int n_paths, int n_threads,
                              int capacity, float scale16) {
  auto* p = new Prefetcher();
  p->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? size_t(capacity) : 8;
  p->scale16 = scale16;
  p->slots.resize(p->capacity);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until the next in-order frame is ready. Returns its sequence index,
// or -1 when the sequence is exhausted, or -2 on decode failure (frame
// skipped; call again for the next one).
long tpuslam_prefetch_next(void* handle, float** data, int* w, int* h) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_consume >= p->paths.size()) return -1;
  size_t idx = p->next_consume;
  Slot& s = p->slots[idx % p->capacity];
  p->cv_consumer.wait(lk, [&] { return s.status != 0; });
  long rc;
  if (s.status == 1) {
    *data = s.data;
    *w = s.w;
    *h = s.h;
    rc = long(idx);
  } else {
    rc = -2;
  }
  s.status = 0;
  s.data = nullptr;
  p->next_consume++;
  p->cv_worker.notify_all();
  return rc;
}

void tpuslam_release_frame(void* handle, float* data) {
  (void)handle;
  tpuslam_free(data);
}

void tpuslam_prefetch_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_worker.notify_all();
  }
  for (auto& t : p->workers) t.join();
  for (auto& s : p->slots)
    if (s.status == 1 && s.data) tpuslam_free(s.data);
  delete p;
}

}  // extern "C"
