// Threaded prefetching image loader.
//
// Native equivalent of the reference's dataset ingestion (the kitti example's
// LoadImages + per-frame cv::imread loop, src/vslam/Examples/Monocular/
// kitti.cc:56-158): a worker pool reads + decodes PNG frames ahead of the
// consumer so the device's work never waits on disk or PNG inflate.  Frames are
// delivered strictly in order through a fixed ring of slots.
//
// C API (ctypes):
//   loader_create(paths, n, n_threads, capacity, w, h) -> handle (0 on error)
//   loader_next(handle, out[h*w]) -> frame index, or -1 when exhausted,
//                                    -2 on decode error for that frame
//   loader_destroy(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int png_gray_size(const uint8_t* data, long n, int* width, int* height);
int png_decode_gray(const uint8_t* data, long n, float* out);
}

namespace {

struct Loader {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  int capacity = 0;
  std::vector<std::vector<float>> slots;   // capacity x (h*w)
  std::vector<int> slot_frame;             // frame index held by slot, -1 empty
  std::vector<int> slot_status;            // 0 pending, 1 ok, 2 error
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  bool stop = false;
  std::mutex mu;
  std::condition_variable ready_cv;   // consumer waits for its frame
  std::condition_variable free_cv;    // workers wait for a free slot
  std::vector<std::thread> workers;

  void worker() {
    std::vector<uint8_t> buf;
    std::vector<float> pixels((size_t)width * height);
    for (;;) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= (int)paths.size()) return;

      // decode outside the lock
      int status = 1;
      FILE* f = fopen(paths[idx].c_str(), "rb");
      if (!f) {
        status = 2;
      } else {
        fseek(f, 0, SEEK_END);
        long n = ftell(f);
        fseek(f, 0, SEEK_SET);
        buf.resize(n);
        if ((long)fread(buf.data(), 1, n, f) != n) status = 2;
        fclose(f);
        if (status == 1) {
          int w = 0, h = 0;
          if (png_gray_size(buf.data(), n, &w, &h) != 0 ||
              w != width || h != height ||
              png_decode_gray(buf.data(), n, pixels.data()) != 0)
            status = 2;
        }
      }

      int slot = idx % capacity;
      std::unique_lock<std::mutex> lk(mu);
      // Wait until THIS frame's ring window is open, i.e. the slot's
      // previous occupant (frame idx - capacity) has been consumed.  The
      // earlier predicate `slot_frame[slot] < next_to_consume` deadlocked:
      // a fast worker holding frame idx+capacity could see the slot still
      // at its initial -1 ("free") and write out of order, after which the
      // consumer waits for a frame that can never land and the displaced
      // worker waits for a window that never opens.
      free_cv.wait(lk, [&] { return stop || idx < next_to_consume + capacity; });
      if (stop) return;
      if (status == 1)
        slots[slot].assign(pixels.begin(), pixels.end());
      slot_frame[slot] = idx;
      slot_status[slot] = status;
      ready_cv.notify_all();
    }
  }

  int next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_consume >= (int)paths.size()) return -1;
    int idx = next_to_consume;
    int slot = idx % capacity;
    ready_cv.wait(lk, [&] { return slot_frame[slot] == idx && slot_status[slot] != 0; });
    int status = slot_status[slot];
    if (status == 1)
      std::memcpy(out, slots[slot].data(), sizeof(float) * width * height);
    next_to_consume++;
    free_cv.notify_all();
    return status == 1 ? idx : -2;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      next_to_consume = (int)paths.size() + capacity;  // frees all slots
    }
    free_cv.notify_all();
    ready_cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int n_threads,
                    int capacity, int width, int height) {
  if (n_paths <= 0 || capacity <= 0 || n_threads <= 0) return nullptr;
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->width = width;
  L->height = height;
  L->capacity = capacity;
  L->slots.assign(capacity, std::vector<float>());
  L->slot_frame.assign(capacity, -1);
  L->slot_status.assign(capacity, 0);
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int loader_next(void* handle, float* out) {
  return static_cast<Loader*>(handle)->next(out);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
