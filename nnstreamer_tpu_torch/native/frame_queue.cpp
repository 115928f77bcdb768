// Native runtime core: the bounded frame queue behind the `queue` element.
//
// The port's copy of the JAX package's native/frame_queue.cpp, unchanged in
// behaviour.  GStreamer's C `queue` element (streaming threads and bounded
// buffering) is the runtime it stands for.  Python holds frames in a handle table
// and pushes opaque uint64 handles through this queue; blocking waits happen
// here, *outside the GIL* (ctypes releases it for the call), so a stalled
// consumer never busy-wakes the Python interpreter the way a pure-Python
// condvar loop does.
//
// Semantics match GStreamer queue leak modes:
//   mode 0 (no)         — block until space (backpressure) or shutdown;
//   mode 1 (downstream) — when full, drop the *oldest* non-event entry
//                         (live pipelines stay current; events survive);
//   mode 2 (upstream)   — when full, reject the incoming non-event entry.
// Handles with NNS_EVENT_BIT set mark in-band events (EOS/flush): they are
// never dropped by either leak mode.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread (driven by
// nnstreamer_tpu_torch/native/__init__.py at first use, into
// build/nnstreamer_tpu_torch/ beside the CUDA kernels; no dependencies).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>

namespace {

constexpr uint64_t kEventBit = 1ull << 63;

struct Queue {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<uint64_t> items;
  size_t capacity;
  bool shutdown = false;

  explicit Queue(size_t cap) : capacity(cap ? cap : 1) {}
};

bool wait_until(std::unique_lock<std::mutex>& lk, std::condition_variable& cv,
                int64_t timeout_ms, bool (*pred)(Queue*), Queue* q) {
  if (timeout_ms < 0) {
    cv.wait(lk, [&] { return pred(q); });
    return true;
  }
  return cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                     [&] { return pred(q); });
}

}  // namespace

extern "C" {

// Status codes shared with the Python binding.
enum {
  NNS_OK = 0,
  NNS_OK_DROPPED_OLDEST = 1,  // pushed; *dropped holds the evicted handle
  NNS_DROPPED_INCOMING = 2,   // not pushed (leaky=upstream, queue full)
  NNS_SHUTDOWN = -1,
  NNS_TIMEOUT = -2,
};

void* nns_queue_new(uint64_t capacity) { return new Queue(capacity); }

void nns_queue_free(void* ptr) { delete static_cast<Queue*>(ptr); }

void nns_queue_shutdown(void* ptr) {
  Queue* q = static_cast<Queue*>(ptr);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->shutdown = true;
  }
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

int64_t nns_queue_len(void* ptr) {
  Queue* q = static_cast<Queue*>(ptr);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int64_t>(q->items.size());
}

int nns_queue_push(void* ptr, uint64_t handle, int mode, int64_t timeout_ms,
                   uint64_t* dropped) {
  Queue* q = static_cast<Queue*>(ptr);
  std::unique_lock<std::mutex> lk(q->mu);
  bool is_event = (handle & kEventBit) != 0;
  if (q->items.size() >= q->capacity && !q->shutdown) {
    if (mode == 1 && !is_event) {
      // leak downstream: evict the oldest non-event entry.
      for (auto it = q->items.begin(); it != q->items.end(); ++it) {
        if ((*it & kEventBit) == 0) {
          if (dropped) *dropped = *it;
          q->items.erase(it);
          q->items.push_back(handle);
          q->not_empty.notify_one();
          return NNS_OK_DROPPED_OLDEST;
        }
      }
      // all queued entries are events: fall through to blocking push.
    } else if (mode == 2 && !is_event) {
      return NNS_DROPPED_INCOMING;
    }
    bool ok = wait_until(
        lk, q->not_full, timeout_ms,
        [](Queue* qq) { return qq->shutdown || qq->items.size() < qq->capacity; },
        q);
    if (!ok) return NNS_TIMEOUT;
  }
  if (q->shutdown) return NNS_SHUTDOWN;
  q->items.push_back(handle);
  q->not_empty.notify_one();
  return NNS_OK;
}

int nns_queue_pop(void* ptr, int64_t timeout_ms, uint64_t* out) {
  Queue* q = static_cast<Queue*>(ptr);
  std::unique_lock<std::mutex> lk(q->mu);
  bool ok = wait_until(
      lk, q->not_empty, timeout_ms,
      [](Queue* qq) { return qq->shutdown || !qq->items.empty(); }, q);
  if (!ok) return NNS_TIMEOUT;
  if (q->items.empty()) return NNS_SHUTDOWN;  // shutdown with drained queue
  *out = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  return NNS_OK;
}

}  // extern "C"
