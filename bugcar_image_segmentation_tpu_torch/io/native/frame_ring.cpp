// Native frame ring buffer: the capture↔compute decoupling layer.
//
// The reference's hot loop read the camera synchronously in Python
// (SURVEY.md §3.1), so a slow inference step stalls capture and a slow
// camera stalls inference.  This is the runtime piece that decouples them:
// a fixed-capacity ring of preallocated frame slots written by a capture
// thread (cv2/RealSense/network) and drained by the TPU feed thread.
//
// Semantics chosen for real-time perception:
//   - push never blocks: when the ring is full the OLDEST frame is
//     overwritten (fresher data beats completeness for navigation);
//   - pop_latest skips the queue and returns the newest frame, reporting
//     how many frames were dropped past;
//   - pop_next returns frames in order (for offline/video processing),
//     blocking with a timeout.
//
// Plain C ABI for ctypes; no Python.h dependency.  Memory is allocated
// once at create time — no allocation on the frame path.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>

namespace {

struct FrameRing {
  uint8_t* storage = nullptr;     // capacity * frame_bytes
  int64_t* seq = nullptr;         // sequence number per slot (-1 = empty)
  size_t frame_bytes = 0;
  size_t capacity = 0;
  int64_t next_seq = 0;           // sequence of the next pushed frame
  int64_t next_read = 0;          // next sequence pop_next wants
  std::mutex mu;
  std::condition_variable cv;
  bool closed = false;

  size_t slot_of(int64_t s) const { return static_cast<size_t>(s) % capacity; }
};

}  // namespace

extern "C" {

FrameRing* frame_ring_create(size_t capacity, size_t frame_bytes) {
  if (capacity == 0 || frame_bytes == 0) return nullptr;
  auto* r = new (std::nothrow) FrameRing();
  if (!r) return nullptr;
  r->storage = new (std::nothrow) uint8_t[capacity * frame_bytes];
  r->seq = new (std::nothrow) int64_t[capacity];
  if (!r->storage || !r->seq) {
    delete[] r->storage;
    delete[] r->seq;
    delete r;
    return nullptr;
  }
  for (size_t i = 0; i < capacity; ++i) r->seq[i] = -1;
  r->frame_bytes = frame_bytes;
  r->capacity = capacity;
  return r;
}

void frame_ring_destroy(FrameRing* r) {
  if (!r) return;
  {
    std::lock_guard<std::mutex> lock(r->mu);
    r->closed = true;
  }
  r->cv.notify_all();
  delete[] r->storage;
  delete[] r->seq;
  delete r;
}

// Copy one frame in.  Returns its sequence number, or -1 if closed.
int64_t frame_ring_push(FrameRing* r, const uint8_t* data) {
  std::unique_lock<std::mutex> lock(r->mu);
  if (r->closed) return -1;
  const int64_t s = r->next_seq++;
  const size_t slot = r->slot_of(s);
  std::memcpy(r->storage + slot * r->frame_bytes, data, r->frame_bytes);
  r->seq[slot] = s;
  // If the writer lapped the reader, advance the reader past the
  // overwritten frames.
  const int64_t oldest = (r->next_seq > static_cast<int64_t>(r->capacity))
                             ? r->next_seq - static_cast<int64_t>(r->capacity)
                             : 0;
  if (r->next_read < oldest) r->next_read = oldest;
  lock.unlock();
  r->cv.notify_all();
  return s;
}

// Newest frame, skipping everything older.  Returns the number of frames
// dropped past (>= 0), -1 on timeout, -2 if closed and drained.
int64_t frame_ring_pop_latest(FrameRing* r, uint8_t* out, int timeout_ms) {
  std::unique_lock<std::mutex> lock(r->mu);
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
  while (r->next_read >= r->next_seq) {
    if (r->closed) return -2;
    if (r->cv.wait_until(lock, deadline) == std::cv_status::timeout)
      return -1;
  }
  const int64_t s = r->next_seq - 1;
  const int64_t dropped = s - r->next_read;
  std::memcpy(out, r->storage + r->slot_of(s) * r->frame_bytes,
              r->frame_bytes);
  r->next_read = s + 1;
  return dropped;
}

// Next frame in order.  Returns its sequence number, -1 on timeout,
// -2 if closed and drained.
int64_t frame_ring_pop_next(FrameRing* r, uint8_t* out, int timeout_ms) {
  std::unique_lock<std::mutex> lock(r->mu);
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
  while (r->next_read >= r->next_seq) {
    if (r->closed) return -2;
    if (r->cv.wait_until(lock, deadline) == std::cv_status::timeout)
      return -1;
  }
  const int64_t s = r->next_read++;
  std::memcpy(out, r->storage + r->slot_of(s) * r->frame_bytes,
              r->frame_bytes);
  return s;
}

int64_t frame_ring_pending(FrameRing* r) {
  std::lock_guard<std::mutex> lock(r->mu);
  return r->next_seq - r->next_read;
}

void frame_ring_close(FrameRing* r) {
  {
    std::lock_guard<std::mutex> lock(r->mu);
    r->closed = true;
  }
  r->cv.notify_all();
}

}  // extern "C"
