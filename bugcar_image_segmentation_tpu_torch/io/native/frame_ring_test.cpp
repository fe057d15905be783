// Concurrency stress test for the frame ring, built for ThreadSanitizer.
//
//   g++ -O1 -g -std=c++17 -fsanitize=thread -pthread \
//       frame_ring.cpp frame_ring_test.cpp -o frame_ring_tsan && ./frame_ring_tsan
//
// Two producers race pushes against a latest-consumer and an in-order
// consumer; TSan must report no data races and the test checks frame
// integrity (every byte of a popped frame carries the same sequence tag).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
struct FrameRing;
FrameRing* frame_ring_create(size_t capacity, size_t frame_bytes);
void frame_ring_destroy(FrameRing*);
int64_t frame_ring_push(FrameRing*, const uint8_t*);
int64_t frame_ring_pop_latest(FrameRing*, uint8_t*, int timeout_ms);
int64_t frame_ring_pop_next(FrameRing*, uint8_t*, int timeout_ms);
int64_t frame_ring_pending(FrameRing*);
void frame_ring_close(FrameRing*);
}

namespace {
constexpr size_t kFrameBytes = 4096;
constexpr int kFramesPerProducer = 2000;

std::atomic<int> torn_frames{0};

void producer(FrameRing* ring, int id) {
  std::vector<uint8_t> buf(kFrameBytes);
  for (int i = 0; i < kFramesPerProducer; ++i) {
    std::memset(buf.data(), static_cast<uint8_t>((id * 131 + i) & 0xff),
                kFrameBytes);
    frame_ring_push(ring, buf.data());
  }
}

void check(const uint8_t* buf) {
  const uint8_t tag = buf[0];
  for (size_t j = 1; j < kFrameBytes; ++j) {
    if (buf[j] != tag) {
      torn_frames.fetch_add(1);
      return;
    }
  }
}

void consumer_latest(FrameRing* ring) {
  std::vector<uint8_t> buf(kFrameBytes);
  while (frame_ring_pop_latest(ring, buf.data(), 50) >= 0) check(buf.data());
}

void consumer_next(FrameRing* ring) {
  std::vector<uint8_t> buf(kFrameBytes);
  while (frame_ring_pop_next(ring, buf.data(), 50) >= 0) check(buf.data());
}
}  // namespace

int main() {
  FrameRing* ring = frame_ring_create(16, kFrameBytes);
  std::thread p1(producer, ring, 1);
  std::thread p2(producer, ring, 2);
  std::thread c1(consumer_latest, ring);
  std::thread c2(consumer_next, ring);
  p1.join();
  p2.join();
  frame_ring_close(ring);
  c1.join();
  c2.join();
  frame_ring_destroy(ring);
  if (torn_frames.load() != 0) {
    std::printf("FAIL: %d torn frames\n", torn_frames.load());
    return 1;
  }
  std::printf("OK: no torn frames\n");
  return 0;
}
