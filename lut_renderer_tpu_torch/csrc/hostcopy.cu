// Host copy of a batch's planes into a slot of the copy in's pinned ring
// (engine/executor.PinnedRing), with non-temporal stores.
//
// Replaces no TPU kernel: on the TPU host the batch goes to the chip
// through XLA's own transfer. On the card's host the staging thread copies
// every batch from the caller's pageable arrays into pinned memory before
// the copy engine takes it, and that copy sets the device loop's pace. It
// is bound by the host's memory: each byte is read once and written once.
// A plain store first reads the destination's line into the cache (a
// third pass over the bytes) and leaves it there, evicting the source;
// a streaming store (`movntdq`) writes the line whole and bypasses the
// cache. The bytes are split into `threads` contiguous parts, one a
// thread, the caller's own thread taking the first.
//
// Host code only: nvcc hands it to the host compiler. It runs with the
// GIL released (ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <emmintrin.h>
#endif

#define HOST_COPY_MAX_PLANES 4

// mirrored by the caller's ctypes Structure
struct HostCopyParams {
  const char* src[HOST_COPY_MAX_PLANES];
  char* dst[HOST_COPY_MAX_PLANES];
  int64_t bytes[HOST_COPY_MAX_PLANES];
  int32_t planes;
  int32_t threads;
};

namespace {

// a thread's part starts on a page, so no two threads store to one line
constexpr int64_t kPart = 4096;

void copy_streaming(char* dst, const char* src, size_t n) {
#if defined(__x86_64__)
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  head = std::min(head, n);
  std::memcpy(dst, src, head);
  dst += head;
  src += head;
  n -= head;
  const size_t body = n & ~size_t(63);
  for (size_t i = 0; i < body; i += 64) {
    const __m128i* s = reinterpret_cast<const __m128i*>(src + i);
    __m128i* d = reinterpret_cast<__m128i*>(dst + i);
    const __m128i a = _mm_loadu_si128(s);
    const __m128i b = _mm_loadu_si128(s + 1);
    const __m128i c = _mm_loadu_si128(s + 2);
    const __m128i e = _mm_loadu_si128(s + 3);
    _mm_stream_si128(d, a);
    _mm_stream_si128(d + 1, b);
    _mm_stream_si128(d + 2, c);
    _mm_stream_si128(d + 3, e);
  }
  _mm_sfence();
  std::memcpy(dst + body, src + body, n - body);
#else
  std::memcpy(dst, src, n);
#endif
}

// bytes [begin, end) of the planes laid end to end
void copy_range(const HostCopyParams* p, int64_t begin, int64_t end) {
  int64_t base = 0;
  for (int i = 0; i < p->planes && base < end; ++i) {
    const int64_t lo = std::max(begin, base);
    const int64_t hi = std::min(end, base + p->bytes[i]);
    if (lo < hi) {
      copy_streaming(p->dst[i] + (lo - base), p->src[i] + (lo - base),
                     static_cast<size_t>(hi - lo));
    }
    base += p->bytes[i];
  }
}

}  // namespace

// 0, or 1 for params it does not take, 2 where a thread could not start.
// The second argument keeps the library's entry-point signature; the copy
// uses no stream.
extern "C" int host_copy(const HostCopyParams* p, void*) {
  if (p->planes < 0 || p->planes > HOST_COPY_MAX_PLANES || p->threads < 1) return 1;
  int64_t total = 0;
  for (int i = 0; i < p->planes; ++i) {
    if (p->bytes[i] < 0) return 1;
    total += p->bytes[i];
  }
  const int64_t share = (total + p->threads - 1) / p->threads;
  const int64_t part = (share + kPart - 1) / kPart * kPart;
  std::vector<std::thread> pool;
  int rc = 0;
  try {
    for (int t = 1; t < p->threads && t * part < total; ++t) {
      pool.emplace_back(copy_range, p, t * part,
                        std::min(total, (t + 1) * part));
    }
  } catch (const std::system_error&) {
    rc = 2;
  }
  if (rc == 0) copy_range(p, 0, std::min(total, part));
  for (auto& th : pool) th.join();
  return rc;
}
