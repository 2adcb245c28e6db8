// Native-layer unit tests of the port's copy of the core (a copy of
// horovod_tpu/native/unit_tests.cpp; SURVEY.md §4: "There is no C++ unit
// test in the reference — the native core is tested only through the
// Python surface. Implication for the rebuild: add the missing
// native-layer unit tests.")
//
// Covers the pure components directly at the C++ boundary: wire
// serialization roundtrips + truncation safety, half-precision conversion,
// buffer reduction ops, the data plane's worlds over TCP and shm lanes, and
// the Gaussian-process/Bayesian-optimizer math. Unlike the JAX package's
// binary it also links core.cpp, for the copy's two deviations: the
// negotiated shutdown and the join that re-runs the promotion (the tests
// at the end, over the core's C API). Built and run, plain and under
// -fsanitize=thread, by `python -m horovod_tpu_torch.utils.native_build
// --check [--tsan]`; it needs no Python at run time.

#include <signal.h>
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/wait.h>
#include <unistd.h>

#include <atomic>
#include <cassert>
#include <cerrno>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <limits>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>

#include <cstdlib>

#include "autotune.h"
#include "compressed.h"
#include "data_plane.h"
#include "flightrec.h"
#include "message.h"
#include "metrics.h"
#include "perfstats.h"
#include "profiler.h"
#include "shm_transport.h"
#include "socket_util.h"
#include "timeline.h"
#include "tracing.h"

// The core's C API (core.cpp), for the tests of its deviations.
extern "C" {
void* hvdtpu_create(int rank, int size, int local_rank, int local_size,
                    int cross_rank, int cross_size, const char* coord_host,
                    int coord_port, const char* my_host, double cycle_time_ms,
                    long long fusion_threshold, const char* timeline_path,
                    int timeline_mark_cycles, double stall_warn_secs);
int hvdtpu_start(void* core, char* err, int errlen);
void hvdtpu_shutdown(void* core);
void hvdtpu_destroy(void* core);
long long hvdtpu_enqueue(void* core, const char* name, int op_type,
                         int reduce_op, int dtype, const long long* shape,
                         int ndim, const void* data, double prescale,
                         double postscale, int root_rank, const int* splits,
                         int nsplits, char* err, int errlen);
int hvdtpu_wait(void* core, long long handle, char* err, int errlen);
int hvdtpu_poll(void* core, long long handle);
int hvdtpu_copy_result(void* core, long long handle, void* dst,
                       long long capacity, char* err, int errlen);
long long hvdtpu_join(void* core);
}

namespace hvdtpu {
namespace {

int failures = 0;

#define CHECK_TRUE(cond)                                                  \
  do {                                                                    \
    if (!(cond)) {                                                        \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      ++failures;                                                         \
    }                                                                     \
  } while (0)

void TestRequestRoundtrip() {
  Request q;
  q.rank = 3;
  q.op_type = OpType::ALLTOALL;
  q.reduce_op = ReduceOp::ADASUM;
  q.dtype = DataType::BFLOAT16;
  q.name = "layer/kernel";
  q.shape = {4, 0, 7};
  q.prescale = 0.25;
  q.postscale = 4.0;
  q.root_rank = 2;
  q.splits = {1, 0, 3};

  Writer w;
  SerializeRequest(q, &w);
  std::vector<uint8_t> buf = w.Take();
  Reader r(buf);
  Request out = DeserializeRequest(&r);
  CHECK_TRUE(r.ok());
  CHECK_TRUE(out.rank == q.rank);
  CHECK_TRUE(out.op_type == q.op_type);
  CHECK_TRUE(out.reduce_op == q.reduce_op);
  CHECK_TRUE(out.dtype == q.dtype);
  CHECK_TRUE(out.name == q.name);
  CHECK_TRUE(out.shape == q.shape);
  CHECK_TRUE(out.prescale == q.prescale);
  CHECK_TRUE(out.postscale == q.postscale);
  CHECK_TRUE(out.root_rank == q.root_rank);
  CHECK_TRUE(out.splits == q.splits);
}

void TestResponseRoundtrip() {
  Response p;
  p.type = ResponseType::ERROR;
  p.op_type = OpType::ALLGATHER;
  p.dtype = DataType::INT64;
  p.error_message = "shape mismatch";
  p.names = {"a", "b"};
  p.shapes = {{2, 3}, {5}};
  p.prescales = {1.0, 0.5};
  p.postscales = {2.0, 1.0};
  p.all_splits = {0, 1, 1, 0};
  p.first_dims = {2, 5};
  p.last_joined_rank = 1;

  Writer w;
  SerializeResponse(p, &w);
  std::vector<uint8_t> buf = w.Take();
  Reader r(buf);
  Response out = DeserializeResponse(&r);
  CHECK_TRUE(r.ok());
  CHECK_TRUE(out.type == p.type);
  CHECK_TRUE(out.error_message == p.error_message);
  CHECK_TRUE(out.names == p.names);
  CHECK_TRUE(out.shapes == p.shapes);
  CHECK_TRUE(out.all_splits == p.all_splits);
  CHECK_TRUE(out.first_dims == p.first_dims);
  CHECK_TRUE(out.last_joined_rank == p.last_joined_rank);
}

void TestReaderTruncationIsSafe() {
  // A frame cut mid-field must flip ok() without reading out of bounds or
  // throwing length_error on a garbage allocation size (message.h Len()).
  Request q;
  q.name = "tensor";
  q.shape = {1024, 1024};
  Writer w;
  SerializeRequest(q, &w);
  std::vector<uint8_t> buf = w.Take();
  for (size_t cut = 0; cut < buf.size(); cut += 3) {
    std::vector<uint8_t> truncated(buf.begin(), buf.begin() + cut);
    Reader r(truncated);
    (void)DeserializeRequest(&r);
    CHECK_TRUE(!r.ok());
  }
}

void TestHalfConversionRoundtrip() {
  const float cases[] = {0.0f, 1.0f, -1.0f, 0.5f, 65504.0f, 1e-4f, -3.25f};
  for (float f : cases) {
    float h = HalfToFloatPublic(FloatToHalfPublic(f));
    CHECK_TRUE(std::fabs(h - f) <= std::fabs(f) * 1e-3f + 1e-6f);
    float b = Bf16ToFloatPublic(FloatToBf16Public(f));
    CHECK_TRUE(std::fabs(b - f) <= std::fabs(f) * 8e-3f + 1e-6f);
  }
}

void TestHalfConversionSpecialValues() {
  const float inf = std::numeric_limits<float>::infinity();
  const float nan = std::numeric_limits<float>::quiet_NaN();
  // Infinities survive both formats with sign.
  CHECK_TRUE(std::isinf(HalfToFloatPublic(FloatToHalfPublic(inf))));
  float nh = HalfToFloatPublic(FloatToHalfPublic(-inf));
  CHECK_TRUE(std::isinf(nh) && nh < 0);
  CHECK_TRUE(std::isinf(Bf16ToFloatPublic(FloatToBf16Public(inf))));
  float nb = Bf16ToFloatPublic(FloatToBf16Public(-inf));
  CHECK_TRUE(std::isinf(nb) && nb < 0);
  // NaN stays NaN (pre-fix: fp16 silently produced inf; bf16's rounding
  // add carried 0x7fffffff into the sign bit, producing -0.0).
  CHECK_TRUE(std::isnan(HalfToFloatPublic(FloatToHalfPublic(nan))));
  CHECK_TRUE(std::isnan(Bf16ToFloatPublic(FloatToBf16Public(nan))));
  float all_ones_nan;
  uint32_t all_ones_bits = 0x7fffffffu;
  std::memcpy(&all_ones_nan, &all_ones_bits, sizeof(all_ones_nan));
  CHECK_TRUE(std::isnan(Bf16ToFloatPublic(FloatToBf16Public(all_ones_nan))));
  // Overflow saturates to inf (fp16 max normal is 65504).
  CHECK_TRUE(std::isinf(HalfToFloatPublic(FloatToHalfPublic(1e6f))));
  // Negative zero keeps its sign bit.
  CHECK_TRUE(std::signbit(HalfToFloatPublic(FloatToHalfPublic(-0.0f))));
  CHECK_TRUE(std::signbit(Bf16ToFloatPublic(FloatToBf16Public(-0.0f))));
  // fp16 subnormal range (min normal 6.1e-5) roundtrips approximately.
  float sub = 1e-5f;
  float back = HalfToFloatPublic(FloatToHalfPublic(sub));
  CHECK_TRUE(std::fabs(back - sub) < 1e-6f);
}

void TestHalfConversionExhaustive() {
  // Every one of the 65536 fp16 bit patterns must survive a float round
  // trip bit-exactly (NaNs must stay NaN; payloads may be canonicalized).
  for (uint32_t u = 0; u < 0x10000u; ++u) {
    uint16_t h = static_cast<uint16_t>(u);
    bool is_nan = (h & 0x7c00u) == 0x7c00u && (h & 0x3ffu) != 0;
    float f = HalfToFloatPublic(h);
    uint16_t back = FloatToHalfPublic(f);
    if (is_nan) {
      if (!((back & 0x7c00u) == 0x7c00u && (back & 0x3ffu) != 0)) {
        std::fprintf(stderr, "FAIL fp16 NaN roundtrip: %04x -> %04x\n", h,
                     back);
        ++failures;
      }
    } else if (back != h) {
      std::fprintf(stderr, "FAIL fp16 roundtrip: %04x -> %g -> %04x\n", h, f,
                   back);
      ++failures;
      return;  // don't spam 65k lines
    }
  }
  // Same for bfloat16 (every pattern is an exact float truncation).
  for (uint32_t u = 0; u < 0x10000u; ++u) {
    uint16_t h = static_cast<uint16_t>(u);
    bool is_nan = (h & 0x7f80u) == 0x7f80u && (h & 0x7fu) != 0;
    float f = Bf16ToFloatPublic(h);
    uint16_t back = FloatToBf16Public(f);
    if (is_nan) {
      if (!((back & 0x7f80u) == 0x7f80u && (back & 0x7fu) != 0)) {
        std::fprintf(stderr, "FAIL bf16 NaN roundtrip: %04x -> %04x\n", h,
                     back);
        ++failures;
      }
    } else if (back != h) {
      std::fprintf(stderr, "FAIL bf16 roundtrip: %04x -> %g -> %04x\n", h, f,
                   back);
      ++failures;
      return;
    }
  }
}

void TestHalfRoundToNearestEven() {
  // Subnormal ties round to even, not up (the seed's round-half-up bug):
  // 2^-25 is exactly halfway between 0 and the smallest subnormal 2^-24.
  CHECK_TRUE(FloatToHalfPublic(std::ldexp(1.0f, -25)) == 0x0000);
  CHECK_TRUE(FloatToHalfPublic(-std::ldexp(1.0f, -25)) == 0x8000);
  // Just above the tie rounds away from zero.
  CHECK_TRUE(FloatToHalfPublic(std::nextafterf(std::ldexp(1.0f, -25), 1.0f)) ==
             0x0001);
  // 3 * 2^-25 (halfway between subnormals 1 and 2) rounds to even (2).
  CHECK_TRUE(FloatToHalfPublic(3.0f * std::ldexp(1.0f, -25)) == 0x0002);
  // Normal-path tie: 1 + 2^-11 is halfway between 1.0 and 1 + 2^-10;
  // round-to-even keeps 1.0 (mantissa 0 is even).
  CHECK_TRUE(FloatToHalfPublic(1.0f + std::ldexp(1.0f, -11)) == 0x3c00);
  // 1 + 3*2^-11 is halfway between 1+2^-10 and 1+2^-9 -> even (1+2^-9).
  CHECK_TRUE(FloatToHalfPublic(1.0f + 3.0f * std::ldexp(1.0f, -11)) == 0x3c02);
  // Overflow rounding: 65520 (tie between 65504 and out-of-range 65536)
  // rounds up to infinity; just below stays at the max normal.
  CHECK_TRUE(FloatToHalfPublic(65520.0f) == 0x7c00);
  CHECK_TRUE(FloatToHalfPublic(std::nextafterf(65520.0f, 0.0f)) == 0x7bff);
}

void TestReduceBufferHalfMatchesScalar() {
  // The fp16/bf16 SUM kernels take a SIMD path when the CPU supports it;
  // verify bit-exact agreement with the scalar convert-combine-convert
  // reference over every finite fp16 value (paired with a fixed addend) and
  // that NaN inputs still propagate.
  const int64_t n = 0x10000;
  std::vector<uint16_t> dst(n), src(n), expect(n);
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = static_cast<uint16_t>(i);
    bool is_nan = (h & 0x7c00u) == 0x7c00u && (h & 0x3ffu) != 0;
    dst[i] = h;
    src[i] = FloatToHalfPublic(0.37109375f);  // exact in fp16
    expect[i] = is_nan ? 0xffffu  // placeholder: checked via isnan below
                       : FloatToHalfPublic(HalfToFloatPublic(dst[i]) +
                                           HalfToFloatPublic(src[i]));
  }
  ReduceBuffer(dst.data(), src.data(), n, DataType::FLOAT16, ReduceOp::SUM);
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = static_cast<uint16_t>(i);
    bool is_nan = (h & 0x7c00u) == 0x7c00u && (h & 0x3ffu) != 0;
    if (is_nan) {
      if (!((dst[i] & 0x7c00u) == 0x7c00u && (dst[i] & 0x3ffu) != 0)) {
        std::fprintf(stderr, "FAIL fp16 sum NaN propagation at %04x -> %04x\n",
                     h, dst[i]);
        ++failures;
      }
    } else if (dst[i] != expect[i]) {
      std::fprintf(stderr, "FAIL fp16 sum kernel mismatch at %04x: %04x vs "
                   "scalar %04x\n", h, dst[i], expect[i]);
      ++failures;
      return;
    }
  }
  // bf16: same sweep.
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = static_cast<uint16_t>(i);
    bool is_nan = (h & 0x7f80u) == 0x7f80u && (h & 0x7fu) != 0;
    dst[i] = h;
    src[i] = FloatToBf16Public(1.5f);
    expect[i] = is_nan ? 0xffffu
                       : FloatToBf16Public(Bf16ToFloatPublic(dst[i]) +
                                           Bf16ToFloatPublic(src[i]));
  }
  ReduceBuffer(dst.data(), src.data(), n, DataType::BFLOAT16, ReduceOp::SUM);
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = static_cast<uint16_t>(i);
    bool is_nan = (h & 0x7f80u) == 0x7f80u && (h & 0x7fu) != 0;
    if (is_nan) {
      if (!((dst[i] & 0x7f80u) == 0x7f80u && (dst[i] & 0x7fu) != 0)) {
        std::fprintf(stderr, "FAIL bf16 sum NaN propagation at %04x -> %04x\n",
                     h, dst[i]);
        ++failures;
      }
    } else if (dst[i] != expect[i]) {
      std::fprintf(stderr, "FAIL bf16 sum kernel mismatch at %04x: %04x vs "
                   "scalar %04x\n", h, dst[i], expect[i]);
      ++failures;
      return;
    }
  }
}

void TestSendRecvSegmented() {
  // Full-duplex segmented transfer over a socketpair: side A uses the
  // segmented path with an on-the-fly reduction callback, side B a plain
  // concurrent send+recv. Odd segment size exercises the short tail.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  const size_t kBytes = 1 << 20;
  std::vector<uint8_t> a_send(kBytes), a_recv(kBytes), b_send(kBytes),
      b_recv(kBytes);
  for (size_t i = 0; i < kBytes; ++i) {
    a_send[i] = static_cast<uint8_t>(i * 7);
    b_send[i] = static_cast<uint8_t>(i * 13 + 1);
  }
  std::atomic<int> b_rc{-1};
  std::thread side_b([&] {
    int send_rc = 0;
    std::thread sender([&] {
      send_rc = SendAll(sv[1], b_send.data(), kBytes);
    });
    int recv_rc = RecvAll(sv[1], b_recv.data(), kBytes);
    sender.join();
    b_rc = (send_rc == 0 && recv_rc == 0) ? 0 : 1;
  });
  size_t callback_bytes = 0;
  size_t calls = 0;
  int rc = SendRecvSegmented(
      sv[0], a_send.data(), kBytes, sv[0], a_recv.data(), kBytes,
      /*segment_bytes=*/100000,
      [&](const uint8_t* data, size_t off, size_t len) {
        // Segments arrive in order, disjoint, and fully landed; the view
        // pointer is buf-backed on the socket path.
        CHECK_TRUE(off == callback_bytes);
        CHECK_TRUE(data == a_recv.data() + off);
        for (size_t i = 0; i < len; i += 9973) {
          CHECK_TRUE(data[i] == static_cast<uint8_t>((off + i) * 13 + 1));
        }
        callback_bytes += len;
        ++calls;
      });
  side_b.join();
  CHECK_TRUE(rc == 0);
  CHECK_TRUE(b_rc == 0);
  CHECK_TRUE(callback_bytes == kBytes);
  // calls is scheduling-dependent (1 if the receiver outran the consumer,
  // up to 11 with no coalescing) — only its lower bound is guaranteed.
  CHECK_TRUE(calls >= 1);
  CHECK_TRUE(b_recv == a_send);
  close(sv[0]);
  close(sv[1]);
}

// --- shm transport unit tests ----------------------------------------------
// The rings are plain MAP_SHARED memory, so two transports in one process
// (threads) exercise exactly the cross-process protocol — and TSan/ASan see
// every access (make check-tsan / check-asan).

void TestShmRingWraparoundWithBatch(int64_t doorbell_batch) {
  // Push far more than the ring capacity through in odd-sized pieces so the
  // cursors wrap the ring many times mid-message; verify every byte. Runs
  // under both doorbell protocols: 1 = legacy wake-per-advance, other =
  // coalesced batching (the default).
  const std::string name = "/hvdtpu_test_wrap_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, /*ring_bytes=*/4096);
  CHECK_TRUE(a != nullptr);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  a->set_doorbell_batch(doorbell_batch);
  b->set_doorbell_batch(doorbell_batch);
  CHECK_TRUE(a->ring_bytes() == 4096 && b->ring_bytes() == 4096);
  const size_t kBytes = 1 << 20;  // 256 ring-fulls
  std::vector<uint8_t> sent(kBytes), got(kBytes, 0);
  for (size_t i = 0; i < kBytes; ++i) {
    sent[i] = static_cast<uint8_t>(i * 31 + 7);
  }
  std::atomic<int> send_rc{-1};
  std::thread producer([&] {
    // Odd chunk size: pieces straddle the ring boundary continually.
    size_t off = 0;
    int rc = 0;
    while (off < kBytes && rc == 0) {
      size_t n = std::min<size_t>(4097, kBytes - off);
      rc = a->Send(sent.data() + off, n);
      off += n;
    }
    send_rc = rc;
  });
  size_t calls = 0, cb_bytes = 0;
  // Zero-copy views: the payload is delivered THROUGH the callback (in-ring
  // pointers; `got` stays scratch) — copy it out here to verify every byte.
  int rc = b->RecvSegmented(got.data(), kBytes, 100000, /*view_align=*/1,
                            [&](const uint8_t* data, size_t off, size_t len) {
                              CHECK_TRUE(off == cb_bytes);
                              memcpy(got.data() + off, data, len);
                              cb_bytes += len;
                              ++calls;
                            });
  producer.join();
  CHECK_TRUE(rc == 0 && send_rc == 0);
  CHECK_TRUE(cb_bytes == kBytes && calls >= 11);
  CHECK_TRUE(got == sent);
  // Full-duplex interleaved pump: both sides exchange > ring capacity.
  std::vector<uint8_t> b2a(64 * 1024), a_got(64 * 1024);
  for (size_t i = 0; i < b2a.size(); ++i) b2a[i] = static_cast<uint8_t>(i * 13);
  std::atomic<int> b_rc{-1};
  std::thread side_b([&] {
    b_rc = b->SendRecv(b2a.data(), b2a.size(), got.data(), kBytes, 0, 1,
                       nullptr);
  });
  rc = a->SendRecv(sent.data(), kBytes, a_got.data(), a_got.size(), 0, 1,
                   nullptr);
  side_b.join();
  CHECK_TRUE(rc == 0 && b_rc == 0);
  CHECK_TRUE(got == sent && a_got == b2a);
}

void TestShmRingWraparound() {
  TestShmRingWraparoundWithBatch(1);  // legacy: doorbell per cursor advance
  TestShmRingWraparoundWithBatch(0);  // 0 -> default coalescing window
}

void TestShmDoorbellBatchingCoalesces() {
  // Deterministic single-threaded fill/drain: with no waiter registered and
  // the batch window larger than the traffic, NO futex syscalls may happen
  // — the whole point of coalescing is that a running peer costs zero
  // doorbells. (The edge-wake latency contract is covered by
  // TestShmDoorbellWakeup, which runs under the default batching.)
  const std::string name = "/hvdtpu_test_batch_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 4096);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  // Window 2048 < op 4096: the adaptive gate engages coalescing (an op
  // smaller than the window would keep the legacy per-advance protocol).
  a->set_doorbell_batch(2048);
  b->set_doorbell_batch(2048);
  std::vector<uint8_t> buf(4096), sink(4096);
  for (size_t i = 0; i < buf.size(); ++i) buf[i] = static_cast<uint8_t>(i);
  CHECK_TRUE(a->Send(buf.data(), buf.size()) == 0);   // exactly one ring-full
  CHECK_TRUE(b->Recv(sink.data(), sink.size()) == 0);
  CHECK_TRUE(sink == buf);
  CHECK_TRUE(a->futex_wakes() == 0);
  CHECK_TRUE(b->futex_wakes() == 0);
  // Same traffic under the legacy protocol still works (and may wake).
  a->set_doorbell_batch(1);
  b->set_doorbell_batch(1);
  CHECK_TRUE(a->Send(buf.data(), buf.size()) == 0);
  CHECK_TRUE(b->Recv(sink.data(), sink.size()) == 0);
  CHECK_TRUE(sink == buf);
}

void TestShmInPlaceViewsAlignedAcrossWrap() {
  // The zero-copy view consumer: payloads are handed out as in-ring views,
  // elem-aligned in op space even when the ring's wrap point slices an
  // element (the 3-byte prologue skews every later wrap mid-element, so the
  // staging path runs on every lap of the 64-byte ring).
  const std::string name = "/hvdtpu_test_views_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 64);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  uint8_t skew[3] = {9, 9, 9}, skew_got[3] = {0, 0, 0};
  std::thread pre([&] { CHECK_TRUE(a->Send(skew, 3) == 0); });
  CHECK_TRUE(b->Recv(skew_got, 3) == 0);
  pre.join();
  const size_t kWords = 1024;
  std::vector<uint32_t> sent(kWords), got(kWords, 0);
  for (size_t i = 0; i < kWords; ++i) {
    sent[i] = static_cast<uint32_t>(i * 2654435761u);
  }
  std::atomic<int> send_rc{-1};
  std::thread producer([&] {
    // Odd-size pieces so element bytes trickle in across view attempts.
    const uint8_t* p = reinterpret_cast<const uint8_t*>(sent.data());
    size_t off = 0, total = kWords * 4;
    int rc = 0;
    while (off < total && rc == 0) {
      size_t n = std::min<size_t>(37, total - off);
      rc = a->Send(p + off, n);
      off += n;
    }
    send_rc = rc;
  });
  size_t cb_bytes = 0;
  bool aligned_ok = true;
  std::vector<uint8_t> scratch(kWords * 4);  // untouched by the views
  int rc = b->RecvSegmented(
      scratch.data(), kWords * 4, 0, /*view_align=*/4,
      [&](const uint8_t* data, size_t off, size_t len) {
        aligned_ok = aligned_ok && off % 4 == 0 && len % 4 == 0;
        memcpy(reinterpret_cast<uint8_t*>(got.data()) + off, data, len);
        cb_bytes += len;
      });
  producer.join();
  CHECK_TRUE(rc == 0 && send_rc == 0);
  CHECK_TRUE(aligned_ok);
  CHECK_TRUE(cb_bytes == kWords * 4);
  CHECK_TRUE(got == sent);
}

void TestShmViewsNeverMisaligned() {
  // An odd-sized prologue knocks the ring cursor off the 8-byte grid; the
  // consumer must then hand out ALIGNED view pointers anyway (the bounce
  // path) — a typed fp64 reducer reading a misaligned view is UB that the
  // UBSan gate aborts on (caught there first, pinned here).
  const std::string name = "/hvdtpu_test_align_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 4096);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  uint8_t skew = 0x5a, skew_got = 0;
  std::thread pre([&] { CHECK_TRUE(a->Send(&skew, 1) == 0); });
  CHECK_TRUE(b->Recv(&skew_got, 1) == 0);
  pre.join();
  const size_t kDoubles = 4096;  // 32 KB: many ring laps, all misaligned
  std::vector<double> sent(kDoubles), got(kDoubles, 0);
  for (size_t i = 0; i < kDoubles; ++i) sent[i] = 0.5 * (i + 1);
  std::atomic<int> send_rc{-1};
  std::thread producer(
      [&] { send_rc = a->Send(sent.data(), kDoubles * 8); });
  bool aligned_ok = true;
  size_t cb = 0;
  std::vector<uint8_t> scratch(kDoubles * 8);
  int rc = b->RecvSegmented(
      scratch.data(), kDoubles * 8, 0, /*view_align=*/8,
      [&](const uint8_t* data, size_t off, size_t len) {
        aligned_ok = aligned_ok &&
                     reinterpret_cast<uintptr_t>(data) % 8 == 0 &&
                     off % 8 == 0 && len % 8 == 0;
        // Read THROUGH the typed lens the reducers use.
        const double* d = reinterpret_cast<const double*>(data);
        for (size_t i = 0; i < len / 8; ++i) {
          reinterpret_cast<double*>(got.data())[(off / 8) + i] = d[i];
        }
        cb += len;
      });
  producer.join();
  CHECK_TRUE(rc == 0 && send_rc == 0);
  CHECK_TRUE(aligned_ok);
  CHECK_TRUE(cb == kDoubles * 8);
  CHECK_TRUE(got == sent);
}

void TestNumaProbeAndPolicy() {
  // Sysfs probe fixtures: node<digits> entries count as nodes; an absent
  // directory reads as single-node (probed no-op everywhere downstream).
  char tmpl[] = "/tmp/hvdtpu_numa_XXXXXX";
  char* dir = mkdtemp(tmpl);
  CHECK_TRUE(dir != nullptr);
  if (dir == nullptr) return;
  std::string d(dir);
  CHECK_TRUE(NumaNodeCount(d + "/missing") == 1);
  CHECK_TRUE(mkdir((d + "/node0").c_str(), 0700) == 0);
  CHECK_TRUE(NumaNodeCount(d) == 1);
  CHECK_TRUE(mkdir((d + "/node1").c_str(), 0700) == 0);
  CHECK_TRUE(mkdir((d + "/nodeX").c_str(), 0700) == 0);  // not a node
  CHECK_TRUE(NumaNodeCount(d) == 2);
  rmdir((d + "/node0").c_str());
  rmdir((d + "/node1").c_str());
  rmdir((d + "/nodeX").c_str());
  rmdir(d.c_str());
  // Policy application on a live segment: OFF is always a no-op; AUTO/ON
  // must degrade cleanly (single-node host, missing syscall) and never
  // break the rings — traffic still flows after.
  const std::string name = "/hvdtpu_test_numa_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 4096);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  CHECK_TRUE(!a->ApplyNumaPolicy(ShmNumaMode::OFF));
  a->ApplyNumaPolicy(ShmNumaMode::AUTO);  // no-crash; result is host-shaped
  b->ApplyNumaPolicy(ShmNumaMode::ON);
  uint64_t v = 0xfeedface, got = 0;
  std::thread s([&] { CHECK_TRUE(a->Send(&v, sizeof(v)) == 0); });
  CHECK_TRUE(b->Recv(&got, sizeof(got)) == 0);
  s.join();
  CHECK_TRUE(got == v);
}

void TestShmDoorbellWakeup() {
  // Consumer blocks on an empty ring (past the spin phase, into the futex
  // wait); a producer that shows up much later must still get through.
  const std::string name = "/hvdtpu_test_bell_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 4096);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  uint32_t got = 0;
  std::atomic<int> recv_rc{-1};
  std::thread consumer([&] { recv_rc = b->Recv(&got, sizeof(got)); });
  std::this_thread::sleep_for(std::chrono::milliseconds(50));
  uint32_t val = 0xdeadbeef;
  CHECK_TRUE(a->Send(&val, sizeof(val)) == 0);
  consumer.join();
  CHECK_TRUE(recv_rc == 0 && got == 0xdeadbeef);
  // And the reverse doorbell: a producer blocked on a FULL ring wakes when
  // the consumer drains.
  std::vector<uint8_t> big(8192, 0x5a), sink(8192, 0);
  std::atomic<int> send_rc{-1};
  std::thread producer([&] { send_rc = a->Send(big.data(), big.size()); });
  std::this_thread::sleep_for(std::chrono::milliseconds(50));
  CHECK_TRUE(b->Recv(sink.data(), sink.size()) == 0);
  producer.join();
  CHECK_TRUE(send_rc == 0);
  CHECK_TRUE(sink == big);
}

void TestShmAbortCleanup() {
  // Abort wakes a blocked peer with an error instead of hanging it, and
  // teardown removes the name from the shm namespace (nothing leaks).
  const std::string name = "/hvdtpu_test_abort_" + std::to_string(getpid());
  {
    auto a = ShmTransport::Create(name, 4096);
    auto b = ShmTransport::Open(name, 2000);
    CHECK_TRUE(a != nullptr && b != nullptr);
    if (a == nullptr || b == nullptr) return;
    uint8_t byte;
    std::atomic<int> recv_rc{0};
    std::thread consumer([&] { recv_rc = b->Recv(&byte, 1); });
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    a->Abort();
    consumer.join();
    CHECK_TRUE(recv_rc == -1);          // blocked op fails over
    CHECK_TRUE(a->Send(&byte, 1) == -1);  // post-abort ops fail fast
    // Destructors: opener unmaps, creator unlinks.
  }
  int fd = shm_open(name.c_str(), O_RDWR, 0600);
  CHECK_TRUE(fd < 0 && errno == ENOENT);
  if (fd >= 0) {
    close(fd);
    shm_unlink(name.c_str());
  }
}

void TestShmKilledPeerWakesWaiter() {
  // The killed-peer fixture (docs/fault-tolerance.md): a SIGKILLed peer can
  // never flip the shared abort flag, so a blocked ring op must be woken by
  // the liveness probe — the (otherwise idle) pair socket EOFs when the
  // peer process dies, checked every wait slice. Fork a REAL peer process,
  // kill it -9 mid-wait, and require the waiter to fail over within a few
  // slices instead of hanging until teardown.
  const std::string name = "/hvdtpu_test_kill_" + std::to_string(getpid());
  int live[2];  // stands in for the pair's TCP socket (liveness probe)
  int sync[2];  // child -> parent "attached" signal, NOT the liveness lane
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, live) == 0);
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sync) == 0);
  auto a = ShmTransport::Create(name, 4096);
  CHECK_TRUE(a != nullptr);
  if (a == nullptr) return;
  pid_t child = fork();
  if (child == 0) {
    // Child: attach as the peer, confirm, then wedge until SIGKILLed. No
    // CHECKs here — the parent judges us by waitpid status. Keep live[1]
    // OPEN: its kernel-side close at SIGKILL is the death signal.
    close(live[0]);
    close(sync[0]);
    auto b = ShmTransport::Open(name, 2000);
    if (b == nullptr) _exit(1);
    char ok = 'k';
    if (write(sync[1], &ok, 1) != 1) _exit(2);
    for (;;) pause();
  }
  close(live[1]);
  close(sync[1]);
  CHECK_TRUE(child > 0);
  char attached = 0;
  CHECK_TRUE(read(sync[0], &attached, 1) == 1 && attached == 'k');
  close(sync[0]);
  // Small detect slice via the shared control block, like the data plane.
  IoControl ctl;
  ctl.detect_slice_ms = 50;
  a->set_liveness_fd(live[0]);
  a->set_control(&ctl);
  uint8_t byte;
  std::atomic<int> recv_rc{0};
  std::thread consumer([&] { recv_rc = a->Recv(&byte, 1); });
  // Let the waiter pass the spin phase into the sliced futex wait.
  std::this_thread::sleep_for(std::chrono::milliseconds(100));
  auto t0 = std::chrono::steady_clock::now();
  CHECK_TRUE(kill(child, SIGKILL) == 0);
  consumer.join();
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  CHECK_TRUE(recv_rc == -1);  // woke with an error, did not hang
  // "Within one timeout slice" + generous CI scheduling slack.
  CHECK_TRUE(waited < 2.0);
  // Peer death must break the WHOLE plane, not just this lane.
  CHECK_TRUE(ctl.peer_failed.load() != 0 && ctl.is_aborted());
  int status = 0;
  CHECK_TRUE(waitpid(child, &status, 0) == child);
  CHECK_TRUE(WIFSIGNALED(status) && WTERMSIG(status) == SIGKILL);
  close(live[0]);
}

// --- interruptible socket I/O (IoControl) -----------------------------------

void TestIoControlRecvFailsFastOnPeerClose() {
  // A controlled RecvAll against a peer that closes mid-wait fails within a
  // poll slice (EOF/POLLHUP), marking the whole plane failed.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  std::atomic<int> rc{0};
  std::thread reader([&] {
    uint8_t buf[16];
    rc = RecvAll(sv[0], buf, sizeof(buf), &ctl);
  });
  std::this_thread::sleep_for(std::chrono::milliseconds(50));
  auto t0 = std::chrono::steady_clock::now();
  close(sv[1]);
  reader.join();
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  CHECK_TRUE(rc == -1);
  CHECK_TRUE(waited < 2.0);
  CHECK_TRUE(ctl.peer_failed.load() != 0 && ctl.is_aborted());
  close(sv[0]);
}

void TestIoControlAbortBreaksBlockedRecv() {
  // A plane-wide abort (flag flip by ANY thread) breaks a blocked read
  // within one slice — this is how one lane's failure cascades to ops
  // blocked on perfectly healthy lanes.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  std::atomic<int> rc{0};
  std::thread reader([&] {
    uint8_t buf[4];
    rc = RecvAll(sv[0], buf, sizeof(buf), &ctl);
  });
  std::this_thread::sleep_for(std::chrono::milliseconds(50));
  ctl.aborted.store(1);
  reader.join();
  CHECK_TRUE(rc == -1);
  CHECK_TRUE(ctl.peer_failed.load() == 0);  // abort, not a peer verdict
  close(sv[0]);
  close(sv[1]);
}

void TestIoControlReadDeadlineTripsOnSilentPeer() {
  // An open-but-silent lane (hung peer / blackholed route: no bytes, no
  // EOF) trips the no-progress deadline instead of blocking forever.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  ctl.read_deadline_secs = 0.15;
  uint8_t buf[4];
  auto t0 = std::chrono::steady_clock::now();
  int rc = RecvAll(sv[0], buf, sizeof(buf), &ctl);
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  CHECK_TRUE(rc == -1);
  CHECK_TRUE(waited >= 0.15 && waited < 2.0);
  CHECK_TRUE(ctl.peer_failed.load() != 0);  // declared dead, plane broken
  close(sv[0]);
  close(sv[1]);
}

void TestShmReadDeadlineTripsOnSilentPeer() {
  // Same contract on the shm lane: a live segment whose ring never moves
  // past the deadline fails over (the peer is attached but wedged — only a
  // deadline can catch it; there is no EOF).
  const std::string name = "/hvdtpu_test_dl_" + std::to_string(getpid());
  auto a = ShmTransport::Create(name, 4096);
  auto b = ShmTransport::Open(name, 2000);
  CHECK_TRUE(a != nullptr && b != nullptr);
  if (a == nullptr || b == nullptr) return;
  a->Unlink();
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  ctl.read_deadline_secs = 0.15;
  a->set_control(&ctl);
  uint8_t byte;
  auto t0 = std::chrono::steady_clock::now();
  int rc = a->Recv(&byte, 1);  // b never sends
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  CHECK_TRUE(rc == -1);
  CHECK_TRUE(waited >= 0.15 && waited < 2.0);
  CHECK_TRUE(ctl.peer_failed.load() != 0 && ctl.is_aborted());
}

// --- zero-copy TCP lane -----------------------------------------------------

// Connected loopback TCP pair (real AF_INET sockets: the SO_ZEROCOPY probe
// needs a TCP socket — AF_UNIX pairs refuse it, which is itself a fixture).
bool MakeTcpPair(int* a, int* b) {
  int port = 0;
  int lfd = TcpListen(0, 1, &port);
  if (lfd < 0) return false;
  *a = TcpConnectRetry("127.0.0.1", port, 2000);
  *b = TcpAccept(lfd);
  CloseFd(lfd);
  if (*a < 0 || *b < 0) {
    CloseFd(*a);
    CloseFd(*b);
    return false;
  }
  return true;
}

void TestSendAllVecExactConcatenation() {
  // Vectored scatter-gather send: three iovecs (frame-header-sized + two
  // payload planes) must arrive as one exact byte stream, including under
  // an IoControl and partial-transfer advancing.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  uint64_t hdr = 0x1122334455667788ull;
  std::vector<uint8_t> p1(300000), p2(70001);
  for (size_t i = 0; i < p1.size(); ++i) p1[i] = static_cast<uint8_t>(i * 3);
  for (size_t i = 0; i < p2.size(); ++i) p2[i] = static_cast<uint8_t>(i * 5 + 1);
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  std::atomic<int> send_rc{-1};
  std::thread sender([&] {
    iovec iov[3] = {{&hdr, sizeof(hdr)},
                    {p1.data(), p1.size()},
                    {p2.data(), p2.size()}};
    send_rc = SendAllVec(sv[0], iov, 3, &ctl);
  });
  std::vector<uint8_t> got(sizeof(hdr) + p1.size() + p2.size());
  CHECK_TRUE(RecvAll(sv[1], got.data(), got.size()) == 0);
  sender.join();
  CHECK_TRUE(send_rc == 0);
  CHECK_TRUE(memcmp(got.data(), &hdr, sizeof(hdr)) == 0);
  CHECK_TRUE(memcmp(got.data() + sizeof(hdr), p1.data(), p1.size()) == 0);
  CHECK_TRUE(memcmp(got.data() + sizeof(hdr) + p1.size(), p2.data(),
                    p2.size()) == 0);
  close(sv[0]);
  close(sv[1]);
}

void TestZeroCopyProbeFallbackBitwise(ZeroCopyMode mode) {
  // Forced-EOPNOTSUPP fixture: AF_UNIX sockets refuse SO_ZEROCOPY, so the
  // probe must leave the engine disabled, the send must take the copy path
  // bit-for-bit, and the fallback counter must record the decline.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  TcpTransport t(sv[0], 32 * 1024, &ctl, mode);
  CHECK_TRUE(!t.zerocopy_enabled());
  CHECK_TRUE(std::strcmp(t.kind(), "tcp") == 0);
  const size_t kBytes = 512 * 1024;  // >= ZeroCopySender::kMinBytes
  std::vector<uint8_t> sent(kBytes), got(kBytes, 0);
  for (size_t i = 0; i < kBytes; ++i) sent[i] = static_cast<uint8_t>(i * 11);
  std::atomic<int> rc{-1};
  std::thread sender([&] { rc = t.Send(sent.data(), kBytes); });
  CHECK_TRUE(RecvAll(sv[1], got.data(), kBytes) == 0);
  sender.join();
  CHECK_TRUE(rc == 0);
  CHECK_TRUE(got == sent);  // copy path bitwise-matches the payload
  CHECK_TRUE(t.zerocopy_sends() == 0);
  CHECK_TRUE(t.zerocopy_fallbacks() >= 1);
  close(sv[0]);
  close(sv[1]);
}

void TestZeroCopyTcpSendBitwise(ZeroCopyMode mode) {
  // The armed lane (whatever the probe lands on — MSG_ZEROCOPY, io_uring,
  // or the copy fallback in a restricted sandbox) must deliver large
  // payloads bit-for-bit and keep the fallback/sends accounting coherent.
  int a = -1, b = -1;
  CHECK_TRUE(MakeTcpPair(&a, &b));
  if (a < 0 || b < 0) return;
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  TcpTransport t(a, 32 * 1024, &ctl, mode);
  const size_t kBytes = 1 << 20;
  std::vector<uint8_t> sent(kBytes), got(kBytes, 0);
  for (size_t i = 0; i < kBytes; ++i) {
    sent[i] = static_cast<uint8_t>(i * 7 + 3);
  }
  std::atomic<int> rc{-1};
  std::thread sender([&] { rc = t.Send(sent.data(), kBytes); });
  CHECK_TRUE(RecvAll(b, got.data(), kBytes) == 0);
  sender.join();
  CHECK_TRUE(rc == 0);
  CHECK_TRUE(got == sent);
  // Exactly one large send: it either completed zero-copy or was counted
  // as a fallback — never silently neither.
  CHECK_TRUE(t.zerocopy_sends() + t.zerocopy_fallbacks() >= 1);
  // Buffer-reuse safety: mutate and resend — the drain-before-return
  // contract means the peer must see the NEW bytes.
  for (size_t i = 0; i < kBytes; ++i) sent[i] = static_cast<uint8_t>(i ^ 0x5a);
  std::thread sender2([&] { rc = t.Send(sent.data(), kBytes); });
  CHECK_TRUE(RecvAll(b, got.data(), kBytes) == 0);
  sender2.join();
  CHECK_TRUE(rc == 0);
  CHECK_TRUE(got == sent);
  CloseFd(a);
  CloseFd(b);
}

void TestZeroCopyKilledPeerFailsFast() {
  // Peer death mid-large-send through the zero-copy lane: the sliced
  // completion/backpressure waits must fail the plane within a couple of
  // slices, exactly like the copy path (docs/fault-tolerance.md).
  int a = -1, b = -1;
  CHECK_TRUE(MakeTcpPair(&a, &b));
  if (a < 0 || b < 0) return;
  IoControl ctl;
  ctl.detect_slice_ms = 20;
  TcpTransport t(a, 32 * 1024, &ctl, ZeroCopyMode::AUTO);
  // Shrink the send buffer so a multi-MB send MUST block on peer drain.
  int small = 16 * 1024;
  setsockopt(a, SOL_SOCKET, SO_SNDBUF, &small, sizeof(small));
  const size_t kBytes = 32 << 20;
  std::vector<uint8_t> payload(kBytes, 0x77);
  std::atomic<int> rc{0};
  std::thread sender([&] { rc = t.Send(payload.data(), kBytes); });
  // Let the send wedge against the tiny buffer, then kill the peer end.
  std::this_thread::sleep_for(std::chrono::milliseconds(100));
  auto t0 = std::chrono::steady_clock::now();
  CloseFd(b);
  sender.join();
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  CHECK_TRUE(rc == -1);
  CHECK_TRUE(waited < 2.0);
  CHECK_TRUE(ctl.peer_failed.load() != 0 && ctl.is_aborted());
  CloseFd(a);
}

// --- data-plane worlds ------------------------------------------------------

// One DataPlane per thread; host strings decide the lanes (same string ->
// shm negotiation; the sockets stay as fallback + liveness probes).
struct TestWorld {
  std::vector<std::unique_ptr<DataPlane>> planes;
  std::vector<PeerAddr> peers;
};

TestWorld MakeWorld(const std::vector<std::string>& hosts) {
  TestWorld w;
  const int n = static_cast<int>(hosts.size());
  w.peers.resize(n);
  for (int r = 0; r < n; ++r) {
    w.planes.emplace_back(new DataPlane(r, n));
    CHECK_TRUE(w.planes[r]->Listen().ok());
    w.peers[r] = {hosts[r], w.planes[r]->port()};
  }
  return w;
}

// Exhaustive dtype/op sweep on one rank's plane; returns false on any
// mismatch. Covers every wire dtype and every reduce op, flat or
// hierarchical depending on the plane's configuration.
bool RunDtypeOpSweep(DataPlane* plane, int r, int world) {
  // float32 SUM, count straddling several 512 B segments per chunk
  // (and an odd count so ring chunks are uneven).
  {
    const int64_t n = 4099;
    std::vector<float> v(n);
    for (int64_t i = 0; i < n; ++i) {
      v[i] = static_cast<float>(r + 1) * (i % 11);
    }
    if (!plane->Allreduce(v.data(), n, DataType::FLOAT32, ReduceOp::SUM)
             .ok()) {
      return false;
    }
    float scale = world * (world + 1) / 2.0f;
    for (int64_t i = 0; i < n; ++i) {
      if (v[i] != scale * (i % 11)) return false;
    }
  }
  // float64 PRODUCT (exact for small integers).
  {
    std::vector<double> v = {2.0, 1.0, static_cast<double>(r + 1)};
    if (!plane->Allreduce(v.data(), 3, DataType::FLOAT64, ReduceOp::PRODUCT)
             .ok()) {
      return false;
    }
    double fact = 1.0;
    for (int q = 1; q <= world; ++q) fact *= q;
    if (v[0] != std::pow(2.0, world) || v[1] != 1.0 || v[2] != fact) {
      return false;
    }
  }
  // int32 MAX, small (latency path under AUTO).
  {
    std::vector<int32_t> v = {r, 100 - r, 7};
    if (!plane->Allreduce(v.data(), 3, DataType::INT32, ReduceOp::MAX).ok()) {
      return false;
    }
    if (v[0] != world - 1 || v[1] != 100 || v[2] != 7) return false;
  }
  // int64 MIN.
  {
    std::vector<int64_t> v = {static_cast<int64_t>(r) - 5, 1000 + r};
    if (!plane->Allreduce(v.data(), 2, DataType::INT64, ReduceOp::MIN).ok()) {
      return false;
    }
    if (v[0] != -5 || v[1] != 1000) return false;
  }
  // uint8 / int8 SUM.
  {
    std::vector<uint8_t> u(5, 3);
    if (!plane->Allreduce(u.data(), 5, DataType::UINT8, ReduceOp::SUM).ok()) {
      return false;
    }
    for (uint8_t x : u) {
      if (x != 3 * world) return false;
    }
    std::vector<int8_t> s(5, -2);
    if (!plane->Allreduce(s.data(), 5, DataType::INT8, ReduceOp::SUM).ok()) {
      return false;
    }
    for (int8_t x : s) {
      if (x != -2 * world) return false;
    }
  }
  // bool: SUM == OR, PRODUCT == AND.
  {
    std::vector<uint8_t> v = {static_cast<uint8_t>(r == 0 ? 1 : 0), 1, 0};
    if (!plane->Allreduce(v.data(), 3, DataType::BOOL, ReduceOp::SUM).ok()) {
      return false;
    }
    if (v[0] != 1 || v[1] != 1 || v[2] != 0) return false;
    std::vector<uint8_t> w = {static_cast<uint8_t>(r == 0 ? 0 : 1), 1, 1};
    if (!plane->Allreduce(w.data(), 3, DataType::BOOL, ReduceOp::PRODUCT)
             .ok()) {
      return false;
    }
    if (w[0] != 0 || w[1] != 1 || w[2] != 1) return false;
  }
  // fp16 SUM through the fused kernel.
  {
    const int64_t n = 1024;
    std::vector<uint16_t> v(n, FloatToHalfPublic(0.25f));
    if (!plane->Allreduce(v.data(), n, DataType::FLOAT16, ReduceOp::SUM)
             .ok()) {
      return false;
    }
    for (int64_t i = 0; i < n; ++i) {
      if (HalfToFloatPublic(v[i]) != 0.25f * world) return false;
    }
  }
  // bf16 MAX.
  {
    std::vector<uint16_t> v = {FloatToBf16Public(static_cast<float>(r)),
                               FloatToBf16Public(-1.0f)};
    if (!plane->Allreduce(v.data(), 2, DataType::BFLOAT16, ReduceOp::MAX)
             .ok()) {
      return false;
    }
    if (Bf16ToFloatPublic(v[0]) != static_cast<float>(world - 1) ||
        Bf16ToFloatPublic(v[1]) != -1.0f) {
      return false;
    }
  }
  return true;
}

// In-process world: one DataPlane per thread over localhost TCP (all ranks
// "share a host", so the lanes come up as shm unless disabled), exercising
// every allreduce algorithm (incl. the pipelined ring with a tiny segment
// size) on even/odd world sizes across the exhaustive dtype/op sweep.
void TestDataPlaneAllreduceAlgos() {
  for (bool shm : {false, true}) {
    for (int world : {2, 3, 4}) {
      for (AllreduceAlgo algo :
           {AllreduceAlgo::AUTO, AllreduceAlgo::RING,
            AllreduceAlgo::RECURSIVE_DOUBLING, AllreduceAlgo::TREE,
            AllreduceAlgo::SCATTER_ALLGATHER,
            AllreduceAlgo::PARAMETER_SERVER}) {
        TestWorld w = MakeWorld(
            std::vector<std::string>(world, "127.0.0.1"));
        for (int r = 0; r < world; ++r) {
          w.planes[r]->set_allreduce_algo(algo);
          w.planes[r]->set_segment_bytes(512);  // force ring pipelining
          w.planes[r]->set_crossover_bytes(4096);
          w.planes[r]->set_shm_enabled(shm);
          w.planes[r]->set_shm_ring_bytes(8192);  // force ring wraparound
          w.planes[r]->set_hier_mode(HierMode::OFF);
        }
        std::atomic<int> bad{0};
        std::vector<std::thread> threads;
        for (int r = 0; r < world; ++r) {
          threads.emplace_back([&, r] {
            if (!w.planes[r]->Connect(w.peers).ok()) {
              ++bad;
              return;
            }
            if (w.planes[r]->shm_lane_count() != (shm ? world - 1 : 0)) {
              ++bad;
              return;
            }
            if (!RunDtypeOpSweep(w.planes[r].get(), r, world)) ++bad;
          });
        }
        for (auto& t : threads) t.join();
        if (bad != 0) {
          std::fprintf(
              stderr,
              "FAIL DataPlane allreduce world=%d algo=%d shm=%d (%d bad)\n",
              world, static_cast<int>(algo), shm ? 1 : 0, bad.load());
          ++failures;
        }
        for (auto& p : w.planes) p->Shutdown();
      }
    }
  }
}

// The probe-fallback acceptance fixture at the world level: identical
// inputs through TCP worlds with every zero-copy mode (OFF = pure copy
// path, ON/AUTO = armed MSG_ZEROCOPY where the kernel allows, URING = the
// io_uring ladder, each degrading to copy under seccomp) must produce
// BITWISE identical results — the lane may never change payload bytes.
void TestDataPlaneZeroCopyMatchesCopyPathBitwise() {
  const int world = 2;
  const int64_t n = 400000;  // ~1.6 MB: hops clear ZeroCopySender::kMinBytes
  std::vector<std::vector<float>> outputs;
  const ZeroCopyMode modes[] = {ZeroCopyMode::OFF, ZeroCopyMode::ON,
                                ZeroCopyMode::AUTO, ZeroCopyMode::URING};
  for (ZeroCopyMode mode : modes) {
    TestWorld w = MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
    for (int r = 0; r < world; ++r) {
      w.planes[r]->set_allreduce_algo(AllreduceAlgo::RING);
      w.planes[r]->set_segment_bytes(64 * 1024);
      w.planes[r]->set_shm_enabled(false);  // pure TCP lanes
      w.planes[r]->set_hier_mode(HierMode::OFF);
      w.planes[r]->set_tcp_zerocopy(mode);
    }
    std::vector<std::vector<float>> bufs(world);
    std::atomic<int> bad{0};
    std::vector<std::thread> threads;
    for (int r = 0; r < world; ++r) {
      threads.emplace_back([&, r] {
        if (!w.planes[r]->Connect(w.peers).ok()) {
          ++bad;
          return;
        }
        bufs[r].resize(n);
        for (int64_t i = 0; i < n; ++i) {
          // Values whose sums are not exactly representable — bitwise
          // agreement must come from identical arithmetic, not luck.
          bufs[r][i] = 0.1f * static_cast<float>((i % 97) + r) + 1e-3f;
        }
        Status st = w.planes[r]->Allreduce(bufs[r].data(), n,
                                           DataType::FLOAT32, ReduceOp::SUM);
        if (!st.ok()) {
          std::fprintf(stderr, "zc world rank %d allreduce: %s\n", r,
                       st.reason.c_str());
          ++bad;
        }
      });
    }
    for (auto& t : threads) t.join();
    if (bad != 0) {
      std::fprintf(stderr, "FAIL zero-copy bitwise world mode=%d (%d bad)\n",
                   static_cast<int>(mode), bad.load());
      ++failures;
    }
    if (bad == 0) {
      CHECK_TRUE(bufs[0] == bufs[1]);  // ranks agree within the world
      if (mode == ZeroCopyMode::ON) {
        // With the lane armed on real TCP, the transport label must say so
        // (it may have legitimately downgraded only under AUTO).
        const std::string& label = w.planes[0]->transport_label();
        CHECK_TRUE(label == (w.planes[0]->zerocopy_active() ? "tcp-zc"
                                                            : "tcp"));
      }
      outputs.push_back(bufs[0]);
    }
    for (auto& p : w.planes) p->Shutdown();
  }
  for (size_t i = 1; i < outputs.size(); ++i) {
    CHECK_TRUE(outputs[i] == outputs[0]);  // every lane bitwise-matches OFF
  }
}

// Chaos `drop` (silent partition) through the zero-copy send path: the
// blackholed exchange must trip the read deadline and abort the plane, not
// wedge inside the completion drain.
void TestDataPlaneZeroCopyDropAborts() {
  const int world = 2;
  TestWorld w = MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
  for (int r = 0; r < world; ++r) {
    w.planes[r]->set_allreduce_algo(AllreduceAlgo::RING);
    w.planes[r]->set_shm_enabled(false);
    w.planes[r]->set_hier_mode(HierMode::OFF);
    w.planes[r]->set_tcp_zerocopy(ZeroCopyMode::ON);
    w.planes[r]->set_failure_detect_ms(100);
    w.planes[r]->set_read_deadline_secs(0.3);
  }
  ChaosSpec drop;
  drop.action = ChaosSpec::Action::DROP;
  drop.hop_index = 1;
  drop.peer = 0;
  w.planes[1]->set_chaos(drop);
  const int64_t n = 400000;
  std::atomic<int> failed{0};
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> threads;
  for (int r = 0; r < world; ++r) {
    threads.emplace_back([&, r] {
      if (!w.planes[r]->Connect(w.peers).ok()) {
        ++failed;
        return;
      }
      std::vector<float> v(n, static_cast<float>(r + 1));
      Status st = w.planes[r]->Allreduce(v.data(), n, DataType::FLOAT32,
                                         ReduceOp::SUM);
      if (!st.ok()) ++failed;
    });
  }
  for (auto& t : threads) t.join();
  double waited = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  // At least the dropped side fails (the healthy side's op breaks too once
  // the abort cascades); nobody may hang past the deadline + slack.
  CHECK_TRUE(failed >= 1);
  CHECK_TRUE(waited < 10.0);
  CHECK_TRUE(w.planes[1]->aborted());
  for (auto& p : w.planes) p->Shutdown();
}

// Scale-out algorithms (scatter-allgather, parameter-server) against the
// ring across worlds x transports x wire modes, on fp32 values whose sums
// are NOT exactly representable:
//   - every algorithm must agree BITWISE across ranks (compressed modes
//     included — quantize-once-at-owner makes every rank decode the same
//     codes);
//   - scatter-allgather under compression=NONE must match the ring BITWISE
//     (it replays the ring reduce-scatter's exact fold order);
//   - parameter-server is a LEFT fold (x_0 + x_1 + ...), a different IEEE
//     summation order than the ring's owner-rotated fold, so it is only
//     held to cross-rank identity plus a loose numeric tolerance.
void TestDataPlaneScaleAlgosBitwise() {
  const int64_t n = 3001;  // odd: ragged chunks, empty none at w<=5
  const AllreduceAlgo algos[] = {AllreduceAlgo::RING,
                                 AllreduceAlgo::SCATTER_ALLGATHER,
                                 AllreduceAlgo::PARAMETER_SERVER};
  for (bool shm : {false, true}) {
    for (int world : {2, 3, 5}) {
      for (WireCompression comp :
           {WireCompression::NONE, WireCompression::FP16,
            WireCompression::INT8, WireCompression::INT4}) {
        // outs[algo][rank] — filled per algorithm run below.
        std::vector<std::vector<std::vector<float>>> outs(
            3, std::vector<std::vector<float>>(world));
        std::vector<double> expect(n, 0.0);
        for (int r = 0; r < world; ++r) {
          for (int64_t i = 0; i < n; ++i) {
            expect[i] +=
                0.1 * static_cast<double>((i % 97) + r) + 1e-3;
          }
        }
        for (int a = 0; a < 3; ++a) {
          TestWorld w = MakeWorld(
              std::vector<std::string>(world, "127.0.0.1"));
          for (int r = 0; r < world; ++r) {
            w.planes[r]->set_allreduce_algo(algos[a]);
            w.planes[r]->set_segment_bytes(512);
            w.planes[r]->set_shm_enabled(shm);
            w.planes[r]->set_shm_ring_bytes(8192);
            w.planes[r]->set_hier_mode(HierMode::OFF);
          }
          std::atomic<int> bad{0};
          std::vector<std::thread> threads;
          for (int r = 0; r < world; ++r) {
            threads.emplace_back([&, r] {
              if (!w.planes[r]->Connect(w.peers).ok()) {
                ++bad;
                return;
              }
              outs[a][r].resize(n);
              for (int64_t i = 0; i < n; ++i) {
                outs[a][r][i] =
                    0.1f * static_cast<float>((i % 97) + r) + 1e-3f;
              }
              std::vector<float> residual;
              if (comp != WireCompression::NONE) {
                residual.assign(n, 0.0f);
                w.planes[r]->BeginCompressedOp(comp, residual.data());
              }
              Status st = w.planes[r]->Allreduce(
                  outs[a][r].data(), n, DataType::FLOAT32, ReduceOp::SUM);
              if (comp != WireCompression::NONE) {
                w.planes[r]->EndCompressedOp();
              }
              if (!st.ok()) {
                std::fprintf(stderr, "scale algo rank %d allreduce: %s\n",
                             r, st.reason.c_str());
                ++bad;
              }
            });
          }
          for (auto& t : threads) t.join();
          if (bad == 0) {
            for (int r = 1; r < world; ++r) {
              if (outs[a][r] != outs[a][0]) ++bad;  // cross-rank bitwise
            }
            // Loose numeric sanity (any fold order, any wire mode).
            const double tol =
                (comp == WireCompression::NONE   ? 1e-3
                 : comp == WireCompression::FP16 ? 2e-2
                 : comp == WireCompression::INT8 ? 0.2
                                                 : 2.0) *
                static_cast<double>(world);
            for (int64_t i = 0; i < n && bad == 0; ++i) {
              if (std::fabs(outs[a][0][i] - expect[i]) > tol) ++bad;
            }
          }
          if (bad != 0) {
            std::fprintf(stderr,
                         "FAIL scale algos world=%d algo=%d comp=%s shm=%d "
                         "(%d bad)\n",
                         world, static_cast<int>(algos[a]),
                         WireCompressionName(comp), shm ? 1 : 0, bad.load());
            ++failures;
          }
          for (auto& p : w.planes) p->Shutdown();
        }
        if (comp == WireCompression::NONE) {
          // scatter-allgather == ring, bitwise, on the raw wire.
          CHECK_TRUE(outs[1][0] == outs[0][0]);
        }
      }
    }
  }
}

// Chaos `drop` (silent partition) mid-collective on the scale-out
// algorithms: the blackholed hop must trip the read deadline, abort the
// plane, and cascade — never wedge. Covers both the scatter-allgather
// direct exchanges and the parameter-server star (worker <-> root lanes).
void TestDataPlaneScaleAlgosDropAborts() {
  for (AllreduceAlgo algo : {AllreduceAlgo::SCATTER_ALLGATHER,
                             AllreduceAlgo::PARAMETER_SERVER}) {
    const int world = 3;  // ragged chunks + a bystander rank for the cascade
    TestWorld w = MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
    for (int r = 0; r < world; ++r) {
      w.planes[r]->set_allreduce_algo(algo);
      w.planes[r]->set_shm_enabled(false);
      w.planes[r]->set_hier_mode(HierMode::OFF);
      w.planes[r]->set_failure_detect_ms(100);
      w.planes[r]->set_read_deadline_secs(0.3);
    }
    ChaosSpec drop;
    drop.action = ChaosSpec::Action::DROP;
    drop.hop_index = 1;
    drop.peer = 0;
    w.planes[1]->set_chaos(drop);
    const int64_t n = 100001;
    std::atomic<int> failed{0};
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> threads;
    for (int r = 0; r < world; ++r) {
      threads.emplace_back([&, r] {
        if (!w.planes[r]->Connect(w.peers).ok()) {
          ++failed;
          return;
        }
        std::vector<float> v(n, static_cast<float>(r + 1));
        Status st = w.planes[r]->Allreduce(v.data(), n, DataType::FLOAT32,
                                           ReduceOp::SUM);
        if (!st.ok()) ++failed;
      });
    }
    for (auto& t : threads) t.join();
    double waited = std::chrono::duration<double>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
    if (failed < 1 || waited >= 10.0 || !w.planes[1]->aborted()) {
      std::fprintf(stderr,
                   "FAIL scale algo drop abort algo=%d failed=%d "
                   "waited=%.1f aborted=%d\n",
                   static_cast<int>(algo), failed.load(), waited,
                   w.planes[1]->aborted() ? 1 : 0);
      ++failures;
    }
    for (auto& p : w.planes) p->Shutdown();
  }
}

// Hierarchical two-level allreduce across synthetic host topologies: two
// host strings split the world into local (shm) groups with one TCP leader
// pair; uneven local sizes exercise the leader gather/scatter with ragged
// chunks. The flat path on the identical world double-checks the oracle.
void TestDataPlaneHierarchicalAllreduce() {
  struct Topo {
    std::vector<std::string> hosts;
  };
  const Topo topos[] = {
      {{"127.0.0.1", "127.0.0.1", "localhost", "localhost"}},  // 2x2
      {{"127.0.0.1", "127.0.0.1", "127.0.0.1", "localhost"}},  // 3+1
      {{"127.0.0.1", "127.0.0.1", "localhost"}},               // 2+1
      {{"127.0.0.1", "127.0.0.1", "127.0.0.1"}},               // single host
  };
  for (const Topo& topo : topos) {
    const int world = static_cast<int>(topo.hosts.size());
    TestWorld w = MakeWorld(topo.hosts);
    for (int r = 0; r < world; ++r) {
      w.planes[r]->set_segment_bytes(512);
      w.planes[r]->set_shm_ring_bytes(8192);
      w.planes[r]->set_hier_mode(HierMode::ON);
    }
    std::atomic<int> bad{0};
    std::vector<std::thread> threads;
    for (int r = 0; r < world; ++r) {
      threads.emplace_back([&, r] {
        if (!w.planes[r]->Connect(w.peers).ok()) {
          ++bad;
          return;
        }
        if (!w.planes[r]->hier_active()) {
          ++bad;
          return;
        }
        if (!RunDtypeOpSweep(w.planes[r].get(), r, world)) ++bad;
        // Tiny tensor: count < local group size leaves empty chunks on the
        // gather/scatter path.
        std::vector<float> tiny = {static_cast<float>(r + 1)};
        if (!w.planes[r]
                 ->Allreduce(tiny.data(), 1, DataType::FLOAT32, ReduceOp::SUM)
                 .ok() ||
            tiny[0] != world * (world + 1) / 2.0f) {
          ++bad;
        }
      });
    }
    for (auto& t : threads) t.join();
    if (bad != 0) {
      std::fprintf(stderr, "FAIL hierarchical allreduce world=%d (%d bad)\n",
                   world, bad.load());
      ++failures;
    }
    for (auto& p : w.planes) p->Shutdown();
  }
}

// --- wire compression (compressed.{h,cpp}) ----------------------------------

// Per-bucket quantization range for the error bound, replicating the
// quantizer's zero-padded-tail semantics.
float BucketRange(const float* x, int64_t count, int64_t bucket) {
  const int64_t lo = bucket * kWireBucketSize;
  const int64_t n = std::min<int64_t>(kWireBucketSize, count - lo);
  float mn = x[lo], mx = x[lo];
  for (int64_t i = 0; i < n; ++i) {
    mn = std::min(mn, x[lo + i]);
    mx = std::max(mx, x[lo + i]);
  }
  if (n < kWireBucketSize) {
    mn = std::min(mn, 0.0f);
    mx = std::max(mx, 0.0f);
  }
  return mx - mn;
}

void TestWireQuantizerRoundTrip() {
  // Counts exercise sub-bucket tensors, exact buckets, padded tails, and
  // odd int4 nibble counts.
  const int64_t counts[] = {1, 2, 511, 512, 513, 1000, 1025};
  const WireCompression modes[] = {WireCompression::FP16,
                                   WireCompression::INT8,
                                   WireCompression::INT4};
  for (WireCompression c : modes) {
    for (int64_t n : counts) {
      std::vector<float> x(n), back(n, -1e9f);
      for (int64_t i = 0; i < n; ++i) {
        x[i] = 0.25f * static_cast<float>((i * 7 + 3) % 23 - 11) +
               0.001f * static_cast<float>(i % 5);
      }
      std::vector<uint8_t> wire(static_cast<size_t>(WireBytes(c, n)), 0xa5);
      WireCompress(c, x.data(), n, wire.data(), nullptr, nullptr);
      WireDecompress(c, wire.data(), n, back.data());
      const float levels = c == WireCompression::INT8 ? 255.0f : 15.0f;
      for (int64_t i = 0; i < n; ++i) {
        float bound;
        if (c == WireCompression::FP16) {
          bound = std::fabs(x[i]) * 1e-3f + 1e-6f;
        } else {
          // Max-min quantization error is at most half a unit.
          bound = BucketRange(x.data(), n, i / kWireBucketSize) / levels *
                      0.5f + 1e-5f;
        }
        if (std::fabs(back[i] - x[i]) > bound) {
          std::fprintf(stderr,
                       "FAIL wire roundtrip %s n=%lld i=%lld: %g vs %g\n",
                       WireCompressionName(c), static_cast<long long>(n),
                       static_cast<long long>(i), back[i], x[i]);
          ++failures;
          return;
        }
      }
      // The fused decompress-add matches decompress + add exactly.
      std::vector<float> acc(n, 1.5f);
      WireDecompressAdd(c, wire.data(), n, acc.data());
      for (int64_t i = 0; i < n; ++i) {
        CHECK_TRUE(acc[i] == 1.5f + back[i]);
      }
      // Self-decode returns exactly what a peer would decode (and may
      // alias the source buffer).
      std::vector<float> self(x);
      WireCompress(c, self.data(), n, wire.data(), nullptr, self.data());
      for (int64_t i = 0; i < n; ++i) {
        CHECK_TRUE(self[i] == back[i]);
      }
    }
  }
}

void TestWireInt4PackingAndTail() {
  // Hand-checked 3-element int4 block: the tail bucket is zero-padded for
  // the min/max scan (mn 0, mx 2, unit 2/15), codes ride low-nibble-first
  // (quantize.py pack_bits order), and the scaled tie 7.5 rounds to EVEN 8.
  const float x[3] = {0.0f, 1.0f, 2.0f};
  std::vector<uint8_t> wire(
      static_cast<size_t>(WireBytes(WireCompression::INT4, 3)), 0xff);
  CHECK_TRUE(wire.size() == 8 + 2);  // one bucket header + 2 code bytes
  WireCompress(WireCompression::INT4, x, 3, wire.data(), nullptr, nullptr);
  float mn, unit;
  memcpy(&mn, wire.data(), 4);
  memcpy(&unit, wire.data() + 4, 4);
  CHECK_TRUE(mn == 0.0f);
  CHECK_TRUE(std::fabs(unit - 2.0f / 15.0f) < 1e-7f);
  // codes low-nibble-first: element 1 scales to 1.0/unit = 7.49999952 in
  // fp32 (not an exact tie — unit rounds up), so RNE gives 7.
  CHECK_TRUE(wire[8] == 0x70);
  CHECK_TRUE(wire[9] == 0x0f);  // code 15; odd tail's high nibble is zeroed
  float back[3];
  WireDecompress(WireCompression::INT4, wire.data(), 3, back);
  CHECK_TRUE(back[0] == 0.0f);
  CHECK_TRUE(std::fabs(back[1] - 7.0f * 2.0f / 15.0f) < 1e-6f);
  CHECK_TRUE(back[2] == 2.0f);
}

void TestWireErrorFeedbackConvergence() {
  // The EF telescoping identity: sum_t decode_t = T*x + r_0 - r_T, so the
  // running mean of the quantized outputs converges to the exact input at
  // rate |r_T| / T — repeated int4 quantization of a FIXED gradient
  // recovers it to far below one quantization unit.
  const int64_t n = 700;  // padded tail bucket included
  std::vector<float> x(n);
  for (int64_t i = 0; i < n; ++i) {
    x[i] = 0.125f * static_cast<float>((i * 11 + 5) % 31 - 15);
  }
  std::vector<float> residual(n, 0.0f), decode(n, 0.0f);
  std::vector<double> acc(n, 0.0);
  std::vector<uint8_t> wire(
      static_cast<size_t>(WireBytes(WireCompression::INT4, n)));
  const int kIters = 200;
  for (int t = 0; t < kIters; ++t) {
    WireCompress(WireCompression::INT4, x.data(), n, wire.data(),
                 residual.data(), decode.data());
    for (int64_t i = 0; i < n; ++i) acc[i] += decode[i];
  }
  float max_range = 0.0f;
  for (int64_t b = 0; b * kWireBucketSize < n; ++b) {
    max_range = std::max(max_range, BucketRange(x.data(), n, b));
  }
  // One-shot quantization error bound vs the EF mean bound (T x smaller).
  const double one_shot = max_range / 15.0 * 0.5;
  const double ef_bound = 2.0 * one_shot / kIters + 1e-5;
  for (int64_t i = 0; i < n; ++i) {
    double err = std::fabs(acc[i] / kIters - x[i]);
    if (err > ef_bound) {
      std::fprintf(stderr,
                   "FAIL wire EF convergence at %lld: err %g (bound %g, "
                   "one-shot %g)\n",
                   static_cast<long long>(i), err, ef_bound, one_shot);
      ++failures;
      return;
    }
  }
}

// Compressed allreduce worlds: fp16/int8/int4 x ring/recursive-doubling x
// TCP/shm lanes. Verifies the quantized sum against the exact fp32 oracle
// within the mode's error budget, bitwise cross-rank agreement (the
// self-decode/forwarding design), raw-vs-wire byte accounting, and that
// non-eligible ops (MIN) pass through the compressed op untouched.
void TestDataPlaneCompressedAllreduce() {
  const int64_t n = 3000;
  for (bool shm : {false, true}) {
    for (AllreduceAlgo algo :
         {AllreduceAlgo::RING, AllreduceAlgo::RECURSIVE_DOUBLING}) {
      for (WireCompression comp :
           {WireCompression::FP16, WireCompression::INT8,
            WireCompression::INT4}) {
        for (int world : {2, 3}) {  // 3: ragged ring chunks + the RD fold
          TestWorld w = MakeWorld(
              std::vector<std::string>(world, "127.0.0.1"));
          for (int r = 0; r < world; ++r) {
            w.planes[r]->set_allreduce_algo(algo);
            w.planes[r]->set_segment_bytes(512);
            w.planes[r]->set_shm_enabled(shm);
            w.planes[r]->set_shm_ring_bytes(8192);
            w.planes[r]->set_hier_mode(HierMode::OFF);
          }
          std::vector<std::vector<float>> outs(
              world, std::vector<float>(n));
          std::vector<double> expect(n, 0.0);
          for (int r = 0; r < world; ++r) {
            for (int64_t i = 0; i < n; ++i) {
              outs[r][i] = 0.25f *
                  static_cast<float>((i * 7 + r * 13) % 23 - 11);
              expect[i] += outs[r][i];
            }
          }
          double max_abs = 0.0;
          for (double v : expect) max_abs = std::max(max_abs, std::fabs(v));
          const double tol =
              (comp == WireCompression::FP16   ? 2e-3
               : comp == WireCompression::INT8 ? 0.03
                                               : 0.4) *
              std::max(max_abs, 1.0);
          std::atomic<int> bad{0};
          std::vector<std::thread> threads;
          for (int r = 0; r < world; ++r) {
            threads.emplace_back([&, r] {
              if (!w.planes[r]->Connect(w.peers).ok()) {
                ++bad;
                return;
              }
              std::vector<float> residual(n, 0.0f);
              w.planes[r]->BeginCompressedOp(comp, residual.data());
              Status st = w.planes[r]->Allreduce(
                  outs[r].data(), n, DataType::FLOAT32, ReduceOp::SUM);
              w.planes[r]->EndCompressedOp();
              if (!st.ok()) {
                ++bad;
                return;
              }
              // int8 on the pure-compressed ring must beat 3.5x on the
              // wire (headers cost 8/512 per bucket; fp32 -> int8 is 4x).
              if (comp == WireCompression::INT8 &&
                  algo == AllreduceAlgo::RING &&
                  w.planes[r]->op_wire_bytes() * 7 >
                      w.planes[r]->op_raw_bytes() * 2) {
                ++bad;
                return;
              }
              // MIN is not eligible: the compressed op leaves it exact.
              std::vector<int32_t> m = {r, 100 - r};
              w.planes[r]->BeginCompressedOp(comp, nullptr);
              st = w.planes[r]->Allreduce(m.data(), 2, DataType::INT32,
                                          ReduceOp::MIN);
              w.planes[r]->EndCompressedOp();
              if (!st.ok() || m[0] != 0 || m[1] != 100 - (world - 1)) ++bad;
            });
          }
          for (auto& t : threads) t.join();
          for (int r = 0; r < world && bad == 0; ++r) {
            for (int64_t i = 0; i < n; ++i) {
              if (std::fabs(outs[r][i] - expect[i]) > tol) {
                ++bad;
                break;
              }
            }
            // Bitwise cross-rank agreement.
            if (memcmp(outs[r].data(), outs[0].data(), n * 4) != 0) ++bad;
          }
          if (bad != 0) {
            std::fprintf(stderr,
                         "FAIL compressed allreduce world=%d algo=%d "
                         "comp=%s shm=%d (%d bad)\n",
                         world, static_cast<int>(algo),
                         WireCompressionName(comp), shm ? 1 : 0,
                         bad.load());
            ++failures;
          }
          for (auto& p : w.planes) p->Shutdown();
        }
      }
    }
  }
}

// First-class reduce-scatter: worlds {2,3} x TCP/shm x
// {dense,fp16,int8,int4}. Every rank must land exactly its own contiguous
// chunk of the reduced vector — the rotated-group ring leaves chunk r on
// rank r — within the wire mode's error budget, including a ragged count
// (standalone DataPlane callers may pass count % world != 0).
void TestDataPlaneReduceScatter() {
  for (bool shm : {false, true}) {
    for (WireCompression comp :
         {WireCompression::NONE, WireCompression::FP16,
          WireCompression::INT8, WireCompression::INT4}) {
      for (int world : {2, 3}) {
        // Ragged only on the dense path: the compressed ring quantizes
        // whole chunks, and the coordinator enforces divisibility for the
        // public op anyway.
        const int64_t n = comp == WireCompression::NONE ? 3001 : 3000;
        TestWorld w =
            MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
        for (int r = 0; r < world; ++r) {
          w.planes[r]->set_segment_bytes(512);
          w.planes[r]->set_shm_enabled(shm);
          w.planes[r]->set_shm_ring_bytes(8192);
          w.planes[r]->set_hier_mode(HierMode::OFF);
        }
        std::vector<std::vector<float>> ins(world, std::vector<float>(n));
        std::vector<double> expect(n, 0.0);
        for (int r = 0; r < world; ++r) {
          for (int64_t i = 0; i < n; ++i) {
            ins[r][i] =
                0.25f * static_cast<float>((i * 5 + r * 17) % 19 - 9);
            expect[i] += ins[r][i];
          }
        }
        double max_abs = 0.0;
        for (double v : expect) max_abs = std::max(max_abs, std::fabs(v));
        const double tol =
            (comp == WireCompression::NONE   ? 1e-6
             : comp == WireCompression::FP16 ? 2e-3
             : comp == WireCompression::INT8 ? 0.03
                                             : 0.4) *
            std::max(max_abs, 1.0);
        std::vector<ByteBuf> outs(world);
        std::atomic<int> bad{0};
        std::vector<std::thread> threads;
        for (int r = 0; r < world; ++r) {
          threads.emplace_back([&, r] {
            if (!w.planes[r]->Connect(w.peers).ok()) {
              ++bad;
              return;
            }
            std::vector<float> residual(n, 0.0f);
            if (comp != WireCompression::NONE) {
              w.planes[r]->BeginCompressedOp(comp, residual.data());
            }
            Status st = w.planes[r]->ReduceScatter(
                ins[r].data(), n, DataType::FLOAT32, ReduceOp::SUM,
                &outs[r]);
            w.planes[r]->EndCompressedOp();
            if (!st.ok()) ++bad;
            // Half an allreduce: raw accounting is (n-1)/n of the payload
            // this rank forwarded; dense wire == raw.
            if (comp == WireCompression::NONE &&
                w.planes[r]->op_wire_bytes() !=
                    w.planes[r]->op_raw_bytes()) {
              ++bad;
            }
          });
        }
        for (auto& t : threads) t.join();
        // Chunk starts mirror ChunkStarts(): base + remainder spread.
        const int64_t base = n / world, rem = n % world;
        int64_t start = 0;
        for (int r = 0; r < world && bad == 0; ++r) {
          const int64_t len = base + (r < rem ? 1 : 0);
          if (static_cast<int64_t>(outs[r].size()) != len * 4) {
            ++bad;
            break;
          }
          const float* got = reinterpret_cast<const float*>(outs[r].data());
          for (int64_t i = 0; i < len; ++i) {
            if (std::fabs(got[i] - expect[start + i]) > tol) {
              ++bad;
              break;
            }
          }
          start += len;
        }
        if (bad != 0) {
          std::fprintf(stderr,
                       "FAIL reduce-scatter world=%d comp=%s shm=%d\n",
                       world, WireCompressionName(comp), shm ? 1 : 0);
          ++failures;
        }
        for (auto& p : w.planes) p->Shutdown();
      }
    }
  }
}

// First-class ragged allgather: worlds {2,3} x TCP/shm x
// {dense-direct,dense-ring,fp16,int8,int4}. Dense results must be exact
// on both dispatch arms (pairwise rotation under the crossover, ring
// store-and-forward above it); compressed results ride quantize-once
// owner codes, so every rank's gathered vector must be BITWISE identical
// even though the codes are lossy vs the originals.
void TestDataPlaneAllgatherv() {
  for (bool shm : {false, true}) {
    struct Arm {
      WireCompression comp;
      int64_t crossover;  // 0 = keep the 32 KB default (direct arm)
    };
    const Arm arms[] = {
        {WireCompression::NONE, 0},     // direct pairwise rotation
        {WireCompression::NONE, 1024},  // forced ring store-and-forward
        {WireCompression::FP16, 0},     {WireCompression::INT8, 0},
        {WireCompression::INT4, 0},
    };
    for (const Arm& arm : arms) {
      for (int world : {2, 3}) {
        TestWorld w =
            MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
        for (int r = 0; r < world; ++r) {
          w.planes[r]->set_segment_bytes(512);
          w.planes[r]->set_shm_enabled(shm);
          w.planes[r]->set_shm_ring_bytes(8192);
          w.planes[r]->set_hier_mode(HierMode::OFF);
          if (arm.crossover > 0) {
            w.planes[r]->set_crossover_bytes(arm.crossover);
          }
        }
        // Ragged per-rank blocks (fp32 counts; ~3-5 KB each).
        std::vector<std::vector<float>> ins(world);
        std::vector<int64_t> block_bytes(world);
        std::vector<double> expect;
        for (int r = 0; r < world; ++r) {
          const int64_t cnt = 800 + 131 * r;
          ins[r].resize(cnt);
          for (int64_t i = 0; i < cnt; ++i) {
            ins[r][i] =
                0.5f * static_cast<float>((i * 3 + r * 7) % 17 - 8);
            expect.push_back(ins[r][i]);
          }
          block_bytes[r] = cnt * 4;
        }
        double max_abs = 0.0;
        for (double v : expect) max_abs = std::max(max_abs, std::fabs(v));
        const double tol =
            (arm.comp == WireCompression::NONE   ? 0.0
             : arm.comp == WireCompression::FP16 ? 2e-3
             : arm.comp == WireCompression::INT8 ? 0.03
                                                 : 0.4) *
            std::max(max_abs, 1.0);
        std::vector<ByteBuf> outs(world);
        std::atomic<int> bad{0};
        std::vector<std::thread> threads;
        for (int r = 0; r < world; ++r) {
          threads.emplace_back([&, r] {
            if (!w.planes[r]->Connect(w.peers).ok()) {
              ++bad;
              return;
            }
            if (arm.comp != WireCompression::NONE) {
              w.planes[r]->BeginCompressedOp(arm.comp, nullptr);
            }
            Status st = w.planes[r]->Allgatherv(
                ins[r].data(), block_bytes[r], block_bytes, &outs[r]);
            w.planes[r]->EndCompressedOp();
            if (!st.ok()) ++bad;
          });
        }
        for (auto& t : threads) t.join();
        const size_t total = expect.size();
        for (int r = 0; r < world && bad == 0; ++r) {
          if (outs[r].size() != total * 4) {
            ++bad;
            break;
          }
          const float* got = reinterpret_cast<const float*>(outs[r].data());
          for (size_t i = 0; i < total; ++i) {
            const double err = std::fabs(got[i] - expect[i]);
            if (arm.comp == WireCompression::NONE ? err != 0.0
                                                  : err > tol) {
              ++bad;
              break;
            }
          }
          // Bitwise world-wide, lossy or not (quantize-once owner codes).
          if (memcmp(outs[r].data(), outs[0].data(), total * 4) != 0) {
            ++bad;
          }
        }
        if (bad != 0) {
          std::fprintf(stderr,
                       "FAIL allgatherv world=%d comp=%s crossover=%lld "
                       "shm=%d\n",
                       world, WireCompressionName(arm.comp),
                       static_cast<long long>(arm.crossover), shm ? 1 : 0);
          ++failures;
        }
        for (auto& p : w.planes) p->Shutdown();
      }
    }
  }
}

// First-class broadcast: worlds {2,3,5} (npo2 exercises the
// binomial vrank rotation) x TCP/shm x {dense-flat,dense-tree,fp16,int8,
// int4 tree + int4 flat}. Nonzero root. Dense results must be exact;
// compressed results ride the root's quantize-once codes, so every rank
// (root included, via self-decode) must hold BITWISE identical bytes even
// though they are lossy vs the originals.
void TestDataPlaneBroadcast() {
  struct Arm {
    WireCompression comp;
    bool flat;
  };
  const Arm arms[] = {
      {WireCompression::NONE, true}, {WireCompression::NONE, false},
      {WireCompression::FP16, false}, {WireCompression::INT8, false},
      {WireCompression::INT4, false}, {WireCompression::INT4, true},
  };
  for (bool shm : {false, true}) {
    for (const Arm& arm : arms) {
      for (int world : {2, 3, 5}) {
        const int64_t n = 3001;
        const int root = 1 % world;
        TestWorld w =
            MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
        for (int r = 0; r < world; ++r) {
          w.planes[r]->set_segment_bytes(512);
          w.planes[r]->set_shm_enabled(shm);
          w.planes[r]->set_shm_ring_bytes(8192);
          w.planes[r]->set_hier_mode(HierMode::OFF);
          // Force the schedule: floor above the payload -> flat, 0 -> tree.
          w.planes[r]->set_bcast_flat_max(arm.flat ? (int64_t{1} << 30) : 0);
        }
        std::vector<float> orig(n);
        for (int64_t i = 0; i < n; ++i) {
          orig[i] = 0.25f * static_cast<float>((i * 7 + 3) % 23 - 11);
        }
        double max_abs = 0.0;
        for (float v : orig) {
          max_abs = std::max(max_abs, static_cast<double>(std::fabs(v)));
        }
        const double tol =
            (arm.comp == WireCompression::NONE   ? 0.0
             : arm.comp == WireCompression::FP16 ? 2e-3
             : arm.comp == WireCompression::INT8 ? 0.03
                                                 : 0.4) *
            std::max(max_abs, 1.0);
        // Root starts from the payload; everyone else from poison.
        std::vector<std::vector<float>> bufs(
            world, std::vector<float>(n, -777.0f));
        bufs[root] = orig;
        std::atomic<int> bad{0};
        std::vector<std::thread> threads;
        for (int r = 0; r < world; ++r) {
          threads.emplace_back([&, r] {
            if (!w.planes[r]->Connect(w.peers).ok()) {
              ++bad;
              return;
            }
            if (arm.comp != WireCompression::NONE) {
              w.planes[r]->BeginCompressedOp(arm.comp, nullptr);
            }
            Status st = w.planes[r]->Broadcast(bufs[r].data(), n * 4, root);
            w.planes[r]->EndCompressedOp();
            if (!st.ok()) ++bad;
            if (std::strcmp(w.planes[r]->last_algo_label(),
                            arm.flat ? "bcast_flat" : "bcast_tree") != 0) {
              ++bad;
            }
            // Dense wire == raw; int4/int8 must actually shrink the wire.
            if (arm.comp == WireCompression::NONE &&
                w.planes[r]->op_wire_bytes() != w.planes[r]->op_raw_bytes()) {
              ++bad;
            }
            if (r == root && arm.comp == WireCompression::INT4 &&
                w.planes[r]->op_wire_bytes() * 2 >
                    w.planes[r]->op_raw_bytes()) {
              ++bad;
            }
          });
        }
        for (auto& t : threads) t.join();
        for (int r = 0; r < world && bad == 0; ++r) {
          // Bitwise vs the root's post-op buffer on EVERY rank.
          if (memcmp(bufs[r].data(), bufs[root].data(), n * 4) != 0) {
            ++bad;
            break;
          }
          for (int64_t i = 0; i < n; ++i) {
            const double err = std::fabs(bufs[r][i] - orig[i]);
            if (arm.comp == WireCompression::NONE ? err != 0.0 : err > tol) {
              ++bad;
              break;
            }
          }
        }
        if (bad != 0) {
          std::fprintf(stderr,
                       "FAIL broadcast world=%d comp=%s flat=%d shm=%d\n",
                       world, WireCompressionName(arm.comp),
                       arm.flat ? 1 : 0, shm ? 1 : 0);
          ++failures;
        }
        for (auto& p : w.planes) p->Shutdown();
      }
    }
  }
}

// First-class pairwise alltoallv: worlds {2,3} x TCP/shm x
// {dense,fp16,int8,int4} with genuinely uneven splits including an empty
// block (the MoE capacity-overflow shape). Rank r's block for rank q must
// land exactly at q's recv offset for r; dense is exact, compressed within
// the wire mode's budget (each block quantized once at its sender).
void TestDataPlaneAlltoallv() {
  for (bool shm : {false, true}) {
    for (WireCompression comp :
         {WireCompression::NONE, WireCompression::FP16,
          WireCompression::INT8, WireCompression::INT4}) {
      for (int world : {2, 3}) {
        TestWorld w =
            MakeWorld(std::vector<std::string>(world, "127.0.0.1"));
        for (int r = 0; r < world; ++r) {
          w.planes[r]->set_segment_bytes(512);
          w.planes[r]->set_shm_enabled(shm);
          w.planes[r]->set_shm_ring_bytes(8192);
          w.planes[r]->set_hier_mode(HierMode::OFF);
        }
        // Uneven split matrix; (0 -> world-1) is an empty block.
        auto count = [&](int from, int to) -> int64_t {
          if (from == 0 && to == world - 1) return 0;
          return 501 + 217 * from + 131 * to;
        };
        auto val = [](int from, int to, int64_t i) {
          return 0.25f *
                 static_cast<float>((i * 3 + from * 7 + to * 11) % 21 - 10);
        };
        std::vector<std::vector<float>> ins(world);
        std::vector<std::vector<int64_t>> send_bytes(
            world, std::vector<int64_t>(world));
        std::vector<std::vector<int64_t>> recv_bytes(
            world, std::vector<int64_t>(world));
        for (int r = 0; r < world; ++r) {
          for (int q = 0; q < world; ++q) {
            send_bytes[r][q] = count(r, q) * 4;
            recv_bytes[r][q] = count(q, r) * 4;
            for (int64_t i = 0; i < count(r, q); ++i) {
              ins[r].push_back(val(r, q, i));
            }
          }
        }
        const double tol = (comp == WireCompression::NONE   ? 0.0
                            : comp == WireCompression::FP16 ? 2e-3
                            : comp == WireCompression::INT8 ? 0.03
                                                            : 0.4) *
                           3.0;
        std::vector<ByteBuf> outs(world);
        std::atomic<int> bad{0};
        std::vector<std::thread> threads;
        for (int r = 0; r < world; ++r) {
          threads.emplace_back([&, r] {
            if (!w.planes[r]->Connect(w.peers).ok()) {
              ++bad;
              return;
            }
            if (comp != WireCompression::NONE) {
              w.planes[r]->BeginCompressedOp(comp, nullptr);
            }
            Status st = w.planes[r]->Alltoallv(ins[r].data(), send_bytes[r],
                                               recv_bytes[r], &outs[r]);
            w.planes[r]->EndCompressedOp();
            if (!st.ok()) ++bad;
            if (std::strcmp(w.planes[r]->last_algo_label(), "pairwise") !=
                0) {
              ++bad;
            }
            if (comp == WireCompression::NONE &&
                w.planes[r]->op_wire_bytes() != w.planes[r]->op_raw_bytes()) {
              ++bad;
            }
          });
        }
        for (auto& t : threads) t.join();
        for (int r = 0; r < world && bad == 0; ++r) {
          int64_t total = 0;
          for (int q = 0; q < world; ++q) total += recv_bytes[r][q];
          if (static_cast<int64_t>(outs[r].size()) != total) {
            ++bad;
            break;
          }
          const float* got = reinterpret_cast<const float*>(outs[r].data());
          int64_t off = 0;
          for (int q = 0; q < world && bad == 0; ++q) {
            for (int64_t i = 0; i < count(q, r); ++i) {
              const double err = std::fabs(got[off + i] - val(q, r, i));
              if (comp == WireCompression::NONE ? err != 0.0 : err > tol) {
                ++bad;
                break;
              }
            }
            off += count(q, r);
          }
        }
        if (bad != 0) {
          std::fprintf(stderr, "FAIL alltoallv world=%d comp=%s shm=%d\n",
                       world, WireCompressionName(comp), shm ? 1 : 0);
          ++failures;
        }
        for (auto& p : w.planes) p->Shutdown();
      }
    }
  }
}

// Compressed hierarchical worlds: the leader (cross-host) phase carries the
// quantized hops, intra-host stages stay dense; result must still agree
// with the oracle and bitwise across every rank.
void TestDataPlaneCompressedHierarchical() {
  const int64_t n = 3000;
  const std::vector<std::vector<std::string>> topos = {
      {"127.0.0.1", "127.0.0.1", "localhost", "localhost"},  // 2x2
      {"127.0.0.1", "127.0.0.1", "localhost"},               // 2+1
  };
  for (const auto& hosts : topos) {
    for (WireCompression comp :
         {WireCompression::FP16, WireCompression::INT8,
          WireCompression::INT4}) {
      const int world = static_cast<int>(hosts.size());
      TestWorld w = MakeWorld(hosts);
      for (int r = 0; r < world; ++r) {
        w.planes[r]->set_segment_bytes(512);
        w.planes[r]->set_shm_ring_bytes(8192);
        w.planes[r]->set_hier_mode(HierMode::ON);
      }
      std::vector<std::vector<float>> outs(world, std::vector<float>(n));
      std::vector<double> expect(n, 0.0);
      for (int r = 0; r < world; ++r) {
        for (int64_t i = 0; i < n; ++i) {
          outs[r][i] =
              0.25f * static_cast<float>((i * 7 + r * 13) % 23 - 11);
          expect[i] += outs[r][i];
        }
      }
      double max_abs = 0.0;
      for (double v : expect) max_abs = std::max(max_abs, std::fabs(v));
      const double tol = (comp == WireCompression::FP16   ? 2e-3
                          : comp == WireCompression::INT8 ? 0.03
                                                          : 0.4) *
                         std::max(max_abs, 1.0);
      std::atomic<int> bad{0};
      std::vector<std::thread> threads;
      for (int r = 0; r < world; ++r) {
        threads.emplace_back([&, r] {
          if (!w.planes[r]->Connect(w.peers).ok() ||
              !w.planes[r]->hier_active()) {
            ++bad;
            return;
          }
          std::vector<float> residual(n, 0.0f);
          w.planes[r]->BeginCompressedOp(comp, residual.data());
          Status st = w.planes[r]->Allreduce(outs[r].data(), n,
                                             DataType::FLOAT32,
                                             ReduceOp::SUM);
          w.planes[r]->EndCompressedOp();
          if (!st.ok()) ++bad;
          // Tiny tensor through the compressed op: empty chunks and the
          // min-count edge must not wedge the two-level schedule.
          std::vector<float> tiny = {static_cast<float>(r + 1)};
          w.planes[r]->BeginCompressedOp(comp, nullptr);
          st = w.planes[r]->Allreduce(tiny.data(), 1, DataType::FLOAT32,
                                      ReduceOp::SUM);
          w.planes[r]->EndCompressedOp();
          if (!st.ok() ||
              std::fabs(tiny[0] - world * (world + 1) / 2.0f) > 0.5f) {
            ++bad;
          }
        });
      }
      for (auto& t : threads) t.join();
      for (int r = 0; r < world && bad == 0; ++r) {
        for (int64_t i = 0; i < n; ++i) {
          if (std::fabs(outs[r][i] - expect[i]) > tol) {
            ++bad;
            break;
          }
        }
        if (memcmp(outs[r].data(), outs[0].data(), n * 4) != 0) ++bad;
      }
      if (bad != 0) {
        std::fprintf(stderr,
                     "FAIL compressed hier allreduce world=%d comp=%s "
                     "(%d bad)\n",
                     world, WireCompressionName(comp), bad.load());
        ++failures;
      }
      for (auto& p : w.planes) p->Shutdown();
    }
  }
}

void TestReduceBufferOps() {
  float dst[4] = {1, 2, 3, 4};
  float src[4] = {4, 3, 2, 1};
  ReduceBuffer(dst, src, 4, DataType::FLOAT32, ReduceOp::SUM);
  CHECK_TRUE(dst[0] == 5 && dst[3] == 5);
  float dmin[2] = {1, 9};
  float smin[2] = {3, 2};
  ReduceBuffer(dmin, smin, 2, DataType::FLOAT32, ReduceOp::MIN);
  CHECK_TRUE(dmin[0] == 1 && dmin[1] == 2);
  int64_t dprod[2] = {2, -3};
  int64_t sprod[2] = {5, 7};
  ReduceBuffer(dprod, sprod, 2, DataType::INT64, ReduceOp::PRODUCT);
  CHECK_TRUE(dprod[0] == 10 && dprod[1] == -21);
  // bf16 accumulates through float (reference: half.cc custom MPI sum).
  uint16_t dbf[2] = {FloatToBf16Public(1.5f), FloatToBf16Public(-2.0f)};
  uint16_t sbf[2] = {FloatToBf16Public(0.5f), FloatToBf16Public(1.0f)};
  ReduceBuffer(dbf, sbf, 2, DataType::BFLOAT16, ReduceOp::SUM);
  CHECK_TRUE(std::fabs(Bf16ToFloatPublic(dbf[0]) - 2.0f) < 0.05f);
  CHECK_TRUE(std::fabs(Bf16ToFloatPublic(dbf[1]) - (-1.0f)) < 0.05f);
}

void TestGaussianProcessInterpolates() {
  GaussianProcess gp(/*noise=*/1e-6);
  std::vector<std::vector<double>> x = {{0.0}, {0.5}, {1.0}};
  std::vector<double> y = {1.0, 3.0, 2.0};
  gp.Fit(x, y);
  double mu, sigma;
  for (size_t i = 0; i < x.size(); ++i) {
    gp.Predict(x[i], &mu, &sigma);
    CHECK_TRUE(std::fabs(mu - y[i]) < 0.05);   // near-interpolation
    CHECK_TRUE(sigma < 0.2);                   // confident at data points
  }
  gp.Predict({0.25}, &mu, &sigma);
  CHECK_TRUE(mu > 1.0 && mu < 3.2);            // between neighbors
}

void TestBayesianOptimizerPicksBestSample() {
  BayesianOptimizer opt(/*dim=*/2, /*noise=*/1e-4);
  opt.AddSample({0.1, 0.1}, 1.0);
  opt.AddSample({0.9, 0.2}, 5.0);
  opt.AddSample({0.4, 0.8}, 3.0);
  std::vector<double> best = opt.BestSample();
  CHECK_TRUE(best[0] == 0.9 && best[1] == 0.2);
  std::vector<double> next = opt.NextSample();
  CHECK_TRUE(next.size() == 2);
  for (double v : next) CHECK_TRUE(v >= 0.0 && v <= 1.0);
}

void TestParameterManagerFreezesAtBest() {
  ParameterManager pm;
  pm.Initialize(/*cycle=*/1.0, /*fusion=*/64 << 20, /*cache=*/true,
                /*algo_crossover=*/256 << 10, /*tune_crossover=*/true,
                /*sa_enabled=*/true, /*tune_sa=*/true,
                /*hier_enabled=*/false, /*tune_hier=*/true,
                /*wire_compression=*/0, /*tune_compression=*/true,
                /*log=*/"", /*warmup=*/1, /*cycles_per_sample=*/1,
                /*max_samples=*/4, /*gp_noise=*/0.1);
  CHECK_TRUE(pm.active());
  double t = 0.0;
  // Drive synthetic traffic until tuning freezes (warmup 1 sample +
  // 4 scored samples x 3 median scores each).
  bool changed_at_least_once = false;
  for (int i = 0; i < 64; ++i) {
    t += 0.01;
    changed_at_least_once |= pm.Update(/*bytes=*/1 << 20, t);
  }
  CHECK_TRUE(changed_at_least_once);
  ParameterManager::Params p = pm.Current();
  CHECK_TRUE(p.cycle_time_ms >= 0.5 && p.cycle_time_ms <= 50.0);
  CHECK_TRUE(p.fusion_threshold >= (1 << 20));
  CHECK_TRUE(p.algo_crossover >= (4 << 10) && p.algo_crossover <= (4 << 20));
  // The compression categorical stays inside the automatic menu
  // {none, fp16, int8} — int4 is never auto-selected.
  CHECK_TRUE(p.wire_compression >= 0 && p.wire_compression <= 2);

  // Pinned algorithm (tune_crossover=false), pinned hier (tune_hier=false)
  // and pinned compression (tune_compression=false): the excluded
  // coordinates are held at their initial values.
  ParameterManager pinned;
  pinned.Initialize(/*cycle=*/1.0, /*fusion=*/64 << 20, /*cache=*/true,
                    /*algo_crossover=*/123456, /*tune_crossover=*/false,
                    /*sa_enabled=*/false, /*tune_sa=*/false,
                    /*hier_enabled=*/true, /*tune_hier=*/false,
                    /*wire_compression=*/3, /*tune_compression=*/false,
                    /*log=*/"", /*warmup=*/1, /*cycles_per_sample=*/1,
                    /*max_samples=*/4, /*gp_noise=*/0.1);
  t = 0.0;
  for (int i = 0; i < 64; ++i) {
    t += 0.01;
    pinned.Update(/*bytes=*/1 << 20, t);
  }
  CHECK_TRUE(pinned.Current().algo_crossover == 123456);
  CHECK_TRUE(pinned.Current().hier_enabled);
  CHECK_TRUE(pinned.Current().wire_compression == 3);
}

// --- metrics registry (metrics.{h,cpp}) ------------------------------------

void TestMetricsConcurrentIncrements() {
  // 8 threads hammering one counter, one gauge, and one histogram through
  // freshly-resolved handles: no increment may be lost (counter/histogram
  // count are atomic adds) and the dump must reflect the exact totals.
  Metrics m;
  constexpr int kThreads = 8;
  constexpr int kIters = 20000;
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t) {
    ts.emplace_back([&m, t] {
      Counter* c = m.GetCounter("test_ops_total", "ops");
      Histogram* h = m.GetHistogram("test_lat_seconds", "lat", {0.5, 2.0});
      Gauge* g = m.GetGauge("test_depth", "depth");
      for (int i = 0; i < kIters; ++i) {
        c->Inc();
        h->Observe(i % 2 == 0 ? 0.25 : 1.0);
        g->Set(t);
      }
    });
  }
  for (auto& t : ts) t.join();
  CHECK_TRUE(m.GetCounter("test_ops_total", "ops")->Get() ==
             kThreads * kIters);
  Histogram* h = m.GetHistogram("test_lat_seconds", "lat", {0.5, 2.0});
  CHECK_TRUE(h->Count() == kThreads * kIters);
  CHECK_TRUE(h->BucketCount(0) == kThreads * kIters / 2);  // 0.25 <= 0.5
  CHECK_TRUE(h->BucketCount(1) == kThreads * kIters / 2);  // 0.5 < 1.0 <= 2
  CHECK_TRUE(h->BucketCount(2) == 0);                      // +Inf bucket
  // Sum is CAS-accumulated: exact (all observed values are binary fractions).
  CHECK_TRUE(h->Sum() == kThreads * kIters * (0.25 + 1.0) / 2);
  double depth = m.GetGauge("test_depth", "depth")->Get();
  CHECK_TRUE(depth >= 0 && depth < kThreads);  // some thread's last Set
}

void TestMetricsHistogramBucketBoundaries() {
  // Prometheus contract: `le` is INCLUSIVE — a value exactly on a bound
  // lands in that bucket; the first value past the last bound goes to +Inf.
  Metrics m;
  Histogram* h =
      m.GetHistogram("test_bytes", "bytes", {10.0, 100.0, 1000.0});
  h->Observe(10.0);    // bucket 0 (le=10)
  h->Observe(10.5);    // bucket 1
  h->Observe(100.0);   // bucket 1 (le=100)
  h->Observe(1000.0);  // bucket 2
  h->Observe(1000.5);  // +Inf
  CHECK_TRUE(h->BucketCount(0) == 1);
  CHECK_TRUE(h->BucketCount(1) == 2);
  CHECK_TRUE(h->BucketCount(2) == 1);
  CHECK_TRUE(h->BucketCount(3) == 1);
  CHECK_TRUE(h->Count() == 5);

  std::string dump = m.Dump();
  // Cumulative rendering: le="100" must count buckets 0+1 = 3.
  CHECK_TRUE(dump.find("test_bytes_bucket{le=\"100\"} 3") !=
             std::string::npos);
  CHECK_TRUE(dump.find("test_bytes_bucket{le=\"+Inf\"} 5") !=
             std::string::npos);
  CHECK_TRUE(dump.find("test_bytes_count 5") != std::string::npos);
}

void TestMetricsDumpDeterminism() {
  // Identical contents registered in different orders must render to the
  // SAME text (families sorted by name, series by label string) — the
  // aggregator and tests diff dumps across ranks.
  auto build = [](bool reversed) {
    auto m = std::make_unique<Metrics>();
    auto add = [&](int which) {
      if (which == 0) {
        m->GetCounter("zz_total", "z", {{"op", "A"}})->Add(3);
      } else if (which == 1) {
        m->GetCounter("zz_total", "z", {{"op", "B"}})->Add(4);
      } else {
        m->GetGauge("aa_depth", "a")->Set(7);
      }
    };
    if (reversed) { add(2); add(1); add(0); }
    else { add(0); add(1); add(2); }
    return m;
  };
  std::string d1 = build(false)->Dump();
  std::string d2 = build(true)->Dump();
  CHECK_TRUE(d1 == d2);
  // aa_depth sorts before zz_total; labeled series sort by label string.
  CHECK_TRUE(d1.find("aa_depth") < d1.find("zz_total"));
  CHECK_TRUE(d1.find("zz_total{op=\"A\"} 3") < d1.find("zz_total{op=\"B\"} 4"));
  // Every non-comment line is `name{labels} value` — well-formed exposition.
  CHECK_TRUE(d1.find("# TYPE aa_depth gauge") != std::string::npos);
  CHECK_TRUE(d1.find("# TYPE zz_total counter") != std::string::npos);
}

void TestMetricsLabelEscaping() {
  Metrics m;
  m.GetCounter("esc_total", "esc", {{"name", "a\"b\\c\nd"}})->Inc();
  std::string dump = m.Dump();
  CHECK_TRUE(dump.find("esc_total{name=\"a\\\"b\\\\c\\nd\"} 1") !=
             std::string::npos);
}

void TestDataPlaneWireCountersInRegistry() {
  // The DataPlane's cumulative byte accounting must live in the injected
  // registry (single source of truth for hvdtpu_wire_stats AND /metrics).
  Metrics m;
  DataPlane plane(0, 1);
  plane.set_metrics(&m);
  CHECK_TRUE(plane.total_raw_bytes() == 0);
  Counter* raw = m.GetCounter("hvdtpu_allreduce_raw_bytes_total", "");
  raw->Add(123);
  CHECK_TRUE(plane.total_raw_bytes() == 123);
  CHECK_TRUE(m.Dump().find("hvdtpu_allreduce_raw_bytes_total 123") !=
             std::string::npos);
}

void TestClockOffsetEstimator() {
  // Min-RTT sample wins: the second sample (RTT 10) beats the first
  // (RTT 100); offset = t2 - midpoint(t1, t3).
  std::vector<ClockSample> samples = {
      {1000, 2000, 1100},   // rtt 100: offset 2000 - 1050 = 950, err 51
      {2000, 2505, 2010},   // rtt 10:  offset 2505 - 2005 = 500, err 6
  };
  ClockEstimate est = EstimateClockOffset(samples);
  CHECK_TRUE(est.valid);
  CHECK_TRUE(est.offset_us == 500);
  CHECK_TRUE(est.err_us == 6);
  // Bogus samples (clock went backwards) are skipped; none usable ->
  // invalid.
  ClockEstimate bad = EstimateClockOffset({{100, 0, 50}});
  CHECK_TRUE(!bad.valid);
  CHECK_TRUE(!EstimateClockOffset({}).valid);
}

void TestTraceSamplerGating() {
  TraceSampler s;
  CHECK_TRUE(!s.enabled());
  CHECK_TRUE(!s.SampleOp());  // disabled: never samples
  s.set_every_n(3);
  CHECK_TRUE(s.enabled());
  int sampled = 0;
  bool first = s.SampleOp();
  CHECK_TRUE(first);  // the first op is always sampled when enabled
  sampled += first ? 1 : 0;
  for (int i = 0; i < 8; ++i) sampled += s.SampleOp() ? 1 : 0;
  CHECK_TRUE(sampled == 3);  // ops 0, 3, 6 of the 9 rolled
  TraceSampler every;
  every.set_every_n(1);
  for (int i = 0; i < 4; ++i) CHECK_TRUE(every.SampleOp());
}

void TestTimelineSpanAndMetadata() {
  char path[] = "/tmp/hvdtpu_tl_span_XXXXXX";
  int fd = mkstemp(path);
  CHECK_TRUE(fd >= 0);
  close(fd);
  {
    Timeline tl;
    tl.Initialize(path, /*rank=*/3);
    const int64_t t0 = Timeline::SteadyAbsUs();
    tl.Span("hops", "SENDRECV", t0, t0 + 250,
            "{\"bytes\": 42, \"wait_us\": 7}");
    // A span predating the timeline origin clamps to ts 0, never negative.
    tl.Span("hops", "EARLY", t0 - 10'000'000, t0 - 9'999'000, "");
    tl.Metadata("{\"clock_offset_us\": -12, \"clock_err_us\": 5}");
    tl.Shutdown();
  }
  FILE* f = fopen(path, "r");
  CHECK_TRUE(f != nullptr);
  std::string text;
  char buf[512];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) text.append(buf, n);
  fclose(f);
  unlink(path);
  CHECK_TRUE(text.find("\"ph\": \"X\"") != std::string::npos);
  CHECK_TRUE(text.find("\"dur\": 250") != std::string::npos);
  CHECK_TRUE(text.find("\"pid\": \"hops\"") != std::string::npos);
  CHECK_TRUE(text.find("\"tid\": 3") != std::string::npos);
  CHECK_TRUE(text.find("\"wait_us\": 7") != std::string::npos);
  CHECK_TRUE(text.find("trace_meta") != std::string::npos);
  CHECK_TRUE(text.find("\"clock_offset_us\": -12") != std::string::npos);
  CHECK_TRUE(text.find("\"ts\": -") == std::string::npos);  // no negatives
  // The clamp shrinks the DURATION too: a fully pre-origin span must not
  // spill past its true end (here: entirely before the origin -> dur 0).
  CHECK_TRUE(text.find("\"name\": \"EARLY\", \"ph\": \"X\", \"ts\": 0, "
                       "\"dur\": 0") != std::string::npos);
  // The file as a whole must still be a JSON array (same writer contract
  // as the op events).
  CHECK_TRUE(!text.empty() && text[0] == '[');
  CHECK_TRUE(text.find(']') != std::string::npos);
}

// Minimal decoder over the flight-recorder dump image (the production
// decoder is horovod_tpu/flightrec.py; this one pins the binary layout at
// the C++ boundary so a silent repack breaks HERE, not in a post-mortem).
struct FlightImage {
  int32_t rank = 0, world = 0, reason = -1, detail = 0;
  int64_t clock_offset = 0, clock_err = 0, write_count = 0;
  uint32_t capacity = 0, record_bytes = 0;
  std::vector<std::string> names;
  std::vector<FlightRecord> recs;
};

template <typename T>
T GetAt(const std::string& img, size_t off) {
  T v;
  std::memcpy(&v, img.data() + off, sizeof(T));
  return v;
}

FlightImage DecodeFlightImage(const std::string& img) {
  FlightImage out;
  CHECK_TRUE(img.size() >= kFlightHeaderBytes);
  CHECK_TRUE(std::memcmp(img.data(), kFlightMagic, 8) == 0);
  CHECK_TRUE(GetAt<uint32_t>(img, 8) == 1);   // version
  CHECK_TRUE(GetAt<uint32_t>(img, 12) == kFlightHeaderBytes);
  out.rank = GetAt<int32_t>(img, 16);
  out.world = GetAt<int32_t>(img, 20);
  out.clock_offset = GetAt<int64_t>(img, 24);
  out.clock_err = GetAt<int64_t>(img, 32);
  out.write_count = GetAt<int64_t>(img, 56);
  out.capacity = GetAt<uint32_t>(img, 64);
  out.record_bytes = GetAt<uint32_t>(img, 68);
  const uint32_t names = GetAt<uint32_t>(img, 72);
  const uint32_t name_bytes = GetAt<uint32_t>(img, 76);
  out.reason = GetAt<int32_t>(img, 80);
  out.detail = GetAt<int32_t>(img, 84);
  size_t off = kFlightHeaderBytes;
  for (uint32_t i = 0; i < names; ++i) {
    out.names.emplace_back(img.data() + off);  // NUL-terminated slot
    off += name_bytes;
  }
  while (off + out.record_bytes <= img.size()) {
    FlightRecord r;
    r.t_end_us = GetAt<int64_t>(img, off);
    const uint64_t w1 = GetAt<uint64_t>(img, off + 8);
    r.dur_us = static_cast<uint32_t>(w1 & 0xffffffffu);
    r.type = static_cast<FlightEvent>(
        static_cast<int32_t>((w1 >> 32) & 0xffff));
    r.lane = static_cast<uint16_t>(w1 >> 48);
    r.bytes = GetAt<int64_t>(img, off + 16);
    const uint64_t w3 = GetAt<uint64_t>(img, off + 24);
    r.name_id = static_cast<int32_t>(w3 & 0xffffffffu);
    r.arg = static_cast<int32_t>(w3 >> 32);
    const uint64_t w4 = GetAt<uint64_t>(img, off + 32);
    r.send_peer = static_cast<int32_t>(w4 & 0xffffffffu);
    r.recv_peer = static_cast<int32_t>(w4 >> 32);
    out.recs.push_back(r);
    off += out.record_bytes;
  }
  return out;
}

void TestFlightRecorderSnapshotRoundtrip() {
  FlightRecorder fr;
  fr.Configure(64, "", /*rank=*/2, /*world=*/4);
  fr.SetClock(1234, 56);
  const int nid = fr.InternName("layer0/kernel");
  CHECK_TRUE(nid == 1);  // slot 0 is the overflow name
  CHECK_TRUE(fr.InternName("layer0/kernel") == nid);
  fr.Record(FlightEvent::OP_BEGIN, nid, 4096, -1, -1, 1000, 1000, 0, 0);
  fr.Record(FlightEvent::SENDRECV, -1, 8192, 1, 3, 1100, 1400, 250, 2);
  fr.Record(FlightEvent::OP_END, nid, 4096, -1, -1, 1000, 1500, 0, 0);
  FlightImage img = DecodeFlightImage(
      fr.Snapshot(DumpReason::ON_DEMAND, -1));
  CHECK_TRUE(img.rank == 2 && img.world == 4);
  CHECK_TRUE(img.clock_offset == 1234 && img.clock_err == 56);
  CHECK_TRUE(img.reason == static_cast<int32_t>(DumpReason::ON_DEMAND));
  CHECK_TRUE(img.write_count == 3);
  CHECK_TRUE(img.recs.size() == 3);
  CHECK_TRUE(img.names.size() == 2 && img.names[1] == "layer0/kernel");
  CHECK_TRUE(img.recs[0].type == FlightEvent::OP_BEGIN);
  CHECK_TRUE(img.recs[0].name_id == nid);
  const FlightRecord& hop = img.recs[1];
  CHECK_TRUE(hop.type == FlightEvent::SENDRECV);
  CHECK_TRUE(hop.send_peer == 1 && hop.recv_peer == 3);
  CHECK_TRUE(hop.bytes == 8192 && hop.dur_us == 300 && hop.arg == 250);
  CHECK_TRUE(hop.lane == 2 && hop.name_id == -1);
  CHECK_TRUE(img.recs[2].t_end_us == 1500 && img.recs[2].dur_us == 500);
}

void TestFlightRecorderWraparoundOldestFirst() {
  FlightRecorder fr;
  fr.Configure(64, "", 0, 1);
  for (int i = 0; i < 150; ++i) {
    fr.Record(FlightEvent::SEND, -1, i, -1, -1, i, i, 0, 1);
  }
  FlightImage img = DecodeFlightImage(
      fr.Snapshot(DumpReason::ON_DEMAND, -1));
  CHECK_TRUE(img.write_count == 150);
  CHECK_TRUE(img.recs.size() == 64);
  // Oldest kept record is #86 (150 - 64), newest #149, strictly in order.
  CHECK_TRUE(img.recs.front().bytes == 86);
  CHECK_TRUE(img.recs.back().bytes == 149);
  for (size_t i = 1; i < img.recs.size(); ++i) {
    CHECK_TRUE(img.recs[i].bytes == img.recs[i - 1].bytes + 1);
  }
}

void TestFlightRecorderNameOverflowSharesSlotZero() {
  FlightRecorder fr;
  fr.Configure(64, "", 0, 1);
  int last = 0;
  for (int i = 0; i < kFlightMaxNames + 10; ++i) {
    last = fr.InternName("t" + std::to_string(i));
  }
  CHECK_TRUE(last == 0);  // overflowed names share the reserved slot
  FlightImage img = DecodeFlightImage(
      fr.Snapshot(DumpReason::ON_DEMAND, -1));
  CHECK_TRUE(img.names.size() == kFlightMaxNames);
  CHECK_TRUE(img.names[0] == "<names-overflowed>");
  CHECK_TRUE(img.names[1] == "t0");
}

void TestFlightRecorderConcurrentWriters() {
  // The ring is claimed by fetch_add and written with relaxed word stores:
  // hammer it from several threads (TSan build included in check-tsan)
  // while a reader snapshots mid-flight.
  FlightRecorder fr;
  fr.Configure(256, "", 0, 1);
  std::atomic<bool> stop{false};
  std::thread reader([&] {
    while (!stop.load()) {
      std::string img = fr.Snapshot(DumpReason::ON_DEMAND, -1);
      CHECK_TRUE(img.size() >= kFlightHeaderBytes);
    }
  });
  std::vector<std::thread> writers;
  for (int t = 0; t < 4; ++t) {
    writers.emplace_back([&fr, t] {
      for (int i = 0; i < 5000; ++i) {
        fr.Record(FlightEvent::SEND, -1, i, t, -1, i, i + 1, 0, 1);
      }
    });
  }
  for (auto& w : writers) w.join();
  stop.store(true);
  reader.join();
  CHECK_TRUE(fr.record_count() == 4 * 5000);
  FlightImage img = DecodeFlightImage(
      fr.Snapshot(DumpReason::ON_DEMAND, -1));
  CHECK_TRUE(img.recs.size() == 256);
  for (const FlightRecord& r : img.recs) {
    CHECK_TRUE(r.type == FlightEvent::SEND && r.dur_us == 1);
  }
}

void TestFlightRecorderDumpLatchAndOnDemand() {
  char tmpl[] = "/tmp/hvdtpu_frec_XXXXXX";
  char* dir = mkdtemp(tmpl);
  CHECK_TRUE(dir != nullptr);
  FlightRecorder fr;
  fr.Configure(64, dir, /*rank=*/1, /*world=*/2);
  fr.Record(FlightEvent::OP_BEGIN, -1, 1, -1, -1, 1, 1, 0, 0);
  // First fatal dump writes; the second is latched out (the original
  // failure's forensics must survive a later cascade).
  CHECK_TRUE(fr.DumpToFile(DumpReason::ABORT, 3, "", true));
  CHECK_TRUE(!fr.DumpToFile(DumpReason::STALL, -1, "", true));
  const std::string path = std::string(dir) + "/flightrec.1.bin";
  CHECK_TRUE(fr.dump_path() == path);
  FILE* f = std::fopen(path.c_str(), "rb");
  CHECK_TRUE(f != nullptr);
  std::string img;
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) img.append(buf, n);
  std::fclose(f);
  FlightImage dec = DecodeFlightImage(img);
  CHECK_TRUE(dec.reason == static_cast<int32_t>(DumpReason::ABORT));
  CHECK_TRUE(dec.detail == 3);
  // On-demand dumps bypass the latch.
  const std::string alt = std::string(dir) + "/ondemand.bin";
  CHECK_TRUE(fr.DumpToFile(DumpReason::ON_DEMAND, -1, alt, false));
  std::remove(path.c_str());
  std::remove(alt.c_str());
  std::remove(dir);
}

void TestFlightRecorderSigtermDoesNotBurnLatch() {
  // A SIGTERM dump (watchdog/launcher cleanup — classified as "not the
  // cause" by the post-mortem) must leave the fatal latch armed so a
  // LATER genuine fatal can still record the real story; the reverse
  // order (fatal first) stays protected.
  char tmpl[] = "/tmp/hvdtpu_frst_XXXXXX";
  char* dir = mkdtemp(tmpl);
  CHECK_TRUE(dir != nullptr);
  FlightRecorder fr;
  fr.Configure(64, dir, 0, 1);
  fr.Record(FlightEvent::OP_BEGIN, -1, 1, -1, -1, 1, 1, 0, 0);
  fr.SignalDump(SIGTERM);
  // The abort cascade after the SIGTERM still gets its dump...
  CHECK_TRUE(fr.DumpToFile(DumpReason::ABORT, 2, "", true));
  // ...and now the latch holds: a later SIGTERM cannot overwrite it.
  const std::string path = fr.dump_path();
  FILE* f = std::fopen(path.c_str(), "rb");
  CHECK_TRUE(f != nullptr);
  std::string img;
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) img.append(buf, n);
  std::fclose(f);
  CHECK_TRUE(DecodeFlightImage(img).reason ==
             static_cast<int32_t>(DumpReason::ABORT));
  CHECK_TRUE(!fr.DumpToFile(DumpReason::STALL, -1, "", true));
  std::remove(path.c_str());
  std::remove(dir);
}

void TestFlightLaneCodes() {
  CHECK_TRUE(FlightLaneCode("tcp") == 1);
  CHECK_TRUE(FlightLaneCode("shm") == 2);
  CHECK_TRUE(FlightLaneCode("tcp-zc") == 3);
  CHECK_TRUE(FlightLaneCode("local") == 0);
  CHECK_TRUE(FlightLaneCode(nullptr) == 0);
}

void TestDataPlaneRecordsFlightHops() {
  // A threaded 2-rank in-process world with the recorder attached: every
  // hop of an UNSAMPLED op (no tracer at all) must land in the ring.
  FlightRecorder fr0, fr1;
  fr0.Configure(1024, "", 0, 2);
  fr1.Configure(1024, "", 1, 2);
  DataPlane a(0, 2), b(1, 2);
  a.set_flightrec(&fr0);
  b.set_flightrec(&fr1);
  CHECK_TRUE(a.Listen().ok());
  CHECK_TRUE(b.Listen().ok());
  std::vector<PeerAddr> peers = {{"127.0.0.1", a.port()},
                                 {"127.0.0.1", b.port()}};
  Status sa, sb;
  std::thread tb([&] { sb = b.Connect(peers); });
  sa = a.Connect(peers);
  tb.join();
  CHECK_TRUE(sa.ok() && sb.ok());
  std::vector<float> va(1024, 1.0f), vb(1024, 2.0f);
  std::thread tr([&] {
    sb = b.Allreduce(vb.data(), 1024, DataType::FLOAT32, ReduceOp::SUM);
  });
  sa = a.Allreduce(va.data(), 1024, DataType::FLOAT32, ReduceOp::SUM);
  tr.join();
  CHECK_TRUE(sa.ok() && sb.ok());
  CHECK_TRUE(va[0] == 3.0f && vb[0] == 3.0f);
  FlightImage img = DecodeFlightImage(
      fr0.Snapshot(DumpReason::ON_DEMAND, -1));
  bool saw_hop = false, saw_reduce = false;
  for (const FlightRecord& r : img.recs) {
    if (r.type == FlightEvent::SENDRECV || r.type == FlightEvent::SEND ||
        r.type == FlightEvent::RECV) {
      saw_hop = true;
      CHECK_TRUE(r.send_peer == 1 || r.recv_peer == 1);
      CHECK_TRUE(r.bytes > 0);
    }
    if (r.type == FlightEvent::REDUCE) saw_reduce = true;
  }
  CHECK_TRUE(saw_hop);
  (void)saw_reduce;  // algo-dependent (RD at this size): hops are the pin
  a.Shutdown();
  b.Shutdown();
}

void TestIoControlWaitAccounting() {
  // A controlled recv with no data must accrue peer-wait time; completing
  // the transfer stops the clock.
  int sv[2];
  CHECK_TRUE(socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  IoControl ctl;
  ctl.detect_slice_ms = 5;
  std::thread sender([&] {
    std::this_thread::sleep_for(std::chrono::milliseconds(30));
    const char b[4] = {1, 2, 3, 4};
    CHECK_TRUE(SendAll(sv[1], b, sizeof(b), nullptr) == 0);
  });
  char out[4];
  CHECK_TRUE(RecvAll(sv[0], out, sizeof(out), &ctl) == 0);
  sender.join();
  // ~30 ms blocked: the accounting must see most of it (scheduler slack
  // allowed) and not wildly more.
  CHECK_TRUE(ctl.WaitUs() >= 10'000);
  CHECK_TRUE(ctl.WaitUs() < 5'000'000);
  close(sv[0]);
  close(sv[1]);
}

void TestP2QuantileTracksSortedQuantiles() {
  // Deterministic LCG stream; the P² estimates must land near the exact
  // sorted quantiles (P² error on smooth distributions is a few percent).
  uint64_t seed = 42;
  auto next = [&seed]() {
    seed = seed * 6364136223846793005ULL + 1442695040888963407ULL;
    return static_cast<double>((seed >> 33) % 100000);
  };
  P2Quantile p50, p99;
  p50.Init(0.5);
  p99.Init(0.99);
  std::vector<double> all;
  for (int i = 0; i < 20000; ++i) {
    const double x = next();
    all.push_back(x);
    p50.Observe(x);
    p99.Observe(x);
  }
  std::sort(all.begin(), all.end());
  const double exact50 = all[all.size() / 2];
  const double exact99 = all[static_cast<size_t>(all.size() * 0.99)];
  CHECK_TRUE(std::abs(p50.Value() - exact50) < 0.05 * exact50 + 1);
  CHECK_TRUE(std::abs(p99.Value() - exact99) < 0.05 * exact99 + 1);
  // Tiny streams are exact (sorted initial buffer).
  P2Quantile small;
  small.Init(0.5);
  small.Observe(30);
  small.Observe(10);
  small.Observe(20);
  CHECK_TRUE(small.Value() == 20);
}

void TestPerfStatsBaselineAndSentry() {
  PerfStats ps;
  ps.Configure(true, 50.0, 5);
  const int slot = ps.KeySlot("grad/0|ring|shm|0|none");
  CHECK_TRUE(slot >= 1);
  CHECK_TRUE(ps.KeySlot("grad/0|ring|shm|0|none") == slot);  // stable
  PerfStats::OpSample s;
  s.wall_us = 1000;
  s.wait_us = 100;
  s.wire_us = 700;
  s.reduce_us = 150;
  s.codec_us = 0;
  for (int i = 0; i < 10; ++i) {
    PerfStats::Anomaly a = ps.RecordOp(slot, s);
    CHECK_TRUE(!a.fired);  // steady state never trips the sentry
  }
  // 10% slower: inside the 50% threshold.
  PerfStats::OpSample mild = s;
  mild.wall_us = 1100;
  CHECK_TRUE(!ps.RecordOp(slot, mild).fired);
  // 3x slower, excess in the wire bucket, slow peer named.
  PerfStats::OpSample slow = s;
  slow.wall_us = 3000;
  slow.wire_us = 2700;
  slow.slow_peer = 3;
  PerfStats::Anomaly a = ps.RecordOp(slot, slow);
  CHECK_TRUE(a.fired);
  CHECK_TRUE(a.phase == PerfPhase::WIRE);
  CHECK_TRUE(a.slow_peer == 3);
  CHECK_TRUE(a.ratio > 2.0);
  CHECK_TRUE(ps.anomalies_total() == 1);
  const PerfSlot* sl = ps.slot(slot);
  CHECK_TRUE(sl != nullptr &&
             sl->anomalies.load(std::memory_order_relaxed) == 1);
  // A reduce-bound slowdown attributes REDUCE, not WIRE.
  PerfStats::OpSample rslow = s;
  rslow.wall_us = 3000;
  rslow.reduce_us = 2200;
  PerfStats::Anomaly ra = ps.RecordOp(slot, rslow);
  CHECK_TRUE(ra.fired && ra.phase == PerfPhase::REDUCE);
  CHECK_TRUE(ra.slow_peer == -1);  // only wait/wire name a peer
  // Warmup gate: a fresh key never fires before min_samples.
  const int fresh = ps.KeySlot("other|ring|shm|0|none");
  PerfStats::OpSample burst = s;
  burst.wall_us = 100;
  ps.RecordOp(fresh, burst);
  burst.wall_us = 100000;
  CHECK_TRUE(!ps.RecordOp(fresh, burst).fired);
}

void TestPerfStatsKeyOverflowSharesSlotZero() {
  PerfStats ps;
  ps.Configure(true, 50.0, 5);
  for (int i = 0; i < kPerfMaxKeys + 16; ++i) {
    const int slot = ps.KeySlot("key" + std::to_string(i));
    if (i < kPerfMaxKeys - 1) {
      CHECK_TRUE(slot == i + 1);
    } else {
      CHECK_TRUE(slot == 0);  // table full: the shared overflow slot
    }
  }
  CHECK_TRUE(ps.slot_count() == kPerfMaxKeys);
  // The overflow slot streams stats but never sentries: its baseline
  // mixes every overflowed key, so a small op judged against big-op
  // history would fire forever.
  PerfStats::OpSample warm;
  warm.wall_us = 100;
  for (int i = 0; i < 8; ++i) CHECK_TRUE(!ps.RecordOp(0, warm).fired);
  PerfStats::OpSample spike;
  spike.wall_us = 100000;  // 1000x the slot-0 baseline
  CHECK_TRUE(!ps.RecordOp(0, spike).fired);
  CHECK_TRUE(ps.slot(0)->count.load(std::memory_order_relaxed) == 9);
  // Disabled stats hand every key slot 0 and never fire.
  PerfStats off;
  off.Configure(false, 50.0, 5);
  CHECK_TRUE(off.KeySlot("anything") == 0);
  PerfStats::OpSample s;
  s.wall_us = 100;
  CHECK_TRUE(!off.RecordOp(0, s).fired);
  CHECK_TRUE(off.SnapshotJson().find("\"enabled\": false") !=
             std::string::npos);
}

void TestPerfStatsConcurrentWritersAndReader() {
  // The production contract is single-writer, but the hot path must stay
  // correct (and TSan-clean) under explicitly concurrent writers plus a
  // mid-flight snapshot reader.
  PerfStats ps;
  ps.Configure(true, 1e12, 1);  // sentry effectively off: count integrity
  const int slot_a = ps.KeySlot("a");
  const int slot_b = ps.KeySlot("b");
  constexpr int kWriters = 4;
  constexpr int kPerWriter = 4000;
  std::atomic<bool> stop{false};
  std::thread reader([&] {
    while (!stop.load(std::memory_order_acquire)) {
      std::string json = ps.SnapshotJson();
      CHECK_TRUE(json.find("\"keys\"") != std::string::npos);
    }
  });
  std::vector<std::thread> writers;
  for (int w = 0; w < kWriters; ++w) {
    writers.emplace_back([&ps, slot_a, slot_b, w] {
      PerfStats::OpSample s;
      for (int i = 0; i < kPerWriter; ++i) {
        s.wall_us = 100 + (i % 7);
        s.wire_us = 50;
        s.wait_us = 25;
        ps.RecordOp(w % 2 == 0 ? slot_a : slot_b, s);
      }
    });
  }
  for (auto& t : writers) t.join();
  stop.store(true, std::memory_order_release);
  reader.join();
  const PerfSlot* a = ps.slot(slot_a);
  const PerfSlot* b = ps.slot(slot_b);
  CHECK_TRUE(a->count.load(std::memory_order_relaxed) ==
             kWriters / 2 * kPerWriter);
  CHECK_TRUE(b->count.load(std::memory_order_relaxed) ==
             kWriters / 2 * kPerWriter);
  const double ew = a->pub_ewma[0].load(std::memory_order_relaxed);
  CHECK_TRUE(ew >= 100 && ew <= 107);
}

void TestPerfStatsSnapshotJsonShape() {
  PerfStats ps;
  ps.Configure(true, 50.0, 20);
  const int slot = ps.KeySlot("grad\"quote\\slash|ring|tcp|0|int8");
  PerfStats::OpSample s;
  s.wall_us = 1234;
  s.wait_us = 100;
  s.wire_us = 1000;
  s.reduce_us = 100;
  s.codec_us = 34;
  ps.RecordOp(slot, s);
  const std::string json = ps.SnapshotJson();
  // Escaped key, all five phase buckets, count, and the sample ring.
  CHECK_TRUE(json.find("grad\\\"quote\\\\slash|ring|tcp|0|int8") !=
             std::string::npos);
  for (const char* phase : {"wall", "wait", "wire", "reduce", "codec"}) {
    CHECK_TRUE(json.find("\"" + std::string(phase) + "\": ") !=
               std::string::npos);
  }
  CHECK_TRUE(json.find("\"count\": 1") != std::string::npos);
  CHECK_TRUE(json.find("\"samples_us\": [1234]") != std::string::npos);
  CHECK_TRUE(json.find("\"p50_us\"") != std::string::npos);
  CHECK_TRUE(json.find("\"p99_us\"") != std::string::npos);
}

void TestDataPlanePerfPhaseAccumulation() {
  // A 2-rank in-process world with perf enabled and NO tracer/recorder:
  // the phase accumulators alone must light up for an unsampled op.
  DataPlane a(0, 2), b(1, 2);
  a.set_perf_enabled(true);
  b.set_perf_enabled(true);
  CHECK_TRUE(a.Listen().ok());
  CHECK_TRUE(b.Listen().ok());
  std::vector<PeerAddr> peers = {{"127.0.0.1", a.port()},
                                 {"127.0.0.1", b.port()}};
  Status sa, sb;
  std::thread tb([&] { sb = b.Connect(peers); });
  sa = a.Connect(peers);
  tb.join();
  CHECK_TRUE(sa.ok() && sb.ok());
  constexpr int64_t kCount = 1 << 18;  // 1 MB: big enough to see wire time
  std::vector<float> va(kCount, 1.0f), vb(kCount, 2.0f);
  std::thread tr([&] {
    sb = b.Allreduce(vb.data(), kCount, DataType::FLOAT32, ReduceOp::SUM);
  });
  sa = a.Allreduce(va.data(), kCount, DataType::FLOAT32, ReduceOp::SUM);
  tr.join();
  CHECK_TRUE(sa.ok() && sb.ok());
  CHECK_TRUE(va[0] == 3.0f);
  // Hop phases were accumulated (wait or wire — scheduling decides the
  // split) and the slow-peer tracker names the only peer when any wait
  // was seen at all.
  CHECK_TRUE(a.op_wait_us() + a.op_wire_us() > 0);
  CHECK_TRUE(a.op_wait_us() >= 0 && a.op_wire_us() >= 0);
  CHECK_TRUE(a.op_reduce_us() >= 0 && a.op_codec_us() >= 0);
  if (a.op_slow_peer() != -1) CHECK_TRUE(a.op_slow_peer() == 1);
  // An empty op early-returns before any hop runs — it must NOT inherit
  // the previous op's phase buckets (ObserveOp reads them regardless).
  CHECK_TRUE(a.Allreduce(va.data(), 0, DataType::FLOAT32,
                         ReduceOp::SUM).ok());
  CHECK_TRUE(a.op_wait_us() == 0 && a.op_wire_us() == 0);
  CHECK_TRUE(a.op_reduce_us() == 0 && a.op_codec_us() == 0);
  CHECK_TRUE(a.op_slow_peer() == -1);
  a.Shutdown();
  b.Shutdown();
}

void TestPerfStatsPerKeyWarnThrottle() {
  // The sentry's WARN throttle is per KEY, not a global
  // 1/s — a chatty slow key must not starve a second, different slow key's
  // first warning (two-key regression pin).
  PerfStats ps;
  ps.Configure(true, 50.0, 5);
  const int a = ps.KeySlot("chatty|ring|shm|0|none|ALLREDUCE");
  const int b = ps.KeySlot("quiet|ring|shm|0|none|ALLREDUCE");
  const int64_t t0 = 1000000;
  CHECK_TRUE(ps.ShouldWarn(a, t0));        // first anomaly of A logs
  CHECK_TRUE(!ps.ShouldWarn(a, t0 + 10));  // A throttled inside its window
  // The regression: B fires 10 us after A — under the old global throttle
  // this was silently swallowed for a second.
  CHECK_TRUE(ps.ShouldWarn(b, t0 + 10));
  CHECK_TRUE(!ps.ShouldWarn(b, t0 + 20));
  // Windows expire independently.
  CHECK_TRUE(ps.ShouldWarn(a, t0 + 1000000));
  CHECK_TRUE(!ps.ShouldWarn(b, t0 + 500000));
  CHECK_TRUE(ps.ShouldWarn(b, t0 + 10 + 1000000));
  // Out-of-range slots never warn (the disabled-stats slot-0 path is a
  // real slot and may warn; invalid ids must not touch memory).
  CHECK_TRUE(!ps.ShouldWarn(-1, t0));
  CHECK_TRUE(!ps.ShouldWarn(9999, t0));
  // Concurrent anomalies on ONE key inside one window: exactly one winner.
  const int c = ps.KeySlot("concurrent|ring|shm|0|none|ALLREDUCE");
  std::atomic<int> winners{0};
  std::vector<std::thread> threads;
  for (int i = 0; i < 4; ++i) {
    threads.emplace_back([&] {
      if (ps.ShouldWarn(c, 42000000)) winners.fetch_add(1);
    });
  }
  for (auto& t : threads) t.join();
  CHECK_TRUE(winners.load() == 1);
}

void TestProfilerPhaseScopePublishesAndRestores() {
  ProfThreadState* t = ProfThread();
  CHECK_TRUE(t->phase.load() == -1);
  CHECK_TRUE(t->op_id.load() == 0);
  {
    ProfOpScope op(7);
    CHECK_TRUE(t->op_id.load() == 7);
    CHECK_TRUE(t->phase.load() == static_cast<int32_t>(PerfPhase::WALL));
    {
      ProfPhaseScope wire(PerfPhase::WIRE);
      CHECK_TRUE(t->phase.load() == static_cast<int32_t>(PerfPhase::WIRE));
      {
        ProfPhaseScope wait(PerfPhase::WAIT);
        CHECK_TRUE(t->phase.load() ==
                   static_cast<int32_t>(PerfPhase::WAIT));
      }
      // Nested scope restored the outer phase, not the base.
      CHECK_TRUE(t->phase.load() == static_cast<int32_t>(PerfPhase::WIRE));
    }
    CHECK_TRUE(t->phase.load() == static_cast<int32_t>(PerfPhase::WALL));
  }
  CHECK_TRUE(t->phase.load() == -1);
  CHECK_TRUE(t->op_id.load() == 0);
}

void TestProfilerDisabledIsNoop() {
  SamplingProfiler p;
  p.Configure(false, 97, 1024, ProfClock::CPU, 0);
  p.RegisterThread();  // must not create a timer
  p.Start();
  CHECK_TRUE(!p.running());
  CHECK_TRUE(p.registered_threads() == 0);
  p.Stop();
  CHECK_TRUE(p.FoldedJson().find("\"enabled\": false") != std::string::npos);
  CHECK_TRUE(p.FoldedText().empty());
  CHECK_TRUE(p.InternOp("anything") == 0);
}

void TestProfilerSamplesTaggedByPhaseAndOp() {
  // A worker thread burns CPU inside ProfOpScope + REDUCE while a 250 Hz
  // CPU-clock window runs: samples must land, tagged with the published
  // phase and op, and fold into both the JSON and flamegraph outputs.
  SamplingProfiler p;
  p.Configure(true, 250, 4096, ProfClock::CPU, 3);
  const int op = p.InternOp("grad/layer0");
  CHECK_TRUE(op >= 1);
  CHECK_TRUE(p.InternOp("grad/layer0") == op);  // stable
  std::atomic<bool> stop{false};
  std::atomic<bool> ready{false};
  std::thread worker([&] {
    p.RegisterThread();
    ready.store(true);
    ProfOpScope op_scope(op);
    ProfPhaseScope reduce(PerfPhase::REDUCE);
    volatile double sink = 0;
    while (!stop.load(std::memory_order_relaxed)) {
      for (int i = 0; i < 1000; ++i) sink += i * 0.5;
    }
    p.UnregisterThread();
  });
  while (!ready.load()) std::this_thread::yield();
  p.Start();
  CHECK_TRUE(p.running());
  // CPU-clock timers need the worker to BURN ~n/hz seconds of CPU; a
  // loaded CI box may schedule it slowly, so wait on samples, not time.
  for (int i = 0; i < 400 && p.sample_count() < 5; ++i) {
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  p.Stop();
  CHECK_TRUE(!p.running());
  stop.store(true);
  worker.join();
  CHECK_TRUE(p.sample_count() >= 5);
  const std::string json = p.FoldedJson();
  CHECK_TRUE(json.find("\"enabled\": true") != std::string::npos);
  CHECK_TRUE(json.find("\"rank\": 3") != std::string::npos);
  CHECK_TRUE(json.find("\"clock\": \"cpu\"") != std::string::npos);
  CHECK_TRUE(json.find("\"reduce\"") != std::string::npos);
  CHECK_TRUE(json.find("grad/layer0") != std::string::npos);
  const std::string folded = p.FoldedText();
  CHECK_TRUE(folded.find("reduce;grad/layer0") != std::string::npos);
  // Every folded line is "stack count" with a positive count.
  size_t pos = 0;
  int lines = 0;
  while (pos < folded.size()) {
    const size_t eol = folded.find('\n', pos);
    CHECK_TRUE(eol != std::string::npos);
    const std::string line = folded.substr(pos, eol - pos);
    const size_t sp = line.rfind(' ');
    CHECK_TRUE(sp != std::string::npos && sp + 1 < line.size());
    CHECK_TRUE(std::atoll(line.c_str() + sp + 1) > 0);
    pos = eol + 1;
    ++lines;
  }
  CHECK_TRUE(lines > 0);
  // A new window clears the previous ring.
  p.Start();
  p.Stop();
  CHECK_TRUE(p.sample_count() == 0);
}

void TestProfilerWallClockSamplesBlockedThread() {
  // Wall-clock mode: a thread PARKED in a WAIT scope still accumulates
  // samples (the mode the chaos-delay acceptance test rides — blocked
  // time is exactly what it must see).
  SamplingProfiler p;
  p.Configure(true, 250, 4096, ProfClock::WALL, 0);
  std::atomic<bool> stop{false};
  std::atomic<bool> ready{false};
  std::thread worker([&] {
    p.RegisterThread();
    ready.store(true);
    ProfPhaseScope wait(PerfPhase::WAIT);
    while (!stop.load(std::memory_order_relaxed)) {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    p.UnregisterThread();
  });
  while (!ready.load()) std::this_thread::yield();
  p.Start();
  for (int i = 0; i < 400 && p.sample_count() < 5; ++i) {
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  p.Stop();
  stop.store(true);
  worker.join();
  CHECK_TRUE(p.sample_count() >= 5);
  CHECK_TRUE(p.FoldedJson().find("\"wait\"") != std::string::npos);
}

void TestProfilerSigprofStormDuringFlightDump() {
  // Signal coexistence: a SIGPROF storm hammering the
  // thread that is writing a flight-recorder fatal dump must corrupt
  // nothing — the dump stays decodable and the profiler keeps sampling.
  SamplingProfiler p;
  p.Configure(true, 500, 4096, ProfClock::WALL, 0);
  p.RegisterThread();
  p.Start();

  FlightRecorder rec;
  char dir[] = "/tmp/hvdtpu_prof_storm_XXXXXX";
  CHECK_TRUE(mkdtemp(dir) != nullptr);
  rec.Configure(512, dir, 1, 2);
  const int name = rec.InternName("storm/op");
  for (int i = 0; i < 600; ++i) {
    rec.Record(FlightEvent::SENDRECV, name, 1024, 0, 0, i * 10, i * 10 + 5,
               2, 2);
  }
  // Storm: a sibling thread fires SIGPROF at this thread far faster than
  // the timer would, while the async-signal-safe dump runs.
  std::atomic<bool> stop{false};
  pthread_t victim = pthread_self();
  std::thread stormer([&] {
    while (!stop.load(std::memory_order_relaxed)) {
      pthread_kill(victim, SIGPROF);
      std::this_thread::sleep_for(std::chrono::microseconds(50));
    }
  });
  for (int i = 0; i < 20; ++i) {
    rec.SignalDump(SIGTERM);  // SIGTERM re-arms the latch: every pass writes
  }
  const std::string img = rec.Snapshot(DumpReason::ON_DEMAND, -1);
  stop.store(true);
  stormer.join();
  // Dump still valid: magic + the records survive.
  CHECK_TRUE(img.size() > kFlightHeaderBytes);
  CHECK_TRUE(std::memcmp(img.data(), kFlightMagic, sizeof(kFlightMagic)) ==
             0);
  const std::string path =
      std::string(dir) + "/flightrec.1.bin";
  FILE* f = std::fopen(path.c_str(), "rb");
  CHECK_TRUE(f != nullptr);
  if (f != nullptr) {
    char magic[8] = {0};
    CHECK_TRUE(std::fread(magic, 1, 8, f) == 8);
    CHECK_TRUE(std::memcmp(magic, kFlightMagic, 8) == 0);
    std::fclose(f);
  }
  p.Stop();
  p.UnregisterThread();
  unlink(path.c_str());
  rmdir(dir);
  // The fatal-signal handlers mask SIGPROF while they run (the other half
  // of coexistence): pin the installed disposition's mask.
  InstallFlightSignalHandlers();
  struct sigaction current;
  CHECK_TRUE(sigaction(SIGSEGV, nullptr, &current) == 0);
  CHECK_TRUE(sigismember(&current.sa_mask, SIGPROF) == 1);
}

// --- numerical-health telemetry (gradstats.h; docs/numerics.md) -------------

void TestCrc32cKnownAnswers() {
  // RFC 3720 B.4 test vectors (Castagnoli polynomial).
  const uint8_t zeros[32] = {0};
  CHECK_TRUE(Crc32c(zeros, 32) == 0x8a9136aau);
  uint8_t ones[32];
  memset(ones, 0xff, sizeof(ones));
  CHECK_TRUE(Crc32c(ones, 32) == 0x62a8ab43u);
  uint8_t inc[32];
  for (int i = 0; i < 32; ++i) inc[i] = static_cast<uint8_t>(i);
  CHECK_TRUE(Crc32c(inc, 32) == 0x46dd794eu);
  // "123456789" is the classic check value for CRC-32C: 0xe3069283.
  CHECK_TRUE(Crc32c("123456789", 9) == 0xe3069283u);
  // One flipped byte MUST change the fingerprint (the divergence probe's
  // whole premise, and exactly what chaos corrupt@op injects).
  uint8_t flipped[32] = {0};
  flipped[0] ^= 0x01;
  CHECK_TRUE(Crc32c(flipped, 32) != Crc32c(zeros, 32));
}

void TestMomentsCountNanInfAndNorm() {
  std::vector<float> v(1027, 0.0f);  // odd size: exercises the scalar tail
  for (size_t i = 0; i < v.size(); ++i) v[i] = (i % 2 == 0) ? 3.0f : -4.0f;
  GradMoments m;
  MomentsF32(v.data(), static_cast<int64_t>(v.size()), &m);
  CHECK_TRUE(m.count == static_cast<int64_t>(v.size()));
  CHECK_TRUE(m.nonfinite == 0);
  CHECK_TRUE(std::fabs(m.absmax - 4.0) < 1e-9);
  const double want = 514 * 9.0 + 513 * 16.0;
  CHECK_TRUE(std::fabs(m.sumsq - want) < 1e-6 * want);
  // NaN/Inf lanes are COUNTED, not folded into the norm: one bad element
  // must not erase the other thousand's magnitude.
  v[7] = std::numeric_limits<float>::quiet_NaN();
  v[900] = std::numeric_limits<float>::infinity();
  v[1024] = -std::numeric_limits<float>::infinity();  // in the scalar tail
  GradMoments m2;
  MomentsF32(v.data(), static_cast<int64_t>(v.size()), &m2);
  CHECK_TRUE(m2.nonfinite == 3);
  CHECK_TRUE(std::isfinite(m2.sumsq));
  CHECK_TRUE(std::fabs(m2.absmax - 4.0) < 1e-9);
  CHECK_TRUE(m2.sumsq < m.sumsq && m2.sumsq > 0.9 * m.sumsq);
}

void TestCopyMomentsMatchesMemcpyAndScan() {
  std::vector<float> src(4099);
  for (size_t i = 0; i < src.size(); ++i) {
    src[i] = std::sin(static_cast<double>(i)) * 7.5f;
  }
  src[17] = std::numeric_limits<float>::quiet_NaN();
  std::vector<float> dst(src.size(), -1.0f);
  GradMoments mc;
  CopyMomentsF32(dst.data(), src.data(),
                 static_cast<int64_t>(src.size()), &mc);
  CHECK_TRUE(memcmp(dst.data(), src.data(), src.size() * 4) == 0);
  GradMoments ms;
  MomentsF32(src.data(), static_cast<int64_t>(src.size()), &ms);
  CHECK_TRUE(mc.count == ms.count);
  CHECK_TRUE(mc.nonfinite == ms.nonfinite && mc.nonfinite == 1);
  CHECK_TRUE(std::fabs(mc.sumsq - ms.sumsq) < 1e-6 * (ms.sumsq + 1));
  CHECK_TRUE(mc.absmax == ms.absmax);
  // Streaming-store path (buffers past the NT threshold, including an
  // odd tail and a deliberately misaligned destination): bitwise-equal
  // copy, identical moments.
  const int64_t big = (4 << 20) / 4 + 13;
  std::vector<float> bsrc(static_cast<size_t>(big));
  for (int64_t i = 0; i < big; ++i) {
    bsrc[static_cast<size_t>(i)] = std::sin(static_cast<double>(i)) * 3.0f;
  }
  bsrc[12345] = std::numeric_limits<float>::infinity();
  std::vector<float> bdst(static_cast<size_t>(big) + 1, -7.0f);
  GradMoments mb;
  CopyMomentsF32(bdst.data() + 1, bsrc.data(), big, &mb);  // unaligned dst
  CHECK_TRUE(memcmp(bdst.data() + 1, bsrc.data(),
                    static_cast<size_t>(big) * 4) == 0);
  GradMoments mbs;
  MomentsF32(bsrc.data(), big, &mbs);
  CHECK_TRUE(mb.count == big && mb.nonfinite == 1);
  CHECK_TRUE(std::fabs(mb.sumsq - mbs.sumsq) < 1e-9 * (mbs.sumsq + 1));
  CHECK_TRUE(mb.absmax == mbs.absmax);
  // ByteBuf (default-init allocator): resize must not zero — fill, shrink,
  // regrow, and the old bytes reappear (proving no value-init pass runs).
  ByteBuf bb;
  bb.resize(64);
  memset(bb.data(), 0xAB, 64);
  bb.resize(0);
  bb.resize(64);
  CHECK_TRUE(bb[0] == 0xAB && bb[63] == 0xAB);
}

void TestWireCompressQualityAccumulation() {
  // Quality rides the quantize kernels: err2/sig2 must reflect the actual
  // round-trip error, so coarser codes score strictly lower SNR.
  std::vector<float> src(2000);
  for (size_t i = 0; i < src.size(); ++i) {
    src[i] = std::cos(static_cast<double>(i) * 0.37) * 2.0f + 0.1f;
  }
  auto snr_of = [&](WireCompression c) {
    std::vector<uint8_t> wire(
        static_cast<size_t>(WireBytes(c, src.size())));
    std::vector<float> decoded(src.size());
    GradQuality q;
    WireCompress(c, src.data(), static_cast<int64_t>(src.size()),
                 wire.data(), nullptr, nullptr, &q);
    CHECK_TRUE(q.count == static_cast<int64_t>(src.size()));
    CHECK_TRUE(q.sig2 > 0);
    // Cross-check err2 against an explicit decode pass.
    WireDecompress(c, wire.data(), static_cast<int64_t>(src.size()),
                   decoded.data());
    double err2 = 0;
    for (size_t i = 0; i < src.size(); ++i) {
      const double d = src[i] - decoded[i];
      err2 += d * d;
    }
    CHECK_TRUE(std::fabs(q.err2 - err2) < 1e-6 * (err2 + 1e-12));
    return q.err2 > 0 ? 10.0 * std::log10(q.sig2 / q.err2) : 1e9;
  };
  const double snr_fp16 = snr_of(WireCompression::FP16);
  const double snr_int8 = snr_of(WireCompression::INT8);
  const double snr_int4 = snr_of(WireCompression::INT4);
  CHECK_TRUE(snr_fp16 > snr_int8);
  CHECK_TRUE(snr_int8 > snr_int4);
  CHECK_TRUE(snr_int4 > 0);
  // With residual error feedback active, err2 equals the post-op residual
  // content (residual[i] = x - deq): the residual-norm telemetry contract.
  std::vector<float> residual(src.size(), 0.0f);
  std::vector<uint8_t> wire(
      static_cast<size_t>(WireBytes(WireCompression::INT8, src.size())));
  GradQuality q;
  WireCompress(WireCompression::INT8, src.data(),
               static_cast<int64_t>(src.size()), wire.data(),
               residual.data(), nullptr, &q);
  double res2 = 0;
  for (float r : residual) res2 += static_cast<double>(r) * r;
  CHECK_TRUE(std::fabs(q.err2 - res2) < 1e-6 * (res2 + 1e-12));
}

void TestResidualStoreResetReporting() {
  ResidualStore store;
  bool reset = true;
  float* a = store.Get("w", 100, &reset);
  CHECK_TRUE(a != nullptr);
  CHECK_TRUE(!reset);  // first use is not a reset
  a[0] = 1.5f;
  CHECK_TRUE(store.Get("w", 100, &reset) == a && !reset);
  CHECK_TRUE(a[0] == 1.5f);  // steady state keeps the feedback
  // Element count changed on a live key (reshape / refused fusion): the
  // feedback restarts from zero AND the caller is told.
  float* b = store.Get("w", 64, &reset);
  CHECK_TRUE(reset);
  CHECK_TRUE(b[0] == 0.0f);
  CHECK_TRUE(store.TotalBytes() == 64 * 4);
  // Cap overflow clears every live key: also a reset (fresh store so the
  // clear fires exactly at the probe, not mid-fill).
  ResidualStore full;
  for (size_t i = 0; i < ResidualStore::kMaxEntries; ++i) {
    full.Get("k" + std::to_string(i), 8, nullptr);
  }
  full.Get("one-more", 8, &reset);
  CHECK_TRUE(reset);
}

void TestGradStatsSlotsAndSnapshot() {
  GradStats gs;
  gs.Configure(true, NanPolicy::WARN, 16);
  CHECK_TRUE(gs.enabled());
  CHECK_TRUE(gs.nan_policy() == NanPolicy::WARN);
  CHECK_TRUE(gs.gradcheck_sample() == 16);
  const int s1 = gs.KeySlot("layer/w");
  const int s2 = gs.KeySlot("layer/bias");
  CHECK_TRUE(s1 >= 1 && s2 >= 1 && s1 != s2);
  CHECK_TRUE(gs.KeySlot("layer/w") == s1);
  GradMoments m;
  m.sumsq = 16.0;
  m.absmax = 3.0;
  m.count = 10;
  gs.RecordMoments(s1, m);
  gs.RecordMoments(s2, m);
  GradQuality q;
  q.err2 = 1.0;
  q.sig2 = 100.0;
  q.count = 10;
  gs.RecordQuality(s1, WireCompression::INT4, q);
  gs.NoteNonfinite(2);
  gs.NoteProbe();
  gs.NoteDivergence();
  gs.NoteResidualReset();
  const GradSlot* sl = gs.slot(s1);
  CHECK_TRUE(sl != nullptr);
  CHECK_TRUE(std::fabs(sl->pub_norm.load() - 4.0) < 1e-9);
  CHECK_TRUE(std::fabs(sl->pub_snr_db.load() - 20.0) < 1e-9);
  CHECK_TRUE(std::fabs(sl->pub_res_norm.load() - 1.0) < 1e-9);
  const std::string json = gs.SnapshotJson();
  // Shape: totals + both keys; SNR fields ONLY on the compressed key —
  // the bias slot (never quantized) must stay absent from the SNR report.
  CHECK_TRUE(json.find("\"nonfinite_total\": 2") != std::string::npos);
  CHECK_TRUE(json.find("\"probes_total\": 1") != std::string::npos);
  CHECK_TRUE(json.find("\"divergence_total\": 1") != std::string::npos);
  CHECK_TRUE(json.find("\"residual_resets_total\": 1") != std::string::npos);
  CHECK_TRUE(json.find("\"nancheck\": \"warn\"") != std::string::npos);
  CHECK_TRUE(json.find("layer/w") != std::string::npos);
  CHECK_TRUE(json.find("layer/bias") != std::string::npos);
  const size_t bias_at = json.find("layer/bias");
  const size_t w_at = json.find("\"key\": \"layer/w\"");
  const size_t snr_at = json.find("\"snr_db\":");
  CHECK_TRUE(snr_at != std::string::npos);
  // Exactly one snr_db field (only the quantized key carries one).
  CHECK_TRUE(json.find("\"snr_db\":", snr_at + 1) == std::string::npos);
  CHECK_TRUE(json.find("\"compression\": \"int4\"") != std::string::npos);
  (void)bias_at;
  (void)w_at;
  // Key overflow: past the cap everything shares slot 0.
  for (int i = 0; i < kGradMaxKeys + 8; ++i) {
    gs.KeySlot("overflow/" + std::to_string(i));
  }
  CHECK_TRUE(gs.KeySlot("one-more") == 0);
}

void TestGradStatsNonfiniteWarnThrottle() {
  // A NaN-flooded tensor warns (and flight-records) at most once per
  // window PER KEY; a second key's first event is never starved.
  GradStats gs;
  gs.Configure(true, NanPolicy::WARN, 0);
  const int s1 = gs.KeySlot("flood/w");
  const int s2 = gs.KeySlot("other/w");
  CHECK_TRUE(gs.ShouldWarnNonfinite(s1, 1000));      // first always passes
  CHECK_TRUE(!gs.ShouldWarnNonfinite(s1, 500000));   // inside the window
  CHECK_TRUE(gs.ShouldWarnNonfinite(s2, 600000));    // other key unstarved
  CHECK_TRUE(gs.ShouldWarnNonfinite(s1, 1000 + 1000000));  // window over
  CHECK_TRUE(!gs.ShouldWarnNonfinite(-1, 0));        // bad slot: quiet
}

void TestGradStatsDisabledIsNoop() {
  GradStats gs;
  gs.Configure(false, NanPolicy::ABORT, 4);
  CHECK_TRUE(!gs.enabled());
  CHECK_TRUE(gs.KeySlot("x") == 0);
  GradMoments m;
  m.count = 1;
  gs.RecordMoments(0, m);  // must not crash with no slot storage
  const std::string json = gs.SnapshotJson();
  CHECK_TRUE(json.find("\"enabled\": false") != std::string::npos);
}

void TestGradStatsConcurrentWritersAndReader() {
  // TSan fixture: four writers hammer two slots while a reader snapshots
  // — same weak-consistency contract as PerfStats (torn sets, never torn
  // values, never a crash).
  GradStats gs;
  gs.Configure(true, NanPolicy::WARN, 8);
  const int s1 = gs.KeySlot("a");
  const int s2 = gs.KeySlot("b");
  std::atomic<bool> stop{false};
  std::vector<std::thread> writers;
  for (int t = 0; t < 4; ++t) {
    writers.emplace_back([&, t] {
      GradMoments m;
      m.sumsq = 4.0 + t;
      m.absmax = 2.0;
      m.count = 8;
      GradQuality q;
      q.err2 = 0.5;
      q.sig2 = 50.0;
      q.count = 8;
      for (int i = 0; i < 2000; ++i) {
        gs.RecordMoments(t % 2 == 0 ? s1 : s2, m);
        gs.RecordQuality(t % 2 == 0 ? s1 : s2, WireCompression::INT8, q);
        gs.NoteNonfinite(1);
      }
    });
  }
  std::thread reader([&] {
    while (!stop.load(std::memory_order_relaxed)) {
      const std::string json = gs.SnapshotJson();
      CHECK_TRUE(json.find("\"keys\": [") != std::string::npos);
    }
  });
  for (auto& w : writers) w.join();
  stop.store(true, std::memory_order_relaxed);
  reader.join();
  CHECK_TRUE(gs.nonfinite_total() == 4 * 2000);
  CHECK_TRUE(gs.slot(s1)->count.load() +
                 gs.slot(s2)->count.load() ==
             4 * 2000);
}


// --- the port's deviations in core.cpp --------------------------------------
// The negotiated shutdown (a rank that shuts down while a peer still reads
// its last bytes no longer breaks the peer) and the join that re-runs the
// promotion (a request already waiting at the coordinator completes when
// the other ranks join). The JAX package's core does neither.

void TestShmCleanCloseLeavesPeerReading() {
  // The negotiated shutdown's lane close: a rank that closes cleanly
  // (every op agreed done) leaves the segment's abort flag down, so a peer
  // still draining bytes written before the close reads them all; a plain
  // close sets the flag, and the peer's next read fails.
  for (bool clean : {true, false}) {
    const std::string name = "/hvdtpu_test_clean_" + std::to_string(getpid()) +
                             (clean ? "_c" : "_a");
    auto a = ShmTransport::Create(name, 4096);
    auto b = ShmTransport::Open(name, 2000);
    CHECK_TRUE(a != nullptr && b != nullptr);
    if (a == nullptr || b == nullptr) return;
    std::vector<uint8_t> sent(3000), got(3000, 0);
    for (size_t i = 0; i < sent.size(); ++i) sent[i] = static_cast<uint8_t>(i * 7);
    CHECK_TRUE(a->Send(sent.data(), sent.size()) == 0);
    if (clean) a->CloseCleanly();
    a.reset();  // the creator's close: unlinks, and aborts unless clean
    int rc = b->Recv(got.data(), got.size());
    if (clean) {
      CHECK_TRUE(rc == 0 && got == sent);
    } else {
      CHECK_TRUE(rc == -1);
    }
  }
}

int FreeTcpPort() {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = 0;
  socklen_t len = sizeof(addr);
  int port = -1;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0 &&
      getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) == 0) {
    port = ntohs(addr.sin_port);
  }
  close(fd);
  return port;
}

// A world of `size` cores in this process, one thread a rank, over
// 127.0.0.1 (shm lanes between them); `body(rank, core)` runs on each
// rank's thread between Start and the caller's own shutdown.
template <typename Body>
void RunCoreWorld(int size, Body body) {
  const int port = FreeTcpPort();
  CHECK_TRUE(port > 0);
  std::vector<void*> cores(size);
  for (int r = 0; r < size; ++r) {
    cores[r] = hvdtpu_create(r, size, r, size, 0, 1, "127.0.0.1", port,
                             "127.0.0.1", 1.0, 64LL << 20, "", 0, 60.0);
  }
  std::vector<std::thread> ranks;
  for (int r = 0; r < size; ++r) {
    ranks.emplace_back([&, r] {
      char err[512] = {0};
      int rc = hvdtpu_start(cores[r], err, sizeof(err));
      if (rc != 0) std::fprintf(stderr, "rank %d start: %s\n", r, err);
      CHECK_TRUE(rc == 0);
      if (rc == 0) body(r, cores[r]);
    });
  }
  for (auto& t : ranks) t.join();
  for (void* c : cores) hvdtpu_destroy(c);
}

long long EnqueueSum(void* core, const char* name, const std::vector<float>& x) {
  char err[512] = {0};
  const long long shape[1] = {static_cast<long long>(x.size())};
  long long h = hvdtpu_enqueue(
      core, name, static_cast<int>(OpType::ALLREDUCE),
      static_cast<int>(ReduceOp::SUM), static_cast<int>(DataType::FLOAT32),
      shape, 1, x.data(), 1.0, 1.0, 0, nullptr, 0, err, sizeof(err));
  if (h < 0) std::fprintf(stderr, "enqueue %s: %s\n", name, err);
  return h;
}

bool WaitResult(void* core, long long h, std::vector<float>* out,
                std::string* error = nullptr) {
  char err[512] = {0};
  if (hvdtpu_wait(core, h, err, sizeof(err)) != 0) {
    if (error != nullptr) *error = err;
    return false;
  }
  return hvdtpu_copy_result(core, h, out->data(),
                            static_cast<long long>(out->size() * sizeof(float)),
                            err, sizeof(err)) == 0;
}

void TestCoreJoinAtWorldOne() {
  // A lone rank's join completes at once and names it: the promotion runs
  // on the JOIN itself (the JAX package's core returns -1 here).
  RunCoreWorld(1, [](int, void* core) {
    CHECK_TRUE(hvdtpu_join(core) == 0);
    hvdtpu_shutdown(core);
  });
}

void TestCoreJoinCompletesWaitingRequest() {
  // Rank 1's "pending" waits at the coordinator when rank 0 joins; the
  // join re-runs the promotion, so it completes with rank 0's zeros (the
  // sum is rank 1's own values), and both joins name rank 1, the last.
  std::atomic<int> before_join{0};
  std::vector<long long> joined(2, -9);
  RunCoreWorld(2, [&](int r, void* core) {
    std::vector<float> mine(5), out(5);
    for (int i = 0; i < 5; ++i) mine[i] = 1.5f * static_cast<float>(i + 1);
    long long pending = -1;
    if (r == 1) pending = EnqueueSum(core, "pending", mine);
    std::vector<float> one(1, 1.0f), got(1);
    CHECK_TRUE(WaitResult(core, EnqueueSum(core, "before_join", one), &got));
    CHECK_TRUE(got[0] == 2.0f);
    before_join.fetch_add(1);
    if (r == 1) {
      // Polled with a deadline: a core that never completes the request
      // (the JAX package's) fails here instead of hanging the binary.
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::seconds(20);
      while (hvdtpu_poll(core, pending) == 0 &&
             std::chrono::steady_clock::now() < deadline) {
        std::this_thread::sleep_for(std::chrono::milliseconds(5));
      }
      CHECK_TRUE(hvdtpu_poll(core, pending) != 0);
      if (hvdtpu_poll(core, pending) != 0) {
        CHECK_TRUE(WaitResult(core, pending, &out));
        CHECK_TRUE(out == mine);
      }
    } else {
      while (before_join.load() < 2) std::this_thread::yield();
    }
    joined[r] = hvdtpu_join(core);
    hvdtpu_shutdown(core);
  });
  CHECK_TRUE(joined[0] == 1 && joined[1] == 1);
}

void TestCoreNegotiatedShutdown() {
  // Rank 0 shuts down after a 16 MiB allreduce while rank 1 still has an
  // op of its own waiting ("late", which rank 0 never enqueues). The
  // coordinator appends CLEAN_SHUTDOWN after the ready ops: rank 1's
  // allreduce is whole, its "late" fails with the shutdown's own error (not
  // a broken lane), and both shutdowns end well inside the agreement's
  // 30 s limit.
  const size_t n = 4u << 20;
  std::atomic<int> late_enqueued{0};
  std::vector<double> shutdown_secs(2, -1.0);
  RunCoreWorld(2, [&](int r, void* core) {
    std::vector<float> x(n, static_cast<float>(r + 1)), out(n);
    CHECK_TRUE(WaitResult(core, EnqueueSum(core, "big", x), &out));
    CHECK_TRUE(out[0] == 3.0f && out[n - 1] == 3.0f);
    if (r == 1) {
      std::vector<float> y(3, 1.0f), got(3);
      long long late = EnqueueSum(core, "late", y);
      late_enqueued.store(1);
      std::string error;
      CHECK_TRUE(!WaitResult(core, late, &got, &error));
      CHECK_TRUE(error.find("shut the world down") != std::string::npos);
      if (error.find("shut the world down") == std::string::npos) {
        std::fprintf(stderr, "late: %s\n", error.c_str());
      }
    } else {
      while (late_enqueued.load() == 0) std::this_thread::yield();
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
    }
    auto t0 = std::chrono::steady_clock::now();
    hvdtpu_shutdown(core);
    shutdown_secs[r] = std::chrono::duration<double>(
                           std::chrono::steady_clock::now() - t0).count();
  });
  CHECK_TRUE(shutdown_secs[0] >= 0 && shutdown_secs[0] < 10.0);
  CHECK_TRUE(shutdown_secs[1] >= 0 && shutdown_secs[1] < 10.0);
}

}  // namespace
}  // namespace hvdtpu

int main() {
  using namespace hvdtpu;
  TestRequestRoundtrip();
  TestResponseRoundtrip();
  TestReaderTruncationIsSafe();
  TestHalfConversionRoundtrip();
  TestHalfConversionSpecialValues();
  TestHalfConversionExhaustive();
  TestHalfRoundToNearestEven();
  TestReduceBufferHalfMatchesScalar();
  TestSendRecvSegmented();
  TestSendAllVecExactConcatenation();
  TestShmRingWraparound();
  TestShmDoorbellBatchingCoalesces();
  TestShmInPlaceViewsAlignedAcrossWrap();
  TestShmViewsNeverMisaligned();
  TestNumaProbeAndPolicy();
  TestShmDoorbellWakeup();
  TestShmAbortCleanup();
  TestShmKilledPeerWakesWaiter();
  TestIoControlRecvFailsFastOnPeerClose();
  TestIoControlAbortBreaksBlockedRecv();
  TestIoControlReadDeadlineTripsOnSilentPeer();
  TestShmReadDeadlineTripsOnSilentPeer();
  TestZeroCopyProbeFallbackBitwise(ZeroCopyMode::ON);
  TestZeroCopyProbeFallbackBitwise(ZeroCopyMode::AUTO);
  TestZeroCopyTcpSendBitwise(ZeroCopyMode::ON);
  TestZeroCopyTcpSendBitwise(ZeroCopyMode::AUTO);
  TestZeroCopyTcpSendBitwise(ZeroCopyMode::URING);
  TestZeroCopyKilledPeerFailsFast();
  TestDataPlaneAllreduceAlgos();
  TestDataPlaneZeroCopyMatchesCopyPathBitwise();
  TestDataPlaneZeroCopyDropAborts();
  TestDataPlaneScaleAlgosBitwise();
  TestDataPlaneScaleAlgosDropAborts();
  TestDataPlaneHierarchicalAllreduce();
  TestWireQuantizerRoundTrip();
  TestWireInt4PackingAndTail();
  TestWireErrorFeedbackConvergence();
  TestDataPlaneCompressedAllreduce();
  TestDataPlaneReduceScatter();
  TestDataPlaneAllgatherv();
  TestDataPlaneBroadcast();
  TestDataPlaneAlltoallv();
  TestDataPlaneCompressedHierarchical();
  TestReduceBufferOps();
  TestMetricsConcurrentIncrements();
  TestMetricsHistogramBucketBoundaries();
  TestMetricsDumpDeterminism();
  TestMetricsLabelEscaping();
  TestDataPlaneWireCountersInRegistry();
  TestGaussianProcessInterpolates();
  TestBayesianOptimizerPicksBestSample();
  TestParameterManagerFreezesAtBest();
  TestClockOffsetEstimator();
  TestTraceSamplerGating();
  TestTimelineSpanAndMetadata();
  TestIoControlWaitAccounting();
  TestFlightRecorderSnapshotRoundtrip();
  TestFlightRecorderWraparoundOldestFirst();
  TestFlightRecorderNameOverflowSharesSlotZero();
  TestFlightRecorderConcurrentWriters();
  TestFlightRecorderDumpLatchAndOnDemand();
  TestFlightRecorderSigtermDoesNotBurnLatch();
  TestFlightLaneCodes();
  TestDataPlaneRecordsFlightHops();
  TestP2QuantileTracksSortedQuantiles();
  TestPerfStatsBaselineAndSentry();
  TestPerfStatsKeyOverflowSharesSlotZero();
  TestPerfStatsConcurrentWritersAndReader();
  TestPerfStatsSnapshotJsonShape();
  TestDataPlanePerfPhaseAccumulation();
  TestPerfStatsPerKeyWarnThrottle();
  TestProfilerPhaseScopePublishesAndRestores();
  TestProfilerDisabledIsNoop();
  TestProfilerSamplesTaggedByPhaseAndOp();
  TestProfilerWallClockSamplesBlockedThread();
  TestProfilerSigprofStormDuringFlightDump();
  TestCrc32cKnownAnswers();
  TestMomentsCountNanInfAndNorm();
  TestCopyMomentsMatchesMemcpyAndScan();
  TestWireCompressQualityAccumulation();
  TestResidualStoreResetReporting();
  TestGradStatsSlotsAndSnapshot();
  TestGradStatsNonfiniteWarnThrottle();
  TestGradStatsDisabledIsNoop();
  TestGradStatsConcurrentWritersAndReader();
  TestShmCleanCloseLeavesPeerReading();
  TestCoreJoinAtWorldOne();
  TestCoreJoinCompletesWaitingRequest();
  TestCoreNegotiatedShutdown();
  if (failures == 0) {
    std::printf("native unit tests: ALL OK\n");
    return 0;
  }
  std::fprintf(stderr, "native unit tests: %d failure(s)\n", failures);
  return 1;
}
