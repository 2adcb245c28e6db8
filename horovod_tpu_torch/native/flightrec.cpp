#include "flightrec.h"

#include <fcntl.h>
#include <signal.h>
#include <time.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <memory>

namespace hvdtpu {

namespace {

inline int64_t SteadyNowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline int64_t WallNowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

inline uint64_t PackU32Pair(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(lo) |
         (static_cast<uint64_t>(hi) << 32);
}

// Little-endian scalar writes into the header buffer. The ring words are
// stored host-endian and dumped verbatim; every supported target is
// little-endian (x86-64 / aarch64), and the decoder asserts the magic.
template <typename T>
inline void Put(char* buf, size_t off, T v) {
  std::memcpy(buf + off, &v, sizeof(T));
}

}  // namespace

FlightRecorder::FlightRecorder() = default;

FlightRecorder::~FlightRecorder() { ClearSignalFlightRecorder(this); }

void FlightRecorder::Configure(int64_t capacity, const std::string& dump_dir,
                               int rank, int world_size) {
  rank_ = rank;
  world_size_ = world_size;
  if (capacity <= 0) {
    cap_ = 0;
    return;
  }
  // Floor keeps the ring useful (a handful of events IS the last op) and
  // the dump header's oldest-first reorder trivial.
  cap_ = capacity < 64 ? 64 : capacity;
  words_ = std::make_unique<std::atomic<uint64_t>[]>(
      static_cast<size_t>(cap_) * kFlightRecordWords);
  for (int64_t i = 0; i < cap_ * kFlightRecordWords; ++i) {
    words_[i].store(0, std::memory_order_relaxed);
  }
  names_ = std::make_unique<char[]>(
      static_cast<size_t>(kFlightMaxNames) * kFlightNameBytes);
  std::memset(names_.get(), 0,
              static_cast<size_t>(kFlightMaxNames) * kFlightNameBytes);
  // Slot 0: the shared overflow name, so InternName never fails.
  std::snprintf(names_.get(), kFlightNameBytes, "<names-overflowed>");
  name_count_.store(1, std::memory_order_release);
  if (!dump_dir.empty()) {
    dump_path_ = dump_dir + "/flightrec." + std::to_string(rank) + ".bin";
  }
}

int FlightRecorder::InternName(const std::string& name) {
  if (!enabled()) return 0;
  auto it = name_ids_.find(name);
  if (it != name_ids_.end()) return it->second;
  uint32_t n = name_count_.load(std::memory_order_relaxed);  // atomic-ok: single-writer reads its own count
  if (n >= kFlightMaxNames) {
    name_ids_.emplace(name, 0);  // memoize the overflow verdict too
    return 0;
  }
  char* slot = names_.get() + static_cast<size_t>(n) * kFlightNameBytes;
  std::snprintf(slot, kFlightNameBytes, "%s", name.c_str());
  // Publish AFTER the slot is complete: readers (incl. signal handlers)
  // acquire the count and only read entries below it.
  name_count_.store(n + 1, std::memory_order_release);
  name_ids_.emplace(name, static_cast<int>(n));
  return static_cast<int>(n);
}

void FlightRecorder::Record(FlightEvent type, int name_id, int64_t bytes,
                            int send_peer, int recv_peer, int64_t t0_us,
                            int64_t t1_us, int64_t arg, uint16_t lane) {
  if (!enabled()) return;
  const int64_t idx = next_.fetch_add(1, std::memory_order_relaxed);
  std::atomic<uint64_t>* w =
      words_.get() + (idx % cap_) * kFlightRecordWords;
  int64_t dur = t1_us - t0_us;
  if (dur < 0) dur = 0;
  const uint32_t dur32 =
      dur > INT32_MAX ? static_cast<uint32_t>(INT32_MAX)
                      : static_cast<uint32_t>(dur);
  int64_t a = arg;
  if (a > INT32_MAX) a = INT32_MAX;
  if (a < INT32_MIN) a = INT32_MIN;
  w[0].store(static_cast<uint64_t>(t1_us), std::memory_order_relaxed);
  w[1].store(static_cast<uint64_t>(dur32) |
                 (static_cast<uint64_t>(static_cast<uint16_t>(
                      static_cast<int32_t>(type))) << 32) |
                 (static_cast<uint64_t>(lane) << 48),
             std::memory_order_relaxed);
  w[2].store(static_cast<uint64_t>(bytes), std::memory_order_relaxed);
  w[3].store(PackU32Pair(static_cast<uint32_t>(name_id),
                         static_cast<uint32_t>(static_cast<int32_t>(a))),
             std::memory_order_relaxed);
  w[4].store(PackU32Pair(static_cast<uint32_t>(send_peer),
                         static_cast<uint32_t>(recv_peer)),
             std::memory_order_relaxed);
}

void FlightRecorder::SerializeHeader(char* out, DumpReason reason,
                                     int32_t detail, int64_t write_count,
                                     uint32_t name_count) const {
  std::memset(out, 0, kFlightHeaderBytes);
  std::memcpy(out, kFlightMagic, sizeof(kFlightMagic));
  Put<uint32_t>(out, 8, 1);                   // version
  Put<uint32_t>(out, 12, kFlightHeaderBytes);
  Put<int32_t>(out, 16, rank_);
  Put<int32_t>(out, 20, world_size_);
  Put<int64_t>(out, 24, clock_offset_us_.load(std::memory_order_relaxed));
  Put<int64_t>(out, 32, clock_err_us_.load(std::memory_order_relaxed));
  Put<int64_t>(out, 40, SteadyNowUs());       // anchor pair at dump time
  Put<int64_t>(out, 48, WallNowUs());
  Put<int64_t>(out, 56, write_count);
  Put<uint32_t>(out, 64, static_cast<uint32_t>(cap_));
  Put<uint32_t>(out, 68, kFlightRecordWords * 8);
  Put<uint32_t>(out, 72, name_count);
  Put<uint32_t>(out, 76, kFlightNameBytes);
  Put<int32_t>(out, 80, static_cast<int32_t>(reason));
  Put<int32_t>(out, 84, detail);
}

std::string FlightRecorder::Snapshot(DumpReason reason,
                                     int32_t detail) const {
  if (!enabled()) return std::string();
  const int64_t wc = next_.load(std::memory_order_relaxed);
  const uint32_t names = name_count_.load(std::memory_order_acquire);
  const int64_t kept = wc < cap_ ? wc : cap_;
  std::string out;
  out.resize(kFlightHeaderBytes +
             static_cast<size_t>(names) * kFlightNameBytes +
             static_cast<size_t>(kept) * kFlightRecordWords * 8);
  char* p = &out[0];
  SerializeHeader(p, reason, detail, wc, names);
  p += kFlightHeaderBytes;
  std::memcpy(p, names_.get(), static_cast<size_t>(names) * kFlightNameBytes);
  p += static_cast<size_t>(names) * kFlightNameBytes;
  // Oldest-first: ring position of the oldest kept record is wc % cap_
  // once the ring has wrapped, 0 before.
  const int64_t start = wc < cap_ ? 0 : wc % cap_;
  uint64_t* dst = reinterpret_cast<uint64_t*>(p);
  for (int64_t i = 0; i < kept; ++i) {
    const std::atomic<uint64_t>* w =
        words_.get() + ((start + i) % cap_) * kFlightRecordWords;
    for (int j = 0; j < kFlightRecordWords; ++j) {
      dst[i * kFlightRecordWords + j] = w[j].load(std::memory_order_relaxed);
    }
  }
  return out;
}

bool FlightRecorder::DumpToFile(DumpReason reason, int32_t detail,
                                const std::string& path, bool fatal_once) {
  if (!enabled()) return false;
  const std::string& target = path.empty() ? dump_path_ : path;
  if (target.empty()) return false;
  if (fatal_once && fatal_dumped_.exchange(true)) return false;
  std::string img = Snapshot(reason, detail);
  FILE* f = std::fopen(target.c_str(), "wb");
  const bool ok =
      f != nullptr &&
      std::fwrite(img.data(), 1, img.size(), f) == img.size();
  if (f != nullptr) std::fclose(f);
  // A failed write must not burn the only dump opportunity: re-arm the
  // latch so a later trigger (stall after a full disk was cleared, the
  // fatal-signal handler) still gets its chance at a post-mortem.
  if (fatal_once && !ok) fatal_dumped_.store(false);
  return ok;
}

void FlightRecorder::SignalDump(int signo) {
  if (!enabled() || dump_path_.empty()) return;
  if (fatal_dumped_.exchange(true)) return;
  const int fd = ::open(dump_path_.c_str(),
                        O_CREAT | O_WRONLY | O_TRUNC | O_CLOEXEC, 0644);
  if (fd < 0) {
    fatal_dumped_.store(false);  // nothing written: leave the latch armed
    return;
  }
  const int64_t wc = next_.load(std::memory_order_relaxed);
  const uint32_t names = name_count_.load(std::memory_order_acquire);
  char header[kFlightHeaderBytes];
  SerializeHeader(header, DumpReason::SIGNAL, signo, wc, names);
  // Partial writes are not retried: a truncated tail still decodes up to
  // the last whole record, and anything fancier is risk inside a handler.
  ssize_t n = ::write(fd, header, sizeof(header));
  if (n == static_cast<ssize_t>(sizeof(header))) {
    n = ::write(fd, names_.get(),
                static_cast<size_t>(names) * kFlightNameBytes);
  }
  if (n >= 0) {
    const int64_t kept = wc < cap_ ? wc : cap_;
    const int64_t start = wc < cap_ ? 0 : wc % cap_;
    uint64_t chunk[64 * kFlightRecordWords];
    int64_t i = 0;
    while (i < kept) {
      int64_t m = 0;
      while (m < 64 && i + m < kept) {
        const std::atomic<uint64_t>* w =
            words_.get() + ((start + i + m) % cap_) * kFlightRecordWords;
        for (int j = 0; j < kFlightRecordWords; ++j) {
          chunk[m * kFlightRecordWords + j] =
              w[j].load(std::memory_order_relaxed);
        }
        ++m;
      }
      if (::write(fd, chunk,
                  static_cast<size_t>(m) * kFlightRecordWords * 8) < 0) {
        break;
      }
      i += m;
    }
  }
  ::close(fd);
  // SIGTERM is launcher/watchdog cleanup, not a cause (postmortem.py
  // classifies it exactly so) — and an application with its own SIGTERM
  // handler may survive it. Re-arm the latch so a LATER genuine fatal
  // (SIGSEGV, abort cascade) can overwrite this dump with the real story;
  // the reverse order stays protected (a prior fatal dump latches this
  // handler out above).
  if (signo == SIGTERM) fatal_dumped_.store(false);
}

// ---------------------------------------------------------------------------
// Fatal-signal plumbing
// ---------------------------------------------------------------------------

namespace {

std::atomic<FlightRecorder*> g_signal_recorder{nullptr};  // atomic: seqcst(publish/drain pairs with g_handler_active)
// Handshake with ClearSignalFlightRecorder: a handler enters (increments)
// BEFORE loading the recorder pointer, so the clearing thread can null the
// pointer and then drain the count, guaranteeing no handler still holds a
// recorder whose buffers its destructor is about to free. Both sides use
// seq_cst: a handler that observed a non-null pointer ordered its increment
// before the clearer's null store, so the drain loop must see it.
std::atomic<int> g_handler_active{0};  // atomic: seqcst(handler-drain handshake, see comment above)
constexpr int kFlightSignals[] = {SIGSEGV, SIGBUS, SIGABRT, SIGTERM};
struct sigaction g_prev_actions[sizeof(kFlightSignals) /
                                sizeof(kFlightSignals[0])];
std::atomic<bool> g_handlers_installed{false};  // atomic: seqcst(install-once exchange)

HVDTPU_ROLE(signal)
void FlightSignalHandler(int signo) {
  g_handler_active.fetch_add(1);
  FlightRecorder* rec = g_signal_recorder.load();
  if (rec != nullptr) rec->SignalDump(signo);
  g_handler_active.fetch_sub(1);
  // Restore the pre-install disposition and re-raise so the process still
  // dies (or runs the application's own handler) exactly as before.
  for (size_t i = 0;
       i < sizeof(kFlightSignals) / sizeof(kFlightSignals[0]); ++i) {
    if (kFlightSignals[i] == signo) {
      sigaction(signo, &g_prev_actions[i], nullptr);
      raise(signo);
      return;
    }
  }
}

}  // namespace

void SetSignalFlightRecorder(FlightRecorder* rec) {
  g_signal_recorder.store(rec);  // seq_cst: pairs with the handler's seq_cst load
}

void ClearSignalFlightRecorder(FlightRecorder* rec) {
  FlightRecorder* expected = rec;
  g_signal_recorder.compare_exchange_strong(expected, nullptr);
  // A handler on another thread may have loaded `rec` (or a predecessor)
  // just before the clear — e.g. the launcher's SIGTERM landing exactly
  // while the user thread tears the Core down. Wait it out before the
  // caller (~FlightRecorder) frees the ring; SignalDump is bounded file
  // I/O, so this terminates.
  while (g_handler_active.load() > 0) {
    struct timespec ts = {0, 1000000};  // 1 ms
    nanosleep(&ts, nullptr);
  }
}

void InstallFlightSignalHandlers() {
  if (g_handlers_installed.exchange(true)) return;
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_handler = FlightSignalHandler;
  sigemptyset(&sa.sa_mask);
  // SIGPROF is masked for the dump's duration: the sampling profiler
  // (profiler.h) may be firing at HVDTPU_PROF_HZ on this very thread, and
  // a sampler interrupting the fatal dump's write loop would stretch the
  // one chance at a post-mortem (pinned by the unit-test re-entrancy
  // storm; docs/profiling.md "Signal coexistence").
  sigaddset(&sa.sa_mask, SIGPROF);
  // No SA_RESETHAND: the handler restores the saved disposition itself so
  // it can chain an application handler instead of always going to default.
  for (size_t i = 0;
       i < sizeof(kFlightSignals) / sizeof(kFlightSignals[0]); ++i) {
    sigaction(kFlightSignals[i], &sa, &g_prev_actions[i]);
  }
}

}  // namespace hvdtpu
