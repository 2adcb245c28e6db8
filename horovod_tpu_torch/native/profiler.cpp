#include "profiler.h"

#include <cxxabi.h>
#include <dlfcn.h>
#include <pthread.h>
#include <sys/syscall.h>
#include <ucontext.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>

// glibc spells the SIGEV_THREAD_ID target field through this macro; musl
// and older glibc headers omit it.
#ifndef sigev_notify_thread_id
#define sigev_notify_thread_id _sigev_un._tid
#endif

namespace hvdtpu {

namespace {

// Record header word layout: [0:8) frame count, [8:16) phase code + 1
// (0 = "no phase" so -1 survives the round trip), [16:32) op id,
// [32:64) reserved.
inline uint64_t PackHeader(int nframes, int32_t phase, int32_t op_id) {
  return static_cast<uint64_t>(nframes & 0xff) |
         (static_cast<uint64_t>((phase + 1) & 0xff) << 8) |
         (static_cast<uint64_t>(static_cast<uint16_t>(op_id)) << 16);
}

inline void UnpackHeader(uint64_t h, int* nframes, int32_t* phase,
                         int32_t* op_id) {
  *nframes = static_cast<int>(h & 0xff);
  *phase = static_cast<int32_t>((h >> 8) & 0xff) - 1;
  *op_id = static_cast<int32_t>((h >> 16) & 0xffff);
}

// Handler-drain handshake (same protocol as the flight recorder's): a
// handler increments BEFORE loading its thread's profiler pointer; a
// destructor on another thread drains the count before freeing the ring.
std::atomic<int> g_prof_handler_active{0};  // atomic: seqcst(handler-drain handshake)
std::atomic<bool> g_prof_handler_installed{false};  // atomic: seqcst(install-once exchange)

HVDTPU_ROLE(signal)
void ProfSignalHandler(int /*signo*/, siginfo_t* /*info*/, void* uc) {
  const int saved_errno = errno;
  g_prof_handler_active.fetch_add(1);
  // Per-thread routing: the timer that fired targeted THIS thread, and
  // only its own registration says which profiler owns it (in-process
  // multi-core test worlds run several).
  SamplingProfiler* p = ProfThread()->profiler;
  if (p != nullptr) p->Sample(uc);
  g_prof_handler_active.fetch_sub(1);
  errno = saved_errno;
}

// Demangled (when possible) symbol for `pc`, with module fallback. NOT
// async-signal-safe — fold-time only.
std::string Symbolize(uintptr_t pc) {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(pc), &info) != 0 &&
      info.dli_sname != nullptr) {
    int status = 0;
    char* dem = abi::__cxa_demangle(info.dli_sname, nullptr, nullptr,
                                    &status);
    std::string out = status == 0 && dem != nullptr ? dem : info.dli_sname;
    std::free(dem);
    // Strip template/argument noise for fold keys: everything after the
    // first '(' (flamegraph frames read better as bare qualified names).
    const size_t paren = out.find('(');
    if (paren != std::string::npos) out.resize(paren);
    return out;
  }
  if (dladdr(reinterpret_cast<void*>(pc), &info) != 0 &&
      info.dli_fname != nullptr) {
    const char* base = std::strrchr(info.dli_fname, '/');
    return std::string("[") + (base != nullptr ? base + 1 : info.dli_fname) +
           "]";
  }
  char buf[32];
  std::snprintf(buf, sizeof(buf), "0x%zx", static_cast<size_t>(pc));
  return buf;
}

}  // namespace

ProfThreadState* ProfThread() {
  static thread_local ProfThreadState state;
  return &state;
}

// Fold-time aggregation: {phase, op, frames} -> count. std::map keeps the
// output deterministic for the tests.
struct SamplingProfiler::Agg {
  struct Key {
    int32_t phase;
    int32_t op_id;
    std::vector<uintptr_t> frames;  // leaf first
    bool operator<(const Key& o) const {
      if (phase != o.phase) return phase < o.phase;
      if (op_id != o.op_id) return op_id < o.op_id;
      return frames < o.frames;
    }
  };
  std::map<Key, int64_t> counts;
  int64_t total = 0;
  int64_t kept = 0;
};

SamplingProfiler::SamplingProfiler() = default;

SamplingProfiler::~SamplingProfiler() {
  Stop();
  // Every well-paired thread has unregistered by now (the core joins its
  // background loop first); drain any handler still inside Sample() before
  // the ring is freed — Sample() is bounded, so this terminates.
  while (g_prof_handler_active.load() > 0) {
    struct timespec ts = {0, 1000000};  // 1 ms
    nanosleep(&ts, nullptr);
  }
}

void SamplingProfiler::Configure(bool enabled, int hz, int64_t capacity,
                                 ProfClock clock, int rank) {
  enabled_ = enabled;
  rank_ = rank;
  clock_ = clock;
  if (hz > 0) hz_ = hz > 1000 ? 1000 : hz;
  if (!enabled_) {
    cap_ = 0;
    return;
  }
  int64_t cap = capacity > 0 ? capacity : kProfDefaultCapacity;
  if (cap < 64) cap = 64;
  if (cap > kProfMaxCapacity) cap = kProfMaxCapacity;
  cap_ = cap;
  words_ = std::make_unique<std::atomic<uint64_t>[]>(
      static_cast<size_t>(cap_) * kProfRecordWords);
  for (int64_t i = 0; i < cap_ * kProfRecordWords; ++i) {
    words_[i].store(0, std::memory_order_relaxed);
  }
  ops_ = std::make_unique<char[]>(
      static_cast<size_t>(kProfMaxOps) * kProfOpNameBytes);
  std::memset(ops_.get(), 0,
              static_cast<size_t>(kProfMaxOps) * kProfOpNameBytes);
  std::snprintf(ops_.get(), kProfOpNameBytes, "<ops-overflowed>");
  op_count_.store(1, std::memory_order_release);
}

int SamplingProfiler::InternOp(const std::string& name) {
  if (!enabled_) return 0;
  auto it = op_ids_.find(name);
  if (it != op_ids_.end()) return it->second;
  uint32_t n = op_count_.load(std::memory_order_relaxed);  // atomic-ok: single-writer reads its own count
  if (n >= kProfMaxOps) {
    op_ids_.emplace(name, 0);
    return 0;
  }
  char* slot = ops_.get() + static_cast<size_t>(n) * kProfOpNameBytes;
  std::snprintf(slot, kProfOpNameBytes, "%s", name.c_str());
  op_count_.store(n + 1, std::memory_order_release);
  op_ids_.emplace(name, static_cast<int>(n));
  return static_cast<int>(n);
}

void SamplingProfiler::ArmTimer(ProfThreadState* t, bool arm) {
  if (!t->registered) return;
  struct itimerspec its;
  std::memset(&its, 0, sizeof(its));
  if (arm) {
    const long ns = 1000000000L / hz_;
    its.it_interval.tv_sec = 0;
    its.it_interval.tv_nsec = ns;
    its.it_value = its.it_interval;
  }  // all-zero disarms
  timer_settime(t->timer, 0, &its, nullptr);
  t->timer_armed = arm;
}

void SamplingProfiler::RegisterThread() {
  if (!enabled_) return;
  ProfThreadState* t = ProfThread();
  if (t->registered) return;
  // Stack bounds for the unwinder's range checks: every frame-pointer
  // dereference must land inside this thread's own mapped stack, so a
  // broken chain (frame-pointer-less libc frames, leaf tails) terminates
  // the walk instead of faulting inside a signal handler.
  pthread_attr_t attr;
  if (pthread_getattr_np(pthread_self(), &attr) == 0) {
    void* lo = nullptr;
    size_t sz = 0;
    if (pthread_attr_getstack(&attr, &lo, &sz) == 0 && lo != nullptr) {
      t->stack_lo = reinterpret_cast<uintptr_t>(lo);
      t->stack_hi = t->stack_lo + sz;
    }
    pthread_attr_destroy(&attr);
  }
  if (t->stack_hi == 0) return;  // no bounds -> never unwind this thread
  struct sigevent sev;
  std::memset(&sev, 0, sizeof(sev));
  sev.sigev_notify = SIGEV_THREAD_ID;
  sev.sigev_signo = SIGPROF;
  sev.sigev_notify_thread_id =
      static_cast<pid_t>(syscall(SYS_gettid));
  const clockid_t clk = clock_ == ProfClock::WALL ? CLOCK_MONOTONIC
                                                  : CLOCK_THREAD_CPUTIME_ID;
  if (timer_create(clk, &sev, &t->timer) != 0) return;
  t->registered = true;
  t->profiler = this;
  InstallProfSignalHandler();
  MutexLock lk(mu_);
  threads_.push_back(t);
  if (running_.load(std::memory_order_acquire)) ArmTimer(t, true);
}

void SamplingProfiler::UnregisterThread() {
  ProfThreadState* t = ProfThread();
  if (!t->registered || t->profiler != this) return;
  // Null the routing pointer FIRST: a SIGPROF already queued for this
  // thread may still be delivered after timer_delete, and the handler must
  // observe the teardown (same-thread program order guarantees it does).
  t->profiler = nullptr;
  // The rest under the registry mutex: Start/Stop walk threads_ and touch
  // timer_armed/registered from other threads under the same lock.
  MutexLock lk(mu_);
  ArmTimer(t, false);
  timer_delete(t->timer);
  t->registered = false;
  for (size_t i = 0; i < threads_.size(); ++i) {
    if (threads_[i] == t) {
      threads_.erase(threads_.begin() + static_cast<ptrdiff_t>(i));
      break;
    }
  }
}

int SamplingProfiler::registered_threads() const {
  MutexLock lk(mu_);
  return static_cast<int>(threads_.size());
}

void SamplingProfiler::Start() {
  if (!enabled_) return;
  MutexLock lk(mu_);
  if (running_.load(std::memory_order_acquire)) return;
  // Fresh window: drop the previous ring contents so folded output never
  // mixes two windows.
  for (int64_t i = 0; i < cap_ * kProfRecordWords; ++i) {
    words_[i].store(0, std::memory_order_relaxed);
  }
  next_.store(0, std::memory_order_relaxed);
  running_.store(true, std::memory_order_release);
  for (ProfThreadState* t : threads_) ArmTimer(t, true);
}

void SamplingProfiler::Stop() {
  if (!enabled_) return;
  MutexLock lk(mu_);
  if (!running_.load(std::memory_order_acquire)) return;
  running_.store(false, std::memory_order_release);
  for (ProfThreadState* t : threads_) ArmTimer(t, false);
}

void SamplingProfiler::Sample(void* ucontext) {
  if (!running_.load(std::memory_order_relaxed) || cap_ <= 0) return;  // atomic-ok: async-signal gate; stale read only costs one sample
  ProfThreadState* t = ProfThread();
  uintptr_t pcs[kProfMaxFrames];
  int n = 0;
  uintptr_t pc = 0;
  uintptr_t fp = 0;
  ucontext_t* uc = static_cast<ucontext_t*>(ucontext);
#if defined(__x86_64__)
  if (uc != nullptr) {
    pc = static_cast<uintptr_t>(uc->uc_mcontext.gregs[REG_RIP]);
    fp = static_cast<uintptr_t>(uc->uc_mcontext.gregs[REG_RBP]);
  }
#elif defined(__aarch64__)
  if (uc != nullptr) {
    pc = static_cast<uintptr_t>(uc->uc_mcontext.pc);
    fp = static_cast<uintptr_t>(uc->uc_mcontext.regs[29]);
  }
#else
  (void)uc;
#endif
  if (pc != 0) pcs[n++] = pc;
  // Frame-pointer walk: [fp] = caller's fp, [fp + 8] = return address.
  // Every dereference is bounds-checked against the thread's own stack and
  // the chain must strictly grow toward the stack base, so a missing or
  // corrupt frame pointer ends the walk — it can never fault or loop.
  uintptr_t lo = t->stack_lo;
  const uintptr_t hi = t->stack_hi;
  while (n < kProfMaxFrames && fp >= lo && fp + 2 * sizeof(uintptr_t) <= hi &&
         (fp & (sizeof(uintptr_t) - 1)) == 0) {
    const uintptr_t* frame = reinterpret_cast<const uintptr_t*>(fp);
    const uintptr_t ret = frame[1];
    if (ret < 4096) break;
    pcs[n++] = ret;
    const uintptr_t next_fp = frame[0];
    if (next_fp <= fp) break;  // must move toward the stack base
    lo = fp + 1;
    fp = next_fp;
  }
  if (n == 0) return;
  const int64_t idx = next_.fetch_add(1, std::memory_order_relaxed);
  std::atomic<uint64_t>* w =
      words_.get() + (idx % cap_) * kProfRecordWords;
  w[0].store(PackHeader(n, t->phase.load(std::memory_order_relaxed),
                        t->op_id.load(std::memory_order_relaxed)),
             std::memory_order_relaxed);
  for (int i = 0; i < n; ++i) {
    w[1 + i].store(static_cast<uint64_t>(pcs[i]), std::memory_order_relaxed);
  }
  for (int i = n; i < kProfMaxFrames; ++i) {
    w[1 + i].store(0, std::memory_order_relaxed);
  }
}

void SamplingProfiler::FoldInto(Agg* agg) const {
  const int64_t wc = next_.load(std::memory_order_relaxed);
  const int64_t kept = wc < cap_ ? wc : cap_;
  const int64_t start = wc < cap_ ? 0 : wc % cap_;
  agg->total = wc;
  agg->kept = kept;
  const uint32_t nops = op_count_.load(std::memory_order_acquire);
  for (int64_t i = 0; i < kept; ++i) {
    const std::atomic<uint64_t>* w =
        words_.get() + ((start + i) % cap_) * kProfRecordWords;
    int nframes = 0;
    int32_t phase = -1, op_id = 0;
    UnpackHeader(w[0].load(std::memory_order_relaxed), &nframes, &phase,
                 &op_id);
    if (nframes <= 0 || nframes > kProfMaxFrames) continue;  // torn/empty
    Agg::Key key;
    key.phase = phase;
    key.op_id = op_id < static_cast<int32_t>(nops) ? op_id : 0;
    key.frames.reserve(static_cast<size_t>(nframes));
    for (int f = 0; f < nframes; ++f) {
      key.frames.push_back(static_cast<uintptr_t>(
          w[1 + f].load(std::memory_order_relaxed)));
    }
    ++agg->counts[key];
  }
}

std::string SamplingProfiler::FoldedJson() const {
  if (!enabled_ || cap_ <= 0) {
    return "{\"version\": 1, \"enabled\": false, \"stacks\": []}";
  }
  Agg agg;
  FoldInto(&agg);
  // Symbolize each unique pc once (dladdr is microseconds; stacks repeat).
  std::map<uintptr_t, std::string> syms;
  int64_t phase_counts[kPerfPhases + 1] = {0};  // [kPerfPhases] = untagged
  for (const auto& kv : agg.counts) {
    const int32_t p = kv.first.phase;
    phase_counts[p >= 0 && p < kPerfPhases ? p : kPerfPhases] += kv.second;
    for (uintptr_t pc : kv.first.frames) {
      if (syms.find(pc) == syms.end()) syms[pc] = Symbolize(pc);
    }
  }
  std::string out = "{\"version\": 1, \"enabled\": true, \"rank\": " +
                    std::to_string(rank_) + ", \"hz\": " +
                    std::to_string(hz_) + ", \"clock\": \"" +
                    (clock_ == ProfClock::WALL ? "wall" : "cpu") +
                    "\", \"running\": " + (running() ? "true" : "false") +
                    ", \"samples\": " + std::to_string(agg.total) +
                    ", \"kept\": " + std::to_string(agg.kept) +
                    ", \"phases\": {";
  bool first = true;
  for (int p = 0; p <= kPerfPhases; ++p) {
    if (phase_counts[p] == 0) continue;
    if (!first) out += ", ";
    first = false;
    out += '"';
    out += p < kPerfPhases ? PerfPhaseName(static_cast<PerfPhase>(p))
                           : "idle";
    out += "\": " + std::to_string(phase_counts[p]);
  }
  out += "}, \"stacks\": [";
  first = true;
  const uint32_t nops = op_count_.load(std::memory_order_acquire);
  for (const auto& kv : agg.counts) {
    if (!first) out += ", ";
    first = false;
    const int32_t p = kv.first.phase;
    const char* op =
        kv.first.op_id > 0 && kv.first.op_id < static_cast<int32_t>(nops)
            ? ops_.get() +
                  static_cast<size_t>(kv.first.op_id) * kProfOpNameBytes
            : "";
    out += "{\"phase\": \"";
    out += p >= 0 && p < kPerfPhases
               ? PerfPhaseName(static_cast<PerfPhase>(p))
               : "idle";
    out += "\", \"op\": " + JsonEscapeString(op) +
           ", \"count\": " + std::to_string(kv.second) + ", \"frames\": [";
    for (size_t f = 0; f < kv.first.frames.size(); ++f) {
      if (f > 0) out += ", ";
      out += JsonEscapeString(syms[kv.first.frames[f]]);
    }
    out += "]}";
  }
  out += "]}";
  return out;
}

std::string SamplingProfiler::FoldedText() const {
  if (!enabled_ || cap_ <= 0) return std::string();
  Agg agg;
  FoldInto(&agg);
  std::map<uintptr_t, std::string> syms;
  for (const auto& kv : agg.counts) {
    for (uintptr_t pc : kv.first.frames) {
      if (syms.find(pc) == syms.end()) syms[pc] = Symbolize(pc);
    }
  }
  const uint32_t nops = op_count_.load(std::memory_order_acquire);
  std::string out;
  for (const auto& kv : agg.counts) {
    const int32_t p = kv.first.phase;
    const char* op =
        kv.first.op_id > 0 && kv.first.op_id < static_cast<int32_t>(nops)
            ? ops_.get() +
                  static_cast<size_t>(kv.first.op_id) * kProfOpNameBytes
            : "-";
    // flamegraph.pl folds on ';'-joined root-first frames; the phase and op
    // lead the stack so one flamegraph splits by {op, phase} at its base.
    // Frame names are sanitized (';' and whitespace) to keep the grammar.
    out += p >= 0 && p < kPerfPhases
               ? PerfPhaseName(static_cast<PerfPhase>(p))
               : "idle";
    out += ';';
    for (const char* c = op[0] != '\0' ? op : "-"; *c != '\0'; ++c) {
      out += *c == ';' || *c == ' ' || *c == '\n' ? '_' : *c;
    }
    for (size_t f = kv.first.frames.size(); f-- > 0;) {
      out += ';';
      for (char c : syms[kv.first.frames[f]]) {
        out += c == ';' || c == ' ' || c == '\n' ? '_' : c;
      }
    }
    out += ' ';
    out += std::to_string(kv.second);
    out += '\n';
  }
  return out;
}

bool SamplingProfiler::WriteFolded(const std::string& path) const {
  if (!enabled_ || path.empty()) return false;
  const std::string body = FoldedText();
  FILE* f = std::fopen(path.c_str(), "w");
  if (f == nullptr) return false;
  const bool ok = std::fwrite(body.data(), 1, body.size(), f) == body.size();
  std::fclose(f);
  return ok;
}

void InstallProfSignalHandler() {
  if (g_prof_handler_installed.exchange(true)) return;
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_sigaction = ProfSignalHandler;
  sa.sa_flags = SA_SIGINFO | SA_RESTART;
  sigemptyset(&sa.sa_mask);
  sigaction(SIGPROF, &sa, nullptr);
}

}  // namespace hvdtpu
