// Always-available in-process sampling profiler (docs/profiling.md).
//
// The observability stack explains WHAT happened (/metrics), WHY an op was
// slow at span level (tracing.h), what a DEAD job was doing (flightrec.h)
// and WHETHER an op beats its own baseline (perfstats.h) — this subsystem
// answers the remaining question: WHICH CODE is burning the cycles when the
// sentry names a phase. Per-thread sampling via POSIX timers delivering
// SIGPROF (timer_create + SIGEV_THREAD_ID at HVDTPU_PROF_HZ, on the
// thread's CPU clock or the monotonic wall clock), an async-signal-safe
// frame-pointer unwinder writing fixed-size records into a lock-free ring
// (same discipline as the flight recorder: no locks, no allocation, no
// syscalls in the handler), and dladdr symbolization deferred entirely to
// dump time. Every sample is tagged with the sampled thread's CURRENT
// PerfPhase and op from a thread-local the data plane publishes at the
// phase-accumulator points — so folded output splits into flamegraphs
// by {op, phase}: "where does REDUCE actually spend its cycles on the
// wire-slow rank?".
//
// Surfaces: the secret-gated /profz endpoint (start/stop window +
// folded-stacks JSON) beside /metrics, hvd.profile() in Python,
// `hvdrun --profile DIR` collecting prof.<rank>.folded per rank
// (scripts/prof_report.py merges them), and the C API
// (hvdtpu_set_profiler / hvdtpu_profiler_{start,stop,snapshot}).
//
// Reference analog: upstream Horovod's timeline+profiling workflow (arxiv
// 1802.05799) and the phase-attributed MPI characterization of arxiv
// 1810.11112 — there offline and by hand; here live, per-phase, and
// machine-mergeable.
#pragma once

#include <signal.h>
#include <time.h>

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "perfstats.h"

namespace hvdtpu {

// Frames kept per sample (leaf first). 24 return addresses cover every
// data-plane call chain with room to spare; deeper stacks truncate at the
// root end.
constexpr int kProfMaxFrames = 24;
// Ring record: one header word (frame count, phase, op id) + the pc words.
constexpr int kProfRecordWords = kProfMaxFrames + 1;
// Interned op-name slots (flight-recorder discipline: slot 0 is the shared
// overflow entry so InternOp never fails).
constexpr int kProfMaxOps = 256;
constexpr int kProfOpNameBytes = 48;
// Default sampling rate. Prime, so the sampler cannot phase-lock with
// millisecond-periodic loops (the classic 100 Hz vs 1 kHz aliasing trap).
constexpr int kProfDefaultHz = 97;
// Default ring capacity in samples (~3.2 MB): at 97 Hz that holds a
// ~169 s window per sampled thread before the ring wraps (newest kept).
constexpr int64_t kProfDefaultCapacity = 16384;
constexpr int64_t kProfMaxCapacity = 4 * 1024 * 1024;

// Sampling clock (HVDTPU_PROF_CLOCK). CPU: the thread's CPU-time clock —
// samples land only while the thread burns cycles, the classic flamegraph
// contract. WALL: the monotonic clock — blocked time (peer waits, chaos
// delays) is sampled too, so the per-phase split matches the perf-
// attribution wall buckets. Mirrored by envvars.PROF_CLOCK_MODES
// (scripts/check_invariants.py ENUM-MIRROR).
enum class ProfClock : int32_t {
  CPU = 0,
  WALL = 1,
};

class SamplingProfiler;

// Per-thread sampling state. The SIGPROF handler runs ON the thread whose
// timer fired and reads only this thread's slot, so phase/op publication is
// same-thread: relaxed atomics are plenty (they exist to pin the ordering
// against the compiler, not other CPUs). stack_lo/hi bound the frame-
// pointer walk — every dereference is range-checked against the thread's
// own mapped stack, so a broken chain terminates instead of faulting.
struct ProfThreadState {
  std::atomic<int32_t> phase{-1};  // PerfPhase code; -1 = outside any op  // atomic: relaxed-counter
  std::atomic<int32_t> op_id{0};   // interned op slot (0 = none)  // atomic: relaxed-counter
  uintptr_t stack_lo = 0;
  uintptr_t stack_hi = 0;
  timer_t timer{};
  bool timer_armed = false;
  bool registered = false;
  // The profiler this thread is registered with — the SIGPROF handler
  // samples into it. Same-thread only: set by RegisterThread, cleared by
  // UnregisterThread BEFORE the timer is deleted, so even a signal queued
  // across the teardown observes null (signal handlers see their own
  // thread's prior stores in program order).
  SamplingProfiler* profiler = nullptr;
};

// This thread's slot (TLS; never null).
ProfThreadState* ProfThread();

// Scoped phase publication — the data plane brackets its wire/reduce/codec/
// wait regions with these at the same points the accumulators ride.
// Nesting saves and restores (a WAIT slice inside a WIRE hop publishes WAIT
// for its duration, then WIRE again). Cost when idle: two relaxed TLS
// stores per scope — nanoseconds against microsecond-scale regions.
class ProfPhaseScope {
 public:
  explicit ProfPhaseScope(PerfPhase phase) {
    ProfThreadState* t = ProfThread();
    prev_ = t->phase.load(std::memory_order_relaxed);
    t->phase.store(static_cast<int32_t>(phase), std::memory_order_relaxed);
  }
  ~ProfPhaseScope() {
    ProfThread()->phase.store(prev_, std::memory_order_relaxed);
  }
  ProfPhaseScope(const ProfPhaseScope&) = delete;
  ProfPhaseScope& operator=(const ProfPhaseScope&) = delete;

 private:
  int32_t prev_;
};

// Scoped op publication (op id + WALL base phase for the op's duration);
// the core wraps each collective execution in one.
class ProfOpScope {
 public:
  explicit ProfOpScope(int op_id) {
    ProfThreadState* t = ProfThread();
    prev_op_ = t->op_id.load(std::memory_order_relaxed);
    prev_phase_ = t->phase.load(std::memory_order_relaxed);
    t->op_id.store(op_id, std::memory_order_relaxed);
    t->phase.store(static_cast<int32_t>(PerfPhase::WALL),
                   std::memory_order_relaxed);
  }
  ~ProfOpScope() {
    ProfThreadState* t = ProfThread();
    t->op_id.store(prev_op_, std::memory_order_relaxed);
    t->phase.store(prev_phase_, std::memory_order_relaxed);
  }
  ProfOpScope(const ProfOpScope&) = delete;
  ProfOpScope& operator=(const ProfOpScope&) = delete;

 private:
  int32_t prev_op_;
  int32_t prev_phase_;
};

// Concurrency contract: RegisterThread/UnregisterThread run on the thread
// being sampled (they own its TLS slot and POSIX timer; the registry vector
// is mutex-guarded, cold path). Start/Stop/FoldedJson run from any thread
// (the /profz HTTP handler in practice) — the ring is fetch_add slot claims
// plus relaxed word stores, so concurrent samplers never block and a
// concurrent fold sees torn TAILS (the oldest records mid-overwrite), never
// torn words. Sample() is async-signal-safe: atomic loads/stores and
// range-checked stack reads only. InternOp is background-thread-only, like
// FlightRecorder::InternName.
class SamplingProfiler {
 public:
  SamplingProfiler();
  ~SamplingProfiler();

  // enabled=false turns every other entry point into one branch. hz <= 0
  // keeps the default; capacity <= 0 keeps the default ring size. Call
  // before threads register (the core does this pre-Start).
  HVDTPU_CALLED_ON(background)
  void Configure(bool enabled, int hz, int64_t capacity, ProfClock clock,
                 int rank);
  HVDTPU_CALLED_ON(any)
  bool enabled() const { return enabled_; }
  HVDTPU_CALLED_ON(any)
  int hz() const { return hz_; }
  HVDTPU_CALLED_ON(any)
  ProfClock clock() const { return clock_; }
  HVDTPU_CALLED_ON(any)
  int rank() const { return rank_; }

  // Create (disarmed) this thread's sampling timer and record its stack
  // bounds; arms immediately when a window is running. No-op when disabled
  // or already registered. UnregisterThread must run on the same thread
  // before it exits (the background loop pairs them RAII-style).
  HVDTPU_CALLED_ON(any)
  void RegisterThread();
  HVDTPU_CALLED_ON(any)
  void UnregisterThread();
  HVDTPU_CALLED_ON(any)
  int registered_threads() const EXCLUDES(mu_);

  // Sampling window control. Start clears the ring and arms every
  // registered thread's timer; Stop disarms them. Both idempotent, any
  // thread (/profz, hvd.profile(), the runner's whole-job window).
  HVDTPU_CALLED_ON(background)
  void Start() EXCLUDES(mu_);
  HVDTPU_CALLED_ON(background)
  void Stop() EXCLUDES(mu_);
  HVDTPU_CALLED_ON(any)
  bool running() const {
    return running_.load(std::memory_order_acquire);
  }

  // Total samples ever written this window (ring keeps the newest
  // min(count, capacity)).
  HVDTPU_CALLED_ON(any)
  int64_t sample_count() const {
    return next_.load(std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(any)
  int64_t capacity() const { return cap_; }

  // Intern `name` -> op slot (>= 1; 0 = shared overflow). Background
  // (collective-driving) thread only.
  HVDTPU_CALLED_ON(background)
  int InternOp(const std::string& name);

  // One sample: unwind the interrupted thread's frame-pointer chain and
  // write a record. Called from the SIGPROF handler with the handler's
  // ucontext (leaf pc + frame pointer); async-signal-safe.
  HVDTPU_CALLED_ON(signal)
  void Sample(void* ucontext);

  // Folded-stacks JSON (the /profz payload and hvd.profile()'s return):
  // aggregated {phase, op, frames} -> count, symbolized via dladdr at this
  // point only. Any thread, live (tolerates concurrent samplers).
  HVDTPU_CALLED_ON(any)
  std::string FoldedJson() const;
  // flamegraph.pl-compatible folded lines: "PHASE;op;root;...;leaf N".
  HVDTPU_CALLED_ON(any)
  std::string FoldedText() const;
  // Write FoldedText to `path` (prof.<rank>.folded). False on I/O failure
  // or when disabled.
  HVDTPU_CALLED_ON(any)
  bool WriteFolded(const std::string& path) const;

 private:
  struct Agg;  // fold-time aggregation (profiler.cpp)
  void ArmTimer(ProfThreadState* t, bool arm);
  void FoldInto(Agg* agg) const;

  bool enabled_ = false;
  int hz_ = kProfDefaultHz;
  ProfClock clock_ = ProfClock::CPU;
  int rank_ = 0;
  int64_t cap_ = 0;  // samples in the ring (0 until configured)
  std::unique_ptr<std::atomic<uint64_t>[]> words_;  // cap_ * kProfRecordWords  // atomic: relaxed-counter
  std::atomic<int64_t> next_{0};  // atomic: relaxed-counter
  std::atomic<bool> running_{false};  // atomic: release-publish
  // Interned op names (flight-recorder style publication: fill slot, then
  // release-store the count; readers acquire the count).
  std::unique_ptr<char[]> ops_;  // kProfMaxOps * kProfOpNameBytes
  std::atomic<uint32_t> op_count_{0};  // atomic: release-publish
  std::unordered_map<std::string, int> op_ids_;  // background thread only
  mutable Mutex mu_;
  std::vector<ProfThreadState*> threads_ GUARDED_BY(mu_);
};

// Install the SIGPROF handler once per process (SA_RESTART + SA_SIGINFO).
// The handler samples into the CALLING THREAD's registered profiler
// (ProfThreadState::profiler) — multiple cores in one process (in-process
// test worlds) each sample their own threads.
void InstallProfSignalHandler();

}  // namespace hvdtpu
