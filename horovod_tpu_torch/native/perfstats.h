// Always-on perf attribution: streaming per-op baselines + slowdown sentry
// (docs/observability.md "Live perf attribution").
//
// The sampled tracing layer (tracing.h) explains a slow op AFTER the fact
// and only for every Nth op; the flight recorder (flightrec.h) explains a
// DEAD job. This subsystem watches performance continuously while the job
// runs: unsampled, allocation-free streaming statistics — EWMA plus
// P²-style p50/p99 estimators — of op wall time and of the wait / wire /
// reduce / codec phase buckets, keyed by {tensor-set signature, algo,
// transport, hier, compression, op}. The phase buckets come from the SAME
// IoControl wait accounting and hop/reduce/quantize instrumentation points
// the flight recorder already proved fit the <2% observability budget at
// every-op granularity (DataPlane::TraceHop accumulates them per op).
//
// On top of the baselines sits the slowdown sentry: each completed op is
// compared against its key's rolling baseline, and past
// HVDTPU_PERF_SLOWDOWN_PCT the core emits an ANOMALY flight-recorder event
// plus a hvdtpu_perf_anomalies_total{phase=...} counter naming the dominant
// phase (and, for wire-slow ops, the slowest hop peer). Snapshots are JSON
// (hvdtpu_perfstats_snapshot C API -> hvd.perf_report() / the /perfz
// endpoint, decoded by horovod_tpu/perfstats.py), and each job can persist
// its per-key baselines as perf_profile.<rank>.json at shutdown for the
// cross-run regression sentry (scripts/perf_diff.py).
//
// Reference analog: none — upstream Horovod's timeline-driven tuning
// workflow (arxiv 1802.05799) and the 1810.11112 characterization do this
// analysis offline, by hand; here it is live and machine-checkable.
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>

#include "thread_roles.h"

namespace hvdtpu {

// Phase buckets the streaming statistics track per key. Mirrored in
// horovod_tpu/perfstats.py PERF_PHASES (scripts/check_invariants.py
// ENUM-MIRROR): the codes cross the C++/Python boundary inside the /perfz
// JSON and the ANOMALY flight record's arg word.
enum class PerfPhase : int32_t {
  WALL = 0,    // whole-op wall time (the baseline the sentry compares)
  WAIT = 1,    // blocked on a peer (sliced polls, futex waits, zc drains)
  WIRE = 2,    // hop time actually moving bytes (hop duration - wait)
  REDUCE = 3,  // reduction kernels
  CODEC = 4,   // wire-compression quantize/dequantize
};
constexpr int kPerfPhases = 5;

const char* PerfPhaseName(PerfPhase p);

// Quote + escape `s` as a JSON string literal (quotes, backslashes, control
// bytes). Shared by the snapshot renderer and the anomaly log the core
// assembles into perf_profile.<rank>.json — tensor names are user-controlled
// and must not corrupt either payload.
std::string JsonEscapeString(const std::string& s);

// Streaming keyed-statistics sizing: a training job's steady state is a few
// dozen (fused tensor-set x parameter) combinations; keys past the cap
// share the overflow slot 0 so the hot path never allocates.
constexpr int kPerfMaxKeys = 256;
// Recent raw wall-time samples kept per key (ring): what perf_diff.py
// bootstraps its cross-run confidence intervals on.
constexpr int kPerfSampleRing = 64;

// P² single-quantile estimator (Jain & Chlamtac 1985): five markers track a
// running quantile in O(1) memory with no sample buffer — the classic
// streaming-quantile fit for an allocation-free hot path. Single writer;
// readers see the published value through PerfStats' atomics, never this.
class P2Quantile {
 public:
  HVDTPU_CALLED_ON(background)
  void Init(double q) {
    q_ = q;
    n_ = 0;
  }
  HVDTPU_CALLED_ON(background)
  void Observe(double x);
  // Current estimate: exact while n < 5 (sorted initial buffer), the P²
  // middle marker after.
  HVDTPU_CALLED_ON(any)
  double Value() const;
  HVDTPU_CALLED_ON(any)
  int64_t count() const { return n_; }

 private:
  double q_ = 0.5;
  int64_t n_ = 0;
  double h_[5] = {0};  // marker heights
  double pos_[5] = {0};  // marker positions (1-based)
};

// One key's streaming state. Writer fields are guarded by a per-slot
// spinlock (writers are the background loop in production — effectively
// uncontended — but the lock keeps explicitly concurrent writers, like the
// TSan unit fixture, correct). Published fields are relaxed atomics any
// thread may read mid-update: readers see torn SETS (a count newer than its
// p99), never torn values — the metrics registry's weak-consistency
// contract.
struct PerfSlot {
  // Writer-owned estimator state (guarded by lock).
  P2Quantile p50[kPerfPhases];
  P2Quantile p99[kPerfPhases];
  double ewma[kPerfPhases] = {0};
  std::atomic_flag lock = ATOMIC_FLAG_INIT;

  // Published, lock-free readable.
  std::atomic<int64_t> count{0};  // atomic: relaxed-counter
  std::atomic<double> pub_ewma[kPerfPhases] = {};  // atomic: relaxed-counter
  std::atomic<double> pub_p50[kPerfPhases] = {};  // atomic: relaxed-counter
  std::atomic<double> pub_p99[kPerfPhases] = {};  // atomic: relaxed-counter
  std::atomic<int64_t> anomalies{0};  // atomic: relaxed-counter
  std::atomic<int64_t> last_wall_us{0};  // atomic: relaxed-counter
  std::atomic<int64_t> samples[kPerfSampleRing] = {};  // atomic: relaxed-counter
  // Sentry WARN throttle stamp, PER KEY (steady-clock us; 0 = never
  // warned). A global 1/s throttle let one chatty slow key starve the
  // first warning for a second, different key — the operator's "rank N
  // just went codec-bound" signal. CAS-claimed so concurrent writers
  // (the TSan fixture) warn at most once per window per key.
  std::atomic<int64_t> last_warn_us{0};  // atomic: relaxed-counter

  std::string key;  // immutable once the slot is published
};

class PerfStats {
 public:
  // enabled=false turns RecordOp into one branch. slowdown_pct <= 0
  // disables the sentry (baselines still stream); min_samples is the
  // per-key warmup before the sentry may fire. Call before the background
  // loop starts.
  HVDTPU_CALLED_ON(background)
  void Configure(bool enabled, double slowdown_pct, int64_t min_samples);
  HVDTPU_CALLED_ON(any)
  bool enabled() const { return enabled_; }
  HVDTPU_CALLED_ON(any)
  double slowdown_pct() const { return slowdown_pct_; }
  HVDTPU_CALLED_ON(any)
  int64_t min_samples() const { return min_samples_; }

  // Intern `key` -> slot id (>= 1; 0 = the shared overflow slot once the
  // table fills). Background (collective-driving) thread only — it owns
  // the lookup map, like FlightRecorder::InternName. The slot itself is
  // release-published so snapshot readers only see complete entries.
  HVDTPU_CALLED_ON(background)
  int KeySlot(const std::string& key);

  struct OpSample {
    int64_t wall_us = 0;
    int64_t wait_us = 0;
    int64_t wire_us = 0;
    int64_t reduce_us = 0;
    int64_t codec_us = 0;
    int slow_peer = -1;  // hop peer with the most wait this op (-1 none)
  };
  struct Anomaly {
    bool fired = false;
    PerfPhase phase = PerfPhase::WALL;  // dominant phase of the excess
    double ratio = 1.0;                 // wall / baseline
    double baseline_us = 0.0;
    int slow_peer = -1;  // meaningful when phase is WAIT/WIRE
  };

  // Record one completed op against `slot` and run the sentry: fires once
  // the slot has min_samples and wall exceeds its EWMA baseline by
  // slowdown_pct. The overflow slot 0 streams stats but never sentries
  // (its baseline mixes unrelated keys). Thread-safe (per-slot spinlock);
  // no allocation.
  HVDTPU_CALLED_ON(background)
  Anomaly RecordOp(int slot, const OpSample& s);

  // Per-key WARN throttle for the sentry's log line: true at most once per
  // min_gap_us PER SLOT (each key gets its own window — a chatty slow key
  // cannot starve a different key's first warning). The counter and flight
  // ring record every anomaly regardless; only the LOG rides this. CAS on
  // the slot's stamp, so it is thread-safe and claims exactly one winner.
  HVDTPU_CALLED_ON(background)
  bool ShouldWarn(int slot, int64_t now_us,
                  int64_t min_gap_us = 1000000);

  // Keyed-baseline snapshot as JSON (the /perfz payload and the body of
  // perf_profile.<rank>.json). Readers touch atomics + immutable keys only
  // — callable from any thread while writers run.
  HVDTPU_CALLED_ON(any)
  std::string SnapshotJson() const;

  HVDTPU_CALLED_ON(any)
  int slot_count() const {
    return nslots_.load(std::memory_order_acquire);
  }
  HVDTPU_CALLED_ON(any)
  int64_t anomalies_total() const {
    return anomalies_total_.load(std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(any)
  const PerfSlot* slot(int i) const {  // tests/introspection
    return i >= 0 && i < slot_count() ? &slots_[i] : nullptr;
  }

 private:
  bool enabled_ = false;
  double slowdown_pct_ = 50.0;
  int64_t min_samples_ = 20;
  std::unique_ptr<PerfSlot[]> slots_;
  std::atomic<int> nslots_{0};  // atomic: release-publish
  std::unordered_map<std::string, int> key_ids_;  // background thread only
  std::atomic<int64_t> anomalies_total_{0};  // atomic: relaxed-counter
};

}  // namespace hvdtpu
