// Numerical-health observability: in-band gradient + compression-quality
// telemetry (docs/numerics.md).
//
// PRs 4-11 built a complete *systems* observability stack (metrics, traces,
// flight recorder, perf attribution, profiler); this subsystem is the first
// one that watches the MODEL rather than the machine. Three signals, all
// fed from existing data-plane touch points at near-zero extra cost:
//
//  * Gradient moments — L2 norm, absmax, NaN/Inf counts — computed in the
//    SAME pass as the fusion copy-in (CopyMomentsF32 fuses the scan into
//    the copy; AppendCopyMomentsF32 cache-blocks it against a vector
//    append, so the extra read comes from L2, not DRAM), streamed into
//    per-tensor EWMA baselines.
//  * Quantization quality — MSE and SNR of every compressed hop vs the
//    pre-quantized values, accumulated INSIDE the quantize kernels
//    (compressed.cpp already computes the dequantized value for error
//    feedback; the accumulation is two FMAs per lane), plus the
//    error-feedback residual norm — EQuARX (arxiv 2506.17615) shows
//    quantized-allreduce quality must be measured per-layer to be tuned
//    safely, and residual blowup is visible here before the loss diverges.
//  * Cross-rank divergence — every HVDTPU_GRADCHECK_SAMPLE-th op each rank
//    fingerprints its post-allreduce output (Crc32c below) and reports it
//    to rank 0 through a piggybacked control-plane frame; any mismatch is
//    silent data corruption or non-determinism (upstream Horovod, arxiv
//    1802.05799, ASSUMES bitwise-identical outputs and never verifies).
//
// On top of the moments sits the non-finite sentinel: the first NaN/Inf
// gradient emits a NONFINITE flight-recorder event naming tensor + rank,
// bumps hvdtpu_nonfinite_grads_total, and under HVDTPU_NANCHECK=abort
// fail-fasts the job with the tensor named in the post-mortem verdict.
//
// Surfaces: hvdtpu_gradstats_snapshot C API -> hvd.grad_report() / the
// /gradz endpoint (decoded by horovod_tpu/gradstats.py), per-rank
// grad_profile.<rank>.json at shutdown for scripts/grad_diff.py, NAN/DIV
// flags + worst-SNR readout in `hvdrun --top`.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "thread_roles.h"

namespace hvdtpu {

enum class WireCompression : int32_t;  // compressed.h

// HVDTPU_NANCHECK policy. Mirrored in horovod_tpu/gradstats.py
// NAN_POLICIES (scripts/check_invariants.py ENUM-MIRROR).
enum class NanPolicy : int32_t {
  OFF = 0,    // moments still stream; non-finite values are not flagged
  WARN = 1,   // flight event + counter + WARN, op proceeds (default)
  ABORT = 2,  // fail-fast: the op errors, the world breaks, forensics dump
};

// Numerical-health event kinds (the /gradz event log's `kind` codes and
// the grad-profile event records). Mirrored in horovod_tpu/gradstats.py
// GRAD_EVENTS (scripts/check_invariants.py ENUM-MIRROR).
enum class GradEvent : int32_t {
  NONFINITE = 0,       // NaN/Inf gradient elements seen at fusion copy-in
  DIVERGENCE = 1,      // cross-rank fingerprint mismatch (SDC sentinel)
  RESIDUAL_RESET = 2,  // error-feedback residual dropped (reshape/overflow)
};

const char* NanPolicyName(NanPolicy p);

// CRC32C (Castagnoli), the fingerprint the divergence probe compares
// across ranks: hardware SSE4.2 CRC32 instruction when the CPU has it
// (~20 GB/s), software slice-by-8 otherwise. seed lets callers chain.
uint32_t Crc32c(const void* data, size_t len, uint32_t seed = 0);

// One-pass moments of an fp32 gradient buffer. sumsq/absmax accumulate
// FINITE lanes only (one NaN must not erase the norm of the other 16M
// elements); NaN and Inf lanes are counted instead.
struct GradMoments {
  double sumsq = 0;
  double absmax = 0;
  int64_t nonfinite = 0;  // NaN + Inf elements
  int64_t count = 0;

  HVDTPU_CALLED_ON(background)
  void Merge(const GradMoments& o) {
    sumsq += o.sumsq;
    if (o.absmax > absmax) absmax = o.absmax;
    nonfinite += o.nonfinite;
    count += o.count;
  }
};

// Scan `count` floats into *m (AVX2 when available; += semantics so callers
// can accumulate across blocks).
void MomentsF32(const float* src, int64_t count, GradMoments* m);
// Fused copy + scan: dst[i] = src[i] while accumulating moments — the
// scan rides the load the copy already does, with REGULAR stores at
// every size (a streaming-store variant was rejected by the paired A/B:
// the collective re-reads this buffer right after the copy-in, and NT
// stores cost 13-25% of the op in post-copy misses; BENCH_r10.json).
void CopyMomentsF32(float* dst, const float* src, int64_t count,
                    GradMoments* m);

// Quantization-quality accumulator one compressed op carries through its
// WireCompress calls (compressed.cpp): err2 = sum (x - dequantized)^2 over
// every quantized element (x = gradient + error-feedback residual), sig2 =
// sum x^2. MSE = err2/count, SNR = 10*log10(sig2/err2). Because error
// feedback stores exactly x - dequantized back into the residual, err2 IS
// the post-op ResidualStore content for these elements: sqrt(err2) is the
// residual norm the blowup sentinel watches.
struct GradQuality {
  double err2 = 0;
  double sig2 = 0;
  int64_t count = 0;

  HVDTPU_CALLED_ON(background)
  void Reset() {
    err2 = 0;
    sig2 = 0;
    count = 0;
  }
};

// Streaming keyed-statistics sizing, same rationale as perfstats.h: keys
// past the cap share the overflow slot 0 so the hot path never allocates.
constexpr int kGradMaxKeys = 256;

// One key's numerical-health state. Same concurrency contract as PerfSlot
// (perfstats.h): writer fields behind a per-slot spinlock, published fields
// relaxed atomics any thread may read mid-update (torn SETS, never torn
// values).
struct GradSlot {
  // Writer-owned (guarded by lock).
  double ewma_norm = 0;
  double ewma_snr_db = 0;
  std::atomic_flag lock = ATOMIC_FLAG_INIT;

  // Published, lock-free readable.
  std::atomic<int64_t> count{0};  // atomic: relaxed-counter
  std::atomic<double> pub_norm{0};       // last L2 norm  // atomic: relaxed-counter
  std::atomic<double> pub_ewma_norm{0};  // EWMA of the norm  // atomic: relaxed-counter
  std::atomic<double> pub_absmax{0};     // last absmax  // atomic: relaxed-counter
  std::atomic<int64_t> nonfinite{0};     // cumulative NaN/Inf elements  // atomic: relaxed-counter
  // Quantization quality (zero q_count = never compressed: dense layer or
  // skip-regex match — the /gradz report omits SNR for these).
  std::atomic<int64_t> q_count{0};  // atomic: relaxed-counter
  std::atomic<double> pub_mse{0};  // atomic: relaxed-counter
  std::atomic<double> pub_snr_db{0};  // atomic: relaxed-counter
  std::atomic<double> pub_ewma_snr_db{0};  // atomic: relaxed-counter
  std::atomic<double> pub_res_norm{0};  // post-op EF residual norm  // atomic: relaxed-counter
  std::atomic<int32_t> comp{0};         // last WireCompression code  // atomic: relaxed-counter
  // NONFINITE WARN/flight-event throttle stamp (steady us; 0 = never).
  // Same per-key CAS window as PerfSlot::last_warn_us: a tensor that went
  // NaN floods hundreds of ops per second, and an unthrottled event per
  // op would evict the op/hop records a post-mortem needs from the
  // flight ring. The counters stay exact; only the log + ring ride this.
  std::atomic<int64_t> last_warn_us{0};  // atomic: relaxed-counter

  std::string key;  // immutable once the slot is published
};

class GradStats {
 public:
  // enabled=false turns every Record* into one branch. sample_n is the
  // divergence probe's every-Nth-op rate (0 disables the probe; moments
  // and quality still stream). Call before the background loop starts.
  HVDTPU_CALLED_ON(background)
  void Configure(bool enabled, NanPolicy policy, int64_t sample_n);
  HVDTPU_CALLED_ON(any)
  bool enabled() const { return enabled_; }
  HVDTPU_CALLED_ON(any)
  NanPolicy nan_policy() const { return policy_; }
  HVDTPU_CALLED_ON(any)
  int64_t gradcheck_sample() const { return sample_n_; }

  // Intern `key` -> slot id (>= 1; 0 = the shared overflow slot once the
  // table fills). Background (collective-driving) thread only, like
  // PerfStats::KeySlot.
  HVDTPU_CALLED_ON(background)
  int KeySlot(const std::string& key);

  // Record one tensor's copy-in moments against `slot`. Thread-safe
  // (per-slot spinlock); no allocation.
  HVDTPU_CALLED_ON(background)
  void RecordMoments(int slot, const GradMoments& m);

  // Record one compressed op's quantization quality against `slot`.
  HVDTPU_CALLED_ON(background)
  void RecordQuality(int slot, WireCompression c, const GradQuality& q);

  // Per-key throttle for the NONFINITE WARN + flight record: true at most
  // once per min_gap_us per slot (the first event of a key always
  // passes). CAS on the slot's stamp — thread-safe, one winner.
  HVDTPU_CALLED_ON(background)
  bool ShouldWarnNonfinite(int slot, int64_t now_us,
                           int64_t min_gap_us = 1000000);

  // Cumulative event counters (the snapshot's totals; the matching
  // Prometheus counters live in the core's registry).
  HVDTPU_CALLED_ON(background)
  void NoteNonfinite(int64_t elements) {
    nonfinite_total_.fetch_add(elements, std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(background)
  void NoteProbe() { probes_total_.fetch_add(1, std::memory_order_relaxed); }
  HVDTPU_CALLED_ON(background)
  void NoteDivergence() {
    divergence_total_.fetch_add(1, std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(background)
  void NoteResidualReset() {
    residual_resets_total_.fetch_add(1, std::memory_order_relaxed);
  }

  HVDTPU_CALLED_ON(any)
  int64_t nonfinite_total() const {
    return nonfinite_total_.load(std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(any)
  int64_t probes_total() const {
    return probes_total_.load(std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(any)
  int64_t divergence_total() const {
    return divergence_total_.load(std::memory_order_relaxed);
  }
  HVDTPU_CALLED_ON(any)
  int64_t residual_resets_total() const {
    return residual_resets_total_.load(std::memory_order_relaxed);
  }

  // Keyed-health snapshot as JSON (the /gradz payload and the body of
  // grad_profile.<rank>.json). Readers touch atomics + immutable keys only
  // — callable from any thread while writers run.
  HVDTPU_CALLED_ON(any)
  std::string SnapshotJson() const;

  HVDTPU_CALLED_ON(any)
  int slot_count() const { return nslots_.load(std::memory_order_acquire); }
  HVDTPU_CALLED_ON(any)
  const GradSlot* slot(int i) const {  // tests/introspection
    return i >= 0 && i < slot_count() ? &slots_[i] : nullptr;
  }

 private:
  bool enabled_ = false;
  NanPolicy policy_ = NanPolicy::WARN;
  int64_t sample_n_ = 0;
  std::unique_ptr<GradSlot[]> slots_;
  std::atomic<int> nslots_{0};  // atomic: release-publish
  std::unordered_map<std::string, int> key_ids_;  // background thread only
  std::atomic<int64_t> nonfinite_total_{0};  // atomic: relaxed-counter
  std::atomic<int64_t> probes_total_{0};  // atomic: relaxed-counter
  std::atomic<int64_t> divergence_total_{0};  // atomic: relaxed-counter
  std::atomic<int64_t> residual_resets_total_{0};  // atomic: relaxed-counter
};

}  // namespace hvdtpu
