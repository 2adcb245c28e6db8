#include "perfstats.h"

#include <algorithm>
#include <cinttypes>
#include <cmath>
#include <cstdio>
#include <cstring>

namespace hvdtpu {

const char* PerfPhaseName(PerfPhase p) {
  switch (p) {
    case PerfPhase::WALL:
      return "wall";
    case PerfPhase::WAIT:
      return "wait";
    case PerfPhase::WIRE:
      return "wire";
    case PerfPhase::REDUCE:
      return "reduce";
    case PerfPhase::CODEC:
      return "codec";
  }
  return "?";
}

// ---------------------------------------------------------------------------
// P² quantile estimator
// ---------------------------------------------------------------------------

void P2Quantile::Observe(double x) {
  if (n_ < 5) {
    // Initial buffer: insert sorted.
    int i = static_cast<int>(n_);
    while (i > 0 && h_[i - 1] > x) {
      h_[i] = h_[i - 1];
      --i;
    }
    h_[i] = x;
    ++n_;
    if (n_ == 5) {
      for (int k = 0; k < 5; ++k) pos_[k] = k + 1;
    }
    return;
  }
  // Find the cell; adjust extreme markers.
  int k;
  if (x < h_[0]) {
    h_[0] = x;
    k = 0;
  } else if (x >= h_[4]) {
    h_[4] = x;
    k = 3;
  } else {
    k = 0;
    while (k < 3 && x >= h_[k + 1]) ++k;
  }
  for (int i = k + 1; i < 5; ++i) pos_[i] += 1;
  ++n_;
  // Desired positions for {min, q/2, q, (1+q)/2, max}.
  const double np1 = static_cast<double>(n_);
  const double want[5] = {1.0, 1.0 + (np1 - 1.0) * q_ / 2.0,
                          1.0 + (np1 - 1.0) * q_,
                          1.0 + (np1 - 1.0) * (1.0 + q_) / 2.0, np1};
  for (int i = 1; i <= 3; ++i) {
    const double d = want[i] - pos_[i];
    if ((d >= 1.0 && pos_[i + 1] - pos_[i] > 1.0) ||
        (d <= -1.0 && pos_[i - 1] - pos_[i] < -1.0)) {
      const double sgn = d >= 0 ? 1.0 : -1.0;
      // Piecewise-parabolic (P²) interpolation; fall back to linear when
      // the parabola would leave the bracketing markers.
      const double qp =
          h_[i] + sgn / (pos_[i + 1] - pos_[i - 1]) *
                      ((pos_[i] - pos_[i - 1] + sgn) * (h_[i + 1] - h_[i]) /
                           (pos_[i + 1] - pos_[i]) +
                       (pos_[i + 1] - pos_[i] - sgn) * (h_[i] - h_[i - 1]) /
                           (pos_[i] - pos_[i - 1]));
      if (h_[i - 1] < qp && qp < h_[i + 1]) {
        h_[i] = qp;
      } else {
        const int j = i + static_cast<int>(sgn);
        h_[i] += sgn * (h_[j] - h_[i]) / (pos_[j] - pos_[i]);
      }
      pos_[i] += sgn;
    }
  }
}

double P2Quantile::Value() const {
  if (n_ == 0) return 0.0;
  if (n_ < 5) {
    // Exact quantile of the sorted initial buffer (nearest-rank).
    const int64_t idx =
        std::min<int64_t>(n_ - 1,
                          static_cast<int64_t>(q_ * static_cast<double>(n_)));
    return h_[idx];
  }
  return h_[2];
}

// ---------------------------------------------------------------------------
// PerfStats
// ---------------------------------------------------------------------------

namespace {

// Writer-side spinlock guard for one slot. Production has a single writer
// (the background loop), so the acquire is one uncontended test-and-set;
// the lock exists to keep explicitly concurrent writers (unit fixtures)
// and the TSan model honest.
class SlotLock {
 public:
  explicit SlotLock(PerfSlot* s) : s_(s) {
    while (s_->lock.test_and_set(std::memory_order_acquire)) {
    }
  }
  ~SlotLock() { s_->lock.clear(std::memory_order_release); }

 private:
  PerfSlot* s_;
};

void InitSlot(PerfSlot* s, const std::string& key) {
  for (int p = 0; p < kPerfPhases; ++p) {
    s->p50[p].Init(0.5);
    s->p99[p].Init(0.99);
  }
  s->key = key;
}

// JSON number: integers render exactly, everything else with enough digits
// to round-trip (same policy as the metrics exposition renderer).
std::string Num(double v) {
  char buf[64];
  if (std::isfinite(v) && v == static_cast<double>(static_cast<int64_t>(v)) &&
      std::abs(v) < 1e15) {
    snprintf(buf, sizeof(buf), "%" PRId64, static_cast<int64_t>(v));
  } else if (!std::isfinite(v)) {
    return "0";  // JSON has no inf/nan; perf stats never produce them anyway
  } else {
    snprintf(buf, sizeof(buf), "%.17g", v);
    double parsed = strtod(buf, nullptr);
    for (int prec = 1; prec < 17; ++prec) {
      char cand[64];
      snprintf(cand, sizeof(cand), "%.*g", prec, v);
      if (strtod(cand, nullptr) == parsed) {
        memcpy(buf, cand, sizeof(cand));
        break;
      }
    }
  }
  return buf;
}

// One phase-indexed JSON object from a published atomic array.
std::string PhaseObj(const std::atomic<double>* vals) {
  std::string out = "{";
  for (int p = 0; p < kPerfPhases; ++p) {
    if (p > 0) out += ", ";
    out += "\"";
    out += PerfPhaseName(static_cast<PerfPhase>(p));
    out += "\": ";
    out += Num(vals[p].load(std::memory_order_relaxed));
  }
  out += "}";
  return out;
}

}  // namespace

// JSON string escape for key signatures (tensor names are user-controlled:
// quotes/backslashes/control bytes must not break the /perfz payload or the
// perf_profile anomaly log core.cpp assembles).
std::string JsonEscapeString(const std::string& s) {
  std::string out = "\"";
  for (char c : s) {
    switch (c) {
      case '"':
        out += "\\\"";
        break;
      case '\\':
        out += "\\\\";
        break;
      case '\n':
        out += "\\n";
        break;
      case '\t':
        out += "\\t";
        break;
      case '\r':
        out += "\\r";
        break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  out += "\"";
  return out;
}

void PerfStats::Configure(bool enabled, double slowdown_pct,
                          int64_t min_samples) {
  enabled_ = enabled;
  slowdown_pct_ = slowdown_pct;
  min_samples_ = min_samples > 0 ? min_samples : 1;
  if (!enabled_) return;
  slots_.reset(new PerfSlot[kPerfMaxKeys]);
  InitSlot(&slots_[0], "<keys-overflowed>");
  key_ids_.clear();
  nslots_.store(1, std::memory_order_release);
  anomalies_total_.store(0, std::memory_order_relaxed);
}

int PerfStats::KeySlot(const std::string& key) {
  if (!enabled_) return 0;
  auto it = key_ids_.find(key);
  if (it != key_ids_.end()) return it->second;
  const int n = nslots_.load(std::memory_order_relaxed);  // atomic-ok: single-writer reads its own count
  if (n >= kPerfMaxKeys) return 0;  // table full: share the overflow slot
  InitSlot(&slots_[n], key);
  nslots_.store(n + 1, std::memory_order_release);  // publish complete slot
  key_ids_.emplace(key, n);
  return n;
}

PerfStats::Anomaly PerfStats::RecordOp(int slot, const OpSample& s) {
  Anomaly a;
  if (!enabled_ || slot < 0 ||
      slot >= nslots_.load(std::memory_order_acquire)) {
    return a;
  }
  PerfSlot* sl = &slots_[slot];
  const double phase_vals[kPerfPhases] = {
      static_cast<double>(s.wall_us), static_cast<double>(s.wait_us),
      static_cast<double>(s.wire_us), static_cast<double>(s.reduce_us),
      static_cast<double>(s.codec_us)};
  SlotLock lk(sl);
  const int64_t n = sl->count.load(std::memory_order_relaxed);

  // Sentry BEFORE the baseline absorbs this sample: a 3x-slower op must be
  // judged against the history, not against itself. The shared overflow
  // slot 0 mixes every key past the table cap into one baseline — a 4KB op
  // judged against 64MB history would fire forever — so it streams stats
  // but never sentries.
  if (slowdown_pct_ > 0 && slot != 0 && n >= min_samples_) {
    const double baseline = sl->ewma[0];
    if (baseline > 0 &&
        phase_vals[0] > baseline * (1.0 + slowdown_pct_ / 100.0)) {
      a.fired = true;
      a.ratio = phase_vals[0] / baseline;
      a.baseline_us = baseline;
      // Dominant phase: largest excess over its own baseline. A slowdown
      // with no phase excess (all buckets at baseline, wall still slow —
      // e.g. a descheduled process) stays attributed to WALL.
      double best = 0;
      for (int p = 1; p < kPerfPhases; ++p) {
        const double excess = phase_vals[p] - sl->ewma[p];
        if (excess > best) {
          best = excess;
          a.phase = static_cast<PerfPhase>(p);
        }
      }
      if (a.phase == PerfPhase::WAIT || a.phase == PerfPhase::WIRE) {
        a.slow_peer = s.slow_peer;
      }
      sl->anomalies.fetch_add(1, std::memory_order_relaxed);
      anomalies_total_.fetch_add(1, std::memory_order_relaxed);
    }
  }

  // Streaming update + publish. EWMA warmup: behave as a running mean for
  // the first samples (a fixed alpha would let the very first op pin the
  // baseline), then settle at alpha = 0.1.
  const double alpha = std::max(0.1, 1.0 / static_cast<double>(n + 1));
  for (int p = 0; p < kPerfPhases; ++p) {
    sl->ewma[p] = n == 0 ? phase_vals[p]
                         : sl->ewma[p] + alpha * (phase_vals[p] - sl->ewma[p]);
    sl->p50[p].Observe(phase_vals[p]);
    sl->p99[p].Observe(phase_vals[p]);
    sl->pub_ewma[p].store(sl->ewma[p], std::memory_order_relaxed);
    sl->pub_p50[p].store(sl->p50[p].Value(), std::memory_order_relaxed);
    sl->pub_p99[p].store(sl->p99[p].Value(), std::memory_order_relaxed);
  }
  sl->samples[n % kPerfSampleRing].store(s.wall_us,
                                         std::memory_order_relaxed);
  sl->last_wall_us.store(s.wall_us, std::memory_order_relaxed);
  sl->count.store(n + 1, std::memory_order_relaxed);
  return a;
}

bool PerfStats::ShouldWarn(int slot, int64_t now_us, int64_t min_gap_us) {
  if (slot < 0 || slot >= nslots_.load(std::memory_order_acquire)) {
    return false;
  }
  PerfSlot* sl = &slots_[slot];
  int64_t last = sl->last_warn_us.load(std::memory_order_relaxed);
  // 0 = never warned: the first anomaly of a key always logs. The CAS
  // claims the window — a concurrent loser sees the fresh stamp and stays
  // quiet.
  while (last == 0 || now_us - last >= min_gap_us) {
    if (sl->last_warn_us.compare_exchange_weak(last, now_us,
                                               std::memory_order_relaxed)) {
      return true;
    }
  }
  return false;
}

std::string PerfStats::SnapshotJson() const {
  std::string out = "{\"version\": 1, \"enabled\": ";
  out += enabled_ ? "true" : "false";
  out += ", \"slowdown_pct\": " + Num(slowdown_pct_);
  out += ", \"min_samples\": " + Num(static_cast<double>(min_samples_));
  out += ", \"anomalies_total\": " +
         Num(static_cast<double>(anomalies_total()));
  out += ", \"keys\": [";
  const int n = slot_count();
  bool first = true;
  for (int i = 0; i < n; ++i) {
    const PerfSlot& sl = slots_[i];
    const int64_t cnt = sl.count.load(std::memory_order_relaxed);
    if (cnt == 0) continue;  // overflow slot (or racing insert) never hit
    if (!first) out += ", ";
    first = false;
    out += "{\"key\": " + JsonEscapeString(sl.key);
    out += ", \"count\": " + Num(static_cast<double>(cnt));
    out += ", \"ewma_us\": " + PhaseObj(sl.pub_ewma);
    out += ", \"p50_us\": " + PhaseObj(sl.pub_p50);
    out += ", \"p99_us\": " + PhaseObj(sl.pub_p99);
    out += ", \"anomalies\": " +
           Num(static_cast<double>(sl.anomalies.load(
               std::memory_order_relaxed)));
    out += ", \"last_wall_us\": " +
           Num(static_cast<double>(sl.last_wall_us.load(
               std::memory_order_relaxed)));
    out += ", \"samples_us\": [";
    const int64_t have = std::min<int64_t>(cnt, kPerfSampleRing);
    for (int64_t k = 0; k < have; ++k) {
      if (k > 0) out += ", ";
      out += Num(static_cast<double>(
          sl.samples[k].load(std::memory_order_relaxed)));
    }
    out += "]}";
  }
  out += "]}";
  return out;
}

}  // namespace hvdtpu
