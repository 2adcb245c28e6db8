// Live-observability metrics registry: counters, gauges, and fixed-bucket
// histograms with Prometheus text exposition.
//
// The reference ships no live-metrics surface at all — its only runtime
// visibility is the post-hoc Chrome-trace timeline (horovod/common/timeline.cc)
// plus log lines. This registry is the rebuild's pull-based replacement: the
// background loop and data plane instrument themselves through it, the C API
// (hvdtpu_metrics_dump) renders the text exposition format, and the Python
// layer serves it over a per-worker /metrics HTTP endpoint
// (horovod_tpu/observability.py) that hvdrun's driver aggregator scrapes.
//
// Concurrency model: metric HANDLES (Counter*/Gauge*/Histogram*) are resolved
// once through the registry (mutex-guarded map insert, cold path) and then
// updated lock-free — plain atomic adds for counters, atomic stores for
// gauges, per-bucket atomic adds + a CAS loop on the double sum for
// histograms. Dump() walks the maps under the registry mutex; readers only
// ever see torn *sets* of metrics (e.g. a count updated before its sum),
// never torn values — the same weak-consistency contract Prometheus client
// libraries give. Handles stay valid for the registry's lifetime (metrics are
// never deleted).
#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// Sorted label set rendered as {k="v",...}. A std::map keeps the rendering
// (and therefore Dump()) deterministic regardless of insertion order.
using MetricLabels = std::map<std::string, std::string>;

class Counter {
 public:
  void Add(int64_t d) { v_.fetch_add(d, std::memory_order_relaxed); }
  void Inc() { Add(1); }
  int64_t Get() const { return v_.load(std::memory_order_relaxed); }

 private:
  std::atomic<int64_t> v_{0};  // atomic: relaxed-counter
};

class Gauge {
 public:
  void Set(double v) { v_.store(v, std::memory_order_relaxed); }
  double Get() const { return v_.load(std::memory_order_relaxed); }

 private:
  std::atomic<double> v_{0.0};  // atomic: relaxed-counter
};

// Fixed-bucket histogram. Bounds are the upper edges of the non-infinite
// buckets (ascending); an implicit +Inf bucket catches the rest. Bucket
// counts are stored per-bucket (not cumulative) and rendered cumulative at
// dump time, Prometheus-style.
class Histogram {
 public:
  explicit Histogram(std::vector<double> bounds)
      : bounds_(std::move(bounds)),
        buckets_(new std::atomic<int64_t>[bounds_.size() + 1]) {
    for (size_t i = 0; i <= bounds_.size(); ++i)
      buckets_[i].store(0, std::memory_order_relaxed);
  }

  void Observe(double v) {
    size_t i = 0;
    while (i < bounds_.size() && v > bounds_[i]) ++i;
    buckets_[i].fetch_add(1, std::memory_order_relaxed);
    // Atomic double accumulation via CAS on the bit pattern (fetch_add on
    // atomic<double> is C++20; this must build as C++17).
    double cur = sum_.load(std::memory_order_relaxed);
    while (!sum_.compare_exchange_weak(cur, cur + v,
                                       std::memory_order_relaxed)) {
    }
  }

  const std::vector<double>& bounds() const { return bounds_; }
  int64_t BucketCount(size_t i) const {
    return buckets_[i].load(std::memory_order_relaxed);
  }
  int64_t Count() const {
    int64_t n = 0;
    for (size_t i = 0; i <= bounds_.size(); ++i) n += BucketCount(i);
    return n;
  }
  double Sum() const { return sum_.load(std::memory_order_relaxed); }

 private:
  std::vector<double> bounds_;
  std::unique_ptr<std::atomic<int64_t>[]> buckets_;  // atomic: relaxed-counter
  std::atomic<double> sum_{0.0};  // atomic: relaxed-counter
};

// Canonical bucket menus for the instrumented subsystems (exponential;
// seconds ones start at poll()'s 1 ms floor territory).
std::vector<double> LatencyBuckets();  // 100us .. ~100s, x4
std::vector<double> BytesBuckets();    // 256B .. 1GB, x4

class Metrics {
 public:
  // Resolve-or-create. `help` is recorded on first creation; the returned
  // handle is stable for the registry's lifetime. Type mismatches on an
  // existing name abort in debug builds and return a fresh unnamed metric
  // otherwise (a programming error, not a runtime condition).
  Counter* GetCounter(const std::string& name, const std::string& help,
                      const MetricLabels& labels = {}) EXCLUDES(mu_);
  Gauge* GetGauge(const std::string& name, const std::string& help,
                  const MetricLabels& labels = {}) EXCLUDES(mu_);
  Histogram* GetHistogram(const std::string& name, const std::string& help,
                          const std::vector<double>& bounds,
                          const MetricLabels& labels = {}) EXCLUDES(mu_);

  // Prometheus text exposition format, version 0.0.4: # HELP / # TYPE lines
  // followed by one sample line per series (histograms expand into
  // cumulative _bucket{le=...} + _sum + _count). Deterministic: families
  // sorted by name, series by label string.
  std::string Dump() const EXCLUDES(mu_);

  // Number of distinct (name, labels) series — bounds cardinality in tests.
  size_t SeriesCount() const EXCLUDES(mu_);

 private:
  enum class Kind { COUNTER, GAUGE, HISTOGRAM };
  struct Series {
    std::unique_ptr<Counter> counter;
    std::unique_ptr<Gauge> gauge;
    std::unique_ptr<Histogram> histogram;
  };
  struct Family {
    Kind kind = Kind::COUNTER;
    std::string help;
    std::map<std::string, Series> series;  // key: rendered label string
  };

  Family* Resolve(const std::string& name, const std::string& help,
                  Kind kind) REQUIRES(mu_);

  mutable Mutex mu_;
  std::map<std::string, Family> families_ GUARDED_BY(mu_);
};

// {k="v",k2="v2"} (empty string for no labels). Values are escaped per the
// exposition format (backslash, double-quote, newline).
std::string RenderLabels(const MetricLabels& labels);

}  // namespace hvdtpu
