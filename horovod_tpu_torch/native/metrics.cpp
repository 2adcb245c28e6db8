// Metrics registry implementation: see metrics.h for the concurrency model.

#include "metrics.h"

#include <cassert>
#include <cinttypes>
#include <cmath>
#include <cstdio>
#include <cstring>

namespace hvdtpu {

namespace {

// Render a double the way Prometheus clients do: integers without a decimal
// point, everything else with enough digits to round-trip, +Inf spelled out.
std::string RenderValue(double v) {
  if (std::isinf(v)) return v > 0 ? "+Inf" : "-Inf";
  if (std::isnan(v)) return "NaN";
  if (v == static_cast<int64_t>(v) && std::fabs(v) < 1e15) {
    char buf[32];
    snprintf(buf, sizeof(buf), "%" PRId64, static_cast<int64_t>(v));
    return buf;
  }
  // Shortest representation that round-trips (so bucket bounds render as
  // "0.0004", not "0.00040000000000000002").
  char buf[64];
  for (int prec = 1; prec <= 17; ++prec) {
    snprintf(buf, sizeof(buf), "%.*g", prec, v);
    if (strtod(buf, nullptr) == v) break;
  }
  return buf;
}

std::string EscapeLabelValue(const std::string& v) {
  std::string out;
  out.reserve(v.size());
  for (char c : v) {
    if (c == '\\') out += "\\\\";
    else if (c == '"') out += "\\\"";
    else if (c == '\n') out += "\\n";
    else out += c;
  }
  return out;
}

}  // namespace

std::string RenderLabels(const MetricLabels& labels) {
  if (labels.empty()) return "";
  std::string out = "{";
  bool first = true;
  for (const auto& kv : labels) {
    if (!first) out += ",";
    first = false;
    out += kv.first + "=\"" + EscapeLabelValue(kv.second) + "\"";
  }
  out += "}";
  return out;
}

std::vector<double> LatencyBuckets() {
  // 100 us .. 102 s in x4 steps: wide enough to span a 4 KB shm hop and a
  // stalled multi-GB ring without exceeding 11 buckets per series.
  return {1e-4, 4e-4, 1.6e-3, 6.4e-3, 2.56e-2, 1.024e-1, 4.096e-1, 1.6384,
          6.5536, 26.2144, 104.8576};
}

std::vector<double> BytesBuckets() {
  // 256 B .. 1 GB in x4 steps.
  return {256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304, 16777216,
          67108864, 268435456, 1073741824};
}

Metrics::Family* Metrics::Resolve(const std::string& name,
                                  const std::string& help, Kind kind) {
  auto it = families_.find(name);
  if (it == families_.end()) {
    Family& f = families_[name];
    f.kind = kind;
    f.help = help;
    return &f;
  }
  assert(it->second.kind == kind && "metric re-registered with another type");
  if (it->second.kind != kind) return nullptr;
  return &it->second;
}

Counter* Metrics::GetCounter(const std::string& name, const std::string& help,
                             const MetricLabels& labels) {
  MutexLock lk(mu_);
  Family* f = Resolve(name, help, Kind::COUNTER);
  if (f == nullptr) { static Counter orphan; return &orphan; }
  Series& s = f->series[RenderLabels(labels)];
  if (!s.counter) s.counter.reset(new Counter());
  return s.counter.get();
}

Gauge* Metrics::GetGauge(const std::string& name, const std::string& help,
                         const MetricLabels& labels) {
  MutexLock lk(mu_);
  Family* f = Resolve(name, help, Kind::GAUGE);
  if (f == nullptr) { static Gauge orphan; return &orphan; }
  Series& s = f->series[RenderLabels(labels)];
  if (!s.gauge) s.gauge.reset(new Gauge());
  return s.gauge.get();
}

Histogram* Metrics::GetHistogram(const std::string& name,
                                 const std::string& help,
                                 const std::vector<double>& bounds,
                                 const MetricLabels& labels) {
  MutexLock lk(mu_);
  Family* f = Resolve(name, help, Kind::HISTOGRAM);
  if (f == nullptr) { static Histogram orphan({1.0}); return &orphan; }
  Series& s = f->series[RenderLabels(labels)];
  if (!s.histogram) s.histogram.reset(new Histogram(bounds));
  return s.histogram.get();
}

size_t Metrics::SeriesCount() const {
  MutexLock lk(mu_);
  size_t n = 0;
  for (const auto& kv : families_) n += kv.second.series.size();
  return n;
}

std::string Metrics::Dump() const {
  MutexLock lk(mu_);
  std::string out;
  out.reserve(4096);
  for (const auto& fam : families_) {
    const std::string& name = fam.first;
    const Family& f = fam.second;
    const char* type = f.kind == Kind::COUNTER ? "counter"
                       : f.kind == Kind::GAUGE ? "gauge"
                                               : "histogram";
    out += "# HELP " + name + " " + f.help + "\n";
    out += "# TYPE " + name + " " + std::string(type) + "\n";
    for (const auto& ser : f.series) {
      const std::string& lbl = ser.first;
      const Series& s = ser.second;
      if (f.kind == Kind::COUNTER) {
        out += name + lbl + " " +
               RenderValue(static_cast<double>(s.counter->Get())) + "\n";
      } else if (f.kind == Kind::GAUGE) {
        out += name + lbl + " " + RenderValue(s.gauge->Get()) + "\n";
      } else {
        const Histogram& h = *s.histogram;
        // _bucket series: cumulative counts, le label appended to (inside)
        // the existing label set.
        int64_t cum = 0;
        auto bucket_line = [&](const std::string& le, int64_t count) {
          std::string l = lbl.empty()
                              ? "{le=\"" + le + "\"}"
                              : lbl.substr(0, lbl.size() - 1) + ",le=\"" +
                                    le + "\"}";
          out += name + "_bucket" + l + " " +
                 RenderValue(static_cast<double>(count)) + "\n";
        };
        for (size_t i = 0; i < h.bounds().size(); ++i) {
          cum += h.BucketCount(i);
          bucket_line(RenderValue(h.bounds()[i]), cum);
        }
        cum += h.BucketCount(h.bounds().size());
        bucket_line("+Inf", cum);
        out += name + "_sum" + lbl + " " + RenderValue(h.Sum()) + "\n";
        out += name + "_count" + lbl + " " +
               RenderValue(static_cast<double>(cum)) + "\n";
      }
    }
  }
  return out;
}

}  // namespace hvdtpu
