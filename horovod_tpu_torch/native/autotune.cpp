#include "autotune.h"

#include <algorithm>
#include <cmath>

namespace hvdtpu {

// ---------------------------------------------------------------------------
// GaussianProcess
// ---------------------------------------------------------------------------

double GaussianProcess::Kernel(const std::vector<double>& a,
                               const std::vector<double>& b) const {
  double d2 = 0.0;
  for (size_t i = 0; i < a.size(); ++i) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return std::exp(-d2 / (2.0 * length_scale_ * length_scale_));
}

void GaussianProcess::Fit(const std::vector<std::vector<double>>& x,
                          const std::vector<double>& y) {
  n_ = x.size();
  x_ = x;
  fitted_ = false;
  if (n_ == 0) return;

  // Standardize targets so the unit-variance kernel prior fits.
  y_mean_ = 0.0;
  for (double v : y) y_mean_ += v;
  y_mean_ /= static_cast<double>(n_);
  double var = 0.0;
  for (double v : y) var += (v - y_mean_) * (v - y_mean_);
  y_std_ = n_ > 1 ? std::sqrt(var / static_cast<double>(n_)) : 1.0;
  if (y_std_ < 1e-12) y_std_ = 1.0;

  // K + noise I, then its Cholesky factor L (n is tens at most).
  std::vector<double> k(n_ * n_);
  for (size_t i = 0; i < n_; ++i) {
    for (size_t j = 0; j < n_; ++j) {
      k[i * n_ + j] = Kernel(x_[i], x_[j]) + (i == j ? noise_ : 0.0);
    }
  }
  chol_.assign(n_ * n_, 0.0);
  for (size_t i = 0; i < n_; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      double s = k[i * n_ + j];
      for (size_t m = 0; m < j; ++m) s -= chol_[i * n_ + m] * chol_[j * n_ + m];
      if (i == j) {
        if (s <= 0) s = 1e-12;
        chol_[i * n_ + i] = std::sqrt(s);
      } else {
        chol_[i * n_ + j] = s / chol_[j * n_ + j];
      }
    }
  }

  // alpha = K^-1 y_std  via two triangular solves.
  std::vector<double> z(n_);
  for (size_t i = 0; i < n_; ++i) {
    double s = (y[i] - y_mean_) / y_std_;
    for (size_t m = 0; m < i; ++m) s -= chol_[i * n_ + m] * z[m];
    z[i] = s / chol_[i * n_ + i];
  }
  alpha_.assign(n_, 0.0);
  for (size_t ii = n_; ii-- > 0;) {
    double s = z[ii];
    for (size_t m = ii + 1; m < n_; ++m) s -= chol_[m * n_ + ii] * alpha_[m];
    alpha_[ii] = s / chol_[ii * n_ + ii];
  }
  fitted_ = true;
}

void GaussianProcess::Predict(const std::vector<double>& x, double* mu,
                              double* sigma) const {
  if (!fitted_) {
    *mu = 0.0;
    *sigma = 1.0;
    return;
  }
  std::vector<double> ks(n_);
  for (size_t i = 0; i < n_; ++i) ks[i] = Kernel(x, x_[i]);
  double m = 0.0;
  for (size_t i = 0; i < n_; ++i) m += ks[i] * alpha_[i];
  // v = L^-1 ks; var = k(x,x) - v.v
  std::vector<double> v(n_);
  for (size_t i = 0; i < n_; ++i) {
    double s = ks[i];
    for (size_t j = 0; j < i; ++j) s -= chol_[i * n_ + j] * v[j];
    v[i] = s / chol_[i * n_ + i];
  }
  double var = Kernel(x, x);
  for (size_t i = 0; i < n_; ++i) var -= v[i] * v[i];
  if (var < 1e-12) var = 1e-12;
  *mu = m * y_std_ + y_mean_;
  *sigma = std::sqrt(var) * y_std_;
}

// ---------------------------------------------------------------------------
// BayesianOptimizer
// ---------------------------------------------------------------------------

namespace {

double NormCdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }
double NormPdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

}  // namespace

void BayesianOptimizer::AddSample(const std::vector<double>& x, double y) {
  xs_.push_back(x);
  ys_.push_back(y);
  gp_.Fit(xs_, ys_);
}

std::vector<double> BayesianOptimizer::BestSample() const {
  size_t best = 0;
  for (size_t i = 1; i < ys_.size(); ++i) {
    if (ys_[i] > ys_[best]) best = i;
  }
  return xs_.empty() ? std::vector<double>(dim_, 0.5) : xs_[best];
}

std::vector<double> BayesianOptimizer::NextSample() {
  if (xs_.empty()) return std::vector<double>(dim_, 0.5);
  double y_best = *std::max_element(ys_.begin(), ys_.end());
  const double xi = 0.01;  // exploration margin (reference uses the same form)

  std::vector<double> best_x(dim_, 0.5);
  double best_ei = -1.0;
  // Deterministic candidate sweep: identical on every rank given the same
  // samples, so no cross-rank disagreement is possible even if workers ran it.
  const int kCandidates = 512;
  for (int c = 0; c < kCandidates; ++c) {
    std::vector<double> x(dim_);
    for (int d = 0; d < dim_; ++d) {
      rng_ = rng_ * 6364136223846793005ull + 1442695040888963407ull;
      x[d] = static_cast<double>((rng_ >> 11) & 0xfffff) / 1048575.0;
    }
    double mu, sigma;
    gp_.Predict(x, &mu, &sigma);
    double z = (mu - y_best - xi) / sigma;
    double ei = (mu - y_best - xi) * NormCdf(z) + sigma * NormPdf(z);
    if (ei > best_ei) {
      best_ei = ei;
      best_x = x;
    }
  }
  return best_x;
}

// ---------------------------------------------------------------------------
// ParameterManager
// ---------------------------------------------------------------------------

namespace {

// Tuning ranges, log-scale (reference tunes fusion in [0, 64 MB] linear and
// cycle in [1, 25] ms multiples-of-5; log-scale covers the same span with
// better resolution at the low end that matters for latency).
constexpr double kCycleMinMs = 0.5, kCycleMaxMs = 50.0;
constexpr double kFusionMin = 1 << 20, kFusionMax = 256u << 20;
// Allreduce algorithm crossover (data_plane.h): recursive doubling below,
// pipelined ring above. Log-scale 4 KB .. 4 MB.
constexpr double kCrossMin = 4 << 10, kCrossMax = 4 << 20;

double FromUnit(double u, double lo, double hi) {
  return lo * std::pow(hi / lo, u);
}
double ToUnit(double v, double lo, double hi) {
  v = std::min(std::max(v, lo), hi);
  return std::log(v / lo) / std::log(hi / lo);
}

}  // namespace

void ParameterManager::Initialize(double cycle_time_ms,
                                  int64_t fusion_threshold, bool cache_enabled,
                                  int64_t algo_crossover, bool tune_crossover,
                                  bool sa_enabled, bool tune_sa,
                                  bool hier_enabled, bool tune_hier,
                                  int32_t wire_compression,
                                  bool tune_compression,
                                  const std::string& log_path,
                                  int warmup_samples, int cycles_per_sample,
                                  int max_samples, double gp_noise) {
  current_ = {cycle_time_ms, fusion_threshold, cache_enabled, algo_crossover,
              sa_enabled, hier_enabled, wire_compression};
  tune_crossover_ = tune_crossover;
  tune_sa_ = tune_sa;
  tune_hier_ = tune_hier;
  tune_compression_ = tune_compression;
  warmup_samples_ = warmup_samples;
  warmup_left_ = warmup_samples;
  cycles_per_sample_ = cycles_per_sample;
  max_samples_ = max_samples;
  opt_ = BayesianOptimizer(3 + (tune_crossover ? 1 : 0) + (tune_sa ? 1 : 0) +
                               (tune_hier ? 1 : 0) + (tune_compression ? 1 : 0),
                           gp_noise);
  if (!log_path.empty()) {
    log_ = fopen(log_path.c_str(), "w");
    if (log_ != nullptr) {
      fputs("cycle_time_ms,fusion_threshold_bytes,cache_enabled,"
            "algo_crossover_bytes,sa_enabled,hier_enabled,wire_compression,"
            "score_bytes_per_sec\n",
            log_);
    }
  }
  active_ = true;
  frozen_ = false;
  cycle_count_ = 0;
  bytes_acc_ = 0;
  sample_start_ = 0.0;
}

ParameterManager::~ParameterManager() {
  if (log_ != nullptr) fclose(log_);
}

std::vector<double> ParameterManager::ToVector(const Params& p) const {
  // Dim 2 is the categorical cache switch: a {0,1}-valued coordinate the
  // candidate sweep explores continuously and SetFromVector thresholds
  // (the GP analog of the reference's CategoricalParameter).
  std::vector<double> x = {
      ToUnit(p.cycle_time_ms, kCycleMinMs, kCycleMaxMs),
      ToUnit(static_cast<double>(p.fusion_threshold), kFusionMin, kFusionMax),
      p.cache_enabled ? 1.0 : 0.0};
  if (tune_crossover_) {
    x.push_back(
        ToUnit(static_cast<double>(p.algo_crossover), kCrossMin, kCrossMax));
  }
  if (tune_sa_) x.push_back(p.sa_enabled ? 1.0 : 0.0);
  if (tune_hier_) x.push_back(p.hier_enabled ? 1.0 : 0.0);
  if (tune_compression_) {
    // 3-way categorical {none, fp16, int8} mapped onto [0, 1] at
    // {0, 0.5, 1}; the sweep explores continuously, SetFromVector rounds.
    x.push_back(static_cast<double>(p.wire_compression) / 2.0);
  }
  return x;
}

void ParameterManager::SetFromVector(const std::vector<double>& x) {
  current_.cycle_time_ms = FromUnit(x[0], kCycleMinMs, kCycleMaxMs);
  // llround, not truncation: FromUnit(ToUnit(v)) can land at v - 1e-7 and
  // a truncating cast would log the frozen best point one byte off the
  // sampled row it was chosen from.
  current_.fusion_threshold =
      static_cast<int64_t>(std::llround(FromUnit(x[1], kFusionMin,
                                                 kFusionMax)));
  current_.cache_enabled = x[2] >= 0.5;
  size_t next = 3;
  if (tune_crossover_ && x.size() > next) {
    current_.algo_crossover = static_cast<int64_t>(
        std::llround(FromUnit(x[next], kCrossMin, kCrossMax)));
    ++next;
  }
  if (tune_sa_ && x.size() > next) {
    // Categorical like the cache switch: big-message AUTO dispatch prefers
    // scatter-allgather when on, the pipelined ring when off.
    current_.sa_enabled = x[next] >= 0.5;
    ++next;
  }
  if (tune_hier_ && x.size() > next) {
    // Categorical like the cache switch: explored continuously, thresholded
    // here (reference: CategoricalParameter, parameter_manager.h:225).
    current_.hier_enabled = x[next] >= 0.5;
    ++next;
  }
  if (tune_compression_ && x.size() > next) {
    int32_t comp = static_cast<int32_t>(std::llround(x[next] * 2.0));
    if (comp < 0) comp = 0;
    if (comp > 2) comp = 2;
    current_.wire_compression = comp;  // 0 none, 1 fp16, 2 int8
  }
}

void ParameterManager::LogSample(double score) {
  if (log_ == nullptr) return;
  fprintf(log_, "%.3f,%lld,%d,%lld,%d,%d,%d,%.1f\n", current_.cycle_time_ms,
          static_cast<long long>(current_.fusion_threshold),
          current_.cache_enabled ? 1 : 0,
          static_cast<long long>(current_.algo_crossover),
          current_.sa_enabled ? 1 : 0, current_.hier_enabled ? 1 : 0,
          static_cast<int>(current_.wire_compression), score);
  fflush(log_);
}

bool ParameterManager::Update(int64_t bytes, double now_secs) {
  if (!active_ || frozen_) return false;
  if (sample_start_ == 0.0) sample_start_ = now_secs;
  bytes_acc_ += bytes;
  if (++cycle_count_ < cycles_per_sample_) return false;

  double elapsed = now_secs - sample_start_;
  double score = elapsed > 0 ? static_cast<double>(bytes_acc_) / elapsed : 0;
  cycle_count_ = 0;
  bytes_acc_ = 0;
  sample_start_ = now_secs;

  if (warmup_left_ > 0) {
    // Reference: discard warmup samples (still-compiling / cold caches).
    --warmup_left_;
    return false;
  }

  // Median-of-N scoring per tuning step: single samples are noisy (one
  // GC pause or burst skews bytes/sec), and the GP fit amplifies outliers.
  step_scores_.push_back(score);
  if (static_cast<int>(step_scores_.size()) < kScoresPerStep) return false;
  std::sort(step_scores_.begin(), step_scores_.end());
  score = step_scores_[step_scores_.size() / 2];
  step_scores_.clear();

  LogSample(score);
  opt_.AddSample(ToVector(current_), score);
  if (static_cast<int>(opt_.num_samples()) >= max_samples_) {
    SetFromVector(opt_.BestSample());
    frozen_ = true;  // reference: SetAutoTuning(false) once tuning concludes
    LogSample(-1.0);
    return true;
  }
  SetFromVector(opt_.NextSample());
  return true;
}

}  // namespace hvdtpu
