// Online autotuning of background-loop parameters.
//
// Reference: horovod/common/parameter_manager.{h,cc} (ParameterManager,
// BayesianParameter h:186) + horovod/common/optim/bayesian_optimization.{h,cc}
// and gaussian_process.{h,cc}. The reference jointly tunes the tensor-fusion
// threshold and cycle time with Bayesian optimization (Gaussian process +
// expected improvement, maximized with Eigen/LBFGS), scoring each sample by
// observed bytes/sec, and broadcasts winning parameters from the coordinator
// (Controller::SynchronizeParameters, controller.cc:34-48).
//
// This rebuild keeps the same structure — warmup, scored samples,
// GP + expected improvement over the 2-D (cycle time, fusion threshold)
// space, freeze at the best point after a sample budget — with a hand-rolled
// Cholesky-based GP (the space is 2-D and samples are few, so Eigen/LBFGS
// buys nothing; EI is maximized over a deterministic candidate sweep).
#pragma once

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace hvdtpu {

// Exact RBF-kernel GP regression on normalized inputs in [0,1]^d.
class GaussianProcess {
 public:
  explicit GaussianProcess(double noise = 1e-4, double length_scale = 0.25)
      : noise_(noise), length_scale_(length_scale) {}

  void Fit(const std::vector<std::vector<double>>& x,
           const std::vector<double>& y);
  // Posterior mean and stddev at a point (y is internally standardized).
  void Predict(const std::vector<double>& x, double* mu, double* sigma) const;
  bool fitted() const { return fitted_; }

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;

  double noise_;
  double length_scale_;
  bool fitted_ = false;
  std::vector<std::vector<double>> x_;
  std::vector<double> alpha_;       // (K + noise I)^-1 y_std
  std::vector<double> chol_;        // lower-triangular Cholesky factor, n x n
  double y_mean_ = 0.0, y_std_ = 1.0;
  size_t n_ = 0;
};

// Expected-improvement Bayesian optimizer over [0,1]^d.
class BayesianOptimizer {
 public:
  explicit BayesianOptimizer(int dim, double noise = 1e-4)
      : dim_(dim), gp_(noise) {}

  void AddSample(const std::vector<double>& x, double y);
  // Next point to evaluate: argmax EI over a deterministic candidate sweep
  // (grid + jittered points from an LCG; the reference uses LBFGS restarts).
  std::vector<double> NextSample();
  std::vector<double> BestSample() const;  // argmax of observed y
  size_t num_samples() const { return xs_.size(); }

 private:
  int dim_;
  GaussianProcess gp_;
  std::vector<std::vector<double>> xs_;
  std::vector<double> ys_;
  uint64_t rng_ = 0x9e3779b97f4a7c15ull;  // deterministic across ranks/runs
};

// Tunes cycle time, fusion threshold, the response-cache on/off switch,
// the allreduce ring/latency-algorithm crossover size, and the hierarchical
// (two-level) allreduce on/off switch
// online, scored by bytes/sec. Coordinator-only; winning values are
// broadcast to workers by the core (reference: ParameterManager lives in
// HorovodGlobalState and is driven from the background loop,
// operations.cc:615-643; the cache switch mirrors the reference's
// CategoricalParameter dimensions, parameter_manager.h:165/:225 —
// represented here as a thresholded third GP dimension).
// Concurrency contract: a ParameterManager lives on rank 0 and is touched
// only from the core's background loop (Initialize runs on the user thread
// strictly before that loop starts) — no locks, no annotations needed. The
// core republishes adopted values into its own GUARDED_BY(mu_) fields /
// PARAMS frames; nothing reads this object cross-thread.
class ParameterManager {
 public:
  struct Params {
    double cycle_time_ms;
    int64_t fusion_threshold;
    bool cache_enabled;
    // AUTO-algorithm crossover: allreduces at or below this many bytes take
    // the latency algorithm (recursive doubling), larger ones the pipelined
    // ring (data_plane.h AllreduceAlgo).
    int64_t algo_crossover;
    // Scatter-allgather for large tensors under AUTO (data_plane.h
    // sa_auto): a categorical on/off switch over whether big-message
    // dispatch prefers SCATTER_ALLGATHER to RING once the group clears
    // the sa_min_group floor.
    bool sa_enabled;
    // Hierarchical two-level allreduce (data_plane.h HierMode::AUTO): a
    // categorical on/off dimension like the cache switch (reference analog:
    // hierarchical_allreduce in BayesianParameter, parameter_manager.h:186).
    bool hier_enabled;
    // Wire compression under HVDTPU_COMPRESSION=auto (compressed.h
    // WireCompression): a 3-way categorical dimension over {none, fp16,
    // int8} — int4 is excluded from the automatic menu (its accuracy cost
    // is a modelling decision, not a throughput knob; force it explicitly).
    int32_t wire_compression;
  };

  // tune_crossover: include the algo crossover as an extra GP dimension
  // only when the data plane is in AUTO mode — with a pinned algorithm the
  // coordinate cannot affect the score and would just dilute the sample
  // budget; the value is then held constant at algo_crossover. tune_sa:
  // include the scatter-allgather switch only when the algorithm is AUTO
  // and the world clears the sa_min_group floor (otherwise the coordinate
  // is inert). tune_hier: include the hierarchical switch only when
  // HVDTPU_ALLREDUCE_HIER=auto AND the topology is non-trivial (multiple
  // hosts, multi-rank hosts). tune_compression: include the
  // wire-compression categorical only when HVDTPU_COMPRESSION=auto — with
  // a pinned mode the coordinate is inert and would dilute the sample
  // budget, like the crossover/hier gates.
  void Initialize(double cycle_time_ms, int64_t fusion_threshold,
                  bool cache_enabled, int64_t algo_crossover,
                  bool tune_crossover, bool sa_enabled, bool tune_sa,
                  bool hier_enabled, bool tune_hier,
                  int32_t wire_compression, bool tune_compression,
                  const std::string& log_path,
                  int warmup_samples, int cycles_per_sample, int max_samples,
                  double gp_noise);
  ~ParameterManager();

  bool active() const { return active_; }

  // Record bytes moved by one nonempty background cycle (callers must skip
  // zero-byte cycles — they would dilute the bytes/sec score with idle/app
  // time). Each tuning step scores the median of kScoresPerStep samples
  // (reference: parameter_manager.cc tunes on the median of several samples).
  // Returns true when the tuned parameters changed (caller re-reads
  // Current() and broadcasts).
  bool Update(int64_t bytes, double now_secs);
  Params Current() const { return current_; }

 private:
  void SetFromVector(const std::vector<double>& x);
  std::vector<double> ToVector(const Params& p) const;
  void LogSample(double score);

  bool active_ = false;
  bool frozen_ = false;
  bool tune_crossover_ = true;
  bool tune_sa_ = false;
  bool tune_hier_ = false;
  bool tune_compression_ = false;
  Params current_{1.0, 64 << 20, true, 32 << 10, true, false, 0};
  BayesianOptimizer opt_{4};
  int warmup_samples_ = 3;
  int cycles_per_sample_ = 50;
  int max_samples_ = 30;
  int warmup_left_ = 3;
  int cycle_count_ = 0;
  int64_t bytes_acc_ = 0;
  double sample_start_ = 0.0;
  static constexpr int kScoresPerStep = 3;
  std::vector<double> step_scores_;
  FILE* log_ = nullptr;
};

}  // namespace hvdtpu
