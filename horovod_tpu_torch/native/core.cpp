// Native core runtime: tensor queue, background cycle loop, rank-0
// negotiation controller, fusion, and the ctypes-visible C API.
//
// TPU-native rebuild of the reference's L1/L2 layers:
//  - background loop + C API: horovod/common/operations.cc
//    (BackgroundThreadLoop :374, RunLoopOnce :591, C API :705-913,
//     EnqueueTensor* :917-1144)
//  - controller negotiation: horovod/common/controller.cc
//    (ComputeResponseList :63, ConstructResponse :380, FuseResponses :686,
//     IncrementTensorCount :838)
//  - tensor queue + duplicate detection: horovod/common/tensor_queue.{h,cc}
//  - stall inspector: horovod/common/stall_inspector.{h,cc}
//
// Differences by design: the control plane is plain TCP to rank 0 (no MPI/Gloo),
// the data plane is the TCP mesh in data_plane.cpp (no NCCL — on TPU the hot
// path is XLA/ICI; this core serves the eager, Horovod-parity process mode),
// and wire structs are the hand-rolled encoding in message.cpp (no flatbuffers).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <list>
#include <cmath>
#include <condition_variable>
#include <cstdarg>
#include <cstdio>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <regex>
#include <set>
#include <thread>
#include <unordered_map>
#include <unordered_set>

#include "autotune.h"
#include "sha256.h"
#include "common.h"
#include "compressed.h"
#include "data_plane.h"
#include "gradstats.h"
#include "message.h"
#include "metrics.h"
#include "perfstats.h"
#include "profiler.h"
#include "socket_util.h"
#include "timeline.h"
#include "tracing.h"

#include <execinfo.h>
#include <poll.h>
#include <sys/resource.h>
#include <unistd.h>
#include <fcntl.h>

namespace hvdtpu {

namespace {

// Diagnostic terminate handler: print a native backtrace before aborting so
// an uncaught C++ exception in a background thread is debuggable in CI logs.
// Installed lazily from hvdtpu_create (not a static initializer — merely
// loading the library must not hijack the host process's handler) and chains
// to whatever handler was installed before.
std::terminate_handler g_prev_terminate = nullptr;

void TerminateWithBacktrace() {
  void* frames[64];
  int n = backtrace(frames, 64);
  fprintf(stderr, "[hvdtpu] fatal: uncaught exception; backtrace:\n");
  backtrace_symbols_fd(frames, n, 2);
  if (g_prev_terminate != nullptr && g_prev_terminate != TerminateWithBacktrace) {
    g_prev_terminate();
  }
  abort();
}

void InstallTerminateHandlerOnce() {
  static std::once_flag once;
  std::call_once(once, [] {
    g_prev_terminate = std::set_terminate(TerminateWithBacktrace);
  });
}

enum class CtrlMsg : int32_t {
  HELLO = 1,
  PEERS = 2,
  READY = 3,      // full requests + cache-hit names
  RESPONSES = 4,
  JOIN = 5,
  NEED_FULL = 6,  // coordinator -> worker: cache miss, resend full requests
  PARAMS = 7,     // coordinator -> worker: autotuned cycle time / fusion
  CLOCK = 8,      // clock-sync ping-pong: worker {t1} <-> coord {t1, t2}
  GRADCHECK = 9,  // worker -> coordinator: post-allreduce output
                  // fingerprint {seq, crc32c, tensor} for the cross-rank
                  // divergence probe (docs/numerics.md)
  // The negotiated shutdown (see Core::Shutdown):
  SHUTDOWN_REQ = 10,  // worker -> coordinator: this rank asks to shut down
  SHUTDOWN_ACK = 11,  // worker -> coordinator: CLEAN_SHUTDOWN executed
  SHUTDOWN_FIN = 12,  // coordinator -> worker: every rank acked; leave
};

// How long a rank that asked to shut down waits for its peers to agree
// before it closes its lanes the old way (aborting a peer that still
// reads). A peer that died is not waited for: its lost connection counts.
constexpr double kShutdownAgreeSecs = 30.0;

void LogWarn(int rank, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "[hvdtpu %d] WARNING: ", rank);
  vfprintf(stderr, fmt, ap);
  fputc('\n', stderr);
  va_end(ap);
}

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void LogBadFrame(int rank, const char* where,
                 const std::vector<uint8_t>& frame) {
  char hex[3 * 64 + 1] = {0};
  size_t n = frame.size() < 64 ? frame.size() : 64;
  for (size_t i = 0; i < n; ++i) {
    snprintf(hex + 3 * i, 4, "%02x ", frame[i]);
  }
  fprintf(stderr,
          "[hvdtpu %d] ERROR: corrupt control frame in %s (len=%zu): %s\n",
          rank, where, frame.size(), hex);
}

// Compare everything that must match for a cached announcement to be valid
// (reference: ResponseCache keys on name + params, response_cache.cc).
bool SameRequest(const Request& a, const Request& b) {
  return a.op_type == b.op_type && a.reduce_op == b.reduce_op &&
         a.dtype == b.dtype && a.shape == b.shape &&
         a.prescale == b.prescale && a.postscale == b.postscale &&
         a.root_rank == b.root_rank && a.splits == b.splits;
}

// Defined below Core (same anonymous namespace); ExecuteResponse needs it
// for reduce-scatter prescale/postscale before the definition appears.
void ScaleBuffer(void* data, int64_t count, DataType dtype, double factor);

}  // namespace

// LRU response cache (reference: horovod/common/response_cache.{h,cc}).
// The reference synchronizes bit-indexed cache entries with two bitvector
// allreduces per cycle; with a TCP star control plane the race-free analog is
// name-keyed: workers announce just the tensor NAME when their request is
// byte-identical to the last one, the coordinator re-materializes the full
// request from its own cache, and a miss (eviction divergence) is repaired by
// a NEED_FULL round trip instead of a protocol error.
class RequestCache {
 public:
  void SetCapacity(int64_t cap) { capacity_ = cap; }
  // Autotune's categorical switch (reference: CategoricalParameter cache
  // on/off, parameter_manager.h:225). capacity==0 (user opt-out) always
  // wins. Toggling only gates the WIRE fast path (enabled()); both sides
  // keep tracking() entries while disabled — otherwise a request that
  // changed during a disabled window would leave a stale-but-valid entry
  // behind, and a later bare-name hit on it is NOT repaired by NEED_FULL
  // (that round trip only covers absent entries).
  void SetEnabled(bool on) { on_ = on; }
  bool enabled() const { return on_ && capacity_ > 0; }
  bool tracking() const { return capacity_ > 0; }

  // Worker side: true if `q` matches the cached entry for its name (-> the
  // bare name suffices on the wire). Updates/inserts the entry otherwise.
  bool CheckAndPut(const Request& q) {
    auto it = map_.find(q.name);
    if (it != map_.end()) {
      Touch(it);
      if (SameRequest(it->second.req, q)) return true;
      it->second.req = q;
      return false;
    }
    Insert(q.name).req = q;
    return false;
  }

  // Coordinator side: remember rank r's full request for this name.
  void PutRank(const Request& q) {
    auto it = map_.find(q.name);
    Entry& e = it != map_.end() ? (Touch(it), it->second) : Insert(q.name);
    if (static_cast<size_t>(q.rank) >= e.by_rank.size()) {
      e.by_rank.resize(q.rank + 1);
      e.valid.resize(q.rank + 1, false);
    }
    e.by_rank[q.rank] = q;
    e.valid[q.rank] = true;
  }

  // Coordinator side: recover rank r's request from a bare-name hit.
  bool GetRank(const std::string& name, int rank, Request* out) {
    auto it = map_.find(name);
    if (it == map_.end()) return false;
    Touch(it);
    Entry& e = it->second;
    if (static_cast<size_t>(rank) >= e.valid.size() || !e.valid[rank]) {
      return false;
    }
    *out = e.by_rank[rank];
    return true;
  }

  void Erase(const std::string& name) {
    auto it = map_.find(name);
    if (it == map_.end()) return;
    lru_.erase(it->second.pos);
    map_.erase(it);
  }

 private:
  struct Entry {
    Request req;                    // worker side: my last-sent request
    std::vector<Request> by_rank;   // coordinator side
    std::vector<bool> valid;
    std::list<std::string>::iterator pos;
  };
  using Map = std::unordered_map<std::string, Entry>;

  void Touch(Map::iterator it) {
    lru_.erase(it->second.pos);
    lru_.push_front(it->first);
    it->second.pos = lru_.begin();
  }
  Entry& Insert(const std::string& name) {
    while (static_cast<int64_t>(map_.size()) >= capacity_ && !lru_.empty()) {
      map_.erase(lru_.back());
      lru_.pop_back();
    }
    lru_.push_front(name);
    Entry& e = map_[name];
    e.pos = lru_.begin();
    return e;
  }

  int64_t capacity_ = 1024;  // reference default: HOROVOD_CACHE_CAPACITY
  bool on_ = true;
  Map map_;
  std::list<std::string> lru_;
};

// Batched control-plane sender (HVDTPU_CTRL_BATCH): per-tensor READY /
// RESPONSES / NEED_FULL plus the CLOCK and GRADCHECK piggyback frames queued
// during one background cycle coalesce into ONE vectored SendAllVec per peer
// at flush — one syscall per peer per cycle instead of one per message,
// which is where w16+ coordination cost actually lives. The wire stream is
// byte-identical to a SendFrame sequence (each frame keeps its own u64
// length prefix), so the receive side is untouched. Owned by the background
// thread, like the fds it writes.
class CtrlOutbox {
 public:
  void set_enabled(bool on) { enabled_ = on; }
  bool enabled() const { return enabled_; }
  void set_counters(Counter* frames, Counter* batches) {
    frames_total_ = frames;
    batches_total_ = batches;
  }

  // Queue one frame for fd. Disabled -> immediate SendFrame (same return);
  // enabled -> queued, returns 0, send failures surface at Flush.
  int Queue(int fd, std::vector<uint8_t> payload) {
    if (frames_total_ != nullptr) frames_total_->Inc();
    if (!enabled_) {
      if (batches_total_ != nullptr) batches_total_->Inc();
      return SendFrame(fd, payload);
    }
    queues_[fd].push_back(std::move(payload));
    return 0;
  }

  bool pending() const { return !queues_.empty(); }

  // Ship everything queued, one vectored send per fd (chunked well under
  // POSIX's IOV_MAX floor of 1024). Returns 0 when every peer's send
  // succeeded, else -1 with *bad_fd naming the first failure; the remaining
  // peers still flush — one dead worker must not strand a broadcast.
  int Flush(int* bad_fd) {
    int rc = 0;
    for (auto& kv : queues_) {
      const int fd = kv.first;
      auto& frames = kv.second;
      // Length prefixes must outlive the iovecs that point at them.
      std::vector<uint64_t> lens(frames.size());
      for (size_t i = 0; i < frames.size(); ++i) lens[i] = frames[i].size();
      size_t done = 0;
      bool fd_ok = true;
      while (fd_ok && done < frames.size()) {
        const size_t n = std::min<size_t>(frames.size() - done, 500);
        std::vector<iovec> iov;
        iov.reserve(2 * n);
        for (size_t i = done; i < done + n; ++i) {
          iov.push_back({&lens[i], sizeof(uint64_t)});
          if (!frames[i].empty()) {
            iov.push_back({frames[i].data(), frames[i].size()});
          }
        }
        if (batches_total_ != nullptr) batches_total_->Inc();
        if (SendAllVec(fd, iov.data(), static_cast<int>(iov.size())) != 0) {
          if (rc == 0 && bad_fd != nullptr) *bad_fd = fd;
          rc = -1;
          fd_ok = false;
        }
        done += n;
      }
    }
    queues_.clear();
    return rc;
  }

  // Drop whatever is queued for a disconnecting peer.
  void Forget(int fd) { queues_.erase(fd); }

 private:
  bool enabled_ = true;
  std::map<int, std::vector<std::vector<uint8_t>>> queues_;
  Counter* frames_total_ = nullptr;
  Counter* batches_total_ = nullptr;
};

struct CoreConfig {
  int rank = 0;
  int size = 1;
  int local_rank = 0;
  int local_size = 1;
  int cross_rank = 0;
  int cross_size = 1;
  std::string coord_host = "127.0.0.1";
  int coord_port = 0;
  std::string my_host = "127.0.0.1";
  double cycle_time_ms = 1.0;
  int64_t fusion_threshold = 64 * 1024 * 1024;  // reference default, 64 MB
  std::string timeline_path;
  bool timeline_mark_cycles = false;
  // Distributed tracing (docs/tracing.md): every Nth collective op gets
  // per-hop child spans on the timeline (0 = spans off; the op-level
  // phases always ride a running timeline). Clock sync against rank 0 is
  // refreshed through the control plane on this period while tracing.
  int64_t trace_sample = 0;
  double clock_sync_interval_secs = 30.0;
  // Always-on flight recorder (flightrec.h; docs/fault-tolerance.md
  // "Post-mortem debugging"): ring capacity in records (0 disables —
  // HVDTPU_FLIGHTREC=0) and the dump directory for the automatic
  // abort/stall/fatal-signal dumps (empty = in-memory only; Snapshot and
  // /debugz still work).
  int64_t flightrec_events = 4096;
  std::string flightrec_dir;
  // Always-on perf attribution (perfstats.h; docs/observability.md). The
  // streaming baselines are on by default (HVDTPU_PERFSTATS=0 disables);
  // the slowdown sentry fires past slowdown_pct once a key has
  // min_samples. perf_profile_path: where Shutdown persists this rank's
  // per-key baselines + anomaly log for the cross-run regression sentry
  // (HVDTPU_PERF_PROFILE_DIR -> perf_profile.<rank>.json; empty = skip).
  bool perfstats = true;
  double perf_slowdown_pct = 50.0;
  int64_t perf_min_samples = 20;
  std::string perf_profile_path;
  // Always-available sampling profiler (profiler.h; docs/profiling.md).
  // Enabled by default: the subsystem costs nothing until a window runs
  // (HVDTPU_PROF=0 compiles it down to one branch per entry point).
  // prof_hz/prof_capacity <= 0 keep the defaults; prof_clock: 0 cpu,
  // 1 wall. prof_path: where Shutdown writes prof.<rank>.folded
  // (HVDTPU_PROF_DIR -> hvdrun --profile; empty = skip); a non-empty path
  // also starts the window at Start — the whole-job profile the runner
  // collects.
  bool prof = true;
  int prof_hz = 0;
  int64_t prof_capacity = 0;
  int32_t prof_clock = 0;
  std::string prof_path;
  double stall_warn_secs = 60.0;  // reference HOROVOD_STALL_CHECK_TIME
  // Shared job secret (reference: runner/common/util/secret.py). When set,
  // every HELLO must carry an HMAC proof; unauthenticated connections are
  // rejected. Empty = auth disabled (un-launched / single-host debugging).
  std::string secret;
  // Reference HOROVOD_STALL_SHUTDOWN_TIME: after this long stalled, break
  // the world instead of hanging forever. The reference defaults this to 0
  // (disabled), which left the escalation dead code in practice; here the
  // default is AUTO (< 0): 10x the warning threshold, so a wedged world
  // always breaks eventually. 0 still disables explicitly.
  double stall_shutdown_secs = -1.0;
  // Failure detection (docs/fault-tolerance.md): HVDTPU_FAILURE_DETECT_MS
  // bounds how long a peer death can go unnoticed on a blocked transport
  // op, HVDTPU_FORMUP_TIMEOUT_SECONDS bounds rendezvous/mesh form-up.
  int64_t failure_detect_ms = 500;
  double formup_timeout_secs = 60.0;
  // Transport-level no-progress deadline (HVDTPU_READ_DEADLINE_SECONDS):
  // a lane that is open but moves ZERO bytes for this long mid-collective
  // is declared dead — the only way to catch a hung-but-alive peer or a
  // silent partition (no EOF ever arrives). 0 disables. Progress resets
  // the clock, so long transfers on slow links are safe.
  double read_deadline_secs = 10.0;
  // Armed fault injection (HVDTPU_CHAOS -> hvdtpu_set_chaos), NONE normally.
  ChaosSpec chaos;
  int64_t cache_capacity = 1024;  // reference HOROVOD_CACHE_CAPACITY
  // Autotune (reference HOROVOD_AUTOTUNE_* knobs, operations.cc:474-532).
  bool autotune = false;
  std::string autotune_log;
  int autotune_warmup_samples = 3;
  int autotune_cycles_per_sample = 50;
  int autotune_max_samples = 30;
  double autotune_gp_noise = 0.2;
  // Allreduce algorithm selection (HVDTPU_ALLREDUCE_ALGO; data_plane.h
  // AllreduceAlgo). Crossover/segment <= 0 keep the data-plane defaults.
  int32_t allreduce_algo = 0;  // AUTO
  int64_t allreduce_crossover = 0;
  int64_t allreduce_segment = 0;
  // Scale-out knobs. allreduce_sa_group (HVDTPU_ALLREDUCE_SA_GROUP): the
  // group-size floor at which AUTO's big-message dispatch prefers
  // scatter-allgather over the ring; < 0 keeps the data-plane default,
  // 0 removes scatter-allgather from the AUTO menu entirely. ctrl_batch
  // (HVDTPU_CTRL_BATCH): nonzero coalesces each background cycle's
  // control-plane frames into one vectored send per peer.
  int64_t allreduce_sa_group = -1;
  int32_t ctrl_batch = 1;
  // Broadcast flat/tree crossover (HVDTPU_BCAST_FLAT_MAX; data_plane.h):
  // payloads at or below this many bytes take the flat root-fanout, larger
  // ones the binomial tree. < 0 keeps the data-plane default, 0 forces the
  // tree for every size.
  int64_t bcast_flat_max = -1;
  // Transport subsystem (HVDTPU_SHM / HVDTPU_SHM_RING_BYTES /
  // HVDTPU_ALLREDUCE_HIER; data_plane.h). shm defaults on — same-host pairs
  // negotiate shared-memory lanes at Connect and fall back to TCP when
  // either side fails setup. hier: 0 off, 1 on, 2 auto (autotuner-owned).
  int32_t shm_enabled = 1;
  int64_t shm_ring_bytes = 0;
  int32_t allreduce_hier = 2;
  // Zero-copy transport lane (HVDTPU_TCP_ZEROCOPY / HVDTPU_SHM_NUMA /
  // HVDTPU_DOORBELL_BATCH; transport.h ZeroCopyMode, shm_transport.h
  // ShmNumaMode). tcp_zerocopy: 0 auto, 1 on, 2 off, 3 uring; shm_numa:
  // 0 auto, 1 on, 2 off; doorbell_batch: futex-wake coalescing window in
  // bytes (0 = lane default, 1 = wake per cursor advance).
  int32_t tcp_zerocopy = 0;
  int32_t shm_numa = 0;
  int64_t doorbell_batch = 0;
  // Wire compression (HVDTPU_COMPRESSION; compressed.h WireCompression:
  // 0 none, 1 fp16, 2 int8, 3 int4, 4 auto/autotuned). Applies to fp32
  // SUM/AVERAGE allreduces at or above min_bytes whose tensor names all
  // miss the skip regex (biases/norms stay dense, reference: the fork's
  // per-layer ignore rules).
  int32_t wire_compression = 0;
  int64_t compression_min_bytes = 1024;
  std::string compression_skip_regex;
  // Numerical-health observability (gradstats.h; docs/numerics.md). On by
  // default: the moments fold into passes the core already pays for.
  // nancheck: 0 off, 1 warn (default), 2 abort — what the first NaN/Inf
  // gradient does. gradcheck_sample: fingerprint every Nth allreduce's
  // post-reduce output and compare across ranks through the control plane
  // (0 disables the divergence probe; must be uniform across ranks, which
  // the launcher's env broadcast guarantees). grad_profile_path: where
  // Shutdown persists grad_profile.<rank>.json (HVDTPU_GRAD_PROFILE_DIR;
  // empty = skip) for scripts/grad_diff.py.
  bool gradstats = true;
  int32_t nancheck = 1;
  int64_t gradcheck_sample = 64;
  std::string grad_profile_path;
};

class Core {
 public:
  explicit Core(const CoreConfig& cfg)
      : cfg_(cfg),
        data_plane_(cfg.rank, cfg.size),
        cycle_time_ms_(cfg.cycle_time_ms),
        fusion_threshold_(cfg.fusion_threshold) {}

  ~Core() {
    Shutdown();
    CloseFd(wake_pipe_[0]);
    CloseFd(wake_pipe_[1]);
  }

  Status Start() EXCLUDES(mu_);
  void Shutdown() EXCLUDES(mu_);

  // Returns handle >= 0, or Status error via *status.
  int64_t Enqueue(TensorEntry entry, Status* status) EXCLUDES(mu_);
  // Grouped-collective enqueue window (hvd.grouped_* batched negotiation):
  // between GroupBegin and GroupEnd, enqueued entries are withheld from the
  // control-plane announcement drain, so the whole group lands in ONE
  // background cycle once released — one READY frame up, one RESPONSES
  // frame down for N tensors (the READY/RESPONSES frames already
  // name-coalesce per cycle), and the coordinator's fusion lookahead sees
  // every member at once. The caller MUST pair Begin with End (the Python
  // context manager guarantees it); waiting on a held handle would hang.
  void GroupBegin() EXCLUDES(mu_);
  void GroupEnd() EXCLUDES(mu_);
  Status WaitHandle(int64_t handle) EXCLUDES(mu_);
  int PollHandle(int64_t handle) EXCLUDES(mu_);
  int64_t ResultBytes(int64_t handle) EXCLUDES(mu_);
  // Copies result and releases the handle.
  Status CopyResult(int64_t handle, void* dst, int64_t capacity)
      EXCLUDES(mu_);
  // Blocks until all ranks joined; returns the last joined rank.
  int64_t Join() EXCLUDES(mu_);

  // Runtime timeline control (reference: horovod_start_timeline /
  // horovod_stop_timeline, operations.cc:735-790). Thread-safe: the request
  // is applied by the background thread at the top of its next cycle so the
  // Timeline object stays single-owner. trace_sample: -1 = keep the
  // configured span-sampling rate, otherwise the new every-Nth-op rate
  // (hvd.start_trace).
  void RequestTimeline(bool start, const std::string& path, bool mark_cycles,
                       int64_t trace_sample = -1) EXCLUDES(timeline_req_mu_);
  // Clock offset vs rank 0 (offset ± error, microseconds; err < 0 = never
  // synced). Lock-free, callable from any thread (C API introspection).
  void ClockOffset(int64_t* offset_us, int64_t* err_us) const {
    if (offset_us != nullptr) {
      *offset_us = clock_offset_us_.load(std::memory_order_relaxed);
    }
    if (err_us != nullptr) {
      *err_us = clock_err_us_.load(std::memory_order_relaxed);
    }
  }
  // Current (possibly autotuned) loop parameters, for tests/introspection.
  double CurrentCycleTimeMs() EXCLUDES(mu_);
  int64_t CurrentFusionThreshold() EXCLUDES(mu_);
  // Cumulative data-plane payload accounting. Thin shim over the metrics
  // registry (hvdtpu_allreduce_{raw,wire}_bytes_total) — the registry is
  // the single source of truth; this keeps the pre-metrics C/Python API
  // stable. Lock-free counters, safe from user threads while ops run.
  void WireStats(int64_t* raw_bytes, int64_t* wire_bytes) {
    *raw_bytes = data_plane_.total_raw_bytes();
    *wire_bytes = data_plane_.total_wire_bytes();
  }
  // ZeRO-1 memory proof (docs/optimizer.md): the Python sharded optimizer
  // reports its resident optimizer-state footprint here so the memory
  // gauges can attest the 1/world claim next to hvdtpu_rss_bytes. Lazy
  // GetGauge (registry lock) + atomic Gauge::Set — safe from user threads
  // at any point in the core lifecycle, no member caching needed.
  void SetOptimizerStateBytes(int64_t bytes) {
    metrics_
        .GetGauge("hvdtpu_optimizer_state_bytes",
                  "Resident optimizer-state bytes on this rank (ZeRO-1 "
                  "shards report ~1/world of the replicated footprint)")
        ->Set(static_cast<double>(bytes));
  }
  // Prometheus text exposition of every registered series (C API:
  // hvdtpu_metrics_dump; served over HTTP by horovod_tpu/observability.py).
  // Callable from any thread at any point in the core lifecycle.
  std::string MetricsDump() { return metrics_.Dump(); }
  // Flight-recorder surface (C API hvdtpu_flightrec_*; /debugz). Callable
  // from any thread at any point in the core lifecycle — a disabled or
  // unstarted recorder snapshots to "".
  std::string FlightSnapshot() {
    return flightrec_.Snapshot(DumpReason::ON_DEMAND, -1);
  }
  bool FlightDumpToFile(const char* path) {
    const bool ok = flightrec_.DumpToFile(DumpReason::ON_DEMAND, -1,
                                          path != nullptr ? path : "");
    if (ok && m_flightrec_dumps_ != nullptr) m_flightrec_dumps_->Inc();
    return ok;
  }
  // Perf-attribution surface (C API hvdtpu_perfstats_snapshot; /perfz).
  // Keyed-baseline snapshot as JSON — lock-free reads, callable from any
  // thread at any point in the core lifecycle.
  std::string PerfSnapshot() { return perfstats_.SnapshotJson(); }
  // Numerical-health surface (C API hvdtpu_gradstats_snapshot; /gradz /
  // hvd.grad_report()). Same lock-free-read contract as PerfSnapshot.
  std::string GradSnapshot() { return gradstats_.SnapshotJson(); }
  // Sampling-profiler surface (C API hvdtpu_profiler_*; /profz /
  // hvd.profile()). All callable from any thread at any point in the core
  // lifecycle — a disabled profiler starts/stops as no-ops and snapshots
  // the "enabled: false" stub.
  void ProfilerStart() { profiler_.Start(); }
  void ProfilerStop() { profiler_.Stop(); }
  bool ProfilerRunning() const { return profiler_.running(); }
  std::string ProfilerSnapshot() const { return profiler_.FoldedJson(); }
  CoreConfig* mutable_config() { return &cfg_; }  // pre-Start() only

 private:
  void BackgroundLoop() EXCLUDES(mu_);
  void WaitForWork() EXCLUDES(mu_);  // poll control fds + wake pipe
  void Wake();                       // nudge the background loop
  void PumpControlPlane() EXCLUDES(mu_);  // role-dependent per-cycle work
  void FlushCtrlOutbox();                  // ship queued control frames
  void CoordinatorIngest() EXCLUDES(mu_);  // rank 0: read worker frames
  // rank 0: match + fuse + broadcast
  void CoordinatorEmitResponses() EXCLUDES(mu_);
  void WorkerSendReady(std::vector<Request> reqs,
                       std::vector<std::string> cached);
  void HandleReadyRequests(std::vector<Request> reqs);  // coordinator table
  Response BuildResponse(const std::string& name);
  void ExecuteResponseList(const std::vector<Response>& list) EXCLUDES(mu_);
  void ExecuteResponse(const Response& resp) EXCLUDES(mu_);
  void ExecuteFusedAllreduce(const Response& resp,
                             std::vector<TensorEntry*>& entries,
                             WireCompression comp) EXCLUDES(mu_);
  void CompleteEntry(TensorEntry* e, const Status& st) EXCLUDES(mu_);
  void CheckStalls();
  // Effective stall-shutdown window: AUTO (< 0) resolves to 10x the warning
  // threshold so the escalation is never silently dead; 0 disables.
  double EffectiveStallShutdownSecs() const {
    return cfg_.stall_shutdown_secs < 0 ? 10.0 * cfg_.stall_warn_secs
                                        : cfg_.stall_shutdown_secs;
  }
  // A data-plane op failed with the plane aborted: a peer died (or tripped
  // its liveness deadline) mid-collective. Count it, make sure every lane
  // is broken (the cascade that unblocks the rest of the world), and fail
  // over so elastic mode can catch HvdTpuInternalError and re-rendezvous.
  void HandleDataPlaneFailure(const Status& st) EXCLUDES(mu_);

 public:
  // Elastic recovery accounting (C API hvdtpu_observe_recovery): the Python
  // runtime measures detection -> successful re-initialization and records
  // it against the NEW core's registry, so hvd.metrics() after a recovery
  // shows both the failure count and the recovery latency.
  void ObserveRecovery(double secs) {
    if (m_recovery_seconds_ != nullptr) m_recovery_seconds_->Observe(secs);
    if (m_failures_detected_ != nullptr) m_failures_detected_->Inc();
  }

 private:
  // Effective wire compression for one negotiated allreduce: the configured
  // (or autotuned) mode, gated on dtype fp32, op SUM/AVERAGE, total payload
  // >= compression_min_bytes, and no tensor name matching the skip regex.
  // Every input is identical on every rank (the mode arrives in config or a
  // PARAMS frame, the rest comes from the broadcast Response), so all ranks
  // resolve the same answer — a split would desynchronize the wire format.
  WireCompression EffectiveCompression(const Response& resp,
                                       int64_t total_bytes);

  CoreConfig cfg_;
  DataPlane data_plane_;
  Timeline timeline_;
  // Always-on flight recorder: the data plane records hops into it, this
  // class records op begin/end + fusion waits + stalls, and the fatal
  // paths dump it (FailAllOutstanding, CheckStalls escalation, the signal
  // handlers flightrec.cpp installs).
  FlightRecorder flightrec_;
  // Always-on perf attribution: streaming per-key baselines fed after
  // every completed op; the slowdown sentry rides ObserveOp
  // (docs/observability.md "Live perf attribution").
  PerfStats perfstats_;
  // Anomaly log for perf_profile.<rank>.json (background thread only,
  // bounded; written out by Shutdown after the loop is joined).
  std::vector<std::string> perf_anomaly_log_;
  bool perf_profile_written_ = false;
  void WritePerfProfile();
  // Numerical-health telemetry (gradstats.h; docs/numerics.md): per-tensor
  // gradient moments + per-key quantization quality + the cross-rank
  // divergence probe. grad_quality_ is the per-op accumulator the data
  // plane's WireCompress calls fill (background thread only).
  GradStats gradstats_;
  GradQuality grad_quality_;
  bool grad_profile_written_ = false;
  void WriteGradProfile();
  // Divergence probe state: every executed (non-Adasum) allreduce bumps
  // gradcheck_seq_ identically on every rank; sampled ops fingerprint
  // their post-reduce output and the coordinator majority-votes per seq.
  // Both are background-thread-owned, like message_table_.
  int64_t gradcheck_seq_ = 0;
  struct GradcheckSlot {
    std::string name;
    int64_t bytes = 0;
    std::vector<uint32_t> crcs;
    std::vector<uint8_t> have;
    int count = 0;
  };
  std::map<int64_t, GradcheckSlot> gradcheck_pending_;  // coordinator only
  // Fingerprint this op's post-allreduce output when the sampler says so
  // (background thread; called before postscale, so every rank hashes
  // bitwise-identical bytes). adasum ops are skipped — their pairwise
  // adaptive combine is outside the bitwise-identity contract.
  void MaybeGradcheck(const std::string& name, const void* data,
                      int64_t bytes);
  // Coordinator side: record one rank's fingerprint for seq; when every
  // rank reported, majority-vote and convict the minority (DIVERGENCE
  // flight event + hvdtpu_divergence_total{suspect=...}).
  void RecordFingerprint(int64_t seq, int rank, uint32_t crc,
                         const std::string& name, int64_t bytes);
  // Non-finite sentinel (HVDTPU_NANCHECK): count + flight event + WARN for
  // a tensor whose copy-in moments saw NaN/Inf; returns true when the
  // policy is ABORT and the op must fail-fast before any data moves.
  // `slot` keys the per-tensor 1/s WARN/flight throttle — a NaN-flooded
  // model must not evict the flight ring's op/hop forensics (counters
  // stay exact regardless).
  bool NoteNonfinite(const std::string& tensor, const GradMoments& m,
                     int slot);
  // Always-available sampling profiler (profiler.h; docs/profiling.md):
  // the background loop registers itself for SIGPROF sampling, the data
  // plane publishes the phase thread-local the samples are tagged with,
  // and /profz / hvd.profile() / hvdrun --profile drive the window.
  SamplingProfiler profiler_;
  bool prof_written_ = false;
  // Memory-occupancy telemetry (docs/profiling.md "Memory telemetry"):
  // refreshed by the background loop at most once per second. Fusion
  // high-water is tracked here (the per-batch gauge is set at execution).
  double last_mem_update_at_ = 0;
  int64_t fusion_highwater_bytes_ = 0;
  Gauge* m_fusion_buffer_gauge_ = nullptr;
  Gauge* m_fusion_highwater_gauge_ = nullptr;
  Gauge* m_residual_bytes_gauge_ = nullptr;
  Gauge* m_rss_gauge_ = nullptr;
  Gauge* m_rss_peak_gauge_ = nullptr;
  std::vector<std::pair<int, int64_t>> shm_occupancy_scratch_;
  void UpdateMemoryGauges(bool force = false);

  // One histogram-pair + counter observation per completed data-plane op,
  // plus the perf-attribution sentry: `perf_sig` is the tensor-set
  // signature keying the streaming baselines (empty skips perf — JOIN,
  // failed lookups).
  void ObserveOp(const char* op, double secs, int64_t bytes,
                 const char* algo, const std::string& transport, bool hier,
                 const char* compression, DataType dtype, bool ok,
                 const std::string& perf_sig = std::string());
  // Refresh the autotune-owned parameter gauges (Start + every adoption).
  void UpdateParamGauges(double cycle_ms, int64_t fusion, bool cache_on,
                         int64_t crossover);

  // Wire-compression state: error-feedback residuals per (fused) tensor,
  // the compiled skip regex (with a per-name verdict memo — regex_search
  // is microseconds per call and the same tensor names recur every cycle
  // on the serialized collective thread), and the autotuner's current
  // choice under HVDTPU_COMPRESSION=auto (background thread only — both
  // the worker PARAMS handler and the coordinator adoption run there).
  ResidualStore residual_store_;
  std::regex comp_skip_re_;
  bool comp_skip_set_ = false;
  std::unordered_map<std::string, bool> comp_skip_memo_;
  int32_t comp_auto_ = 0;

  // Control plane.
  int coord_listen_fd_ = -1;           // rank 0
  std::vector<int> worker_fds_;        // rank 0: fd per rank (self = -1)
  int control_fd_ = -1;                // workers: connection to rank 0

  // Self-pipe waking the background loop's poll() the instant work arrives
  // (local enqueue/join/shutdown). Control-plane frames wake it by their fd
  // becoming readable, so small collectives are event-driven end to end
  // instead of paying up to one cycle_time_ms sleep per hop; the cycle time
  // degrades to the idle-poll timeout.
  int wake_pipe_[2] = {-1, -1};

  // Tensor queue + outstanding table (reference: tensor_queue.{h,cc}).
  // mu_ is the only lock shared between user threads (Enqueue/Wait/Poll/
  // CopyResult/Join) and the background thread; everything it guards is
  // annotated below and checked by `make analyze`.
  Mutex mu_;
  CondVar cv_;                                 // completion + enqueue signal
  // enqueued, not yet announced
  std::deque<TensorEntry*> pending_ GUARDED_BY(mu_);
  // Grouped-enqueue hold (GroupBegin/GroupEnd): while true, pending_ stays
  // queued so the whole group announces in one cycle.
  bool group_hold_ GUARDED_BY(mu_) = false;
  // by name
  std::unordered_map<std::string, TensorEntry*> outstanding_ GUARDED_BY(mu_);
  std::unordered_map<int64_t, TensorEntry*> handles_ GUARDED_BY(mu_);
  // completed handle -> status
  std::unordered_map<int64_t, Status> done_ GUARDED_BY(mu_);
  int64_t next_handle_ GUARDED_BY(mu_) = 0;
  // Runtime-mutable loop parameters (autotune adoption / PARAMS frames write
  // them, user threads read them via CurrentCycleTimeMs/CurrentFusion
  // Threshold). Split out of cfg_ so they can carry GUARDED_BY — the rest of
  // cfg_ is immutable once Start() spawns the background thread.
  double cycle_time_ms_ GUARDED_BY(mu_) = 1.0;
  int64_t fusion_threshold_ GUARDED_BY(mu_) = 64 * 1024 * 1024;

  // Coordinator negotiation state (reference: controller message_table_).
  // Background-thread-owned, like cache_, param_manager_, residual_store_,
  // comp_*_ and worker_fds_ (after Start): only BackgroundLoop's call tree
  // touches them, so they need no lock and carry no annotation — thread
  // ownership is a contract the analysis cannot express.
  struct PendingName {
    std::vector<Request> requests;
    double first_seen = 0;
    bool stall_warned = false;
  };
  std::map<std::string, PendingName> message_table_;  // ordered for determinism
  std::deque<std::string> ready_names_;               // count reached
  std::set<int32_t> joined_ranks_;
  std::set<int32_t> dead_ranks_;  // disconnected workers (never come back)
  bool join_pending_local_ GUARDED_BY(mu_) = false;
  std::atomic<int32_t> last_joined_rank_{-1};  // atomic: seqcst(join handshake with mutex-guarded state)
  std::atomic<bool> join_done_{false};  // atomic: seqcst(join handshake with mutex-guarded state)

  std::thread background_;
  std::atomic<bool> shutdown_{false};  // atomic: seqcst(shutdown latch, read via implicit loads)
  // The negotiated shutdown (a deviation from the JAX package's core,
  // whose Shutdown closes its lanes at once and so aborts a peer still
  // reading its last bytes). Shutdown() sets shutdown_requested_; the
  // background loop tells the coordinator (SHUTDOWN_REQ), which appends a
  // CLEAN_SHUTDOWN response after the ready ops. Every rank executes it
  // after every op before it, fails what is still outstanding, and acks
  // (SHUTDOWN_ACK); once every live rank has, the coordinator sends
  // SHUTDOWN_FIN and every loop leaves (clean_exit_). Only then are the
  // lanes closed, without the abort flag. A lost connection or a broken
  // world still leaves at once, and a rank whose peers do not agree within
  // kShutdownAgreeSecs closes as before.
  std::atomic<bool> shutdown_requested_{false};  // atomic: seqcst(user -> background request)
  bool closing_ GUARDED_BY(mu_) = false;  // CLEAN_SHUTDOWN executed here
  // Background-thread owned:
  bool shutdown_announced_ = false;
  double shutdown_deadline_ = 0;
  bool clean_exit_ = false;
  bool world_shutdown_ = false;          // coordinator: a rank asked
  bool clean_shutdown_emitted_ = false;  // coordinator
  bool clean_shutdown_executed_ = false;
  std::set<int32_t> shutdown_acks_;      // coordinator
  std::atomic<bool> world_broken_{false};  // atomic: seqcst(failure latch)
  // Worker-side failover latch (set by HandleDataPlaneFailure, consumed at
  // the top of the next background cycle — see the deferral note there).
  std::atomic<bool> worker_failover_pending_{false};  // atomic: seqcst(failover doorbell)
  bool started_ = false;

  // Response cache (see RequestCache above). Worker role uses req/enabled;
  // coordinator role uses the per-rank table.
  RequestCache cache_;

  // Batched control-plane sender (see CtrlOutbox above). Background-thread
  // owned like the fds it writes; flushed before any collective runs and at
  // the end of every pump.
  CtrlOutbox outbox_;

  // Autotune: coordinator-only decisions, broadcast via CtrlMsg::PARAMS.
  ParameterManager param_manager_;

  // Pending timeline start/stop, applied by the background thread.
  Mutex timeline_req_mu_;
  bool timeline_req_pending_ GUARDED_BY(timeline_req_mu_) = false;
  bool timeline_req_start_ GUARDED_BY(timeline_req_mu_) = false;
  std::string timeline_req_path_ GUARDED_BY(timeline_req_mu_);
  bool timeline_req_mark_ GUARDED_BY(timeline_req_mu_) = false;
  int64_t timeline_req_sample_ GUARDED_BY(timeline_req_mu_) = -1;

  void ApplyTimelineRequest() EXCLUDES(timeline_req_mu_);

  // Cross-rank clock alignment (docs/tracing.md): offset ± error of this
  // rank's steady clock vs rank 0's, estimated from CLOCK ping-pongs at
  // form-up and refreshed through the control plane while tracing. The
  // atomics are readable from any thread (hvdtpu_clock_offset); everything
  // else is background-thread-owned (Start writes before the spawn).
  std::atomic<int64_t> clock_offset_us_{0};  // atomic: relaxed-counter
  std::atomic<int64_t> clock_err_us_{-1};  // atomic: relaxed-counter
  double clock_synced_at_ = 0;
  double clock_adopted_at_ = 0;
  double clock_ping_sent_at_ = 0;
  bool clock_ping_inflight_ = false;
  // Emit (or refresh) this rank's trace-metadata event: clock offset ±
  // error, steady/wall anchors, sampling rate. No-op while no timeline
  // runs. Background thread (or Start, before the spawn) only.
  void EmitTraceMeta();
  void FailAllOutstanding(const std::string& reason) EXCLUDES(mu_);
  // The negotiated shutdown's steps (background thread).
  void AnnounceShutdown();
  void ExecuteCleanShutdown();
  void CoordinatorMaybeFinishShutdown();

  // Live-metrics registry (metrics.h) + handles pre-resolved in Start() so
  // the background loop's per-cycle updates are pure lock-free atomic ops.
  // Per-op histogram handles are label-dependent and resolved per op (a
  // mutex-guarded map lookup — microseconds against millisecond-scale
  // collectives, background thread only). Declared LAST so the registry's
  // mutex/map do not displace the hot negotiation state above across
  // cache lines.
  Metrics metrics_;
  Counter* m_cycles_ = nullptr;
  Histogram* m_cycle_hist_ = nullptr;
  Gauge* m_queue_depth_ = nullptr;
  Gauge* m_outstanding_ = nullptr;
  Gauge* m_stalled_ = nullptr;
  Counter* m_stall_warnings_ = nullptr;
  Gauge* m_dead_ranks_ = nullptr;
  Gauge* m_cycle_time_gauge_ = nullptr;
  Gauge* m_fusion_threshold_gauge_ = nullptr;
  Gauge* m_cache_enabled_gauge_ = nullptr;
  Gauge* m_crossover_gauge_ = nullptr;
  Gauge* m_hier_gauge_ = nullptr;
  Gauge* m_comp_mode_gauge_ = nullptr;
  Histogram* m_fusion_batch_bytes_ = nullptr;
  Histogram* m_fusion_utilization_ = nullptr;
  Counter* m_fused_tensors_ = nullptr;
  Counter* m_op_errors_ = nullptr;
  Counter* m_failures_detected_ = nullptr;
  Histogram* m_recovery_seconds_ = nullptr;
  Counter* m_flightrec_dumps_ = nullptr;
  // Numerical-health counters (docs/numerics.md): non-finite gradient
  // elements seen, divergence probes run, and error-feedback residual
  // resets (hvdtpu_divergence_total is label-resolved per suspect rank at
  // emission).
  Counter* m_nonfinite_grads_ = nullptr;
  Counter* m_gradcheck_probes_ = nullptr;
  Counter* m_residual_resets_ = nullptr;
  // Clock-sync quality vs rank 0 (alignment), refreshed at every
  // adoption so the aggregator/console can flag degraded ranks.
  Gauge* m_clock_offset_gauge_ = nullptr;
  Gauge* m_clock_err_gauge_ = nullptr;
  // Negotiation-cache effectiveness: requests that rode the bare-name fast
  // path vs full announcements while the cache was tracking (workers count
  // their send decision, rank 0 counts bare-name rematerializations and
  // NEED_FULL repairs).
  Counter* m_cache_hits_ = nullptr;
  Counter* m_cache_misses_ = nullptr;
  // One failure-cascade count per core incarnation: after the plane aborts,
  // every queued op fails with the same coherent status — only the first
  // detection is a new failure (background thread only).
  bool failure_counted_ = false;
};

void Core::RequestTimeline(bool start, const std::string& path,
                           bool mark_cycles, int64_t trace_sample) {
  MutexLock lk(timeline_req_mu_);
  timeline_req_pending_ = true;
  timeline_req_start_ = start;
  timeline_req_path_ = path;
  timeline_req_mark_ = mark_cycles;
  timeline_req_sample_ = trace_sample;
}

void Core::ApplyTimelineRequest() {
  bool pending, start, mark;
  std::string path;
  int64_t sample;
  {
    MutexLock lk(timeline_req_mu_);
    pending = timeline_req_pending_;
    timeline_req_pending_ = false;
    start = timeline_req_start_;
    path = timeline_req_path_;
    mark = timeline_req_mark_;
    sample = timeline_req_sample_;
  }
  if (!pending) return;
  if (start) {
    timeline_.Shutdown();
    timeline_.Initialize(path, cfg_.rank);
    cfg_.timeline_mark_cycles = mark;
    if (sample >= 0) cfg_.trace_sample = sample;
    // This (background) thread is the data plane's single driver, so the
    // sampler can be retargeted here.
    data_plane_.set_trace_sample(cfg_.trace_sample);
    // A runtime-started trace on a worker that skipped the form-up sync
    // (un-traced launch) needs an offset NOW, not one refresh interval
    // from now: age out the sync state so the next pump cycle pings.
    if (cfg_.rank != 0 &&
        clock_err_us_.load(std::memory_order_relaxed) < 0) {
      clock_synced_at_ = 0;
    }
    EmitTraceMeta();
  } else {
    timeline_.Shutdown();
    cfg_.timeline_mark_cycles = false;
  }
}

void Core::EmitTraceMeta() {
  if (!timeline_.Initialized()) return;
  const int64_t unix_us =
      std::chrono::duration_cast<std::chrono::microseconds>(
          std::chrono::system_clock::now().time_since_epoch())
          .count();
  // Hostname rides into JSON: strip the two characters that could corrupt
  // it (quotes/backslashes have no business in a hostname anyway).
  std::string host = cfg_.my_host;
  for (char& c : host) {
    if (c == '"' || c == '\\') c = '_';
  }
  std::string args =
      "{\"rank\": " + std::to_string(cfg_.rank) +
      ", \"size\": " + std::to_string(cfg_.size) +
      ", \"host\": \"" + host + "\"" +
      ", \"clock_offset_us\": " +
      std::to_string(clock_offset_us_.load(std::memory_order_relaxed)) +
      ", \"clock_err_us\": " +
      std::to_string(clock_err_us_.load(std::memory_order_relaxed)) +
      ", \"steady_init_us\": " + std::to_string(timeline_.init_steady_us()) +
      ", \"steady_now_us\": " + std::to_string(Timeline::SteadyAbsUs()) +
      ", \"unix_now_us\": " + std::to_string(unix_us) +
      ", \"trace_sample\": " + std::to_string(cfg_.trace_sample) + "}";
  timeline_.Metadata(args);
}

void Core::ObserveOp(const char* op, double secs, int64_t bytes,
                     const char* algo, const std::string& transport,
                     bool hier, const char* compression, DataType dtype,
                     bool ok, const std::string& perf_sig) {
  MetricLabels labels{{"op", op},
                      {"algo", algo},
                      {"transport", transport},
                      {"hier", hier ? "1" : "0"},
                      {"compression", compression},
                      {"dtype", DataTypeName(dtype)}};
  metrics_
      .GetHistogram("hvdtpu_op_seconds",
                    "Data-plane wall time per collective op", LatencyBuckets(),
                    labels)
      ->Observe(secs);
  metrics_
      .GetHistogram("hvdtpu_op_bytes",
                    "Payload bytes per collective op (raw, pre-compression)",
                    BytesBuckets(), labels)
      ->Observe(static_cast<double>(bytes));
  metrics_
      .GetCounter("hvdtpu_ops_total", "Completed collective ops",
                  MetricLabels{{"op", op}})
      ->Inc();
  if (!ok) m_op_errors_->Inc();

  // Perf attribution (docs/observability.md): feed the streaming baselines
  // and run the slowdown sentry. Failed ops are excluded — their wall time
  // measures abort latency, not performance — and only real tensor-set
  // signatures key a baseline.
  if (!ok || !perfstats_.enabled() || perf_sig.empty()) return;
  // The op type is part of the key: a BROADCAST and an ALLREDUCE of the
  // same tensor name have unrelated cost profiles — sharing a baseline
  // would let the cheaper op drag it down and fire phantom anomalies on
  // the costlier one.
  std::string key;
  key.reserve(perf_sig.size() + transport.size() + 36);
  key += perf_sig;
  key += '|';
  key += algo;
  key += '|';
  key += transport;
  key += hier ? "|1|" : "|0|";
  key += compression;
  key += '|';
  key += op;
  PerfStats::OpSample sample;
  sample.wall_us = static_cast<int64_t>(secs * 1e6);
  sample.wait_us = data_plane_.op_wait_us();
  sample.wire_us = data_plane_.op_wire_us();
  sample.reduce_us = data_plane_.op_reduce_us();
  sample.codec_us = data_plane_.op_codec_us();
  sample.slow_peer = data_plane_.op_slow_peer();
  const int perf_slot = perfstats_.KeySlot(key);
  const PerfStats::Anomaly an = perfstats_.RecordOp(perf_slot, sample);
  if (!an.fired) return;
  metrics_
      .GetCounter(
          "hvdtpu_perf_anomalies_total",
          "Completed ops the slowdown sentry flagged against their rolling "
          "baseline (HVDTPU_PERF_SLOWDOWN_PCT), by dominant phase",
          MetricLabels{{"phase", PerfPhaseName(an.phase)}})
      ->Inc();
  {
    // Flight ring: the anomaly spans the op it flags; arg carries the
    // dominant-phase code, send_peer the wire-slow suspect (-1 otherwise).
    const int64_t now = Timeline::SteadyAbsUs();
    flightrec_.Record(FlightEvent::ANOMALY, flightrec_.InternName(perf_sig),
                      bytes, an.slow_peer, -1, now - sample.wall_us, now,
                      static_cast<int64_t>(an.phase), 0);
  }
  // Per-KEY log throttle (PerfStats::ShouldWarn): each slow key warns at
  // most once per second, but a chatty key can no longer starve a second,
  // different key's first warning — that second key appearing IS the
  // signal ("now codec-bound too").
  if (perfstats_.ShouldWarn(perf_slot, Timeline::SteadyAbsUs())) {
    LogWarn(cfg_.rank,
            "perf sentry: op '%s' ran %.2fx its baseline (%.2f ms vs "
            "%.2f ms), dominant phase %s%s",
            perf_sig.c_str(), an.ratio, sample.wall_us / 1e3,
            an.baseline_us / 1e3, PerfPhaseName(an.phase),
            an.slow_peer >= 0
                ? (" (slow hop peer rank " + std::to_string(an.slow_peer) +
                   ")")
                      .c_str()
                : "");
  }
  if (perf_anomaly_log_.size() < 512) {
    // Tensor names are user-controlled and ride into JSON: escape them
    // properly (quotes/backslashes/control bytes) — a stripped-only key
    // with an embedded newline would corrupt perf_profile.<rank>.json and
    // silently drop this rank from the cross-run merge.
    perf_anomaly_log_.push_back(
        "{\"t_us\": " + std::to_string(Timeline::SteadyAbsUs()) +
        ", \"op\": \"" + op + "\", \"key\": " + JsonEscapeString(key) +
        ", \"wall_us\": " + std::to_string(sample.wall_us) +
        ", \"baseline_us\": " +
        std::to_string(static_cast<int64_t>(an.baseline_us)) +
        ", \"ratio\": " + std::to_string(an.ratio) + ", \"phase\": \"" +
        PerfPhaseName(an.phase) +
        "\", \"slow_peer\": " + std::to_string(an.slow_peer) + "}");
  }
}

void Core::WritePerfProfile() {
  if (cfg_.perf_profile_path.empty() || !perfstats_.enabled() ||
      perf_profile_written_) {
    return;
  }
  perf_profile_written_ = true;
  std::string body = "{\"version\": 1, \"rank\": " +
                     std::to_string(cfg_.rank) +
                     ", \"size\": " + std::to_string(cfg_.size) +
                     ", \"perfstats\": " + perfstats_.SnapshotJson() +
                     ", \"anomalies\": [";
  for (size_t i = 0; i < perf_anomaly_log_.size(); ++i) {
    if (i > 0) body += ", ";
    body += perf_anomaly_log_[i];
  }
  body += "]}\n";
  FILE* f = fopen(cfg_.perf_profile_path.c_str(), "w");
  if (f == nullptr) {
    LogWarn(cfg_.rank, "perf profile: cannot write %s",
            cfg_.perf_profile_path.c_str());
    return;
  }
  fwrite(body.data(), 1, body.size(), f);
  fclose(f);
}

void Core::WriteGradProfile() {
  if (cfg_.grad_profile_path.empty() || !gradstats_.enabled() ||
      grad_profile_written_) {
    return;
  }
  grad_profile_written_ = true;
  std::string body = "{\"version\": 1, \"rank\": " +
                     std::to_string(cfg_.rank) +
                     ", \"size\": " + std::to_string(cfg_.size) +
                     ", \"gradstats\": " + gradstats_.SnapshotJson() + "}\n";
  FILE* f = fopen(cfg_.grad_profile_path.c_str(), "w");
  if (f == nullptr) {
    LogWarn(cfg_.rank, "grad profile: cannot write %s",
            cfg_.grad_profile_path.c_str());
    return;
  }
  fwrite(body.data(), 1, body.size(), f);
  fclose(f);
}

bool Core::NoteNonfinite(const std::string& tensor, const GradMoments& m,
                         int slot) {
  if (m.nonfinite == 0) return false;
  const NanPolicy policy = gradstats_.nan_policy();
  if (policy == NanPolicy::OFF) return false;
  m_nonfinite_grads_->Add(m.nonfinite);
  gradstats_.NoteNonfinite(m.nonfinite);
  // A diverged model floods NaN tensors hundreds of ops per second:
  // throttle the LOG and the flight record per tensor (first event always
  // passes) so the ring keeps the op/hop records a post-mortem needs.
  // Aborts always surface — they are about to freeze the ring anyway.
  const int64_t now = Timeline::SteadyAbsUs();
  if (policy == NanPolicy::ABORT ||
      gradstats_.ShouldWarnNonfinite(slot, now)) {
    flightrec_.Record(FlightEvent::NONFINITE, flightrec_.InternName(tensor),
                      m.nonfinite, -1, -1, now, now,
                      static_cast<int64_t>(policy), 0);
    LogWarn(cfg_.rank,
            "non-finite gradient in tensor '%s': %lld of %lld elements are "
            "NaN/Inf (HVDTPU_NANCHECK=%s)",
            tensor.c_str(), static_cast<long long>(m.nonfinite),
            static_cast<long long>(m.count), NanPolicyName(policy));
  }
  if (policy != NanPolicy::ABORT) return false;
  // Fail-fast forensics BEFORE any lane breaks: this rank's own dump must
  // carry the NONFINITE record (and the NONFINITE reason code) so the
  // post-mortem verdict can name the tensor, not just the rank.
  if (flightrec_.DumpToFile(DumpReason::NONFINITE, cfg_.rank, "",
                            /*fatal_once=*/true) &&
      m_flightrec_dumps_ != nullptr) {
    m_flightrec_dumps_->Inc();
  }
  return true;
}

void Core::MaybeGradcheck(const std::string& name, const void* data,
                          int64_t bytes) {
  if (!gradstats_.enabled() || cfg_.size <= 1 || bytes <= 0) return;
  const int64_t every = gradstats_.gradcheck_sample();
  if (every <= 0) return;
  // The sequence counter advances on EVERY probed-eligible op so all ranks
  // roll the same sampling decision (the knob is env-broadcast uniform).
  const int64_t seq = ++gradcheck_seq_;
  if (seq % every != 0) return;
  const uint32_t crc = Crc32c(data, static_cast<size_t>(bytes));
  gradstats_.NoteProbe();
  m_gradcheck_probes_->Inc();
  if (cfg_.rank == 0) {
    RecordFingerprint(seq, 0, crc, name, bytes);
    return;
  }
  if (control_fd_ < 0) return;
  // Piggybacked control-plane frame: rides the already-open coordinator
  // connection, one small frame per sampled op (cost model in
  // docs/numerics.md) — batched with the cycle's other control traffic.
  Writer w;
  w.I32(static_cast<int32_t>(CtrlMsg::GRADCHECK));
  w.I64(seq);
  w.I64(static_cast<int64_t>(crc));
  w.Str(name);
  outbox_.Queue(control_fd_, w.Take());
}

void Core::RecordFingerprint(int64_t seq, int rank, uint32_t crc,
                             const std::string& name, int64_t bytes) {
  GradcheckSlot& slot = gradcheck_pending_[seq];
  if (slot.crcs.empty()) {
    slot.crcs.assign(cfg_.size, 0);
    slot.have.assign(cfg_.size, 0);
  }
  if (rank < 0 || rank >= cfg_.size || slot.have[rank] != 0) return;
  slot.crcs[rank] = crc;
  slot.have[rank] = 1;
  ++slot.count;
  if (!name.empty()) slot.name = name;
  if (bytes > 0) slot.bytes = bytes;
  if (slot.count < cfg_.size) {
    // Bound the pending table: a rank that shut down (or lost its frame)
    // must not pin entries forever — drop the oldest incomplete probes.
    while (gradcheck_pending_.size() > 256) {
      gradcheck_pending_.erase(gradcheck_pending_.begin());
    }
    return;
  }
  // Every rank reported: majority vote. The majority fingerprint is the
  // most frequent value (ties broken toward the lowest holding rank, so a
  // 1v1 world convicts rank 1, matching the verdict convention that rank 0
  // holds the reference copy of negotiated state).
  std::unordered_map<uint32_t, int> freq;
  for (int r = 0; r < cfg_.size; ++r) ++freq[slot.crcs[r]];
  uint32_t majority = slot.crcs[0];
  int best = 0;
  for (int r = 0; r < cfg_.size; ++r) {
    const int f = freq[slot.crcs[r]];
    if (f > best) {
      best = f;
      majority = slot.crcs[r];
    }
  }
  if (best < cfg_.size) {
    for (int r = 0; r < cfg_.size; ++r) {
      if (slot.crcs[r] == majority) continue;
      // Silent data corruption (or non-determinism): the invariant every
      // collective here guarantees — bitwise-identical outputs on every
      // rank (made even the compressed paths honor it) — broke.
      gradstats_.NoteDivergence();
      metrics_
          .GetCounter(
              "hvdtpu_divergence_total",
              "Cross-rank divergence-probe mismatches: sampled "
              "post-allreduce outputs whose crc32c differed from the "
              "world's majority (silent data corruption or "
              "non-determinism), by minority rank",
              MetricLabels{{"suspect", std::to_string(r)}})
          ->Inc();
      const int64_t now = Timeline::SteadyAbsUs();
      flightrec_.Record(FlightEvent::DIVERGENCE,
                        flightrec_.InternName(slot.name), slot.bytes, r, -1,
                        now, now, static_cast<int64_t>(slot.crcs[r]), 0);
      LogWarn(0,
              "DIVERGENCE: tensor '%s' (probe #%lld) — rank %d's "
              "post-allreduce fingerprint %08x differs from the majority "
              "%08x; silent data corruption or non-determinism",
              slot.name.c_str(), static_cast<long long>(seq), r,
              slot.crcs[r], majority);
    }
  }
  gradcheck_pending_.erase(seq);
}

void Core::UpdateParamGauges(double cycle_ms, int64_t fusion, bool cache_on,
                             int64_t crossover) {
  m_cycle_time_gauge_->Set(cycle_ms);
  m_fusion_threshold_gauge_->Set(static_cast<double>(fusion));
  m_cache_enabled_gauge_->Set(cache_on ? 1 : 0);
  m_crossover_gauge_->Set(static_cast<double>(crossover));
  // hier/compression are read back from the just-applied state so the
  // gauges always show the EFFECTIVE values (forced or autotuned).
  m_hier_gauge_->Set(data_plane_.hier_active() ? 1 : 0);
  const int32_t comp =
      cfg_.wire_compression == static_cast<int32_t>(WireCompression::AUTO)
          ? comp_auto_
          : cfg_.wire_compression;
  m_comp_mode_gauge_->Set(static_cast<double>(comp));
}

double Core::CurrentCycleTimeMs() {
  MutexLock lk(mu_);
  return cycle_time_ms_;
}

int64_t Core::CurrentFusionThreshold() {
  MutexLock lk(mu_);
  return fusion_threshold_;
}

Status Core::Start() {
  if (started_) return Status::OK();
  if (!cfg_.timeline_path.empty()) {
    timeline_.Initialize(cfg_.timeline_path, cfg_.rank);
  }
  cache_.SetCapacity(cfg_.cache_capacity);

  // Metrics registry: route data-plane byte accounting into this core's
  // registry (single source of truth behind hvdtpu_wire_stats AND /metrics)
  // and pre-resolve every fixed-label handle the background loop touches.
  data_plane_.set_metrics(&metrics_);
  metrics_.GetGauge("hvdtpu_rank", "This worker's global rank")
      ->Set(cfg_.rank);
  metrics_.GetGauge("hvdtpu_world_size", "Number of ranks in the world")
      ->Set(cfg_.size);
  m_cycles_ = metrics_.GetCounter(
      "hvdtpu_cycles_total", "Background-loop coordination cycles run");
  m_cycle_hist_ = metrics_.GetHistogram(
      "hvdtpu_cycle_seconds",
      "Coordination tick latency: wall time of one background-loop cycle "
      "(control-plane pump + any collectives it executed)",
      LatencyBuckets());
  m_queue_depth_ = metrics_.GetGauge(
      "hvdtpu_negotiation_queue_depth",
      "Coordinator message_table_ size: tensors announced by some ranks "
      "and still waiting for the rest (always 0 on non-coordinators)");
  m_outstanding_ = metrics_.GetGauge(
      "hvdtpu_outstanding_ops",
      "Collectives enqueued on this rank and not yet completed");
  m_stalled_ = metrics_.GetGauge(
      "hvdtpu_stalled",
      "1 while the stall inspector sees at least one tensor past the "
      "warning threshold, else 0 (coordinator only)");
  m_stall_warnings_ = metrics_.GetCounter(
      "hvdtpu_stall_warnings_total", "Stall warnings emitted by rank 0");
  m_dead_ranks_ = metrics_.GetGauge(
      "hvdtpu_dead_ranks",
      "Workers that disconnected without joining (coordinator only)");
  m_cycle_time_gauge_ = metrics_.GetGauge(
      "hvdtpu_cycle_time_ms", "Current (possibly autotuned) cycle time");
  m_fusion_threshold_gauge_ = metrics_.GetGauge(
      "hvdtpu_fusion_threshold_bytes",
      "Current (possibly autotuned) tensor-fusion threshold");
  m_cache_enabled_gauge_ = metrics_.GetGauge(
      "hvdtpu_cache_enabled",
      "1 when the response-cache bare-name fast path is active");
  m_crossover_gauge_ = metrics_.GetGauge(
      "hvdtpu_algo_crossover_bytes",
      "Current (possibly autotuned) ring/latency-algorithm crossover");
  m_hier_gauge_ = metrics_.GetGauge(
      "hvdtpu_hier_enabled",
      "1 when the hierarchical two-level allreduce is on (forced or "
      "autotuned)");
  m_comp_mode_gauge_ = metrics_.GetGauge(
      "hvdtpu_compression_mode",
      "Effective wire-compression mode code (0 none, 1 fp16, 2 int8, "
      "3 int4; under auto, the autotuner's current choice)");
  m_fusion_batch_bytes_ = metrics_.GetHistogram(
      "hvdtpu_fusion_batch_bytes",
      "Total payload bytes per fused allreduce batch", BytesBuckets());
  m_fusion_utilization_ = metrics_.GetHistogram(
      "hvdtpu_fusion_utilization",
      "Fused batch bytes as a fraction of the fusion threshold",
      {0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0});
  m_fused_tensors_ = metrics_.GetCounter(
      "hvdtpu_fused_tensors_total",
      "Tensors that rode a multi-tensor fused allreduce batch");
  m_op_errors_ = metrics_.GetCounter(
      "hvdtpu_op_errors_total", "Collectives that completed with an error");
  m_failures_detected_ = metrics_.GetCounter(
      "hvdtpu_failures_detected_total",
      "Peer failures detected by this rank (data-plane lane death, "
      "liveness-deadline trips, worker disconnects with ops pending)");
  m_recovery_seconds_ = metrics_.GetHistogram(
      "hvdtpu_recovery_seconds",
      "Failure-detection to successful re-initialization latency, observed "
      "by the elastic runtime after each recovery", LatencyBuckets());
  m_flightrec_dumps_ = metrics_.GetCounter(
      "hvdtpu_flightrec_dumps_total",
      "Flight-recorder dump files written (abort cascade, stall "
      "escalation, or on demand; fatal-signal dumps happen after the "
      "registry is unreachable and are not counted)");
  // Clock-sync quality (docs/tracing.md): this rank's steady-clock offset
  // vs rank 0 and the estimator's error bound. err = -1 until the first
  // sync, so the aggregator/console can flag never-aligned ranks.
  m_clock_offset_gauge_ = metrics_.GetGauge(
      "hvdtpu_clock_offset_us",
      "Steady-clock offset vs rank 0 in microseconds (NTP-style "
      "alignment; 0 on rank 0)");
  m_clock_err_gauge_ = metrics_.GetGauge(
      "hvdtpu_clock_err_us",
      "Error bound of the clock-offset estimate in microseconds "
      "(-1 = never synced)");
  m_clock_err_gauge_->Set(-1);

  // Failure detection + fault injection (docs/fault-tolerance.md): slices
  // bound abort-propagation latency on every lane, the read deadline
  // catches hung-but-alive peers, the form-up timeout bounds mesh
  // establishment, and any armed chaos spec rides into the data plane.
  data_plane_.set_failure_detect_ms(cfg_.failure_detect_ms);
  data_plane_.set_read_deadline_secs(cfg_.read_deadline_secs);
  data_plane_.set_formup_timeout_ms(
      static_cast<int64_t>(cfg_.formup_timeout_secs * 1000.0));
  data_plane_.set_chaos(cfg_.chaos);
  // Distributed tracing: the data plane emits per-hop child spans into this
  // core's timeline for every trace_sample-th op (docs/tracing.md).
  data_plane_.set_tracer(&timeline_);
  data_plane_.set_trace_sample(cfg_.trace_sample);
  // Always-on flight recorder: every hop/op/failure event lands in the
  // in-memory ring regardless of trace sampling; the fatal-signal handlers
  // dump the MOST RECENTLY started core's ring (one live core per worker
  // process in production — in-process test worlds get the last one).
  flightrec_.Configure(cfg_.flightrec_events, cfg_.flightrec_dir, cfg_.rank,
                       cfg_.size);
  data_plane_.set_flightrec(&flightrec_);
  if (flightrec_.enabled()) {
    InstallFlightSignalHandlers();
    SetSignalFlightRecorder(&flightrec_);
  }
  // Always-on perf attribution (docs/observability.md): streaming per-key
  // baselines + the slowdown sentry, fed from the same hop instrumentation
  // the flight recorder rides.
  perfstats_.Configure(cfg_.perfstats, cfg_.perf_slowdown_pct,
                       cfg_.perf_min_samples);
  data_plane_.set_perf_enabled(perfstats_.enabled());
  // Numerical-health telemetry (docs/numerics.md): gradient moments fold
  // into the fusion copy-in, quantization quality into the compressed
  // hops, and the divergence probe fingerprints every Nth op's output.
  gradstats_.Configure(cfg_.gradstats,
                       static_cast<NanPolicy>(cfg_.nancheck),
                       cfg_.gradcheck_sample);
  m_nonfinite_grads_ = metrics_.GetCounter(
      "hvdtpu_nonfinite_grads_total",
      "NaN/Inf gradient elements seen at fusion copy-in "
      "(HVDTPU_NANCHECK; docs/numerics.md)");
  m_gradcheck_probes_ = metrics_.GetCounter(
      "hvdtpu_gradcheck_probes_total",
      "Cross-rank divergence probes this rank ran: sampled post-allreduce "
      "outputs fingerprinted and reported to rank 0 "
      "(HVDTPU_GRADCHECK_SAMPLE)");
  m_residual_resets_ = metrics_.GetCounter(
      "hvdtpu_residual_resets_total",
      "Error-feedback residual buffers dropped mid-run (element count "
      "changed on a live key — refused fusion or reshape — or the store "
      "hit its entry cap); compression quality restarts from zero "
      "feedback");
  // Always-available sampling profiler (docs/profiling.md): the background
  // loop registers itself once it starts; a window runs only on demand
  // (/profz, hvd.profile()) — except under hvdrun --profile, whose
  // prof_path arms a whole-job window right here.
  profiler_.Configure(cfg_.prof, cfg_.prof_hz, cfg_.prof_capacity,
                      static_cast<ProfClock>(cfg_.prof_clock), cfg_.rank);
  if (profiler_.enabled() && !cfg_.prof_path.empty()) profiler_.Start();
  // Memory-occupancy telemetry (docs/profiling.md "Memory telemetry"):
  // fusion-buffer occupancy/high-water, ResidualStore bytes, per-lane shm
  // ring occupancy, and process RSS/peak-RSS — refreshed by the background
  // loop once per second.
  m_fusion_buffer_gauge_ = metrics_.GetGauge(
      "hvdtpu_fusion_buffer_bytes",
      "Payload bytes of the most recent fused allreduce batch (the live "
      "fusion-buffer occupancy)");
  m_fusion_highwater_gauge_ = metrics_.GetGauge(
      "hvdtpu_fusion_buffer_highwater_bytes",
      "Largest fused batch this core has executed (fusion-buffer "
      "high-water mark)");
  m_residual_bytes_gauge_ = metrics_.GetGauge(
      "hvdtpu_residual_store_bytes",
      "Bytes held by the wire-compression error-feedback ResidualStore");
  m_rss_gauge_ = metrics_.GetGauge(
      "hvdtpu_rss_bytes", "Resident set size of this worker process");
  m_rss_peak_gauge_ = metrics_.GetGauge(
      "hvdtpu_rss_peak_bytes",
      "Peak resident set size of this worker process (getrusage ru_maxrss)");
  // Negotiation-cache effectiveness (docs/metrics.md): steady-state cycles
  // over a repeating tensor set should be all hits after the first
  // negotiation — a rising miss rate means eviction churn (capacity too
  // small) or requests that keep changing shape.
  m_cache_hits_ = metrics_.GetCounter(
      "hvdtpu_negotiation_cache_hits_total",
      "Negotiation requests that rode the response-cache bare-name fast "
      "path (workers: sent name-only; rank 0: rematerialized from cache)");
  m_cache_misses_ = metrics_.GetCounter(
      "hvdtpu_negotiation_cache_misses_total",
      "Negotiation requests sent or received in full while the cache was "
      "tracking (first sight, changed request, eviction, or NEED_FULL "
      "repair)");
  // Control-plane batching (docs/metrics.md): frames/batches is the
  // syscall amplification the CtrlOutbox removes — with HVDTPU_CTRL_BATCH=0
  // the two counters advance in lockstep.
  outbox_.set_enabled(cfg_.ctrl_batch != 0);
  outbox_.set_counters(
      metrics_.GetCounter(
          "hvdtpu_ctrl_frames_total",
          "Control-plane frames this rank produced (READY/RESPONSES/CLOCK/"
          "GRADCHECK/...; each is one syscall when batching is off)"),
      metrics_.GetCounter(
          "hvdtpu_ctrl_batches_total",
          "Vectored control-plane sends issued (one per peer per flush "
          "under HVDTPU_CTRL_BATCH=1; equals frames_total when off)"));

  data_plane_.set_allreduce_algo(
      static_cast<AllreduceAlgo>(cfg_.allreduce_algo));
  data_plane_.set_crossover_bytes(cfg_.allreduce_crossover);
  data_plane_.set_segment_bytes(cfg_.allreduce_segment);
  data_plane_.set_sa_min_group(cfg_.allreduce_sa_group);
  data_plane_.set_bcast_flat_max(cfg_.bcast_flat_max);
  data_plane_.set_shm_enabled(cfg_.shm_enabled != 0);
  data_plane_.set_shm_ring_bytes(cfg_.shm_ring_bytes);
  data_plane_.set_hier_mode(static_cast<HierMode>(cfg_.allreduce_hier));
  data_plane_.set_tcp_zerocopy(static_cast<ZeroCopyMode>(cfg_.tcp_zerocopy));
  data_plane_.set_shm_numa(static_cast<ShmNumaMode>(cfg_.shm_numa));
  data_plane_.set_doorbell_batch(cfg_.doorbell_batch);
  // Wire-compression skip list (Python validates the pattern too; a bad
  // regex smuggled past it must fail loudly, not silently compress biases).
  comp_skip_set_ = false;
  if (!cfg_.compression_skip_regex.empty()) {
    try {
      comp_skip_re_ = std::regex(cfg_.compression_skip_regex,
                                 std::regex::icase | std::regex::nosubs);
      comp_skip_set_ = true;
    } catch (const std::regex_error& e) {
      return Status::Error(StatusCode::INVALID_ARGUMENT,
                           std::string("bad HVDTPU_COMPRESSION_SKIP_REGEX: ") +
                               e.what());
    }
  }
  comp_auto_ = 0;  // HVDTPU_COMPRESSION=auto starts dense until tuned
  // (Re)create the wake pipe. The previous pipe, if any, is closed only
  // here and in the destructor — never in Shutdown — so a user thread's
  // Wake() racing a concurrent Shutdown can at worst write one byte into a
  // still-open pipe, not into a closed-and-reused fd.
  CloseFd(wake_pipe_[0]);
  CloseFd(wake_pipe_[1]);
  if (pipe(wake_pipe_) != 0) {
    wake_pipe_[0] = wake_pipe_[1] = -1;
    return Status::Error(StatusCode::ABORTED, "cannot create wake pipe");
  }
  fcntl(wake_pipe_[0], F_SETFL, O_NONBLOCK);
  fcntl(wake_pipe_[1], F_SETFL, O_NONBLOCK);
  Status st = data_plane_.Listen();
  if (!st.ok()) return st;

  // Rendezvous over the control plane (fills the role of the reference's HTTP
  // KV store rendezvous, horovod/runner/http/http_server.py +
  // gloo/http_store.cc): workers HELLO their data-plane endpoint to rank 0,
  // rank 0 broadcasts the peer table.
  std::vector<PeerAddr> peers(cfg_.size);
  peers[cfg_.rank] = {cfg_.my_host, data_plane_.port()};
  if (cfg_.size > 1) {
    if (cfg_.rank == 0) {
      coord_listen_fd_ = TcpListen(cfg_.coord_port, cfg_.size + 4, nullptr);
      if (coord_listen_fd_ < 0) {
        return Status::Error(StatusCode::ABORTED,
                             "coordinator: cannot listen on port " +
                                 std::to_string(cfg_.coord_port));
      }
      worker_fds_.assign(cfg_.size, -1);
      int pending = cfg_.size - 1;
      int rejects = 0;
      // With auth enabled, every malformed / slow / unauthenticated / dup
      // connection is rejected and accepting continues — a stray client
      // must not be able to kill or join the job (reference: secret.py +
      // authenticated driver_service). Without a secret a bad HELLO aborts
      // loudly: it's a real peer bug, not an attack surface. Note: the
      // proof binds (rank, host, port) but has no nonce — a same-boot
      // replay of a captured HELLO is rejected only by the dup-rank check;
      // full replay protection would need challenge-response.
      const bool authed = !cfg_.secret.empty();
      auto reject = [&](int fd, const char* why) -> bool {
        LogWarn(cfg_.rank, "coordinator: rejecting connection (%s)", why);
        CloseFd(fd);
        return ++rejects <= 1000;
      };
      const int formup_ms =
          std::max(1, static_cast<int>(cfg_.formup_timeout_secs * 1000.0));
      while (pending > 0) {
        // Form-up deadline: a worker that died (or never launched) between
        // spawn and HELLO must not wedge rendezvous forever (the elastic
        // driver retries with a fresh epoch on this failure).
        int fd = TcpAcceptTimeout(coord_listen_fd_, formup_ms);
        if (fd < 0) {
          return Status::Error(
              StatusCode::ABORTED,
              errno == ETIMEDOUT
                  ? "coordinator: rendezvous timed out waiting for " +
                        std::to_string(pending) +
                        " worker(s) (HVDTPU_FORMUP_TIMEOUT_SECONDS)"
                  : "coordinator: accept failed");
        }
        if (authed && !Readable(fd, 10000)) {
          if (reject(fd, "no HELLO within 10s")) continue;
          return Status::Error(StatusCode::ABORTED,
                               "coordinator: too many bad connections");
        }
        std::vector<uint8_t> frame;
        if (RecvFrame(fd, &frame) != 0) {
          if (authed && reject(fd, "hello recv failed")) continue;
          return Status::Error(StatusCode::ABORTED, "coordinator: hello failed");
        }
        Reader r(frame);
        if (static_cast<CtrlMsg>(r.I32()) != CtrlMsg::HELLO) {
          if (authed && reject(fd, "not a HELLO frame")) continue;
          return Status::Error(StatusCode::ABORTED, "coordinator: bad hello");
        }
        int32_t rank = r.I32();
        std::string host = r.Str();
        int32_t port = r.I32();
        if (authed) {
          std::string proof = r.ok() && r.pos() < r.size() ? r.Str() : "";
          std::string expect = HmacSha256Hex(
              cfg_.secret, "hvdtpu-hello:" + std::to_string(rank) + ":" +
                               host + ":" + std::to_string(port));
          if (!r.ok() || !ConstTimeEquals(proof, expect)) {
            if (reject(fd, "bad or missing secret proof")) continue;
            return Status::Error(StatusCode::ABORTED,
                                 "coordinator: too many unauthenticated "
                                 "connection attempts");
          }
        }
        if (rank <= 0 || rank >= cfg_.size) {
          if (authed && reject(fd, "rank out of range")) continue;
          return Status::Error(StatusCode::ABORTED, "coordinator: bad rank");
        }
        if (worker_fds_[rank] != -1) {
          // Duplicate rank (double connect or HELLO replay): keep the first.
          if (authed && reject(fd, "duplicate rank")) continue;
          return Status::Error(StatusCode::ABORTED,
                               "coordinator: duplicate rank in HELLO");
        }
        peers[rank] = {host, port};
        worker_fds_[rank] = fd;
        --pending;
      }
      Writer w;
      w.I32(static_cast<int32_t>(CtrlMsg::PEERS));
      for (const auto& p : peers) {
        w.Str(p.host);
        w.I32(p.port);
      }
      std::vector<uint8_t> payload = w.Take();
      for (int rank = 1; rank < cfg_.size; ++rank) {
        if (SendFrame(worker_fds_[rank], payload) != 0) {
          return Status::Error(StatusCode::ABORTED, "coordinator: peers send");
        }
      }
    } else {
      control_fd_ = TcpConnectRetry(
          cfg_.coord_host, cfg_.coord_port,
          std::max(1, static_cast<int>(cfg_.formup_timeout_secs * 1000.0)));
      if (control_fd_ < 0) {
        return Status::Error(StatusCode::ABORTED,
                             "worker: cannot reach coordinator at " +
                                 cfg_.coord_host + ":" +
                                 std::to_string(cfg_.coord_port));
      }
      Writer w;
      w.I32(static_cast<int32_t>(CtrlMsg::HELLO));
      w.I32(cfg_.rank);
      w.Str(cfg_.my_host);
      w.I32(data_plane_.port());
      if (!cfg_.secret.empty()) {
        w.Str(HmacSha256Hex(
            cfg_.secret, "hvdtpu-hello:" + std::to_string(cfg_.rank) + ":" +
                             cfg_.my_host + ":" +
                             std::to_string(data_plane_.port())));
      }
      if (SendFrame(control_fd_, w.buffer()) != 0) {
        return Status::Error(StatusCode::ABORTED, "worker: hello send failed");
      }
      std::vector<uint8_t> frame;
      if (RecvFrame(control_fd_, &frame) != 0) {
        return Status::Error(StatusCode::ABORTED, "worker: peers recv failed");
      }
      Reader r(frame);
      if (static_cast<CtrlMsg>(r.I32()) != CtrlMsg::PEERS) {
        return Status::Error(StatusCode::ABORTED, "worker: expected PEERS");
      }
      for (int rank = 0; rank < cfg_.size; ++rank) {
        peers[rank].host = r.Str();
        peers[rank].port = r.I32();
      }
    }
    // Cross-rank clock alignment (docs/tracing.md): ping-pong CLOCK frames
    // piggybacked on the form-up handshake, before the data-plane mesh
    // forms. The phase is SELF-DESCRIBING so per-rank config cannot
    // deadlock it: each worker sends as many pings as it wants (8 when a
    // timeline/trace is configured, zero otherwise — un-traced jobs pay
    // one done-marker frame per worker, not 8·(N−1) serialized RTTs at
    // the ROADMAP's w64 scale) and closes with a t1 = -1 marker; rank 0
    // echoes pings until it sees each worker's marker. A later worker's
    // first ping just waits in its socket buffer — the min-RTT estimator
    // discards the queued sample. Runtime-started traces on un-synced
    // workers get their offset from the control-plane refresh instead
    // (ApplyTimelineRequest forces a prompt ping).
    constexpr int kClockPings = 8;
    const int clock_ms =
        std::max(1, static_cast<int>(cfg_.formup_timeout_secs * 1000.0));
    const bool want_clock =
        cfg_.trace_sample > 0 || !cfg_.timeline_path.empty();
    if (cfg_.rank == 0) {
      clock_offset_us_.store(0, std::memory_order_relaxed);
      clock_err_us_.store(0, std::memory_order_relaxed);
      flightrec_.SetClock(0, 0);
      m_clock_offset_gauge_->Set(0);
      m_clock_err_gauge_->Set(0);
      for (int rank = 1; rank < cfg_.size; ++rank) {
        // Bounded serve loop: a buggy peer streaming endless pings must
        // trip form-up failure, not wedge rendezvous.
        for (int k = 0; k <= 8 * kClockPings; ++k) {
          std::vector<uint8_t> frame;
          if (k == 8 * kClockPings || !Readable(worker_fds_[rank], clock_ms) ||
              RecvFrame(worker_fds_[rank], &frame) != 0) {
            return Status::Error(StatusCode::ABORTED,
                                 "coordinator: clock sync with rank " +
                                     std::to_string(rank) + " failed");
          }
          Reader r(frame);
          if (static_cast<CtrlMsg>(r.I32()) != CtrlMsg::CLOCK) {
            return Status::Error(StatusCode::ABORTED,
                                 "coordinator: expected CLOCK frame");
          }
          int64_t t1 = r.I64();
          if (!r.ok()) {
            return Status::Error(StatusCode::ABORTED,
                                 "coordinator: bad CLOCK frame");
          }
          if (t1 < 0) break;  // this worker's done marker
          Writer w;
          w.I32(static_cast<int32_t>(CtrlMsg::CLOCK));
          w.I64(t1);
          w.I64(Timeline::SteadyAbsUs());
          if (SendFrame(worker_fds_[rank], w.buffer()) != 0) {
            return Status::Error(StatusCode::ABORTED,
                                 "coordinator: clock reply send failed");
          }
        }
      }
    } else {
      std::vector<ClockSample> samples;
      samples.reserve(kClockPings);
      for (int k = 0; want_clock && k < kClockPings; ++k) {
        ClockSample s;
        s.t1 = Timeline::SteadyAbsUs();
        Writer w;
        w.I32(static_cast<int32_t>(CtrlMsg::CLOCK));
        w.I64(s.t1);
        w.I64(0);
        std::vector<uint8_t> frame;
        if (SendFrame(control_fd_, w.buffer()) != 0 ||
            !Readable(control_fd_, clock_ms) ||
            RecvFrame(control_fd_, &frame) != 0) {
          return Status::Error(StatusCode::ABORTED,
                               "worker: clock sync with rank 0 failed");
        }
        s.t3 = Timeline::SteadyAbsUs();
        Reader r(frame);
        if (static_cast<CtrlMsg>(r.I32()) != CtrlMsg::CLOCK) {
          return Status::Error(StatusCode::ABORTED,
                               "worker: expected CLOCK frame");
        }
        r.I64();  // our t1, echoed
        s.t2 = r.I64();
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "worker CLOCK", frame);
          continue;
        }
        samples.push_back(s);
      }
      {
        Writer w;  // done marker: sync phase over for this worker
        w.I32(static_cast<int32_t>(CtrlMsg::CLOCK));
        w.I64(-1);
        w.I64(0);
        if (SendFrame(control_fd_, w.buffer()) != 0) {
          return Status::Error(StatusCode::ABORTED,
                               "worker: clock done-marker send failed");
        }
      }
      ClockEstimate est = EstimateClockOffset(samples);
      if (est.valid) {
        clock_offset_us_.store(est.offset_us, std::memory_order_relaxed);
        clock_err_us_.store(est.err_us, std::memory_order_relaxed);
        flightrec_.SetClock(est.offset_us, est.err_us);
        m_clock_offset_gauge_->Set(static_cast<double>(est.offset_us));
        m_clock_err_gauge_->Set(static_cast<double>(est.err_us));
      }
    }
    clock_synced_at_ = NowSeconds();
    clock_adopted_at_ = clock_synced_at_;
    st = data_plane_.Connect(peers);
    if (!st.ok()) return st;
  }

  // Current (possibly previously-autotuned, on a restart) loop parameters.
  double cycle_ms_now;
  int64_t fusion_now;
  {
    MutexLock lk(mu_);
    cycle_ms_now = cycle_time_ms_;
    fusion_now = fusion_threshold_;
  }

  if (cfg_.autotune && cfg_.rank == 0) {
    // After Connect on purpose: the hier switch joins the GP only under
    // AUTO with a topology where the two-level path exists and can matter —
    // 2+ hosts AND some host holding 2+ ranks — judged from the REAL peer
    // table (the launcher-provided local/cross sizes describe only this
    // rank, which may sit alone on its host while other hosts are
    // multi-rank).
    const bool tune_hier = cfg_.allreduce_hier == 2 &&
                           data_plane_.num_hosts() > 1 &&
                           data_plane_.num_hosts() < cfg_.size;
    // The compression categorical joins the GP only under
    // HVDTPU_COMPRESSION=auto (a pinned mode makes the coordinate inert).
    const bool tune_comp =
        cfg_.wire_compression ==
            static_cast<int32_t>(WireCompression::AUTO) &&
        cfg_.size > 1;
    // The scatter-allgather switch joins the GP only when AUTO's
    // big-message dispatch can actually reach it: algorithm unpinned and a
    // world at or past the sa_min_group floor (a smaller world makes the
    // coordinate inert, like the hier/comp gates).
    const bool tune_sa =
        data_plane_.allreduce_algo() == AllreduceAlgo::AUTO &&
        data_plane_.sa_min_group() > 0 &&
        cfg_.size >= data_plane_.sa_min_group();
    param_manager_.Initialize(cycle_ms_now, fusion_now,
                              cfg_.cache_capacity > 0,
                              data_plane_.crossover_bytes(),
                              data_plane_.allreduce_algo() ==
                                  AllreduceAlgo::AUTO,
                              data_plane_.sa_auto(), tune_sa,
                              /*hier_enabled=*/false, tune_hier,
                              /*wire_compression=*/0, tune_comp,
                              cfg_.autotune_log, cfg_.autotune_warmup_samples,
                              cfg_.autotune_cycles_per_sample,
                              cfg_.autotune_max_samples,
                              cfg_.autotune_gp_noise);
  }

  UpdateParamGauges(cycle_ms_now, fusion_now, cache_.enabled(),
                    data_plane_.crossover_bytes());

  // Single-rank worlds ARE rank 0: their clock is the global axis.
  if (cfg_.size == 1) {
    clock_offset_us_.store(0, std::memory_order_relaxed);
    clock_err_us_.store(0, std::memory_order_relaxed);
    flightrec_.SetClock(0, 0);
    m_clock_offset_gauge_->Set(0);
    m_clock_err_gauge_->Set(0);
  }
  // A timeline opened via HVDTPU_TIMELINE/HVDTPU_TRACE gets its metadata
  // now that the clock offset is known (runtime starts emit theirs in
  // ApplyTimelineRequest).
  EmitTraceMeta();

  shutdown_ = false;
  background_ = std::thread([this] { BackgroundLoop(); });
  started_ = true;
  return Status::OK();
}

void Core::Shutdown() {
  if (!started_) return;
  // Ask the background loop to agree on the exit with the peers; it
  // leaves once they have (or at once on a lost connection or a broken
  // world).
  shutdown_requested_ = true;
  Wake();
  if (background_.joinable()) background_.join();
  {
    MutexLock lk(mu_);
    shutdown_ = true;  // under mu_: no lost wakeups for waiters
  }
  cv_.NotifyAll();
  // Cross-run regression sentry (docs/observability.md): persist this
  // rank's per-key baselines + anomaly log. After the join, the
  // background thread's perf state is quiescent.
  WritePerfProfile();
  // Numerical-health profile (docs/numerics.md): per-key norms/SNR for
  // scripts/grad_diff.py, same quiescence argument.
  WriteGradProfile();
  // Whole-job profile (hvdrun --profile): stop the window and persist
  // prof.<rank>.folded for scripts/prof_report.py. The background thread
  // has unregistered its timer by now; the ring is quiescent.
  profiler_.Stop();
  if (!cfg_.prof_path.empty() && profiler_.enabled() && !prof_written_) {
    prof_written_ = true;
    if (!profiler_.WriteFolded(cfg_.prof_path)) {
      LogWarn(cfg_.rank, "profiler: cannot write %s",
              cfg_.prof_path.c_str());
    }
  }
  // Fail any still-outstanding handles.
  {
    MutexLock lk(mu_);
    for (auto& kv : handles_) {
      done_[kv.first] =
          Status::Error(StatusCode::ABORTED, "shut down before completion");
      delete kv.second;
    }
    handles_.clear();
    outstanding_.clear();
    pending_.clear();
  }
  cv_.NotifyAll();
  data_plane_.Shutdown(/*clean=*/clean_exit_);
  if (control_fd_ >= 0) CloseFd(control_fd_);
  if (cfg_.rank == 0) {
    for (int fd : worker_fds_) CloseFd(fd);
    CloseFd(coord_listen_fd_);
  }
  timeline_.Shutdown();
  started_ = false;
}

int64_t Core::Enqueue(TensorEntry entry, Status* status) {
  MutexLock lk(mu_);
  if (shutdown_ || closing_) {
    *status = Status::Error(StatusCode::ABORTED, "core is shut down");
    return -1;
  }
  if (outstanding_.count(entry.name) != 0) {
    // Reference: DUPLICATE_NAME_ERROR (common.h:214, tensor_queue.cc).
    *status = Status::Error(
        StatusCode::DUPLICATE_NAME,
        "Requested to " + std::string("collective on tensor '") + entry.name +
            "' which is already pending; tensor names must be unique among "
            "in-flight operations");
    return -1;
  }
  // AVERAGE == SUM with postscale 1/size (reference: operations.cc:928).
  // Applies to reduce-scatter too: its output chunk is postscaled after the
  // ring phase, exactly like the allreduce's per-entry postscale.
  if ((entry.op_type == OpType::ALLREDUCE ||
       entry.op_type == OpType::REDUCESCATTER) &&
      entry.reduce_op == ReduceOp::AVERAGE) {
    entry.reduce_op = ReduceOp::SUM;
    entry.postscale /= static_cast<double>(cfg_.size);
  }
  auto* e = new TensorEntry(std::move(entry));
  e->enqueued_at_us = Timeline::SteadyAbsUs();
  e->handle = static_cast<int32_t>(next_handle_++);
  handles_[e->handle] = e;
  outstanding_[e->name] = e;
  pending_.push_back(e);
  timeline_.QueueStart(e->name);
  *status = Status::OK();
  int64_t h = e->handle;
  lk.Unlock();
  cv_.NotifyAll();
  Wake();
  return h;
}

void Core::GroupBegin() {
  MutexLock lk(mu_);
  group_hold_ = true;
}

void Core::GroupEnd() {
  {
    MutexLock lk(mu_);
    group_hold_ = false;
  }
  Wake();  // release the whole group into the next announcement cycle
}

Status Core::WaitHandle(int64_t handle) {
  MutexLock lk(mu_);
  while (done_.count(handle) == 0 && !shutdown_.load()) cv_.Wait(lk);
  auto it = done_.find(handle);
  if (it == done_.end()) {
    return Status::Error(StatusCode::ABORTED, "core shut down while waiting");
  }
  return it->second;
}

int Core::PollHandle(int64_t handle) {
  MutexLock lk(mu_);
  return done_.count(handle) != 0 ? 1 : 0;
}

int64_t Core::ResultBytes(int64_t handle) {
  MutexLock lk(mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return -1;
  return static_cast<int64_t>(it->second->output.size());
}

Status Core::CopyResult(int64_t handle, void* dst, int64_t capacity) {
  MutexLock lk(mu_);
  auto hit = handles_.find(handle);
  auto dit = done_.find(handle);
  if (hit == handles_.end() || dit == done_.end()) {
    return Status::Error(StatusCode::INVALID_ARGUMENT, "unknown handle");
  }
  Status st = dit->second;
  TensorEntry* e = hit->second;
  if (st.ok()) {
    if (capacity < static_cast<int64_t>(e->output.size())) {
      return Status::Error(StatusCode::INVALID_ARGUMENT,
                           "result buffer too small");
    }
    memcpy(dst, e->output.data(), e->output.size());
  }
  delete e;
  handles_.erase(hit);
  done_.erase(dit);
  return st;
}

int64_t Core::Join() {
  {
    MutexLock lk(mu_);
    join_pending_local_ = true;
    join_done_ = false;
  }
  cv_.NotifyAll();
  Wake();
  MutexLock lk(mu_);
  while (!join_done_.load() && !shutdown_.load() && !closing_) cv_.Wait(lk);
  if (!join_done_.load()) return -2;  // woken by a broken world, not a join
  return last_joined_rank_.load();
}

void Core::Wake() {
  if (wake_pipe_[1] >= 0) {
    char b = 1;
    // Nonblocking: a full pipe already guarantees a pending wakeup.
    (void)!write(wake_pipe_[1], &b, 1);
  }
}

void Core::WaitForWork() {
  // Event-driven cycle gate (replaces the reference's fixed RunLoopOnce
  // sleep, operations.cc:591): poll the wake pipe (local enqueue/join/
  // shutdown) plus every control-plane fd, so both coordinator and workers
  // react to frames the moment they land instead of sleeping out the cycle
  // time. The cycle time remains the idle-poll timeout (autotune still owns
  // it; its floor is poll's 1 ms granularity).
  std::vector<pollfd> pfds;
  pfds.push_back({wake_pipe_[0], POLLIN, 0});
  if (cfg_.rank == 0) {
    for (int fd : worker_fds_) {
      if (fd >= 0) pfds.push_back({fd, POLLIN, 0});
    }
  } else if (control_fd_ >= 0) {
    pfds.push_back({control_fd_, POLLIN, 0});
  }
  double cycle_ms;
  {
    MutexLock lk(mu_);
    cycle_ms = cycle_time_ms_;
  }
  int timeout = std::max(1, static_cast<int>(std::lround(cycle_ms)));
  (void)poll(pfds.data(), pfds.size(), timeout);
  // Drain the pipe: it is level-triggered bookkeeping, not a byte count.
  char buf[256];
  while (read(wake_pipe_[0], buf, sizeof(buf)) > 0) {
  }
}

HVDTPU_ROLE(background)
void Core::BackgroundLoop() {
  // Sampling profiler: this is the collective-driving thread — the one the
  // flamegraphs are about. Registration creates its (disarmed) per-thread
  // timer; the unregister below pairs with it before the thread exits.
  profiler_.RegisterThread();
  while (!shutdown_) {
    if (worker_failover_pending_.exchange(false)) {
      // A data-plane failure was detected last cycle; the entry walk that
      // detected it has fully unwound, so failing every outstanding handle
      // (and waking user threads) is safe now.
      FailAllOutstanding("a peer process failed during a collective");
      {
        MutexLock lk(mu_);
        shutdown_ = true;
      }
      cv_.NotifyAll();
      break;
    }
    WaitForWork();
    if (shutdown_) break;
    if (shutdown_requested_ && !shutdown_announced_) AnnounceShutdown();
    ApplyTimelineRequest();
    if (cfg_.timeline_mark_cycles) timeline_.MarkCycle();
    const double t0 = NowSeconds();
    PumpControlPlane();
    // End-of-cycle flush: whatever the pump queued and no collective forced
    // out earlier (CLOCK pings/echoes, GRADCHECK piggybacks, PARAMS, READY
    // lists on quiet cycles) ships as one vectored send per peer.
    FlushCtrlOutbox();
    // Coordination-tick accounting: latency of the productive part of the
    // cycle (the idle poll in WaitForWork is deliberately excluded — an
    // idle worker would otherwise bury the signal under cycle_time_ms
    // observations) plus the queue-depth/outstanding gauges.
    m_cycles_->Inc();
    m_cycle_hist_->Observe(NowSeconds() - t0);
    m_queue_depth_->Set(static_cast<double>(message_table_.size()));
    m_dead_ranks_->Set(static_cast<double>(dead_ranks_.size()));
    {
      MutexLock lk(mu_);
      m_outstanding_->Set(static_cast<double>(outstanding_.size()));
    }
    UpdateMemoryGauges();
    if (clean_exit_) break;
    if (shutdown_announced_ && NowSeconds() > shutdown_deadline_) {
      LogWarn(cfg_.rank, "shutdown: the peers did not agree within %.0f s; "
              "closing the lanes", kShutdownAgreeSecs);
      break;
    }
  }
  {
    MutexLock lk(mu_);
    shutdown_ = true;  // a loop that left by agreement takes no more ops
  }
  cv_.NotifyAll();
  profiler_.UnregisterThread();
}

void Core::AnnounceShutdown() {
  shutdown_announced_ = true;
  shutdown_deadline_ = NowSeconds() + kShutdownAgreeSecs;
  if (cfg_.size == 1) {
    clean_exit_ = true;  // no peer reads this rank's lanes
  } else if (cfg_.rank == 0) {
    world_shutdown_ = true;
  } else if (control_fd_ >= 0) {
    Writer w;
    w.I32(static_cast<int32_t>(CtrlMsg::SHUTDOWN_REQ));
    w.I32(cfg_.rank);
    outbox_.Queue(control_fd_, w.Take());
  }
}

void Core::ExecuteCleanShutdown() {
  // Every response before this one has run on this rank, so no lane of a
  // peer is read here any more. What is still outstanding never will run:
  // a peer asked to shut down (reference: SHUT_DOWN_ERROR).
  clean_shutdown_executed_ = true;
  {
    MutexLock lk(mu_);
    closing_ = true;
    for (auto& kv : handles_) {
      if (done_.count(kv.first) == 0) {
        done_[kv.first] = Status::Error(
            StatusCode::ABORTED,
            "a rank shut the world down before this op completed");
        outstanding_.erase(kv.second->name);
      }
    }
    pending_.clear();
  }
  cv_.NotifyAll();
  if (cfg_.rank == 0) {
    shutdown_acks_.insert(0);
  } else if (control_fd_ >= 0) {
    Writer w;
    w.I32(static_cast<int32_t>(CtrlMsg::SHUTDOWN_ACK));
    w.I32(cfg_.rank);
    outbox_.Queue(control_fd_, w.Take());
    FlushCtrlOutbox();
  }
}

void Core::CoordinatorMaybeFinishShutdown() {
  if (!clean_shutdown_executed_ || clean_exit_) return;
  for (int rank = 1; rank < cfg_.size; ++rank) {
    if (worker_fds_[rank] >= 0 && shutdown_acks_.count(rank) == 0) return;
  }
  Writer w;
  w.I32(static_cast<int32_t>(CtrlMsg::SHUTDOWN_FIN));
  std::vector<uint8_t> payload = w.Take();
  for (int rank = 1; rank < cfg_.size; ++rank) {
    if (worker_fds_[rank] >= 0) outbox_.Queue(worker_fds_[rank], payload);
  }
  clean_exit_ = true;
}

void Core::UpdateMemoryGauges(bool force) {
  // Once per second: /proc and the per-lane walks are microseconds, but the
  // loop can cycle every millisecond under load.
  const double now = NowSeconds();
  if (!force && now - last_mem_update_at_ < 1.0) return;
  last_mem_update_at_ = now;
  if (m_residual_bytes_gauge_ != nullptr) {
    m_residual_bytes_gauge_->Set(
        static_cast<double>(residual_store_.TotalBytes()));
  }
  // Per-lane shm-ring occupancy. The gauge handle resolution is a mutex-map
  // lookup per lane — fine at this cadence; lanes are fixed after Connect.
  data_plane_.ShmOccupancy(&shm_occupancy_scratch_);
  for (const auto& lane : shm_occupancy_scratch_) {
    metrics_
        .GetGauge("hvdtpu_shm_ring_occupancy_bytes",
                  "Bytes buffered in the shared-memory rings to one peer "
                  "(both directions; head minus tail)",
                  MetricLabels{{"peer", std::to_string(lane.first)}})
        ->Set(static_cast<double>(lane.second));
  }
  // RSS (current from /proc/self/statm, peak from getrusage): the gauges
  // that catch a fusion-buffer or ring leak growing the process.
  if (m_rss_gauge_ != nullptr) {
    FILE* f = fopen("/proc/self/statm", "r");
    if (f != nullptr) {
      long total = 0, resident = 0;
      if (fscanf(f, "%ld %ld", &total, &resident) == 2) {
        m_rss_gauge_->Set(static_cast<double>(resident) *
                          static_cast<double>(sysconf(_SC_PAGESIZE)));
      }
      fclose(f);
    }
  }
  if (m_rss_peak_gauge_ != nullptr) {
    struct rusage ru;
    if (getrusage(RUSAGE_SELF, &ru) == 0) {
      m_rss_peak_gauge_->Set(static_cast<double>(ru.ru_maxrss) * 1024.0);
    }
  }
}

void Core::PumpControlPlane() {
  // Move newly enqueued entries into the announcement.
  std::vector<Request> reqs;
  bool announce_join = false;
  {
    MutexLock lk(mu_);
    // A grouped-enqueue window is open: leave the queue intact so the whole
    // group announces together in the cycle after GroupEnd releases it.
    while (!group_hold_ && !pending_.empty()) {
      TensorEntry* e = pending_.front();
      pending_.pop_front();
      Request q;
      q.rank = cfg_.rank;
      q.op_type = e->op_type;
      q.reduce_op = e->reduce_op;
      q.dtype = e->dtype;
      q.name = e->name;
      q.shape = e->shape;
      q.prescale = e->prescale;
      q.postscale = e->postscale;
      q.root_rank = e->root_rank;
      q.splits = e->splits;
      reqs.push_back(std::move(q));
      timeline_.NegotiateStart(e->name);
    }
    if (join_pending_local_) {
      join_pending_local_ = false;
      announce_join = true;
    }
  }

  if (cfg_.size == 1) {
    // Single rank: every op is immediately ready; execute locally.
    std::vector<Response> list;
    for (auto& q : reqs) {
      HandleReadyRequests({q});
    }
    if (announce_join) {
      joined_ranks_.insert(0);
      last_joined_rank_ = 0;
    }
    CoordinatorEmitResponses();
    return;
  }

  if (cfg_.rank == 0) {
    if (!reqs.empty()) HandleReadyRequests(std::move(reqs));
    if (announce_join) {
      joined_ranks_.insert(0);
      last_joined_rank_ = 0;
      // A join completes the count of requests already waiting.
      HandleReadyRequests({});
    }
    CoordinatorIngest();
    CheckStalls();
    CoordinatorEmitResponses();
    CoordinatorMaybeFinishShutdown();
  } else {
    if (!reqs.empty()) {
      // Response-cache fast path: a request identical to the last one for the
      // same name travels as just its name (reference: ResponseCache hit
      // skipping negotiation, response_cache.cc; see RequestCache above).
      std::vector<Request> fulls;
      std::vector<std::string> cached;
      for (auto& q : reqs) {
        // CheckAndPut always tracks (keeps this side's entry fresh across
        // autotune cache toggles); enabled() only gates the bare-name wire
        // fast path.
        bool hit = cache_.tracking() && cache_.CheckAndPut(q);
        if (hit && cache_.enabled()) {
          cached.push_back(q.name);
          m_cache_hits_->Inc();
        } else {
          if (cache_.tracking()) m_cache_misses_->Inc();
          fulls.push_back(std::move(q));
        }
      }
      WorkerSendReady(std::move(fulls), std::move(cached));
    }
    if (announce_join) {
      Writer w;
      w.I32(static_cast<int32_t>(CtrlMsg::JOIN));
      w.I32(cfg_.rank);
      outbox_.Queue(control_fd_, w.Take());
    }
    // Periodic clock-sync refresh while a timeline runs (docs/tracing.md):
    // at most one CLOCK ping in flight; the reply is handled in the drain
    // loop below. Gated on the timeline alone — an op-phases-only trace
    // (HVDTPU_TRACE_SAMPLE=0) still needs fresh offsets for the merge.
    // The refresh rides the busy control plane, so its RTT (and error
    // bound) is worse than the quiet form-up sync — the adoption logic
    // keeps the tighter estimate unless it has aged out.
    // A lost reply must not disable refreshing forever: re-arm once the
    // outstanding ping has aged past two intervals.
    if (control_fd_ >= 0 && timeline_.Initialized() &&
        (!clock_ping_inflight_ ||
         NowSeconds() - clock_ping_sent_at_ >
             2.0 * cfg_.clock_sync_interval_secs) &&
        NowSeconds() - clock_synced_at_ > cfg_.clock_sync_interval_secs) {
      Writer w;
      w.I32(static_cast<int32_t>(CtrlMsg::CLOCK));
      w.I64(Timeline::SteadyAbsUs());
      w.I64(0);
      // Queued frames ship at the next flush (same pump); a batched send
      // failure surfaces there, and the two-interval re-arm above recovers
      // the lost ping either way.
      if (outbox_.Queue(control_fd_, w.Take()) == 0) {
        clock_ping_inflight_ = true;
        clock_ping_sent_at_ = NowSeconds();
      }
    }
    // Drain response lists.
    while (control_fd_ >= 0 && Readable(control_fd_, 0)) {
      std::vector<uint8_t> frame;
      if (RecvFrame(control_fd_, &frame) != 0) {
        if (!shutdown_) {
          // EOF with nothing in flight is a peer shutting down at job end;
          // only a mid-operation loss is an error worth failing over.
          bool have_outstanding;
          {
            MutexLock lk(mu_);
            have_outstanding = !outstanding_.empty();
            shutdown_ = true;  // under mu_: no lost wakeups for waiters
          }
          if (have_outstanding) {
            LogWarn(cfg_.rank, "lost connection to coordinator");
          }
          cv_.NotifyAll();
        }
        return;
      }
      Reader r(frame);
      CtrlMsg type = static_cast<CtrlMsg>(r.I32());
      if (type == CtrlMsg::SHUTDOWN_FIN) {
        clean_exit_ = true;  // every rank is past its last op
        return;
      }
      if (type == CtrlMsg::NEED_FULL) {
        // Coordinator evicted a cache entry we hit on — resend in full from
        // the still-outstanding entry (race-free repair path).
        int64_t n = r.I64();
        std::vector<Request> fulls;
        {
          MutexLock lk(mu_);
          for (int64_t i = 0; i < n && r.ok(); ++i) {
            std::string name = r.Str();
            if (!r.ok()) break;
            auto it = outstanding_.find(name);
            if (it == outstanding_.end()) continue;
            TensorEntry* e = it->second;
            Request q;
            q.rank = cfg_.rank;
            q.op_type = e->op_type;
            q.reduce_op = e->reduce_op;
            q.dtype = e->dtype;
            q.name = e->name;
            q.shape = e->shape;
            q.prescale = e->prescale;
            q.postscale = e->postscale;
            q.root_rank = e->root_rank;
            q.splits = e->splits;
            fulls.push_back(std::move(q));
          }
        }
        if (cache_.tracking()) {
          for (auto& q : fulls) cache_.CheckAndPut(q);  // refresh local entry
        }
        if (!fulls.empty()) WorkerSendReady(std::move(fulls), {});
        continue;
      }
      if (type == CtrlMsg::CLOCK) {
        // Refresh reply: recompute the offset from this single ping-pong.
        ClockSample s;
        s.t3 = Timeline::SteadyAbsUs();
        s.t1 = r.I64();
        s.t2 = r.I64();
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "worker CLOCK", frame);
          continue;
        }
        clock_ping_inflight_ = false;
        clock_synced_at_ = NowSeconds();
        ClockEstimate est = EstimateClockOffset({s});
        const int64_t cur_err =
            clock_err_us_.load(std::memory_order_relaxed);
        // Adopt when at least as tight as the current bound, or when the
        // current estimate has aged out — past ~10 refresh periods clock
        // drift beats a stale tight bound.
        if (est.valid &&
            (cur_err < 0 || est.err_us <= cur_err ||
             NowSeconds() - clock_adopted_at_ >
                 10.0 * cfg_.clock_sync_interval_secs)) {
          clock_offset_us_.store(est.offset_us, std::memory_order_relaxed);
          clock_err_us_.store(est.err_us, std::memory_order_relaxed);
          flightrec_.SetClock(est.offset_us, est.err_us);
          m_clock_offset_gauge_->Set(static_cast<double>(est.offset_us));
          m_clock_err_gauge_->Set(static_cast<double>(est.err_us));
          clock_adopted_at_ = NowSeconds();
          EmitTraceMeta();
        }
        continue;
      }
      if (type == CtrlMsg::PARAMS) {
        double cycle = r.F64();
        int64_t fusion = r.I64();
        bool cache_on = r.I32() != 0;
        int64_t crossover = r.I64();
        bool hier_on = r.I32() != 0;
        int32_t comp = r.I32();
        bool sa_on = r.I32() != 0;
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "worker PARAMS", frame);
          continue;
        }
        // data_plane_ is driven by this (background) thread only.
        data_plane_.set_crossover_bytes(crossover);
        data_plane_.set_sa_auto(sa_on);
        data_plane_.set_hier_auto(hier_on);
        comp_auto_ = comp;
        {
          MutexLock lk(mu_);
          cycle_time_ms_ = cycle;
          fusion_threshold_ = fusion;
          cache_.SetEnabled(cache_on);
        }
        UpdateParamGauges(cycle, fusion, cache_on,
                          data_plane_.crossover_bytes());
        continue;
      }
      if (type != CtrlMsg::RESPONSES) continue;
      int64_t n = r.I64();
      std::vector<Response> list;
      for (int64_t i = 0; i < n && r.ok(); ++i) {
        list.push_back(DeserializeResponse(&r));
      }
      if (!r.ok()) {
        LogBadFrame(cfg_.rank, "worker RESPONSES", frame);
        continue;
      }
      ExecuteResponseList(list);
    }
  }
}

void Core::WorkerSendReady(std::vector<Request> reqs,
                           std::vector<std::string> cached) {
  Writer w;
  w.I32(static_cast<int32_t>(CtrlMsg::READY));
  w.I64(static_cast<int64_t>(reqs.size()));
  for (const auto& q : reqs) SerializeRequest(q, &w);
  w.I64(static_cast<int64_t>(cached.size()));
  for (const auto& name : cached) w.Str(name);
  if (outbox_.Queue(control_fd_, w.Take()) != 0 && !shutdown_) {
    LogWarn(cfg_.rank, "failed to send ready list to coordinator");
  }
}

void Core::FlushCtrlOutbox() {
  if (!outbox_.pending()) return;
  int bad_fd = -1;
  if (outbox_.Flush(&bad_fd) != 0 && !shutdown_) {
    // Same policy as the unbatched sends: a failed control write is only
    // logged — the authoritative disconnect signal is the RecvFrame EOF
    // (coordinator ingest / worker drain), which runs the failover path.
    LogWarn(cfg_.rank, "control-plane flush failed (fd %d)", bad_fd);
  }
}

void Core::CoordinatorIngest() {
  for (int rank = 1; rank < cfg_.size; ++rank) {
    int fd = worker_fds_[rank];
    if (fd < 0) continue;
    while (Readable(fd, 0)) {
      std::vector<uint8_t> frame;
      if (RecvFrame(fd, &frame) != 0) {
        if (!shutdown_) {
          // A worker vanished. With ops pending anywhere this breaks the
          // world: fail everything coherently on every rank so elastic mode
          // can catch HvdTpuInternalError and re-rendezvous (reference:
          // HorovodInternalError semantics, horovod/common/exceptions.py).
          bool have_outstanding;
          {
            MutexLock lk(mu_);
            have_outstanding = !outstanding_.empty();
          }
          if (!message_table_.empty() || have_outstanding) {
            LogWarn(0, "worker rank %d disconnected with ops pending", rank);
            m_failures_detected_->Inc();
            world_broken_ = true;
          }
          // Even with nothing in flight, the rank is gone for good (unless it
          // Joined first): any collective announced later can never complete,
          // so it must fail over, not hang (HandleReadyRequests checks this).
          if (!joined_ranks_.count(rank)) dead_ranks_.insert(rank);
          worker_fds_[rank] = -1;
          outbox_.Forget(fd);
          CloseFd(fd);
        }
        break;
      }
      Reader r(frame);
      CtrlMsg type = static_cast<CtrlMsg>(r.I32());
      if (type == CtrlMsg::READY) {
        int64_t n = r.I64();
        std::vector<Request> reqs;
        for (int64_t i = 0; i < n && r.ok(); ++i) {
          Request q = DeserializeRequest(&r);
          if (!r.ok()) break;
          if (cache_.tracking()) cache_.PutRank(q);
          reqs.push_back(std::move(q));
        }
        // Cache-hit names: re-materialize the full request this rank last
        // sent; on a miss (entry evicted here) ask the worker to resend.
        int64_t ncached = r.I64();
        std::vector<std::string> need_full;
        for (int64_t i = 0; i < ncached && r.ok(); ++i) {
          std::string name = r.Str();
          if (!r.ok()) break;
          Request q;
          if (cache_.GetRank(name, rank, &q)) {
            m_cache_hits_->Inc();
            reqs.push_back(std::move(q));
          } else {
            m_cache_misses_->Inc();
            need_full.push_back(std::move(name));
          }
        }
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "coordinator READY", frame);
          continue;
        }
        if (!need_full.empty()) {
          Writer w;
          w.I32(static_cast<int32_t>(CtrlMsg::NEED_FULL));
          w.I64(static_cast<int64_t>(need_full.size()));
          for (const auto& name : need_full) w.Str(name);
          outbox_.Queue(fd, w.Take());
        }
        HandleReadyRequests(std::move(reqs));
      } else if (type == CtrlMsg::SHUTDOWN_REQ) {
        world_shutdown_ = true;
      } else if (type == CtrlMsg::SHUTDOWN_ACK) {
        shutdown_acks_.insert(rank);
      } else if (type == CtrlMsg::JOIN) {
        int32_t who = r.I32();
        joined_ranks_.insert(who);
        last_joined_rank_ = who;
        // A join completes the count of requests already waiting.
        HandleReadyRequests({});
      } else if (type == CtrlMsg::CLOCK) {
        // Clock-sync refresh ping: echo the worker's t1 with our steady
        // now. Served inline — the timestamp is taken here, so coordinator
        // scheduling latency lands in the worker's RTT (and its error
        // bound), never in the offset unnoticed.
        int64_t t1 = r.I64();
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "coordinator CLOCK", frame);
          continue;
        }
        Writer w;
        w.I32(static_cast<int32_t>(CtrlMsg::CLOCK));
        w.I64(t1);
        w.I64(Timeline::SteadyAbsUs());
        outbox_.Queue(fd, w.Take());
      } else if (type == CtrlMsg::GRADCHECK) {
        // Divergence probe report (docs/numerics.md): one sampled op's
        // post-allreduce fingerprint from this worker.
        int64_t seq = r.I64();
        int64_t crc = r.I64();
        std::string name = r.Str();
        if (!r.ok()) {
          LogBadFrame(cfg_.rank, "coordinator GRADCHECK", frame);
          continue;
        }
        RecordFingerprint(seq, rank, static_cast<uint32_t>(crc), name, 0);
      }
    }
  }
}

void Core::HandleReadyRequests(std::vector<Request> reqs) {
  // A request arriving after a (non-joined) peer died can never reach world
  // count — break the world now instead of hanging until the stall timeout.
  if (!reqs.empty() && !dead_ranks_.empty()) {
    LogWarn(0, "collective announced after a peer died; failing over");
    world_broken_ = true;
  }
  // Reference: IncrementTensorCount (controller.cc:838).
  for (auto& q : reqs) {
    auto& slot = message_table_[q.name];
    if (slot.requests.empty()) {
      slot.first_seen = NowSeconds();
      slot.stall_warned = false;
    }
    slot.requests.push_back(std::move(q));
  }
  // Promote names whose count (plus joined ranks) reached world size.
  for (auto& kv : message_table_) {
    size_t have = kv.second.requests.size() + joined_ranks_.size();
    if (have >= static_cast<size_t>(cfg_.size) &&
        std::find(ready_names_.begin(), ready_names_.end(), kv.first) ==
            ready_names_.end()) {
      ready_names_.push_back(kv.first);
    }
  }
}

Response Core::BuildResponse(const std::string& name) {
  // Reference: ConstructResponse (controller.cc:380) — validate that every
  // rank agreed on op/dtype/shape before any data moves, and surface ONE
  // coherent error on all ranks otherwise.
  auto& slot = message_table_[name];
  auto& reqs = slot.requests;
  Response resp;
  resp.names.push_back(name);
  const Request& first = reqs[0];
  resp.op_type = first.op_type;
  resp.reduce_op = first.reduce_op;
  resp.dtype = first.dtype;
  resp.root_rank = first.root_rank;
  resp.shapes.push_back(first.shape);
  resp.prescales.push_back(first.prescale);
  resp.postscales.push_back(first.postscale);

  auto error = [&](const std::string& msg) {
    resp.type = ResponseType::ERROR;
    resp.error_message = msg;
    return resp;
  };

  for (size_t i = 1; i < reqs.size(); ++i) {
    const Request& q = reqs[i];
    if (q.op_type != first.op_type) {
      return error("Mismatched collective operations: rank " +
                   std::to_string(first.rank) + " requested op " +
                   std::to_string(static_cast<int>(first.op_type)) +
                   " but rank " + std::to_string(q.rank) + " requested op " +
                   std::to_string(static_cast<int>(q.op_type)) +
                   " for tensor '" + name + "'");
    }
    if (q.dtype != first.dtype) {
      return error("Mismatched data types: rank " +
                   std::to_string(first.rank) + " has " +
                   DataTypeName(first.dtype) + " but rank " +
                   std::to_string(q.rank) + " has " + DataTypeName(q.dtype) +
                   " for tensor '" + name + "'");
    }
  }

  switch (first.op_type) {
    case OpType::ALLREDUCE:
    case OpType::REDUCESCATTER: {
      for (size_t i = 1; i < reqs.size(); ++i) {
        if (reqs[i].shape != first.shape) {
          return error("Mismatched " +
                       std::string(first.op_type == OpType::ALLREDUCE
                                       ? "allreduce"
                                       : "reducescatter") +
                       " tensor shapes: rank " + std::to_string(first.rank) +
                       " has " + ShapeStr(first.shape) + " but rank " +
                       std::to_string(reqs[i].rank) + " has " +
                       ShapeStr(reqs[i].shape) + " for tensor '" + name + "'");
        }
        if (reqs[i].reduce_op != first.reduce_op) {
          return error("Mismatched reduce ops for tensor '" + name + "'");
        }
      }
      if (first.op_type == OpType::REDUCESCATTER) {
        if (!first.shape.empty() && first.shape[0] % cfg_.size != 0) {
          return error("reducescatter first dimension (" +
                       std::to_string(first.shape[0]) +
                       ") must be divisible by world size (" +
                       std::to_string(cfg_.size) + ") for tensor '" + name +
                       "'");
        }
        // RESPONSES carry the per-rank output shape (dim 0 of each rank's
        // chunk), like allgather — uniform today, but on the wire so the
        // execute path and any future ragged extension key off the
        // negotiated value, not a recomputation.
        resp.first_dims.assign(
            cfg_.size,
            first.shape.empty() ? 0 : first.shape[0] / cfg_.size);
      }
      break;
    }
    case OpType::ALLGATHER: {
      // Ranks may differ in dim 0 only (reference: controller.cc:812-832).
      resp.first_dims.assign(cfg_.size, first.shape.empty() ? 1 : first.shape[0]);
      for (const auto& q : reqs) {
        if (q.shape.size() != first.shape.size()) {
          return error("Mismatched allgather tensor ranks: rank " +
                       std::to_string(first.rank) + " has rank-" +
                       std::to_string(first.shape.size()) +
                       " tensor but rank " + std::to_string(q.rank) +
                       " has rank-" + std::to_string(q.shape.size()) +
                       " tensor for '" + name + "'");
        }
        for (size_t d = 1; d < first.shape.size(); ++d) {
          if (q.shape[d] != first.shape[d]) {
            return error(
                "Mismatched allgather tensor shapes beyond the first "
                "dimension: rank " +
                std::to_string(first.rank) + " has " + ShapeStr(first.shape) +
                " but rank " + std::to_string(q.rank) + " has " +
                ShapeStr(q.shape) + " for tensor '" + name + "'");
          }
        }
        resp.first_dims[q.rank] = q.shape.empty() ? 1 : q.shape[0];
      }
      // Joined ranks contribute zero rows.
      for (int r : joined_ranks_) resp.first_dims[r] = 0;
      break;
    }
    case OpType::BROADCAST: {
      for (const auto& q : reqs) {
        if (q.root_rank != first.root_rank) {
          return error("Mismatched broadcast root ranks: rank " +
                       std::to_string(first.rank) + " has root " +
                       std::to_string(first.root_rank) + " but rank " +
                       std::to_string(q.rank) + " has root " +
                       std::to_string(q.root_rank) + " for tensor '" + name +
                       "'");
        }
        if (q.shape != first.shape) {
          return error("Mismatched broadcast tensor shapes: rank " +
                       std::to_string(first.rank) + " has " +
                       ShapeStr(first.shape) + " but rank " +
                       std::to_string(q.rank) + " has " + ShapeStr(q.shape) +
                       " for tensor '" + name + "'");
        }
      }
      if (joined_ranks_.count(first.root_rank) != 0) {
        return error("broadcast root rank " +
                     std::to_string(first.root_rank) + " has joined");
      }
      break;
    }
    case OpType::ALLTOALL: {
      resp.all_splits.assign(static_cast<size_t>(cfg_.size) * cfg_.size, 0);
      for (const auto& q : reqs) {
        std::vector<int32_t> splits = q.splits;
        int64_t dim0 = q.shape.empty() ? 0 : q.shape[0];
        if (splits.empty()) {
          if (dim0 % cfg_.size != 0) {
            return error("alltoall first dimension (" + std::to_string(dim0) +
                         ") is not divisible by world size (" +
                         std::to_string(cfg_.size) +
                         ") and no splits were given for tensor '" + name +
                         "'");
          }
          splits.assign(cfg_.size,
                        static_cast<int32_t>(dim0 / cfg_.size));
        }
        if (static_cast<int>(splits.size()) != cfg_.size) {
          return error("alltoall splits length (" +
                       std::to_string(splits.size()) +
                       ") != world size for tensor '" + name + "'");
        }
        int64_t total = 0;
        for (auto s : splits) total += s;
        if (total != dim0) {
          return error("alltoall splits sum (" + std::to_string(total) +
                       ") != first dimension (" + std::to_string(dim0) +
                       ") for tensor '" + name + "'");
        }
        for (size_t d = 1; d < q.shape.size(); ++d) {
          if (q.shape[d] != first.shape[d]) {
            return error("Mismatched alltoall tensor shapes beyond the first "
                         "dimension for tensor '" + name + "'");
          }
        }
        for (int r = 0; r < cfg_.size; ++r) {
          resp.all_splits[static_cast<size_t>(q.rank) * cfg_.size + r] =
              splits[r];
        }
      }
      break;
    }
    case OpType::JOIN:
      break;
  }
  return resp;
}

void Core::FailAllOutstanding(const std::string& reason) {
  // The abort cascade reached this rank: freeze the flight ring to disk
  // before anything else unwinds. Latched — a later stall/signal on the
  // same incarnation must not overwrite the first post-mortem.
  if (flightrec_.DumpToFile(DumpReason::ABORT, data_plane_.failed_peer(),
                            "", /*fatal_once=*/true) &&
      m_flightrec_dumps_ != nullptr) {
    m_flightrec_dumps_->Inc();
  }
  MutexLock lk(mu_);
  for (auto& kv : handles_) {
    if (done_.count(kv.first) == 0) {
      done_[kv.first] = Status::Error(StatusCode::ABORTED, reason);
      outstanding_.erase(kv.second->name);
    }
  }
  pending_.clear();
  cv_.NotifyAll();
}

void Core::CoordinatorEmitResponses() {
  // A join barrier in progress can never reach world count once a non-joined
  // peer died: JOIN announcements bypass HandleReadyRequests, so check here.
  if (!joined_ranks_.empty() && !dead_ranks_.empty()) {
    LogWarn(0, "join barrier cannot complete after a peer died; failing over");
    world_broken_ = true;
  }
  if (world_broken_.exchange(false)) {
    // Tell every surviving rank the world is broken, then fail locally.
    Response dead;
    dead.type = ResponseType::SHUTDOWN;
    dead.error_message = "a peer process failed during a collective";
    Writer w;
    w.I32(static_cast<int32_t>(CtrlMsg::RESPONSES));
    w.I64(1);
    SerializeResponse(dead, &w);
    std::vector<uint8_t> payload = w.Take();
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (worker_fds_[rank] >= 0) SendFrame(worker_fds_[rank], payload);
    }
    message_table_.clear();
    ready_names_.clear();
    FailAllOutstanding("a peer process failed during a collective");
    {
      MutexLock lk(mu_);
      shutdown_ = true;
    }
    cv_.NotifyAll();
    return;
  }

  std::vector<Response> list;

  // Fuse ready allreduces with matching (dtype, reduce_op) under the fusion
  // threshold (reference: FuseResponses, controller.cc:686). Snapshot the
  // (autotune-mutable) threshold once per emit pass — the only writer is
  // this same background thread, so it cannot move mid-loop.
  int64_t fusion_threshold_now;
  {
    MutexLock lk(mu_);
    fusion_threshold_now = fusion_threshold_;
  }
  while (!ready_names_.empty()) {
    std::string name = ready_names_.front();
    ready_names_.pop_front();
    Response resp = BuildResponse(name);
    message_table_.erase(name);
    if (resp.type == ResponseType::ERROR) {
      // Don't let future bare-name hits resurrect disagreeing requests.
      cache_.Erase(name);
    }
    if (resp.type == ResponseType::OK &&
        (resp.op_type == OpType::ALLREDUCE ||
         resp.op_type == OpType::BROADCAST)) {
      int64_t fused_bytes =
          NumElements(resp.shapes[0]) *
          static_cast<int64_t>(DataTypeSize(resp.dtype));
      // Look ahead over the remaining ready names for fusable partners.
      // Broadcasts fuse too (the grouped-enqueue payoff): same dtype
      // AND same root — the fused batch packs into one buffer and ships as
      // ONE tree broadcast (shapes may differ; they're independent
      // tensors). Alltoalls stay per-tensor: each carries its own split
      // matrix and packing them would serialize nothing the pairwise
      // schedule doesn't already overlap.
      for (auto it = ready_names_.begin(); it != ready_names_.end();) {
        Response peek = BuildResponse(*it);
        bool fusable =
            peek.type == ResponseType::OK &&
            peek.op_type == resp.op_type &&
            peek.dtype == resp.dtype && peek.reduce_op == resp.reduce_op &&
            (resp.op_type != OpType::BROADCAST ||
             peek.root_rank == resp.root_rank);
        if (fusable) {
          int64_t extra = NumElements(peek.shapes[0]) *
                          static_cast<int64_t>(DataTypeSize(peek.dtype));
          if (fused_bytes + extra > fusion_threshold_now) {
            ++it;
            continue;
          }
          resp.names.push_back(peek.names[0]);
          resp.shapes.push_back(peek.shapes[0]);
          resp.prescales.push_back(peek.prescales[0]);
          resp.postscales.push_back(peek.postscales[0]);
          fused_bytes += extra;
          message_table_.erase(*it);
          it = ready_names_.erase(it);
        } else {
          ++it;
        }
      }
    }
    list.push_back(std::move(resp));
  }

  // A rank asked to shut down: every rank leaves after the ops above.
  if (world_shutdown_ && !clean_shutdown_emitted_) {
    clean_shutdown_emitted_ = true;
    Response bye;
    bye.type = ResponseType::CLEAN_SHUTDOWN;
    list.push_back(std::move(bye));
  }

  // Join barrier complete?
  if (static_cast<int>(joined_ranks_.size()) == cfg_.size) {
    Response j;
    j.type = ResponseType::JOIN_DONE;
    j.op_type = OpType::JOIN;
    j.last_joined_rank = last_joined_rank_.load();
    list.push_back(std::move(j));
    joined_ranks_.clear();
  }

  if (list.empty()) return;

  if (cfg_.size > 1) {
    Writer w;
    w.I32(static_cast<int32_t>(CtrlMsg::RESPONSES));
    w.I64(static_cast<int64_t>(list.size()));
    for (const auto& resp : list) SerializeResponse(resp, &w);
    std::vector<uint8_t> payload = w.Take();
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (worker_fds_[rank] >= 0) outbox_.Queue(worker_fds_[rank], payload);
    }
  }

  // Execute BEFORE adopting any new autotuned parameters: the RESPONSES
  // frame for this list is already on the wire, and workers apply a PARAMS
  // frame only after executing it — if rank 0 adopted a new algo crossover
  // first, both sides could pick different allreduce algorithms for the
  // same tensor and desynchronize the data plane.
  ExecuteResponseList(list);

  if (param_manager_.active()) {
    // Score this cycle by payload bytes moved; adopt + broadcast any new
    // parameters (reference: ParameterManager::Update scored bytes/sec,
    // SynchronizeParameters broadcast, controller.cc:34-48).
    int64_t bytes = 0;
    for (const auto& resp : list) {
      if (resp.type != ResponseType::OK) continue;
      for (const auto& s : resp.shapes) {
        bytes += NumElements(s) * static_cast<int64_t>(DataTypeSize(resp.dtype));
      }
    }
    // Zero-byte lists (ERROR/JOIN_DONE only) are not data cycles; letting
    // them advance the sample would dilute the bytes/sec score with idle
    // time (reference advances samples by per-tensor step counts,
    // parameter_manager.cc:142-160).
    if (bytes > 0 && param_manager_.Update(bytes, NowSeconds())) {
      ParameterManager::Params p = param_manager_.Current();
      data_plane_.set_crossover_bytes(p.algo_crossover);
      data_plane_.set_sa_auto(p.sa_enabled);
      data_plane_.set_hier_auto(p.hier_enabled);
      comp_auto_ = p.wire_compression;
      {
        MutexLock lk(mu_);
        cycle_time_ms_ = p.cycle_time_ms;
        fusion_threshold_ = p.fusion_threshold;
        cache_.SetEnabled(p.cache_enabled);
      }
      UpdateParamGauges(p.cycle_time_ms, p.fusion_threshold, p.cache_enabled,
                        data_plane_.crossover_bytes());
      if (cfg_.size > 1) {
        Writer w;
        w.I32(static_cast<int32_t>(CtrlMsg::PARAMS));
        w.F64(p.cycle_time_ms);
        w.I64(p.fusion_threshold);
        w.I32(p.cache_enabled ? 1 : 0);
        w.I64(p.algo_crossover);
        w.I32(p.hier_enabled ? 1 : 0);
        w.I32(p.wire_compression);
        w.I32(p.sa_enabled ? 1 : 0);
        std::vector<uint8_t> payload = w.Take();
        for (int rank = 1; rank < cfg_.size; ++rank) {
          // Queued (flushed at pump end): a PARAMS frame lands on the wire
          // strictly after the RESPONSES list it was adopted behind.
          if (worker_fds_[rank] >= 0) outbox_.Queue(worker_fds_[rank], payload);
        }
      }
    }
  }
}

void Core::ExecuteResponseList(const std::vector<Response>& list) {
  // Everything queued so far MUST hit the wire before any collective below
  // can block: on rank 0 that includes the RESPONSES list itself (workers
  // cannot join the collective they never heard about), on workers the
  // READY/NEED_FULL repairs the coordinator is polling for.
  FlushCtrlOutbox();
  for (const auto& resp : list) ExecuteResponse(resp);
}

void Core::CompleteEntry(TensorEntry* e, const Status& st) {
  MutexLock lk(mu_);
  outstanding_.erase(e->name);
  done_[e->handle] = st;
  cv_.NotifyAll();
}

void Core::ExecuteResponse(const Response& resp) {
  if (resp.type == ResponseType::CLEAN_SHUTDOWN) {
    ExecuteCleanShutdown();
    return;
  }
  if (resp.type == ResponseType::SHUTDOWN) {
    // Coordinator declared the world broken (a peer died mid-collective).
    FailAllOutstanding(resp.error_message.empty()
                           ? "a peer process failed during a collective"
                           : resp.error_message);
    {
      MutexLock lk(mu_);
      shutdown_ = true;
    }
    cv_.NotifyAll();
    return;
  }
  if (resp.type == ResponseType::JOIN_DONE) {
    {
      // Flag writes must happen under mu_ or a waiter that just evaluated its
      // predicate (false) can block after this notify and hang forever.
      MutexLock lk(mu_);
      last_joined_rank_ = resp.last_joined_rank;
      join_done_ = true;
    }
    cv_.NotifyAll();
    return;
  }

  // Collect local entries (may be absent on joined ranks -> zero tensors,
  // reference: tensor_queue.cc GetTensorEntriesFromResponse).
  std::vector<TensorEntry*> entries;
  std::vector<std::unique_ptr<TensorEntry>> zombies;  // zero stand-ins
  {
    MutexLock lk(mu_);
    for (size_t i = 0; i < resp.names.size(); ++i) {
      auto it = outstanding_.find(resp.names[i]);
      if (it != outstanding_.end()) {
        entries.push_back(it->second);
      } else {
        auto z = std::make_unique<TensorEntry>();
        z->name = resp.names[i];
        z->op_type = resp.op_type;
        z->reduce_op = resp.reduce_op;
        z->dtype = resp.dtype;
        z->shape = resp.shapes[i];
        z->prescale = resp.prescales[i];
        z->postscale = resp.postscales[i];
        z->root_rank = resp.root_rank;
        z->input = nullptr;  // zeros
        z->handle = -1;
        entries.push_back(z.get());
        zombies.push_back(std::move(z));
      }
    }
  }

  for (auto* e : entries) timeline_.NegotiateEnd(e->name);

  if (resp.type == ResponseType::ERROR) {
    Status st = Status::Error(StatusCode::INVALID_ARGUMENT,
                              resp.error_message);
    for (auto* e : entries) {
      if (e->handle >= 0) CompleteEntry(e, st);
    }
    return;
  }

  // Transport tag per op (timeline arg): which lane mix carried it, and
  // whether the allreduce took the hierarchical two-level path. The
  // compression tag sits next to it: the effective wire mode resolved for
  // this (fused) allreduce — identical on every rank (see
  // EffectiveCompression).
  std::string lane = data_plane_.transport_label();
  // Whole negotiated batch in bytes (all fused shapes): the compression
  // gate and the flight ring's OP_BEGIN/OP_END both key on it.
  int64_t batch_bytes = 0;
  for (const auto& s : resp.shapes) {
    batch_bytes +=
        NumElements(s) * static_cast<int64_t>(DataTypeSize(resp.dtype));
  }
  WireCompression comp = WireCompression::NONE;
  if (resp.op_type == OpType::ALLREDUCE && data_plane_.hier_active()) {
    lane += "+hier";
  }
  // Every data-moving op carries the wire-compression dimension now that
  // broadcast ships quantize-once root codes and alltoall quantizes each
  // block for its single receiver; EffectiveCompression still
  // returns NONE for JOIN and for non-fp32 payloads.
  const bool comp_capable = resp.op_type != OpType::JOIN;
  if (comp_capable) comp = EffectiveCompression(resp, batch_bytes);
  const char* opname = resp.op_type == OpType::ALLREDUCE ? "ALLREDUCE"
                       : resp.op_type == OpType::ALLGATHER ? "ALLGATHER"
                       : resp.op_type == OpType::BROADCAST ? "BROADCAST"
                       : resp.op_type == OpType::ALLTOALL ? "ALLTOALL"
                                                          : "REDUCESCATTER";
  for (auto* e : entries) {
    timeline_.ActivityStart(e->name, opname, lane,
                            comp_capable ? WireCompressionName(comp) : "");
  }

  // Flight ring: one OP_BEGIN per dispatched collective under its primary
  // tensor name (fused batches share one data-plane op, like the trace
  // rows). arg = the OpType code; the matching OP_END carries the status;
  // bytes = the whole negotiated batch, same figure ExecuteFusedAllreduce
  // reports at OP_END.
  const int fr_name =
      entries.empty() ? -1 : flightrec_.InternName(entries[0]->name);
  {
    const int64_t now = Timeline::SteadyAbsUs();
    flightrec_.Record(FlightEvent::OP_BEGIN, fr_name, batch_bytes, -1, -1,
                      now, now, static_cast<int64_t>(resp.op_type), 0);
  }

  const double op_t0 = NowSeconds();
  const int64_t fr_t0 = Timeline::SteadyAbsUs();
  // Profiler op tag: samples during this op fold under the (first) tensor's
  // name; the data plane's phase scopes refine WALL into wire/wait/reduce/
  // codec slices underneath it.
  ProfOpScope prof_op(profiler_.InternOp(
      resp.names.empty() ? std::string("<unnamed>") : resp.names[0]));
  Status st = Status::OK();
  switch (resp.op_type) {
    case OpType::ALLREDUCE: {
      // Completion AND timeline finalization happen inside: once
      // CompleteEntry runs, the user thread may CopyResult and free the
      // entry, so nothing here may touch `entries` afterwards.
      ExecuteFusedAllreduce(resp, entries, comp);
      return;
    }
    case OpType::ALLGATHER: {
      TensorEntry* e = entries[0];
      size_t elem = DataTypeSize(e->dtype);
      int64_t row_bytes = static_cast<int64_t>(elem);
      for (size_t d = 1; d < resp.shapes[0].size(); ++d) {
        row_bytes *= resp.shapes[0][d];
      }
      int64_t my_first = e->shape.empty() ? 1 : e->shape[0];
      if (e->input == nullptr) my_first = 0;
      std::vector<int64_t> block_bytes(cfg_.size);
      for (int r = 0; r < cfg_.size; ++r) {
        block_bytes[r] = resp.first_dims[r] * row_bytes;
      }
      // Compressed allgather: quantize-once owner codes on the ring
      // rotation — fp32 only (EffectiveCompression), no error-feedback
      // residual (a gathered payload is a value, not a gradient stream the
      // next iteration can correct).
      const bool grad_on =
          gradstats_.enabled() && resp.dtype == DataType::FLOAT32;
      if (comp != WireCompression::NONE) {
        data_plane_.BeginCompressedOp(comp, nullptr,
                                      grad_on ? &grad_quality_ : nullptr);
      }
      ByteBuf out;
      st = data_plane_.Allgatherv(e->input, my_first * row_bytes, block_bytes,
                                  &out);
      data_plane_.EndCompressedOp();
      if (st.ok()) {
        if (grad_on && comp != WireCompression::NONE) {
          gradstats_.RecordQuality(gradstats_.KeySlot(e->name), comp,
                                   grad_quality_);
        }
        // Divergence probe on the GATHERED vector (extension): every
        // rank holds bitwise-identical bytes — the raw paths move exact
        // blocks, the compressed ring decodes the owners' codes verbatim —
        // which is exactly the allgathered-params invariant the ZeRO-1
        // sharded update stands on (docs/numerics.md).
        MaybeGradcheck(e->name, out.data(),
                       static_cast<int64_t>(out.size()));
        e->output = std::move(out);
      }
      break;
    }
    case OpType::BROADCAST: {
      // May carry multiple fused entries (grouped broadcast): pack
      // the batch into one buffer at the root, run ONE tree broadcast, and
      // slice the result back out — the grouped-enqueue counterpart of
      // ExecuteFusedAllreduce. The single-entry path broadcasts in place.
      const bool grad_on =
          gradstats_.enabled() && resp.dtype == DataType::FLOAT32;
      // Compressed broadcast: quantize-once at the root with
      // self-decode — fp32 only (EffectiveCompression), no error-feedback
      // residual (a broadcast payload is a value, not a gradient stream).
      if (comp != WireCompression::NONE) {
        data_plane_.BeginCompressedOp(comp, nullptr,
                                      grad_on ? &grad_quality_ : nullptr);
      }
      if (entries.size() == 1) {
        TensorEntry* e = entries[0];
        e->output.resize(static_cast<size_t>(e->byte_size()));
        if (cfg_.rank == resp.root_rank && e->input != nullptr) {
          memcpy(e->output.data(), e->input, e->output.size());
        }
        st = data_plane_.Broadcast(e->output.data(),
                                   static_cast<int64_t>(e->output.size()),
                                   resp.root_rank);
        data_plane_.EndCompressedOp();
        if (st.ok()) {
          // Every rank holds bitwise-identical broadcast bytes (raw moves
          // exact bytes; compressed decodes the root's codes verbatim) —
          // the same fingerprint invariant allgather rides.
          MaybeGradcheck(e->name, e->output.data(),
                         static_cast<int64_t>(e->output.size()));
        }
      } else {
        ByteBuf packed(static_cast<size_t>(batch_bytes));
        if (cfg_.rank == resp.root_rank) {
          size_t off = 0;
          for (auto* e : entries) {
            const size_t n = static_cast<size_t>(e->byte_size());
            if (e->input != nullptr) {
              memcpy(packed.data() + off, e->input, n);
            } else {
              memset(packed.data() + off, 0, n);
            }
            off += n;
          }
        }
        st = data_plane_.Broadcast(packed.data(), batch_bytes,
                                   resp.root_rank);
        data_plane_.EndCompressedOp();
        if (st.ok()) {
          MaybeGradcheck(entries[0]->name, packed.data(), batch_bytes);
          size_t off = 0;
          for (auto* e : entries) {
            const size_t n = static_cast<size_t>(e->byte_size());
            e->output.assign(packed.data() + off, packed.data() + off + n);
            off += n;
          }
        }
      }
      if (st.ok() && grad_on && comp != WireCompression::NONE &&
          cfg_.rank == resp.root_rank) {
        // Only the root ran the quantizer; other ranks' accumulators are
        // empty and would dilute the per-key quality baselines.
        gradstats_.RecordQuality(gradstats_.KeySlot(entries[0]->name), comp,
                                 grad_quality_);
      }
      break;
    }
    case OpType::ALLTOALL: {
      TensorEntry* e = entries[0];
      size_t elem = DataTypeSize(e->dtype);
      int64_t row_bytes = static_cast<int64_t>(elem);
      for (size_t d = 1; d < resp.shapes[0].size(); ++d) {
        row_bytes *= resp.shapes[0][d];
      }
      std::vector<int64_t> send_bytes(cfg_.size, 0), recv_bytes(cfg_.size, 0);
      for (int r = 0; r < cfg_.size; ++r) {
        send_bytes[r] =
            resp.all_splits[static_cast<size_t>(cfg_.rank) * cfg_.size + r] *
            row_bytes;
        recv_bytes[r] =
            resp.all_splits[static_cast<size_t>(r) * cfg_.size + cfg_.rank] *
            row_bytes;
      }
      // Joined rank: no input buffer, but the negotiated split matrix says
      // this rank sends nothing (its Request never existed), so a null
      // input only backs zero-byte sends. Guard anyway: a zombie with
      // nonzero sends must contribute zeros, not garbage.
      std::vector<uint8_t> zero_input;
      const void* src = e->input;
      if (src == nullptr) {
        zero_input.assign(static_cast<size_t>(e->byte_size()), 0);
        src = zero_input.data();
      }
      // Compressed alltoall: every block is quantized once at its
      // sender and decoded at its single receiver — fp32 only, no residual
      // (routed activations are values, not gradient streams).
      const bool grad_on =
          gradstats_.enabled() && resp.dtype == DataType::FLOAT32;
      if (comp != WireCompression::NONE) {
        data_plane_.BeginCompressedOp(comp, nullptr,
                                      grad_on ? &grad_quality_ : nullptr);
      }
      ByteBuf out;
      st = data_plane_.Alltoallv(src, send_bytes, recv_bytes, &out);
      data_plane_.EndCompressedOp();
      if (st.ok()) {
        if (grad_on && comp != WireCompression::NONE) {
          gradstats_.RecordQuality(gradstats_.KeySlot(e->name), comp,
                                   grad_quality_);
        }
        // NO MaybeGradcheck here: alltoall outputs legitimately differ per
        // rank — fingerprint-comparing them would convict healthy ranks.
        e->output = std::move(out);
      }
      break;
    }
    case OpType::REDUCESCATTER: {
      TensorEntry* e = entries[0];
      const int64_t total_elems = NumElements(resp.shapes[0]);
      std::vector<uint8_t> input_copy;
      const void* src = e->input;
      if (src == nullptr) {
        input_copy.assign(static_cast<size_t>(e->byte_size()), 0);
        src = input_copy.data();
      } else if (e->prescale != 1.0) {
        // Prescale without touching the user's pinned input buffer.
        input_copy.assign(static_cast<const uint8_t*>(src),
                          static_cast<const uint8_t*>(src) + e->byte_size());
        ScaleBuffer(input_copy.data(), total_elems, resp.dtype, e->prescale);
        src = input_copy.data();
      }
      // Compressed reduce-scatter: the compressed ring allreduce's
      // first half, with the same per-tensor error-feedback residual.
      const bool grad_on =
          gradstats_.enabled() && resp.dtype == DataType::FLOAT32;
      if (comp != WireCompression::NONE) {
        bool residual_reset = false;
        float* residual =
            residual_store_.Get(e->name, total_elems, &residual_reset);
        if (residual_reset) {
          m_residual_resets_->Inc();
          gradstats_.NoteResidualReset();
        }
        data_plane_.BeginCompressedOp(comp, residual,
                                      grad_on ? &grad_quality_ : nullptr);
      }
      ByteBuf out;
      st = data_plane_.ReduceScatter(src, total_elems, e->dtype,
                                     e->reduce_op, &out);
      data_plane_.EndCompressedOp();
      if (st.ok()) {
        if (grad_on && comp != WireCompression::NONE) {
          gradstats_.RecordQuality(gradstats_.KeySlot(e->name), comp,
                                   grad_quality_);
        }
        // AVERAGE arrives as SUM + postscale 1/size (Enqueue), applied to
        // this rank's chunk only — the reduced full vector never exists.
        ScaleBuffer(out.data(),
                    static_cast<int64_t>(out.size()) /
                        static_cast<int64_t>(DataTypeSize(resp.dtype)),
                    resp.dtype, e->postscale);
        e->output = std::move(out);
      }
      break;
    }
    case OpType::JOIN:
      break;
  }

  // Every op carries real algorithm + compression labels now (for
  // reduce-scatter/allgather, for broadcast's bcast_tree/bcast_flat
  // and alltoall's pairwise) — the same dimensions the per-op perf
  // baselines key on.
  if (!entries.empty()) {
    ObserveOp(opname, NowSeconds() - op_t0, entries[0]->byte_size(),
              comp_capable ? data_plane_.last_algo_label() : "none",
              data_plane_.transport_label(), false,
              comp_capable ? WireCompressionName(comp) : "none", resp.dtype,
              st.ok(), entries[0]->name);
  }
  flightrec_.Record(FlightEvent::OP_END, fr_name, batch_bytes, -1, -1,
                    fr_t0, Timeline::SteadyAbsUs(), st.ok() ? 0 : 1, 0);
  if (!st.ok() && data_plane_.aborted()) HandleDataPlaneFailure(st);

  // Reduce-scatter/allgather and broadcast/alltoall all
  // feed the cumulative raw/wire byte counters (their data-plane entry
  // points reset + publish the per-op accumulators), so their timeline
  // op-done events must carry the same figures — /metrics and the timeline
  // tell one story (tests/data/metrics_worker.py pins sum(timeline) ==
  // counter). Only JOIN (no data-plane entry) stays omitted; ALLREDUCE
  // completes inside ExecuteFusedAllreduce, which meters its own.
  const bool byte_metered = resp.op_type == OpType::REDUCESCATTER ||
                            resp.op_type == OpType::ALLGATHER ||
                            resp.op_type == OpType::BROADCAST ||
                            resp.op_type == OpType::ALLTOALL;
  const int64_t done_raw = byte_metered ? data_plane_.op_raw_bytes() : -1;
  const int64_t done_wire = byte_metered ? data_plane_.op_wire_bytes() : -1;
  for (auto* e : entries) {
    timeline_.ActivityEnd(e->name);
    timeline_.OpDone(e->name, st.ok() ? "ok" : st.reason, done_raw,
                     done_wire);
    if (e->handle >= 0) CompleteEntry(e, st);
  }
}

namespace {

// Apply a scalar factor in place (reference: prescale/postscale hooks,
// collective_operations.h:106-136 — incl. the fp16 path). Halp-precision
// scales through float; integers scale in double with round-to-nearest so
// AVERAGE(int) behaves like the framework-side true-division the reference
// falls back to.
void ScaleBuffer(void* data, int64_t count, DataType dtype, double factor) {
  if (factor == 1.0) return;
  switch (dtype) {
    case DataType::FLOAT32: {
      float* p = static_cast<float*>(data);
      for (int64_t i = 0; i < count; ++i) p[i] *= static_cast<float>(factor);
      break;
    }
    case DataType::FLOAT64: {
      double* p = static_cast<double*>(data);
      for (int64_t i = 0; i < count; ++i) p[i] *= factor;
      break;
    }
    case DataType::FLOAT16:
    case DataType::BFLOAT16: {
      uint16_t* p = static_cast<uint16_t*>(data);
      const bool bf = dtype == DataType::BFLOAT16;
      for (int64_t i = 0; i < count; ++i) {
        float f = bf ? Bf16ToFloatPublic(p[i]) : HalfToFloatPublic(p[i]);
        f = static_cast<float>(f * factor);
        p[i] = bf ? FloatToBf16Public(f) : FloatToHalfPublic(f);
      }
      break;
    }
    case DataType::INT32: {
      int32_t* p = static_cast<int32_t*>(data);
      for (int64_t i = 0; i < count; ++i) {
        p[i] = static_cast<int32_t>(llround(p[i] * factor));
      }
      break;
    }
    case DataType::INT64: {
      int64_t* p = static_cast<int64_t*>(data);
      for (int64_t i = 0; i < count; ++i) {
        p[i] = static_cast<int64_t>(llround(p[i] * factor));
      }
      break;
    }
    case DataType::UINT8: {
      uint8_t* p = static_cast<uint8_t*>(data);
      for (int64_t i = 0; i < count; ++i) {
        p[i] = static_cast<uint8_t>(llround(p[i] * factor));
      }
      break;
    }
    case DataType::INT8: {
      int8_t* p = static_cast<int8_t*>(data);
      for (int64_t i = 0; i < count; ++i) {
        p[i] = static_cast<int8_t>(llround(p[i] * factor));
      }
      break;
    }
    case DataType::BOOL:
      break;  // scaling a bool mask is meaningless; leave untouched
  }
}

}  // namespace

WireCompression Core::EffectiveCompression(const Response& resp,
                                           int64_t total_bytes) {
  int32_t mode = cfg_.wire_compression;
  if (mode == static_cast<int32_t>(WireCompression::AUTO)) mode = comp_auto_;
  if (mode == static_cast<int32_t>(WireCompression::NONE)) {
    return WireCompression::NONE;
  }
  if (resp.dtype != DataType::FLOAT32) return WireCompression::NONE;
  // Every data-moving op has a compressed schedule now: the reducing ops
  // and allgather, broadcast (quantize-once root codes) and
  // alltoall (per-block sender codes). JOIN moves no data.
  if (resp.op_type == OpType::JOIN) return WireCompression::NONE;
  // Adasum's adaptive combine needs the exact partials; MIN/MAX/PRODUCT
  // have no meaningful quantized-sum form. reduce_op is per-response (all
  // fused entries share it); allgather/broadcast/alltoall carry no
  // reduction to gate on.
  if ((resp.op_type == OpType::ALLREDUCE ||
       resp.op_type == OpType::REDUCESCATTER) &&
      resp.reduce_op != ReduceOp::SUM &&
      resp.reduce_op != ReduceOp::AVERAGE) {
    return WireCompression::NONE;
  }
  // Small-tensor bypass: below this size the quantization headers and the
  // extra passes cost more than the bytes they save.
  if (total_bytes < cfg_.compression_min_bytes) return WireCompression::NONE;
  // Sensitive-layer skip list (biases/norms): one match anywhere in the
  // fused batch keeps the whole op dense — the batch shares a wire format.
  if (comp_skip_set_) {
    for (const auto& name : resp.names) {
      auto it = comp_skip_memo_.find(name);
      if (it == comp_skip_memo_.end()) {
        if (comp_skip_memo_.size() >= 4096) comp_skip_memo_.clear();
        it = comp_skip_memo_
                 .emplace(name, std::regex_search(name, comp_skip_re_))
                 .first;
      }
      if (it->second) return WireCompression::NONE;
    }
  }
  return static_cast<WireCompression>(mode);
}

void Core::ExecuteFusedAllreduce(const Response& resp,
                                 std::vector<TensorEntry*>& entries,
                                 WireCompression comp) {
  // Reference: fused MemcpyInFusionBuffer -> collective -> MemcpyOut
  // (collective_operations.cc + mpi_operations.cc).
  size_t elem = DataTypeSize(resp.dtype);
  int64_t total_elems = 0;
  for (const auto& s : resp.shapes) total_elems += NumElements(s);
  const int64_t total_bytes = total_elems * static_cast<int64_t>(elem);

  // Fusion-buffer utilization: how full each negotiated batch ran against
  // the (possibly autotuned) threshold. Single-tensor batches count too —
  // a utilization histogram stuck near 0 is the "raise the threshold or
  // slow the cycle" signal the reference surfaces only via timeline
  // archaeology.
  m_fusion_batch_bytes_->Observe(static_cast<double>(total_bytes));
  // Memory telemetry: live fusion-buffer occupancy + high-water mark
  // (docs/profiling.md "Memory telemetry").
  if (m_fusion_buffer_gauge_ != nullptr) {
    m_fusion_buffer_gauge_->Set(static_cast<double>(total_bytes));
    if (total_bytes > fusion_highwater_bytes_) {
      fusion_highwater_bytes_ = total_bytes;
      m_fusion_highwater_gauge_->Set(static_cast<double>(total_bytes));
    }
  }
  {
    int64_t threshold;
    {
      MutexLock lk(mu_);
      threshold = fusion_threshold_;
    }
    if (threshold > 0) {
      m_fusion_utilization_->Observe(static_cast<double>(total_bytes) /
                                     static_cast<double>(threshold));
    }
  }
  if (entries.size() > 1) {
    m_fused_tensors_->Add(static_cast<int64_t>(entries.size()));
  }
  const double op_t0 = NowSeconds();
  const int64_t exec_start_us = Timeline::SteadyAbsUs();
  // FUSION-WAIT trace spans (emitted after the collective, once the data
  // plane has rolled its sampling decision): each tensor's enqueue-to-
  // execution wait on its own row — how long it sat queued/fusing before
  // the batch ran (docs/tracing.md).
  auto emit_fusion_wait = [&](const std::vector<TensorEntry*>& es) {
    for (TensorEntry* te : es) {
      if (te->enqueued_at_us > 0) {
        // Flight ring: unsampled, every batch (arg = tensors in the batch).
        flightrec_.Record(FlightEvent::FUSION_WAIT,
                          flightrec_.InternName(te->name), total_bytes, -1,
                          -1, te->enqueued_at_us, exec_start_us,
                          static_cast<int64_t>(es.size()), 0);
      }
    }
    if (!data_plane_.trace_sampling_op()) return;
    const std::string args =
        "{\"tensors\": " + std::to_string(es.size()) +
        ", \"batch_bytes\": " + std::to_string(total_bytes) + "}";
    for (TensorEntry* te : es) {
      if (te->enqueued_at_us > 0) {
        timeline_.Span(te->name, "FUSION-WAIT", te->enqueued_at_us,
                       exec_start_us, args);
      }
    }
  };

  // Error-feedback residuals live at the compressing rank, keyed by the
  // fused batch's name signature (steady-state fusions reuse the buffer;
  // a changed composition starts fresh — best-effort, like the reference's
  // per-entry feedback buffers).
  float* residual = nullptr;
  if (comp != WireCompression::NONE) {
    std::string key = resp.names.empty() ? std::string() : resp.names[0];
    for (size_t i = 1; i < resp.names.size(); ++i) {
      key += ';';
      key += resp.names[i];
    }
    bool residual_reset = false;
    residual = residual_store_.Get(key, total_elems, &residual_reset);
    if (residual_reset) {
      // A live key's error feedback was dropped (element count changed —
      // refused fusion or reshape — or the store hit its cap). Quality
      // telemetry, not bookkeeping: the accumulated correction restarts
      // from zero, so make it visible (docs/numerics.md).
      m_residual_resets_->Inc();
      gradstats_.NoteResidualReset();
      LogWarn(cfg_.rank,
              "error-feedback residual reset for '%s' (element count "
              "changed mid-run or store overflow); compression restarts "
              "with zero feedback",
              key.c_str());
    }
  }
  // Gradient-health instrumentation for this op (docs/numerics.md):
  // moments fold into the fp32 copy-in below; the compressed hops fill
  // grad_quality_ through the data plane.
  const bool grad_on =
      gradstats_.enabled() && resp.dtype == DataType::FLOAT32;
  data_plane_.BeginCompressedOp(
      comp, residual,
      grad_on && comp != WireCompression::NONE ? &grad_quality_ : nullptr);
  // The per-key signature the health stats are keyed by: the primary
  // tensor for unfused ops (per-layer granularity), primary + batch width
  // for fused batches (same convention as the perf baselines). Built only
  // when gradstats will consume it — off must stay one branch per op.
  const std::string grad_key =
      !grad_on || entries.empty()
          ? std::string()
          : (entries.size() == 1
                 ? entries[0]->name
                 : entries[0]->name + "(+" +
                       std::to_string(entries.size() - 1) + ")");
  // Fail-fast path for HVDTPU_NANCHECK=abort: complete every entry with
  // one coherent error BEFORE any data moves, then break the world — a
  // rank that keeps collectives running on NaN gradients just burns the
  // fleet to diverge the loss.
  auto nan_abort = [&](const std::string& tensor) {
    data_plane_.EndCompressedOp();
    Status st = Status::Error(
        StatusCode::INVALID_ARGUMENT,
        "non-finite gradient in tensor '" + tensor +
            "' (HVDTPU_NANCHECK=abort)");
    flightrec_.Record(
        FlightEvent::OP_END,
        entries.empty() ? -1 : flightrec_.InternName(entries[0]->name),
        total_bytes, -1, -1, exec_start_us, Timeline::SteadyAbsUs(), 1, 0);
    for (auto* e : entries) {
      timeline_.ActivityEnd(e->name);
      timeline_.OpDone(e->name, st.reason);
      if (e->handle >= 0) CompleteEntry(e, st);
    }
    // Break every lane so peers blocked in this collective cascade-fail
    // within one detect slice instead of hanging; then fail over like a
    // data-plane failure (the coordinator broadcasts SHUTDOWN).
    data_plane_.Abort();
    if (cfg_.rank == 0) {
      world_broken_ = true;
    } else {
      worker_failover_pending_ = true;
    }
  };

  if (entries.size() == 1) {
    // Unfused: the entry's output buffer IS the working buffer — one big
    // copy (and one allocation) less than staging through a fusion buffer.
    TensorEntry* e = entries[0];
    const size_t nbytes = static_cast<size_t>(total_elems) * elem;
    if (e->input != nullptr) {
      const uint8_t* in = static_cast<const uint8_t*>(e->input);
      // ByteBuf resize is malloc-only (no zero-fill pass — every byte is
      // about to be overwritten); explicit memcpy keeps glibc's
      // large-copy non-temporal path, which a range insert through the
      // custom allocator would lose.
      e->output.resize(nbytes);
      if (grad_on) {
        // Single-pass fused copy + moments scan (docs/numerics.md): the
        // scan rides the copy's load stream, within the A/B-measured
        // noise of plain memcpy.
        GradMoments m;
        CopyMomentsF32(reinterpret_cast<float*>(e->output.data()),
                       reinterpret_cast<const float*>(in), total_elems,
                       &m);
        const int slot = gradstats_.KeySlot(e->name);
        gradstats_.RecordMoments(slot, m);
        if (NoteNonfinite(e->name, m, slot)) {
          nan_abort(e->name);
          return;
        }
      } else {
        memcpy(e->output.data(), in, nbytes);
      }
      ScaleBuffer(e->output.data(), total_elems, resp.dtype, e->prescale);
    } else {
      e->output.assign(nbytes, 0);
    }
    Status st;
    if (resp.reduce_op == ReduceOp::ADASUM) {
      st = data_plane_.AdasumAllreduce(e->output.data(), total_elems,
                                       resp.dtype);
    } else {
      st = data_plane_.Allreduce(e->output.data(), total_elems, resp.dtype,
                                 resp.reduce_op);
    }
    data_plane_.EndCompressedOp();
    if (st.ok() && grad_on) {
      if (comp != WireCompression::NONE) {
        gradstats_.RecordQuality(gradstats_.KeySlot(grad_key), comp,
                                 grad_quality_);
      }
      // Fingerprint BEFORE postscale: AVERAGE's 1/size postscale is
      // per-entry, the pre-postscale reduction is the bitwise-identical
      // artifact every rank holds.
      if (resp.reduce_op != ReduceOp::ADASUM) {
        MaybeGradcheck(e->name, e->output.data(),
                       static_cast<int64_t>(nbytes));
      }
    }
    ObserveOp("ALLREDUCE", NowSeconds() - op_t0, total_bytes,
              data_plane_.last_algo_label(), data_plane_.transport_label(),
              data_plane_.hier_active(), WireCompressionName(comp),
              resp.dtype, st.ok(), e->name);
    flightrec_.Record(FlightEvent::OP_END, flightrec_.InternName(e->name),
                      total_bytes, -1, -1, exec_start_us,
                      Timeline::SteadyAbsUs(), st.ok() ? 0 : 1, 0);
    if (!st.ok() && data_plane_.aborted()) HandleDataPlaneFailure(st);
    if (st.ok()) {
      ScaleBuffer(e->output.data(), total_elems, resp.dtype, e->postscale);
    }
    emit_fusion_wait(entries);
    timeline_.ActivityEnd(e->name);
    timeline_.OpDone(e->name, st.ok() ? "ok" : st.reason,
                     data_plane_.op_raw_bytes(),
                     data_plane_.op_wire_bytes());
    if (e->handle >= 0) CompleteEntry(e, st);
    return;
  }

  // ByteBuf: malloc-only sizing — every segment is either copied over
  // below or explicitly zeroed (zombie stand-ins), so the old whole-buffer
  // zero-fill pass was pure waste.
  ByteBuf fusion;
  fusion.resize(static_cast<size_t>(total_elems) * elem);

  int64_t off = 0;
  for (size_t i = 0; i < entries.size(); ++i) {
    TensorEntry* e = entries[i];
    int64_t n = NumElements(resp.shapes[i]);
    if (e->input != nullptr) {
      if (grad_on) {
        // Moments fold into the copy-in the fusion buffer already pays
        // for — per TENSOR, so each layer keeps its own norm baseline
        // even inside a fused batch (docs/numerics.md).
        GradMoments m;
        CopyMomentsF32(reinterpret_cast<float*>(fusion.data() + off * elem),
                       reinterpret_cast<const float*>(e->input), n, &m);
        const int slot = gradstats_.KeySlot(e->name);
        gradstats_.RecordMoments(slot, m);
        if (NoteNonfinite(e->name, m, slot)) {
          nan_abort(e->name);
          return;
        }
      } else {
        memcpy(fusion.data() + off * elem, e->input,
               static_cast<size_t>(n) * elem);
      }
      ScaleBuffer(fusion.data() + off * elem, n, resp.dtype, e->prescale);
    } else {
      // Joined rank's zero stand-in: only these segments need zeroing.
      memset(fusion.data() + off * elem, 0, static_cast<size_t>(n) * elem);
    }
    off += n;
  }

  Status st;
  if (resp.reduce_op == ReduceOp::ADASUM) {
    st = data_plane_.AdasumAllreduce(fusion.data(), total_elems, resp.dtype);
  } else {
    st = data_plane_.Allreduce(fusion.data(), total_elems, resp.dtype,
                               resp.reduce_op);
  }
  data_plane_.EndCompressedOp();
  if (st.ok() && grad_on) {
    if (comp != WireCompression::NONE) {
      gradstats_.RecordQuality(gradstats_.KeySlot(grad_key), comp,
                               grad_quality_);
    }
    if (resp.reduce_op != ReduceOp::ADASUM) {
      MaybeGradcheck(grad_key, fusion.data(), total_bytes);
    }
  }
  const int64_t op_raw = data_plane_.op_raw_bytes();
  const int64_t op_wire = data_plane_.op_wire_bytes();
  // Fused batches key their perf baseline on the primary tensor plus the
  // batch width: steady-state fusions recur with the same composition, and
  // a re-fused batch must not be judged against a different one's baseline.
  ObserveOp("ALLREDUCE", NowSeconds() - op_t0, total_bytes,
            data_plane_.last_algo_label(), data_plane_.transport_label(),
            data_plane_.hier_active(), WireCompressionName(comp), resp.dtype,
            st.ok(),
            entries.empty()
                ? std::string()
                : entries[0]->name + "(+" +
                      std::to_string(entries.size() - 1) + ")");
  flightrec_.Record(
      FlightEvent::OP_END,
      entries.empty() ? -1 : flightrec_.InternName(entries[0]->name),
      total_bytes, -1, -1, exec_start_us, Timeline::SteadyAbsUs(),
      st.ok() ? 0 : 1, 0);
  if (!st.ok() && data_plane_.aborted()) HandleDataPlaneFailure(st);
  emit_fusion_wait(entries);

  off = 0;
  for (size_t i = 0; i < entries.size(); ++i) {
    TensorEntry* e = entries[i];
    int64_t n = NumElements(resp.shapes[i]);
    if (st.ok()) {
      ScaleBuffer(fusion.data() + off * elem, n, resp.dtype, e->postscale);
      // resize + memcpy, NOT range-assign: through the ByteBuf's custom
      // allocator a range copy loses libstdc++'s memmove lowering (see
      // common.h) — this is the copy-OUT of up to a full fusion batch.
      e->output.resize(static_cast<size_t>(n) * elem);
      memcpy(e->output.data(), fusion.data() + off * elem,
             static_cast<size_t>(n) * elem);
    }
    off += n;
    // Timeline events BEFORE CompleteEntry: completion hands ownership to
    // the user thread, which may free the entry immediately.
    timeline_.ActivityEnd(e->name);
    timeline_.OpDone(e->name, st.ok() ? "ok" : st.reason, op_raw, op_wire);
    if (e->handle >= 0) CompleteEntry(e, st);
  }
}

void Core::HandleDataPlaneFailure(const Status& st) {
  // Freeze the flight ring NOW, synchronously at detection: the deferred
  // world_broken_/failover consumption runs a background cycle later, and
  // a user thread that sees the op error first may Shutdown() the loop
  // before that cycle happens — losing the post-mortem to a race. The
  // fatal-once latch keeps this and FailAllOutstanding's dump (the
  // SHUTDOWN-response path, whose plane never aborted locally) idempotent.
  if (flightrec_.DumpToFile(DumpReason::ABORT, data_plane_.failed_peer(),
                            "", /*fatal_once=*/true) &&
      m_flightrec_dumps_ != nullptr) {
    m_flightrec_dumps_->Inc();
  }
  if (!failure_counted_) {
    failure_counted_ = true;
    m_failures_detected_->Inc();
    const int peer = data_plane_.failed_peer();
    LogWarn(cfg_.rank,
            "data-plane failure detected%s: %s",
            peer >= 0 ? (" (suspect rank " + std::to_string(peer) + ")")
                            .c_str()
                      : "",
            st.reason.c_str());
    if (peer >= 0 && cfg_.rank == 0) dead_ranks_.insert(peer);
  }
  // Make sure EVERY lane is broken (idempotent): the half-closed sockets
  // and woken futex waiters are how detection cascades rank-to-rank within
  // one detect slice per hop, even to ranks idling between collectives.
  data_plane_.Abort();
  if (cfg_.rank == 0) {
    // Consumed by the next CoordinatorEmitResponses: broadcast SHUTDOWN to
    // every surviving worker, fail local handles, stop the loop.
    world_broken_ = true;
  } else {
    // Worker: fail over so the user thread raises HvdTpuInternalError and
    // elastic mode can re-rendezvous. DEFERRED to the top of the next
    // background cycle (like rank 0's world_broken_): failing the
    // outstanding handles HERE would wake the user thread while the caller
    // (ExecuteResponse) is still walking this response's entries — and a
    // woken waiter may CopyResult and free them mid-walk. The coordinator
    // learns of the failure through its own data plane (it participates in
    // the same collective) or the control-plane EOF.
    worker_failover_pending_ = true;
  }
}

void Core::CheckStalls() {
  // Reference: StallInspector (stall_inspector.{h,cc}) — rank 0 warns when
  // some ranks announced a tensor and others have not for stall_warn_secs,
  // and force-shuts-down after stall_shutdown_secs (stall_inspector.cc
  // ShutdownIfStalled).
  double now = NowSeconds();
  // `stalled` gauge: 1 while ANY tensor sits past the warning threshold
  // (not just at the warning edge — it stays up until the laggard arrives
  // and the slot leaves message_table_, so a scrape can't miss the window).
  bool any_stalled = false;
  for (const auto& kv : message_table_) {
    if (now - kv.second.first_seen >= cfg_.stall_warn_secs) {
      any_stalled = true;
      break;
    }
  }
  m_stalled_->Set(any_stalled ? 1 : 0);
  // AUTO (< 0) resolves to 10x the warning threshold so the escalation is
  // never dead code: a wedged world always breaks eventually instead of
  // hanging until an operator notices (the reference defaults this OFF).
  const double shutdown_secs = EffectiveStallShutdownSecs();
  for (auto& kv : message_table_) {
    auto& slot = kv.second;
    if (shutdown_secs > 0 && now - slot.first_seen > shutdown_secs) {
      LogWarn(0,
              "tensor '%s' stalled for over %.0f s "
              "(HVDTPU_STALL_SHUTDOWN_TIME_SECONDS); aborting the job",
              kv.first.c_str(), shutdown_secs);
      m_failures_detected_->Inc();
      {
        // send_peer = the first rank that never announced the tensor: the
        // post-mortem verdict's prime suspect for a wedged world. Joined
        // ranks legitimately never announce (their contribution is zeros)
        // and dead ranks are already convicted elsewhere — skip both, or
        // the verdict would blame a healthy rank that finished training.
        std::unordered_set<int> ready;
        for (const auto& q : slot.requests) ready.insert(q.rank);
        int missing = -1;
        for (int r = 0; r < cfg_.size; ++r) {
          if (ready.count(r) == 0 && joined_ranks_.count(r) == 0 &&
              dead_ranks_.count(r) == 0) {
            missing = r;
            break;
          }
        }
        const int64_t t = Timeline::SteadyAbsUs();
        flightrec_.Record(FlightEvent::STALL,
                          flightrec_.InternName(kv.first), 0, missing, -1,
                          t, t, /*escalated=*/1, 0);
      }
      if (flightrec_.DumpToFile(DumpReason::STALL, -1, "",
                                /*fatal_once=*/true) &&
          m_flightrec_dumps_ != nullptr) {
        m_flightrec_dumps_->Inc();
      }
      world_broken_ = true;
      return;
    }
    if (slot.stall_warned ||
        now - slot.first_seen < cfg_.stall_warn_secs) {
      continue;
    }
    std::string have, missing;
    std::unordered_set<int> ready_ranks;
    for (const auto& q : slot.requests) ready_ranks.insert(q.rank);
    for (int r = 0; r < cfg_.size; ++r) {
      std::string& tgt = ready_ranks.count(r) ? have : missing;
      if (!tgt.empty()) tgt += ", ";
      tgt += std::to_string(r);
    }
    LogWarn(0,
            "One or more tensors were submitted to be reduced/gathered but "
            "some ranks have not yet done so: tensor '%s' ready on ranks "
            "[%s], waiting on ranks [%s] for %.0f s",
            kv.first.c_str(), have.c_str(), missing.c_str(),
            now - slot.first_seen);
    slot.stall_warned = true;
    m_stall_warnings_->Inc();
    {
      const int64_t t = Timeline::SteadyAbsUs();
      flightrec_.Record(FlightEvent::STALL, flightrec_.InternName(kv.first),
                        0, -1, -1, t, t, /*escalated=*/0, 0);
    }
  }
}

}  // namespace hvdtpu

// ---------------------------------------------------------------------------
// C API (ctypes surface; reference: operations.cc:705-913)
// ---------------------------------------------------------------------------

using hvdtpu::Core;
using hvdtpu::CoreConfig;
using hvdtpu::Status;
using hvdtpu::TensorEntry;

namespace {

void FillErr(const Status& st, char* err, int errlen) {
  if (err != nullptr && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", st.reason.c_str());
  }
}

}  // namespace

extern "C" {

void* hvdtpu_create(int rank, int size, int local_rank, int local_size,
                    int cross_rank, int cross_size, const char* coord_host,
                    int coord_port, const char* my_host, double cycle_time_ms,
                    long long fusion_threshold, const char* timeline_path,
                    int timeline_mark_cycles, double stall_warn_secs) {
  hvdtpu::InstallTerminateHandlerOnce();
  CoreConfig cfg;
  cfg.rank = rank;
  cfg.size = size;
  cfg.local_rank = local_rank;
  cfg.local_size = local_size;
  cfg.cross_rank = cross_rank;
  cfg.cross_size = cross_size;
  cfg.coord_host = coord_host ? coord_host : "127.0.0.1";
  cfg.coord_port = coord_port;
  cfg.my_host = my_host ? my_host : "127.0.0.1";
  cfg.cycle_time_ms = cycle_time_ms;
  cfg.fusion_threshold = fusion_threshold;
  cfg.timeline_path = timeline_path ? timeline_path : "";
  cfg.timeline_mark_cycles = timeline_mark_cycles != 0;
  cfg.stall_warn_secs = stall_warn_secs;
  return new Core(cfg);
}

int hvdtpu_start(void* core, char* err, int errlen) {
  Status st = static_cast<Core*>(core)->Start();
  FillErr(st, err, errlen);
  return st.ok() ? 0 : -1;
}

void hvdtpu_shutdown(void* core) { static_cast<Core*>(core)->Shutdown(); }

void hvdtpu_destroy(void* core) { delete static_cast<Core*>(core); }

long long hvdtpu_enqueue(void* core, const char* name, int op_type,
                         int reduce_op, int dtype, const long long* shape,
                         int ndim, const void* data, double prescale,
                         double postscale, int root_rank, const int* splits,
                         int nsplits, char* err, int errlen) {
  TensorEntry e;
  e.name = name;
  e.op_type = static_cast<hvdtpu::OpType>(op_type);
  e.reduce_op = static_cast<hvdtpu::ReduceOp>(reduce_op);
  e.dtype = static_cast<hvdtpu::DataType>(dtype);
  e.shape.assign(shape, shape + ndim);
  e.input = data;
  e.prescale = prescale;
  e.postscale = postscale;
  e.root_rank = root_rank;
  if (splits != nullptr && nsplits > 0) {
    e.splits.assign(splits, splits + nsplits);
  }
  Status st;
  long long h = static_cast<Core*>(core)->Enqueue(std::move(e), &st);
  FillErr(st, err, errlen);
  return st.ok() ? h : -1;
}

// Dedicated entry points for the first-class reduce-scatter / allgather
// collectives (docs/collectives.md "Reduce-scatter & allgather") — thin
// delegates over hvdtpu_enqueue so ctypes callers get a stable narrow
// signature and a probe-able symbol (basics.py hasattr-gates on these).
long long hvdtpu_enqueue_reducescatter(void* core, const char* name,
                                       int reduce_op, int dtype,
                                       const long long* shape, int ndim,
                                       const void* data, double prescale,
                                       double postscale, char* err,
                                       int errlen) {
  return hvdtpu_enqueue(core, name,
                        static_cast<int>(hvdtpu::OpType::REDUCESCATTER),
                        reduce_op, dtype, shape, ndim, data, prescale,
                        postscale, 0, nullptr, 0, err, errlen);
}

long long hvdtpu_enqueue_allgather(void* core, const char* name, int dtype,
                                   const long long* shape, int ndim,
                                   const void* data, char* err, int errlen) {
  return hvdtpu_enqueue(core, name,
                        static_cast<int>(hvdtpu::OpType::ALLGATHER),
                        static_cast<int>(hvdtpu::ReduceOp::SUM), dtype, shape,
                        ndim, data, 1.0, 1.0, 0, nullptr, 0, err, errlen);
}

// Broadcast / alltoall entry points (docs/collectives.md "Broadcast &
// alltoall") — same thin-delegate pattern. Broadcast: data is the input on
// the root and ignored elsewhere (shape must still agree; the result buffer
// is what every rank reads back). Alltoall: splits is the caller's dim-0
// send-split row, one entry per rank; nullptr means even 1/n splits.
long long hvdtpu_enqueue_broadcast(void* core, const char* name, int dtype,
                                   const long long* shape, int ndim,
                                   const void* data, int root_rank, char* err,
                                   int errlen) {
  return hvdtpu_enqueue(core, name,
                        static_cast<int>(hvdtpu::OpType::BROADCAST),
                        static_cast<int>(hvdtpu::ReduceOp::SUM), dtype, shape,
                        ndim, data, 1.0, 1.0, root_rank, nullptr, 0, err,
                        errlen);
}

long long hvdtpu_enqueue_alltoall(void* core, const char* name, int dtype,
                                  const long long* shape, int ndim,
                                  const void* data, const int* splits,
                                  int nsplits, char* err, int errlen) {
  return hvdtpu_enqueue(core, name,
                        static_cast<int>(hvdtpu::OpType::ALLTOALL),
                        static_cast<int>(hvdtpu::ReduceOp::SUM), dtype, shape,
                        ndim, data, 1.0, 1.0, 0, splits, nsplits, err,
                        errlen);
}

// Grouped-collective window (docs/collectives.md "Grouped enqueue"):
// between begin/end, Enqueue() parks requests without letting the
// background cycle drain them, so the whole group rides one READY /
// RESPONSES round (and, for same-op/dtype lists, one fused execution).
void hvdtpu_group_begin(void* core) {
  static_cast<Core*>(core)->GroupBegin();
}

void hvdtpu_group_end(void* core) { static_cast<Core*>(core)->GroupEnd(); }

int hvdtpu_wait(void* core, long long handle, char* err, int errlen) {
  Status st = static_cast<Core*>(core)->WaitHandle(handle);
  FillErr(st, err, errlen);
  return st.ok() ? 0 : -1;
}

int hvdtpu_poll(void* core, long long handle) {
  return static_cast<Core*>(core)->PollHandle(handle);
}

long long hvdtpu_result_bytes(void* core, long long handle) {
  return static_cast<Core*>(core)->ResultBytes(handle);
}

int hvdtpu_copy_result(void* core, long long handle, void* dst,
                       long long capacity, char* err, int errlen) {
  Status st = static_cast<Core*>(core)->CopyResult(handle, dst, capacity);
  FillErr(st, err, errlen);
  return st.ok() ? 0 : -1;
}

long long hvdtpu_join(void* core) {
  return static_cast<Core*>(core)->Join();
}

// Pre-Start() configuration (reference: env knobs parsed at init,
// operations.cc:456-532 — here Python parses env and pushes values down).
int hvdtpu_set_cache_capacity(void* core, long long capacity) {
  static_cast<Core*>(core)->mutable_config()->cache_capacity = capacity;
  return 0;
}

int hvdtpu_hmac_hex(const char* key, const char* msg, char* out,
                    int outlen) {
  // Exposed for tests and the Python side's proof checks.
  std::string hex = hvdtpu::HmacSha256Hex(key ? key : "", msg ? msg : "");
  if (outlen < static_cast<int>(hex.size()) + 1) return -1;
  std::memcpy(out, hex.c_str(), hex.size() + 1);
  return 0;
}

int hvdtpu_set_secret(void* core, const char* secret) {
  static_cast<Core*>(core)->mutable_config()->secret = secret ? secret : "";
  return 0;
}

// Allreduce algorithm selection (data_plane.h AllreduceAlgo: 0 auto, 1 ring,
// 2 recursive_doubling, 3 tree, 4 scatter_allgather, 5 parameter_server).
// crossover_bytes tunes the AUTO ring/latency switchover, segment_bytes the
// ring pipeline granularity; values <= 0 keep the defaults (and AUTO's
// crossover stays under autotune ownership).
int hvdtpu_set_allreduce_tuning(void* core, int algo,
                                long long crossover_bytes,
                                long long segment_bytes) {
  if (algo < 0 || algo > 5) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->allreduce_algo = algo;
  cfg->allreduce_crossover = crossover_bytes;
  cfg->allreduce_segment = segment_bytes;
  return 0;
}

// Scale-out knobs (docs/collectives.md "Scaling out"). sa_group: group-size
// floor at which AUTO's big-message dispatch prefers scatter-allgather over
// the ring (HVDTPU_ALLREDUCE_SA_GROUP; < 0 keeps the default, 0 removes it
// from the AUTO menu). ctrl_batch: nonzero coalesces each background
// cycle's control-plane frames into one vectored send per peer
// (HVDTPU_CTRL_BATCH). Pre-Start() only.
int hvdtpu_set_scale_tuning(void* core, long long sa_group, int ctrl_batch) {
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->allreduce_sa_group = sa_group;
  cfg->ctrl_batch = ctrl_batch;
  return 0;
}

// Broadcast schedule floor (docs/collectives.md "Broadcast & alltoall"):
// payloads at or under flat_max_bytes use the flat root-sends-to-all
// schedule (one hop of latency); larger ones take the binomial tree
// (ceil(log2 n) depth, n-1 total sends either way). < 0 keeps the
// default (HVDTPU_BCAST_FLAT_MAX). Pre-Start() only.
int hvdtpu_set_bcast_tuning(void* core, long long flat_max_bytes) {
  static_cast<Core*>(core)->mutable_config()->bcast_flat_max =
      flat_max_bytes;
  return 0;
}

// Transport subsystem knobs (data_plane.h): shm_enabled toggles the POSIX
// shared-memory lanes for same-host pairs (on by default), ring_bytes sizes
// each per-direction ring (<= 0 keeps the default), hier_mode selects the
// hierarchical two-level allreduce (0 off, 1 on, 2 auto/autotuned).
int hvdtpu_set_transport(void* core, int shm_enabled,
                         long long shm_ring_bytes, int hier_mode) {
  if (hier_mode < 0 || hier_mode > 2) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->shm_enabled = shm_enabled;
  cfg->shm_ring_bytes = shm_ring_bytes;
  cfg->allreduce_hier = hier_mode;
  return 0;
}

// Zero-copy transport lane knobs (docs/collectives.md "Zero-copy TCP
// lane"): tcp_zerocopy = transport.h ZeroCopyMode (0 auto, 1 on, 2 off,
// 3 uring — the lane is runtime-probed either way and falls back to the
// copy path); shm_numa = shm_transport.h ShmNumaMode (0 auto, 1 on,
// 2 off); doorbell_batch = futex-doorbell coalescing window in bytes
// (<= 0 keeps the lane default, 1 restores wake-per-advance). Pre-Start()
// only: the TCP lanes probe at Connect, the shm lanes take their policy at
// negotiation.
int hvdtpu_set_transport_ext(void* core, int tcp_zerocopy, int shm_numa,
                             long long doorbell_batch) {
  if (tcp_zerocopy < 0 || tcp_zerocopy > 3) return -1;
  if (shm_numa < 0 || shm_numa > 2) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->tcp_zerocopy = tcp_zerocopy;
  cfg->shm_numa = shm_numa;
  cfg->doorbell_batch = doorbell_batch;
  return 0;
}

int hvdtpu_set_stall_shutdown(void* core, double secs) {
  static_cast<Core*>(core)->mutable_config()->stall_shutdown_secs = secs;
  return 0;
}

// Failure-detection knobs (docs/fault-tolerance.md). detect_ms bounds how
// long peer death can go unnoticed on a blocked transport op (poll slice =
// detect_ms/5, clamped); read_deadline_secs declares an open-but-silent
// lane dead after that long with zero progress (0 disables — the only way
// to catch a hung-but-alive peer or a blackholed route); formup_secs
// bounds rendezvous + data-plane mesh establishment. Values <= 0 keep the
// defaults (except read_deadline_secs, where 0 disables). Pre-Start() only.
int hvdtpu_set_failure_detection(void* core, long long detect_ms,
                                 double read_deadline_secs,
                                 double formup_secs) {
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  if (detect_ms > 0) cfg->failure_detect_ms = detect_ms;
  if (read_deadline_secs >= 0) cfg->read_deadline_secs = read_deadline_secs;
  if (formup_secs > 0) cfg->formup_timeout_secs = formup_secs;
  return 0;
}

// Arm one fault injection (HVDTPU_CHAOS -> horovod_tpu/chaos.py; the spec
// grammar lives in Python, the native side sees resolved integers). action:
// 0 none, 1 kill, 2 hang, 3 delay, 4 drop, 5 corrupt (flip one byte of the
// triggering op's post-allreduce output — the seeded SDC the divergence
// probe must catch). Fires once, at the op_index-th allreduce this rank
// starts or the hop_index-th pairwise exchange it runs (1-based; 0 = not
// gated on that counter). Pre-Start() only.
int hvdtpu_set_chaos(void* core, int action, long long op_index,
                     long long hop_index, long long delay_ms, int peer) {
  if (action < 0 || action > 5) return -1;
  if (action != 0 && op_index <= 0 && hop_index <= 0) return -1;
  hvdtpu::ChaosSpec spec;
  spec.action = static_cast<hvdtpu::ChaosSpec::Action>(action);
  spec.op_index = op_index;
  spec.hop_index = hop_index;
  spec.delay_ms = delay_ms;
  spec.peer = peer;
  static_cast<Core*>(core)->mutable_config()->chaos = spec;
  return 0;
}

// Elastic recovery accounting: the Python runtime measures failure
// detection -> successful re-init and records it against the NEW core
// (hvdtpu_recovery_seconds + hvdtpu_failures_detected_total), so a
// post-recovery hvd.metrics() shows the whole episode. Post-Start() only
// (the registry handles resolve in Start).
int hvdtpu_observe_recovery(void* core, double secs) {
  if (secs < 0) return -1;
  static_cast<Core*>(core)->ObserveRecovery(secs);
  return 0;
}

// Wire compression for the native data plane (compressed.h): mode 0 none,
// 1 fp16, 2 int8, 3 int4, 4 auto (autotuner-owned categorical). min_bytes
// is the small-tensor bypass (< 0 keeps the default); skip_regex a
// case-insensitive regex over tensor names that keeps matching ops dense
// (empty/null = no skip list). Pre-Start() only.
int hvdtpu_set_compression(void* core, int mode, long long min_bytes,
                           const char* skip_regex) {
  if (mode < 0 || mode > 4) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->wire_compression = mode;
  if (min_bytes >= 0) cfg->compression_min_bytes = min_bytes;
  cfg->compression_skip_regex = skip_regex ? skip_regex : "";
  return 0;
}

// ZeRO-1 memory attestation (docs/optimizer.md "Sharded optimizer state"):
// the Python sharded optimizer reports its resident optimizer-state bytes
// so /metrics can prove the 1/world footprint. Callable from any thread at
// any point in the core lifecycle.
int hvdtpu_set_optimizer_state_bytes(void* core, long long bytes) {
  static_cast<Core*>(core)->SetOptimizerStateBytes(bytes);
  return 0;
}

// Cumulative bytes-on-wire accounting for this rank's allreduce payloads
// (reduce-scatter and allgather feed the same counters — their raw/wire
// accounting shares the allreduce series so the equal-wire-bytes claim is
// checkable from one pair of numbers):
// raw = what the data plane would have sent uncompressed, wire = what it
// actually sent (equal when compression is off). Thin shim over the metrics
// registry's hvdtpu_allreduce_{raw,wire}_bytes_total counters — the single
// source of truth also served by hvdtpu_metrics_dump / the /metrics
// endpoint. The per-op values ride the timeline (docs/timeline.md
// raw_bytes/wire_bytes).
void hvdtpu_wire_stats(void* core, long long* raw_bytes,
                       long long* wire_bytes) {
  int64_t raw = 0, wire = 0;
  static_cast<Core*>(core)->WireStats(&raw, &wire);
  if (raw_bytes != nullptr) *raw_bytes = raw;
  if (wire_bytes != nullptr) *wire_bytes = wire;
}

// Live-metrics dump (metrics.h): renders every registered series in
// Prometheus text exposition format 0.0.4. Copies up to `buflen` bytes into
// `buf` (NUL-terminated when there is room) and returns the FULL rendered
// length — callers probe with (NULL, 0), allocate, and call again, looping
// if the registry grew in between. Callable from any thread.
long long hvdtpu_metrics_dump(void* core, char* buf, long long buflen) {
  std::string text = static_cast<Core*>(core)->MetricsDump();
  if (buf != nullptr && buflen > 0) {
    long long n = std::min<long long>(buflen, text.size());
    std::memcpy(buf, text.data(), static_cast<size_t>(n));
    if (n < buflen) buf[n] = '\0';
  }
  return static_cast<long long>(text.size());
}

// Always-on flight recorder (flightrec.h; docs/fault-tolerance.md
// "Post-mortem debugging"). hvdtpu_set_flightrec: pre-Start() config —
// `events` is the ring capacity in records (0 disables; < 0 keeps the
// default 4096), `dump_dir` the directory for the automatic
// flightrec.<rank>.bin dumps on abort cascade / stall escalation / fatal
// signals (NULL or empty = in-memory only; snapshots still work).
int hvdtpu_set_flightrec(void* core, long long events,
                         const char* dump_dir) {
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  if (events >= 0) cfg->flightrec_events = events;
  cfg->flightrec_dir = dump_dir != nullptr ? dump_dir : "";
  return 0;
}

// On-demand dump to `path` (NULL/empty = the configured
// <dump_dir>/flightrec.<rank>.bin). Returns 0 on success, -1 when the
// recorder is disabled or no destination is known. Callable any thread.
int hvdtpu_flightrec_dump(void* core, const char* path) {
  return static_cast<Core*>(core)->FlightDumpToFile(path) ? 0 : -1;
}

// Always-on perf attribution (perfstats.h; docs/observability.md).
// hvdtpu_set_perfstats: pre-Start() config — enabled toggles the streaming
// baselines (default on), slowdown_pct is the sentry threshold in percent
// over the rolling baseline (<= 0 keeps baselines but disables the sentry;
// < 0 keeps the default 50), min_samples the per-key warmup before the
// sentry may fire (<= 0 keeps the default 20), profile_path where Shutdown
// writes perf_profile.<rank>.json for scripts/perf_diff.py (NULL/empty =
// skip).
int hvdtpu_set_perfstats(void* core, int enabled, double slowdown_pct,
                         long long min_samples, const char* profile_path) {
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->perfstats = enabled != 0;
  if (slowdown_pct >= 0) cfg->perf_slowdown_pct = slowdown_pct;
  if (min_samples > 0) cfg->perf_min_samples = min_samples;
  cfg->perf_profile_path = profile_path != nullptr ? profile_path : "";
  return 0;
}

// Always-available sampling profiler (profiler.h; docs/profiling.md).
// hvdtpu_set_profiler: pre-Start() config — enabled toggles the subsystem
// (default on; off compiles every entry point down to one branch), hz the
// SIGPROF rate (<= 0 keeps the default 97; clamped to 1000), capacity the
// sample-ring size (<= 0 keeps the default 16384), clock 0 = per-thread
// CPU time (flamegraph contract), 1 = wall (blocked time sampled too),
// folded_path where Shutdown writes prof.<rank>.folded (NULL/empty = skip;
// non-empty also starts a whole-job window at Start — hvdrun --profile).
int hvdtpu_set_profiler(void* core, int enabled, int hz,
                        long long capacity, int clock_mode,
                        const char* folded_path) {
  if (clock_mode < 0 || clock_mode > 1) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->prof = enabled != 0;
  cfg->prof_hz = hz;
  cfg->prof_capacity = capacity;
  cfg->prof_clock = clock_mode;
  cfg->prof_path = folded_path != nullptr ? folded_path : "";
  return 0;
}

// Runtime sampling-window control (the /profz endpoint and hvd.profile()
// ride these). Start clears the ring and arms every registered thread's
// timer; both are idempotent no-ops when the profiler is disabled.
// Callable from any thread.
int hvdtpu_profiler_start(void* core) {
  static_cast<Core*>(core)->ProfilerStart();
  return 0;
}

int hvdtpu_profiler_stop(void* core) {
  static_cast<Core*>(core)->ProfilerStop();
  return 0;
}

int hvdtpu_profiler_running(void* core) {
  return static_cast<Core*>(core)->ProfilerRunning() ? 1 : 0;
}

// Folded-stacks JSON snapshot (horovod_tpu/profiler.py decodes it — the
// /profz payload and hvd.profile()'s return). Same probe-then-copy
// contract as hvdtpu_metrics_dump. Callable from any thread, live.
long long hvdtpu_profiler_snapshot(void* core, char* buf, long long buflen) {
  std::string img = static_cast<Core*>(core)->ProfilerSnapshot();
  if (buf != nullptr && buflen > 0) {
    long long n = std::min<long long>(buflen, img.size());
    std::memcpy(buf, img.data(), static_cast<size_t>(n));
    if (n < buflen) buf[n] = '\0';
  }
  return static_cast<long long>(img.size());
}

// Numerical-health observability (gradstats.h; docs/numerics.md).
// hvdtpu_set_gradstats: pre-Start() config — enabled toggles the whole
// subsystem (default on; off compiles every entry point down to one
// branch), nancheck is the NanPolicy code (0 off, 1 warn, 2 abort; < 0
// keeps the default warn), gradcheck_sample the divergence probe's
// every-Nth-op rate (0 disables the probe; < 0 keeps the default 64;
// must be uniform across ranks), profile_path where Shutdown writes
// grad_profile.<rank>.json for scripts/grad_diff.py (NULL/empty = skip).
int hvdtpu_set_gradstats(void* core, int enabled, int nancheck,
                         long long gradcheck_sample,
                         const char* profile_path) {
  if (nancheck > 2) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->gradstats = enabled != 0;
  if (nancheck >= 0) cfg->nancheck = nancheck;
  if (gradcheck_sample >= 0) cfg->gradcheck_sample = gradcheck_sample;
  cfg->grad_profile_path = profile_path != nullptr ? profile_path : "";
  return 0;
}

// Keyed numerical-health snapshot as JSON (horovod_tpu/gradstats.py
// decodes it — hvd.grad_report() and the /gradz endpoint's data source).
// Same probe-then-copy contract as hvdtpu_metrics_dump. Callable any
// thread.
long long hvdtpu_gradstats_snapshot(void* core, char* buf, long long buflen) {
  std::string img = static_cast<Core*>(core)->GradSnapshot();
  if (buf != nullptr && buflen > 0) {
    long long n = std::min<long long>(buflen, img.size());
    std::memcpy(buf, img.data(), static_cast<size_t>(n));
    if (n < buflen) buf[n] = '\0';
  }
  return static_cast<long long>(img.size());
}

// Keyed-baseline snapshot as JSON (horovod_tpu/perfstats.py decodes it —
// hvd.perf_report() and the /perfz endpoint's data source). Same
// probe-then-copy contract as hvdtpu_metrics_dump. Callable any thread.
long long hvdtpu_perfstats_snapshot(void* core, char* buf, long long buflen) {
  std::string img = static_cast<Core*>(core)->PerfSnapshot();
  if (buf != nullptr && buflen > 0) {
    long long n = std::min<long long>(buflen, img.size());
    std::memcpy(buf, img.data(), static_cast<size_t>(n));
    if (n < buflen) buf[n] = '\0';
  }
  return static_cast<long long>(img.size());
}

// Serialized dump image (binary; horovod_tpu/flightrec.py decodes it —
// the /debugz endpoint's data source). Same probe-then-copy contract as
// hvdtpu_metrics_dump: copies up to `buflen` bytes and returns the FULL
// image size (0 = recorder disabled). Callable from any thread.
long long hvdtpu_flightrec_snapshot(void* core, char* buf, long long buflen) {
  std::string img = static_cast<Core*>(core)->FlightSnapshot();
  if (buf != nullptr && buflen > 0) {
    long long n = std::min<long long>(buflen, img.size());
    std::memcpy(buf, img.data(), static_cast<size_t>(n));
  }
  return static_cast<long long>(img.size());
}

// Standalone quantizer entry points (no core instance needed): the
// cross-implementation parity tests pin these against the JAX-level
// MaxMinQuantizer (compression/quantize.py) — same bucket-512 (min, unit)
// encoding, same codes. `residual` (nullable, count floats) applies and
// updates error feedback exactly like the data plane's compressed hops.
long long hvdtpu_wire_compressed_bytes(int mode, long long count) {
  if (mode < 0 || mode > 4 || count < 0) return -1;
  return hvdtpu::WireBytes(static_cast<hvdtpu::WireCompression>(mode), count);
}

int hvdtpu_wire_compress(int mode, const float* src, long long count,
                         unsigned char* dst, float* residual) {
  if (mode <= 0 || mode > 3 || count < 0) return -1;
  hvdtpu::WireCompress(static_cast<hvdtpu::WireCompression>(mode), src, count,
                       dst, residual, nullptr);
  return 0;
}

int hvdtpu_wire_decompress(int mode, const unsigned char* src,
                           long long count, float* dst) {
  if (mode <= 0 || mode > 3 || count < 0) return -1;
  hvdtpu::WireDecompress(static_cast<hvdtpu::WireCompression>(mode), src,
                         count, dst);
  return 0;
}

int hvdtpu_set_autotune(void* core, int enabled, const char* log_path,
                        int warmup_samples, int cycles_per_sample,
                        int max_samples, double gp_noise) {
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->autotune = enabled != 0;
  cfg->autotune_log = log_path ? log_path : "";
  if (warmup_samples > 0) cfg->autotune_warmup_samples = warmup_samples;
  if (cycles_per_sample > 0) cfg->autotune_cycles_per_sample = cycles_per_sample;
  if (max_samples > 0) cfg->autotune_max_samples = max_samples;
  if (gp_noise > 0) cfg->autotune_gp_noise = gp_noise;
  return 0;
}

// Runtime timeline control (reference: horovod_start_timeline /
// horovod_stop_timeline, operations.cc:735-790).
void hvdtpu_start_timeline(void* core, const char* path, int mark_cycles) {
  static_cast<Core*>(core)->RequestTimeline(true, path ? path : "",
                                            mark_cycles != 0);
}

void hvdtpu_stop_timeline(void* core) {
  static_cast<Core*>(core)->RequestTimeline(false, "", false);
}

// Distributed tracing (docs/tracing.md). hvdtpu_set_trace: pre-Start()
// span-sampling config — sample_every = emit per-hop child spans for every
// Nth collective op (0 disables; op-level phases always ride a running
// timeline); clock_sync_interval_secs > 0 overrides the control-plane
// clock-refresh period (default 30 s). hvdtpu_start_trace: runtime
// start_timeline variant that also (re)targets the sampler (sample_every
// < 0 keeps the configured rate). hvdtpu_clock_offset: this rank's steady
// clock offset ± error vs rank 0 in microseconds (err < 0 = never synced);
// callable from any thread.
int hvdtpu_set_trace(void* core, long long sample_every,
                     double clock_sync_interval_secs) {
  if (sample_every < 0) return -1;
  hvdtpu::CoreConfig* cfg = static_cast<Core*>(core)->mutable_config();
  cfg->trace_sample = sample_every;
  if (clock_sync_interval_secs > 0) {
    cfg->clock_sync_interval_secs = clock_sync_interval_secs;
  }
  return 0;
}

void hvdtpu_start_trace(void* core, const char* path, int mark_cycles,
                        long long sample_every) {
  static_cast<Core*>(core)->RequestTimeline(true, path ? path : "",
                                            mark_cycles != 0, sample_every);
}

void hvdtpu_clock_offset(void* core, long long* offset_us,
                         long long* err_us) {
  int64_t off = 0, err = -1;
  static_cast<Core*>(core)->ClockOffset(&off, &err);
  if (offset_us != nullptr) *offset_us = off;
  if (err_us != nullptr) *err_us = err;
}

double hvdtpu_cycle_time_ms(void* core) {
  return static_cast<Core*>(core)->CurrentCycleTimeMs();
}

long long hvdtpu_fusion_threshold(void* core) {
  return static_cast<Core*>(core)->CurrentFusionThreshold();
}

}  // extern "C"
