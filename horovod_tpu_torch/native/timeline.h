// Chrome-tracing timeline writer.
//
// Reference: horovod/common/timeline.{h,cc} — per-op JSON events viewable in
// chrome://tracing / Perfetto, with NEGOTIATE / QUEUE / operation phases
// (phase names from horovod/common/common.h:32-66). Here events are written
// by a dedicated writer thread fed through a lock-free-enough queue, like the
// reference's async writer (timeline.cc:185-380).
#pragma once

#include <atomic>
#include <chrono>
#include <cstdio>
#include <queue>
#include <string>
#include <thread>

#include "common.h"

namespace hvdtpu {

class Timeline {
 public:
  ~Timeline();

  // No-op unless initialized. file comes from HVDTPU_TIMELINE.
  HVDTPU_CALLED_ON(any)
  void Initialize(const std::string& path, int rank) EXCLUDES(state_mu_, mu_);
  HVDTPU_CALLED_ON(any)
  void Shutdown() EXCLUDES(state_mu_, mu_);
  HVDTPU_CALLED_ON(any)
  bool Initialized() const { return initialized_; }

  // Phase events for a named tensor (tensor name becomes the trace "pid" row,
  // like the reference, timeline.cc:254-276).
  HVDTPU_CALLED_ON(any)
  void NegotiateStart(const std::string& name);
  HVDTPU_CALLED_ON(any)
  void NegotiateEnd(const std::string& name);
  HVDTPU_CALLED_ON(any)
  void QueueStart(const std::string& name);
  // `transport` (optional) tags the op with the data-plane lane summary
  // ("shm", "tcp", "shm+tcp", with "+hier" under the two-level allreduce) as
  // a Chrome-trace arg — visible in the Perfetto slice details.
  // `compression` (optional) sits next to it: the op's effective wire
  // compression ("none", "fp16", "int8", "int4").
  HVDTPU_CALLED_ON(any)
  void ActivityStart(const std::string& name, const std::string& activity,
                     const std::string& transport = "",
                     const std::string& compression = "");
  HVDTPU_CALLED_ON(any)
  void ActivityEnd(const std::string& name);
  // raw_bytes/wire_bytes (optional, -1 = omit): payload this rank would
  // have sent uncompressed vs bytes actually sent, from the data plane's
  // per-op counters — the compression-ratio measurement surface
  // (docs/timeline.md).
  HVDTPU_CALLED_ON(any)
  void OpDone(const std::string& name, const std::string& result,
              int64_t raw_bytes = -1, int64_t wire_bytes = -1);
  HVDTPU_CALLED_ON(any)
  void MarkCycle() EXCLUDES(state_mu_, mu_);  // HVDTPU_TIMELINE_MARK_CYCLES

  // --- distributed-tracing surface (docs/tracing.md) ----------------------
  // Complete ('X') span on track `track` (one Perfetto row per track per
  // rank). start/end are ABSOLUTE steady-clock microseconds (SteadyAbsUs);
  // the timeline converts to its own origin at emission, so emitters can
  // timestamp without taking state_mu_. args_json: "{...}" or "".
  HVDTPU_CALLED_ON(any)
  void Span(const std::string& track, const std::string& name,
            int64_t start_abs_us, int64_t end_abs_us,
            const std::string& args_json) EXCLUDES(state_mu_, mu_);
  // Trace-metadata instant on the reserved kTraceMetaTrack row: clock
  // offset ± error bound vs rank 0, steady/wall anchors — everything
  // scripts/trace_analyze.py needs to align this rank's events globally.
  HVDTPU_CALLED_ON(any)
  void Metadata(const std::string& args_json) EXCLUDES(state_mu_, mu_);
  // Absolute steady-clock now in microseconds (the spans' time base).
  HVDTPU_CALLED_ON(any)
  static int64_t SteadyAbsUs() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  // Absolute steady us of this timeline's ts origin (0 if uninitialized).
  HVDTPU_CALLED_ON(any)
  int64_t init_steady_us() EXCLUDES(state_mu_);

  static constexpr const char* kTraceMetaTrack = "__hvdtpu_trace_meta";

 private:
  struct Event {
    std::string json;
  };
  void Emit(const std::string& name, char ph, const std::string& args_json,
            const std::string& cat = "") EXCLUDES(state_mu_, mu_);
  // Queue one rendered event WITHOUT waking the writer: every emitter runs
  // on (or inside) the collective path, where a per-event futex wake
  // preempts the pipelined overlap on small hosts (measured up to ~8% at
  // 16 MB on a 1-CPU box). The writer is nudged at op boundaries (OpDone)
  // and otherwise drains on a 1 s backstop; Shutdown notifies for the
  // prompt final drain.
  void Push(std::string json) EXCLUDES(mu_);
  void WriterLoop() EXCLUDES(mu_);
  int64_t NowUs() const REQUIRES(state_mu_);

  // Lifecycle state can be mutated by the background thread (runtime
  // start/stop requests) while user threads Emit from EnqueueOp — state_mu_
  // guards it. Lock order: state_mu_ before mu_ (Emit/MarkCycle take both).
  Mutex state_mu_ ACQUIRED_BEFORE(mu_);
  // Lock-free fast-path check in Initialized(); every WRITE happens under
  // state_mu_ so Emit's snapshot (rank_/start_) stays consistent with it.
  std::atomic<bool> initialized_{false};  // atomic: seqcst(init latch, read via implicit loads)
  int rank_ GUARDED_BY(state_mu_) = 0;
  std::chrono::steady_clock::time_point start_ GUARDED_BY(state_mu_);
  int cycle_ GUARDED_BY(state_mu_) = 0;
  // Writer-thread-owned between Initialize and Shutdown: Initialize writes
  // file_/first_ before spawning writer_, Shutdown touches them only after
  // join(). Not GUARDED_BY — ownership transfers via thread start/join,
  // which the analysis cannot express (and no lock is ever needed).
  FILE* file_ = nullptr;
  bool first_ = true;
  Mutex mu_;
  CondVar cv_;
  std::queue<Event> queue_ GUARDED_BY(mu_);
  bool stop_ GUARDED_BY(mu_) = false;
  std::thread writer_;
};

}  // namespace hvdtpu
