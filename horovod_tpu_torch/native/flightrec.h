// Always-on in-memory flight recorder (docs/fault-tolerance.md
// "Post-mortem debugging").
//
// A fixed-size per-rank ring of compact binary phase records — op begin/end,
// per-hop send/recv with peer+bytes+lane, reduce, quantize, fusion-wait,
// failure-detect and stall events — written unconditionally on the
// collective path (unlike the sampled JSON tracing layer, docs/tracing.md:
// a record is five relaxed atomic stores, no strings, no allocation, so the
// steady-state cost stays inside the <2% observability budget at
// every-op granularity). The ring is dumped to `flightrec.<rank>.bin`:
//
//   * on the abort cascade (Core::FailAllOutstanding),
//   * on stall escalation (Core::CheckStalls shutdown),
//   * on a fatal signal (SIGSEGV/SIGBUS/SIGABRT/SIGTERM handlers installed
//     by the core; the dump path uses only async-signal-safe syscalls),
//   * on demand (hvdtpu_flightrec_dump C API / the /debugz endpoint's
//     hvdtpu_flightrec_snapshot).
//
// The dump header carries the clock offset ± error vs rank 0 plus a
// steady/wall anchor pair, so scripts/postmortem.py can merge surviving
// ranks' rings onto one global time axis with the same alignment machinery
// the distributed tracer uses. horovod_tpu/flightrec.py is the decoder;
// the FlightEvent / DumpReason values below are mirrored there and held in
// sync by scripts/check_invariants.py (ENUM-MIRROR).
//
// No reference analog: the reference's only post-hoc artifact is the
// optional timeline, which is off by default and gone with the process.
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>

#include "thread_roles.h"

namespace hvdtpu {

// Record type tags. Mirrored in horovod_tpu/flightrec.py FLIGHT_EVENTS
// (scripts/check_invariants.py ENUM-MIRROR).
enum class FlightEvent : int32_t {
  NONE = 0,
  OP_BEGIN = 1,      // collective dispatched (name, op code in arg, bytes)
  OP_END = 2,        // collective finished (arg: 0 ok / 1 error)
  SEND = 3,          // one-directional hop (send_peer, bytes, wait split)
  RECV = 4,
  SENDRECV = 5,      // paired exchange (both peers, combined bytes)
  REDUCE = 6,        // reduction phase (busy time in dur)
  QUANTIZE = 7,      // wire-compression encode
  DEQUANTIZE = 8,    // wire-compression decode
  FUSION_WAIT = 9,   // tensor's enqueue -> batch-execution wait
  FAIL_DETECT = 10,  // lane failure pinned on a peer (send_peer = suspect)
  STALL = 11,        // coordinator stall warning / escalation
  ABORT = 12,        // data plane aborted (cascade reached this rank)
  MARK = 13,         // user marker (reserved for the Python API)
  ANOMALY = 14,      // perf sentry: op past its baseline (arg = PerfPhase
                     // code, send_peer = slow hop peer for wire-slow)
  NONFINITE = 15,    // NaN/Inf gradient at fusion copy-in (name = tensor,
                     // bytes = non-finite element count, arg = NanPolicy)
  DIVERGENCE = 16,   // cross-rank fingerprint mismatch (send_peer = the
                     // minority rank, arg = its crc32c, bytes = payload)
};

// Why a dump was written. Mirrored in horovod_tpu/flightrec.py DUMP_REASONS.
enum class DumpReason : int32_t {
  ON_DEMAND = 0,  // C API / /debugz snapshot
  ABORT = 1,      // abort cascade (detail = suspected failed peer, -1 none)
  STALL = 2,      // stall-shutdown escalation
  SIGNAL = 3,     // fatal signal (detail = signo)
  NONFINITE = 4,  // HVDTPU_NANCHECK=abort fail-fast (detail = this rank)
};

// One decoded record (the ring stores these packed into kRecordWords
// relaxed-atomic u64 words; see Pack/Unpack in flightrec.cpp).
struct FlightRecord {
  int64_t t_end_us = 0;  // Timeline::SteadyAbsUs at the event's end
  uint32_t dur_us = 0;   // event duration (clamped to u32: ~71 min)
  FlightEvent type = FlightEvent::NONE;
  uint16_t lane = 0;     // 0 none/local, 1 tcp, 2 shm, 3 tcp-zc
  int64_t bytes = 0;     // payload bytes (hops/ops) or aux quantity
  int32_t name_id = -1;  // interned name (-1 none, 0 the overflow slot)
  int32_t arg = 0;       // wait_us (hops) / status (OP_END) / op code / signo
  int32_t send_peer = -1;
  int32_t recv_peer = -1;
};

constexpr int kFlightRecordWords = 5;   // 40 bytes per record
constexpr int kFlightNameBytes = 48;    // interned-name slot size (w/ NUL)
constexpr int kFlightMaxNames = 512;    // names beyond this share kOverflow
constexpr uint32_t kFlightHeaderBytes = 128;
constexpr char kFlightMagic[8] = {'H', 'V', 'D', 'F', 'R', 'E', 'C', '1'};

inline uint16_t FlightLaneCode(const char* kind) {
  if (kind == nullptr) return 0;
  if (kind[0] == 't') return kind[3] == '-' ? 3 : 1;  // "tcp-zc" vs "tcp"
  if (kind[0] == 's') return 2;                       // "shm"
  return 0;                                           // "local" / unknown
}

// Concurrency contract: Record() may run from any thread (the collective-
// driving background thread in practice, plus the transient sender threads
// inside SendRecvSegmented) — the ring is a fetch_add slot claim plus
// relaxed word stores, so concurrent writers never block and never tear a
// word. InternName() is background-thread-only (it owns the lookup map);
// the name TABLE itself is published with release stores so any reader —
// including a signal handler — sees complete entries. Snapshot()/
// DumpToFile() run from any thread; SignalDump() is async-signal-safe
// (syscalls + atomic loads only, path precomposed at Configure time).
class FlightRecorder {
 public:
  FlightRecorder();
  ~FlightRecorder();

  // capacity <= 0 disables (every Record() is one branch). dump_dir may be
  // empty: recording and Snapshot() still work, automatic file dumps are
  // skipped. Call before the background loop starts.
  HVDTPU_CALLED_ON(background)
  void Configure(int64_t capacity, const std::string& dump_dir, int rank,
                 int world_size);
  HVDTPU_CALLED_ON(any)
  bool enabled() const { return cap_ > 0; }
  HVDTPU_CALLED_ON(any)
  int rank() const { return rank_; }
  // "<dump_dir>/flightrec.<rank>.bin" ("" when no dir configured).
  HVDTPU_CALLED_ON(any)
  const std::string& dump_path() const { return dump_path_; }

  // Intern `name` -> id (>= 1; 0 = the shared overflow slot once the table
  // fills; pass -1 to Record for nameless events). Background thread only.
  HVDTPU_CALLED_ON(background)
  int InternName(const std::string& name);

  // One ring write: five relaxed atomic word stores after a fetch_add slot
  // claim. name_id -1 = nameless; arg carries the event-specific scalar
  // (hop wait_us, OP_END status, signal number, ...).
  HVDTPU_CALLED_ON(any)
  void Record(FlightEvent type, int name_id, int64_t bytes, int send_peer,
              int recv_peer, int64_t t0_us, int64_t t1_us, int64_t arg,
              uint16_t lane);

  // Clock offset vs rank 0 (sync), recorded into every dump header.
  HVDTPU_CALLED_ON(any)
  void SetClock(int64_t offset_us, int64_t err_us) {
    clock_offset_us_.store(offset_us, std::memory_order_relaxed);
    clock_err_us_.store(err_us, std::memory_order_relaxed);
  }

  HVDTPU_CALLED_ON(any)
  int64_t record_count() const {
    return next_.load(std::memory_order_relaxed);
  }

  // Serialized dump image: header + name table + records oldest-first.
  // Callable from any thread (concurrent writers may overwrite the oldest
  // slots mid-copy; forensics tolerates a torn tail, never a torn word).
  HVDTPU_CALLED_ON(any)
  std::string Snapshot(DumpReason reason, int32_t detail) const;

  // Write Snapshot() to `path` (empty = the configured dump_path). Returns
  // true on success. `fatal_once` dumps are latched: only the FIRST fatal
  // trigger (abort/stall/signal) writes, so a cascade of failures cannot
  // overwrite the record of the original one; on-demand dumps always write.
  HVDTPU_CALLED_ON(any)
  bool DumpToFile(DumpReason reason, int32_t detail,
                  const std::string& path = "", bool fatal_once = false);

  // Async-signal-safe dump to the precomposed path (open/write/close +
  // atomic loads only). No-op without a configured dump dir.
  HVDTPU_CALLED_ON(signal)
  void SignalDump(int signo);

 private:
  void SerializeHeader(char* out, DumpReason reason, int32_t detail,
                       int64_t write_count, uint32_t name_count) const;

  int64_t cap_ = 0;  // records in the ring (0 = disabled)
  int rank_ = 0;
  int world_size_ = 1;
  std::string dump_path_;
  std::unique_ptr<std::atomic<uint64_t>[]> words_;  // cap_ * kRecordWords  // atomic: relaxed-counter
  std::atomic<int64_t> next_{0};  // total records ever written  // atomic: relaxed-counter
  // Interned names: entries [0, name_count_) are immutable once published
  // (fill slot, then release-store the count). Slot 0 is reserved for
  // "<names-overflowed>" so ids stay >= 1 for real names.
  std::unique_ptr<char[]> names_;  // kFlightMaxNames * kFlightNameBytes
  std::atomic<uint32_t> name_count_{0};  // atomic: release-publish
  std::unordered_map<std::string, int> name_ids_;  // background thread only
  std::atomic<int64_t> clock_offset_us_{0};  // atomic: relaxed-counter
  std::atomic<int64_t> clock_err_us_{-1};  // atomic: relaxed-counter
  std::atomic<bool> fatal_dumped_{false};  // atomic: seqcst(one-shot fatal-dump latch)
};

// Process-wide recorder the fatal-signal handlers dump (the most recently
// configured enabled recorder wins; cleared when its core is destroyed).
// Handlers are installed once per process by InstallFlightSignalHandlers.
void SetSignalFlightRecorder(FlightRecorder* rec);
void ClearSignalFlightRecorder(FlightRecorder* rec);
void InstallFlightSignalHandlers();

}  // namespace hvdtpu
