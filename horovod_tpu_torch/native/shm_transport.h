// POSIX shared-memory transport: per-pair shm_open+mmap ring buffers with
// futex doorbells, used automatically for ranks sharing a host.
//
// One segment per rank pair, created by the lower rank, holding two
// single-producer/single-consumer byte rings (lower->higher and
// higher->lower). Each ring is lock-free within the segment: the producer
// owns the head cursor, the consumer the tail, and cross-process wakeups
// ride shared (non-private) futex words with a timeout fallback so a lost
// wake can only cost milliseconds, never a hang. Abort (worker shutdown or
// world break) flips a shared flag and wakes both sides; every blocked ring
// op observes it and fails over instead of spinning on a dead peer.
//
// Zero-copy receive: segmented receives with a callback consume the
// payload IN PLACE — the callback gets views straight into the mapped ring
// (elem-aligned, wrap handled), the staging memcpy out of the ring is gone,
// and the tail advances only after the view is consumed. Doorbells are
// batched: wakes coalesce while the peer is demonstrably running
// (HVDTPU_DOORBELL_BATCH), with an immediate wake on every empty->data /
// full->space transition so a sleeping peer never waits past one chunk.
// Rings can be NUMA-pinned (HVDTPU_SHM_NUMA): each side binds its INBOUND
// ring's pages to its own node — reads local, the peer's writes ride the
// store buffer — probed via /sys/devices/system/node, no-op single-node.
//
// Reference analog: the fork's CUDA-IPC shared-memory communicator
// (horovod/common/ops/compressed/ SHM path) — here host memory instead of
// device memory, POSIX shm instead of cudaIpc handles.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "transport.h"

#include "thread_roles.h"

namespace hvdtpu {

// Per-direction ring capacity. Must absorb one full in-flight collective
// chunk for the inline (no sender thread) fast path to engage; tunable via
// HVDTPU_SHM_RING_BYTES.
constexpr int64_t kDefaultShmRingBytes = 1 << 20;

// Default futex-doorbell coalescing window (bytes moved per wake while the
// peer has a waiter registered but data/space keeps flowing). 1 = ring the
// bell on every cursor advance (the pre-batching behavior).
constexpr int64_t kDefaultDoorbellBatchBytes = 256 * 1024;

// NUMA placement mode for the shm rings (HVDTPU_SHM_NUMA; mirrored by
// envvars.SHM_NUMA_MODES — scripts/check_invariants.py ENUM-MIRROR).
// AUTO pins when the host has >1 node, ON attempts the mbind regardless,
// OFF never touches placement.
enum class ShmNumaMode : int32_t {
  AUTO = 0,
  ON = 1,
  OFF = 2,
};

// Nodes under `sysfs_dir` (/sys/devices/system/node): the NUMA probe.
// Returns 1 when the directory is absent/unreadable (treat as single-node).
int NumaNodeCount(const std::string& sysfs_dir = "/sys/devices/system/node");

// Concurrency contract (see common.h's TSA layer; this type is mutex-free on
// purpose): each ring is strict SPSC across two PROCESSES — the producer
// side owns the head cursor, the consumer the tail, both published with
// acquire/release atomics in the mapped segment; futex words handle
// cross-process wakeups. Within a process, a ShmTransport is driven by the
// core's background loop only (the same single-driver rule as DataPlane),
// except Abort()/abort flag reads, which are async-signal-style atomics any
// thread may touch during shutdown.
class ShmTransport : public Transport {
 public:
  // Creator (lower rank) allocates and initializes the segment; the opener
  // maps it. `name` must match on both sides and be unique per pair per job
  // (DataPlane derives it from the pair's data-plane ports). Both return
  // null on failure — the caller falls back to TCP after the socket
  // handshake confirms the peer agrees.
  HVDTPU_CALLED_ON(background)
  static std::unique_ptr<ShmTransport> Create(const std::string& name,
                                              size_t ring_bytes);
  HVDTPU_CALLED_ON(background)
  static std::unique_ptr<ShmTransport> Open(const std::string& name,
                                            int timeout_ms);
  ~ShmTransport() override;

  HVDTPU_CALLED_ON(any)
  const char* kind() const override { return "shm"; }
  HVDTPU_CALLED_ON(background)
  int Send(const void* buf, size_t len) override;
  HVDTPU_CALLED_ON(background)
  int Recv(void* buf, size_t len) override;
  // Zero-copy when on_segment is set: the payload is consumed IN PLACE via
  // ring views (elem-aligned per view_align; buf is untouched scratch).
  // Without a callback, bytes land in buf as before.
  HVDTPU_CALLED_ON(background)
  int RecvSegmented(void* buf, size_t len, size_t segment_bytes,
                    size_t view_align, const SegmentFn& on_segment) override;
  // Interleaved full-duplex pump on the calling thread: no extra thread —
  // writes whatever fits the outbound ring, drains the inbound ring, and
  // fires segment callbacks as contiguous (aligned) runs complete — in
  // place, like RecvSegmented. The peer's concurrent pump guarantees both
  // directions advance.
  HVDTPU_CALLED_ON(background)
  int SendRecv(const void* send_buf, size_t send_bytes, void* recv_buf,
               size_t recv_bytes, size_t segment_bytes, size_t view_align,
               const SegmentFn& on_segment) override;
  // The data-plane algorithms exchange matched messages (every byte sent in
  // a step is consumed in the same step), so the ring is drained at each
  // step boundary and a payload no larger than the ring can never block.
  HVDTPU_CALLED_ON(background)
  bool InlineSendSafe(size_t bytes) const override {
    return bytes <= ring_bytes_;
  }

  // Mark the segment aborted and wake both sides; any blocked ring op
  // (either process) returns -1. Called from DataPlane::Shutdown so a dying
  // rank releases its same-host peers.
  HVDTPU_CALLED_ON(any)
  void Abort() override;
  // The destructor then unmaps without flipping the abort flag.
  HVDTPU_CALLED_ON(background)
  void CloseCleanly() override { clean_close_ = true; }
  // Peer-liveness probe: a SIGKILLed peer can never flip the abort flag, so
  // the wait loops also watch this (otherwise idle) socket to the peer and
  // abort on EOF — checked every wait slice, so a killed peer wakes a
  // blocked waiter within one slice. Optional; without it a dead peer
  // blocks until the caller tears the plane down.
  HVDTPU_CALLED_ON(background)
  void set_liveness_fd(int fd) { liveness_fd_ = fd; }
  // Shared fault-detection block (socket_util.h IoControl): wait slices
  // shrink to its detect_slice_ms, a plane-wide abort breaks blocked ring
  // ops within one slice, peer death (liveness EOF) marks the whole plane
  // failed, and read_deadline_secs bounds a zero-progress op against a
  // hung-but-alive peer. Optional (standalone/unit-test use keeps the
  // segment-local abort flag only).
  HVDTPU_CALLED_ON(background)
  void set_control(IoControl* ctl) { ctl_ = ctl; }
  // Futex-doorbell coalescing window in bytes (HVDTPU_DOORBELL_BATCH):
  // 0 = kDefaultDoorbellBatchBytes, 1 = ring on every advance (legacy).
  // Coalescing is ADAPTIVE per op: it engages only when the op moves at
  // least one window's worth of bytes (sustained streaming, where wake
  // syscalls amortize away); smaller ops keep the legacy per-advance
  // protocol — their one wake IS the latency path, measured slower under
  // coalescing on a contended box. Set before traffic (Connect time);
  // each side tunes its own bells.
  HVDTPU_CALLED_ON(background)
  void set_doorbell_batch(int64_t bytes) {
    doorbell_batch_ = bytes <= 0 ? kDefaultDoorbellBatchBytes : bytes;
  }
  // Bind this side's inbound ring pages to the local NUMA node
  // (HVDTPU_SHM_NUMA; mbind(MPOL_PREFERRED, MF_MOVE), page-rounded).
  // Returns true when a binding was applied; false = probed no-op
  // (single-node host, mode OFF, or the syscall is unavailable).
  HVDTPU_CALLED_ON(background)
  bool ApplyNumaPolicy(ShmNumaMode mode);
  // Drop the name from the shm namespace (creator side, once the opener
  // confirmed attach over the socket handshake): an abnormal death after
  // this point leaks nothing. Idempotent.
  HVDTPU_CALLED_ON(background)
  void Unlink();

  HVDTPU_CALLED_ON(any)
  size_t ring_bytes() const { return ring_bytes_; }
  // Bytes sitting in the segment's two rings right now (producer head minus
  // consumer tail, both directions) — the per-lane occupancy gauge. Any
  // thread (the cursors are cross-process atomics already).
  HVDTPU_CALLED_ON(any)
  int64_t OccupancyBytes() const override;
  // Futex wake syscalls this side has issued (doorbell-batching tests).
  HVDTPU_CALLED_ON(any)
  int64_t futex_wakes() const { return futex_wakes_; }
  // True once THIS lane's liveness probe saw the peer die (EOF) or its
  // no-progress deadline expired — failure ATTRIBUTION for exchanges that
  // span two lanes (DataPlane::Exchange's DuplexPump path must not blame
  // the healthy neighbor; the plane-wide IoControl flags cannot say which
  // lane tripped first).
  HVDTPU_CALLED_ON(any)
  bool peer_died() const { return peer_died_; }

  // Single-threaded duplex pump across TWO shm lanes (ring-neighbor
  // exchanges: send to `tx`'s peer while receiving from `rx`'s peer) — the
  // two-peer analog of SendRecv's same-peer pump. Replaces the
  // sender-thread-per-hop pattern for all-shm ring steps: no thread
  // create/join, no cross-thread scheduling churn, and the receive side
  // consumes in place (view semantics, like RecvSegmented). Both lanes
  // must be driven by the calling thread (the usual single-driver rule).
  HVDTPU_CALLED_ON(background)
  static int DuplexPump(ShmTransport* tx, const void* send_buf,
                        size_t send_bytes, ShmTransport* rx, void* recv_buf,
                        size_t recv_bytes, size_t view_align,
                        const SegmentFn& on_segment);

 private:
  struct Segment;  // shared-memory layout (shm_transport.cpp)
  struct ShmRingRef;

  ShmTransport(std::string name, Segment* seg, size_t map_bytes,
               bool creator);

  // Arm/disarm doorbell coalescing for the op moving `op_bytes` (see
  // set_doorbell_batch); called at every public-op entry.
  void BeginOp(size_t op_bytes) {
    coalesce_ = doorbell_batch_ > 1 &&
                op_bytes >= static_cast<size_t>(doorbell_batch_);
  }
  // One bounded copy attempt (never blocks); returns bytes moved.
  size_t TrySend(const uint8_t* buf, size_t len);
  size_t TryRecv(uint8_t* buf, size_t len);
  // One bounded IN-PLACE consume attempt: fires on_segment with up to one
  // aligned contiguous ring view (staging only for a wrap-straddled
  // element), advances the tail past it. `done` is the op's running offset
  // (callback offset + alignment bookkeeping); returns bytes consumed.
  size_t TryConsumeViews(size_t done, size_t len, size_t view_align,
                         const SegmentFn& on_segment);
  // Doorbell plumbing: called after a cursor advance. `was_edge` = the ring
  // crossed an empty->data (head) or full->space (tail) transition, which
  // always rings immediately — a sleeping peer can only be waiting on an
  // edge. Otherwise wakes coalesce until doorbell_batch_ bytes accumulated.
  void NotifyHeadAdvance(size_t bytes, bool was_edge);
  void NotifyTailAdvance(size_t bytes, bool was_edge);
  // The bell itself: bump the futex word and wake (counted). The caller
  // owns the Dekker ordering (seq_cst fence/RMW before the waiter check).
  void BumpAndWake(std::atomic<uint32_t>* seq);
  // Ring any deferred doorbells NOW: before this side blocks (the peer must
  // make progress for us to ever wake) and at every op boundary.
  void FlushDoorbells();
  // Park until the peer moves the given cursor or the deadline/abort hits.
  void WaitOutboundSpace();
  void WaitInboundData();
  // True (and segment aborted) when the liveness socket reports EOF.
  bool PeerDead();
  // True when any abort source fired (segment flag or plane-wide control).
  bool AbortedNow() const;
  // Wait slice in ms (control's detect slice, else the built-in default).
  int WaitSliceMs() const;
  // No-progress deadline check for a blocked op; marks the peer failed and
  // aborts the segment when breached. `last_progress` is a monotonic-seconds
  // stamp of the op's latest byte movement.
  bool DeadlineExpired(double last_progress);

  std::string name_;
  Segment* seg_ = nullptr;
  size_t map_bytes_ = 0;
  size_t ring_bytes_ = 0;
  bool creator_ = false;
  bool unlinked_ = false;
  bool clean_close_ = false;
  int liveness_fd_ = -1;
  bool peer_died_ = false;
  IoControl* ctl_ = nullptr;
  int out_ring_ = 0;  // rings[out_ring_] is my producer side
  uint8_t* out_data_ = nullptr;
  uint8_t* in_data_ = nullptr;
  int64_t doorbell_batch_ = kDefaultDoorbellBatchBytes;
  bool coalesce_ = false;  // current op streams enough to batch the bells
  // Wake debt owed to a registered peer waiter while coalescing (bytes
  // advanced since the last bell, per direction). Driver-thread-only.
  size_t pending_head_bytes_ = 0;
  size_t pending_tail_bytes_ = 0;
  int64_t futex_wakes_ = 0;
  // Aligned bounce for in-place views whose ring offset an earlier
  // odd-sized op knocked off the element grid (TryConsumeViews); lazily
  // allocated, bounded.
  std::vector<uint8_t> bounce_;
};

}  // namespace hvdtpu
