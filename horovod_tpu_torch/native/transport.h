// Transport abstraction for the host data plane.
//
// The collective algorithms in data_plane.cpp speak to every peer through
// this interface; the concrete lane is chosen per pair at Connect() time:
// TcpTransport (socket path, loopback or cross-host, with an
// optional zero-copy send engine) or ShmTransport (shm_transport.h — POSIX
// shared-memory rings for ranks that share a host). This is the seam later
// transports (TPU ICI-aware, RDMA) plug into: implement the five methods and
// register a lane in DataPlane::Connect. Fills the role of the reference
// fork's communicator menu (horovod/common/ops/compressed/: MPI / NCCL /
// CUDA-IPC SHM / P2P).
#pragma once

#include <cstddef>
#include <cstdint>
#include <functional>

#include "socket_util.h"
#include "thread_roles.h"

namespace hvdtpu {

// In-order, disjoint completion callback for segmented receives:
// (data, offset, length). `data` points at the segment's payload bytes and
// is valid only for the duration of the call; landing transports pass
// recv_buf + offset, while zero-copy transports (the shm rings) pass views
// into their own storage and may skip writing recv_buf entirely — callers
// that pass a callback must treat recv_buf as scratch and consume the
// payload through the views. Offsets are monotonic and disjoint; lengths
// are multiples of the caller's view alignment (see view_align below), but
// otherwise transport-chosen (segment-sized for TCP, ring-run-sized for
// shm). Runs on the caller's thread.
using SegmentFn = std::function<void(const uint8_t*, size_t, size_t)>;

// TCP zero-copy send mode (HVDTPU_TCP_ZEROCOPY; mirrored by
// envvars.TCP_ZEROCOPY_MODES — scripts/check_invariants.py ENUM-MIRROR).
// AUTO probes SO_ZEROCOPY at Connect and backs off to the copy path when
// the kernel reports it copied anyway (loopback, unsupported NICs); ON
// keeps the lane armed wherever the probe succeeds; OFF never probes;
// URING probes an io_uring submission ring first and falls back down the
// same ladder (docs/collectives.md "Zero-copy TCP lane" has the full probe
// order).
enum class ZeroCopyMode : int32_t {
  AUTO = 0,
  ON = 1,
  OFF = 2,
  URING = 3,
};

// Per-fd zero-copy send engine (MSG_ZEROCOPY + errqueue completion reaping,
// optional io_uring submission lane). Owned by a TcpTransport; single-driver
// like its owner — only the thread running the send may call SendAll.
//
// Correctness contract: SendAll returns only after every queued byte's
// zero-copy completion has been reaped from the socket error queue, so the
// caller may immediately reuse the buffer (the collectives re-fill send
// buffers every hop). Completion waits are folded into IoControl-style poll
// slices: a plane abort, peer death, or the no-progress deadline breaks a
// blocked drain within one slice, exactly like the copy path.
class ZeroCopySender {
 public:
  ~ZeroCopySender();

  // Probe and arm the lane (Connect-time, before any traffic). Probe order:
  // URING -> io_uring ring with IORING_OP_SEND (falls through to
  // MSG_ZEROCOPY when io_uring_setup is unavailable — seccomp'd containers,
  // old kernels); AUTO/ON -> setsockopt(SO_ZEROCOPY) (EOPNOTSUPP/ENOPROTOOPT
  // leaves the engine disabled: AF_UNIX pairs, pre-4.14 kernels). OFF never
  // probes. Idempotent.
  HVDTPU_CALLED_ON(background)
  void Init(int fd, ZeroCopyMode mode);

  // Lane armed (post-probe, not auto-disabled)?
  HVDTPU_CALLED_ON(any)
  bool enabled() const { return lane_ != Lane::NONE; }
  // Engage for this payload? Small sends stay on the copy path: page
  // pinning + completion reaping cost more than one memcpy below this.
  HVDTPU_CALLED_ON(background)
  bool ShouldUse(size_t len) const {
    return lane_ != Lane::NONE && len >= kMinBytes;
  }

  // Exact-length zero-copy send. 0 = success (all completions drained),
  // -1 = error/abort (errno set), +1 = lane declined before any byte moved
  // (runtime EOPNOTSUPP) — the caller must fall back to the copy path and
  // the engine disables itself. AUTO mode also self-disables after the
  // first drain whose completions all carry SO_EE_CODE_ZEROCOPY_COPIED
  // (the kernel copied anyway — loopback): later sends take the copy path.
  HVDTPU_CALLED_ON(background)
  int SendAll(const void* buf, size_t len, IoControl* ctl);

  // Completed zero-copy sends / sends-that-fell-back since Init, for the
  // data plane's hvdtpu_zerocopy_{sends,fallbacks}_total counters.
  HVDTPU_CALLED_ON(any)
  int64_t sends() const { return sends_; }
  HVDTPU_CALLED_ON(any)
  int64_t kernel_copied_events() const { return copied_notifs_; }

  static constexpr size_t kMinBytes = 128 * 1024;

 private:
  enum class Lane { NONE, MSG_ZC, URING };

  // Reap whatever completions sit in the error queue right now (never
  // blocks). -1 on a genuine socket error.
  int ReapCompletions();
  // Block (in ctl slices) until every issued send's completion arrived.
  int DrainCompletions(IoControl* ctl);
  int UringSubmitSend(const void* buf, size_t len, IoControl* ctl);
  void UringClose();

  Lane lane_ = Lane::NONE;
  ZeroCopyMode mode_ = ZeroCopyMode::OFF;
  int fd_ = -1;
  bool probed_ = false;
  // MSG_ZEROCOPY accounting: one notification per successful zc send call.
  int64_t issued_ = 0;
  int64_t completed_ = 0;
  int64_t copied_notifs_ = 0;  // completions flagged "kernel copied anyway"
  int64_t sends_ = 0;
  // io_uring state (raw syscalls; no liburing dependency).
  int ring_fd_ = -1;
  void* sq_mem_ = nullptr;
  void* cq_mem_ = nullptr;
  void* sqe_mem_ = nullptr;
  size_t sq_mem_bytes_ = 0;
  size_t cq_mem_bytes_ = 0;
  size_t sqe_mem_bytes_ = 0;
  struct UringLayout;
  UringLayout* uring_ = nullptr;
};

class Transport {
 public:
  virtual ~Transport() = default;

  // Lane tag for the timeline / introspection ("tcp", "tcp-zc", "shm", ...).
  HVDTPU_CALLED_ON(any)
  virtual const char* kind() const = 0;

  // Exact-length transfers; 0 on success, -1 on error or abort.
  // (Vectored scatter-gather sends are a socket-level facility — SendAllVec
  // in socket_util.h, used by the control plane's SendFrame — not a lane
  // method: every collective payload is a single contiguous region, so a
  // per-lane Sendv would be interface weight with no caller.)
  HVDTPU_CALLED_ON(background)
  virtual int Send(const void* buf, size_t len) = 0;
  HVDTPU_CALLED_ON(background)
  virtual int Recv(void* buf, size_t len) = 0;

  // Receive with segment callbacks so per-segment work (reduction) overlaps
  // the transfer. A null on_segment degrades to Recv; with a callback, the
  // payload is delivered through the callback views (see SegmentFn) and
  // `buf` is scratch a zero-copy lane may skip. view_align: every view
  // length/offset is a multiple of this (the caller's element size), so
  // in-place reducers never see a torn element.
  HVDTPU_CALLED_ON(background)
  virtual int RecvSegmented(void* buf, size_t len, size_t segment_bytes,
                            size_t view_align, const SegmentFn& on_segment) = 0;

  // Full-duplex exchange with the SAME peer (both sides may send first
  // without deadlock) plus optional segment callbacks on the receive side
  // (same view semantics as RecvSegmented).
  HVDTPU_CALLED_ON(background)
  virtual int SendRecv(const void* send_buf, size_t send_bytes,
                       void* recv_buf, size_t recv_bytes,
                       size_t segment_bytes, size_t view_align,
                       const SegmentFn& on_segment) = 0;

  // True when Send(bytes) completes without any peer progress (the payload
  // fits the transport's own buffering): callers may send inline before a
  // blocking receive with no deadlock risk, skipping the sender thread that
  // dominates small-message latency.
  HVDTPU_CALLED_ON(background)
  virtual bool InlineSendSafe(size_t bytes) const = 0;

  // Break any blocked op on this lane (world abort / peer failure). The TCP
  // lane needs nothing here — DataPlane::Abort shuts the socket down and the
  // sliced reads observe the shared IoControl; the shm lane overrides to
  // flip its cross-process abort flag and wake futex waiters.
  HVDTPU_CALLED_ON(any)
  virtual void Abort() {}

  // The next close is agreed with the peer (no op of it reads this lane
  // any more): the lane closes without aborting the peer's side. No-op for
  // lanes whose close aborts nothing.
  HVDTPU_CALLED_ON(background)
  virtual void CloseCleanly() {}

  // Bytes currently buffered inside the lane's own storage (the shm rings'
  // head-tail spread; 0 for lanes that buffer in the kernel) — the memory-
  // occupancy telemetry's per-lane gauge (docs/profiling.md). Any thread;
  // weakly consistent like the metrics it feeds.
  HVDTPU_CALLED_ON(any)
  virtual int64_t OccupancyBytes() const { return 0; }
};

// The socket path behind the interface. Does NOT own the fd (the
// DataPlane's mesh teardown closes it). With a non-null `ctl` every
// blocking read/write is interruptible: sliced polls observe the plane
// abort flag, peer death fails within one slice, and a silent-but-open
// socket trips the no-progress deadline (docs/fault-tolerance.md).
// zc_mode arms the zero-copy send engine (probed in the constructor; large
// sends ride MSG_ZEROCOPY / io_uring, small ones and failed probes the
// plain copy path — ZeroCopySender above).
class TcpTransport : public Transport {
 public:
  TcpTransport(int fd, int64_t inline_max_bytes, IoControl* ctl = nullptr,
               ZeroCopyMode zc_mode = ZeroCopyMode::OFF)
      : fd_(fd), inline_max_(inline_max_bytes), ctl_(ctl), zc_mode_(zc_mode) {
    zc_.Init(fd, zc_mode);
  }

  HVDTPU_CALLED_ON(any)
  const char* kind() const override {
    return zc_.enabled() ? "tcp-zc" : "tcp";
  }
  HVDTPU_CALLED_ON(background)
  int Send(const void* buf, size_t len) override;
  HVDTPU_CALLED_ON(background)
  int Recv(void* buf, size_t len) override;
  HVDTPU_CALLED_ON(background)
  int RecvSegmented(void* buf, size_t len, size_t segment_bytes,
                    size_t view_align, const SegmentFn& on_segment) override;
  HVDTPU_CALLED_ON(background)
  int SendRecv(const void* send_buf, size_t send_bytes, void* recv_buf,
               size_t recv_bytes, size_t segment_bytes, size_t view_align,
               const SegmentFn& on_segment) override;
  HVDTPU_CALLED_ON(background)
  bool InlineSendSafe(size_t bytes) const override {
    return static_cast<int64_t>(bytes) <= inline_max_;
  }

  // Zero-copy introspection/accounting (the data plane scrapes these into
  // the metrics registry after each op; background thread only).
  HVDTPU_CALLED_ON(any)
  bool zerocopy_enabled() const { return zc_.enabled(); }
  HVDTPU_CALLED_ON(any)
  int64_t zerocopy_sends() const { return zc_.sends(); }
  HVDTPU_CALLED_ON(any)
  int64_t zerocopy_fallbacks() const { return zc_fallbacks_; }

 private:
  int fd_;
  int64_t inline_max_;
  IoControl* ctl_;  // nullable; shared with the owning DataPlane
  ZeroCopyMode zc_mode_;
  ZeroCopySender zc_;
  // Large sends that wanted the zero-copy lane but took the copy path
  // (failed probe, runtime decline, kernel-copies auto-disable).
  int64_t zc_fallbacks_ = 0;
};

}  // namespace hvdtpu
