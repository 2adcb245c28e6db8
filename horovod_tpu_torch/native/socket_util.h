// Minimal TCP plumbing: listeners, retrying connects, length-prefixed frames.
//
// Fills the role of the reference's gloo TCP device + HTTPStore rendezvous
// (horovod/common/gloo/) with plain POSIX sockets — the control plane and the
// loopback/CPU data plane both ride these.
#pragma once

#include <sys/uio.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <functional>
#include <string>
#include <vector>

namespace hvdtpu {

// Monotonic clock as seconds (progress/deadline bookkeeping across the
// transports and the data plane).
inline double MonoSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Shared fault-detection control block for one data plane's transports
// (docs/fault-tolerance.md). Every blocking transport read/write that gets a
// pointer to one becomes interruptible: it polls in `detect_slice_ms` slices
// so a plane-wide abort is observed within one slice, fails fast on peer
// death (EOF/RST/POLLHUP), and — when `read_deadline_secs` > 0 — declares a
// peer dead after that long with zero progress (the transport-level stall
// escalation; a hung-but-alive rank produces no EOF). The flags are relaxed
// atomics any thread may read; writers use MarkPeerFailed/store-release.
// The plain-int tuning fields are written before Connect only.
struct IoControl {
  std::atomic<uint32_t> aborted{0};      // plane-wide: fail every lane op  // atomic: acquire-read
  std::atomic<uint32_t> peer_failed{0};  // a lane observed peer death  // atomic: release-publish
  int64_t detect_slice_ms = 100;         // poll slice (abort latency bound)
  double read_deadline_secs = 0;         // 0 = no no-progress deadline
  // Cumulative peer-wait time: microseconds every controlled op spent
  // blocked for the peer (sliced polls on an empty/full socket, futex waits
  // on the shm rings, zero-copy completion drains) rather than moving
  // bytes. The distributed-tracing layer snapshots it around each hop to
  // split hop time into wait vs wire (docs/tracing.md straggler
  // attribution). Relaxed adds on the already-slow blocked path: free on
  // the hot path.
  std::atomic<int64_t> wait_us{0};  // atomic: relaxed-counter

  bool is_aborted() const {
    return aborted.load(std::memory_order_acquire) != 0;
  }
  void MarkPeerFailed() {
    peer_failed.store(1, std::memory_order_release);
    aborted.store(1, std::memory_order_release);
  }
  void AddWaitUs(int64_t us) {
    if (us > 0) wait_us.fetch_add(us, std::memory_order_relaxed);
  }
  int64_t WaitUs() const {
    return wait_us.load(std::memory_order_relaxed);
  }
};

// Poll-slice length in ms for a controlled blocking op: the control's
// detect_slice_ms clamped to [1, 1000] (100 with no control block). One
// clamp policy for every sliced wait — SendAll/RecvAll here, the
// zero-copy completion drains in transport.cpp.
int IoSliceMs(const IoControl* ctl);

// All functions return >= 0 on success, -1 on error (errno preserved).

// Create a listening socket bound to 0.0.0.0:port (port 0 = ephemeral).
// On success stores the actual port in *out_port.
int TcpListen(int port, int backlog, int* out_port);

// Accept one connection (blocking). Returns connected fd.
int TcpAccept(int listen_fd);

// Accept with a deadline: -1 with errno ETIMEDOUT when no connection lands
// within timeout_ms (bounds world form-up so a vanished peer cannot wedge
// rendezvous forever; docs/fault-tolerance.md).
int TcpAcceptTimeout(int listen_fd, int timeout_ms);

// Connect to host:port, retrying for up to timeout_ms (covers peer startup
// races during rendezvous). Returns connected fd.
int TcpConnectRetry(const std::string& host, int port, int timeout_ms);

// Exact-length send/recv (loop over partial transfers). 0 on success.
// With a non-null `ctl` the loop becomes interruptible (see IoControl): the
// hot path still issues one recv/send syscall per chunk (MSG_DONTWAIT), and
// only an empty/full socket buffer drops to a sliced poll that watches the
// abort flag, peer death, and the no-progress deadline.
int SendAll(int fd, const void* buf, size_t len, IoControl* ctl = nullptr);
int RecvAll(int fd, void* buf, size_t len, IoControl* ctl = nullptr);

// Vectored exact-length send (sendmsg scatter-gather): every byte of every
// iovec is shipped, partial transfers advance the (caller-owned, mutated)
// iovec array in place — one syscall per kernel-buffer-ful instead of one
// per iovec, so header+payload pairs (length-prefixed frames, quantized
// header+codes) leave without a staging copy or a second syscall. Same
// IoControl semantics as SendAll. 0 on success.
int SendAllVec(int fd, struct iovec* iov, int iovcnt,
               IoControl* ctl = nullptr);

// Full-duplex segmented transfer: streams send_bytes out of send_fd while
// receiving recv_bytes into recv_buf, invoking on_segment(data, offset,
// length) on the CALLING thread as each received segment lands (data ==
// recv_buf + offset here; the shm transport's zero-copy override passes
// in-ring views instead) — later segments keep streaming in a background
// thread, so per-segment work (e.g. reduction) overlaps the wire time.
// Offsets/lengths are multiples of segment_bytes except the final segment.
// segment_bytes == 0 means one segment; a null on_segment degrades to a
// plain concurrent send+recv. 0 on success.
int SendRecvSegmented(
    int send_fd, const void* send_buf, size_t send_bytes, int recv_fd,
    void* recv_buf, size_t recv_bytes, size_t segment_bytes,
    const std::function<void(const uint8_t*, size_t, size_t)>& on_segment,
    IoControl* ctl = nullptr);

// Length-prefixed frame: [u64 length][payload].
int SendFrame(int fd, const std::vector<uint8_t>& payload);
int RecvFrame(int fd, std::vector<uint8_t>* payload);

// True if the fd has readable data (poll with timeout_ms; 0 = nonblocking).
bool Readable(int fd, int timeout_ms);

void CloseFd(int fd);

}  // namespace hvdtpu
