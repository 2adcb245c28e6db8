#include "transport.h"

#include <errno.h>
#include <poll.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <thread>

#include "socket_util.h"

#if defined(__linux__)
#include <linux/errqueue.h>
#if __has_include(<linux/io_uring.h>)
#include <linux/io_uring.h>
#define HVD_HAVE_IO_URING 1
#endif
#endif

namespace hvdtpu {

namespace {

// Constants newer than this box's uapi headers (the kernel is probed at
// runtime either way; stale headers must not force the copy path).
#if defined(HVD_HAVE_IO_URING)
constexpr uint8_t kIoringOpSendZc = 47;      // IORING_OP_SEND_ZC (>= 6.0)
constexpr uint32_t kIoringCqeFNotif = 1u << 3;  // IORING_CQE_F_NOTIF
#endif

}  // namespace

// ---------------------------------------------------------------------------
// ZeroCopySender
// ---------------------------------------------------------------------------

#if defined(HVD_HAVE_IO_URING)
struct ZeroCopySender::UringLayout {
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned sq_mask = 0;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned cq_mask = 0;
  io_uring_cqe* cqes = nullptr;
  io_uring_sqe* sqes = nullptr;
  bool single_mmap = false;
  int64_t notifs_pending = 0;  // SEND_ZC buffer-release CQEs not yet seen
  bool send_zc_ok = true;      // flips off on -EINVAL (pre-6.0 kernel)
};
#else
struct ZeroCopySender::UringLayout {};
#endif

void ZeroCopySender::Init(int fd, ZeroCopyMode mode) {
  if (probed_) return;
  probed_ = true;
  fd_ = fd;
  mode_ = mode;
  lane_ = Lane::NONE;
  if (mode == ZeroCopyMode::OFF || fd < 0) return;
#if defined(HVD_HAVE_IO_URING)
  if (mode == ZeroCopyMode::URING) {
    // Probe order (docs/collectives.md): io_uring ring first; a failed
    // setup (seccomp'd container, old kernel, RLIMIT_MEMLOCK) falls
    // through to the MSG_ZEROCOPY probe below.
    io_uring_params params;
    memset(&params, 0, sizeof(params));
    long rfd = syscall(SYS_io_uring_setup, 8, &params);
    if (rfd >= 0) {
      ring_fd_ = static_cast<int>(rfd);
      sq_mem_bytes_ =
          params.sq_off.array + params.sq_entries * sizeof(unsigned);
      cq_mem_bytes_ =
          params.cq_off.cqes + params.cq_entries * sizeof(io_uring_cqe);
      const bool single = (params.features & IORING_FEAT_SINGLE_MMAP) != 0;
      if (single) {
        sq_mem_bytes_ = cq_mem_bytes_ =
            sq_mem_bytes_ > cq_mem_bytes_ ? sq_mem_bytes_ : cq_mem_bytes_;
      }
      sq_mem_ = mmap(nullptr, sq_mem_bytes_, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, ring_fd_, IORING_OFF_SQ_RING);
      cq_mem_ = single ? sq_mem_
                       : mmap(nullptr, cq_mem_bytes_, PROT_READ | PROT_WRITE,
                              MAP_SHARED | MAP_POPULATE, ring_fd_,
                              IORING_OFF_CQ_RING);
      sqe_mem_bytes_ = params.sq_entries * sizeof(io_uring_sqe);
      sqe_mem_ = mmap(nullptr, sqe_mem_bytes_, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, ring_fd_, IORING_OFF_SQES);
      if (sq_mem_ != MAP_FAILED && cq_mem_ != MAP_FAILED &&
          sqe_mem_ != MAP_FAILED) {
        uring_ = new UringLayout();
        auto* sqb = static_cast<uint8_t*>(sq_mem_);
        auto* cqb = static_cast<uint8_t*>(cq_mem_);
        uring_->sq_head =
            reinterpret_cast<unsigned*>(sqb + params.sq_off.head);
        uring_->sq_tail =
            reinterpret_cast<unsigned*>(sqb + params.sq_off.tail);
        uring_->sq_mask =
            *reinterpret_cast<unsigned*>(sqb + params.sq_off.ring_mask);
        uring_->sq_array =
            reinterpret_cast<unsigned*>(sqb + params.sq_off.array);
        uring_->cq_head =
            reinterpret_cast<unsigned*>(cqb + params.cq_off.head);
        uring_->cq_tail =
            reinterpret_cast<unsigned*>(cqb + params.cq_off.tail);
        uring_->cq_mask =
            *reinterpret_cast<unsigned*>(cqb + params.cq_off.ring_mask);
        uring_->cqes =
            reinterpret_cast<io_uring_cqe*>(cqb + params.cq_off.cqes);
        uring_->sqes = static_cast<io_uring_sqe*>(sqe_mem_);
        uring_->single_mmap = single;
        lane_ = Lane::URING;
        return;
      }
      UringClose();
    }
  }
#endif  // HVD_HAVE_IO_URING
#if defined(SO_ZEROCOPY) && defined(MSG_ZEROCOPY)
  int one = 1;
  if (setsockopt(fd, SOL_SOCKET, SO_ZEROCOPY, &one, sizeof(one)) == 0) {
    lane_ = Lane::MSG_ZC;
  }
#endif
  // EOPNOTSUPP/ENOPROTOOPT (AF_UNIX, old kernel): stay on the copy path.
}

ZeroCopySender::~ZeroCopySender() { UringClose(); }

void ZeroCopySender::UringClose() {
#if defined(HVD_HAVE_IO_URING)
  if (sq_mem_ != nullptr && sq_mem_ != MAP_FAILED) {
    munmap(sq_mem_, sq_mem_bytes_);
  }
  if (cq_mem_ != nullptr && cq_mem_ != MAP_FAILED && cq_mem_ != sq_mem_) {
    munmap(cq_mem_, cq_mem_bytes_);
  }
  if (sqe_mem_ != nullptr && sqe_mem_ != MAP_FAILED) {
    munmap(sqe_mem_, sqe_mem_bytes_);
  }
#endif
  sq_mem_ = cq_mem_ = sqe_mem_ = nullptr;
  if (ring_fd_ >= 0) close(ring_fd_);
  ring_fd_ = -1;
  delete uring_;
  uring_ = nullptr;
}

int ZeroCopySender::ReapCompletions() {
#if defined(SO_ZEROCOPY) && defined(MSG_ZEROCOPY)
  for (;;) {
    // Completion notifications ride the socket error queue as
    // sock_extended_err control messages (SO_EE_ORIGIN_ZEROCOPY), each
    // acking the inclusive range [ee_info, ee_data] of zerocopy sends.
    alignas(cmsghdr) char ctrl[128];
    msghdr mh;
    memset(&mh, 0, sizeof(mh));
    mh.msg_control = ctrl;
    mh.msg_controllen = sizeof(ctrl);
    ssize_t r = recvmsg(fd_, &mh, MSG_ERRQUEUE | MSG_DONTWAIT);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
        return 0;  // queue empty
      }
      return -1;
    }
    for (cmsghdr* cm = CMSG_FIRSTHDR(&mh); cm != nullptr;
         cm = CMSG_NXTHDR(&mh, cm)) {
      auto* ee = reinterpret_cast<sock_extended_err*>(CMSG_DATA(cm));
      if (ee->ee_origin == SO_EE_ORIGIN_ZEROCOPY) {
        completed_ +=
            static_cast<int64_t>(ee->ee_data) - ee->ee_info + 1;
        if ((ee->ee_code & SO_EE_CODE_ZEROCOPY_COPIED) != 0) {
          ++copied_notifs_;
        }
      } else {
        // A real transmission error (ICMP, route gone) queued behind the
        // notifications: surface it as a lane failure.
        errno = ee->ee_errno != 0 ? ee->ee_errno : ECONNRESET;
        return -1;
      }
    }
  }
#else
  return 0;
#endif
}

int ZeroCopySender::DrainCompletions(IoControl* ctl) {
  double last_progress = MonoSeconds();
  while (completed_ < issued_) {
    int64_t before = completed_;
    if (ReapCompletions() != 0) {
      if (ctl != nullptr) ctl->MarkPeerFailed();
      return -1;
    }
    if (completed_ > before) {
      last_progress = MonoSeconds();
      continue;
    }
    if (ctl != nullptr && ctl->is_aborted()) {
      errno = ECANCELED;
      return -1;
    }
    if (ctl != nullptr && ctl->read_deadline_secs > 0 &&
        MonoSeconds() - last_progress > ctl->read_deadline_secs) {
      // The peer must consume our bytes for the kernel to release the
      // pages; a silent peer therefore stalls the drain exactly like a
      // stalled read — same escalation (docs/fault-tolerance.md).
      ctl->MarkPeerFailed();
      errno = ETIMEDOUT;
      return -1;
    }
    // poll with no requested events still reports POLLERR, which is how
    // errqueue readiness surfaces — the completion wait folds into the
    // same slice discipline as every other blocking transport op.
    pollfd pfd{fd_, 0, 0};
    const double wait_t0 = MonoSeconds();
    poll(&pfd, 1, IoSliceMs(ctl));
    if (ctl != nullptr) {
      // Peer-wait accounting (tracing): a completion drain parks on the
      // peer consuming our bytes, exactly like a blocked send.
      ctl->AddWaitUs(static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
    }
    if ((pfd.revents & (POLLHUP | POLLNVAL)) != 0 &&
        (pfd.revents & POLLERR) == 0) {
      if (ctl != nullptr) ctl->MarkPeerFailed();
      errno = ECONNRESET;
      return -1;
    }
  }
  return 0;
}

#if defined(HVD_HAVE_IO_URING)
namespace {
// Reap every currently-visible CQE; reports (via out-params) the result
// CQE, if one appeared, and adjusts the SEND_ZC notification debt. Returns
// the number of CQEs consumed.
struct UringCqeScan {
  bool got_result = false;
  ssize_t res = 0;
};
}  // namespace

int ZeroCopySender::UringSubmitSend(const void* buf, size_t len,
                                    IoControl* ctl) {
  // One SQE at a time, partial sends looped — a submission lane, not a
  // batching engine; the payloads here are single large buffers. SEND_ZC
  // (zero-copy, two CQEs: result + buffer-release notification) when the
  // kernel has it, with an -EINVAL downgrade to plain IORING_OP_SEND.
  const char* p = static_cast<const char*>(buf);
  size_t off = 0;
  double last_progress = MonoSeconds();
  auto reap_visible = [&](UringCqeScan* scan) -> int {
    unsigned chead = *uring_->cq_head;
    unsigned ctail = __atomic_load_n(uring_->cq_tail, __ATOMIC_ACQUIRE);
    int consumed = 0;
    while (chead != ctail) {
      io_uring_cqe* cqe = &uring_->cqes[chead & uring_->cq_mask];
      if ((cqe->flags & kIoringCqeFNotif) != 0) {
        --uring_->notifs_pending;
      } else if (scan != nullptr) {
        scan->got_result = true;
        scan->res = cqe->res;
        if ((cqe->flags & IORING_CQE_F_MORE) != 0) {
          ++uring_->notifs_pending;  // SEND_ZC: release CQE still due
        }
      }
      ++chead;
      ++consumed;
    }
    __atomic_store_n(uring_->cq_head, chead, __ATOMIC_RELEASE);
    return consumed;
  };
  auto wait_for_cqes = [&]() -> int {
    // Nothing visible in the mapped ring: with a CQ of only ~16 entries,
    // deferred SEND_ZC notifications can land in the kernel's overflow
    // backlog, which is flushed into the ring only by an enter() with
    // GETEVENTS — poll() alone would wait forever on backlogged CQEs.
    (void)syscall(SYS_io_uring_enter, ring_fd_, 0, 0,
                  IORING_ENTER_GETEVENTS, nullptr, 0);
    if (ctl != nullptr && ctl->is_aborted()) {
      errno = ECANCELED;
      return -1;
    }
    if (ctl != nullptr && ctl->read_deadline_secs > 0 &&
        MonoSeconds() - last_progress > ctl->read_deadline_secs) {
      ctl->MarkPeerFailed();
      errno = ETIMEDOUT;
      return -1;
    }
    pollfd pfd{ring_fd_, POLLIN, 0};
    const double wait_t0 = MonoSeconds();
    poll(&pfd, 1, IoSliceMs(ctl));
    if (ctl != nullptr) {
      ctl->AddWaitUs(static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
    }
    return 0;
  };
  while (off < len) {
    if (ctl != nullptr && ctl->is_aborted()) {
      errno = ECANCELED;
      return -1;
    }
    // Keep notification headroom in the tiny CQ: drain before staging
    // another SEND_ZC when half the ring could already be owed.
    while (uring_->notifs_pending >= 8) {
      if (reap_visible(nullptr) > 0) {
        last_progress = MonoSeconds();
        continue;
      }
      if (wait_for_cqes() != 0) return -1;
    }
    unsigned tail = *uring_->sq_tail;
    unsigned idx = tail & uring_->sq_mask;
    io_uring_sqe* sqe = &uring_->sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = uring_->send_zc_ok
                      ? kIoringOpSendZc
                      : static_cast<uint8_t>(IORING_OP_SEND);
    sqe->fd = fd_;
    sqe->addr = reinterpret_cast<uint64_t>(p + off);
    sqe->len = static_cast<uint32_t>(len - off);
    sqe->msg_flags = MSG_NOSIGNAL;
    uring_->sq_array[idx] = idx;
    __atomic_store_n(uring_->sq_tail, tail + 1, __ATOMIC_RELEASE);
    // The SQE is staged exactly once; only the enter() is retried on
    // EINTR/partial consumption — re-staging would queue a duplicate send
    // of the same byte range and corrupt the stream.
    int to_submit = 1;
    while (to_submit > 0) {
      long rc =
          syscall(SYS_io_uring_enter, ring_fd_, to_submit, 0, 0, nullptr, 0);
      if (rc < 0) {
        if (errno == EINTR) continue;
        return -1;
      }
      to_submit -= static_cast<int>(rc);
    }
    // Wait for the result CQE (and count SEND_ZC notification CQEs as they
    // arrive; stragglers are drained after the final byte).
    UringCqeScan scan;
    while (!scan.got_result) {
      if (reap_visible(&scan) > 0) {
        last_progress = MonoSeconds();
        continue;
      }
      if (wait_for_cqes() != 0) return -1;
    }
    ssize_t res = scan.res;
    if (res < 0) {
      if (res == -EINVAL && uring_->send_zc_ok) {
        // Kernel without SEND_ZC: downgrade this lane to plain OP_SEND
        // submissions (still the io_uring lane, no longer zero-copy).
        uring_->send_zc_ok = false;
        continue;
      }
      if (res == -EAGAIN || res == -EINTR) continue;
      errno = static_cast<int>(-res);
      if (ctl != nullptr) ctl->MarkPeerFailed();
      return -1;
    }
    off += static_cast<size_t>(res);
    last_progress = MonoSeconds();
  }
  // Drain outstanding SEND_ZC notifications: the caller reuses the buffer
  // the moment we return, so every page reference must be gone.
  while (uring_->notifs_pending > 0) {
    if (reap_visible(nullptr) > 0) {
      last_progress = MonoSeconds();
      continue;
    }
    if (wait_for_cqes() != 0) return -1;
  }
  return 0;
}
#else
int ZeroCopySender::UringSubmitSend(const void*, size_t, IoControl*) {
  errno = EOPNOTSUPP;
  return 1;
}
#endif  // HVD_HAVE_IO_URING

int ZeroCopySender::SendAll(const void* buf, size_t len, IoControl* ctl) {
  if (lane_ == Lane::URING) {
    int rc = UringSubmitSend(buf, len, ctl);
    if (rc > 0) {
      lane_ = Lane::NONE;  // ring unusable at send time: copy path from here
      return 1;
    }
    if (rc == 0) ++sends_;
    return rc;
  }
#if defined(SO_ZEROCOPY) && defined(MSG_ZEROCOPY)
  const char* p = static_cast<const char*>(buf);
  size_t off = 0;
  const int64_t issued_before = issued_;
  const int64_t copied_before = copied_notifs_;
  double last_progress = MonoSeconds();
  while (off < len) {
    ssize_t n = send(fd_, p + off, len - off,
                     MSG_NOSIGNAL | MSG_DONTWAIT | MSG_ZEROCOPY);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EOPNOTSUPP && off == 0 && issued_ == issued_before) {
        // Probe passed but the send path refused (e.g. a socket family
        // that accepts SO_ZEROCOPY but not the flag): permanent fallback.
        lane_ = Lane::NONE;
        return 1;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS) {
        const bool optmem_full = errno == ENOBUFS;
        // Full socket buffer (EAGAIN) or the optmem pinned-page accounting
        // limit (ENOBUFS — /proc/sys/net/core/optmem_max is 128 KB on many
        // hosts, far below one large send): reap completions to release
        // pinned pages before deciding how to wait.
        int64_t completed_before_reap = completed_;
        if (ReapCompletions() != 0) {
          if (ctl != nullptr) ctl->MarkPeerFailed();
          return -1;
        }
        if (completed_ > completed_before_reap) {
          last_progress = MonoSeconds();  // peer consumed: real progress
          continue;
        }
        if (optmem_full && completed_ == issued_) {
          // ENOBUFS with NOTHING outstanding: the accounting budget cannot
          // hold even one in-flight send on this host — zero-copy cannot
          // function. Disable the lane; untransmitted bytes take the copy
          // path (same byte stream, just copied).
          lane_ = Lane::NONE;
          if (off == 0) return 1;  // clean decline: caller falls back
          int rc = hvdtpu::SendAll(fd_, p + off, len - off, ctl);
          if (rc == 0) ++sends_;  // the prefix did ride zero-copy
          return rc;
        }
        if (ctl != nullptr && ctl->is_aborted()) {
          errno = ECANCELED;
          return -1;
        }
        if (ctl != nullptr && ctl->read_deadline_secs > 0 &&
            MonoSeconds() - last_progress > ctl->read_deadline_secs) {
          ctl->MarkPeerFailed();
          errno = ETIMEDOUT;
          return -1;
        }
        // ENOBUFS with sends outstanding: writable space is NOT the gate —
        // poll for errqueue readiness (POLLERR, events=0) so we sleep until
        // completions arrive instead of busy-spinning on an already
        // writable socket. EAGAIN waits for writability as usual.
        pollfd pfd{fd_, static_cast<short>(optmem_full ? 0 : POLLOUT), 0};
        const double wait_t0 = MonoSeconds();
        poll(&pfd, 1, IoSliceMs(ctl));
        if (ctl != nullptr) {
          ctl->AddWaitUs(
              static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
        }
        if ((pfd.revents & POLLNVAL) != 0) {
          if (ctl != nullptr) ctl->MarkPeerFailed();
          errno = ECONNRESET;
          return -1;
        }
        continue;
      }
      if (ctl != nullptr) ctl->MarkPeerFailed();
      return -1;
    }
    ++issued_;  // one errqueue notification per successful zerocopy send
    off += static_cast<size_t>(n);
    last_progress = MonoSeconds();
  }
  if (DrainCompletions(ctl) != 0) return -1;
  ++sends_;
  if (mode_ == ZeroCopyMode::AUTO &&
      copied_notifs_ - copied_before >= issued_ - issued_before &&
      issued_ > issued_before) {
    // Every completion of this send reported SO_EE_CODE_ZEROCOPY_COPIED:
    // the kernel copied anyway (loopback, non-SG NIC). Pinning pages and
    // reaping notifications is pure overhead then — back off to the plain
    // copy path for the rest of this connection's life.
    lane_ = Lane::NONE;
  }
  return 0;
#else
  (void)buf;
  (void)len;
  (void)ctl;
  lane_ = Lane::NONE;
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// TcpTransport
// ---------------------------------------------------------------------------

int TcpTransport::Send(const void* buf, size_t len) {
  if (len == 0) return 0;
  if (zc_.ShouldUse(len)) {
    int rc = zc_.SendAll(buf, len, ctl_);
    if (rc <= 0) return rc;
    ++zc_fallbacks_;  // rc > 0: lane declined, fall through to the copy path
  } else if (zc_mode_ != ZeroCopyMode::OFF && len >= ZeroCopySender::kMinBytes) {
    ++zc_fallbacks_;  // zero-copy requested but unavailable on this lane
  }
  return SendAll(fd_, buf, len, ctl_);
}

int TcpTransport::Recv(void* buf, size_t len) {
  if (len == 0) return 0;
  return RecvAll(fd_, buf, len, ctl_);
}

int TcpTransport::RecvSegmented(void* buf, size_t len, size_t segment_bytes,
                                size_t view_align,
                                const SegmentFn& on_segment) {
  (void)view_align;  // TCP lands every byte in buf: views are buf-backed
  if (len == 0) {
    return 0;
  }
  if (!on_segment) return RecvAll(fd_, buf, len, ctl_);
  if (segment_bytes == 0 || len < 2 * segment_bytes) {
    // One (or barely two) segments: background-receiver machinery buys
    // nothing; land the payload and run the callback once.
    int rc = RecvAll(fd_, buf, len, ctl_);
    if (rc == 0) on_segment(static_cast<const uint8_t*>(buf), 0, len);
    return rc;
  }
  // Reuse the pipelined receiver (background thread lands segments, the
  // calling thread consumes them) with a zero-byte send side.
  return SendRecvSegmented(-1, nullptr, 0, fd_, buf, len, segment_bytes,
                           on_segment, ctl_);
}

int TcpTransport::SendRecv(const void* send_buf, size_t send_bytes,
                           void* recv_buf, size_t recv_bytes,
                           size_t segment_bytes, size_t view_align,
                           const SegmentFn& on_segment) {
  if (on_segment && segment_bytes > 0 && recv_bytes >= 2 * segment_bytes) {
    // Sender thread + segmented receive on the calling thread. The send
    // side goes through Send() so large payloads ride the zero-copy lane.
    int send_rc = 0;
    std::thread sender([&] { send_rc = Send(send_buf, send_bytes); });
    int recv_rc = RecvSegmented(recv_buf, recv_bytes, segment_bytes,
                                view_align, on_segment);
    sender.join();
    return (send_rc != 0 || recv_rc != 0) ? -1 : 0;
  }
  int rc = 0;
  if (InlineSendSafe(send_bytes)) {
    // Payload fits the kernel socket buffers: blocking send then receive on
    // the calling thread — both peers sending first cannot deadlock, and
    // skipping the sender thread is the bulk of the small-message win.
    if (send_bytes > 0) rc = SendAll(fd_, send_buf, send_bytes, ctl_);
    if (rc == 0 && recv_bytes > 0) rc = RecvAll(fd_, recv_buf, recv_bytes, ctl_);
  } else {
    int send_rc = 0;
    std::thread sender([&] { send_rc = Send(send_buf, send_bytes); });
    int recv_rc = 0;
    if (recv_bytes > 0) recv_rc = RecvAll(fd_, recv_buf, recv_bytes, ctl_);
    sender.join();
    rc = (send_rc != 0 || recv_rc != 0) ? -1 : 0;
  }
  if (rc == 0 && on_segment && recv_bytes > 0) {
    on_segment(static_cast<const uint8_t*>(recv_buf), 0, recv_bytes);
  }
  return rc;
}

}  // namespace hvdtpu
