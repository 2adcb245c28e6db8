#include "socket_util.h"

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>

#include "profiler.h"

namespace hvdtpu {

int TcpListen(int port, int backlog, int* out_port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(fd, backlog) < 0) {
    close(fd);
    return -1;
  }
  if (out_port != nullptr) {
    socklen_t len = sizeof(addr);
    if (getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0) {
      close(fd);
      return -1;
    }
    *out_port = ntohs(addr.sin_port);
  }
  return fd;
}

int TcpAccept(int listen_fd) {
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

int TcpAcceptTimeout(int listen_fd, int timeout_ms) {
  if (!Readable(listen_fd, timeout_ms)) {
    errno = ETIMEDOUT;
    return -1;
  }
  return TcpAccept(listen_fd);
}

int TcpConnectRetry(const std::string& host, int port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_str = std::to_string(port);
  while (true) {
    addrinfo* res = nullptr;
    if (getaddrinfo(host.c_str(), port_str.c_str(), &hints, &res) == 0 &&
        res != nullptr) {
      int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0) {
        if (connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          freeaddrinfo(res);
          return fd;
        }
        close(fd);
      }
      freeaddrinfo(res);
    }
    if (std::chrono::steady_clock::now() >= deadline) {
      errno = ETIMEDOUT;
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
}

int IoSliceMs(const IoControl* ctl) {
  if (ctl == nullptr) return 100;
  int64_t s = ctl->detect_slice_ms;
  return static_cast<int>(s < 1 ? 1 : (s > 1000 ? 1000 : s));
}

namespace {

// One sliced poll while a controlled transfer makes no progress. Returns -1
// (transfer must fail) on plane abort, observed peer death (POLLERR/POLLHUP
// with nothing left to read / POLLOUT side errors), or the no-progress
// deadline; 0 to retry the I/O.
int CtlWait(int fd, short events, IoControl* ctl, double last_progress) {
  if (ctl->is_aborted()) {
    errno = ECANCELED;
    return -1;
  }
  pollfd pfd{fd, events, 0};
  const double wait_t0 = MonoSeconds();
  int rc;
  {
    // Sampling-profiler phase tag (profiler.h): a sample landing inside
    // this poll is blocked-on-peer time, the same split AddWaitUs feeds
    // the perf-attribution WAIT bucket.
    ProfPhaseScope prof_wait(PerfPhase::WAIT);
    rc = poll(&pfd, 1, IoSliceMs(ctl));
  }
  // Peer-wait accounting for the tracing layer: every microsecond inside
  // this poll is time the transfer stalled on the peer, not the wire.
  ctl->AddWaitUs(static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
  if (rc > 0 && (pfd.revents & POLLNVAL) != 0) {
    ctl->MarkPeerFailed();
    errno = ECONNRESET;
    return -1;
  }
  if (rc > 0 && (pfd.revents & POLLERR) != 0) {
    // POLLERR is ambiguous on a socket with the zero-copy lane armed:
    // pending MSG_ZEROCOPY completion notifications sit on the error queue
    // and raise it without any real failure. SO_ERROR tells them apart —
    // zero means "errqueue data only" (the sending thread reaps it), so
    // the transfer just retries; nonzero is a genuine socket error.
    int soerr = 0;
    socklen_t slen = sizeof(soerr);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen) != 0 ||
        soerr != 0) {
      ctl->MarkPeerFailed();
      errno = soerr != 0 ? soerr : ECONNRESET;
      return -1;
    }
    if ((pfd.revents & (events | POLLHUP)) == 0) {
      // Nothing but the errqueue flag: avoid a hard spin while the sender
      // thread drains its completions.
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      return 0;
    }
  }
  if (rc > 0 && (pfd.revents & POLLHUP) != 0 &&
      (pfd.revents & POLLIN) == 0) {
    // Hangup with no readable residue: the peer is gone. (POLLIN|POLLHUP
    // still drains buffered bytes; recv() == 0 catches the EOF after.)
    ctl->MarkPeerFailed();
    errno = ECONNRESET;
    return -1;
  }
  if (ctl->read_deadline_secs > 0 &&
      MonoSeconds() - last_progress > ctl->read_deadline_secs) {
    // Socket alive but silent past the deadline: a hung peer. Declare it
    // dead rather than blocking the world forever (the transport-level
    // analog of the coordinator's stall shutdown).
    ctl->MarkPeerFailed();
    errno = ETIMEDOUT;
    return -1;
  }
  return 0;
}

}  // namespace

int SendAll(int fd, const void* buf, size_t len, IoControl* ctl) {
  const char* p = static_cast<const char*>(buf);
  double last_progress = ctl != nullptr ? MonoSeconds() : 0;
  while (len > 0) {
    ssize_t n = send(fd, p, len,
                     MSG_NOSIGNAL | (ctl != nullptr ? MSG_DONTWAIT : 0));
    if (n < 0) {
      if (errno == EINTR) continue;
      if (ctl != nullptr && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (CtlWait(fd, POLLOUT, ctl, last_progress) != 0) return -1;
        continue;
      }
      if (ctl != nullptr) ctl->MarkPeerFailed();  // EPIPE/ECONNRESET/...
      return -1;
    }
    p += n;
    len -= static_cast<size_t>(n);
    if (ctl != nullptr && n > 0) last_progress = MonoSeconds();
  }
  return 0;
}

int RecvAll(int fd, void* buf, size_t len, IoControl* ctl) {
  char* p = static_cast<char*>(buf);
  double last_progress = ctl != nullptr ? MonoSeconds() : 0;
  while (len > 0) {
    ssize_t n = recv(fd, p, len, ctl != nullptr ? MSG_DONTWAIT : 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (ctl != nullptr && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (CtlWait(fd, POLLIN, ctl, last_progress) != 0) return -1;
        continue;
      }
      if (ctl != nullptr) ctl->MarkPeerFailed();
      return -1;
    }
    if (n == 0) {
      if (ctl != nullptr) ctl->MarkPeerFailed();
      errno = ECONNRESET;
      return -1;  // peer closed
    }
    p += n;
    len -= static_cast<size_t>(n);
    if (ctl != nullptr) last_progress = MonoSeconds();
  }
  return 0;
}

int SendAllVec(int fd, struct iovec* iov, int iovcnt, IoControl* ctl) {
  double last_progress = ctl != nullptr ? MonoSeconds() : 0;
  int i = 0;
  while (i < iovcnt) {
    if (iov[i].iov_len == 0) {
      ++i;
      continue;
    }
    msghdr mh;
    memset(&mh, 0, sizeof(mh));
    mh.msg_iov = iov + i;
    mh.msg_iovlen = static_cast<size_t>(iovcnt - i);
    ssize_t n = sendmsg(fd, &mh,
                        MSG_NOSIGNAL | (ctl != nullptr ? MSG_DONTWAIT : 0));
    if (n < 0) {
      if (errno == EINTR) continue;
      if (ctl != nullptr && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (CtlWait(fd, POLLOUT, ctl, last_progress) != 0) return -1;
        continue;
      }
      if (ctl != nullptr) ctl->MarkPeerFailed();
      return -1;
    }
    if (ctl != nullptr && n > 0) last_progress = MonoSeconds();
    // Advance past fully sent iovecs, then trim the partial head.
    size_t left = static_cast<size_t>(n);
    while (i < iovcnt && left >= iov[i].iov_len) {
      left -= iov[i].iov_len;
      ++i;
    }
    if (i < iovcnt && left > 0) {
      iov[i].iov_base = static_cast<char*>(iov[i].iov_base) + left;
      iov[i].iov_len -= left;
    }
  }
  return 0;
}

int SendRecvSegmented(
    int send_fd, const void* send_buf, size_t send_bytes, int recv_fd,
    void* recv_buf, size_t recv_bytes, size_t segment_bytes,
    const std::function<void(const uint8_t*, size_t, size_t)>& on_segment,
    IoControl* ctl) {
  if (segment_bytes == 0 || segment_bytes > recv_bytes) {
    segment_bytes = recv_bytes;
  }
  int send_rc = 0;
  // No sender thread for receive-only calls (TcpTransport::RecvSegmented
  // delegates here with send_bytes == 0 on every segmented ring hop).
  std::thread sender;
  if (send_bytes > 0) {
    sender = std::thread(
        [&] { send_rc = SendAll(send_fd, send_buf, send_bytes, ctl); });
  }
  int recv_rc = 0;
  if (recv_bytes > 0) {
    if (!on_segment) {
      recv_rc = RecvAll(recv_fd, recv_buf, recv_bytes, ctl);
    } else {
      // Receiver thread lands segments and publishes a high-water mark; the
      // calling thread consumes them (runs on_segment) as they arrive.
      // Segments are disjoint, so the mutex only guards the counters — the
      // handoff of each buffer region rides the received/consumed ordering.
      std::mutex mu;
      std::condition_variable cv;
      size_t received = 0;
      bool done = false;
      std::thread receiver([&] {
        char* p = static_cast<char*>(recv_buf);
        size_t off = 0;
        int rc = 0;
        while (off < recv_bytes) {
          size_t len = std::min(segment_bytes, recv_bytes - off);
          rc = RecvAll(recv_fd, p + off, len, ctl);
          if (rc != 0) break;
          off += len;
          {
            std::lock_guard<std::mutex> lk(mu);
            received = off;
          }
          cv.notify_one();
        }
        {
          std::lock_guard<std::mutex> lk(mu);
          done = true;
          if (rc != 0) recv_rc = rc;
        }
        cv.notify_one();
      });
      size_t consumed = 0;
      while (consumed < recv_bytes) {
        size_t avail;
        bool finished;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [&] { return received > consumed || done; });
          avail = received;
          finished = done;
        }
        if (avail > consumed) {
          on_segment(static_cast<const uint8_t*>(recv_buf) + consumed,
                     consumed, avail - consumed);
          consumed = avail;
        } else if (finished) {
          break;  // receive error: recv_rc is set
        }
      }
      receiver.join();
    }
  }
  if (sender.joinable()) sender.join();
  return (send_rc != 0 || recv_rc != 0) ? -1 : 0;
}

int SendFrame(int fd, const std::vector<uint8_t>& payload) {
  // One vectored syscall for [u64 length][payload]: the header no longer
  // rides its own send (and, under TCP_NODELAY, its own packet).
  uint64_t len = payload.size();
  iovec iov[2] = {{&len, sizeof(len)},
                  {const_cast<uint8_t*>(payload.data()), payload.size()}};
  return SendAllVec(fd, iov, len > 0 ? 2 : 1);
}

int RecvFrame(int fd, std::vector<uint8_t>* payload) {
  uint64_t len = 0;
  if (RecvAll(fd, &len, sizeof(len)) != 0) return -1;
  payload->resize(len);
  if (len > 0 && RecvAll(fd, payload->data(), len) != 0) return -1;
  return 0;
}

bool Readable(int fd, int timeout_ms) {
  pollfd pfd{fd, POLLIN, 0};
  return poll(&pfd, 1, timeout_ms) > 0 && (pfd.revents & POLLIN) != 0;
}

void CloseFd(int fd) {
  if (fd >= 0) close(fd);
}

}  // namespace hvdtpu
