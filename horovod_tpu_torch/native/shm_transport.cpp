#include "shm_transport.h"

#include <ctype.h>
#include <dirent.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <climits>
#include <cstring>
#include <new>
#include <thread>

#include "profiler.h"

namespace hvdtpu {

namespace {

// Shared (cross-process) futex wait/wake. The protocol never RELIES on wake
// delivery — every wait carries a timeout and re-checks the ring cursors —
// so futex here is purely a power/latency optimization over spinning. The
// batched doorbells (NotifyHeadAdvance/NotifyTailAdvance) lean the same way:
// a coalesced-away wake is repaired by the next batch boundary, the op-end
// flush, or at worst one wait-slice timeout.
int FutexWait(std::atomic<uint32_t>* addr, uint32_t expected, int timeout_ms) {
  timespec ts{timeout_ms / 1000, (timeout_ms % 1000) * 1000000L};
  return static_cast<int>(
      syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
              expected, &ts, nullptr, 0));
}

void FutexWake(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE, INT_MAX,
          nullptr, nullptr, 0);
}

constexpr uint32_t kMagic = 0x48565453u;  // "HVTS"
constexpr int kSpinIters = 4096;
constexpr int kWaitSliceMs = 100;

// Pre-futex spin budget. Spinning bets that the peer is running RIGHT NOW
// on another core; on a single-CPU host that bet is always lost — the peer
// cannot advance a cursor while we burn its timeslice — so the budget
// drops to a token few iterations and blocked waits go straight to the
// futex (which yields the core to the peer).
int SpinIters() {
  static const int iters =
      std::thread::hardware_concurrency() > 1 ? kSpinIters : 16;
  return iters;
}

// mbind(2) plumbing without <numaif.h> (absent on this image; the syscall
// is probed at runtime and any failure degrades to "no placement").
constexpr int kMpolPreferred = 1;     // MPOL_PREFERRED
constexpr unsigned kMpolMfMove = 2;   // MPOL_MF_MOVE

}  // namespace

int NumaNodeCount(const std::string& sysfs_dir) {
  DIR* d = opendir(sysfs_dir.c_str());
  if (d == nullptr) return 1;
  int nodes = 0;
  while (dirent* e = readdir(d)) {
    const char* n = e->d_name;
    if (strncmp(n, "node", 4) != 0 || n[4] == '\0') continue;
    bool digits = true;
    for (const char* p = n + 4; *p != '\0'; ++p) {
      if (!isdigit(static_cast<unsigned char>(*p))) {
        digits = false;
        break;
      }
    }
    if (digits) ++nodes;
  }
  closedir(d);
  return nodes > 0 ? nodes : 1;
}

// Single-producer/single-consumer byte ring. head/tail are free-running
// byte cursors (never wrapped); the data offset is cursor % ring_bytes.
// The producer's release-store of head (and the consumer's acquire-load)
// carries the happens-before for the bytes it covers; symmetrically tail
// hands regions back to the producer for reuse.
struct alignas(64) ShmRing {
  std::atomic<uint64_t> head;       // producer cursor  // atomic: release-publish
  char pad0[64 - sizeof(std::atomic<uint64_t>)];
  std::atomic<uint64_t> tail;       // consumer cursor  // atomic: release-publish
  char pad1[64 - sizeof(std::atomic<uint64_t>)];
  std::atomic<uint32_t> head_seq;   // futex word: bumped on head advance  // atomic: seqcst(futex doorbell protocol, see fences below)
  std::atomic<uint32_t> head_waiters;  // atomic: seqcst(futex doorbell protocol)
  char pad2[64 - 2 * sizeof(std::atomic<uint32_t>)];
  std::atomic<uint32_t> tail_seq;   // futex word: bumped on tail advance  // atomic: seqcst(futex doorbell protocol, see fences below)
  std::atomic<uint32_t> tail_waiters;  // atomic: seqcst(futex doorbell protocol)
  char pad3[64 - 2 * sizeof(std::atomic<uint32_t>)];
};

struct ShmTransport::Segment {
  uint32_t magic;
  std::atomic<uint32_t> ready;    // creator sets once initialized  // atomic: release-publish
  std::atomic<uint32_t> aborted;  // either side sets on shutdown/error  // atomic: acquire-read
  uint32_t reserved;
  uint64_t ring_bytes;
  ShmRing rings[2];  // [0]: creator -> opener, [1]: opener -> creator
  // Data areas follow: ring 0 bytes, then ring 1 bytes.
  uint8_t* data(int ring) {
    return reinterpret_cast<uint8_t*>(this + 1) +
           static_cast<size_t>(ring) * ring_bytes;
  }
};

ShmTransport::ShmTransport(std::string name, Segment* seg, size_t map_bytes,
                           bool creator)
    : name_(std::move(name)),
      seg_(seg),
      map_bytes_(map_bytes),
      ring_bytes_(seg->ring_bytes),
      creator_(creator),
      out_ring_(creator ? 0 : 1) {
  out_data_ = seg_->data(out_ring_);
  in_data_ = seg_->data(1 - out_ring_);
}

std::unique_ptr<ShmTransport> ShmTransport::Create(const std::string& name,
                                                   size_t ring_bytes) {
  if (ring_bytes == 0) ring_bytes = kDefaultShmRingBytes;
  // 64-byte-multiple capacity keeps the wrap point element-aligned for
  // every wire dtype the in-place view consumer hands out.
  ring_bytes = (ring_bytes + 63) & ~static_cast<size_t>(63);
  int fd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0 && errno == EEXIST) {
    // Stale segment from a crashed prior job that happened to reuse our
    // ports: reclaim the name.
    shm_unlink(name.c_str());
    fd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  }
  if (fd < 0) return nullptr;
  size_t map_bytes = sizeof(Segment) + 2 * ring_bytes;
  if (ftruncate(fd, static_cast<off_t>(map_bytes)) != 0) {
    close(fd);
    shm_unlink(name.c_str());
    return nullptr;
  }
  void* mem = mmap(nullptr, map_bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name.c_str());
    return nullptr;
  }
  auto* seg = new (mem) Segment();
  for (ShmRing& r : seg->rings) {
    r.head.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init; ready.store(release) below publishes
    r.tail.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
    r.head_seq.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
    r.head_waiters.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
    r.tail_seq.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
    r.tail_waiters.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
  }
  seg->aborted.store(0, std::memory_order_relaxed);  // atomic-ok: pre-publication init
  seg->ring_bytes = ring_bytes;
  seg->magic = kMagic;
  seg->ready.store(1, std::memory_order_release);
  return std::unique_ptr<ShmTransport>(
      new ShmTransport(name, seg, map_bytes, /*creator=*/true));
}

std::unique_ptr<ShmTransport> ShmTransport::Open(const std::string& name,
                                                 int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (true) {
    int fd = shm_open(name.c_str(), O_RDWR, 0600);
    if (fd >= 0) {
      struct stat st;
      if (fstat(fd, &st) == 0 &&
          st.st_size >= static_cast<off_t>(sizeof(Segment))) {
        size_t map_bytes = static_cast<size_t>(st.st_size);
        void* mem = mmap(nullptr, map_bytes, PROT_READ | PROT_WRITE,
                         MAP_SHARED, fd, 0);
        close(fd);
        if (mem == MAP_FAILED) return nullptr;
        auto* seg = static_cast<Segment*>(mem);
        while (!(seg->magic == kMagic &&
                 seg->ready.load(std::memory_order_acquire) == 1)) {
          if (std::chrono::steady_clock::now() >= deadline) {
            munmap(mem, map_bytes);
            return nullptr;
          }
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
        }
        if (sizeof(Segment) + 2 * seg->ring_bytes > map_bytes) {
          munmap(mem, map_bytes);
          return nullptr;
        }
        return std::unique_ptr<ShmTransport>(
            new ShmTransport(name, seg, map_bytes, /*creator=*/false));
      }
      close(fd);
    }
    if (std::chrono::steady_clock::now() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
}

ShmTransport::~ShmTransport() {
  if (seg_ != nullptr) {
    // Release any peer still blocked on our rings, unless the close was
    // agreed (every peer is past its last op).
    if (!clean_close_) Abort();
    if (creator_) Unlink();
    munmap(seg_, map_bytes_);
    seg_ = nullptr;
  }
}

void ShmTransport::Abort() {
  if (seg_ == nullptr) return;
  seg_->aborted.store(1, std::memory_order_release);
  for (ShmRing& r : seg_->rings) {
    r.head_seq.fetch_add(1);  // seq_cst: futex doorbell, pairs with waiters' seq_cst re-check
    r.tail_seq.fetch_add(1);
    FutexWake(&r.head_seq);
    FutexWake(&r.tail_seq);
  }
}

void ShmTransport::Unlink() {
  if (!unlinked_) {
    unlinked_ = true;
    shm_unlink(name_.c_str());  // ENOENT is fine (already gone)
  }
}

bool ShmTransport::ApplyNumaPolicy(ShmNumaMode mode) {
  if (mode == ShmNumaMode::OFF || seg_ == nullptr) return false;
  if (mode == ShmNumaMode::AUTO && NumaNodeCount() <= 1) {
    return false;  // single-node host: placement is moot
  }
  unsigned cpu = 0, node = 0;
  if (syscall(SYS_getcpu, &cpu, &node, nullptr) != 0) return false;
  // Consumer-local placement: pin the INBOUND ring's data pages to the node
  // this side runs on. Our reads (the in-place view consumer and TryRecv)
  // go node-local; the peer's producer writes cross the interconnect once,
  // through the store buffer — the cheap direction.
  unsigned long mask[16];
  memset(mask, 0, sizeof(mask));
  const unsigned bits = 8 * sizeof(unsigned long);
  if (node >= 16 * bits) return false;
  mask[node / bits] = 1ul << (node % bits);
  const long page = sysconf(_SC_PAGESIZE);
  if (page <= 0) return false;
  uintptr_t start = reinterpret_cast<uintptr_t>(in_data_);
  uintptr_t end = start + ring_bytes_;
  uintptr_t a_start =
      (start + static_cast<uintptr_t>(page) - 1) &
      ~(static_cast<uintptr_t>(page) - 1);
  uintptr_t a_end = end & ~(static_cast<uintptr_t>(page) - 1);
  if (a_end <= a_start) return false;  // ring smaller than a page
  // MPOL_PREFERRED (never ENOMEMs under pressure, unlike a strict bind) +
  // MF_MOVE to migrate pages the creator's init already first-touched.
  long rc = syscall(SYS_mbind, a_start, a_end - a_start, kMpolPreferred,
                    mask, 16 * bits + 1, kMpolMfMove);
  return rc == 0;
}

int64_t ShmTransport::OccupancyBytes() const {
  if (seg_ == nullptr) return 0;
  int64_t total = 0;
  for (int i = 0; i < 2; ++i) {
    const ShmRing& r = seg_->rings[i];
    const uint64_t head = r.head.load(std::memory_order_relaxed);  // atomic-ok: monitoring snapshot, torn pair tolerated
    const uint64_t tail = r.tail.load(std::memory_order_relaxed);  // atomic-ok: monitoring snapshot, torn pair tolerated
    // Free-running cursors: head >= tail modulo concurrent advance; a
    // transiently inverted read (tail racing past a stale head) clamps to 0
    // rather than wrapping to a huge unsigned spread.
    if (head > tail) total += static_cast<int64_t>(head - tail);
  }
  return total;
}

void ShmTransport::BumpAndWake(std::atomic<uint32_t>* seq) {
  seq->fetch_add(1, std::memory_order_seq_cst);
  FutexWake(seq);
  ++futex_wakes_;
}

void ShmTransport::NotifyHeadAdvance(size_t bytes, bool was_edge) {
  ShmRing& r = seg_->rings[out_ring_];
  if (!coalesce_) {
    // Legacy per-advance doorbell (small ops, HVDTPU_DOORBELL_BATCH=1):
    // the one wake IS the latency path there.
    r.head_seq.fetch_add(1, std::memory_order_seq_cst);
    if (r.head_waiters.load(std::memory_order_seq_cst) != 0) {
      FutexWake(&r.head_seq);
      ++futex_wakes_;
    }
    return;
  }
  // Dekker with the waiter's registration: our head store is already
  // published (release); the fence orders it against the waiter-count load,
  // so either we observe the waiter here or its post-registration re-check
  // observes our head — both-miss is impossible.
  std::atomic_thread_fence(std::memory_order_seq_cst);
  pending_head_bytes_ += bytes;
  const bool waiter =
      r.head_waiters.load(std::memory_order_seq_cst) != 0;
  if (pending_head_bytes_ >= static_cast<size_t>(doorbell_batch_) ||
      (waiter && was_edge)) {
    pending_head_bytes_ = 0;
    if (waiter) BumpAndWake(&r.head_seq);
  }
}

void ShmTransport::NotifyTailAdvance(size_t bytes, bool was_edge) {
  ShmRing& r = seg_->rings[1 - out_ring_];
  if (!coalesce_) {
    r.tail_seq.fetch_add(1, std::memory_order_seq_cst);
    if (r.tail_waiters.load(std::memory_order_seq_cst) != 0) {
      FutexWake(&r.tail_seq);
      ++futex_wakes_;
    }
    return;
  }
  std::atomic_thread_fence(std::memory_order_seq_cst);
  pending_tail_bytes_ += bytes;
  const bool waiter =
      r.tail_waiters.load(std::memory_order_seq_cst) != 0;
  if (pending_tail_bytes_ >= static_cast<size_t>(doorbell_batch_) ||
      (waiter && was_edge)) {
    pending_tail_bytes_ = 0;
    if (waiter) BumpAndWake(&r.tail_seq);
  }
}

void ShmTransport::FlushDoorbells() {
  // Ring every deferred bell: called before this side blocks (only the
  // peer's progress can wake us, so it must not be left sleeping on our
  // debt) and at op boundaries (the last chunks of an op may be under the
  // batch threshold forever).
  if (pending_head_bytes_ > 0) {
    pending_head_bytes_ = 0;
    ShmRing& r = seg_->rings[out_ring_];
    std::atomic_thread_fence(std::memory_order_seq_cst);
    if (r.head_waiters.load(std::memory_order_seq_cst) != 0) {
      BumpAndWake(&r.head_seq);
    }
  }
  if (pending_tail_bytes_ > 0) {
    pending_tail_bytes_ = 0;
    ShmRing& r = seg_->rings[1 - out_ring_];
    std::atomic_thread_fence(std::memory_order_seq_cst);
    if (r.tail_waiters.load(std::memory_order_seq_cst) != 0) {
      BumpAndWake(&r.tail_seq);
    }
  }
}

size_t ShmTransport::TrySend(const uint8_t* buf, size_t len) {
  ShmRing& r = seg_->rings[out_ring_];
  uint64_t head = r.head.load(std::memory_order_relaxed);  // atomic-ok: sole producer reads its own cursor
  uint64_t tail = r.tail.load(std::memory_order_acquire);
  size_t free_space = ring_bytes_ - static_cast<size_t>(head - tail);
  if (free_space == 0) return 0;
  size_t off = static_cast<size_t>(head % ring_bytes_);
  size_t chunk = std::min({free_space, len, ring_bytes_ - off});
  memcpy(out_data_ + off, buf, chunk);
  r.head.store(head + chunk, std::memory_order_release);
  // Empty->data edge: a consumer can only be asleep if it drained the ring
  // dry, so the chunk that refills it must ring through immediately. The
  // freshest tail tells us whether that drain happened. (Only the
  // coalescing path consults it; the legacy path rings every advance.)
  const bool was_edge =
      coalesce_ && r.tail.load(std::memory_order_seq_cst) == head;  // atomic-ok: Dekker edge-check, pairs with waiter's seq_cst window
  NotifyHeadAdvance(chunk, was_edge);
  return chunk;
}

size_t ShmTransport::TryRecv(uint8_t* buf, size_t len) {
  ShmRing& r = seg_->rings[1 - out_ring_];
  uint64_t tail = r.tail.load(std::memory_order_relaxed);  // atomic-ok: sole consumer reads its own cursor
  uint64_t head = r.head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (avail == 0) return 0;
  size_t off = static_cast<size_t>(tail % ring_bytes_);
  size_t chunk = std::min({avail, len, ring_bytes_ - off});
  memcpy(buf, in_data_ + off, chunk);
  r.tail.store(tail + chunk, std::memory_order_release);
  // Full->space edge: a producer sleeps only against a completely full
  // ring; the drain that opens space must wake it at once.
  const bool was_edge = avail == ring_bytes_;
  NotifyTailAdvance(chunk, was_edge);
  return chunk;
}

size_t ShmTransport::TryConsumeViews(size_t done, size_t len,
                                     size_t view_align,
                                     const SegmentFn& on_segment) {
  ShmRing& r = seg_->rings[1 - out_ring_];
  uint64_t tail = r.tail.load(std::memory_order_relaxed);  // atomic-ok: sole consumer reads its own cursor
  uint64_t head = r.head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (avail == 0) return 0;
  const size_t remaining = len - done;
  size_t align = view_align == 0 ? 1 : view_align;
  if (align > remaining) align = remaining;  // ragged caller tail
  if (align > 16) align = 1;  // staging buffer bound; dtypes are <= 8 bytes
  size_t off = static_cast<size_t>(tail % ring_bytes_);
  size_t run = std::min({avail, remaining, ring_bytes_ - off});
  size_t aligned = run - run % align;
  const bool was_edge = avail == ring_bytes_;
  if (aligned == 0) {
    // The next element straddles the wrap point (run < align while the ring
    // holds >= align bytes) or hasn't fully arrived yet. Assemble exactly
    // one element through a staging buffer once its bytes are all in; the
    // view contract (elem-aligned lengths) holds either way.
    if (avail < align) return 0;  // element incomplete: wait for more bytes
    alignas(16) uint8_t stage[16];
    const size_t first = ring_bytes_ - off;  // bytes before the wrap point
    memcpy(stage, in_data_ + off, first);
    memcpy(stage + first, in_data_, align - first);
    on_segment(stage, done, align);
    r.tail.store(tail + align, std::memory_order_release);
    NotifyTailAdvance(align, was_edge);
    return align;
  }
  const uint8_t* src = in_data_ + off;
  if (align > 1 && reinterpret_cast<uintptr_t>(src) % align != 0) {
    // An earlier odd-sized op (bool/uint8 payload, compressed wire bytes)
    // left the ring cursor off the element grid, so EVERY in-place view of
    // this op would hand the typed reducer a misaligned element — UB the
    // UBSan gate rightly aborts on. Degrade to the earlier behavior for
    // this op: bounce the run through a bounded aligned buffer (one
    // staging copy, exactly the old cost; the aligned common case keeps
    // the zero-copy path).
    constexpr size_t kBounceCap = 256 * 1024;
    if (bounce_.empty()) bounce_.resize(kBounceCap);
    size_t n = std::min(aligned, bounce_.size());
    memcpy(bounce_.data(), src, n);
    on_segment(bounce_.data(), done, n);
    r.tail.store(tail + n, std::memory_order_release);
    NotifyTailAdvance(n, was_edge);
    return n;
  }
  // Zero-copy consumption: the callback reads straight out of the mapped
  // ring; the tail advances only afterwards, so the producer cannot reuse
  // the region mid-view. This removes the staging memcpy entirely — the
  // reduction becomes the only read of the incoming bytes.
  on_segment(src, done, aligned);
  r.tail.store(tail + aligned, std::memory_order_release);
  NotifyTailAdvance(aligned, was_edge);
  return aligned;
}

bool ShmTransport::PeerDead() {
  if (liveness_fd_ < 0) return false;
  pollfd pfd{liveness_fd_, POLLIN, 0};
  if (poll(&pfd, 1, 0) <= 0) return false;
  if ((pfd.revents & (POLLERR | POLLHUP | POLLNVAL)) == 0) {
    // POLLIN on an idle pair socket: EOF or stray bytes — peek to decide.
    char b;
    ssize_t n = recv(liveness_fd_, &b, 1, MSG_PEEK | MSG_DONTWAIT);
    if (n > 0 || (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))) {
      return false;
    }
  }
  peer_died_ = true;
  if (ctl_ != nullptr) ctl_->MarkPeerFailed();  // break the WHOLE plane
  Abort();  // wake our own other-direction waiters too
  return true;
}

bool ShmTransport::AbortedNow() const {
  return seg_->aborted.load(std::memory_order_acquire) != 0 ||
         (ctl_ != nullptr && ctl_->is_aborted());
}

int ShmTransport::WaitSliceMs() const {
  if (ctl_ == nullptr) return kWaitSliceMs;
  int64_t s = ctl_->detect_slice_ms;
  return static_cast<int>(s < 1 ? 1 : (s > kWaitSliceMs ? kWaitSliceMs : s));
}

bool ShmTransport::DeadlineExpired(double last_progress) {
  if (ctl_ == nullptr || ctl_->read_deadline_secs <= 0) return false;
  if (MonoSeconds() - last_progress <= ctl_->read_deadline_secs) return false;
  // Peer alive (no EOF on the liveness socket) but the ring hasn't moved
  // past the deadline: a hung peer. Fail the plane instead of waiting out
  // the coordinator's (possibly never-running) stall inspector.
  peer_died_ = true;
  ctl_->MarkPeerFailed();
  Abort();
  return true;
}

void ShmTransport::WaitOutboundSpace() {
  // Sampling-profiler phase tag: spin or futex-park, this whole function is
  // blocked-on-peer time (the WAIT bucket the perf attribution measures).
  ProfPhaseScope prof_wait(PerfPhase::WAIT);
  ShmRing& r = seg_->rings[out_ring_];
  uint64_t head = r.head.load(std::memory_order_relaxed);  // atomic-ok: sole producer reads its own cursor
  for (int i = 0, spins = SpinIters(); i < spins; ++i) {
    if (r.tail.load(std::memory_order_acquire) + ring_bytes_ != head ||
        AbortedNow()) {
      return;
    }
  }
  if (PeerDead()) return;
  uint32_t seq = r.tail_seq.load(std::memory_order_seq_cst);
  r.tail_waiters.fetch_add(1, std::memory_order_seq_cst);
  if (r.tail.load(std::memory_order_seq_cst) + ring_bytes_ == head &&  // atomic-ok: Dekker re-check between waiter-count bump and futex park
      !AbortedNow()) {
    // Peer-wait accounting (tracing layer): time parked on the futex is
    // time the op stalled on the consumer, not ring bandwidth.
    const double wait_t0 = MonoSeconds();
    FutexWait(&r.tail_seq, seq, WaitSliceMs());
    if (ctl_ != nullptr) {
      ctl_->AddWaitUs(static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
    }
  }
  r.tail_waiters.fetch_sub(1, std::memory_order_seq_cst);
}

void ShmTransport::WaitInboundData() {
  ProfPhaseScope prof_wait(PerfPhase::WAIT);
  ShmRing& r = seg_->rings[1 - out_ring_];
  // Wait for the head to move past its CURRENT position (not merely past
  // the tail): the in-place view consumer can be blocked on the back half
  // of a wrap-straddled element while the ring is technically non-empty.
  uint64_t observed = r.head.load(std::memory_order_acquire);
  uint64_t tail = r.tail.load(std::memory_order_relaxed);  // atomic-ok: sole consumer reads its own cursor
  if (observed != tail) {
    // Bytes are available; only a partial element can be waiting. The
    // producer is mid-write — spin briefly, skip the futex (its next
    // store lands in a bounded number of its own steps).
    for (int i = 0, spins = SpinIters(); i < spins; ++i) {
      if (r.head.load(std::memory_order_acquire) != observed ||
          AbortedNow()) {
        return;
      }
    }
    if (PeerDead()) return;
    std::this_thread::yield();
    return;
  }
  for (int i = 0, spins = SpinIters(); i < spins; ++i) {
    if (r.head.load(std::memory_order_acquire) != observed ||
        AbortedNow()) {
      return;
    }
  }
  if (PeerDead()) return;
  uint32_t seq = r.head_seq.load(std::memory_order_seq_cst);
  r.head_waiters.fetch_add(1, std::memory_order_seq_cst);
  if (r.head.load(std::memory_order_seq_cst) == observed &&  // atomic-ok: Dekker re-check between waiter-count bump and futex park
      !AbortedNow()) {
    // Peer-wait accounting (tracing layer): parked waiting for the
    // producer to publish bytes — the shm analog of a blocked recv().
    const double wait_t0 = MonoSeconds();
    FutexWait(&r.head_seq, seq, WaitSliceMs());
    if (ctl_ != nullptr) {
      ctl_->AddWaitUs(static_cast<int64_t>((MonoSeconds() - wait_t0) * 1e6));
    }
  }
  r.head_waiters.fetch_sub(1, std::memory_order_seq_cst);
}

int ShmTransport::Send(const void* buf, size_t len) {
  BeginOp(len);
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  size_t done = 0;
  double last_progress = MonoSeconds();
  while (done < len) {
    if (AbortedNow()) {
      FlushDoorbells();
      return -1;
    }
    size_t n = TrySend(p + done, len - done);
    if (n == 0) {
      if (DeadlineExpired(last_progress)) {
        FlushDoorbells();
        return -1;
      }
      FlushDoorbells();  // our wake depends on the peer: pay the debt first
      WaitOutboundSpace();
    } else {
      done += n;
      last_progress = MonoSeconds();
    }
  }
  FlushDoorbells();
  return 0;
}

int ShmTransport::Recv(void* buf, size_t len) {
  return RecvSegmented(buf, len, 0, 1, nullptr);
}

int ShmTransport::RecvSegmented(void* buf, size_t len, size_t segment_bytes,
                                size_t view_align,
                                const SegmentFn& on_segment) {
  (void)segment_bytes;  // views are ring-run-granular, not segment-sized
  BeginOp(len);
  uint8_t* p = static_cast<uint8_t*>(buf);
  size_t done = 0;
  double last_progress = MonoSeconds();
  while (done < len) {
    if (AbortedNow()) {
      FlushDoorbells();
      return -1;
    }
    size_t n = on_segment
                   ? TryConsumeViews(done, len, view_align, on_segment)
                   : TryRecv(p + done, len - done);
    if (n == 0) {
      if (DeadlineExpired(last_progress)) {
        FlushDoorbells();
        return -1;
      }
      FlushDoorbells();
      WaitInboundData();
      continue;
    }
    done += n;
    last_progress = MonoSeconds();
  }
  FlushDoorbells();
  return 0;
}

int ShmTransport::DuplexPump(ShmTransport* tx, const void* send_buf,
                             size_t send_bytes, ShmTransport* rx,
                             void* recv_buf, size_t recv_bytes,
                             size_t view_align, const SegmentFn& on_segment) {
  tx->BeginOp(send_bytes);
  rx->BeginOp(recv_bytes);
  const uint8_t* sp = static_cast<const uint8_t*>(send_buf);
  uint8_t* rp = static_cast<uint8_t*>(recv_buf);
  size_t sent = 0, rcvd = 0;
  double last_progress = MonoSeconds();
  while (sent < send_bytes || rcvd < recv_bytes) {
    if (tx->AbortedNow() || rx->AbortedNow()) {
      tx->FlushDoorbells();
      rx->FlushDoorbells();
      return -1;
    }
    bool progress = false;
    if (sent < send_bytes) {
      size_t n = tx->TrySend(sp + sent, send_bytes - sent);
      sent += n;
      progress |= n != 0;
    }
    if (rcvd < recv_bytes) {
      size_t n = on_segment ? rx->TryConsumeViews(rcvd, recv_bytes,
                                                  view_align, on_segment)
                            : rx->TryRecv(rp + rcvd, recv_bytes - rcvd);
      rcvd += n;
      progress |= n != 0;
    }
    if (!progress) {
      // The lane we are about to park on is the one whose peer owes us
      // progress — charge the no-progress deadline (and therefore the
      // failure attribution) to IT, not to its healthy sibling.
      ShmTransport* gate = rcvd < recv_bytes ? rx : tx;
      if (gate->DeadlineExpired(last_progress)) {
        tx->FlushDoorbells();
        rx->FlushDoorbells();
        return -1;
      }
      // Pay both lanes' doorbell debts (our wake depends on two different
      // peers now), then park on whichever cursor unblocks us. The ring
      // schedule is matched hop-by-hop, so inbound data and outbound
      // space open together; the futex timeout slice bounds any stagger.
      tx->FlushDoorbells();
      rx->FlushDoorbells();
      if (rcvd < recv_bytes) {
        rx->WaitInboundData();
      } else {
        tx->WaitOutboundSpace();
      }
    } else {
      last_progress = MonoSeconds();
    }
  }
  tx->FlushDoorbells();
  rx->FlushDoorbells();
  return 0;
}

int ShmTransport::SendRecv(const void* send_buf, size_t send_bytes,
                           void* recv_buf, size_t recv_bytes,
                           size_t segment_bytes, size_t view_align,
                           const SegmentFn& on_segment) {
  (void)segment_bytes;  // views are ring-run-granular, not segment-sized
  BeginOp(send_bytes > recv_bytes ? send_bytes : recv_bytes);
  const uint8_t* sp = static_cast<const uint8_t*>(send_buf);
  uint8_t* rp = static_cast<uint8_t*>(recv_buf);
  size_t sent = 0, rcvd = 0;
  double last_progress = MonoSeconds();
  while (sent < send_bytes || rcvd < recv_bytes) {
    if (AbortedNow()) {
      FlushDoorbells();
      return -1;
    }
    bool progress = false;
    if (sent < send_bytes) {
      size_t n = TrySend(sp + sent, send_bytes - sent);
      sent += n;
      progress |= n != 0;
    }
    if (rcvd < recv_bytes) {
      size_t n =
          on_segment
              ? TryConsumeViews(rcvd, recv_bytes, view_align, on_segment)
              : TryRecv(rp + rcvd, recv_bytes - rcvd);
      rcvd += n;
      progress |= n != 0;
    }
    if (!progress) {
      if (DeadlineExpired(last_progress)) {
        FlushDoorbells();
        return -1;
      }
      // Both directions stuck: pay any deferred doorbells (the peer's
      // progress is our only wake source), then park on whichever cursor
      // unblocks us (inbound data if we still expect bytes, else outbound
      // space). The peer's pump advances the other direction independently.
      FlushDoorbells();
      if (rcvd < recv_bytes) {
        WaitInboundData();
      } else {
        WaitOutboundSpace();
      }
    } else {
      last_progress = MonoSeconds();
    }
  }
  FlushDoorbells();
  return 0;
}

}  // namespace hvdtpu
