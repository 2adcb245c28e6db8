#include "data_plane.h"

#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <csignal>
#include <cstdio>
#include <cstring>
#include <thread>

#include "profiler.h"
#include "shm_transport.h"
#include "socket_util.h"
#include "timeline.h"

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace hvdtpu {

namespace {

// --- fp16 / bf16 conversion (reference: horovod/common/half.{h,cc}) ---------

inline float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {
      // subnormal: normalize
      exp = 127 - 15 + 1;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3ffu;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  memcpy(&f, &bits, sizeof(f));
  return f;
}

inline uint16_t FloatToHalf(float f) {
  uint32_t bits;
  memcpy(&bits, &f, sizeof(bits));
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xff) - 127 + 15;
  uint32_t mant = bits & 0x7fffffu;
  if (exp >= 0x1f) {
    // NaN must stay NaN (nonzero mantissa); inf and overflow saturate.
    if (((bits >> 23) & 0xffu) == 0xffu && mant != 0)
      return static_cast<uint16_t>(sign | 0x7e00u);
    return static_cast<uint16_t>(sign | 0x7c00u);
  }
  if (exp <= 0) {
    // Subnormal result. Round-to-nearest-EVEN on the dropped bits (the old
    // round-half-up biased every exact tie upward, e.g. 2^-25 -> 2^-24
    // instead of 0), matching IEEE 754 and the F16C hardware path.
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint16_t h = static_cast<uint16_t>(sign | (mant >> shift));
    uint32_t rem = mant & ((1u << shift) - 1u);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (h & 1u))) h++;
    return h;
  }
  // Normal result: round-to-nearest-even on the 13 dropped mantissa bits.
  // A mantissa carry correctly rolls into the exponent (and 65520+ to inf).
  uint16_t h = static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) h++;
  return h;
}

inline float Bf16ToFloat(uint16_t h) {
  uint32_t bits = static_cast<uint32_t>(h) << 16;
  float f;
  memcpy(&f, &bits, sizeof(f));
  return f;
}

inline uint16_t FloatToBf16(float f) {
  uint32_t bits;
  memcpy(&bits, &f, sizeof(bits));
  // NaN first: the rounding add below would carry its mantissa into the
  // exponent (NaN -> inf) or even the sign bit (0x7fffffff -> -0.0).
  if ((bits & 0x7fffffffu) > 0x7f800000u)
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);  // quiet NaN
  // round-to-nearest-even
  uint32_t rounded = bits + 0x7fffu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>(rounded >> 16);
}

// --- reduction kernels ------------------------------------------------------
// The op is resolved ONCE per buffer (functor template parameter), never per
// element, and the inner loops carry __restrict__ so -O3 can vectorize them.

struct SumOp {
  template <typename T> T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  template <typename T> T operator()(T a, T b) const { return std::min(a, b); }
};
struct MaxOp {
  template <typename T> T operator()(T a, T b) const { return std::max(a, b); }
};
struct ProdOp {
  template <typename T> T operator()(T a, T b) const { return a * b; }
};

template <typename T, typename Op>
void ReduceLoop(T* __restrict__ dst, const T* __restrict__ src, int64_t count,
                Op op) {
  for (int64_t i = 0; i < count; ++i) dst[i] = op(dst[i], src[i]);
}

template <typename T>
void ReduceTyped(T* dst, const T* src, int64_t count, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
      ReduceLoop(dst, src, count, SumOp{});
      break;
    case ReduceOp::MIN:
      ReduceLoop(dst, src, count, MinOp{});
      break;
    case ReduceOp::MAX:
      ReduceLoop(dst, src, count, MaxOp{});
      break;
    case ReduceOp::PRODUCT:
      ReduceLoop(dst, src, count, ProdOp{});
      break;
  }
}

#if defined(__x86_64__)
// Fused fp16 convert+add+convert, 8 lanes per step (F16C). The hardware
// conversions are full IEEE round-to-nearest-even including subnormals, so
// this is bit-identical to the scalar HalfToFloat/FloatToHalf path for
// numeric values (NaNs stay NaN but may carry a different payload).
__attribute__((target("avx2,f16c")))
void HalfSumF16C(uint16_t* __restrict__ dst, const uint16_t* __restrict__ src,
                 int64_t count) {
  int64_t i = 0;
  for (; i + 8 <= count; i += 8) {
    __m256 a = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(dst + i)));
    __m256 b = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm256_cvtps_ph(_mm256_add_ps(a, b),
                                     _MM_FROUND_TO_NEAREST_INT));
  }
  for (; i < count; ++i) {
    dst[i] = FloatToHalf(HalfToFloat(dst[i]) + HalfToFloat(src[i]));
  }
}

// Fused bf16 convert+add+convert, 8 lanes per step: widen by shift, add as
// f32, round-to-nearest-even back by integer arithmetic (same formula as
// the scalar FloatToBf16, including the NaN-quieting blend).
__attribute__((target("avx2")))
void Bf16SumAvx2(uint16_t* __restrict__ dst, const uint16_t* __restrict__ src,
                 int64_t count) {
  const __m256i vexpmask = _mm256_set1_epi32(0x7fffffff);
  const __m256i vinf = _mm256_set1_epi32(0x7f800000);
  const __m256i vbias = _mm256_set1_epi32(0x7fff);
  const __m256i vone = _mm256_set1_epi32(1);
  const __m256i vquiet = _mm256_set1_epi32(0x0040);
  int64_t i = 0;
  for (; i + 8 <= count; i += 8) {
    __m256i a = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(dst + i))), 16);
    __m256i b = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i))), 16);
    __m256i s = _mm256_castps_si256(_mm256_add_ps(_mm256_castsi256_ps(a),
                                                  _mm256_castsi256_ps(b)));
    // round-to-nearest-even: bits + 0x7fff + ((bits >> 16) & 1)
    __m256i rounded = _mm256_srli_epi32(
        _mm256_add_epi32(_mm256_add_epi32(s, vbias),
                         _mm256_and_si256(_mm256_srli_epi32(s, 16), vone)),
        16);
    // NaN sum (|bits| > inf): quiet NaN instead of letting the rounding add
    // carry the mantissa into the exponent/sign.
    __m256i nan_mask = _mm256_cmpgt_epi32(_mm256_and_si256(s, vexpmask), vinf);
    __m256i quieted = _mm256_or_si256(_mm256_srli_epi32(s, 16), vquiet);
    __m256i out32 = _mm256_blendv_epi8(rounded, quieted, nan_mask);
    // pack the low words of the 8 lanes back to 8 x u16 (packus after
    // clamping is safe: values are already <= 0xffff)
    __m256i packed = _mm256_packus_epi32(out32, out32);
    __m128i lo = _mm256_castsi256_si128(packed);
    __m128i hi = _mm256_extracti128_si256(packed, 1);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm_unpacklo_epi64(lo, hi));
  }
  for (; i < count; ++i) {
    dst[i] = FloatToBf16(Bf16ToFloat(dst[i]) + Bf16ToFloat(src[i]));
  }
}

bool HaveF16C() {
  // gcc 10's __builtin_cpu_supports has no "f16c"; read CPUID leaf 1 ECX
  // bit 29 directly.
  static const bool ok = [] {
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    return (ecx & (1u << 29)) != 0 && __builtin_cpu_supports("avx2") != 0;
  }();
  return ok;
}

bool HaveAvx2() {
  static const bool ok = __builtin_cpu_supports("avx2");
  return ok;
}
#endif  // __x86_64__

// Half-precision buffers reduce through float in ONE pass: convert, combine,
// convert back per element (vectorized 8-wide for the SUM hot path), instead
// of a per-element op dispatch.
template <typename Op>
void ReduceHalfLoop(uint16_t* __restrict__ dst, const uint16_t* __restrict__ src,
                    int64_t count, Op op) {
  for (int64_t i = 0; i < count; ++i) {
    dst[i] = FloatToHalf(op(HalfToFloat(dst[i]), HalfToFloat(src[i])));
  }
}

template <typename Op>
void ReduceBf16Loop(uint16_t* __restrict__ dst, const uint16_t* __restrict__ src,
                    int64_t count, Op op) {
  for (int64_t i = 0; i < count; ++i) {
    dst[i] = FloatToBf16(op(Bf16ToFloat(dst[i]), Bf16ToFloat(src[i])));
  }
}

void ReduceHalf(uint16_t* dst, const uint16_t* src, int64_t count,
                ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
#if defined(__x86_64__)
      if (HaveF16C()) {
        HalfSumF16C(dst, src, count);
        return;
      }
#endif
      ReduceHalfLoop(dst, src, count, SumOp{});
      break;
    case ReduceOp::MIN:
      ReduceHalfLoop(dst, src, count, MinOp{});
      break;
    case ReduceOp::MAX:
      ReduceHalfLoop(dst, src, count, MaxOp{});
      break;
    case ReduceOp::PRODUCT:
      ReduceHalfLoop(dst, src, count, ProdOp{});
      break;
  }
}

void ReduceBf16(uint16_t* dst, const uint16_t* src, int64_t count,
                ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
#if defined(__x86_64__)
      if (HaveAvx2()) {
        Bf16SumAvx2(dst, src, count);
        return;
      }
#endif
      ReduceBf16Loop(dst, src, count, SumOp{});
      break;
    case ReduceOp::MIN:
      ReduceBf16Loop(dst, src, count, MinOp{});
      break;
    case ReduceOp::MAX:
      ReduceBf16Loop(dst, src, count, MaxOp{});
      break;
    case ReduceOp::PRODUCT:
      ReduceBf16Loop(dst, src, count, ProdOp{});
      break;
  }
}

}  // namespace

float HalfToFloatPublic(uint16_t h) { return HalfToFloat(h); }
uint16_t FloatToHalfPublic(float f) { return FloatToHalf(f); }
float Bf16ToFloatPublic(uint16_t h) { return Bf16ToFloat(h); }
uint16_t FloatToBf16Public(float f) { return FloatToBf16(f); }

void ReduceBuffer(void* dst, const void* src, int64_t count, DataType dtype,
                  ReduceOp op) {
  switch (dtype) {
    case DataType::FLOAT32:
      ReduceTyped(static_cast<float*>(dst), static_cast<const float*>(src),
                  count, op);
      break;
    case DataType::FLOAT64:
      ReduceTyped(static_cast<double*>(dst), static_cast<const double*>(src),
                  count, op);
      break;
    case DataType::INT32:
      ReduceTyped(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src),
                  count, op);
      break;
    case DataType::INT64:
      ReduceTyped(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src),
                  count, op);
      break;
    case DataType::UINT8:
      ReduceTyped(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src),
                  count, op);
      break;
    case DataType::INT8:
      ReduceTyped(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src),
                  count, op);
      break;
    case DataType::BOOL: {
      uint8_t* d = static_cast<uint8_t*>(dst);
      const uint8_t* s = static_cast<const uint8_t*>(src);
      // bool: SUM/MAX == OR, MIN/PRODUCT == AND
      if (op == ReduceOp::MIN || op == ReduceOp::PRODUCT) {
        for (int64_t i = 0; i < count; ++i) d[i] = d[i] && s[i];
      } else {
        for (int64_t i = 0; i < count; ++i) d[i] = d[i] || s[i];
      }
      break;
    }
    case DataType::FLOAT16:
      ReduceHalf(static_cast<uint16_t*>(dst),
                 static_cast<const uint16_t*>(src), count, op);
      break;
    case DataType::BFLOAT16:
      ReduceBf16(static_cast<uint16_t*>(dst),
                 static_cast<const uint16_t*>(src), count, op);
      break;
  }
}

DataPlane::DataPlane(int rank, int size)
    : rank_(rank), size_(size), fds_(size, -1), transports_(size) {
  world_group_.resize(size);
  for (int r = 0; r < size; ++r) world_group_[r] = r;
  local_group_ = {rank};
  leaders_ = {0};
  own_metrics_.reset(new Metrics());
  set_metrics(own_metrics_.get());
}

void DataPlane::set_metrics(Metrics* m) {
  metrics_ = m;
  raw_bytes_total_ = metrics_->GetCounter(
      "hvdtpu_allreduce_raw_bytes_total",
      "Allreduce payload bytes this rank would have sent uncompressed");
  wire_bytes_total_ = metrics_->GetCounter(
      "hvdtpu_allreduce_wire_bytes_total",
      "Allreduce payload bytes this rank actually sent on the wire");
  zc_sends_total_ = metrics_->GetCounter(
      "hvdtpu_zerocopy_sends_total",
      "Large TCP sends completed through the zero-copy lane "
      "(MSG_ZEROCOPY/io_uring), completions drained");
  zc_fallbacks_total_ = metrics_->GetCounter(
      "hvdtpu_zerocopy_fallbacks_total",
      "Large TCP sends that wanted the zero-copy lane but took the copy "
      "path (failed probe, kernel-copied auto-disable, runtime decline)");
  zc_sends_published_ = 0;
  zc_fallbacks_published_ = 0;
}

void DataPlane::PublishZeroCopyCounters() {
  if (tcp_lanes_.empty()) return;
  int64_t sends = 0, fallbacks = 0;
  for (TcpTransport* t : tcp_lanes_) {
    sends += t->zerocopy_sends();
    fallbacks += t->zerocopy_fallbacks();
  }
  if (sends > zc_sends_published_) {
    zc_sends_total_->Add(sends - zc_sends_published_);
    zc_sends_published_ = sends;
  }
  if (fallbacks > zc_fallbacks_published_) {
    zc_fallbacks_total_->Add(fallbacks - zc_fallbacks_published_);
    zc_fallbacks_published_ = fallbacks;
  }
}

DataPlane::~DataPlane() { Shutdown(); }

Status DataPlane::Listen() {
  listen_fd_ = TcpListen(0, size_ + 4, &port_);
  if (listen_fd_ < 0) {
    return Status::Error(StatusCode::ABORTED, "data plane: listen failed");
  }
  return Status::OK();
}

Status DataPlane::Connect(const std::vector<PeerAddr>& peers) {
  // Deterministic, deadlock-free establishment: connect to lower ranks (they
  // are already listening), accept from higher ranks. Rank is identified by a
  // 4-byte hello.
  for (int peer = 0; peer < rank_; ++peer) {
    int fd = TcpConnectRetry(peers[peer].host, peers[peer].port,
                             static_cast<int>(formup_timeout_ms_));
    if (fd < 0) {
      return Status::Error(StatusCode::ABORTED,
                           "data plane: connect to rank " +
                               std::to_string(peer) + " failed");
    }
    int32_t me = rank_;
    if (SendAll(fd, &me, sizeof(me), &io_ctl_) != 0) {
      CloseFd(fd);
      return Status::Error(StatusCode::ABORTED, "data plane: hello failed");
    }
    fds_[peer] = fd;
  }
  for (int expected = 0; expected < size_ - rank_ - 1; ++expected) {
    // Deadline-bounded: a higher rank that died between rendezvous and its
    // data-plane connect must not wedge form-up forever.
    int fd = TcpAcceptTimeout(listen_fd_,
                              static_cast<int>(formup_timeout_ms_));
    if (fd < 0) {
      return Status::Error(StatusCode::ABORTED,
                           "data plane: accept failed (peer missing within "
                           "the form-up timeout?)");
    }
    // Interruptible: a peer whose route blackholes between its connect and
    // its 4-byte hello must trip the no-progress deadline, not wedge
    // form-up forever (HVDTPU_FORMUP_TIMEOUT_SECONDS bounds the accept
    // above; the IoControl deadline bounds the read here).
    int32_t who = -1;
    if (RecvAll(fd, &who, sizeof(who), &io_ctl_) != 0 ||
        who <= rank_ || who >= size_) {
      CloseFd(fd);
      return Status::Error(StatusCode::ABORTED, "data plane: bad hello");
    }
    fds_[who] = fd;
  }

  // Size the inline (send-then-recv, no sender thread) SendRecv fast path
  // from the ACTUAL kernel buffer sizes: a payload at most a quarter of the
  // smallest send/receive buffer on the mesh can never wedge even when both
  // peers send first. Hosts tuned down to the 4 KB tcp_wmem minimum simply
  // get a (correct) tiny threshold instead of a deadlock.
  int64_t lim = 32 * 1024;
  for (int fd : fds_) {
    if (fd < 0) continue;
    int val = 0;
    socklen_t len = sizeof(val);
    if (getsockopt(fd, SOL_SOCKET, SO_SNDBUF, &val, &len) == 0) {
      lim = std::min(lim, static_cast<int64_t>(val) / 4);
    }
    len = sizeof(val);
    if (getsockopt(fd, SOL_SOCKET, SO_RCVBUF, &val, &len) == 0) {
      lim = std::min(lim, static_cast<int64_t>(val) / 4);
    }
  }
  inline_max_bytes_ = std::max<int64_t>(lim, 0);

  // Host topology from the peer table: ranks advertising the same host
  // string form a local group; the lowest rank per host is its leader.
  // (Two names for one machine — "localhost" vs "127.0.0.1" — read as two
  // hosts; the launcher advertises one canonical name per host.)
  local_group_.clear();
  leaders_.clear();
  {
    std::vector<std::string> seen;
    for (int r = 0; r < size_; ++r) {
      if (peers[r].host == peers[rank_].host) local_group_.push_back(r);
      if (std::find(seen.begin(), seen.end(), peers[r].host) == seen.end()) {
        seen.push_back(peers[r].host);
        leaders_.push_back(r);
      }
    }
  }
  return SetupTransports(peers);
}

Status DataPlane::SetupTransports(const std::vector<PeerAddr>& peers) {
  tcp_lanes_.clear();
  auto make_tcp = [&](int peer) {
    auto* t = new TcpTransport(fds_[peer], inline_max_bytes_, &io_ctl_,
                               tcp_zerocopy_);
    tcp_lanes_.push_back(t);
    transports_[peer].reset(t);
  };
  for (int peer = 0; peer < size_; ++peer) {
    if (peer == rank_) continue;
    if (peers[peer].host != peers[rank_].host) {
      make_tcp(peer);
      continue;
    }
    // Same host: negotiate a shared-memory lane over the pair's socket so
    // both sides agree on the outcome — a one-sided fallback (one rank on
    // shm, the other on TCP) would wedge the pair. The handshake runs even
    // with shm disabled locally: the peer may have it on, and its status
    // byte must be consumed either way. Segment names key on the pair's
    // data-plane ports (unique per process while the job lives) + uid.
    const bool creator = rank_ < peer;
    const std::string name =
        "/hvdtpu_" + std::to_string(getuid()) + "_" +
        std::to_string(peers[std::min(rank_, peer)].port) + "_" +
        std::to_string(peers[std::max(rank_, peer)].port);
    std::unique_ptr<ShmTransport> shm;
    uint8_t ok = 0, peer_ok = 0;
    if (creator) {
      if (shm_enabled_) {
        shm = ShmTransport::Create(
            name, shm_ring_bytes_ > 0 ? static_cast<size_t>(shm_ring_bytes_)
                                      : 0);
      }
      ok = shm != nullptr ? 1 : 0;
      if (SendAll(fds_[peer], &ok, 1, &io_ctl_) != 0 ||
          RecvAll(fds_[peer], &peer_ok, 1, &io_ctl_) != 0) {
        return Status::Error(StatusCode::ABORTED,
                             "data plane: shm handshake with rank " +
                                 std::to_string(peer) + " failed");
      }
    } else {
      if (RecvAll(fds_[peer], &peer_ok, 1, &io_ctl_) != 0) {
        return Status::Error(StatusCode::ABORTED,
                             "data plane: shm handshake with rank " +
                                 std::to_string(peer) + " failed");
      }
      if (peer_ok != 0 && shm_enabled_) {
        shm = ShmTransport::Open(name, /*timeout_ms=*/10000);
      }
      ok = shm != nullptr ? 1 : 0;
      if (SendAll(fds_[peer], &ok, 1, &io_ctl_) != 0) {
        return Status::Error(StatusCode::ABORTED,
                             "data plane: shm handshake with rank " +
                                 std::to_string(peer) + " failed");
      }
    }
    if (ok != 0 && peer_ok != 0) {
      // The opener mmap'ed before acking, so the name can leave the shm
      // namespace now: an abnormal death past this point leaks nothing.
      if (creator) shm->Unlink();
      // A SIGKILLed peer can't flip the shared abort flag; the lane polls
      // the pair's (otherwise idle) socket for EOF while waiting instead.
      shm->set_liveness_fd(fds_[peer]);
      shm->set_control(&io_ctl_);
      shm->set_doorbell_batch(doorbell_batch_);
      // NUMA placement (HVDTPU_SHM_NUMA): each side pins its inbound ring
      // to its own node — probed no-op on single-node hosts.
      shm->ApplyNumaPolicy(shm_numa_);
      transports_[peer] = std::move(shm);
    } else {
      shm.reset();  // creator side aborts + unlinks in the destructor
      if (shm_enabled_) {
        fprintf(stderr,
                "[hvdtpu %d] WARNING: shm transport to same-host rank %d "
                "unavailable; falling back to TCP\n",
                rank_, peer);
      }
      make_tcp(peer);
    }
  }
  return Status::OK();
}

int DataPlane::shm_lane_count() const {
  int shm = 0;
  for (const auto& t : transports_) {
    if (t != nullptr && std::strcmp(t->kind(), "shm") == 0) ++shm;
  }
  return shm;
}

void DataPlane::ShmOccupancy(
    std::vector<std::pair<int, int64_t>>* out) const {
  out->clear();
  for (size_t peer = 0; peer < transports_.size(); ++peer) {
    const auto& t = transports_[peer];
    if (t != nullptr && std::strcmp(t->kind(), "shm") == 0) {
      out->emplace_back(static_cast<int>(peer), t->OccupancyBytes());
    }
  }
}

bool DataPlane::zerocopy_active() const {
  for (TcpTransport* t : tcp_lanes_) {
    if (t->zerocopy_enabled()) return true;
  }
  return false;
}

const std::string& DataPlane::transport_label() {
  // Rebuilt per call (a handful of times per op): the tcp-zc tag is live —
  // an AUTO lane that found the kernel copying anyway has downgraded
  // itself, and the per-op histogram/timeline labels must say so.
  int shm = 0, tcp = 0;
  bool zc = false;
  for (const auto& t : transports_) {
    if (t == nullptr) continue;
    if (std::strcmp(t->kind(), "shm") == 0) {
      ++shm;
    } else {
      ++tcp;
      if (std::strcmp(t->kind(), "tcp-zc") == 0) zc = true;
    }
  }
  const char* tcp_tag = zc ? "tcp-zc" : "tcp";
  if (shm > 0 && tcp > 0) {
    transport_label_ = std::string("shm+") + tcp_tag;
  } else if (shm > 0) {
    transport_label_ = "shm";
  } else if (tcp > 0) {
    transport_label_ = tcp_tag;
  } else {
    transport_label_ = "local";
  }
  return transport_label_;
}

void DataPlane::Shutdown(bool clean) {
  // Transports first: unless the close was agreed, the shm lanes flip their
  // shared abort flag and wake any same-host peer still blocked in a ring
  // op before the name goes.
  tcp_lanes_.clear();  // raw views into transports_: drop before the owners
  if (clean) {
    for (auto& t : transports_) {
      if (t != nullptr) t->CloseCleanly();
    }
  }
  for (auto& t : transports_) t.reset();
  for (int& fd : fds_) {
    CloseFd(fd);
    fd = -1;
  }
  CloseFd(listen_fd_);
  listen_fd_ = -1;
}

void DataPlane::Abort() {
  if (flight_ != nullptr && !io_ctl_.is_aborted()) {
    const int64_t now = Timeline::SteadyAbsUs();
    flight_->Record(FlightEvent::ABORT, -1, 0, failed_peer_, -1, now, now, 0,
                    0);
  }
  io_ctl_.aborted.store(1, std::memory_order_release);
  for (auto& t : transports_) {
    if (t != nullptr) t->Abort();  // shm: flag + futex wake; tcp: no-op
  }
  // Half-close (not close: fds stay owned until Shutdown) so a peer blocked
  // mid-transfer sees EOF at once and cascades its own abort.
  for (int fd : fds_) {
    if (fd >= 0) shutdown(fd, SHUT_RDWR);
  }
}

Status DataPlane::FailLane(int peer, const char* what) {
  if (failed_peer_ < 0) failed_peer_ = peer;
  if (flight_ != nullptr) {
    // The forensic money shot: which lane died, pinned on which peer. The
    // post-mortem verdict votes across every surviving rank's FAIL_DETECT
    // records to name the dead rank.
    const int64_t now = Timeline::SteadyAbsUs();
    flight_->Record(FlightEvent::FAIL_DETECT, -1, 0, peer, -1, now, now, 0,
                    0);
  }
  io_ctl_.MarkPeerFailed();
  Abort();
  return Status::Error(StatusCode::ABORTED,
                       "data plane: " + std::string(what) + " with rank " +
                           std::to_string(peer) +
                           " failed (peer death or liveness deadline)");
}

void DataPlane::BeginOpTrace() {
  trace_hop_seq_ = 0;
  trace_op_ = tracer_ != nullptr && tracer_->Initialized() &&
              trace_sampler_.SampleOp();
  // The flight ring and the perf-attribution accumulators want every hop;
  // the sampled JSON tracer only its share.
  rec_hops_ = trace_op_ || flight_ != nullptr || perf_on_;
  ResetOpPhaseAccum();
}

void DataPlane::ResetOpPhaseAccum() {
  op_wait_us_ = 0;
  op_wire_us_ = 0;
  op_reduce_us_ = 0;
  op_codec_us_ = 0;
  op_slow_peer_ = -1;
  op_slow_peer_wait_us_ = 0;
}

namespace {

// Map a TraceHop span name onto its flight-record tag. The strings are the
// handful of literals the data plane emits; first-character dispatch keeps
// this branchy-but-trivial on the hop path.
FlightEvent FlightHopEvent(const char* name) {
  switch (name[0]) {
    case 'S':
      return name[4] == 'R' ? FlightEvent::SENDRECV : FlightEvent::SEND;
    case 'R':
      return name[2] == 'C' ? FlightEvent::RECV : FlightEvent::REDUCE;
    case 'Q':
      return FlightEvent::QUANTIZE;
    case 'D':
      return FlightEvent::DEQUANTIZE;
    default:
      return FlightEvent::NONE;
  }
}

}  // namespace

void DataPlane::TraceHop(const char* name, int send_peer, int recv_peer,
                         int64_t bytes, int64_t t0_us, int64_t wait0_us) {
  if (!rec_hops_) return;
  const int64_t t1_us = Timeline::SteadyAbsUs();
  const int64_t wait_us = io_ctl_.WaitUs() - wait0_us;
  const int lane_peer = recv_peer >= 0 ? recv_peer : send_peer;
  const char* lane =
      lane_peer >= 0 && lane_peer < size_ && transports_[lane_peer] != nullptr
          ? transports_[lane_peer]->kind()
          : "local";
  const FlightEvent fev = FlightHopEvent(name);
  // Perf-attribution phase buckets (perfstats.h): every hop of every op —
  // plain integer adds, no strings, no branches beyond this switch.
  switch (fev) {
    case FlightEvent::SEND:
    case FlightEvent::RECV:
    case FlightEvent::SENDRECV: {
      op_wait_us_ += wait_us;
      const int64_t wire = t1_us - t0_us - wait_us;
      op_wire_us_ += wire > 0 ? wire : 0;
      if (lane_peer >= 0 && wait_us > op_slow_peer_wait_us_) {
        op_slow_peer_wait_us_ = wait_us;
        op_slow_peer_ = lane_peer;
      }
      break;
    }
    case FlightEvent::REDUCE:
      op_reduce_us_ += t1_us - t0_us;
      break;
    case FlightEvent::QUANTIZE:
    case FlightEvent::DEQUANTIZE:
      op_codec_us_ += t1_us - t0_us;
      break;
    default:
      break;
  }
  if (flight_ != nullptr) {
    flight_->Record(fev, /*name_id=*/-1, bytes, send_peer,
                    recv_peer, t0_us, t1_us, wait_us, FlightLaneCode(lane));
  }
  if (!trace_op_) return;
  std::string args = "{\"send_peer\": " + std::to_string(send_peer) +
                     ", \"recv_peer\": " + std::to_string(recv_peer) +
                     ", \"bytes\": " + std::to_string(bytes) +
                     ", \"lane\": \"" + lane + "\"" +
                     ", \"algo\": \"" + last_algo_label_ + "\"" +
                     ", \"hier\": " + (hier_active() ? "1" : "0") +
                     ", \"compression\": \"" +
                     WireCompressionName(op_comp_) + "\"" +
                     ", \"seg\": " + std::to_string(trace_hop_seq_++) +
                     ", \"wait_us\": " + std::to_string(wait_us) + "}";
  tracer_->Span("hops", name, t0_us, t1_us, args);
}

void DataPlane::MaybeChaosOp() {
  if (chaos_.action == ChaosSpec::Action::NONE || chaos_.op_index <= 0) {
    return;
  }
  if (++chaos_ops_ == chaos_.op_index) FireChaos(/*peer_hint=*/-1);
}

void DataPlane::MaybeChaosHop(int send_peer, int recv_peer) {
  if (chaos_.action == ChaosSpec::Action::NONE || chaos_.hop_index <= 0) {
    return;
  }
  if (++chaos_hops_ == chaos_.hop_index) {
    FireChaos(recv_peer >= 0 ? recv_peer : send_peer);
  }
}

void DataPlane::FireChaos(int peer_hint) {
  const ChaosSpec::Action action = chaos_.action;
  chaos_.action = ChaosSpec::Action::NONE;  // one-shot
  switch (action) {
    case ChaosSpec::Action::KILL:
      fprintf(stderr, "[hvdtpu %d] CHAOS: SIGKILL (op %lld, hop %lld)\n",
              rank_, static_cast<long long>(chaos_ops_),
              static_cast<long long>(chaos_hops_));
      raise(SIGKILL);
      return;  // unreachable
    case ChaosSpec::Action::HANG:
      fprintf(stderr, "[hvdtpu %d] CHAOS: hanging the collective thread "
                      "(op %lld, hop %lld)\n",
              rank_, static_cast<long long>(chaos_ops_),
              static_cast<long long>(chaos_hops_));
      // Wedged on purpose, ignoring every abort signal: this simulates a
      // livelocked rank, which only the PEERS' deadlines can detect.
      for (;;) {
        std::this_thread::sleep_for(std::chrono::milliseconds(100));
      }
    case ChaosSpec::Action::DELAY:
      fprintf(stderr, "[hvdtpu %d] CHAOS: delaying %lld ms\n", rank_,
              static_cast<long long>(chaos_.delay_ms));
      std::this_thread::sleep_for(
          std::chrono::milliseconds(chaos_.delay_ms));
      return;
    case ChaosSpec::Action::CORRUPT:
      // Deferred: the byte flips AFTER this op's reduction completes (see
      // Allreduce) so the corruption lands in the post-allreduce output
      // the divergence probe fingerprints — a pre-reduce flip would just
      // change the (still bitwise-consistent) sum on every rank.
      fprintf(stderr,
              "[hvdtpu %d] CHAOS: corrupting this op's output (op %lld)\n",
              rank_, static_cast<long long>(chaos_ops_));
      corrupt_pending_ = true;
      return;
    case ChaosSpec::Action::DROP: {
      // An op trigger has no hop peer yet (peer_hint == -1): blackhole the
      // ring neighbor so `drop@op=N` injects a real partition instead of
      // consuming the one-shot as a silent no-op.
      int victim = chaos_.peer >= 0 ? chaos_.peer : peer_hint;
      if (victim < 0 || victim == rank_ || victim >= size_) {
        victim = (rank_ + 1) % size_;
      }
      blackholed_peer_ = victim;
      fprintf(stderr, "[hvdtpu %d] CHAOS: blackholing lane to rank %d\n",
              rank_, blackholed_peer_);
      return;
    }
    case ChaosSpec::Action::NONE:
      return;
  }
}

Status DataPlane::BlackholeWait(int peer) {
  // A dropped lane is SILENT: no bytes move and no EOF ever arrives, like a
  // switch eating the flow. The op parks here until the plane aborts (a
  // peer detected the partition) or our own read deadline declares the
  // lane dead.
  const double t0 = MonoSeconds();
  for (;;) {
    if (io_ctl_.is_aborted()) {
      return Status::Error(StatusCode::ABORTED,
                           "data plane: aborted during a blackholed "
                           "exchange with rank " + std::to_string(peer));
    }
    const double now = MonoSeconds();
    if (io_ctl_.read_deadline_secs > 0 &&
        now - t0 > io_ctl_.read_deadline_secs) {
      return FailLane(peer, "blackholed exchange");
    }
    std::this_thread::sleep_for(
        std::chrono::milliseconds(io_ctl_.detect_slice_ms));
  }
}

Status DataPlane::SendTo(int peer, const void* buf, int64_t bytes,
                         const char* what) {
  MaybeChaosHop(peer, -1);
  if (io_ctl_.is_aborted()) {
    return Status::Error(StatusCode::ABORTED,
                         "data plane: aborted after a peer failure");
  }
  if (blackholed_peer_ >= 0 && peer == blackholed_peer_) {
    return BlackholeWait(peer);
  }
  // Sampling-profiler phase tag (profiler.h): samples landing inside this
  // hop fold under WIRE — the same region the op_wire_us_ accumulator
  // measures (wait slices re-tag themselves WAIT inside the transports).
  ProfPhaseScope prof_phase(PerfPhase::WIRE);
  const int64_t t0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  const int64_t w0 = rec_hops_ ? io_ctl_.WaitUs() : 0;
  if (bytes > 0 &&
      transports_[peer]->Send(buf, static_cast<size_t>(bytes)) != 0) {
    return FailLane(peer, what);
  }
  TraceHop("SEND", peer, -1, bytes, t0, w0);
  return Status::OK();
}

Status DataPlane::RecvFrom(int peer, void* buf, int64_t bytes,
                           const char* what) {
  MaybeChaosHop(-1, peer);
  if (io_ctl_.is_aborted()) {
    return Status::Error(StatusCode::ABORTED,
                         "data plane: aborted after a peer failure");
  }
  if (blackholed_peer_ >= 0 && peer == blackholed_peer_) {
    return BlackholeWait(peer);
  }
  ProfPhaseScope prof_phase(PerfPhase::WIRE);
  const int64_t t0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  const int64_t w0 = rec_hops_ ? io_ctl_.WaitUs() : 0;
  if (bytes > 0 &&
      transports_[peer]->Recv(buf, static_cast<size_t>(bytes)) != 0) {
    return FailLane(peer, what);
  }
  TraceHop("RECV", -1, peer, bytes, t0, w0);
  return Status::OK();
}

Status DataPlane::Exchange(int send_peer, const void* send_buf,
                           int64_t send_bytes, int recv_peer, void* recv_buf,
                           int64_t recv_bytes, int64_t segment_bytes,
                           const SegmentFn& on_segment, size_t view_align) {
  MaybeChaosHop(send_peer, recv_peer);
  if (io_ctl_.is_aborted()) {
    return Status::Error(StatusCode::ABORTED,
                         "data plane: aborted after a peer failure");
  }
  if (blackholed_peer_ >= 0 && (send_peer == blackholed_peer_ ||
                                recv_peer == blackholed_peer_)) {
    return BlackholeWait(blackholed_peer_);
  }
  // WIRE for the whole exchange; the segment callbacks (reduction) re-tag
  // their slices REDUCE and the transports' wait slices re-tag WAIT, so a
  // profiler sample always names the innermost active phase.
  ProfPhaseScope prof_phase(PerfPhase::WIRE);
  const int64_t t0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  const int64_t w0 = rec_hops_ ? io_ctl_.WaitUs() : 0;
  const int64_t hop_bytes = send_bytes + recv_bytes;
  const size_t seg =
      segment_bytes > 0 ? static_cast<size_t>(segment_bytes) : 0;
  if (send_peer == recv_peer) {
    // Same peer: the transport's own full-duplex exchange (interleaved ring
    // pump for shm; inline/concurrent/segmented socket path for TCP).
    if (transports_[send_peer]->SendRecv(
            send_buf, static_cast<size_t>(send_bytes), recv_buf,
            static_cast<size_t>(recv_bytes), seg, view_align,
            on_segment) != 0) {
      return FailLane(send_peer, "exchange");
    }
    TraceHop("SENDRECV", send_peer, recv_peer, hop_bytes, t0, w0);
    return Status::OK();
  }
  Transport* ts = transports_[send_peer].get();
  Transport* tr = transports_[recv_peer].get();
  if (std::strcmp(ts->kind(), "shm") == 0 &&
      std::strcmp(tr->kind(), "shm") == 0) {
    // Both lanes shared memory (ring-neighbor exchange on one host): one
    // thread pumps both rings — no sender thread, in-place receive views.
    auto* stx = static_cast<ShmTransport*>(ts);
    auto* srx = static_cast<ShmTransport*>(tr);
    if (ShmTransport::DuplexPump(stx, send_buf,
                                 static_cast<size_t>(send_bytes), srx,
                                 recv_buf, static_cast<size_t>(recv_bytes),
                                 view_align, on_segment) != 0) {
      // Blame the lane whose liveness probe / deadline actually tripped,
      // not reflexively the receive side: dead_ranks_ and the 
      // re-rendezvous trigger act on this attribution.
      const int suspect = stx->peer_died() && !srx->peer_died()
                              ? send_peer
                              : recv_peer;
      return FailLane(suspect, "exchange");
    }
    TraceHop("SENDRECV", send_peer, recv_peer, hop_bytes, t0, w0);
    return Status::OK();
  }
  auto recv_side = [&]() -> int {
    if (recv_bytes <= 0) return 0;
    if (on_segment) {
      return tr->RecvSegmented(recv_buf, static_cast<size_t>(recv_bytes), seg,
                               view_align, on_segment);
    }
    return tr->Recv(recv_buf, static_cast<size_t>(recv_bytes));
  };
  if (send_bytes <= 0 ||
      ts->InlineSendSafe(static_cast<size_t>(send_bytes))) {
    // The send completes without peer progress (fits the lane's buffering):
    // inline send-then-recv skips the per-call sender thread.
    if (send_bytes > 0 &&
        ts->Send(send_buf, static_cast<size_t>(send_bytes)) != 0) {
      return FailLane(send_peer, "send");
    }
    if (recv_side() != 0) return FailLane(recv_peer, "receive");
    TraceHop("SENDRECV", send_peer, recv_peer, hop_bytes, t0, w0);
    return Status::OK();
  }
  int send_rc = 0;
  std::thread sender(
      [&] { send_rc = ts->Send(send_buf, static_cast<size_t>(send_bytes)); });
  int recv_rc = recv_side();
  sender.join();
  if (send_rc != 0) return FailLane(send_peer, "send");
  if (recv_rc != 0) return FailLane(recv_peer, "receive");
  TraceHop("SENDRECV", send_peer, recv_peer, hop_bytes, t0, w0);
  return Status::OK();
}

namespace {

// Chunk boundaries for a ring over `n` members (chunk c covers
// [starts[c], starts[c+1])).
std::vector<int64_t> ChunkStarts(int64_t count, int n) {
  std::vector<int64_t> starts(n + 1, 0);
  int64_t base = count / n, rem = count % n;
  for (int c = 0; c < n; ++c) {
    starts[c + 1] = starts[c] + base + (c < rem ? 1 : 0);
  }
  return starts;
}

int GroupIndex(const std::vector<int>& group, int rank) {
  for (size_t i = 0; i < group.size(); ++i) {
    if (group[i] == rank) return static_cast<int>(i);
  }
  return -1;
}

}  // namespace

Status DataPlane::Allreduce(void* data, int64_t count, DataType dtype,
                            ReduceOp op) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "none";
  trace_op_ = false;  // never inherit the previous op's sampling decision
  if (size_ == 1 || count == 0) {
    // No hops will run, but ObserveOp still reads the phase accumulators:
    // a skipped BeginOpTrace must not leak the PREVIOUS op's buckets into
    // this op's perf baseline.
    ResetOpPhaseAccum();
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  Status st;
  if (hier_active()) {
    st = HierarchicalAllreduce(data, count, dtype, op);
    // Overwrites the leader-phase AllreduceGroup label: the op as a whole
    // took the two-level path.
    last_algo_label_ = "hierarchical";
  } else {
    st = AllreduceGroup(data, count, dtype, op, world_group_);
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  if (corrupt_pending_ && st.ok()) {
    // Seeded silent data corruption (HVDTPU_CHAOS corrupt@op=N): one byte
    // of THIS rank's reduced output flips, exactly the bitwise divergence
    // the gradcheck fingerprint probe exists to catch (docs/numerics.md).
    corrupt_pending_ = false;
    static_cast<uint8_t*>(data)[0] ^= 0x01;
  }
  return st;
}

Status DataPlane::AllreduceGroup(void* data, int64_t count, DataType dtype,
                                 ReduceOp op, const std::vector<int>& group) {
  if (group.size() <= 1 || count == 0) return Status::OK();
  AllreduceAlgo algo = algo_;
  if (algo == AllreduceAlgo::AUTO) {
    const int64_t bytes = count * static_cast<int64_t>(DataTypeSize(dtype));
    if (bytes <= crossover_bytes_) {
      algo = AllreduceAlgo::RECURSIVE_DOUBLING;
    } else if (sa_auto_ && sa_min_group_ > 0 &&
               static_cast<int>(group.size()) >= sa_min_group_) {
      // Large message, large group: scatter-allgather's 2 rounds of depth
      // beat the ring's 2(gs-1) serialized hops. The static gate is the
      // HVDTPU_ALLREDUCE_SA_GROUP floor; sa_auto_ is the autotuner's pick.
      // The decision depends only on world-agreed values (group size,
      // adopted knobs), so the schedule cannot split across ranks.
      algo = AllreduceAlgo::SCATTER_ALLGATHER;
    } else {
      algo = AllreduceAlgo::RING;
    }
  }
  last_algo_label_ =
      algo == AllreduceAlgo::RECURSIVE_DOUBLING  ? "recursive_doubling"
      : algo == AllreduceAlgo::TREE              ? "tree"
      : algo == AllreduceAlgo::SCATTER_ALLGATHER ? "scatter_allgather"
      : algo == AllreduceAlgo::PARAMETER_SERVER  ? "parameter_server"
                                                 : "ring";
  switch (algo) {
    case AllreduceAlgo::RECURSIVE_DOUBLING:
      if (CompressionActive(dtype, op)) {
        return CompressedRecursiveDoubling(static_cast<float*>(data), count,
                                          group);
      }
      return RecursiveDoublingGroup(data, count, dtype, op, group);
    case AllreduceAlgo::TREE:
      // The tree path stays raw (all ranks resolve the same algo, so the
      // schedule cannot split): its reduce/broadcast edges are one-way and
      // would re-quantize log2(p) times with no bandwidth structure to
      // exploit — compression covers ring + recursive doubling.
      return TreeAllreduceGroup(data, count, dtype, op, group);
    case AllreduceAlgo::SCATTER_ALLGATHER:
      if (CompressionActive(dtype, op)) {
        const int gi = GroupIndex(group, rank_);
        std::vector<int64_t> starts =
            ChunkStarts(count, static_cast<int>(group.size()));
        return CompressedScatterAllgather(static_cast<float*>(data), starts,
                                          group, gi);
      }
      return ScatterAllgatherGroup(data, count, dtype, op, group);
    case AllreduceAlgo::PARAMETER_SERVER:
      if (CompressionActive(dtype, op)) {
        return CompressedParameterServer(static_cast<float*>(data), count,
                                         group, GroupIndex(group, rank_));
      }
      return ParameterServerGroup(data, count, dtype, op, group);
    case AllreduceAlgo::AUTO:
    case AllreduceAlgo::RING:
      break;
  }
  if (CompressionActive(dtype, op)) {
    const int gi = GroupIndex(group, rank_);
    std::vector<int64_t> starts =
        ChunkStarts(count, static_cast<int>(group.size()));
    float* buf = static_cast<float*>(data);
    Status st = CompressedRingReduceScatter(buf, starts, group, gi);
    if (!st.ok()) return st;
    return CompressedRingAllgather(buf, starts, group, gi);
  }
  return RingAllreduceGroup(data, count, dtype, op, group);
}

Status DataPlane::CompressedRingReduceScatter(
    float* buf, const std::vector<int64_t>& starts,
    const std::vector<int>& group, int gi) {
  const WireCompression c = op_comp_;
  const int gs = static_cast<int>(group.size());
  const int right = group[(gi + 1) % gs];
  const int left = group[(gi - 1 + gs) % gs];
  auto chunk_count = [&](int ch) { return starts[ch + 1] - starts[ch]; };
  int64_t max_chunk = 0;
  for (int ch = 0; ch < gs; ++ch) {
    max_chunk = std::max(max_chunk, chunk_count(ch));
  }
  std::vector<uint8_t> send_wire(static_cast<size_t>(WireBytes(c, max_chunk)));
  std::vector<uint8_t> recv_wire(send_wire.size());

  // Same schedule as the raw reduce-scatter: at step s send chunk (gi - s),
  // receive chunk (gi - s - 1) — but each hop ships the quantized form and
  // the receiver dequantizes + accumulates in fp32. Every chunk is
  // compressed exactly once per rank per op, so the error-feedback residual
  // region [starts[c], starts[c+1]) is consumed and rewritten once.
  for (int s = 0; s < gs - 1; ++s) {
    const int send_c = ((gi - s) % gs + gs) % gs;
    const int recv_c = ((gi - s - 1) % gs + gs) % gs;
    const int64_t sc = chunk_count(send_c);
    const int64_t rc = chunk_count(recv_c);
    const int64_t sw = WireBytes(c, sc);
    const int64_t rw = WireBytes(c, rc);
    const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireCompress(c, buf + starts[send_c], sc, send_wire.data(),
                   op_residual_ != nullptr ? op_residual_ + starts[send_c]
                                           : nullptr,
                   nullptr, op_quality_);
    }
    TraceHop("QUANTIZE", -1, -1, sc * 4, qt0, io_ctl_.WaitUs());
    AddOpBytes(sc * 4, sw);
    Status st = Exchange(right, send_wire.data(), sw, left, recv_wire.data(),
                         rw);
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompressAdd(c, recv_wire.data(), rc, buf + starts[recv_c]);
    }
    TraceHop("DEQUANTIZE", -1, -1, rc * 4, dt0, io_ctl_.WaitUs());
  }
  return Status::OK();
}

Status DataPlane::CompressedRingAllgather(float* buf,
                                          const std::vector<int64_t>& starts,
                                          const std::vector<int>& group,
                                          int gi) {
  const WireCompression c = op_comp_;
  const int gs = static_cast<int>(group.size());
  const int right = group[(gi + 1) % gs];
  const int left = group[(gi - 1 + gs) % gs];
  auto chunk_count = [&](int ch) { return starts[ch + 1] - starts[ch]; };
  int64_t max_chunk = 0;
  for (int ch = 0; ch < gs; ++ch) {
    max_chunk = std::max(max_chunk, chunk_count(ch));
  }
  std::vector<uint8_t> cur(static_cast<size_t>(WireBytes(c, max_chunk)));
  std::vector<uint8_t> next(cur.size());

  // The owner quantizes its fully reduced chunk once (residual applied,
  // own copy replaced by the dequantized values); every later hop forwards
  // those wire bytes verbatim, so the whole group decodes identical codes
  // and the final vectors agree bitwise.
  const int own_c = (gi + 1) % gs;
  const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  {
    ProfPhaseScope prof_codec(PerfPhase::CODEC);
    WireCompress(c, buf + starts[own_c], chunk_count(own_c), cur.data(),
                 op_residual_ != nullptr ? op_residual_ + starts[own_c]
                                         : nullptr,
                 buf + starts[own_c], op_quality_);
  }
  TraceHop("QUANTIZE", -1, -1, chunk_count(own_c) * 4, qt0,
           io_ctl_.WaitUs());
  for (int s = 0; s < gs - 1; ++s) {
    const int send_c = ((gi + 1 - s) % gs + gs) % gs;
    const int recv_c = ((gi - s) % gs + gs) % gs;
    const int64_t sw = WireBytes(c, chunk_count(send_c));
    const int64_t rw = WireBytes(c, chunk_count(recv_c));
    AddOpBytes(chunk_count(send_c) * 4, sw);
    Status st = Exchange(right, cur.data(), sw, left, next.data(), rw);
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompress(c, next.data(), chunk_count(recv_c),
                     buf + starts[recv_c]);
    }
    TraceHop("DEQUANTIZE", -1, -1, chunk_count(recv_c) * 4, dt0,
             io_ctl_.WaitUs());
    cur.swap(next);
  }
  return Status::OK();
}

Status DataPlane::CompressedRecursiveDoubling(float* data, int64_t count,
                                              const std::vector<int>& group) {
  const WireCompression c = op_comp_;
  const int gs = static_cast<int>(group.size());
  const int gi = GroupIndex(group, rank_);
  const int64_t raw_bytes = count * 4;
  const int64_t wb = WireBytes(c, count);
  std::vector<uint8_t> send_wire(static_cast<size_t>(wb));
  std::vector<uint8_t> recv_wire(static_cast<size_t>(wb));

  int p = 1;
  while (p * 2 <= gs) p *= 2;
  const int r = gs - p;

  // Fold: extra members ship their contribution quantized (uplink), the
  // partner dequantizes + accumulates.
  if (gi >= p) {
    WireCompress(c, data, count, send_wire.data(), op_residual_, nullptr,
                 op_quality_);
    AddOpBytes(raw_bytes, wb);
    Status st = SendTo(group[gi - p], send_wire.data(), wb, "rd fold send");
    if (!st.ok()) return st;
  } else if (gi < r) {
    Status st = RecvFrom(group[gi + p], recv_wire.data(), wb, "rd fold recv");
    if (!st.ok()) return st;
    WireDecompressAdd(c, recv_wire.data(), count, data);
  }

  if (gi < p) {
    for (int distance = 1; distance < p; distance *= 2) {
      const int peer = group[gi ^ distance];
      // Self-decode into `data`: both sides of the pair end up with
      // deQ(mine) + deQ(theirs) — bitwise identical by commutativity.
      const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      {
        ProfPhaseScope prof_codec(PerfPhase::CODEC);
        WireCompress(c, data, count, send_wire.data(), op_residual_, data,
                     op_quality_);
      }
      TraceHop("QUANTIZE", -1, -1, raw_bytes, qt0, io_ctl_.WaitUs());
      AddOpBytes(raw_bytes, wb);
      Status st = Exchange(peer, send_wire.data(), wb, peer,
                           recv_wire.data(), wb);
      if (!st.ok()) return st;
      const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      {
        ProfPhaseScope prof_codec(PerfPhase::CODEC);
        WireDecompressAdd(c, recv_wire.data(), count, data);
      }
      TraceHop("DEQUANTIZE", -1, -1, raw_bytes, dt0, io_ctl_.WaitUs());
    }
  }

  // Unfold: the final vector travels RAW so folded ranks hold exactly the
  // main group's bytes (one uncompressed hop, non-power-of-two worlds only).
  if (gi < r) {
    AddOpBytes(raw_bytes, raw_bytes);
    Status st = SendTo(group[gi + p], data, raw_bytes, "rd unfold send");
    if (!st.ok()) return st;
  } else if (gi >= p) {
    Status st = RecvFrom(group[gi - p], data, raw_bytes, "rd unfold recv");
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::RingReduceScatterPhase(uint8_t* buf,
                                         const std::vector<int64_t>& starts,
                                         size_t elem, DataType dtype,
                                         ReduceOp op,
                                         const std::vector<int>& group,
                                         int gi) {
  const int gs = static_cast<int>(group.size());
  const int right = group[(gi + 1) % gs];
  const int left = group[(gi - 1 + gs) % gs];
  auto chunk_ptr = [&](int c) { return buf + starts[c] * elem; };
  auto chunk_count = [&](int c) { return starts[c + 1] - starts[c]; };
  int64_t max_chunk = 0;
  for (int c = 0; c < gs; ++c) max_chunk = std::max(max_chunk, chunk_count(c));
  // Receive scratch: the shm lane consumes segments in place (zero-copy
  // views), so a shm left-neighbor needs NO landing buffer at all — and
  // the TCP lane gets an uninitialized one (the old value-initialized
  // vector memset a full chunk per op for bytes about to be overwritten).
  const bool recv_lands =
      std::strcmp(transports_[left]->kind(), "shm") != 0;
  std::unique_ptr<uint8_t[]> recv_tmp(
      recv_lands ? new uint8_t[static_cast<size_t>(max_chunk) * elem]
                 : nullptr);

  // Element-aligned pipeline segment.
  int64_t seg = segment_bytes_ - segment_bytes_ % static_cast<int64_t>(elem);
  if (seg <= 0) seg = static_cast<int64_t>(elem);

  // Ring reduce-scatter. After step s, chunk (gi - s - 1) holds the partial
  // sum of s + 2 members; after gs-1 steps, chunk (gi + 1) holds the full
  // reduction on this member (standard ring schedule: send chunk (gi - s),
  // receive + reduce chunk (gi - s - 1)). Chunks of two or more segments
  // stream through the segmented exchange so the reduction of segment k
  // overlaps the transfer of segment k+1.
  for (int s = 0; s < gs - 1; ++s) {
    int send_c = ((gi - s) % gs + gs) % gs;
    int recv_c = ((gi - s - 1) % gs + gs) % gs;
    int64_t send_bytes = chunk_count(send_c) * static_cast<int64_t>(elem);
    int64_t recv_bytes = chunk_count(recv_c) * static_cast<int64_t>(elem);
    AddOpBytes(send_bytes, send_bytes);
    if (recv_bytes > 0) {
      // Segment views reduce straight from the transport's storage: the
      // TCP lane hands recv_tmp-backed views, the shm lane hands in-ring
      // views and skips the staging copy entirely (transport.h SegmentFn).
      // Every non-empty chunk takes this path — chunk sizes are whole
      // element multiples, and sub-segment chunks simply arrive as one
      // view.
      uint8_t* dst = chunk_ptr(recv_c);
      // Tracing: the per-segment reductions interleave with the transfer;
      // the REDUCE child span covers first-to-last with the actual busy
      // time in its args (docs/tracing.md).
      int64_t reduce_first_us = 0, reduce_last_us = 0, reduce_busy_us = 0;
      Status st = Exchange(
          right, chunk_ptr(send_c), send_bytes, left, recv_tmp.get(),
          recv_bytes, seg,
          [&](const uint8_t* data, size_t off, size_t len) {
            ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
            const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
            ReduceBuffer(dst + off, data, static_cast<int64_t>(len / elem),
                         dtype, op);
            if (rec_hops_) {
              const int64_t rt1 = Timeline::SteadyAbsUs();
              if (reduce_first_us == 0) reduce_first_us = rt0;
              reduce_last_us = rt1;
              reduce_busy_us += rt1 - rt0;
            }
          },
          elem);
      if (!st.ok()) return st;
      if (rec_hops_ && reduce_first_us != 0) {
        // Perf attribution: the segmented reduce's actual busy time (the
        // first-to-last span overlaps the wire and would double-count).
        op_reduce_us_ += reduce_busy_us;
        if (flight_ != nullptr) {
          // busy_us in arg: the span is first-to-last segment, the actual
          // reduction time is what the analyzer attributes.
          flight_->Record(FlightEvent::REDUCE, -1, recv_bytes, -1, -1,
                          reduce_first_us, reduce_last_us, reduce_busy_us,
                          0);
        }
        if (trace_op_) {
          tracer_->Span(
              "hops", "REDUCE", reduce_first_us, reduce_last_us,
              "{\"bytes\": " + std::to_string(recv_bytes) +
                  ", \"busy_us\": " + std::to_string(reduce_busy_us) +
                  ", \"seg\": " + std::to_string(trace_hop_seq_++) + "}");
        }
      }
    } else {
      // Empty chunk (count < group size): send-only hop.
      Status st = Exchange(right, chunk_ptr(send_c), send_bytes, left,
                           nullptr, 0);
      if (!st.ok()) return st;
    }
  }
  return Status::OK();
}

Status DataPlane::RingAllgatherPhase(uint8_t* buf,
                                     const std::vector<int64_t>& starts,
                                     size_t elem,
                                     const std::vector<int>& group, int gi) {
  const int gs = static_cast<int>(group.size());
  const int right = group[(gi + 1) % gs];
  const int left = group[(gi - 1 + gs) % gs];
  auto chunk_ptr = [&](int c) { return buf + starts[c] * elem; };
  auto chunk_count = [&](int c) { return starts[c + 1] - starts[c]; };
  // Ring allgather of the reduced chunks (already full-duplex; no
  // per-segment work to overlap).
  for (int s = 0; s < gs - 1; ++s) {
    int send_c = ((gi + 1 - s) % gs + gs) % gs;
    int recv_c = ((gi - s) % gs + gs) % gs;
    const int64_t send_bytes =
        chunk_count(send_c) * static_cast<int64_t>(elem);
    AddOpBytes(send_bytes, send_bytes);
    Status st = Exchange(right, chunk_ptr(send_c), send_bytes,
                         left, chunk_ptr(recv_c),
                         chunk_count(recv_c) * static_cast<int64_t>(elem));
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::RingAllreduceGroup(void* data, int64_t count, DataType dtype,
                                     ReduceOp op,
                                     const std::vector<int>& group) {
  const size_t elem = DataTypeSize(dtype);
  uint8_t* buf = static_cast<uint8_t*>(data);
  const int gi = GroupIndex(group, rank_);
  std::vector<int64_t> starts =
      ChunkStarts(count, static_cast<int>(group.size()));
  Status st = RingReduceScatterPhase(buf, starts, elem, dtype, op, group, gi);
  if (!st.ok()) return st;
  return RingAllgatherPhase(buf, starts, elem, group, gi);
}

Status DataPlane::RecursiveDoublingGroup(void* data, int64_t count,
                                         DataType dtype, ReduceOp op,
                                         const std::vector<int>& group) {
  const size_t elem = DataTypeSize(dtype);
  const int64_t bytes = count * static_cast<int64_t>(elem);
  const int gs = static_cast<int>(group.size());
  const int gi = GroupIndex(group, rank_);
  std::vector<uint8_t> other(static_cast<size_t>(bytes));

  // Largest power-of-two subgroup; the r extra members fold into their
  // partner first and receive the result last (same shape as Adasum).
  int p = 1;
  while (p * 2 <= gs) p *= 2;
  const int r = gs - p;

  if (gi >= p) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(group[gi - p], data, bytes, "rd fold send");
    if (!st.ok()) return st;
  } else if (gi < r) {
    Status st = RecvFrom(group[gi + p], other.data(), bytes, "rd fold recv");
    if (!st.ok()) return st;
    ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
    const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    ReduceBuffer(data, other.data(), count, dtype, op);
    TraceHop("REDUCE", -1, -1, bytes, rt0, io_ctl_.WaitUs());
  }

  if (gi < p) {
    for (int distance = 1; distance < p; distance *= 2) {
      int peer = group[gi ^ distance];
      AddOpBytes(bytes, bytes);
      Status st = Exchange(peer, data, bytes, peer, other.data(), bytes);
      if (!st.ok()) return st;
      ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
      const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      ReduceBuffer(data, other.data(), count, dtype, op);
      TraceHop("REDUCE", -1, -1, bytes, rt0, io_ctl_.WaitUs());
    }
  }

  if (gi < r) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(group[gi + p], data, bytes, "rd unfold send");
    if (!st.ok()) return st;
  } else if (gi >= p) {
    Status st = RecvFrom(group[gi - p], data, bytes, "rd unfold recv");
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::TreeAllreduceGroup(void* data, int64_t count, DataType dtype,
                                     ReduceOp op,
                                     const std::vector<int>& group) {
  const size_t elem = DataTypeSize(dtype);
  const int64_t bytes = count * static_cast<int64_t>(elem);
  const int gs = static_cast<int>(group.size());
  const int gi = GroupIndex(group, rank_);
  std::vector<uint8_t> other(static_cast<size_t>(bytes));

  // Binomial reduce toward member 0: at distance d, members with bit d set
  // send up and leave; the rest absorb a child (if present) and continue.
  for (int d = 1; d < gs; d <<= 1) {
    if (gi & d) {
      AddOpBytes(bytes, bytes);
      Status st = SendTo(group[gi - d], data, bytes, "tree reduce send");
      if (!st.ok()) return st;
      break;
    }
    if (gi + d < gs) {
      Status st =
          RecvFrom(group[gi + d], other.data(), bytes, "tree reduce recv");
      if (!st.ok()) return st;
      ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
      const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      ReduceBuffer(data, other.data(), count, dtype, op);
      TraceHop("REDUCE", -1, -1, bytes, rt0, io_ctl_.WaitUs());
    }
  }

  // Binomial broadcast back down the same tree (parent first, then forward
  // to children in decreasing-distance order — each edge is one-directional,
  // so plain blocking sends cannot deadlock).
  int top = 1;
  while (top < gs) top <<= 1;
  int lsb = gi == 0 ? top : (gi & -gi);
  if (gi != 0) {
    Status st = RecvFrom(group[gi - lsb], data, bytes, "tree bcast recv");
    if (!st.ok()) return st;
  }
  for (int d = lsb >> 1; d >= 1; d >>= 1) {
    if (gi + d < gs) {
      AddOpBytes(bytes, bytes);
      Status st = SendTo(group[gi + d], data, bytes, "tree bcast send");
      if (!st.ok()) return st;
    }
  }
  return Status::OK();
}

Status DataPlane::ScatterAllgatherGroup(void* data, int64_t count,
                                        DataType dtype, ReduceOp op,
                                        const std::vector<int>& group) {
  const size_t elem = DataTypeSize(dtype);
  uint8_t* buf = static_cast<uint8_t*>(data);
  const int gs = static_cast<int>(group.size());
  const int gi = GroupIndex(group, rank_);
  std::vector<int64_t> starts = ChunkStarts(count, gs);
  auto chunk_ptr = [&](int c) { return buf + starts[c] * elem; };
  auto chunk_bytes = [&](int c) {
    return (starts[c + 1] - starts[c]) * static_cast<int64_t>(elem);
  };
  // Ring-identical chunk ownership: member j owns chunk (j+1) % gs.
  auto owned = [&](int j) { return (j + 1) % gs; };
  const int own_c = owned(gi);
  const int64_t mine = chunk_bytes(own_c);

  // Accumulator for the gs-1 incoming copies of my owned chunk, plus a
  // landing buffer for the segmented exchanges (the shm lanes consume
  // segments in place and leave it untouched; the TCP lanes stage there).
  std::vector<uint8_t> tmp(static_cast<size_t>(mine));
  std::vector<uint8_t> scratch(static_cast<size_t>(mine));
  int64_t seg = segment_bytes_ - segment_bytes_ % static_cast<int64_t>(elem);
  if (seg <= 0) seg = static_cast<int64_t>(elem);

  // Phase 1 — direct-exchange reduce-scatter: at step k, ship peer
  // (gi - k)'s owned slice straight out of MY buffer while receiving peer
  // (gi + k)'s copy of MY owned chunk. The copies arrive from members
  // own_c, own_c+1, ..., gi-1 in that order — exactly the ring
  // reduce-scatter's accumulation order — and my own contribution folds in
  // last, so the reduced chunk is bitwise the ring's (commutative
  // per-application IEEE ops; see data_plane.h).
  for (int k = 1; k < gs; ++k) {
    const int send_i = (gi - k + gs) % gs;
    const int recv_i = (gi + k) % gs;
    const int send_c = owned(send_i);
    const int64_t send_bytes = chunk_bytes(send_c);
    AddOpBytes(send_bytes, send_bytes);
    Status st;
    if (mine == 0) {
      st = Exchange(group[send_i], chunk_ptr(send_c), send_bytes,
                    group[recv_i], nullptr, 0);
    } else if (k == 1) {
      // First copy lands plain: the accumulator starts as x_{own_c}.
      st = Exchange(group[send_i], chunk_ptr(send_c), send_bytes,
                    group[recv_i], tmp.data(), mine);
    } else {
      // Later copies stream through the segmented exchange so the
      // reduction of segment s overlaps the transfer of segment s+1, like
      // the ring reduce-scatter.
      int64_t reduce_first_us = 0, reduce_last_us = 0, reduce_busy_us = 0;
      st = Exchange(
          group[send_i], chunk_ptr(send_c), send_bytes, group[recv_i],
          scratch.data(), mine, seg,
          [&](const uint8_t* d, size_t off, size_t len) {
            ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
            const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
            ReduceBuffer(tmp.data() + off, d,
                         static_cast<int64_t>(len / elem), dtype, op);
            if (rec_hops_) {
              const int64_t rt1 = Timeline::SteadyAbsUs();
              if (reduce_first_us == 0) reduce_first_us = rt0;
              reduce_last_us = rt1;
              reduce_busy_us += rt1 - rt0;
            }
          },
          elem);
      if (st.ok() && rec_hops_ && reduce_first_us != 0) {
        op_reduce_us_ += reduce_busy_us;
        if (flight_ != nullptr) {
          flight_->Record(FlightEvent::REDUCE, -1, mine, -1, -1,
                          reduce_first_us, reduce_last_us, reduce_busy_us,
                          0);
        }
        if (trace_op_) {
          tracer_->Span(
              "hops", "REDUCE", reduce_first_us, reduce_last_us,
              "{\"bytes\": " + std::to_string(mine) +
                  ", \"busy_us\": " + std::to_string(reduce_busy_us) +
                  ", \"seg\": " + std::to_string(trace_hop_seq_++) + "}");
        }
      }
    }
    if (!st.ok()) return st;
  }
  if (mine > 0) {
    // My contribution folds in last, where the ring's final reduce-scatter
    // step puts it: chunk = x_gi OP (x_c OP ... OP x_{gi-1}).
    ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
    const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    ReduceBuffer(chunk_ptr(own_c), tmp.data(), starts[own_c + 1] - starts[own_c],
                 dtype, op);
    TraceHop("REDUCE", -1, -1, mine, rt0, io_ctl_.WaitUs());
  }

  // Phase 2 — direct allgather: every peer gets my reduced chunk straight
  // from its owner (one hop of depth; no store-and-forward reshipping).
  for (int k = 1; k < gs; ++k) {
    const int to_i = (gi + k) % gs;
    const int from_i = (gi - k + gs) % gs;
    const int from_c = owned(from_i);
    AddOpBytes(mine, mine);
    Status st = Exchange(group[to_i], chunk_ptr(own_c), mine, group[from_i],
                         chunk_ptr(from_c), chunk_bytes(from_c));
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::CompressedScatterAllgather(
    float* buf, const std::vector<int64_t>& starts,
    const std::vector<int>& group, int gi) {
  const WireCompression c = op_comp_;
  const int gs = static_cast<int>(group.size());
  auto chunk_count = [&](int ch) { return starts[ch + 1] - starts[ch]; };
  auto owned = [&](int j) { return (j + 1) % gs; };
  const int own_c = owned(gi);
  const int64_t mc = chunk_count(own_c);
  int64_t max_chunk = 0;
  for (int ch = 0; ch < gs; ++ch) {
    max_chunk = std::max(max_chunk, chunk_count(ch));
  }
  std::vector<uint8_t> send_wire(static_cast<size_t>(WireBytes(c, max_chunk)));
  std::vector<uint8_t> recv_wire(send_wire.size());

  // Phase 1: quantize each peer's slice out of MY buffer (error feedback at
  // that region — together with phase 2's own-chunk quantize, every region
  // is compressed exactly once per rank per op) and dequantize-add the
  // incoming copies straight into my owned chunk, which starts as x_gi.
  for (int k = 1; k < gs; ++k) {
    const int send_i = (gi - k + gs) % gs;
    const int recv_i = (gi + k) % gs;
    const int send_c = owned(send_i);
    const int64_t sc = chunk_count(send_c);
    const int64_t sw = WireBytes(c, sc);
    const int64_t rw = WireBytes(c, mc);
    const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireCompress(c, buf + starts[send_c], sc, send_wire.data(),
                   op_residual_ != nullptr ? op_residual_ + starts[send_c]
                                           : nullptr,
                   nullptr, op_quality_);
    }
    TraceHop("QUANTIZE", -1, -1, sc * 4, qt0, io_ctl_.WaitUs());
    AddOpBytes(sc * 4, sw);
    Status st = Exchange(group[send_i], send_wire.data(), sw, group[recv_i],
                         recv_wire.data(), rw);
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompressAdd(c, recv_wire.data(), mc, buf + starts[own_c]);
    }
    TraceHop("DEQUANTIZE", -1, -1, mc * 4, dt0, io_ctl_.WaitUs());
  }

  // Phase 2: the owner quantizes its fully reduced chunk ONCE (residual
  // applied, own copy replaced by the dequantized values) and the direct
  // rotation ships those same wire bytes to every peer — the whole group
  // decodes identical codes, so the final vectors agree bitwise.
  const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  {
    ProfPhaseScope prof_codec(PerfPhase::CODEC);
    WireCompress(c, buf + starts[own_c], mc, send_wire.data(),
                 op_residual_ != nullptr ? op_residual_ + starts[own_c]
                                         : nullptr,
                 buf + starts[own_c], op_quality_);
  }
  TraceHop("QUANTIZE", -1, -1, mc * 4, qt0, io_ctl_.WaitUs());
  const int64_t ow = WireBytes(c, mc);
  for (int k = 1; k < gs; ++k) {
    const int to_i = (gi + k) % gs;
    const int from_i = (gi - k + gs) % gs;
    const int from_c = owned(from_i);
    const int64_t rc = chunk_count(from_c);
    const int64_t rw = WireBytes(c, rc);
    AddOpBytes(mc * 4, ow);
    Status st = Exchange(group[to_i], send_wire.data(), ow, group[from_i],
                         recv_wire.data(), rw);
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompress(c, recv_wire.data(), rc, buf + starts[from_c]);
    }
    TraceHop("DEQUANTIZE", -1, -1, rc * 4, dt0, io_ctl_.WaitUs());
  }
  return Status::OK();
}

Status DataPlane::ParameterServerGroup(void* data, int64_t count,
                                       DataType dtype, ReduceOp op,
                                       const std::vector<int>& group) {
  const size_t elem = DataTypeSize(dtype);
  const int64_t bytes = count * static_cast<int64_t>(elem);
  const int gs = static_cast<int>(group.size());
  const int gi = GroupIndex(group, rank_);

  if (gi != 0) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(group[0], data, bytes, "ps gather send");
    if (!st.ok()) return st;
    return RecvFrom(group[0], data, bytes, "ps bcast recv");
  }
  // Root: absorb every worker's vector in rank order (the same sequential
  // one-directional drain as the tree reduce — no cycle, no deadlock),
  // then broadcast the single reduced buffer. One reducer, one buffer:
  // cross-rank bitwise equality is trivial.
  std::vector<uint8_t> other(static_cast<size_t>(bytes));
  for (int j = 1; j < gs; ++j) {
    Status st = RecvFrom(group[j], other.data(), bytes, "ps gather recv");
    if (!st.ok()) return st;
    ProfPhaseScope prof_reduce(PerfPhase::REDUCE);
    const int64_t rt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    ReduceBuffer(data, other.data(), count, dtype, op);
    TraceHop("REDUCE", -1, -1, bytes, rt0, io_ctl_.WaitUs());
  }
  for (int j = 1; j < gs; ++j) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(group[j], data, bytes, "ps bcast send");
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::CompressedParameterServer(float* buf, int64_t count,
                                            const std::vector<int>& group,
                                            int gi) {
  const WireCompression c = op_comp_;
  const int gs = static_cast<int>(group.size());
  const int64_t raw_bytes = count * 4;
  const int64_t wb = WireBytes(c, count);
  std::vector<uint8_t> wire(static_cast<size_t>(wb));

  if (gi != 0) {
    // Quantized uplink with error feedback at the worker...
    const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireCompress(c, buf, count, wire.data(), op_residual_, nullptr,
                   op_quality_);
    }
    TraceHop("QUANTIZE", -1, -1, raw_bytes, qt0, io_ctl_.WaitUs());
    AddOpBytes(raw_bytes, wb);
    Status st = SendTo(group[0], wire.data(), wb, "ps gather send");
    if (!st.ok()) return st;
    // ...then decode the root's single quantized broadcast: every rank
    // sees the same codes (quantize-once-at-owner).
    st = RecvFrom(group[0], wire.data(), wb, "ps bcast recv");
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompress(c, wire.data(), count, buf);
    }
    TraceHop("DEQUANTIZE", -1, -1, raw_bytes, dt0, io_ctl_.WaitUs());
    return Status::OK();
  }
  std::vector<uint8_t> peer_wire(static_cast<size_t>(wb));
  for (int j = 1; j < gs; ++j) {
    Status st = RecvFrom(group[j], peer_wire.data(), wb, "ps gather recv");
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompressAdd(c, peer_wire.data(), count, buf);
    }
    TraceHop("DEQUANTIZE", -1, -1, raw_bytes, dt0, io_ctl_.WaitUs());
  }
  // The root quantizes the reduced vector ONCE (self-decoding its own
  // copy) and ships the identical wire bytes to every worker.
  const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  {
    ProfPhaseScope prof_codec(PerfPhase::CODEC);
    WireCompress(c, buf, count, wire.data(), op_residual_, buf, op_quality_);
  }
  TraceHop("QUANTIZE", -1, -1, raw_bytes, qt0, io_ctl_.WaitUs());
  for (int j = 1; j < gs; ++j) {
    AddOpBytes(raw_bytes, wb);
    Status st = SendTo(group[j], wire.data(), wb, "ps bcast send");
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::HierarchicalAllreduce(void* data, int64_t count,
                                        DataType dtype, ReduceOp op) {
  // Two-level allreduce (reference analog: Horovod's hierarchical NCCL+MPI
  // path, with the fork's SHM lanes carrying the intra-node stages):
  //   1. intra-host ring reduce-scatter over the (shm) local lanes — the
  //      reduction compute parallelizes across the host's ranks;
  //   2. reduced chunks gather to the host leader (lowest local rank);
  //   3. leaders run the flat ring/recursive-doubling over TCP;
  //   4. chunks scatter back from the leader;
  //   5. intra-host ring allgather completes every member's vector.
  // With a single host, stages 2-4 vanish and this is the all-shm ring.
  const std::vector<int>& local = local_group_;
  const int L = static_cast<int>(local.size());
  const int li = GroupIndex(local, rank_);
  const size_t elem = DataTypeSize(dtype);
  uint8_t* buf = static_cast<uint8_t*>(data);
  const bool cross = leaders_.size() > 1;

  std::vector<int64_t> starts = ChunkStarts(count, L);
  auto chunk_ptr = [&](int c) { return buf + starts[c] * elem; };
  auto chunk_bytes = [&](int c) {
    return (starts[c + 1] - starts[c]) * static_cast<int64_t>(elem);
  };
  // Chunk owned by local member j after the reduce-scatter phase.
  auto owned = [&](int j) { return (j + 1) % L; };

  if (L > 1) {
    Status st = RingReduceScatterPhase(buf, starts, elem, dtype, op, local, li);
    if (!st.ok()) return st;
  }
  if (cross) {
    if (L > 1) {
      if (li == 0) {
        for (int j = 1; j < L; ++j) {
          int c = owned(j);
          Status st = RecvFrom(local[j], chunk_ptr(c), chunk_bytes(c),
                               "hier leader gather");
          if (!st.ok()) return st;
        }
      } else {
        int c = owned(li);
        AddOpBytes(chunk_bytes(c), chunk_bytes(c));
        Status st = SendTo(local[0], chunk_ptr(c), chunk_bytes(c),
                           "hier leader gather");
        if (!st.ok()) return st;
      }
    }
    if (li == 0) {
      // The leader phase inherits the op's compression: the cross-host hop
      // is the slow link the reference fork quantizes (intra-host shm
      // stages stay dense).
      Status st = AllreduceGroup(data, count, dtype, op, leaders_);
      if (!st.ok()) return st;
    }
    if (L > 1) {
      if (li == 0) {
        for (int j = 1; j < L; ++j) {
          int c = owned(j);
          AddOpBytes(chunk_bytes(c), chunk_bytes(c));
          Status st = SendTo(local[j], chunk_ptr(c), chunk_bytes(c),
                             "hier leader scatter");
          if (!st.ok()) return st;
        }
      } else {
        int c = owned(li);
        Status st = RecvFrom(local[0], chunk_ptr(c), chunk_bytes(c),
                             "hier leader scatter");
        if (!st.ok()) return st;
      }
    }
  }
  if (L > 1) {
    Status st = RingAllgatherPhase(buf, starts, elem, local, li);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::Allgatherv(const void* in, int64_t in_bytes,
                             const std::vector<int64_t>& block_bytes,
                             ByteBuf* out) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "none";
  trace_op_ = false;
  std::vector<int64_t> offsets(size_ + 1, 0);
  for (int r = 0; r < size_; ++r) offsets[r + 1] = offsets[r] + block_bytes[r];
  out->resize(static_cast<size_t>(offsets[size_]));
  memcpy(out->data() + offsets[rank_], in, static_cast<size_t>(in_bytes));
  if (size_ == 1 || offsets[size_] == 0) {
    // No hops; see Allreduce — ObserveOp still reads the accumulators.
    ResetOpPhaseAccum();
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  Status st;
  if (op_comp_ != WireCompression::NONE) {
    // Compression requires the ring: quantize-once owner codes only stay
    // identical world-wide when every hop forwards them verbatim. The core
    // arms the mode for fp32 payloads only (EffectiveCompression).
    last_algo_label_ = "ring";
    st = CompressedRingAllgatherv(offsets, block_bytes, out->data());
  } else if (offsets[size_] > crossover_bytes_) {
    // Bandwidth path: store-and-forward over neighbor lanes only — big
    // gathers ride the shm/zero-copy neighbor lanes instead of opening all
    // n-1 TCP streams at once.
    last_algo_label_ = "ring";
    st = RingAllgathervPhase(offsets, block_bytes, out->data());
  } else {
    // Latency path: direct pairwise rotation — step k sends my block to
    // rank (rank+k), receives the block of rank (rank-k); every block
    // travels exactly one hop.
    last_algo_label_ = "direct";
    st = Status::OK();
    for (int k = 1; k < size_; ++k) {
      int to = (rank_ + k) % size_;
      int from = (rank_ - k + size_) % size_;
      AddOpBytes(in_bytes, in_bytes);
      st = Exchange(to, in, in_bytes, from,
                    out->data() + offsets[from], block_bytes[from]);
      if (!st.ok()) break;
    }
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  if (corrupt_pending_ && st.ok() && !out->empty()) {
    // Seeded SDC (HVDTPU_CHAOS corrupt@op=N): flip one byte of the gathered
    // output — the divergence probe fingerprints allgather results too.
    corrupt_pending_ = false;
    out->data()[0] ^= 0x01;
  }
  return st;
}

Status DataPlane::RingAllgathervPhase(const std::vector<int64_t>& offsets,
                                      const std::vector<int64_t>& block_bytes,
                                      uint8_t* out) {
  const int right = (rank_ + 1) % size_;
  const int left = (rank_ - 1 + size_) % size_;
  // Standard ring allgather generalized to ragged blocks: at step s forward
  // block (rank - s) — own block first, then whatever just arrived — and
  // receive block (rank - s - 1) straight into its slot.
  for (int s = 0; s < size_ - 1; ++s) {
    const int send_b = ((rank_ - s) % size_ + size_) % size_;
    const int recv_b = ((rank_ - s - 1) % size_ + size_) % size_;
    AddOpBytes(block_bytes[send_b], block_bytes[send_b]);
    Status st = Exchange(right, out + offsets[send_b], block_bytes[send_b],
                         left, out + offsets[recv_b], block_bytes[recv_b]);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status DataPlane::CompressedRingAllgatherv(
    const std::vector<int64_t>& offsets,
    const std::vector<int64_t>& block_bytes, uint8_t* out) {
  const WireCompression c = op_comp_;
  const int right = (rank_ + 1) % size_;
  const int left = (rank_ - 1 + size_) % size_;
  auto block_count = [&](int b) {
    return block_bytes[b] / static_cast<int64_t>(sizeof(float));
  };
  int64_t max_count = 0;
  for (int b = 0; b < size_; ++b) {
    max_count = std::max(max_count, block_count(b));
  }
  std::vector<uint8_t> cur(static_cast<size_t>(WireBytes(c, max_count)));
  std::vector<uint8_t> next(cur.size());

  // Quantize-once at the owner, exactly like the compressed ring
  // allreduce's allgather phase: my block's codes are produced here (no
  // error-feedback residual — an allgather payload is a value, not a
  // gradient stream) with self-decode, so my own copy holds the same lossy
  // values every receiver will decode; each later hop forwards the codes
  // verbatim and the gathered vectors agree bitwise world-wide.
  float* own = reinterpret_cast<float*>(out + offsets[rank_]);
  const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
  {
    ProfPhaseScope prof_codec(PerfPhase::CODEC);
    WireCompress(c, own, block_count(rank_), cur.data(), nullptr, own,
                 op_quality_);
  }
  TraceHop("QUANTIZE", -1, -1, block_bytes[rank_], qt0, io_ctl_.WaitUs());
  for (int s = 0; s < size_ - 1; ++s) {
    const int send_b = ((rank_ - s) % size_ + size_) % size_;
    const int recv_b = ((rank_ - s - 1) % size_ + size_) % size_;
    const int64_t sw = WireBytes(c, block_count(send_b));
    const int64_t rw = WireBytes(c, block_count(recv_b));
    AddOpBytes(block_bytes[send_b], sw);
    Status st = Exchange(right, cur.data(), sw, left, next.data(), rw);
    if (!st.ok()) return st;
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompress(c, next.data(), block_count(recv_b),
                     reinterpret_cast<float*>(out + offsets[recv_b]));
    }
    TraceHop("DEQUANTIZE", -1, -1, block_bytes[recv_b], dt0,
             io_ctl_.WaitUs());
    cur.swap(next);
  }
  return Status::OK();
}

Status DataPlane::BinomialBroadcastSchedule(void* buf, int64_t wire_bytes,
                                            int64_t raw_per_send, int root) {
  // MPICH binomial schedule on virtual ranks (vr 0 = root): receive from
  // vr minus its lowest set bit, then forward down the descending masks —
  // every rank is live after ⌈log2 n⌉ rounds and forwards at most that many
  // copies, vs the flat root shipping n-1 serialized full payloads.
  const int vr = (rank_ - root + size_) % size_;
  int mask = 1;
  while (mask < size_) {
    if (vr & mask) {
      const int src = (rank_ - mask + size_) % size_;
      Status st = RecvFrom(src, buf, wire_bytes, "broadcast recv");
      if (!st.ok()) return st;
      break;
    }
    mask <<= 1;
  }
  mask >>= 1;
  while (mask > 0) {
    if (vr + mask < size_) {
      const int dst = (rank_ + mask) % size_;
      AddOpBytes(raw_per_send, wire_bytes);
      Status st = SendTo(dst, buf, wire_bytes, "broadcast send");
      if (!st.ok()) return st;
    }
    mask >>= 1;
  }
  return Status::OK();
}

Status DataPlane::FlatBroadcastSchedule(void* buf, int64_t wire_bytes,
                                        int64_t raw_per_send, int root) {
  if (rank_ == root) {
    for (int r = 0; r < size_; ++r) {
      if (r == rank_) continue;
      AddOpBytes(raw_per_send, wire_bytes);
      Status st = SendTo(r, buf, wire_bytes, "broadcast send");
      if (!st.ok()) return st;
    }
    return Status::OK();
  }
  return RecvFrom(root, buf, wire_bytes, "broadcast recv");
}

Status DataPlane::CompressedBroadcast(float* data, int64_t count, int root,
                                      bool flat) {
  // Quantize ONCE at the root with self-decode (owner-codes
  // pattern; no error-feedback residual — a broadcast payload is a value,
  // not a gradient stream), forward the codes verbatim, decode everywhere:
  // every rank ends up decoding the identical byte stream, so the broadcast
  // is bitwise identical world-wide even under int4.
  const WireCompression c = op_comp_;
  const int64_t raw = count * static_cast<int64_t>(sizeof(float));
  std::vector<uint8_t> codes(static_cast<size_t>(WireBytes(c, count)));
  if (rank_ == root) {
    const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireCompress(c, data, count, codes.data(), nullptr, data, op_quality_);
    }
    TraceHop("QUANTIZE", -1, -1, raw, qt0, io_ctl_.WaitUs());
  }
  Status st =
      flat ? FlatBroadcastSchedule(codes.data(), WireBytes(c, count), raw,
                                   root)
           : BinomialBroadcastSchedule(codes.data(), WireBytes(c, count), raw,
                                       root);
  if (!st.ok()) return st;
  if (rank_ != root) {
    // Decode AFTER the forwards: children must see the owner's codes
    // verbatim, never a re-quantization of this rank's decoded copy.
    const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireDecompress(c, codes.data(), count, data);
    }
    TraceHop("DEQUANTIZE", -1, -1, raw, dt0, io_ctl_.WaitUs());
  }
  return Status::OK();
}

Status DataPlane::Broadcast(void* data, int64_t bytes, int root) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "none";
  trace_op_ = false;
  if (size_ == 1 || bytes == 0) {
    ResetOpPhaseAccum();  // ObserveOp reads the accumulators regardless
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  // Latency floor: at or below bcast_flat_max_ the root's n-1 direct sends
  // beat the tree's serialized store-and-forward rounds (one hop of depth
  // per peer vs ⌈log2 n⌉ handoffs of a payload too small to pipeline).
  const bool flat = bytes <= bcast_flat_max_;
  Status st;
  if (op_comp_ != WireCompression::NONE) {
    // The core arms compression for fp32 payloads only (EffectiveCompression),
    // so the element count is exact.
    last_algo_label_ = flat ? "bcast_flat" : "bcast_tree";
    st = CompressedBroadcast(static_cast<float*>(data),
                             bytes / static_cast<int64_t>(sizeof(float)),
                             root, flat);
  } else if (flat) {
    last_algo_label_ = "bcast_flat";
    st = FlatBroadcastSchedule(data, bytes, bytes, root);
  } else {
    last_algo_label_ = "bcast_tree";
    st = BinomialBroadcastSchedule(data, bytes, bytes, root);
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  if (corrupt_pending_ && st.ok()) {
    // Seeded SDC (HVDTPU_CHAOS corrupt@op=N): flip one byte of this rank's
    // broadcast output — the divergence probe fingerprints broadcast
    // results too (every rank holds bitwise-identical bytes).
    corrupt_pending_ = false;
    static_cast<uint8_t*>(data)[0] ^= 0x01;
  }
  return st;
}

Status DataPlane::CompressedAlltoallv(const float* in,
                                      const std::vector<int64_t>& send_off,
                                      const std::vector<int64_t>& recv_off,
                                      uint8_t* out) {
  // Every block travels exactly one hop, so the sender quantizes it once
  // for its single receiver — no forwarding discipline needed for
  // determinism. The self block rides the same quantize/self-decode
  // roundtrip (straight into `out`), so every block a rank holds is
  // uniformly lossy: symmetric inputs still produce world-bitwise outputs.
  const WireCompression c = op_comp_;
  const int64_t felem = static_cast<int64_t>(sizeof(float));
  auto scount = [&](int r) { return (send_off[r + 1] - send_off[r]) / felem; };
  auto rcount = [&](int r) { return (recv_off[r + 1] - recv_off[r]) / felem; };
  int64_t max_count = 0;
  for (int r = 0; r < size_; ++r) {
    max_count = std::max(max_count, std::max(scount(r), rcount(r)));
  }
  std::vector<uint8_t> scodes(static_cast<size_t>(WireBytes(c, max_count)));
  std::vector<uint8_t> rcodes(scodes.size());
  if (scount(rank_) > 0) {
    const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
    {
      ProfPhaseScope prof_codec(PerfPhase::CODEC);
      WireCompress(c, in + send_off[rank_] / felem, scount(rank_),
                   scodes.data(), nullptr,
                   reinterpret_cast<float*>(out + recv_off[rank_]),
                   op_quality_);
    }
    TraceHop("QUANTIZE", -1, -1, scount(rank_) * felem, qt0,
             io_ctl_.WaitUs());
  }
  for (int k = 1; k < size_; ++k) {
    const int to = (rank_ + k) % size_;
    const int from = (rank_ - k + size_) % size_;
    const int64_t sw = WireBytes(c, scount(to));
    const int64_t rw = WireBytes(c, rcount(from));
    if (scount(to) > 0) {
      const int64_t qt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      {
        ProfPhaseScope prof_codec(PerfPhase::CODEC);
        WireCompress(c, in + send_off[to] / felem, scount(to), scodes.data(),
                     nullptr, nullptr, op_quality_);
      }
      TraceHop("QUANTIZE", -1, -1, scount(to) * felem, qt0, io_ctl_.WaitUs());
    }
    AddOpBytes(scount(to) * felem, scount(to) > 0 ? sw : 0);
    Status st = Exchange(to, scodes.data(), scount(to) > 0 ? sw : 0, from,
                         rcodes.data(), rcount(from) > 0 ? rw : 0);
    if (!st.ok()) return st;
    if (rcount(from) > 0) {
      const int64_t dt0 = rec_hops_ ? Timeline::SteadyAbsUs() : 0;
      {
        ProfPhaseScope prof_codec(PerfPhase::CODEC);
        WireDecompress(c, rcodes.data(), rcount(from),
                       reinterpret_cast<float*>(out + recv_off[from]));
      }
      TraceHop("DEQUANTIZE", -1, -1, rcount(from) * felem, dt0,
               io_ctl_.WaitUs());
    }
  }
  return Status::OK();
}

Status DataPlane::Alltoallv(const void* in,
                            const std::vector<int64_t>& send_bytes,
                            const std::vector<int64_t>& recv_bytes,
                            ByteBuf* out) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "none";
  trace_op_ = false;
  std::vector<int64_t> send_off(size_ + 1, 0), recv_off(size_ + 1, 0);
  for (int r = 0; r < size_; ++r) {
    send_off[r + 1] = send_off[r] + send_bytes[r];
    recv_off[r + 1] = recv_off[r] + recv_bytes[r];
  }
  out->resize(static_cast<size_t>(recv_off[size_]));
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (size_ == 1) {
    memcpy(out->data(), src + send_off[rank_],
           static_cast<size_t>(send_bytes[rank_]));
    ResetOpPhaseAccum();  // ObserveOp reads the accumulators regardless
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  last_algo_label_ = "pairwise";
  Status st;
  if (op_comp_ != WireCompression::NONE) {
    st = CompressedAlltoallv(reinterpret_cast<const float*>(in), send_off,
                             recv_off, out->data());
  } else {
    memcpy(out->data() + recv_off[rank_], src + send_off[rank_],
           static_cast<size_t>(send_bytes[rank_]));
    st = Status::OK();
    for (int k = 1; k < size_; ++k) {
      int to = (rank_ + k) % size_;
      int from = (rank_ - k + size_) % size_;
      AddOpBytes(send_bytes[to], send_bytes[to]);
      st = Exchange(to, src + send_off[to], send_bytes[to], from,
                    out->data() + recv_off[from], recv_bytes[from]);
      if (!st.ok()) break;
    }
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  if (corrupt_pending_ && st.ok() && !out->empty()) {
    // Seeded SDC in this rank's routed output (docs/numerics.md).
    corrupt_pending_ = false;
    out->data()[0] ^= 0x01;
  }
  return st;
}

namespace {

template <typename T>
void AdasumCombine(T* mine, const T* other, int64_t count, bool i_am_lower) {
  double dot = 0, mine2 = 0, theirs2 = 0;
  for (int64_t i = 0; i < count; ++i) {
    dot += static_cast<double>(mine[i]) * static_cast<double>(other[i]);
    mine2 += static_cast<double>(mine[i]) * static_cast<double>(mine[i]);
    theirs2 += static_cast<double>(other[i]) * static_cast<double>(other[i]);
  }
  double na2 = i_am_lower ? mine2 : theirs2;
  double nb2 = i_am_lower ? theirs2 : mine2;
  double a_coeff = na2 == 0 ? 1.0 : 1.0 - dot / (2.0 * na2);
  double b_coeff = nb2 == 0 ? 1.0 : 1.0 - dot / (2.0 * nb2);
  double my_coeff = i_am_lower ? a_coeff : b_coeff;
  double their_coeff = i_am_lower ? b_coeff : a_coeff;
  for (int64_t i = 0; i < count; ++i) {
    mine[i] = static_cast<T>(my_coeff * static_cast<double>(mine[i]) +
                             their_coeff * static_cast<double>(other[i]));
  }
}

template <typename T>
void AddInto(T* dst, const T* src, int64_t count) {
  for (int64_t i = 0; i < count; ++i) dst[i] += src[i];
}

}  // namespace

Status DataPlane::AdasumAllreduce(void* data, int64_t count, DataType dtype) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "adasum";
  trace_op_ = false;
  if (dtype != DataType::FLOAT32 && dtype != DataType::FLOAT64) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "Adasum supports float32/float64 only, got " +
                             std::string(DataTypeName(dtype)));
  }
  if (size_ == 1 || count == 0) {
    ResetOpPhaseAccum();  // ObserveOp reads the accumulators regardless
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  const size_t elem = DataTypeSize(dtype);
  const int64_t bytes = count * static_cast<int64_t>(elem);
  std::vector<uint8_t> other(static_cast<size_t>(bytes));

  int p = 1;
  while (p * 2 <= size_) p *= 2;
  const int r = size_ - p;

  auto exchange = [&](int peer) -> Status {
    AddOpBytes(bytes, bytes);
    return Exchange(peer, data, bytes, peer, other.data(), bytes);
  };
  auto combine = [&](bool lower) {
    if (dtype == DataType::FLOAT32) {
      AdasumCombine(static_cast<float*>(data),
                    reinterpret_cast<const float*>(other.data()), count, lower);
    } else {
      AdasumCombine(static_cast<double*>(data),
                    reinterpret_cast<const double*>(other.data()), count,
                    lower);
    }
  };

  // Fold extra ranks (>= p) into their partner by plain addition.
  if (rank_ >= p) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(rank_ - p, data, bytes, "adasum fold send");
    if (!st.ok()) return st;
  } else if (rank_ < r) {
    Status st = RecvFrom(rank_ + p, other.data(), bytes, "adasum fold recv");
    if (!st.ok()) return st;
    if (dtype == DataType::FLOAT32) {
      AddInto(static_cast<float*>(data),
              reinterpret_cast<const float*>(other.data()), count);
    } else {
      AddInto(static_cast<double*>(data),
              reinterpret_cast<const double*>(other.data()), count);
    }
  }

  if (rank_ < p) {
    for (int distance = 1; distance < p; distance *= 2) {
      int peer = rank_ ^ distance;
      Status st = exchange(peer);
      if (!st.ok()) return st;
      combine((rank_ & distance) == 0);
    }
  }

  // Broadcast the result to the folded ranks.
  if (rank_ < r) {
    AddOpBytes(bytes, bytes);
    Status st = SendTo(rank_ + p, data, bytes, "adasum unfold send");
    if (!st.ok()) return st;
  } else if (rank_ >= p) {
    Status st = RecvFrom(rank_ - p, data, bytes, "adasum unfold recv");
    if (!st.ok()) return st;
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  return Status::OK();
}

Status DataPlane::ReduceScatter(const void* in, int64_t count, DataType dtype,
                                ReduceOp op, ByteBuf* out) {
  op_raw_bytes_ = 0;
  op_wire_bytes_ = 0;
  last_algo_label_ = "none";
  trace_op_ = false;
  const size_t elem = DataTypeSize(dtype);
  if (size_ == 1) {
    out->resize(static_cast<size_t>(count) * elem);
    memcpy(out->data(), in, out->size());
    ResetOpPhaseAccum();  // ObserveOp reads the accumulators regardless
    return Status::OK();
  }
  if (count == 0) {
    out->clear();
    ResetOpPhaseAccum();
    return Status::OK();
  }
  BeginOpTrace();
  MaybeChaosOp();
  // The ring reduces in place: stage the input in a full-length scratch
  // (the caller's buffer is const and may be the user's pinned array).
  std::vector<uint8_t> work(static_cast<size_t>(count) * elem);
  memcpy(work.data(), in, work.size());
  // The ring's reduce-scatter phase with PUBLIC chunk ownership: the phase
  // leaves member gi owning chunk (gi+1) % gs, so run it over the rotated
  // group [1, 2, ..., n-1, 0]. Rank r sits at group index (r-1+n)%n and
  // therefore owns chunk r — while its physical ring neighbors (right =
  // r+1, left = r-1) are exactly the flat ring's, so the segmented
  // exchanges, shm in-place views and zero-copy lanes are reused unchanged.
  std::vector<int> rot(size_);
  for (int i = 0; i < size_; ++i) rot[i] = (i + 1) % size_;
  const int gi = (rank_ - 1 + size_) % size_;
  std::vector<int64_t> starts = ChunkStarts(count, size_);
  last_algo_label_ = "ring";
  Status st;
  if (CompressionActive(dtype, op)) {
    st = CompressedRingReduceScatter(reinterpret_cast<float*>(work.data()),
                                     starts, rot, gi);
  } else {
    st = RingReduceScatterPhase(work.data(), starts, elem, dtype, op, rot,
                                gi);
  }
  if (st.ok()) {
    out->assign(
        work.begin() + starts[rank_] * static_cast<int64_t>(elem),
        work.begin() + starts[rank_ + 1] * static_cast<int64_t>(elem));
  }
  raw_bytes_total_->Add(op_raw_bytes_);
  wire_bytes_total_->Add(op_wire_bytes_);
  PublishZeroCopyCounters();
  if (corrupt_pending_ && st.ok() && !out->empty()) {
    // Seeded SDC in this rank's reduced chunk (docs/numerics.md).
    corrupt_pending_ = false;
    out->data()[0] ^= 0x01;
  }
  return st;
}

}  // namespace hvdtpu
