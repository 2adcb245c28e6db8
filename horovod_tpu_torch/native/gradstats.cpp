#include "gradstats.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>

#include "compressed.h"  // WireCompression / WireCompressionName
#include "perfstats.h"   // JsonEscapeString

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace hvdtpu {

const char* NanPolicyName(NanPolicy p) {
  switch (p) {
    case NanPolicy::OFF:
      return "off";
    case NanPolicy::WARN:
      return "warn";
    case NanPolicy::ABORT:
      return "abort";
  }
  return "?";
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli)
// ---------------------------------------------------------------------------

namespace {

// Software slice-by-1 table for the reflected Castagnoli polynomial
// 0x82F63B78, built once. The hardware path below covers every modern x86;
// the table keeps non-SSE4.2 hosts (and other arches) correct, if slower.
const uint32_t* Crc32cTable() {
  static const uint32_t* table = [] {
    static uint32_t t[256];
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) {
        c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      }
      t[i] = c;
    }
    return t;
  }();
  return table;
}

#if defined(__x86_64__)
bool HaveSse42() {
  static const bool ok = __builtin_cpu_supports("sse4.2") != 0;
  return ok;
}

__attribute__((target("sse4.2")))
uint32_t Crc32cHw(const uint8_t* p, size_t len, uint32_t crc) {
  while (len >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
    p += 8;
    len -= 8;
  }
  while (len > 0) {
    crc = _mm_crc32_u8(crc, *p);
    ++p;
    --len;
  }
  return crc;
}
#endif

}  // namespace

uint32_t Crc32c(const void* data, size_t len, uint32_t seed) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint32_t crc = ~seed;
#if defined(__x86_64__)
  if (HaveSse42()) return ~Crc32cHw(p, len, crc);
#endif
  const uint32_t* t = Crc32cTable();
  for (size_t i = 0; i < len; ++i) {
    crc = t[(crc ^ p[i]) & 0xff] ^ (crc >> 8);
  }
  return ~crc;
}

// ---------------------------------------------------------------------------
// Moments kernels
// ---------------------------------------------------------------------------

namespace {



void MomentsF32Scalar(const float* src, int64_t count, GradMoments* m) {
  double sumsq = 0, absmax = m->absmax;
  int64_t nonfinite = 0;
  for (int64_t i = 0; i < count; ++i) {
    const float x = src[i];
    if (std::isfinite(x)) {
      sumsq += static_cast<double>(x) * static_cast<double>(x);
      const double a = std::fabs(static_cast<double>(x));
      if (a > absmax) absmax = a;
    } else {
      ++nonfinite;
    }
  }
  m->sumsq += sumsq;
  m->absmax = absmax;
  m->nonfinite += nonfinite;
  m->count += count;
}

#if defined(__x86_64__)
bool MomentsHaveAvx2() {
  static const bool ok = __builtin_cpu_supports("avx2") != 0;
  return ok;
}

// Fast 16-lane scan with optional fused copy (regular stores ONLY — a
// streaming-store variant was tried and REJECTED by the paired A/B: the
// collective re-reads this buffer chunk by chunk right after the copy,
// and NT stores cost 0.75x/0.87x at 16/64 MB in post-copy misses,
// BENCH_r10.json). The hot loop is UNMASKED — load, (store,) fmadd,
// and+max; five vector ops per 16 floats, cheap enough to ride a
// memory-bound copy even on a CPU-oversubscribed box (the earlier
// masked/movemask variant cost a visible fraction of the op under
// 4-ranks-per-core contention). The non-finite check is LAZY: any
// NaN/Inf input makes the accumulated sumsq non-finite (x*x propagates
// NaN and Inf through fmadd) — the wrapper detects that and reruns the
// precise masked pass, so clean tensors (the overwhelmingly common case)
// pay nothing for the sentinel. Block-local float accumulators drain
// into the double total every 4096 lanes so a 16M-element tensor loses
// no precision.
template <bool kCopy>
__attribute__((target("avx2,fma")))
void MomentsF32FastAvx2(float* dst, const float* src, int64_t count,
                        double* sumsq_out, double* absmax_out) {
  const __m256 abs_mask =
      _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
  double sumsq = 0;
  __m256 vmax0 = _mm256_setzero_ps(), vmax1 = _mm256_setzero_ps();
  int64_t i = 0;
  while (i + 16 <= count) {
    const int64_t block_end = std::min<int64_t>(count - 15, i + 4096);
    __m256 vsum0 = _mm256_setzero_ps(), vsum1 = _mm256_setzero_ps();
    for (; i < block_end; i += 16) {
      __m256 x0 = _mm256_loadu_ps(src + i);
      __m256 x1 = _mm256_loadu_ps(src + i + 8);
      if (kCopy) {
        _mm256_storeu_ps(dst + i, x0);
        _mm256_storeu_ps(dst + i + 8, x1);
      }
      vsum0 = _mm256_fmadd_ps(x0, x0, vsum0);
      vsum1 = _mm256_fmadd_ps(x1, x1, vsum1);
      vmax0 = _mm256_max_ps(vmax0, _mm256_and_ps(x0, abs_mask));
      vmax1 = _mm256_max_ps(vmax1, _mm256_and_ps(x1, abs_mask));
    }
    alignas(32) float tmp[8];
    _mm256_store_ps(tmp, _mm256_add_ps(vsum0, vsum1));
    for (int k = 0; k < 8; ++k) sumsq += tmp[k];
  }
  alignas(32) float tmp[8];
  _mm256_store_ps(tmp, _mm256_max_ps(vmax0, vmax1));
  double absmax = 0;
  bool max_nan = false;
  for (int k = 0; k < 8; ++k) {
    if (tmp[k] != tmp[k]) max_nan = true;
    if (tmp[k] > absmax) absmax = tmp[k];
  }
  for (; i < count; ++i) {
    const float x = src[i];
    if (kCopy) dst[i] = x;
    sumsq += static_cast<double>(x) * static_cast<double>(x);
    const double a = std::fabs(static_cast<double>(x));
    if (a > absmax) absmax = a;
    if (x != x) max_nan = true;
  }
  *sumsq_out = sumsq;
  // A NaN lane can slip through max_ps (max(acc, NaN) takes the second
  // operand, but max(NaN, x) later drops it) — surface it through absmax
  // so the wrapper's non-finite detection stays sound.
  *absmax_out = max_nan
                    ? std::numeric_limits<double>::quiet_NaN()
                    : absmax;
}

// Detect-and-redo wrapper: run the fast unmasked kernel; when its totals
// came back non-finite (some input was NaN/Inf — or a square overflowed
// fp32, which the precise double-accumulating pass also repairs), rescan
// with the exact masked scalar pass. Copying is complete either way.
template <bool kCopy>
void MomentsF32Fast(float* dst, const float* src, int64_t count,
                    GradMoments* m) {
  double sumsq = 0, absmax = 0;
  MomentsF32FastAvx2<kCopy>(dst, src, count, &sumsq, &absmax);
  if (!std::isfinite(sumsq) || !std::isfinite(absmax)) {
    MomentsF32Scalar(src, count, m);  // exact: masked + counted
    return;
  }
  m->sumsq += sumsq;
  if (absmax > m->absmax) m->absmax = absmax;
  m->count += count;
}
#endif  // __x86_64__

}  // namespace

void MomentsF32(const float* src, int64_t count, GradMoments* m) {
  if (count <= 0) return;
#if defined(__x86_64__)
  if (MomentsHaveAvx2()) {
    MomentsF32Fast<false>(nullptr, src, count, m);
    return;
  }
#endif
  MomentsF32Scalar(src, count, m);
}

void CopyMomentsF32(float* dst, const float* src, int64_t count,
                    GradMoments* m) {
  if (count <= 0) return;
#if defined(__x86_64__)
  if (MomentsHaveAvx2()) {
    MomentsF32Fast<true>(dst, src, count, m);
    return;
  }
#endif
  memcpy(dst, src, static_cast<size_t>(count) * 4);
  MomentsF32Scalar(src, count, m);
}

// ---------------------------------------------------------------------------
// GradStats
// ---------------------------------------------------------------------------

namespace {

// Writer-side spinlock guard, same single-writer rationale as perfstats.cpp.
class GradSlotLock {
 public:
  explicit GradSlotLock(GradSlot* s) : s_(s) {
    while (s_->lock.test_and_set(std::memory_order_acquire)) {
    }
  }
  ~GradSlotLock() { s_->lock.clear(std::memory_order_release); }

 private:
  GradSlot* s_;
};

// JSON number, clamped finite (JSON has no inf/nan; a degenerate SNR of an
// all-zero tensor renders as 0).
std::string GNum(double v) {
  if (!std::isfinite(v)) return "0";
  char buf[64];
  // Magnitude gate BEFORE the int64 cast: casting a double >= 2^63 to
  // int64_t is UB ([conv.fpint]) and gradient norms/MSE are unbounded —
  // a pre-divergence absmax of 1e20 must render, not trip UBSan.
  if (std::abs(v) < 1e15 &&
      v == static_cast<double>(static_cast<int64_t>(v))) {
    snprintf(buf, sizeof(buf), "%lld",
             static_cast<long long>(static_cast<int64_t>(v)));
  } else {
    snprintf(buf, sizeof(buf), "%.9g", v);
  }
  return buf;
}

}  // namespace

void GradStats::Configure(bool enabled, NanPolicy policy, int64_t sample_n) {
  enabled_ = enabled;
  policy_ = policy;
  sample_n_ = sample_n > 0 ? sample_n : 0;
  if (!enabled_) return;
  slots_.reset(new GradSlot[kGradMaxKeys]);
  slots_[0].key = "<keys-overflowed>";
  key_ids_.clear();
  nslots_.store(1, std::memory_order_release);
  nonfinite_total_.store(0, std::memory_order_relaxed);
  probes_total_.store(0, std::memory_order_relaxed);
  divergence_total_.store(0, std::memory_order_relaxed);
  residual_resets_total_.store(0, std::memory_order_relaxed);
}

int GradStats::KeySlot(const std::string& key) {
  if (!enabled_) return 0;
  auto it = key_ids_.find(key);
  if (it != key_ids_.end()) return it->second;
  const int n = nslots_.load(std::memory_order_relaxed);  // atomic-ok: single-writer reads its own count
  if (n >= kGradMaxKeys) return 0;  // table full: share the overflow slot
  slots_[n].key = key;
  nslots_.store(n + 1, std::memory_order_release);  // publish complete slot
  key_ids_.emplace(key, n);
  return n;
}

void GradStats::RecordMoments(int slot, const GradMoments& m) {
  if (!enabled_ || slot < 0 ||
      slot >= nslots_.load(std::memory_order_acquire) || m.count <= 0) {
    return;
  }
  GradSlot* sl = &slots_[slot];
  const double norm = std::sqrt(m.sumsq);
  GradSlotLock lk(sl);
  const int64_t n = sl->count.load(std::memory_order_relaxed);
  // EWMA warmup: running mean first, then alpha = 0.1 (perfstats.cpp
  // rationale — the very first step must not pin the baseline).
  const double alpha = std::max(0.1, 1.0 / static_cast<double>(n + 1));
  sl->ewma_norm =
      n == 0 ? norm : sl->ewma_norm + alpha * (norm - sl->ewma_norm);
  sl->pub_norm.store(norm, std::memory_order_relaxed);
  sl->pub_ewma_norm.store(sl->ewma_norm, std::memory_order_relaxed);
  sl->pub_absmax.store(m.absmax, std::memory_order_relaxed);
  if (m.nonfinite > 0) {
    sl->nonfinite.fetch_add(m.nonfinite, std::memory_order_relaxed);
  }
  sl->count.store(n + 1, std::memory_order_relaxed);
}

void GradStats::RecordQuality(int slot, WireCompression c,
                              const GradQuality& q) {
  if (!enabled_ || slot < 0 ||
      slot >= nslots_.load(std::memory_order_acquire) || q.count <= 0) {
    return;
  }
  GradSlot* sl = &slots_[slot];
  const double mse = q.err2 / static_cast<double>(q.count);
  // SNR of a perfectly-represented signal (err2 == 0, e.g. fp16 codes of
  // exactly-representable values) is unbounded; clamp at a recognizable
  // ceiling so the JSON stays finite and comparisons stay ordered.
  const double snr_db =
      q.err2 > 0 ? 10.0 * std::log10(q.sig2 > 0 ? q.sig2 / q.err2 : 1.0)
                 : 200.0;
  GradSlotLock lk(sl);
  const int64_t n = sl->q_count.load(std::memory_order_relaxed);
  const double alpha = std::max(0.1, 1.0 / static_cast<double>(n + 1));
  sl->ewma_snr_db =
      n == 0 ? snr_db : sl->ewma_snr_db + alpha * (snr_db - sl->ewma_snr_db);
  sl->pub_mse.store(mse, std::memory_order_relaxed);
  sl->pub_snr_db.store(snr_db, std::memory_order_relaxed);
  sl->pub_ewma_snr_db.store(sl->ewma_snr_db, std::memory_order_relaxed);
  sl->pub_res_norm.store(std::sqrt(q.err2), std::memory_order_relaxed);
  sl->comp.store(static_cast<int32_t>(c), std::memory_order_relaxed);
  sl->q_count.store(n + 1, std::memory_order_relaxed);
}

bool GradStats::ShouldWarnNonfinite(int slot, int64_t now_us,
                                    int64_t min_gap_us) {
  if (!enabled_ || slot < 0 ||
      slot >= nslots_.load(std::memory_order_acquire)) {
    return false;
  }
  GradSlot* sl = &slots_[slot];
  int64_t last = sl->last_warn_us.load(std::memory_order_relaxed);
  while (last == 0 || now_us - last >= min_gap_us) {
    if (sl->last_warn_us.compare_exchange_weak(last, now_us,
                                               std::memory_order_relaxed)) {
      return true;
    }
  }
  return false;
}

std::string GradStats::SnapshotJson() const {
  std::string out = "{\"version\": 1, \"enabled\": ";
  out += enabled_ ? "true" : "false";
  out += ", \"nancheck\": \"";
  out += NanPolicyName(policy_);
  out += "\", \"gradcheck_sample\": " + GNum(static_cast<double>(sample_n_));
  out += ", \"nonfinite_total\": " +
         GNum(static_cast<double>(nonfinite_total()));
  out += ", \"probes_total\": " + GNum(static_cast<double>(probes_total()));
  out += ", \"divergence_total\": " +
         GNum(static_cast<double>(divergence_total()));
  out += ", \"residual_resets_total\": " +
         GNum(static_cast<double>(residual_resets_total()));
  out += ", \"keys\": [";
  const int n = slot_count();
  bool first = true;
  for (int i = 0; i < n; ++i) {
    const GradSlot& sl = slots_[i];
    const int64_t cnt = sl.count.load(std::memory_order_relaxed);
    const int64_t qcnt = sl.q_count.load(std::memory_order_relaxed);
    if (cnt == 0 && qcnt == 0) continue;  // never hit
    if (!first) out += ", ";
    first = false;
    out += "{\"key\": " + JsonEscapeString(sl.key);
    out += ", \"count\": " + GNum(static_cast<double>(cnt));
    out += ", \"norm\": " +
           GNum(sl.pub_norm.load(std::memory_order_relaxed));
    out += ", \"ewma_norm\": " +
           GNum(sl.pub_ewma_norm.load(std::memory_order_relaxed));
    out += ", \"absmax\": " +
           GNum(sl.pub_absmax.load(std::memory_order_relaxed));
    out += ", \"nonfinite\": " +
           GNum(static_cast<double>(
               sl.nonfinite.load(std::memory_order_relaxed)));
    out += ", \"quant_count\": " + GNum(static_cast<double>(qcnt));
    if (qcnt > 0) {
      // SNR fields exist ONLY for keys the compressed wire actually
      // touched: skip-regex layers (biases/norms) and dense ops stay
      // absent from the per-layer SNR report by construction.
      out += ", \"compression\": \"";
      out += WireCompressionName(static_cast<WireCompression>(
          sl.comp.load(std::memory_order_relaxed)));
      out += "\", \"mse\": " +
             GNum(sl.pub_mse.load(std::memory_order_relaxed));
      out += ", \"snr_db\": " +
             GNum(sl.pub_snr_db.load(std::memory_order_relaxed));
      out += ", \"ewma_snr_db\": " +
             GNum(sl.pub_ewma_snr_db.load(std::memory_order_relaxed));
      out += ", \"residual_norm\": " +
             GNum(sl.pub_res_norm.load(std::memory_order_relaxed));
    }
    out += "}";
  }
  out += "]}";
  return out;
}

}  // namespace hvdtpu
