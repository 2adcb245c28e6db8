#include "compressed.h"

#include <cmath>
#include <cstring>

#include "data_plane.h"  // HalfToFloatPublic / FloatToHalfPublic (RNE)

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace hvdtpu {

namespace {

// Quality accumulation helper (docs/numerics.md): err2 += (x - deq)^2,
// sig2 += x^2, finite terms only — one NaN element (or an fp16 overflow's
// inf diff) must not erase the whole op's SNR; the non-finite elements
// themselves are the NaN sentinel's business, not the quality metric's.
inline void AccumQuality(GradQuality* q, float x, float deq) {
  const float d = x - deq;
  if (d - d == 0.0f && x - x == 0.0f) {  // both finite
    q->err2 += static_cast<double>(d) * static_cast<double>(d);
    q->sig2 += static_cast<double>(x) * static_cast<double>(x);
  }
  ++q->count;
}

#if defined(__x86_64__)
// Drain an 8-lane float product vector into a double accumulator.
__attribute__((target("avx2")))
inline void AccumPd(__m256d* acc, __m256 v) {
  *acc = _mm256_add_pd(*acc, _mm256_cvtps_pd(_mm256_castps256_ps128(v)));
  *acc = _mm256_add_pd(*acc, _mm256_cvtps_pd(_mm256_extractf128_ps(v, 1)));
}

__attribute__((target("avx2")))
inline double HorizontalSumPd(__m256d v) {
  __m128d lo = _mm256_castpd256_pd128(v);
  __m128d hi = _mm256_extractf128_pd(v, 1);
  lo = _mm_add_pd(lo, hi);
  return _mm_cvtsd_f64(lo) + _mm_cvtsd_f64(_mm_unpackhi_pd(lo, lo));
}

bool HaveF16C() {
  // gcc 10's __builtin_cpu_supports has no "f16c"; read CPUID leaf 1 ECX
  // bit 29 directly (same probe as data_plane.cpp).
  static const bool ok = [] {
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    return (ecx & (1u << 29)) != 0 && __builtin_cpu_supports("avx2") != 0;
  }();
  return ok;
}

// 8-lane fp32 -> fp16 -> fp32 cast with optional residual/self-decode, on
// the F16C hardware converters (full IEEE round-to-nearest-even, identical
// to the scalar FloatToHalf path for numeric values).
__attribute__((target("avx2,f16c")))
void Fp16CompressF16C(const float* __restrict__ src, int64_t count,
                      uint16_t* __restrict__ dst, float* __restrict__ residual,
                      float* __restrict__ self_decode,
                      GradQuality* __restrict__ quality) {
  const bool want_back =
      residual != nullptr || self_decode != nullptr || quality != nullptr;
  __m256d qerr = _mm256_setzero_pd();
  __m256d qsig = _mm256_setzero_pd();
  int64_t i = 0;
  for (; i + 8 <= count; i += 8) {
    __m256 x = _mm256_loadu_ps(src + i);
    if (residual != nullptr) {
      x = _mm256_add_ps(x, _mm256_loadu_ps(residual + i));
    }
    __m128i h = _mm256_cvtps_ph(x, _MM_FROUND_TO_NEAREST_INT);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i), h);
    if (want_back) {
      __m256 back = _mm256_cvtph_ps(h);
      // Finite mask over x - back: zero where half-range overflow
      // saturated to inf or a NaN input poisons the diff.
      __m256 r = _mm256_sub_ps(x, back);
      __m256 finite = _mm256_cmp_ps(_mm256_sub_ps(r, r),
                                    _mm256_setzero_ps(), _CMP_EQ_OQ);
      __m256 rf = _mm256_and_ps(r, finite);
      if (residual != nullptr) {
        // Carrying ±inf would poison the element's error feedback
        // permanently — store the filtered diff.
        _mm256_storeu_ps(residual + i, rf);
      }
      if (self_decode != nullptr) _mm256_storeu_ps(self_decode + i, back);
      if (quality != nullptr) {
        // r finite implies x finite (back is never NaN for finite x), so
        // one mask filters both quality terms.
        __m256 xf = _mm256_and_ps(x, finite);
        AccumPd(&qerr, _mm256_mul_ps(rf, rf));
        AccumPd(&qsig, _mm256_mul_ps(xf, xf));
      }
    }
  }
  if (quality != nullptr) {
    quality->err2 += HorizontalSumPd(qerr);
    quality->sig2 += HorizontalSumPd(qsig);
    quality->count += i;
  }
  for (; i < count; ++i) {
    float x = src[i] + (residual != nullptr ? residual[i] : 0.0f);
    uint16_t h = FloatToHalfPublic(x);
    dst[i] = h;
    if (want_back) {
      float back = HalfToFloatPublic(h);
      if (residual != nullptr) {
        float r = x - back;
        residual[i] = std::isfinite(r) ? r : 0.0f;
      }
      if (self_decode != nullptr) self_decode[i] = back;
      if (quality != nullptr) AccumQuality(quality, x, back);
    }
  }
}

__attribute__((target("avx2,f16c")))
void Fp16DecompressF16C(const uint16_t* __restrict__ src, int64_t count,
                        float* __restrict__ dst, bool add) {
  int64_t i = 0;
  for (; i + 8 <= count; i += 8) {
    __m256 v = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i)));
    if (add) v = _mm256_add_ps(v, _mm256_loadu_ps(dst + i));
    _mm256_storeu_ps(dst + i, v);
  }
  for (; i < count; ++i) {
    float v = HalfToFloatPublic(src[i]);
    dst[i] = add ? dst[i] + v : v;
  }
}
#endif  // __x86_64__

void Fp16Compress(const float* src, int64_t count, uint8_t* dst,
                  float* residual, float* self_decode, GradQuality* quality) {
  uint16_t* h = reinterpret_cast<uint16_t*>(dst);
#if defined(__x86_64__)
  if (HaveF16C()) {
    Fp16CompressF16C(src, count, h, residual, self_decode, quality);
    return;
  }
#endif
  const bool want_back =
      residual != nullptr || self_decode != nullptr || quality != nullptr;
  for (int64_t i = 0; i < count; ++i) {
    float x = src[i] + (residual != nullptr ? residual[i] : 0.0f);
    h[i] = FloatToHalfPublic(x);
    if (want_back) {
      float back = HalfToFloatPublic(h[i]);
      if (residual != nullptr) {
        // Half-range overflow saturates to inf; a ±inf residual would
        // poison the element forever — drop the feedback instead.
        float r = x - back;
        residual[i] = std::isfinite(r) ? r : 0.0f;
      }
      if (self_decode != nullptr) self_decode[i] = back;
      if (quality != nullptr) AccumQuality(quality, x, back);
    }
  }
}

void Fp16Decompress(const uint8_t* src, int64_t count, float* dst, bool add) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
#if defined(__x86_64__)
  if (HaveF16C()) {
    Fp16DecompressF16C(h, count, dst, add);
    return;
  }
#endif
  for (int64_t i = 0; i < count; ++i) {
    float v = HalfToFloatPublic(h[i]);
    dst[i] = add ? dst[i] + v : v;
  }
}

// --- bucket-wise max-min quantization ---------------------------------------
// Bit-compatible with compression/quantize.py MaxMinQuantizer: same bucket
// size (512), same unit = (max - min) / (2^bits - 1), same
// round-to-nearest-EVEN codes (nearbyintf under the default rounding mode,
// matching jnp.round), and the same zero-padded-tail min/max semantics
// (_bucketize pads the last bucket with zeros BEFORE the min/max scan, so a
// short tail bucket's range always includes 0).
//
// The int8 hot path has an AVX2 variant (8 lanes per step, bit-identical to
// the scalar loop: same subtract/divide/RNE-round/clamp element ops, no FMA
// contraction) — without it the quantize+dequantize passes cost more than
// the bytes they save on fast links.

inline int64_t NumBuckets(int64_t count) {
  return (count + kWireBucketSize - 1) / kWireBucketSize;
}

#if defined(__x86_64__)
bool HaveAvx2() {
  static const bool ok = __builtin_cpu_supports("avx2") != 0;
  return ok;
}

__attribute__((target("avx2")))
inline float HorizontalMin(__m256 v) {
  __m128 m = _mm_min_ps(_mm256_castps256_ps128(v),
                        _mm256_extractf128_ps(v, 1));
  m = _mm_min_ps(m, _mm_movehl_ps(m, m));
  m = _mm_min_ss(m, _mm_shuffle_ps(m, m, 1));
  return _mm_cvtss_f32(m);
}

__attribute__((target("avx2")))
inline float HorizontalMax(__m256 v) {
  __m128 m = _mm_max_ps(_mm256_castps256_ps128(v),
                        _mm256_extractf128_ps(v, 1));
  m = _mm_max_ps(m, _mm_movehl_ps(m, m));
  m = _mm_max_ss(m, _mm_shuffle_ps(m, m, 1));
  return _mm_cvtss_f32(m);
}

__attribute__((target("avx2")))
void MaxMinCompress8Avx2(const float* src, int64_t count, uint8_t* dst,
                         float* residual, float* self_decode,
                         GradQuality* quality) {
  __m256d qerr = _mm256_setzero_pd();
  __m256d qsig = _mm256_setzero_pd();
  int64_t qvec = 0;  // lanes the vector loop accumulated (tails self-count)
  const int64_t nb = NumBuckets(count);
  float* header = reinterpret_cast<float*>(dst);
  uint8_t* codes = dst + nb * 8;
  alignas(32) float xbuf[kWireBucketSize];
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t lo = b * kWireBucketSize;
    const int64_t n = std::min<int64_t>(kWireBucketSize, count - lo);
    // Adjusted values (error feedback applied) staged through xbuf so the
    // stores below may alias src via self_decode.
    int64_t i = 0;
    if (residual != nullptr) {
      for (; i + 8 <= n; i += 8) {
        _mm256_store_ps(xbuf + i,
                        _mm256_add_ps(_mm256_loadu_ps(src + lo + i),
                                      _mm256_loadu_ps(residual + lo + i)));
      }
      for (; i < n; ++i) xbuf[i] = src[lo + i] + residual[lo + i];
    } else {
      for (; i + 8 <= n; i += 8) {
        _mm256_store_ps(xbuf + i, _mm256_loadu_ps(src + lo + i));
      }
      for (; i < n; ++i) xbuf[i] = src[lo + i];
    }
    float mn = xbuf[0], mx = xbuf[0];
    if (n >= 8) {
      __m256 vmn = _mm256_load_ps(xbuf), vmx = vmn;
      for (i = 8; i + 8 <= n; i += 8) {
        __m256 x = _mm256_load_ps(xbuf + i);
        vmn = _mm256_min_ps(vmn, x);
        vmx = _mm256_max_ps(vmx, x);
      }
      mn = HorizontalMin(vmn);
      mx = HorizontalMax(vmx);
    } else {
      i = 1;
    }
    for (; i < n; ++i) {
      mn = std::min(mn, xbuf[i]);
      mx = std::max(mx, xbuf[i]);
    }
    if (n < kWireBucketSize) {  // zero-padded tail (quantize.py parity)
      mn = std::min(mn, 0.0f);
      mx = std::max(mx, 0.0f);
    }
    const float unit = (mx - mn) / 255.0f;
    const float safe_unit = unit == 0.0f ? 1.0f : unit;
    header[b * 2] = mn;
    header[b * 2 + 1] = unit;
    const __m256 vmn = _mm256_set1_ps(mn);
    const __m256 vunit = _mm256_set1_ps(unit);
    const __m256 vsafe = _mm256_set1_ps(safe_unit);
    const __m256 vzero = _mm256_setzero_ps();
    const __m256 vlev = _mm256_set1_ps(255.0f);
    for (i = 0; i + 8 <= n; i += 8) {
      __m256 x = _mm256_load_ps(xbuf + i);
      __m256 q = _mm256_round_ps(
          _mm256_div_ps(_mm256_sub_ps(x, vmn), vsafe),
          _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
      q = _mm256_min_ps(_mm256_max_ps(q, vzero), vlev);
      __m256i i32 = _mm256_cvtps_epi32(q);
      __m128i u16 = _mm_packus_epi32(_mm256_castsi256_si128(i32),
                                     _mm256_extracti128_si256(i32, 1));
      _mm_storel_epi64(reinterpret_cast<__m128i*>(codes + lo + i),
                       _mm_packus_epi16(u16, u16));
      if (residual != nullptr || self_decode != nullptr ||
          quality != nullptr) {
        __m256 deq = _mm256_add_ps(vmn, _mm256_mul_ps(q, vunit));
        __m256 diff = _mm256_sub_ps(x, deq);
        if (residual != nullptr) {
          _mm256_storeu_ps(residual + lo + i, diff);
        }
        if (self_decode != nullptr) {
          _mm256_storeu_ps(self_decode + lo + i, deq);
        }
        if (quality != nullptr) {
          // Finite lanes only (a NaN input makes the bucket's min/unit —
          // and so diff — NaN; the sentinel owns non-finite values).
          __m256 finite = _mm256_cmp_ps(_mm256_sub_ps(diff, diff),
                                        _mm256_setzero_ps(), _CMP_EQ_OQ);
          __m256 df = _mm256_and_ps(diff, finite);
          __m256 xf = _mm256_and_ps(x, finite);
          AccumPd(&qerr, _mm256_mul_ps(df, df));
          AccumPd(&qsig, _mm256_mul_ps(xf, xf));
          qvec += 8;
        }
      }
    }
    for (; i < n; ++i) {
      float scaled = (xbuf[i] - mn) / safe_unit;
      float q = nearbyintf(scaled);
      if (q < 0.0f) q = 0.0f;
      if (q > 255.0f) q = 255.0f;
      codes[lo + i] = static_cast<uint8_t>(q);
      if (residual != nullptr || self_decode != nullptr ||
          quality != nullptr) {
        const float deq = mn + q * unit;
        if (residual != nullptr) residual[lo + i] = xbuf[i] - deq;
        if (self_decode != nullptr) self_decode[lo + i] = deq;
        if (quality != nullptr) AccumQuality(quality, xbuf[i], deq);
      }
    }
  }
  if (quality != nullptr) {
    quality->err2 += HorizontalSumPd(qerr);
    quality->sig2 += HorizontalSumPd(qsig);
    quality->count += qvec;  // scalar tails self-counted via AccumQuality
  }
}

template <bool kAdd>
__attribute__((target("avx2")))
void MaxMinDecompress8Avx2(const uint8_t* src, int64_t count, float* dst) {
  const int64_t nb = NumBuckets(count);
  const float* header = reinterpret_cast<const float*>(src);
  const uint8_t* codes = src + nb * 8;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t lo = b * kWireBucketSize;
    const int64_t n = std::min<int64_t>(kWireBucketSize, count - lo);
    const float mn = header[b * 2];
    const float unit = header[b * 2 + 1];
    const __m256 vmn = _mm256_set1_ps(mn);
    const __m256 vunit = _mm256_set1_ps(unit);
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
      __m256i i32 = _mm256_cvtepu8_epi32(_mm_loadl_epi64(
          reinterpret_cast<const __m128i*>(codes + lo + i)));
      __m256 v =
          _mm256_add_ps(vmn, _mm256_mul_ps(_mm256_cvtepi32_ps(i32), vunit));
      if (kAdd) v = _mm256_add_ps(v, _mm256_loadu_ps(dst + lo + i));
      _mm256_storeu_ps(dst + lo + i, v);
    }
    for (; i < n; ++i) {
      const float v = mn + static_cast<float>(codes[lo + i]) * unit;
      dst[lo + i] = kAdd ? dst[lo + i] + v : v;
    }
  }
}
#endif  // __x86_64__

template <int kBits>
void MaxMinCompress(const float* src, int64_t count, uint8_t* dst,
                    float* residual, float* self_decode,
                    GradQuality* quality) {
  constexpr float kLevels = static_cast<float>((1 << kBits) - 1);
  const int64_t nb = NumBuckets(count);
  float* header = reinterpret_cast<float*>(dst);
  uint8_t* codes = dst + nb * 8;
  float xbuf[kWireBucketSize];  // adjusted values (src may alias self_decode)
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t lo = b * kWireBucketSize;
    const int64_t n = std::min<int64_t>(kWireBucketSize, count - lo);
    float mn = src[lo] + (residual != nullptr ? residual[lo] : 0.0f);
    float mx = mn;
    for (int64_t i = 0; i < n; ++i) {
      float x = src[lo + i] + (residual != nullptr ? residual[lo + i] : 0.0f);
      xbuf[i] = x;
      mn = std::min(mn, x);
      mx = std::max(mx, x);
    }
    if (n < kWireBucketSize) {  // zero-padded tail (quantize.py parity)
      mn = std::min(mn, 0.0f);
      mx = std::max(mx, 0.0f);
    }
    const float unit = (mx - mn) / kLevels;
    const float safe_unit = unit == 0.0f ? 1.0f : unit;
    header[b * 2] = mn;
    header[b * 2 + 1] = unit;
    for (int64_t i = 0; i < n; ++i) {
      float scaled = (xbuf[i] - mn) / safe_unit;
      float q = nearbyintf(scaled);
      if (q < 0.0f) q = 0.0f;
      if (q > kLevels) q = kLevels;
      const uint8_t code = static_cast<uint8_t>(q);
      if (kBits == 8) {
        codes[lo + i] = code;
      } else {
        // Two codes per byte, low nibble first (quantize.py pack_bits).
        uint8_t& cell = codes[(lo + i) >> 1];
        if (((lo + i) & 1) == 0) {
          cell = code;
        } else {
          cell = static_cast<uint8_t>(cell | (code << 4));
        }
      }
      if (residual != nullptr || self_decode != nullptr ||
          quality != nullptr) {
        const float deq = mn + q * unit;
        if (residual != nullptr) residual[lo + i] = xbuf[i] - deq;
        if (self_decode != nullptr) self_decode[lo + i] = deq;
        if (quality != nullptr) AccumQuality(quality, xbuf[i], deq);
      }
    }
  }
}

template <int kBits, bool kAdd>
void MaxMinDecompress(const uint8_t* src, int64_t count, float* dst) {
  const int64_t nb = NumBuckets(count);
  const float* header = reinterpret_cast<const float*>(src);
  const uint8_t* codes = src + nb * 8;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t lo = b * kWireBucketSize;
    const int64_t n = std::min<int64_t>(kWireBucketSize, count - lo);
    const float mn = header[b * 2];
    const float unit = header[b * 2 + 1];
    for (int64_t i = 0; i < n; ++i) {
      uint8_t code;
      if (kBits == 8) {
        code = codes[lo + i];
      } else {
        const uint8_t cell = codes[(lo + i) >> 1];
        code = ((lo + i) & 1) == 0 ? (cell & 0x0f) : (cell >> 4);
      }
      const float v = mn + static_cast<float>(code) * unit;
      dst[lo + i] = kAdd ? dst[lo + i] + v : v;
    }
  }
}

}  // namespace

const char* WireCompressionName(WireCompression c) {
  switch (c) {
    case WireCompression::NONE: return "none";
    case WireCompression::FP16: return "fp16";
    case WireCompression::INT8: return "int8";
    case WireCompression::INT4: return "int4";
    case WireCompression::AUTO: return "auto";
  }
  return "unknown";
}

int64_t WireBytes(WireCompression c, int64_t count) {
  switch (c) {
    case WireCompression::FP16:
      return count * 2;
    case WireCompression::INT8:
      return NumBuckets(count) * 8 + count;
    case WireCompression::INT4:
      return NumBuckets(count) * 8 + (count + 1) / 2;
    case WireCompression::NONE:
    case WireCompression::AUTO:
      break;
  }
  return count * 4;
}

void WireCompress(WireCompression c, const float* src, int64_t count,
                  uint8_t* dst, float* residual, float* self_decode,
                  GradQuality* quality) {
  if (count <= 0) return;
  switch (c) {
    case WireCompression::FP16:
      Fp16Compress(src, count, dst, residual, self_decode, quality);
      return;
    case WireCompression::INT8:
#if defined(__x86_64__)
      if (HaveAvx2()) {
        MaxMinCompress8Avx2(src, count, dst, residual, self_decode, quality);
        return;
      }
#endif
      MaxMinCompress<8>(src, count, dst, residual, self_decode, quality);
      return;
    case WireCompression::INT4:
      MaxMinCompress<4>(src, count, dst, residual, self_decode, quality);
      return;
    case WireCompression::NONE:
    case WireCompression::AUTO:
      break;
  }
  memcpy(dst, src, static_cast<size_t>(count) * 4);
  if (self_decode != nullptr && self_decode != src) {
    memcpy(self_decode, src, static_cast<size_t>(count) * 4);
  }
}

void WireDecompress(WireCompression c, const uint8_t* src, int64_t count,
                    float* dst) {
  if (count <= 0) return;
  switch (c) {
    case WireCompression::FP16:
      Fp16Decompress(src, count, dst, /*add=*/false);
      return;
    case WireCompression::INT8:
#if defined(__x86_64__)
      if (HaveAvx2()) {
        MaxMinDecompress8Avx2<false>(src, count, dst);
        return;
      }
#endif
      MaxMinDecompress<8, false>(src, count, dst);
      return;
    case WireCompression::INT4:
      MaxMinDecompress<4, false>(src, count, dst);
      return;
    case WireCompression::NONE:
    case WireCompression::AUTO:
      break;
  }
  memcpy(dst, src, static_cast<size_t>(count) * 4);
}

void WireDecompressAdd(WireCompression c, const uint8_t* src, int64_t count,
                       float* dst) {
  if (count <= 0) return;
  switch (c) {
    case WireCompression::FP16:
      Fp16Decompress(src, count, dst, /*add=*/true);
      return;
    case WireCompression::INT8:
#if defined(__x86_64__)
      if (HaveAvx2()) {
        MaxMinDecompress8Avx2<true>(src, count, dst);
        return;
      }
#endif
      MaxMinDecompress<8, true>(src, count, dst);
      return;
    case WireCompression::INT4:
      MaxMinDecompress<4, true>(src, count, dst);
      return;
    case WireCompression::NONE:
    case WireCompression::AUTO: {
      const float* v = reinterpret_cast<const float*>(src);
      for (int64_t i = 0; i < count; ++i) dst[i] += v[i];
      return;
    }
  }
}

float* ResidualStore::Get(const std::string& key, int64_t count,
                          bool* reset) {
  if (reset != nullptr) *reset = false;
  if (buf_.size() >= kMaxEntries && buf_.find(key) == buf_.end()) {
    // Cap reached by a NEW signature: every live key's feedback is
    // dropped — that is a reset of real state, not a first use.
    if (reset != nullptr && !buf_.empty()) *reset = true;
    buf_.clear();
  }
  auto it = buf_.find(key);
  const bool existed = it != buf_.end();
  std::vector<float>& buf = existed ? it->second : buf_[key];
  if (buf.size() != static_cast<size_t>(count)) {
    // Element count changed on a LIVE key (refused fusion / reshape):
    // accumulated error feedback restarts from zero — the caller counts
    // and WARNs (hvdtpu_residual_resets_total) so a mid-run reshape is
    // visible instead of silently degrading quality.
    if (reset != nullptr && existed && !buf.empty()) *reset = true;
    buf.assign(static_cast<size_t>(count), 0.0f);
  }
  return buf.data();
}

}  // namespace hvdtpu
