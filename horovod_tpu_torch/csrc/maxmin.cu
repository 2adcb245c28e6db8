// Max-min quantization kernels for Hopper (sm_90a), bound to Python with
// ctypes through the plain C functions at the end of this file.
//
// They replace the Pallas TPU kernels in horovod_tpu/compression/
// pallas_kernels.py:
//   B1 maxmin_quantize        <- maxmin_quantize_pallas   (_quantize_kernel)
//   B2 maxmin_quantize_stochastic
//                             <- maxmin_quantize_stochastic_pallas
//                                (_quantize_stochastic_kernel)
//   B3 maxmin_dequantize_sum  <- maxmin_dequantize_sum_pallas
//                                (_dequantize_sum_kernel)
//   B4 maxmin_dequantize      <- maxmin_dequantize_pallas (_dequantize_kernel)
//
// All four do a handful of fp32 operations per byte they move, so on an
// H100 they are bound by device-memory bytes, not by operations (B2's
// Philox4x32-10 adds about 15 issue slots a value, which with the rest of
// its work, about 29, stays under the byte bound; chip_smoke.py counts it
// in B2_SLOTS).
// The design answer is to touch each byte once: B1 reads a bucket once from
// device memory (the second pass over it hits L1), B2's packed route reads
// it once into registers and writes the packed payload itself, B3 and B4
// read the packed payload as it crossed the wire (no unpacking pass), and
// B3 decodes and sums every rank's codes in one pass instead of n
// dequantize passes plus n adds.
// Bytes moved, for n values in n_buckets buckets of `bucket` values:
//   B1: 4n read + n_buckets*bucket codes + 8*n_buckets min/unit written
//   B2: 4n read + n_buckets*bucket*bits/8 packed codes (one byte a code on
//       its byte-code route) + 8*n_buckets min/unit written
//   B4: n_buckets*bucket*bits/8 packed codes + 8*n_buckets read,
//       4*n_buckets*bucket written
//   B3: n_ranks*(n_buckets*bucket*bits/8 + 8*n_buckets) read,
//       4*n_buckets*bucket written
//
// B2's routes, chosen in hvd_maxmin_quantize_stochastic from the input and
// reported by hvd_maxmin_last_route:
//   packed  bucket % 8 == 0 and bucket <= 2048, at any address: the
//           bucket read once, coalesced, into registers
//           (bucket_groups.cuh); min and max from the registers; a group of
//           8 values is exactly Philox counters 2g and 2g + 1, so no
//           counter straddles two buckets; the codes packed by the kernel;
//   bytes   any other bucket: a strided pass for min and max and one per
//           Philox counter for the codes (a counter may straddle two
//           buckets), one byte per code, packed by pack_bits outside.
// B3's and B4's routes, chosen by the bucket alone and reported the same
// way:
//   packed  bucket % 8 == 0: a group of 8 codes is `bits` whole bytes, read
//           with one load (load_packed; byte by byte where the payload's
//           address is not a multiple of `bits`), decoded and written as
//           16-byte stores;
//   generic any other bucket: code j's byte and shift from its bit index,
//           one value a lane at a time; correct, not fast.
//
// Every rounding step is spelled out with an IEEE intrinsic (__fsub_rn,
// __fdiv_rn, __fmul_rn, __fadd_rn, rintf) so nvcc cannot contract or
// approximate it: the codes and the decoded values are bitwise equal to the
// plain PyTorch versions in horovod_tpu_torch/compression/kernels.py. B2's
// packed route divides by the bucket's unit through hvd_groups::divide
// (bucket_groups.cuh): nvcc's IEEE division, its reciprocal refined once a
// bucket. Do not build with --use_fast_math.
//
// B1's codes are packed into bytes outside (pack_bits); B3 and B4 read
// them packed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bucket_groups.cuh"

namespace {

using hvd_groups::kGroup;
using hvd_groups::kWarp;

constexpr int kQuantizeWarps = 8;     // buckets per block in B1 and B2
constexpr int kDecodeWarps = 8;       // buckets per block in B3 and B4
// A lane's groups, and in B3 ranks, whose loads go out before any of their
// arithmetic.
constexpr int kDecodeGroups = 4;
constexpr int kDecodeRanks = 4;
// Buckets of B3 and B4 index a bucket's bits in 32 bits.
constexpr int kMaxDecodeBucket = 1 << 27;

// Routes of B2, B3 and B4, as hvd_maxmin_last_route reports them.
constexpr int kRoutePacked = 1;
constexpr int kRouteBytes = 2;
constexpr int kRouteGeneric = 3;
thread_local int g_maxmin_route = 0;

// min and max that pass a NaN through, as torch.amin/amax and jnp.min/max
// do (fminf/fmaxf would drop it): once `acc` is NaN no comparison is true.
__device__ __forceinline__ float nan_min(float acc, float v) {
  return (v < acc || isnan(v)) ? v : acc;
}
__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || isnan(v)) ? v : acc;
}

// The min and max of bucket `base / bucket` across one warp; every lane
// gets both. Values past `n` are the zero padding of the last bucket and
// count in its min and max (quantize.py _bucketize).
__device__ __forceinline__ void bucket_min_max(const float* __restrict__ x,
                                               int64_t n, int64_t base,
                                               int bucket, int lane,
                                               float* lo_out, float* hi_out) {
  float lo = INFINITY;
  float hi = -INFINITY;
  for (int j = lane; j < bucket; j += kWarp) {
    const float v = base + j < n ? x[base + j] : 0.0f;
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  *lo_out = lo;
  *hi_out = hi;
}

// B1: one warp per bucket. A NaN in a bucket makes its min and unit NaN,
// so every value decoded from it is NaN; the codes of such a bucket are 0
// (fmaxf drops the NaN), as in the plain version.
__global__ void maxmin_quantize_kernel(const float* __restrict__ x, int64_t n,
                                       int64_t n_buckets, int bucket,
                                       float levels,
                                       uint8_t* __restrict__ q,
                                       float* __restrict__ mn_out,
                                       float* __restrict__ unit_out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kQuantizeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;  // warp-uniform: the shuffles stay full-warp
  const int64_t base = b * bucket;

  float lo, hi;
  bucket_min_max(x, n, base, bucket, lane, &lo, &hi);
  const float unit = __fdiv_rn(__fsub_rn(hi, lo), levels);
  const float safe = unit == 0.0f ? 1.0f : unit;
  for (int j = lane; j < bucket; j += kWarp) {
    const float v = base + j < n ? x[base + j] : 0.0f;
    float c = rintf(__fdiv_rn(__fsub_rn(v, lo), safe));
    c = fminf(fmaxf(c, 0.0f), levels);
    q[base + j] = static_cast<uint8_t>(c);
  }
  if (lane == 0) {
    mn_out[b] = lo;
    unit_out[b] = unit;
  }
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; Random123's philox4x32 with 10 rounds): four 32-bit words
// from a 128-bit counter under a 64-bit key. Pinned by Random123's
// known-answer vectors in the CPU tests, through the plain version in
// compression/kernels.py, which computes the same rounds.
struct Words4 {
  uint32_t x, y, z, w;
};

// The ten round keys of a 64-bit key, computed once per thread: the rounds
// then do two 32x32->64-bit multiplies (one IMAD.WIDE.U32 each) and two
// three-input XORs, and nothing else.
struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t k0, uint32_t k1) {
  PhiloxKey key;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    key.k0[r] = k0 + r * 0x9E3779B9u;
    key.k1[r] = k1 + r * 0xBB67AE85u;
  }
  return key;
}

__device__ __forceinline__ Words4 philox4x32_10(Words4 c,
                                                const PhiloxKey& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = Words4{hi1 ^ c.y ^ key.k0[r], lo1, hi0 ^ c.w ^ key.k1[r], lo0};
  }
  return c;
}

// The noise of one value: u = (w & 0xffffff) * 2^-24, the 24 low bits the
// TPU kernel masks (exact: a 24-bit integer times a power of two), and the
// code clip(floor(scaled + u), 0, levels) of its scaled value
// (v - lo) / safe.
__device__ __forceinline__ uint32_t stochastic_code(float scaled,
                                                    float levels,
                                                    uint32_t w) {
  const float u = static_cast<float>(w & 0xffffffu) * 0x1p-24f;
  const float code = fminf(fmaxf(floorf(__fadd_rn(scaled, u)), 0.0f), levels);
  return static_cast<uint32_t>(code);
}

// B2: B1 with stochastic rounding, q = clip(floor(scaled + u), 0, levels).
// u comes from word i % 4 of Philox4x32-10 at counter (i / 4, offset) under
// the key `seed`, where i is the value's index in the padded
// [n_buckets * bucket] layout, so the codes do not depend on the launch
// geometry or the route.
//
// Packed route: one warp per bucket of `bucket` values (a multiple of 8, at
// most 256 * kGroups), read once into registers; lane l codes groups l,
// l + 32, ... and draws Philox counters 2g and 2g + 1 of each (64-bit
// counters: the bucket's first counter is computed once, in 64 bits, and
// every round is 32-bit). The kernel waits on its loads and on the
// division's and Philox's chains more than on issue, so at 1 and 2 groups a
// lane (buckets of up to 512) it is held to 48 registers for 5 blocks an SM
// in place of 4, without a spill (PERF.md). At 4 and 8 groups a lane holds
// 32 and 64 values, which do not fit in 48 registers: those instances
// keep the compiler's own register count.
template <int kGroups>
__global__ void __launch_bounds__(kQuantizeWarps * kWarp,
                                  kGroups <= 2 ? 5 : 1)
maxmin_quantize_stochastic_packed_kernel(
    const float* __restrict__ x, int64_t n, int64_t n_buckets, int bucket,
    float levels, int bits, uint32_t k0, uint32_t k1, uint32_t off0,
    uint32_t off1, uint8_t* __restrict__ q, float* __restrict__ mn_out,
    float* __restrict__ unit_out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kQuantizeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;  // warp-uniform: the shuffles stay full-warp
  const int64_t base = b * bucket;
  const int groups = bucket / kGroup;
  const bool aligned = hvd_groups::vector_aligned(x);

  float v[kGroups][kGroup];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int g = j * kWarp + lane;
    if (g < groups) {
      hvd_groups::load_group(x, aligned, n, base + kGroup * g, v[j]);
    }
  }
  // fminf and fmaxf drop a NaN; a flag beside them passes it through, as
  // nan_min and nan_max do, in three instructions a value instead of
  // about eight.
  float lo = INFINITY;
  float hi = -INFINITY;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    if (j * kWarp + lane >= groups) continue;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      lo = fminf(lo, v[j][t]);
      hi = fmaxf(hi, v[j][t]);
      nan |= isnan(v[j][t]);
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (__any_sync(0xffffffffu, nan)) {
    lo = NAN;
    hi = NAN;
  }
  const float unit = __fdiv_rn(__fsub_rn(hi, lo), levels);
  const hvd_groups::Divisor safe =
      hvd_groups::make_divisor(unit == 0.0f ? 1.0f : unit);
  const PhiloxKey key = philox_key(k0, k1);
  const uint64_t first_counter = static_cast<uint64_t>(base) / 4;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int g = j * kWarp + lane;
    if (g >= groups) continue;
    const uint64_t c = first_counter + 2 * static_cast<uint64_t>(g);
    const Words4 r0 = philox4x32_10(
        Words4{static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
               off0, off1}, key);
    const Words4 r1 = philox4x32_10(
        Words4{static_cast<uint32_t>(c + 1),
               static_cast<uint32_t>((c + 1) >> 32), off0, off1}, key);
    const uint32_t words[kGroup] = {r0.x, r0.y, r0.z, r0.w,
                                    r1.x, r1.y, r1.z, r1.w};
    float above_min[kGroup], scaled[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) above_min[t] = __fsub_rn(v[j][t], lo);
    hvd_groups::divide(above_min, safe, scaled);
    uint32_t codes[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      codes[t] = stochastic_code(scaled[t], levels, words[t]);
    }
    hvd_groups::store_packed(q + (base / kGroup + g) * bits, codes, bits);
  }
  if (lane == 0) {
    mn_out[b] = lo;
    unit_out[b] = unit;
  }
}

// Byte-code route: one warp per bucket of any size; each lane
// draws one counter (four words) at a time and codes the values of the
// bucket among its four.
__global__ void maxmin_quantize_stochastic_bytes_kernel(
    const float* __restrict__ x, int64_t n, int64_t n_buckets, int bucket,
    float levels, uint32_t k0, uint32_t k1, uint32_t off0, uint32_t off1,
    uint8_t* __restrict__ q, float* __restrict__ mn_out,
    float* __restrict__ unit_out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kQuantizeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;  // warp-uniform: the shuffles stay full-warp
  const int64_t base = b * bucket;
  const int64_t end = base + bucket;

  float lo, hi;
  bucket_min_max(x, n, base, bucket, lane, &lo, &hi);
  const float unit = __fdiv_rn(__fsub_rn(hi, lo), levels);
  const float safe = unit == 0.0f ? 1.0f : unit;
  const PhiloxKey key = philox_key(k0, k1);
  for (int64_t c = base / 4 + lane; c <= (end - 1) / 4; c += kWarp) {
    const Words4 r = philox4x32_10(
        Words4{static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
               off0, off1},
        key);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t i = 4 * c + k;
      if (i < base || i >= end) continue;
      const float v = i < n ? x[i] : 0.0f;
      q[i] = static_cast<uint8_t>(stochastic_code(
          __fdiv_rn(__fsub_rn(v, lo), safe), levels, words[k]));
    }
  }
  if (lane == 0) {
    mn_out[b] = lo;
    unit_out[b] = unit;
  }
}

unsigned int blocks_for(int64_t work, int per_block) {
  return static_cast<unsigned int>((work + per_block - 1) / per_block);
}

// B4 and B3 share one layout. The payload of rank r (B3; B4 has one) is
// rows of `row_stride` bytes at q + r * rank_stride; row k holds buckets
// k * per_row .. (k + 1) * per_row - 1, each pack_bits of its codes, code j
// of a row at bit j * bits. Output bucket b is min + code * unit of every
// rank's bucket b (mn, unit [n_ranks, n_buckets]): B4 writes that value,
// B3 the sum over ranks in rank order, acc = 0 then acc + value rank by
// rank: the order of the plain version and of the JAX package's per-rank
// loop, so both are bitwise equal to their plain versions. The product and
// the sums round one by one (__fmul_rn, __fadd_rn: no FMA).
//
// Where the first code of the bucket lies: its row, and its byte and bit
// in that row, computed once a bucket in 64 bits.
struct BucketCodes {
  const uint8_t* first;
  int skew;  // the first code's bit in *first (0 on the packed route)
};

__device__ __forceinline__ BucketCodes bucket_codes(const uint8_t* q,
                                                    int64_t row_stride,
                                                    int64_t per_row,
                                                    int64_t b, int bucket,
                                                    int bits) {
  const int64_t row = b / per_row;
  const int64_t first_bit = (b - row * per_row) * bucket * bits;
  return BucketCodes{q + row * row_stride + first_bit / 8,
                     static_cast<int>(first_bit % 8)};
}

// Four values as one 16-byte store at p (16-byte aligned). Spelled out:
// left to itself, nvcc split one of a loop's four float4 stores into four
// 4-byte ones.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// The packed route: one warp per output bucket (a multiple of 8 values).
// A group of 8 codes is kBits whole bytes; lanes 2k and 2k + 1 load the
// same group (one sector) and decode its first and second half, so each
// 16-byte store of the warp covers 512 consecutive bytes of output: for
// group index i a lane writes half l % 2 of group g = l / 2 + 16 i. A
// lane issues the loads of kDecodeGroups groups of kRanks ranks, as
// straight-line code, before their arithmetic: an index past the bucket
// or the last rank reads the last group or rank again (a valid address,
// its value unused), so no branch separates two loads and each warp waits
// for its loads once. min and unit are read once a bucket and rank (one
// broadcast load for the warp).
template <bool kSum, int kRanks, int kBits, bool kAligned>
__device__ __forceinline__ void decode_packed_bucket(
    const uint8_t* __restrict__ src, int64_t rank_stride,
    const float* __restrict__ mn, const float* __restrict__ unit,
    int n_ranks, int64_t n_buckets, int64_t b, int groups, int lane,
    float* __restrict__ dst) {
  constexpr int kHalfWarp = kWarp / 2;
  constexpr int kHalf = kGroup / 2;
  const int half_shift = (lane % 2) * kHalf * kBits;
  for (int g0 = lane / 2; g0 < groups; g0 += kHalfWarp * kDecodeGroups) {
    float acc[kDecodeGroups][kHalf];
#pragma unroll
    for (int i = 0; i < kDecodeGroups; ++i) {
#pragma unroll
      for (int t = 0; t < kHalf; ++t) acc[i][t] = 0.0f;
    }
    for (int r0 = 0; r0 < n_ranks; r0 += kRanks) {
      uint32_t word[kRanks][kDecodeGroups];
      float lo[kRanks], step[kRanks];
#pragma unroll
      for (int k = 0; k < kRanks; ++k) {
        const int r = min(r0 + k, n_ranks - 1);
        lo[k] = __ldg(mn + r * n_buckets + b);
        step[k] = __ldg(unit + r * n_buckets + b);
#pragma unroll
        for (int i = 0; i < kDecodeGroups; ++i) {
          const int g = min(g0 + i * kHalfWarp, groups - 1);
          word[k][i] = static_cast<uint32_t>(
              hvd_groups::load_packed<kBits, kAligned>(
                  src + r * rank_stride + g * kBits) >> half_shift);
        }
      }
      // A rank past the last one adds nothing: a select, not a branch,
      // so the compiler cannot sink that rank's loads below the
      // arithmetic of the ranks before it.
#pragma unroll
      for (int k = 0; k < kRanks; ++k) {
        const bool live = r0 + k < n_ranks;
#pragma unroll
        for (int i = 0; i < kDecodeGroups; ++i) {
#pragma unroll
          for (int t = 0; t < kHalf; ++t) {
            const float code = static_cast<float>(
                hvd_groups::packed_code(word[k][i], t, kBits));
            const float v = __fadd_rn(lo[k], __fmul_rn(code, step[k]));
            acc[i][t] = !kSum ? v : live ? __fadd_rn(acc[i][t], v)
                                         : acc[i][t];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDecodeGroups; ++i) {
      const int g = g0 + i * kHalfWarp;
      if (g < groups) {
        store4(dst + g * kGroup, acc[i]);
      }
    }
  }
}

// B4 (kSum false, one rank) and B3 (kRanks ranks' loads at a time). The
// load width follows the payload's address (one load of kBits bytes, or
// byte by byte where the address or a stride is not a multiple of kBits),
// one branch a warp; the output layout does not.
template <bool kSum, int kRanks, int kBits>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
maxmin_decode_packed_kernel(const uint8_t* __restrict__ q,
                            int64_t row_stride, int64_t rank_stride,
                            const float* __restrict__ mn,
                            const float* __restrict__ unit, int n_ranks,
                            int64_t n_buckets, int64_t per_row, int bucket,
                            float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kDecodeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;
  const uint8_t* src =
      bucket_codes(q, row_stride, per_row, b, bucket, kBits).first;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | row_stride | rank_stride) %
          kBits == 0;
  float* dst = out + b * bucket + (lane % 2) * (kGroup / 2);
  if (aligned) {
    decode_packed_bucket<kSum, kRanks, kBits, true>(
        src, rank_stride, mn, unit, n_ranks, n_buckets, b, bucket / kGroup,
        lane, dst);
  } else {
    decode_packed_bucket<kSum, kRanks, kBits, false>(
        src, rank_stride, mn, unit, n_ranks, n_buckets, b, bucket / kGroup,
        lane, dst);
  }
}

// The generic route: one warp per output bucket of any size, lane l on
// values l, l + 32, ...: code j's byte and shift from its bit index
// skew + j * bits in 32 bits (bits divides 8, so a code never straddles two
// bytes), each rank's value of it added in rank order.
template <bool kSum>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
maxmin_decode_generic_kernel(const uint8_t* __restrict__ q,
                             int64_t row_stride, int64_t rank_stride,
                             const float* __restrict__ mn,
                             const float* __restrict__ unit, int n_ranks,
                             int64_t n_buckets, int64_t per_row, int bucket,
                             int bits, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kDecodeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;
  const BucketCodes codes =
      bucket_codes(q, row_stride, per_row, b, bucket, bits);
  const uint32_t mask = (1u << bits) - 1;
  for (int j = lane; j < bucket; j += kWarp) {
    const int bit = codes.skew + j * bits;
    const uint8_t* p = codes.first + bit / 8;
    const int shift = bit % 8;
    float acc = 0.0f;
    for (int r = 0; r < n_ranks; ++r) {
      const float code = static_cast<float>(
          (static_cast<uint32_t>(__ldg(p + r * rank_stride)) >> shift) &
          mask);
      const float v = __fadd_rn(
          __ldg(mn + r * n_buckets + b),
          __fmul_rn(code, __ldg(unit + r * n_buckets + b)));
      acc = kSum ? __fadd_rn(acc, v) : v;
    }
    out[b * bucket + j] = acc;
  }
}

// Launch B3 (sum) or B4 on the route the bucket asks for, and record it.
int decode(const uint8_t* q, int64_t row_stride, int64_t rank_stride,
           const float* mn, const float* unit, int n_ranks,
           int64_t n_buckets, int64_t per_row, int bucket, int bits,
           float* out, bool sum, cudaStream_t s) {
  const bool packed = bucket % kGroup == 0;
  if (bucket < 1 || bucket > kMaxDecodeBucket || n_ranks < 1 ||
      per_row < 1 || !(bits == 1 || bits == 2 || bits == 4 || bits == 8) ||
      (packed && reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g_maxmin_route = packed ? kRoutePacked : kRouteGeneric;
  const unsigned int blocks = blocks_for(n_buckets, kDecodeWarps);
  const unsigned int threads = kDecodeWarps * kWarp;
  if (!packed) {
    if (sum) {
      maxmin_decode_generic_kernel<true><<<blocks, threads, 0, s>>>(
          q, row_stride, rank_stride, mn, unit, n_ranks, n_buckets, per_row,
          bucket, bits, out);
    } else {
      maxmin_decode_generic_kernel<false><<<blocks, threads, 0, s>>>(
          q, row_stride, rank_stride, mn, unit, n_ranks, n_buckets, per_row,
          bucket, bits, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // B4 one rank; B3 one rank, or kDecodeRanks at a time.
#define HVD_DECODE_BITS(SUM, RANKS)                                       \
  switch (bits) {                                                         \
    case 1: HVD_DECODE(SUM, RANKS, 1); break;                             \
    case 2: HVD_DECODE(SUM, RANKS, 2); break;                             \
    case 4: HVD_DECODE(SUM, RANKS, 4); break;                             \
    default: HVD_DECODE(SUM, RANKS, 8);                                   \
  }
#define HVD_DECODE(SUM, RANKS, BITS)                                      \
  maxmin_decode_packed_kernel<SUM, RANKS, BITS><<<blocks, threads, 0, s>>>( \
      q, row_stride, rank_stride, mn, unit, n_ranks, n_buckets, per_row,  \
      bucket, out)
  if (!sum) {
    HVD_DECODE_BITS(false, 1)
  } else if (n_ranks == 1) {
    HVD_DECODE_BITS(true, 1)
  } else {
    HVD_DECODE_BITS(true, kDecodeRanks)
  }
#undef HVD_DECODE
#undef HVD_DECODE_BITS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: every function launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller.
extern "C" {

int hvd_maxmin_quantize(const float* x, int64_t n, int64_t n_buckets,
                        int bucket, int bits, uint8_t* q, float* mn,
                        float* unit, void* stream) {
  const float levels = static_cast<float>((1 << bits) - 1);
  maxmin_quantize_kernel<<<blocks_for(n_buckets, kQuantizeWarps),
                           kQuantizeWarps * kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, n, n_buckets, bucket, levels, q, mn, unit);
  return static_cast<int>(cudaGetLastError());
}

// The route of the calling thread's last launch of B2, B3 or B4: 1 packed,
// 2 bytes (B2), 3 generic (B3, B4); see the top of this file.
int hvd_maxmin_last_route(void) { return g_maxmin_route; }

// B2. On the packed route q receives n_buckets * bucket * bits / 8 bytes,
// on the byte-code route n_buckets * bucket bytes.
int hvd_maxmin_quantize_stochastic(const float* x, int64_t n,
                                   int64_t n_buckets, int bucket, int bits,
                                   uint64_t seed, uint64_t offset, uint8_t* q,
                                   float* mn, float* unit, void* stream) {
  const float levels = static_cast<float>((1 << bits) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(n_buckets, kQuantizeWarps);
  const unsigned int threads = kQuantizeWarps * kWarp;
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const uint32_t off0 = static_cast<uint32_t>(offset);
  const uint32_t off1 = static_cast<uint32_t>(offset >> 32);
  const int groups_per_lane = hvd_groups::packed_groups_per_lane(bucket);
  if (groups_per_lane == 0) {
    g_maxmin_route = kRouteBytes;
    maxmin_quantize_stochastic_bytes_kernel<<<blocks, threads, 0, s>>>(
        x, n, n_buckets, bucket, levels, k0, k1, off0, off1, q, mn, unit);
    return static_cast<int>(cudaGetLastError());
  }
  g_maxmin_route = kRoutePacked;
#define HVD_B2_PACKED(G)                                                  \
  maxmin_quantize_stochastic_packed_kernel<G><<<blocks, threads, 0, s>>>( \
      x, n, n_buckets, bucket, levels, bits, k0, k1, off0, off1, q, mn, unit)
  switch (groups_per_lane) {
    case 1: HVD_B2_PACKED(1); break;
    case 2: HVD_B2_PACKED(2); break;
    case 4: HVD_B2_PACKED(4); break;
    default: HVD_B2_PACKED(8);
  }
#undef HVD_B2_PACKED
  return static_cast<int>(cudaGetLastError());
}

// B4: q holds `rows` rows of row_bytes bytes, each the packed codes of
// n_buckets / rows buckets; mn, unit [n_buckets]; out [n_buckets, bucket]
// (16-byte aligned).
int hvd_maxmin_dequantize(const uint8_t* q, int64_t rows, int64_t row_bytes,
                          const float* mn, const float* unit,
                          int64_t n_buckets, int bucket, int bits,
                          float* out, void* stream) {
  if (rows < 1 || n_buckets % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return decode(q, row_bytes, 0, mn, unit, 1, n_buckets, n_buckets / rows,
                bucket, bits, out, false, static_cast<cudaStream_t>(stream));
}

// B3: q holds one row of row_bytes bytes a rank, the packed codes of its
// n_buckets buckets; mn, unit [n_ranks, n_buckets]; out [n_buckets,
// bucket] (16-byte aligned).
int hvd_maxmin_dequantize_sum(const uint8_t* q, int n_ranks,
                              int64_t row_bytes, const float* mn,
                              const float* unit, int64_t n_buckets,
                              int bucket, int bits, float* out,
                              void* stream) {
  return decode(q, row_bytes, row_bytes, mn, unit, n_ranks, n_buckets,
                n_buckets, bucket, bits, out, true,
                static_cast<cudaStream_t>(stream));
}

const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
