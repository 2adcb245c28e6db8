// Norm quantization kernels for Hopper (sm_90a), bound to Python with
// ctypes through the plain C functions at the end of this file.
//
// They replace the Pallas TPU kernels in horovod_tpu/compression/
// pallas_kernels.py that serve NormalizedQuantizer (quantize.py:239-343):
//   B5 norm_quantize    <- norm_quantize_pallas   (_norm_quantize_kernel)
//   B6 norm_dequantize  <- norm_dequantize_pallas (_norm_dequantize_kernel)
//
// Per bucket of `bucket` values, with a descending level table of L <= 128
// fp32 entries:
//   B5: norm = max|x| (linf) or sqrt(sum x^2) (l2), ratio = |x| / norm'
//       (norm' = 1 where norm == 0), idx = the first nearest level (a
//       strict-< running argmin, as jnp.argmin picks the first minimum),
//       code = (idx << 1) | (x < 0), and the norm per bucket.
//   B6: (1 - 2 sign) * level[min(idx, L - 1)] * norm, the product of the
//       signed level and the norm rounded once, as quantize.py:337-342.
//
// Bytes moved, for n values in n_buckets buckets of `bucket` values with
// `bits`-bit codes:
//   B5: 4n read + n_buckets*bucket*bits/8 packed codes + 4*n_buckets norms
//       written (one byte per code on the byte-code route)
//   B6: n_buckets*bucket codes + 4*n_buckets norms read,
//       4*n_buckets*bucket written
// B6 is bound by device-memory bytes, and so is B5 where it finds the level
// by bisection on a strictly descending table (8 steps at 128 levels, 4 at
// 8, about 3 instructions a step); the linear scan it keeps for any other
// table costs about 4 operations a level, which at 128 levels bounds it by
// operations.
//
// B5's routes, chosen in hvd_norm_quantize from the input and reported by
// hvd_norm_last_route:
//   packed_search  bucket % 8 == 0 and bucket <= 2048, at any address,
//                  and a table the wrapper found strictly descending and
//                  finite: one coalesced read of the bucket held in
//                  registers (bucket_groups.cuh), the level by bisection,
//                  the codes packed by the kernel;
//   packed_scan    the same with any other table: the linear scan;
//   bytes          any other bucket: a scalar pass for the norm and one
//                  for the codes (the second mostly served by L1), one byte
//                  per code, packed by pack_bits outside; the search as the
//                  table allows.
// Every route gives the scan's index: the first nearest level under a
// strict-< running argmin, as jnp.argmin picks the first minimum
// (nearest_levels below).
//
// Rounding steps are spelled out with IEEE intrinsics (__fdiv_rn,
// __fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn; on the packed routes the
// division by the norm goes through hvd_groups::divide, nvcc's IEEE
// division with its reciprocal refined once a bucket) so nvcc cannot
// contract or approximate them: linf codes and norms and every decoded
// value are bitwise equal to the plain PyTorch versions in
// horovod_tpu_torch/compression/norm_kernels.py. The l2 sum runs in a
// warp's order, not the plain version's, so l2 norms agree to rtol 1e-6.
// Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bucket_groups.cuh"

namespace {

using hvd_groups::kGroup;
using hvd_groups::kWarp;

constexpr int kQuantizeWarps = 8;   // buckets per block in B5
constexpr int kDequantThreads = 128;
constexpr int kMaxLevels = 128;     // 8 bits: 7 index bits and a sign bit

// Routes of B5, as hvd_norm_last_route reports them.
constexpr int kRoutePackedSearch = 1;
constexpr int kRoutePackedScan = 2;
constexpr int kRouteBytes = 3;
thread_local int g_norm_route = 0;

// Max that passes a NaN through, as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || isnan(v)) ? v : acc;
}

__device__ __forceinline__ void load_levels(const float* __restrict__ levels,
                                            int n_levels, float* lv) {
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
}

// The table as B5 searches it: lv[-2] = lv[-1] = +inf, lv[0 .. n_levels -
// 1] the levels, and -inf from lv[n_levels] to lv[2 * kMaxLevels - 2], so
// every probe of the bisection and each neighbour its result looks at lie
// inside the array, at non-negative offsets from lv[k - 2], and no probe
// needs a bound check.
constexpr int kPaddedLevels = 2 * kMaxLevels + 1;
__device__ __forceinline__ const float* load_padded_levels(
    const float* __restrict__ levels, int n_levels, float* padded) {
  for (int i = threadIdx.x; i < kPaddedLevels; i += blockDim.x) {
    padded[i] = i < 2 ? INFINITY : i < n_levels + 2 ? levels[i - 2]
                                                    : -INFINITY;
  }
  __syncthreads();
  return padded + 2;
}

// lv[k - 2 + i] for the shared-memory address `at` of lv[k - 2], with the
// offset in the instruction: the search keeps one 32-bit address a value
// and spends no instruction on the probe's address.
template <int kIndex>
__device__ __forceinline__ float level_at(uint32_t at) {
  float level;
  asm volatile("ld.shared.f32 %0, [%1+%2];"
               : "=f"(level)
               : "r"(at), "n"(4 * kIndex));
  return level;
}

// The bisection's steps kStep, kStep / 2, ..., 1, each skipped above `top`
// (warp-uniform): the probe lv[k + step - 1], a compare and a predicated
// add of step to k, for every ratio at once.
template <int kStep, int kCount>
__device__ __forceinline__ void bisect(uint32_t (&at)[kCount],
                                       const float (&ratio)[kCount],
                                       int top) {
  if constexpr (kStep > 0) {
    if (kStep <= top) {
#pragma unroll
      for (int t = 0; t < kCount; ++t) {
        if (level_at<kStep + 1>(at[t]) > ratio[t]) at[t] += 4 * kStep;
      }
    }
    bisect<kStep / 2>(at, ratio, top);
  }
}

__device__ __forceinline__ float distance(float ratio, float level) {
  return fabsf(__fsub_rn(ratio, level));
}

// The index of the first nearest level to each of `kCount` ratios: the
// result of a running argmin over d[l] = |fl(ratio - lv[l])| with a strict
// <, as jnp.argmin picks the first minimum.
//
// kBisect (a strictly descending, finite table, padded as
// load_padded_levels pads it): fl(ratio - lv[l]) never decreases as l
// grows, since rounding is monotone, and it is below 0 exactly for the
// levels above ratio. Those form a prefix of length k, found in
// log2(top) + 1 steps (top: the largest power of two <= n_levels; the
// -inf padding answers the probes past the table), and d falls along the
// prefix and rises after it. So the minimum is d[k-1] or d[k]; k wins only
// when strictly nearer, and otherwise the first minimum lies at k-1 or,
// where rounding made neighbours' distances equal, further left along a
// run of equal distances. A NaN ratio compares with nothing, so k is 0 and
// the index 0, as in the scan. The ratios go through each step together,
// so their shared-memory loads are in flight at once.
template <bool kBisect, int kCount>
__device__ __forceinline__ void nearest_levels(const float (&ratio)[kCount],
                                               const float* __restrict__ lv,
                                               int n_levels, int top,
                                               int (&idx)[kCount]) {
  if (!kBisect) {
#pragma unroll
    for (int t = 0; t < kCount; ++t) {
      float best_d = distance(ratio[t], lv[0]);
      int best = 0;
      for (int l = 1; l < n_levels; ++l) {
        const float d = distance(ratio[t], lv[l]);
        if (d < best_d) {
          best_d = d;
          best = l;
        }
      }
      idx[t] = best;
    }
    return;
  }
  const uint32_t origin =
      static_cast<uint32_t>(__cvta_generic_to_shared(lv - 2));
  uint32_t at[kCount];  // the shared-memory address of lv[k - 2]
#pragma unroll
  for (int t = 0; t < kCount; ++t) at[t] = origin;
  bisect<kMaxLevels>(at, ratio, top);
  // Every neighbour is loaded before any branch; only a left winner whose
  // own left neighbour lies as near (a tie made by rounding) walks on.
  float left[kCount];
  bool walk = false;
#pragma unroll
  for (int t = 0; t < kCount; ++t) {
    const int k = static_cast<int>((at[t] - origin) / 4);
    left[t] = distance(ratio[t], level_at<1>(at[t]));
    const bool right = distance(ratio[t], level_at<2>(at[t])) < left[t];
    const float further = distance(ratio[t], level_at<0>(at[t]));
    idx[t] = right ? k : k - 1;
    walk |= !right & (k > 1) & (further == left[t]);
  }
  if (walk) {
#pragma unroll
    for (int t = 0; t < kCount; ++t) {
      if (idx[t] != static_cast<int>((at[t] - origin) / 4) - 1) continue;
      while (idx[t] > 0 && distance(ratio[t], lv[idx[t] - 1]) == left[t]) {
        --idx[t];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kCount; ++t) idx[t] = at[t] == origin ? 0 : idx[t];
}

// The code of a value: the level index, shifted left once, with the sign
// in the low bit.
__device__ __forceinline__ uint32_t norm_code(float v, int idx) {
  return (static_cast<uint32_t>(idx) << 1) | (v < 0.0f ? 1u : 0u);
}

// B5, packed routes: one warp per bucket of `bucket` values (a multiple of
// 8, at most 256 * kGroups), read once into registers. The zero padding
// past `n` counts in the norm (it changes neither max|x| nor the sum) and
// is coded like any zero. A NaN makes the bucket's norm and every ratio
// NaN, so every index is 0, as in the plain version and jnp.argmin.
template <int kGroups, bool kBisect>
__global__ void norm_quantize_packed_kernel(
    const float* __restrict__ x, int64_t n, int64_t n_buckets, int bucket,
    const float* __restrict__ levels, int n_levels, int top, int use_l2,
    int bits, uint8_t* __restrict__ q, float* __restrict__ norm_out) {
  __shared__ float padded[kPaddedLevels];
  const float* lv = load_padded_levels(levels, n_levels, padded);
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
    } else {
#pragma unroll
      for (int t = 0; t < kGroup; ++t) v[j][t] = 0.0f;  // neutral below
    }
  }
  // linf: fmaxf drops a NaN, so a flag beside it passes one through, as
  // nan_max does (the l2 sum passes it by itself).
  float acc = 0.0f;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      acc = use_l2 ? __fadd_rn(acc, __fmul_rn(v[j][t], v[j][t]))
                   : fmaxf(acc, fabsf(v[j][t]));
      nan |= isnan(v[j][t]);
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float other = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = use_l2 ? __fadd_rn(acc, other) : fmaxf(acc, other);
  }
  if (__any_sync(0xffffffffu, nan)) acc = NAN;
  const float norm = use_l2 ? __fsqrt_rn(acc) : acc;
  const hvd_groups::Divisor safe =
      hvd_groups::make_divisor(norm == 0.0f ? 1.0f : norm);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int g = j * kWarp + lane;
    if (g >= groups) continue;
    float magnitude[kGroup], ratio[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) magnitude[t] = fabsf(v[j][t]);
    hvd_groups::divide(magnitude, safe, ratio);
    int idx[kGroup];
    nearest_levels<kBisect>(ratio, lv, n_levels, top, idx);
    uint32_t c[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) c[t] = norm_code(v[j][t], idx[t]);
    hvd_groups::store_packed(q + (base / kGroup + g) * bits, c, bits);
  }
  if (lane == 0) norm_out[b] = norm;
}

// B5, byte-code route: one warp per bucket of any size, a
// strided pass for the norm and one for the codes, one byte per code.
template <bool kBisect>
__global__ void norm_quantize_bytes_kernel(const float* __restrict__ x,
                                           int64_t n, int64_t n_buckets,
                                           int bucket,
                                           const float* __restrict__ levels,
                                           int n_levels, int top, int use_l2,
                                           uint8_t* __restrict__ q,
                                           float* __restrict__ norm_out) {
  __shared__ float padded[kPaddedLevels];
  const float* lv = load_padded_levels(levels, n_levels, padded);
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kQuantizeWarps +
                    threadIdx.x / kWarp;
  if (b >= n_buckets) return;  // warp-uniform: the shuffles stay full-warp
  const int64_t base = b * bucket;

  float acc = 0.0f;
  for (int j = lane; j < bucket; j += kWarp) {
    const float v = base + j < n ? x[base + j] : 0.0f;
    acc = use_l2 ? __fadd_rn(acc, __fmul_rn(v, v)) : nan_max(acc, fabsf(v));
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float other = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = use_l2 ? __fadd_rn(acc, other) : nan_max(acc, other);
  }
  const float norm = use_l2 ? __fsqrt_rn(acc) : acc;
  const float safe = norm == 0.0f ? 1.0f : norm;
  for (int j = lane; j < bucket; j += kWarp) {
    const float v = base + j < n ? x[base + j] : 0.0f;
    const float ratio[1] = {__fdiv_rn(fabsf(v), safe)};
    int idx[1];
    nearest_levels<kBisect>(ratio, lv, n_levels, top, idx);
    q[base + j] = static_cast<uint8_t>(norm_code(v, idx[0]));
  }
  if (lane == 0) norm_out[b] = norm;
}

// B6: one block per bucket, its threads striding over the bucket. The
// index is clipped to the table, so a payload coded against a larger table
// decodes at the last level (pallas_kernels.py:118-121).
__global__ void norm_dequantize_kernel(const uint8_t* __restrict__ q,
                                       const float* __restrict__ levels,
                                       int n_levels,
                                       const float* __restrict__ norm,
                                       int bucket, float* __restrict__ out) {
  __shared__ float lv[kMaxLevels];
  load_levels(levels, n_levels, lv);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * bucket;
  const float scale = norm[blockIdx.x];
  for (int j = threadIdx.x; j < bucket; j += blockDim.x) {
    const int code = q[base + j];
    const float level = lv[min(code >> 1, n_levels - 1)];
    const float signed_level = (code & 1) ? -level : level;  // exact
    out[base + j] = __fmul_rn(signed_level, scale);
  }
}

template <bool kBisect>
cudaError_t launch_packed(int groups_per_lane, unsigned int blocks,
                          cudaStream_t stream, const float* x, int64_t n,
                          int64_t n_buckets, int bucket, const float* levels,
                          int n_levels, int top, int use_l2, int bits,
                          uint8_t* q, float* norm) {
  const unsigned int threads = kQuantizeWarps * kWarp;
#define HVD_NORM_PACKED(G)                                                  \
  norm_quantize_packed_kernel<G, kBisect><<<blocks, threads, 0, stream>>>( \
      x, n, n_buckets, bucket, levels, n_levels, top, use_l2, bits, q, norm)
  switch (groups_per_lane) {
    case 1: HVD_NORM_PACKED(1); break;
    case 2: HVD_NORM_PACKED(2); break;
    case 4: HVD_NORM_PACKED(4); break;
    default: HVD_NORM_PACKED(8);
  }
#undef HVD_NORM_PACKED
  return cudaGetLastError();
}

}  // namespace

// The C interface: every function launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller. `levels` is
// a device pointer to n_levels (1..128) fp32 values.
extern "C" {

// The route of the calling thread's last hvd_norm_quantize launch: 1
// packed_search, 2 packed_scan, 3 bytes (see the top of this file).
int hvd_norm_last_route(void) { return g_norm_route; }

// B5. `bits` (1, 2, 4 or 8, with n_levels <= 2^(bits-1)) is the width of
// a packed code; `search` says the table is strictly descending and finite.
// On a packed route q receives n_buckets * bucket * bits / 8 bytes, on the
// byte-code route n_buckets * bucket bytes.
int hvd_norm_quantize(const float* x, int64_t n, int64_t n_buckets,
                      int bucket, const float* levels, int n_levels,
                      int use_l2, int bits, int search, uint8_t* q,
                      float* norm, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8) ||
      n_levels > (1 << (bits - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>(
      (n_buckets + kQuantizeWarps - 1) / kQuantizeWarps);
  const int top = 1 << (31 - __builtin_clz(static_cast<unsigned>(n_levels)));
  const int groups_per_lane = hvd_groups::packed_groups_per_lane(bucket);
  if (groups_per_lane == 0) {
    g_norm_route = kRouteBytes;
    if (search) {
      norm_quantize_bytes_kernel<true><<<blocks, kQuantizeWarps * kWarp, 0,
                                         s>>>(x, n, n_buckets, bucket, levels,
                                              n_levels, top, use_l2, q, norm);
    } else {
      norm_quantize_bytes_kernel<false><<<blocks, kQuantizeWarps * kWarp, 0,
                                          s>>>(x, n, n_buckets, bucket,
                                               levels, n_levels, top, use_l2,
                                               q, norm);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (search) {
    g_norm_route = kRoutePackedSearch;
    return static_cast<int>(launch_packed<true>(
        groups_per_lane, blocks, s, x, n, n_buckets, bucket, levels,
        n_levels, top, use_l2, bits, q, norm));
  }
  g_norm_route = kRoutePackedScan;
  return static_cast<int>(launch_packed<false>(
      groups_per_lane, blocks, s, x, n, n_buckets, bucket, levels, n_levels,
      top, use_l2, bits, q, norm));
}

int hvd_norm_dequantize(const uint8_t* q, const float* levels, int n_levels,
                        const float* norm, int64_t n_buckets, int bucket,
                        float* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  norm_dequantize_kernel<<<static_cast<unsigned int>(n_buckets),
                           kDequantThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, levels, n_levels, norm, bucket, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
