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
// H100 they are bound by device-memory bytes, not by operations. The design
// answer is to touch each byte once: B1 reads a bucket once from device
// memory (the second pass over it hits L1) and B3 decodes and sums every
// rank's codes in one pass instead of n dequantize passes plus n adds.
// Bytes moved, for n values in n_buckets buckets of `bucket` values:
//   B1, B2: 4n read + n_buckets*bucket codes + 8*n_buckets min/unit written
//   B4: n_buckets*bucket codes + 8*n_buckets read, 4*n_buckets*bucket written
//   B3: n_ranks*(n_buckets*bucket + 8*n_buckets) read,
//       4*n_buckets*bucket written
//
// Every rounding step is spelled out with an IEEE intrinsic (__fsub_rn,
// __fdiv_rn, __fmul_rn, __fadd_rn, rintf) so nvcc cannot contract or
// approximate it: the codes and the decoded values are bitwise equal to the
// plain PyTorch versions in horovod_tpu_torch/compression/kernels.py. Do not
// build with --use_fast_math.
//
// Packing the codes into bytes (pack_bits/unpack_bits) stays outside.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kQuantizeWarps = 8;     // buckets per block in B1
constexpr int kElementwiseThreads = 256;

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

__device__ __forceinline__ Words4 philox4x32_10(Words4 c, uint32_t k0,
                                                uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = Words4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// B2: B1 with stochastic rounding, q = clip(floor(scaled + u), 0, levels)
// with u = (w & 0xffffff) * 2^-24, the 24 low bits the TPU kernel masks.
// w is word i % 4 of Philox4x32-10 at counter (i / 4, offset) under the
// key `seed`, where i is the value's index in the padded
// [n_buckets * bucket] layout, so the codes do not depend on the launch
// geometry. One warp per bucket; each lane draws one counter (four words)
// at a time and codes the values of the bucket among its four.
__global__ void maxmin_quantize_stochastic_kernel(
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
  for (int64_t c = base / 4 + lane; c <= (end - 1) / 4; c += kWarp) {
    const Words4 r = philox4x32_10(
        Words4{static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
               off0, off1},
        k0, k1);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t i = 4 * c + k;
      if (i < base || i >= end) continue;
      const float v = i < n ? x[i] : 0.0f;
      // Exact: a 24-bit integer times a power of two.
      const float u = static_cast<float>(words[k] & 0xffffffu) * 0x1p-24f;
      float code = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(v, lo), safe), u));
      code = fminf(fmaxf(code, 0.0f), levels);
      q[i] = static_cast<uint8_t>(code);
    }
  }
  if (lane == 0) {
    mn_out[b] = lo;
    unit_out[b] = unit;
  }
}

// B4: one thread per value, min + q * unit.
__global__ void maxmin_dequantize_kernel(const uint8_t* __restrict__ q,
                                         const float* __restrict__ mn,
                                         const float* __restrict__ unit,
                                         int64_t total, int bucket,
                                         float* __restrict__ out) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / bucket;
  out[i] = __fadd_rn(mn[b], __fmul_rn(static_cast<float>(q[i]), unit[b]));
}

// B3: one thread per output value, summing the decoded value of every rank
// in rank order — the order of the per-rank loop in reducers.py
// _dequant_sum_stacked — so the sum equals the plain version's.
__global__ void maxmin_dequantize_sum_kernel(const uint8_t* __restrict__ q,
                                             const float* __restrict__ mn,
                                             const float* __restrict__ unit,
                                             int n_ranks, int64_t n_buckets,
                                             int bucket,
                                             float* __restrict__ out) {
  const int64_t total = n_buckets * bucket;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / bucket;
  float acc = 0.0f;
  for (int r = 0; r < n_ranks; ++r) {
    const int64_t m = r * n_buckets + b;
    const float v = __fadd_rn(
        mn[m], __fmul_rn(static_cast<float>(q[r * total + i]), unit[m]));
    acc = __fadd_rn(acc, v);
  }
  out[i] = acc;
}

unsigned int blocks_for(int64_t work, int per_block) {
  return static_cast<unsigned int>((work + per_block - 1) / per_block);
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

int hvd_maxmin_quantize_stochastic(const float* x, int64_t n,
                                   int64_t n_buckets, int bucket, int bits,
                                   uint64_t seed, uint64_t offset, uint8_t* q,
                                   float* mn, float* unit, void* stream) {
  const float levels = static_cast<float>((1 << bits) - 1);
  maxmin_quantize_stochastic_kernel<<<blocks_for(n_buckets, kQuantizeWarps),
                                      kQuantizeWarps * kWarp, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      x, n, n_buckets, bucket, levels, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), static_cast<uint32_t>(offset),
      static_cast<uint32_t>(offset >> 32), q, mn, unit);
  return static_cast<int>(cudaGetLastError());
}

int hvd_maxmin_dequantize(const uint8_t* q, const float* mn,
                          const float* unit, int64_t n_buckets, int bucket,
                          float* out, void* stream) {
  const int64_t total = n_buckets * bucket;
  maxmin_dequantize_kernel<<<blocks_for(total, kElementwiseThreads),
                             kElementwiseThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, mn, unit, total, bucket, out);
  return static_cast<int>(cudaGetLastError());
}

int hvd_maxmin_dequantize_sum(const uint8_t* q, const float* mn,
                              const float* unit, int n_ranks,
                              int64_t n_buckets, int bucket, float* out,
                              void* stream) {
  const int64_t total = n_buckets * bucket;
  maxmin_dequantize_sum_kernel<<<blocks_for(total, kElementwiseThreads),
                                 kElementwiseThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      q, mn, unit, n_ranks, n_buckets, bucket, out);
  return static_cast<int>(cudaGetLastError());
}

const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
