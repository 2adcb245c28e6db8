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
// Bytes moved, for n values in n_buckets buckets:
//   B5: 4n read + n_buckets*bucket codes + 4*n_buckets norms written
//   B6: n_buckets*bucket codes + 4*n_buckets norms read,
//       4*n_buckets*bucket written
// Both are bound by device-memory bytes at 4 bits (7 level comparisons per
// value); B5 at 8 bits does 127 comparisons per value, about 4 operations
// each, and is bound by operations. The design touches each byte once: B5
// reads a bucket from device memory once (the second pass hits L1), and
// the level table sits in shared memory, read as a broadcast.
//
// Rounding steps are spelled out with IEEE intrinsics (__fdiv_rn,
// __fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn) so nvcc cannot contract or
// approximate them: linf codes and norms and every decoded value are
// bitwise equal to the plain PyTorch versions in
// horovod_tpu_torch/compression/norm_kernels.py. The l2 sum runs in a
// warp's order, not the plain version's, so l2 norms agree to rtol 1e-6.
// Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kQuantizeWarps = 8;   // buckets per block in B5
constexpr int kDequantThreads = 128;
constexpr int kMaxLevels = 128;     // 8 bits: 7 index bits and a sign bit

// Max that passes a NaN through, as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || isnan(v)) ? v : acc;
}

__device__ __forceinline__ void load_levels(const float* __restrict__ levels,
                                            int n_levels, float* lv) {
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
}

// B5: one warp per bucket. The zero padding past `n` counts in the norm
// (it changes neither max|x| nor the sum) and is coded like any zero. A NaN
// makes the bucket's norm and every ratio NaN, so no distance compares less
// and every index is 0, as in the plain version and jnp.argmin.
__global__ void norm_quantize_kernel(const float* __restrict__ x, int64_t n,
                                     int64_t n_buckets, int bucket,
                                     const float* __restrict__ levels,
                                     int n_levels, int use_l2,
                                     uint8_t* __restrict__ q,
                                     float* __restrict__ norm_out) {
  __shared__ float lv[kMaxLevels];
  load_levels(levels, n_levels, lv);
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
    const float ratio = __fdiv_rn(fabsf(v), safe);
    float best_d = fabsf(__fsub_rn(ratio, lv[0]));
    int best = 0;
    for (int l = 1; l < n_levels; ++l) {
      const float d = fabsf(__fsub_rn(ratio, lv[l]));
      if (d < best_d) {
        best_d = d;
        best = l;
      }
    }
    q[base + j] = static_cast<uint8_t>((best << 1) | (v < 0.0f ? 1 : 0));
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

}  // namespace

// The C interface: every function launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller. `levels` is
// a device pointer to n_levels (1..128) fp32 values.
extern "C" {

int hvd_norm_quantize(const float* x, int64_t n, int64_t n_buckets,
                      int bucket, const float* levels, int n_levels,
                      int use_l2, uint8_t* q, float* norm, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>(
      (n_buckets + kQuantizeWarps - 1) / kQuantizeWarps);
  norm_quantize_kernel<<<blocks, kQuantizeWarps * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, n, n_buckets, bucket, levels, n_levels, use_l2, q, norm);
  return static_cast<int>(cudaGetLastError());
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
