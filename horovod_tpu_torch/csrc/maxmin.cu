// Max-min quantization kernels for Hopper (sm_90a), bound to Python with
// ctypes through the plain C functions at the end of this file.
//
// They replace the Pallas TPU kernels in horovod_tpu/compression/
// pallas_kernels.py:
//   B1 maxmin_quantize        <- maxmin_quantize_pallas   (_quantize_kernel)
//   B3 maxmin_dequantize_sum  <- maxmin_dequantize_sum_pallas
//                                (_dequantize_sum_kernel)
//   B4 maxmin_dequantize      <- maxmin_dequantize_pallas (_dequantize_kernel)
//
// All three do a handful of fp32 operations per byte they move, so on an
// H100 they are bound by device-memory bytes, not by operations. The design
// answer is to touch each byte once: B1 reads a bucket once from device
// memory (the second pass over it hits L1) and B3 decodes and sums every
// rank's codes in one pass instead of n dequantize passes plus n adds.
// Bytes moved, for n values in n_buckets buckets of `bucket` values:
//   B1: 4n read + n_buckets*bucket codes + 8*n_buckets min/unit written
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

// B1: one warp per bucket. Values past `n` are the zero padding of the
// last bucket and count in its min and max (quantize.py _bucketize).
// A NaN in a bucket makes its min and unit NaN, so every value decoded
// from it is NaN; the codes of such a bucket are 0 (fmaxf drops the NaN),
// as in the plain version.
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
