// Batch norm with the activation that follows it, on channels-last tensors,
// for Hopper (sm_90a); bound to Python with ctypes through the plain C
// functions at the end of this file (wrapper: horovod_tpu_torch/models/
// norm_kernels.py).
//
// It replaces no TPU kernel: the JAX package leaves batch norm, the ReLU
// and the residual add of its ResNet to XLA, which fuses them. On the card
// PyTorch ran them as four batch-norm kernels and separate ReLU, add and
// threshold-backward passes, each reading and writing every activation
// again. These kernels fold the ReLU and the block's residual add into the
// norm's own passes.
//
// Layout: x is [rows, C] row-major (a channels-last [N, C, H, W] has rows
// N*H*W). C must be a multiple of 8, and every pointer to activations 16-
// byte aligned: the wrapper raises otherwise. A thread moves 8 channels of
// a row (16 bytes of bf16 or fp16, 32 of fp32); neighbouring lanes take
// neighbouring vectors of a row, up to 32 of them (a column tile of 256
// channels, blockIdx.y), and a warp takes 32 / (C / 8) rows at once where
// a row holds fewer than 32 vectors. Any row count works: the last chunk of
// rows is cut short. Offsets are 64-bit.
//
// With y = (x - mean) * invstd * weight + bias and n = rows:
//   bn_act_stats_kernel           per-channel sums of x - p and (x - p)^2
//                                 over a chunk of rows into fp32 partials
//                                 [2][chunks][C]; p = x[0, c], a pivot, so
//                                 the variance does not cancel as E[x^2] -
//                                 mean^2 does
//   bn_act_stats_finalize_kernel  the partials summed in fp64 in chunk
//                                 order: mean and invstd, and the running
//                                 statistics updated in place as flax does
//                                 (momentum on the old value, the biased
//                                 batch variance)
//   bn_act_apply_kernel           z = act(y [+ r]) in x's type, act ReLU or
//                                 none; eval mode takes mean and invstd
//                                 from the running statistics
//   bn_act_bwd_reduce_kernel      dy' = dz masked by ReLU's derivative
//                                 (below), else dz; the per-channel sums of
//                                 dy' and dy' (x - mean) into partials;
//                                 under ReLU after a residual add it also
//                                 writes dy', which is the residual's
//                                 gradient
//   bn_act_bwd_finalize_kernel    the partials in chunk order: dweight,
//                                 dbias and the coefficients of dx
//   bn_act_bwd_apply_kernel       dx = A dy' - B - D (x - mean), with A =
//                                 weight invstd, B = A mean(dy'), D = A
//                                 invstd^2 mean(dy' (x - mean)) (B = D = 0
//                                 in eval mode), from the dy' the reduce
//                                 wrote, or from dz masked again
//
// ReLU's mask: after a residual add it is z > 0 of the saved output z (the
// backward does not have the residual); after the norm alone it is y > 0 of
// the pre-activation recomputed from x (kMaskFromX), which spares reading
// z in both backward passes.
//
// Deterministic: no atomics. Every sum runs in an order that the shape and
// the card (its SM count and the kernels' occupancy, which size the
// chunks) fix, so two calls, eager or replayed from a CUDA graph, give the
// same bits.
//
// Bound: device-memory bytes. With v = rows * C values of b bytes:
// statistics read v b; apply reads v b (2 v b with a residual) and writes
// v b; the backward reduce reads 2 v b (3 v b under ReLU after a residual
// add, where it also writes v b); the backward apply reads 2 v b and writes
// v b. So a norm moves 8 v b a step with ReLU alone or with none, 11 v b
// with a residual add and ReLU, where PyTorch's composition moved 13, 8 and
// 16 v b.
// The partials are 8 C bytes a chunk, under 2% of v b at every shape of
// ResNet-50. The design is what such a bound asks for: 16-byte accesses,
// whole lines a warp, a full wave of resident blocks in the reductions,
// four rows' loads in flight a thread in the applies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // reductions and applies: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // channels a thread
constexpr int kTile = 32;        // vectors of a column tile
constexpr int kApplySteps = 4;   // row steps of an apply block
constexpr int kMinSteps = 4;     // fewest row steps of a reduction chunk
constexpr int kLanes = 32;       // finalize: chunk lanes of a channel
constexpr int kMaxDevices = 64;

// 8 values as loaded and stored: one 16-byte access for 16-bit types, two
// for fp32.
template <typename T>
struct Raw {
  uint4 a;
};
template <>
struct Raw<float> {
  float4 a, b;
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* p) {
  return Raw<T>{*reinterpret_cast<const uint4*>(p)};
}
template <>
__device__ __forceinline__ Raw<float> load_raw(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return Raw<float>{q[0], q[1]};
}

template <typename T>
__device__ __forceinline__ void store_raw(T* p, const Raw<T>& r) {
  *reinterpret_cast<uint4*>(p) = r.a;
}
template <>
__device__ __forceinline__ void store_raw(float* p, const Raw<float>& r) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = r.a;
  q[1] = r.b;
}

__device__ __forceinline__ void to_float(const Raw<float>& r,
                                         float (&v)[kVec]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
__device__ __forceinline__ void to_float(const Raw<__nv_bfloat16>& r,
                                         float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_float(const Raw<__half>& r,
                                         float (&v)[kVec]) {
  const __half2* h = reinterpret_cast<const __half2*>(&r.a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ Raw<T> from_float(const float (&v)[kVec]);
template <>
__device__ __forceinline__ Raw<float> from_float(const float (&v)[kVec]) {
  return Raw<float>{make_float4(v[0], v[1], v[2], v[3]),
                    make_float4(v[4], v[5], v[6], v[7])};
}
template <>
__device__ __forceinline__ Raw<__nv_bfloat16> from_float(
    const float (&v)[kVec]) {
  Raw<__nv_bfloat16> r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return r;
}
template <>
__device__ __forceinline__ Raw<__half> from_float(const float (&v)[kVec]) {
  Raw<__half> r;
  __half2* h = reinterpret_cast<__half2*>(&r.a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  }
  return r;
}

__device__ __forceinline__ float scalar_float(float v) { return v; }
__device__ __forceinline__ float scalar_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float scalar_float(__half v) {
  return __half2float(v);
}

// The calling thread's place: its vector (8 channels) of a row, its row
// within a step of rows_per_step rows, and whether it has one (a lane past
// the rows of its warp, or past C in the last column tile, has none).
struct Place {
  int vec;
  int sub_row;
  int rows_per_step;
  bool active;
};

__host__ __device__ __forceinline__ int tile_vectors(int c) {
  return c / kVec < kTile ? c / kVec : kTile;
}

__device__ __forceinline__ Place place(int c) {
  const int tile = tile_vectors(c);
  const int rows_per_warp = 32 / tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / tile;
  Place p;
  p.vec = blockIdx.y * kTile + lane % tile;
  p.sub_row = warp * rows_per_warp + sub;
  p.rows_per_step = kWarps * rows_per_warp;
  p.active = sub < rows_per_warp && p.vec < c / kVec;
  return p;
}

__host__ __device__ __forceinline__ int rows_per_step(int c) {
  return kWarps * (32 / tile_vectors(c));
}

// Each thread's two sums of 8 channels, through shared memory, into the
// block's partials: for each channel of the tile the threads that hold it
// are added warp by warp, row by row, always in that order.
__device__ __forceinline__ void block_partials(
    const float (&s1)[kVec], const float (&s2)[kVec], int c,
    float* __restrict__ partial, int n_chunks) {
  __shared__ float red[2][kVec][kThreads];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][j][threadIdx.x] = s1[j];
    red[1][j][threadIdx.x] = s2[j];
  }
  __syncthreads();
  const int tile = tile_vectors(c);
  const int rows_per_warp = 32 / tile;
  for (int q = threadIdx.x; q < 2 * kVec * tile; q += kThreads) {
    const int which = q / (kVec * tile);
    const int j = (q / tile) % kVec;
    const int tv = q % tile;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      for (int sub = 0; sub < rows_per_warp; ++sub) {
        sum += red[which][j][w * 32 + sub * tile + tv];
      }
    }
    const int ch = (blockIdx.y * kTile + tv) * kVec + j;
    if (ch < c) {
      partial[(static_cast<int64_t>(which) * n_chunks + blockIdx.x) * c +
              ch] = sum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_act_stats_kernel(
    const T* __restrict__ x, int64_t rows, int c, int64_t steps_per_chunk,
    float* __restrict__ partial, int n_chunks) {
  const Place p = place(c);
  float s1[kVec] = {}, s2[kVec] = {};
  if (p.active) {
    float pivot[kVec];
    to_float(load_raw(x + static_cast<int64_t>(p.vec) * kVec), pivot);
    const int64_t rps = p.rows_per_step;
    const int64_t begin = blockIdx.x * steps_per_chunk * rps;
    const int64_t end = min(rows, begin + steps_per_chunk * rps);
    const int64_t stride = rps * c;
    int64_t row = begin + p.sub_row;
    const T* at = x + row * c + p.vec * kVec;
    for (; row + 3 * rps < end; row += 4 * rps, at += 4 * stride) {
      Raw<T> raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) raw[u] = load_raw(at + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[kVec];
        to_float(raw[u], v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = v[j] - pivot[j];
          s1[j] += d;
          s2[j] = fmaf(d, d, s2[j]);
        }
      }
    }
    for (; row < end; row += rps, at += stride) {
      float v[kVec];
      to_float(load_raw(at), v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[j] - pivot[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
    }
  }
  block_partials(s1, s2, c, partial, n_chunks);
}

// The two sums of channel `ch` over the chunks, in fp64, in an order fixed
// by n_chunks: lane y adds chunks y, y + 32, ..., then lane 0 adds the
// lanes in order. Blocks are (32 channels, kLanes lanes).
__device__ __forceinline__ bool chunk_sums(const float* __restrict__ partial,
                                           int c, int n_chunks, double* t1,
                                           double* t2) {
  __shared__ double red[2][kLanes][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  double s1 = 0.0, s2 = 0.0;
  if (ch < c) {
    for (int k = threadIdx.y; k < n_chunks; k += kLanes) {
      s1 += partial[static_cast<int64_t>(k) * c + ch];
      s2 += partial[static_cast<int64_t>(n_chunks + k) * c + ch];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y != 0 || ch >= c) return false;
  double a = 0.0, b = 0.0;
  for (int y = 0; y < kLanes; ++y) {
    a += red[0][y][threadIdx.x];
    b += red[1][y][threadIdx.x];
  }
  *t1 = a;
  *t2 = b;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(32 * kLanes) bn_act_stats_finalize_kernel(
    const T* __restrict__ x, int64_t rows, int c,
    const float* __restrict__ partial, int n_chunks, float eps,
    float momentum, float* __restrict__ running_mean,
    float* __restrict__ running_var, float* __restrict__ mean,
    float* __restrict__ invstd) {
  double t1, t2;
  if (!chunk_sums(partial, c, n_chunks, &t1, &t2)) return;
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const double n = static_cast<double>(rows);
  const double shift = t1 / n;
  const double var = fmax(t2 / n - shift * shift, 0.0);
  const float m = static_cast<float>(scalar_float(x[ch]) + shift);
  mean[ch] = m;
  invstd[ch] = static_cast<float>(1.0 / sqrt(var + eps));
  running_mean[ch] = momentum * running_mean[ch] + (1.f - momentum) * m;
  running_var[ch] = momentum * running_var[ch] +
                    (1.f - momentum) * static_cast<float>(var);
}

// A norm's per-channel fp32 arrays: mean and stat (invstd, or the running
// variance when from_var: eval mode), weight and bias.
struct Channels {
  const float* mean;
  const float* stat;
  const float* weight;
  const float* bias;
  int from_var;
  float eps;
};

// The forward's terms of a thread's 8 channels, y = fmaf(x - m, scale, b).
// The apply and the backward's recomputed pre-activation both take them
// from here, so the two compute y with the same operations, bit for bit.
__device__ __forceinline__ void channel_terms(const Channels& k, int ch0,
                                              float (&m)[kVec],
                                              float (&scale)[kVec],
                                              float (&b)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float s = k.stat[ch0 + j];
    const float inv = k.from_var ? 1.f / sqrtf(s + k.eps) : s;
    m[j] = k.mean[ch0 + j];
    scale[j] = k.weight[ch0 + j] * inv;
    b[j] = k.bias[ch0 + j];
  }
}

template <typename T, bool kRelu, bool kResidual>
__global__ void __launch_bounds__(kThreads) bn_act_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ z,
    int64_t rows, int c, Channels k) {
  const Place p = place(c);
  if (!p.active) return;
  const int ch0 = p.vec * kVec;
  float m[kVec], scale[kVec], b[kVec];
  channel_terms(k, ch0, m, scale, b);
  const int64_t rps = p.rows_per_step;
  const int64_t first = blockIdx.x * kApplySteps * rps + p.sub_row;
  Raw<T> xs[kApplySteps], rs[kApplySteps];
#pragma unroll
  for (int u = 0; u < kApplySteps; ++u) {
    const int64_t row = first + u * rps;
    if (row < rows) {
      xs[u] = load_raw(x + row * c + ch0);
      if (kResidual) rs[u] = load_raw(r + row * c + ch0);
    }
  }
#pragma unroll
  for (int u = 0; u < kApplySteps; ++u) {
    const int64_t row = first + u * rps;
    if (row >= rows) break;
    float v[kVec], res[kVec];
    to_float(xs[u], v);
    if (kResidual) to_float(rs[u], res);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float y = fmaf(v[j] - m[j], scale[j], b[j]);
      if (kResidual) y += res[j];
      // NaN passes through, as torch.relu lets it.
      if (kRelu) y = y < 0.f ? 0.f : y;
      v[j] = y;
    }
    store_raw(z + row * c + ch0, from_float<T>(v));
  }
}

// How the backward finds dy' from dz. kMaskFromZ: z > 0, z the saved
// output (ReLU after a residual add, whose input the backward does not
// have). kMaskFromX: y > 0, y the forward's pre-activation recomputed from
// x by channel_terms, the same fp32 value the apply rounded into z; so the
// mask is z > 0 except where a positive y rounds to 0 in x's type (under
// 2^-133 in bf16, 2^-25 in fp16), where it lets the gradient through as
// ReLU's derivative at y does. It spares reading z.
constexpr int kNoMask = 0, kMaskFromZ = 1, kMaskFromX = 2;

template <int kMask>
__device__ __forceinline__ void mask_dy(float (&dy)[kVec],
                                        const float (&v)[kVec],
                                        const float (&out)[kVec],
                                        const float (&m)[kVec],
                                        const float (&scale)[kVec],
                                        const float (&b)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (kMask == kMaskFromZ) dy[j] = out[j] > 0.f ? dy[j] : 0.f;
    if (kMask == kMaskFromX) {
      dy[j] = fmaf(v[j] - m[j], scale[j], b[j]) > 0.f ? dy[j] : 0.f;
    }
  }
}

// kMask == kMaskFromZ writes dy' to dy_out.
template <typename T, int kMask>
__global__ void __launch_bounds__(kThreads) bn_act_bwd_reduce_kernel(
    const T* __restrict__ dz, const T* __restrict__ x,
    const T* __restrict__ z, T* __restrict__ dy_out, int64_t rows, int c,
    int64_t steps_per_chunk, Channels k, float* __restrict__ partial,
    int n_chunks) {
  const Place p = place(c);
  float s1[kVec] = {}, s2[kVec] = {};
  if (p.active) {
    const int ch0 = p.vec * kVec;
    float m[kVec], scale[kVec], b[kVec];
    channel_terms(k, ch0, m, scale, b);
    const int64_t rps = p.rows_per_step;
    const int64_t begin = blockIdx.x * steps_per_chunk * rps;
    const int64_t end = min(rows, begin + steps_per_chunk * rps);
    for (int64_t row = begin + p.sub_row; row < end; row += 2 * rps) {
      Raw<T> g[2], xs[2], zs[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t at = (row + u * rps) * c + ch0;
        if (u == 0 || row + rps < end) {
          g[u] = load_raw(dz + at);
          xs[u] = load_raw(x + at);
          if (kMask == kMaskFromZ) zs[u] = load_raw(z + at);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && row + rps >= end) break;
        float dy[kVec], v[kVec], out[kVec];
        to_float(g[u], dy);
        to_float(xs[u], v);
        if (kMask == kMaskFromZ) to_float(zs[u], out);
        mask_dy<kMask>(dy, v, out, m, scale, b);
        if (kMask == kMaskFromZ) {
          store_raw(dy_out + (row + u * rps) * c + ch0, from_float<T>(dy));
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s1[j] += dy[j];
          s2[j] = fmaf(dy[j], v[j] - m[j], s2[j]);
        }
      }
    }
  }
  block_partials(s1, s2, c, partial, n_chunks);
}

// coef is [3][C]: A, B and D of dx = A dy' - B - D (x - mean).
__global__ void __launch_bounds__(32 * kLanes) bn_act_bwd_finalize_kernel(
    int64_t rows, int c, const float* __restrict__ partial, int n_chunks,
    Channels k, int training, float* __restrict__ dweight,
    float* __restrict__ dbias, float* __restrict__ coef) {
  double t1, t2;
  if (!chunk_sums(partial, c, n_chunks, &t1, &t2)) return;
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const double inv = k.from_var
                         ? 1.0 / sqrt(static_cast<double>(k.stat[ch]) +
                                      static_cast<double>(k.eps))
                         : static_cast<double>(k.stat[ch]);
  const double a = static_cast<double>(k.weight[ch]) * inv;
  const double n = static_cast<double>(rows);
  dbias[ch] = static_cast<float>(t1);
  dweight[ch] = static_cast<float>(t2 * inv);
  coef[ch] = static_cast<float>(a);
  coef[c + ch] = training ? static_cast<float>(a * t1 / n) : 0.f;
  coef[2 * c + ch] = training ? static_cast<float>(a * inv * inv * t2 / n)
                              : 0.f;
}

// kMask is kNoMask (dy is dz, or the dy' the reduce wrote) or kMaskFromX.
template <typename T, int kMask>
__global__ void __launch_bounds__(kThreads) bn_act_bwd_apply_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
    int64_t rows, int c, Channels k, const float* __restrict__ coef) {
  const Place p = place(c);
  if (!p.active) return;
  const int ch0 = p.vec * kVec;
  float m[kVec], scale[kVec], b[kVec], ca[kVec], cb[kVec], cd[kVec];
  channel_terms(k, ch0, m, scale, b);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    ca[j] = coef[ch0 + j];
    cb[j] = coef[c + ch0 + j];
    cd[j] = coef[2 * c + ch0 + j];
  }
  const int64_t rps = p.rows_per_step;
  const int64_t first = blockIdx.x * kApplySteps * rps + p.sub_row;
  Raw<T> gs[kApplySteps], xs[kApplySteps];
#pragma unroll
  for (int u = 0; u < kApplySteps; ++u) {
    const int64_t row = first + u * rps;
    if (row < rows) {
      gs[u] = load_raw(dy + row * c + ch0);
      xs[u] = load_raw(x + row * c + ch0);
    }
  }
#pragma unroll
  for (int u = 0; u < kApplySteps; ++u) {
    const int64_t row = first + u * rps;
    if (row >= rows) break;
    float g[kVec], v[kVec];
    to_float(gs[u], g);
    to_float(xs[u], v);
    mask_dy<kMask>(g, v, v, m, scale, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = fmaf(ca[j], g[j], -fmaf(cd[j], v[j] - m[j], cb[j]));
    }
    store_raw(dx + row * c + ch0, from_float<T>(v));
  }
}

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// Resident blocks of 256 threads the whole card holds of the statistics
// kernel (backward = 0) or of the backward reduce (1), read once a device.
int resident_blocks(int backward) {
  static int cached[kMaxDevices][2];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  int& slot = cached[dev][backward ? 1 : 0];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (backward) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bn_act_bwd_reduce_kernel<__nv_bfloat16, kMaskFromZ>,
          kThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bn_act_stats_kernel<__nv_bfloat16>, kThreads, 0);
    }
    slot = sms * per_sm;
  }
  return slot;
}

int64_t steps_of(int64_t rows, int c) {
  const int64_t rps = rows_per_step(c);
  return (rows + rps - 1) / rps;
}

int64_t steps_per_chunk(int64_t rows, int c, int n_chunks) {
  return (steps_of(rows, c) + n_chunks - 1) / n_chunks;
}

unsigned int column_tiles(int c) {
  return static_cast<unsigned int>((c / kVec + kTile - 1) / kTile);
}

bool bad_shape(int64_t rows, int c) {
  return rows < 1 || c < kVec || c % kVec != 0;
}

int status() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int stats(const void* x, int64_t rows, int c, int n_chunks, float* partial,
          cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(n_chunks), column_tiles(c));
  bn_act_stats_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), rows, c, steps_per_chunk(rows, c, n_chunks),
      partial, n_chunks);
  return status();
}

template <typename T>
int stats_finalize(const void* x, int64_t rows, int c, const float* partial,
                   int n_chunks, float eps, float momentum,
                   float* running_mean, float* running_var, float* mean,
                   float* invstd, cudaStream_t s) {
  bn_act_stats_finalize_kernel<T>
      <<<(c + 31) / 32, dim3(32, kLanes), 0, s>>>(
          static_cast<const T*>(x), rows, c, partial, n_chunks, eps,
          momentum, running_mean, running_var, mean, invstd);
  return status();
}

template <typename T>
int apply(const void* x, const void* r, void* z, int64_t rows, int c,
          const Channels& k, int relu, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(
                      (steps_of(rows, c) + kApplySteps - 1) / kApplySteps),
                  column_tiles(c));
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* zt = static_cast<T*>(z);
#define HVD_BN_APPLY(RELU, RES) \
  bn_act_apply_kernel<T, RELU, RES><<<grid, kThreads, 0, s>>>(xt, rt, zt, \
                                                              rows, c, k)
  if (relu && r) {
    HVD_BN_APPLY(true, true);
  } else if (relu) {
    HVD_BN_APPLY(true, false);
  } else if (r) {
    HVD_BN_APPLY(false, true);
  } else {
    HVD_BN_APPLY(false, false);
  }
#undef HVD_BN_APPLY
  return status();
}

template <typename T>
int bwd_reduce(const void* dz, const void* x, const void* z, void* dy_out,
               int64_t rows, int c, int n_chunks, const Channels& k,
               int mask, float* partial, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(n_chunks), column_tiles(c));
  const int64_t spc = steps_per_chunk(rows, c, n_chunks);
  const T* g = static_cast<const T*>(dz);
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  T* out = static_cast<T*>(dy_out);
#define HVD_BN_REDUCE(MASK)                                          \
  bn_act_bwd_reduce_kernel<T, MASK><<<grid, kThreads, 0, s>>>(       \
      g, xt, zt, out, rows, c, spc, k, partial, n_chunks)
  if (mask == kMaskFromZ) {
    HVD_BN_REDUCE(kMaskFromZ);
  } else if (mask == kMaskFromX) {
    HVD_BN_REDUCE(kMaskFromX);
  } else {
    HVD_BN_REDUCE(kNoMask);
  }
#undef HVD_BN_REDUCE
  return status();
}

template <typename T>
int bwd_apply(const void* dy, const void* x, void* dx, int64_t rows, int c,
              const Channels& k, const float* coef, int mask_from_x,
              cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(
                      (steps_of(rows, c) + kApplySteps - 1) / kApplySteps),
                  column_tiles(c));
  const T* g = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* out = static_cast<T*>(dx);
  if (mask_from_x) {
    bn_act_bwd_apply_kernel<T, kMaskFromX><<<grid, kThreads, 0, s>>>(
        g, xt, out, rows, c, k, coef);
  } else {
    bn_act_bwd_apply_kernel<T, kNoMask><<<grid, kThreads, 0, s>>>(
        g, xt, out, rows, c, k, coef);
  }
  return status();
}

}  // namespace

#define HVD_BN_DISPATCH(DTYPE, CALL)                                  \
  switch (DTYPE) {                                                    \
    case kF32: return CALL(float);                                    \
    case kBF16: return CALL(__nv_bfloat16);                           \
    case kF16: return CALL(__half);                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

// The C interface: every launcher launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller, or
// cudaErrorInvalidValue for a shape or type it does not take (C not a
// multiple of 8, no rows). dtype: 0 fp32, 1 bf16, 2 fp16. Activations are
// [rows, C] row-major and 16-byte aligned; per-channel arrays are fp32
// [C] (any 4-byte alignment); partials fp32 [2][n_chunks][C].
extern "C" {

// The chunks of rows the reductions split [rows, C] into (the first
// dimension of their partials): enough blocks for one full wave of the
// kernel on this card (backward: the backward reduce, else the
// statistics), each at least kMinSteps steps of rows. 0 on a bad shape.
int hvd_bn_chunks(int64_t rows, int c, int backward) {
  if (bad_shape(rows, c)) return 0;
  const int64_t tiles = column_tiles(c);
  const int64_t blocks = resident_blocks(backward);
  const int64_t want = blocks / tiles > 1 ? blocks / tiles : 1;
  const int64_t steps = steps_of(rows, c);
  int64_t per_chunk = (steps + want - 1) / want;
  if (per_chunk < kMinSteps) per_chunk = kMinSteps;
  return static_cast<int>((steps + per_chunk - 1) / per_chunk);
}

int hvd_bn_stats(const void* x, int dtype, int64_t rows, int c,
                 int n_chunks, float* partial, void* stream) {
  if (bad_shape(rows, c) || n_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_CALL(T) stats<T>(x, rows, c, n_chunks, partial, s)
  HVD_BN_DISPATCH(dtype, HVD_CALL)
#undef HVD_CALL
}

// Also folds mean and the biased variance into the running statistics
// with weight 1 - momentum.
int hvd_bn_stats_finalize(const void* x, int dtype, int64_t rows, int c,
                          const float* partial, int n_chunks, float eps,
                          float momentum, float* running_mean,
                          float* running_var, float* mean, float* invstd,
                          void* stream) {
  if (bad_shape(rows, c) || n_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_CALL(T)                                             \
  stats_finalize<T>(x, rows, c, partial, n_chunks, eps, momentum, \
                    running_mean, running_var, mean, invstd, s)
  HVD_BN_DISPATCH(dtype, HVD_CALL)
#undef HVD_CALL
}

// r: the residual ([rows, C], x's type) or null. stat: invstd, or the
// running variance when from_var.
int hvd_bn_apply(const void* x, const void* r, void* z, int dtype,
                 int64_t rows, int c, const float* mean, const float* stat,
                 int from_var, float eps, const float* weight,
                 const float* bias, int relu, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Channels k{mean, stat, weight, bias, from_var, eps};
#define HVD_CALL(T) apply<T>(x, r, z, rows, c, k, relu, s)
  HVD_BN_DISPATCH(dtype, HVD_CALL)
#undef HVD_CALL
}

// mask: 0 none (dy' = dz), 1 from the saved output z, writing dy' to
// dy_out, 2 from the pre-activation recomputed from x (see kMaskFromX).
int hvd_bn_bwd_reduce(const void* dz, const void* x, const void* z,
                      void* dy_out, int dtype, int64_t rows, int c,
                      int n_chunks, const float* mean, const float* stat,
                      int from_var, float eps, const float* weight,
                      const float* bias, int mask, float* partial,
                      void* stream) {
  if (bad_shape(rows, c) || n_chunks < 1 || mask < kNoMask ||
      mask > kMaskFromX || (mask == kMaskFromZ && (!z || !dy_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Channels k{mean, stat, weight, bias, from_var, eps};
#define HVD_CALL(T)                                                   \
  bwd_reduce<T>(dz, x, z, dy_out, rows, c, n_chunks, k, mask, partial, s)
  HVD_BN_DISPATCH(dtype, HVD_CALL)
#undef HVD_CALL
}

// training = 0 gives eval mode's dx (B = D = 0). coef receives [3][C].
int hvd_bn_bwd_finalize(int64_t rows, int c, const float* partial,
                        int n_chunks, const float* stat, int from_var,
                        float eps, const float* weight, int training,
                        float* dweight, float* dbias, float* coef,
                        void* stream) {
  if (bad_shape(rows, c) || n_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Channels k{nullptr, stat, weight, nullptr, from_var, eps};
  bn_act_bwd_finalize_kernel<<<(c + 31) / 32, dim3(32, kLanes), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      rows, c, partial, n_chunks, k, training, dweight, dbias, coef);
  return status();
}

// dy: dz, or the dy' the reduce wrote; mask_from_x: mask dz as the reduce's
// mode 2 does.
int hvd_bn_bwd_apply(const void* dy, const void* x, void* dx, int dtype,
                     int64_t rows, int c, const float* mean,
                     const float* stat, int from_var, float eps,
                     const float* weight, const float* bias,
                     const float* coef, int mask_from_x, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Channels k{mean, stat, weight, bias, from_var, eps};
#define HVD_CALL(T) \
  bwd_apply<T>(dy, x, dx, rows, c, k, coef, mask_from_x, s)
  HVD_BN_DISPATCH(dtype, HVD_CALL)
#undef HVD_CALL
}

}  // extern "C"

#undef HVD_BN_DISPATCH
