// FlashAttention kernels for Hopper (sm_90a), bound to Python with ctypes
// through the plain C functions at the end of this file.
//
// They replace the Pallas TPU kernels in horovod_tpu/ops/flash_attention.py:
//   B7 flash_fwd   <- _fwd_call    (_fwd_kernel): o and the row logsumexp
//   B8 flash_dkdv  <- _flash_bhsd_bwd's first pallas_call (_dkdv_kernel)
//   B9 flash_dq    <- _flash_bhsd_bwd's second pallas_call (_dq_kernel)
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [BH, S, D] row-major in bf16 or
// fp32; lse and delta = rowsum(dO * O) are fp32 [BH, S]. scale = 1/sqrt(D).
//
// Routes, chosen by type in the C entry points, never by a failed launch:
// bf16 B7, B8 and B9 run the tensor-core kernels of flash_attention_mma.cu
// (mma.sync tiles fed by cp.async; see the note there). fp32 runs the
// CUDA-core kernels of this file: tensor cores would take fp32 operands
// only as TF32, which misses the fp32 bound, and fp32 reaches these
// kernels only in checks.
//
// What bounds them on an H100: arithmetic. At the GPT path's shape
// (BH 16, S 4096, D 64, causal) B7 does 2 products of 2*D flops for each
// of the 8.4M causal (query, key) pairs of a head, B8 does 4 and B9 3: some
// 1,000 flops for every byte each kernel must move. The design answer of
// these kernels is the FlashAttention one, to keep the S x S logits
// out of device memory: each block holds its tiles in shared memory and
// recomputes the probabilities from q, k and the saved logsumexp, so device
// memory sees only the inputs and outputs. The products run on the CUDA
// cores in fp32 FMAs, as the TPU kernels' astype(f32) computes: each thread
// accumulates a 4 x 4 (or 4 x D/16) register tile from shared memory. That
// caps them far below the bound, at the fp32 FMA rate and the shared-memory
// load rate.
//
// The TPU kernels stream the contraction tiles along a sequential grid axis
// and carry the running softmax state across grid steps in VMEM scratch.
// CUDA blocks run in no order, so that axis becomes a loop inside each
// block: B7 and B9 take one (bh, 64-row query tile) per block and loop over
// key tiles (up to the diagonal when causal); B8 takes one (bh, 64-row key
// tile) and loops over query tiles (from the diagonal when causal). No
// block writes what another reads, so there are no atomics and the result
// does not depend on scheduling.
//
// Masking follows _mask_tile: causal keeps k_pos <= q_pos, bidirectional
// keeps k_pos < S; a masked logit is -1e30, not -inf, so exp never sees
// inf - inf. Rows and columns past S (the ragged last tile) and head-dim
// columns past D are read as zeros and never written, so S needs no
// padding and D is padded inside shared memory to the template's DP.
//
// All arithmetic is IEEE fp32 (expf, logf, division); do not build with
// --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace {

constexpr int kTile = 64;              // query rows and key rows per tile
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kGroup = 16;             // threads that share a tile row
constexpr int kRows = kTile / kGroup;  // tile rows each thread owns (4)
constexpr int kPStride = kTile + 1;    // padded row of the 64 x 64 tile
constexpr float kNegInf = -1e30f;      // the TPU kernels' _NEG_INF

// Rows [row0, row0 + 64) of a [S, D] slab into a [64][DP + 1] tile, each
// value multiplied by `mul` (q * scale, as the TPU kernels do). Zeros
// outside the slab. The +1 keeps the column reads of the products on
// distinct shared-memory banks.
template <int DP>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int row0, int S, int D, float mul) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP;
    const int d = idx % DP;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < S && d < D) v = src[static_cast<int64_t>(row) * D + d];
    tile[r * (DP + 1) + d] = v * mul;
  }
}

// 64 values of a [S] fp32 row vector into shared memory, zeros past S.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = row0 + r < S ? src[row0 + r] : 0.0f;
  }
}

// acc[a][b] = sum_k A[ty + 16a][k] * B[tx + 16b][k]: a 64 x 64 tile of
// A Bᵀ for two [64][DP + 1] tiles.
template <int DP>
__device__ __forceinline__ void product_abt(const float* A, const float* B,
                                            float acc[kRows][kRows], int ty,
                                            int tx) {
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < DP; ++k) {
    float av[kRows], bv[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) av[a] = A[(ty + kGroup * a) * (DP + 1) + k];
#pragma unroll
    for (int b = 0; b < kRows; ++b) bv[b] = B[(tx + kGroup * b) * (DP + 1) + k];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// acc[a][c] += sum_j P[ty + 16a][j] * B[j][tx + 16c]: P is a [64][65] tile,
// B a [64][DP + 1] tile.
template <int DP>
__device__ __forceinline__ void product_pb(const float* P, const float* B,
                                           float acc[kRows][DP / kGroup],
                                           int ty, int tx) {
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    float pv[kRows], bv[DP / kGroup];
#pragma unroll
    for (int a = 0; a < kRows; ++a) pv[a] = P[(ty + kGroup * a) * kPStride + j];
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) bv[c] = B[j * (DP + 1) + tx + kGroup * c];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < DP / kGroup; ++c)
        acc[a][c] = fmaf(pv[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_i P[i][ty + 16a] * B[i][tx + 16c]: the same with Pᵀ.
template <int DP>
__device__ __forceinline__ void product_ptb(const float* P, const float* B,
                                            float acc[kRows][DP / kGroup],
                                            int ty, int tx) {
#pragma unroll 8
  for (int i = 0; i < kTile; ++i) {
    float pv[kRows], bv[DP / kGroup];
#pragma unroll
    for (int a = 0; a < kRows; ++a) pv[a] = P[i * kPStride + ty + kGroup * a];
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) bv[c] = B[i * (DP + 1) + tx + kGroup * c];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < DP / kGroup; ++c)
        acc[a][c] = fmaf(pv[a], bv[c], acc[a][c]);
  }
}

__device__ __forceinline__ float masked(float s, int q_pos, int k_pos,
                                        bool causal, int S) {
  const bool keep = causal ? q_pos >= k_pos : k_pos < S;
  return keep ? s : kNegInf;
}

// Max and sum over the 16 threads of a row group (lanes that differ in
// their low four bits; the whole warp takes part).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// p = exp(s - lse) for a 64 x 64 tile of masked logits of (query tile q0,
// key tile k0), in place.
__device__ __forceinline__ void probs_from_lse(float s[kRows][kRows],
                                               const float* lse, int q0,
                                               int k0, bool causal, int S,
                                               int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = ty + kGroup * a;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float v = masked(s[a][b], q0 + r, k0 + tx + kGroup * b, causal, S);
      s[a][b] = expf(v - lse[r]);
    }
  }
}

// B7: one block per (64-row query tile, bh). Online softmax over the key
// tiles, in the order of _fwd_kernel: m' = max(m, rowmax s),
// p = exp(s - m'), l' = l exp(m - m') + rowsum p,
// acc' = acc exp(m - m') + p v; then o = acc / l and lse = m + log l, with
// l = 0 read as 1.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale,
                     bool causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (DP + 1);
  float* sV = sK + kTile * (DP + 1);
  float* sP = sV + kTile * (DP + 1);
  const int qt = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S;
  const int ty = threadIdx.x / kGroup;
  const int tx = threadIdx.x % kGroup;
  const int q0 = qt * kTile;

  load_tile<DP>(sQ, q + base * D, q0, S, D, scale);
  float m[kRows], l[kRows], acc[kRows][DP / kGroup];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) acc[a][c] = 0.0f;
  }
  const int last = causal ? qt : (S - 1) / kTile;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    load_tile<DP>(sK, k + base * D, k0, S, D, 1.0f);
    load_tile<DP>(sV, v + base * D, k0, S, D, 1.0f);
    __syncthreads();
    float s[kRows][kRows];
    product_abt<DP>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + kGroup * a;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        s[a][b] = masked(s[a][b], q0 + r, k0 + tx + kGroup * b, causal, S);
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], group_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const float p = expf(s[a][b] - m_new);
        sP[r * kPStride + tx + kGroup * b] = p;
        sum += p;
      }
      l[a] = l[a] * alpha + group_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DP / kGroup; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();
    product_pb<DP>(sP, sV, acc, ty, tx);
    __syncthreads();  // sK, sV and sP are overwritten next
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int row = q0 + ty + kGroup * a;
    if (row >= S) continue;
    const float safe = l[a] == 0.0f ? 1.0f : l[a];
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) {
      const int d = tx + kGroup * c;
      if (d < D) o[(base + row) * D + d] = acc[a][c] / safe;
    }
    if (tx == 0) lse[base + row] = m[a] + logf(safe);
  }
}

// B8: one block per (64-row key tile, bh), looping over the query tiles
// that see it. For each: p = exp(s - lse), dV += pᵀ dO, dP = dO Vᵀ,
// dS = p (dP - delta), dK += dSᵀ (q scale), as _dkdv_kernel.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int D, float scale,
                      bool causal) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (DP + 1);
  float* sQ = sV + kTile * (DP + 1);
  float* sO = sQ + kTile * (DP + 1);  // dO
  float* sP = sO + kTile * (DP + 1);  // p, then dS
  float* sL = sP + kTile * kPStride;  // lse
  float* sD = sL + kTile;             // delta
  const int kt = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S;
  const int ty = threadIdx.x / kGroup;
  const int tx = threadIdx.x % kGroup;
  const int k0 = kt * kTile;

  load_tile<DP>(sK, k + base * D, k0, S, D, 1.0f);
  load_tile<DP>(sV, v + base * D, k0, S, D, 1.0f);
  float gk[kRows][DP / kGroup], gv[kRows][DP / kGroup];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) gk[a][c] = gv[a][c] = 0.0f;
  const int n_tiles = (S + kTile - 1) / kTile;
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    load_tile<DP>(sQ, q + base * D, q0, S, D, scale);
    load_tile<DP>(sO, dout + base * D, q0, S, D, 1.0f);
    load_rows(sL, lse + base, q0, S);
    load_rows(sD, delta + base, q0, S);
    __syncthreads();
    float p[kRows][kRows];
    product_abt<DP>(sQ, sK, p, ty, tx);
    probs_from_lse(p, sL, q0, k0, causal, S, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        sP[(ty + kGroup * a) * kPStride + tx + kGroup * b] = p[a][b];
    __syncthreads();
    product_ptb<DP>(sP, sO, gv, ty, tx);
    float dp[kRows][kRows];
    product_abt<DP>(sO, sV, dp, ty, tx);
    __syncthreads();  // every read of p is done; sP takes dS
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + kGroup * a;
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        sP[r * kPStride + tx + kGroup * b] = p[a][b] * (dp[a][b] - sD[r]);
    }
    __syncthreads();
    product_ptb<DP>(sP, sQ, gk, ty, tx);
    __syncthreads();  // sQ, sO, sP, sL and sD are overwritten next
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int row = k0 + ty + kGroup * a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) {
      const int d = tx + kGroup * c;
      if (d >= D) continue;
      dk[(base + row) * D + d] = gk[a][c];
      dv[(base + row) * D + d] = gv[a][c];
    }
  }
}

// B9: one block per (64-row query tile, bh), looping over the key tiles it
// sees: dS = p (dO Vᵀ - delta), dQ += dS K; dQ is scaled once at the end,
// as _dq_kernel.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int D, float scale, bool causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile * (DP + 1);  // dO
  float* sK = sO + kTile * (DP + 1);
  float* sV = sK + kTile * (DP + 1);
  float* sP = sV + kTile * (DP + 1);  // dS
  float* sL = sP + kTile * kPStride;
  float* sD = sL + kTile;
  const int qt = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S;
  const int ty = threadIdx.x / kGroup;
  const int tx = threadIdx.x % kGroup;
  const int q0 = qt * kTile;

  load_tile<DP>(sQ, q + base * D, q0, S, D, scale);
  load_tile<DP>(sO, dout + base * D, q0, S, D, 1.0f);
  load_rows(sL, lse + base, q0, S);
  load_rows(sD, delta + base, q0, S);
  float gq[kRows][DP / kGroup];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) gq[a][c] = 0.0f;
  const int last = causal ? qt : (S - 1) / kTile;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    load_tile<DP>(sK, k + base * D, k0, S, D, 1.0f);
    load_tile<DP>(sV, v + base * D, k0, S, D, 1.0f);
    __syncthreads();
    float p[kRows][kRows], dp[kRows][kRows];
    product_abt<DP>(sQ, sK, p, ty, tx);
    probs_from_lse(p, sL, q0, k0, causal, S, ty, tx);
    product_abt<DP>(sO, sV, dp, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + kGroup * a;
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        sP[r * kPStride + tx + kGroup * b] = p[a][b] * (dp[a][b] - sD[r]);
    }
    __syncthreads();
    product_pb<DP>(sP, sK, gq, ty, tx);
    __syncthreads();  // sK, sV and sP are overwritten next
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int row = q0 + ty + kGroup * a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DP / kGroup; ++c) {
      const int d = tx + kGroup * c;
      if (d < D) dq[(base + row) * D + d] = gq[a][c] * scale;
    }
  }
}

constexpr size_t tile_bytes(int dp) {
  return static_cast<size_t>(kTile) * (dp + 1) * sizeof(float);
}
constexpr size_t fwd_smem(int dp) {
  return 3 * tile_bytes(dp) + kTile * kPStride * sizeof(float);
}
constexpr size_t bwd_smem(int dp) {
  return 4 * tile_bytes(dp) + (kTile * kPStride + 2 * kTile) * sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int S, int D, float scale, bool causal,
                cudaStream_t stream) {
  const size_t smem = fwd_smem(DP);
  cudaError_t err = prepare(flash_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, D, scale,
      causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int bh, int S, int D, float scale,
                 bool causal, cudaStream_t stream) {
  const size_t smem = bwd_smem(DP);
  cudaError_t err = prepare(flash_dkdv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_dkdv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, D, scale,
      causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out, int bh,
               int S, int D, float scale, bool causal, cudaStream_t stream) {
  const size_t smem = bwd_smem(DP);
  cudaError_t err = prepare(flash_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq_out), S, D, scale, causal);
  return cudaGetLastError();
}

// The head dimension padded to the tile width the kernel is built for:
// 16, 32, 64 or 128 (the wrapper accepts multiples of 8 up to 128).
#define HVD_FLASH_DISPATCH(fn, D, ...) \
  ((D) <= 16   ? fn<16>(__VA_ARGS__)     \
   : (D) <= 32 ? fn<32>(__VA_ARGS__)     \
   : (D) <= 64 ? fn<64>(__VA_ARGS__)     \
               : fn<128>(__VA_ARGS__))

}  // namespace

// The C interface: every function launches on `stream` and returns a CUDA
// error code (0 on success), so a refused launch reaches the caller.
// `is_bf16` selects bf16 tensors and the tensor-core kernels, else fp32
// tensors and the CUDA-core ones. hvd_flash_last_route reads the route the
// calling thread's last B7, B8 or B9 launch took, recorded in the branch
// that launched it: 1 the tensor-core kernels, 2 the CUDA-core ones.
namespace {
constexpr int kRouteMma = 1;
constexpr int kRouteCudaCore = 2;
thread_local int g_last_route = 0;
}  // namespace

extern "C" {

int hvd_flash_last_route(void) { return g_last_route; }

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int S, int D, float scale, int causal,
                  int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = hvd_flash_mma::fwd_bf16(q, k, v, o, lse, bh, S, D, scale,
                                  causal != 0, st);
    g_last_route = kRouteMma;
  } else {
    err = HVD_FLASH_DISPATCH(fwd, D, q, k, v, o, lse, bh, S, D, scale,
                             causal != 0, st);
    g_last_route = kRouteCudaCore;
  }
  return static_cast<int>(err);
}

int hvd_flash_dkdv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int bh, int S, int D, float scale,
                   int causal, int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = hvd_flash_mma::dkdv_bf16(q, k, v, dout, lse, delta, dk, dv, bh, S,
                                   D, scale, causal != 0, st);
    g_last_route = kRouteMma;
  } else {
    err = HVD_FLASH_DISPATCH(dkdv, D, q, k, v, dout, lse, delta, dk,
                             dv, bh, S, D, scale, causal != 0, st);
    g_last_route = kRouteCudaCore;
  }
  return static_cast<int>(err);
}

int hvd_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq_out, int bh, int S, int D, float scale, int causal,
                 int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = hvd_flash_mma::dq_bf16(q, k, v, dout, lse, delta, dq_out, bh, S, D,
                                 scale, causal != 0, st);
    g_last_route = kRouteMma;
  } else {
    err = HVD_FLASH_DISPATCH(dq, D, q, k, v, dout, lse, delta, dq_out, bh, S,
                             D, scale, causal != 0, st);
    g_last_route = kRouteCudaCore;
  }
  return static_cast<int>(err);
}

}  // extern "C"
