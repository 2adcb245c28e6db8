// Tensor-core FlashAttention dQ for bf16 on Hopper (sm_90a): mma.sync
// tiles fed by cp.async. flash_attention.cu's C entry points launch it for
// bf16 tensors; fp32 tensors keep that file's CUDA-core kernels, and bf16
// B7 and B8 run flash_attention_wgmma.cu's wgmma kernels.
//
// It replaces the Pallas TPU kernel of horovod_tpu/ops/flash_attention.py
//   B9 flash_dq   <- _flash_bhsd_bwd's second pallas_call (_dq_kernel).
//
// What bounds it on an H100: operations. At the GPT path's shape (BH 16,
// S 4096, D 64, causal) B9 does three products of 2 * D flops for each of
// the 134M causal (query, key) pairs, 51.6 GFLOP or 0.0521 ms at the
// card's 989 TFLOP/s of bf16. Every byte it must move is some thousand
// flops away, so the design keeps the logits in registers and the products
// on the tensor cores:
//   * a block of 4 warps owns a 64-row query tile; each warp owns 16 of its
//     rows and keeps them as mma A fragments in registers for the whole
//     loop over the key tiles;
//   * the loop's tiles stay bf16 in shared memory, loaded with 16-byte
//     cp.async copies into a two-stage ring, so tile j + 1 is in flight
//     while tile j computes; each row is padded by 16 bytes, which puts the
//     eight rows an ldmatrix reads on distinct banks;
//   * every product is mma.sync.m16n8k16 with fp32 accumulators. The
//     accumulator of one product, rounded to bf16, is the A fragment of
//     the next (flash_attention_mma.cuh), so dS never touches shared
//     memory; the other operand comes through ldmatrix, transposed where
//     the product contracts over its rows.
//
// Numerics against the fp32 plain version: the products of bf16 inputs
// are exact in fp32; the scale is applied to the fp32 logits after the
// product; dS is rounded to bf16 before it enters a product, a relative
// error of at most 2^-8, which the checks add to the bf16 bound as
// 4 * 2^-8 * scale * sqrt(sum dS^2 K^2): round to nearest errs both ways
// (flash_attention.py, mma_rounding_terms). Masks follow the TPU kernel
// and flash_attention.cu. Do not build with --use_fast_math.
//
// Layout as flash_attention.cu: [BH, S, D] row-major, lse and delta fp32
// [BH, S]. Rows past S and head-dim columns past D are zero-filled by the
// copies' source-size operand and never written; D is padded in shared
// memory to the template's DP in {16, 32, 64, 128}.

#include "flash_attention_mma.cuh"

#include <math.h>

namespace hvd_flash_mma {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // rows of a tile
constexpr int kThreads = 128;  // 4 warps of 16 rows each
constexpr int kTileN = kTile / 8;  // 8-column mma n-tiles across a tile
constexpr float kLog2e = 1.4426950408889634f;

// A tile's row in shared memory: DP bf16 and 16 bytes of padding.
template <int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 8;
}
template <int DP>
__host__ __device__ constexpr int tile_elems() {
  return kTile * row_stride<DP>();
}

// Rows [row0, row0 + 64) of a [S, D] bf16 slab into a tile, as 16-byte
// cp.async copies (D is a multiple of 8, so a 16-byte chunk lies wholly
// inside or outside the row). Chunks past S or D read nothing and land as
// zeros. Not committed: the caller groups the copies.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int row0, int S, int D) {
  constexpr int kChunks = DP / 8;
  static_assert(kTile * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const bool in = row < S && c * 8 < D;
    const bf16* from = in ? src + static_cast<int64_t>(row) * D + c * 8 : src;
    cp_async16(tile + r * row_stride<DP>() + c * 8, from, in ? 16 : 0);
  }
}

// ldmatrix address of this lane for the A fragment of rows [row0, +16),
// columns [col0, +16) of a tile, and, with ldmatrix .trans, for the B
// fragments of two n-tiles (columns col0 and col0 + 8) when the product
// contracts over rows [row0, +16): registers {b0, b1} of the first n-tile,
// then of the second.
template <int DP>
__device__ __forceinline__ const bf16* frag_rows(const bf16* tile, int row0,
                                                 int col0, int lane) {
  return tile + (row0 + (lane & 15)) * row_stride<DP>() + col0 +
         (lane >> 4) * 8;
}

// ldmatrix address (no .trans) for the B fragments of two n-tiles whose
// columns are the tile's rows [row0, +8) and [row0 + 8, +8), contracting
// over the tile's columns [col0, +16): registers {b0, b1} of the first
// n-tile, then of the second.
template <int DP>
__device__ __forceinline__ const bf16* frag_cols(const bf16* tile, int row0,
                                                 int col0, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * row_stride<DP>() +
         col0 + ((lane >> 3) & 1) * 8;
}

// acc[2i], acc[2i + 1] += A_kc x (B of the two n-tiles of rows 16 i .. of
// `tile`), contracting over the head dim: S = A Bᵀ with B's 64 rows as the
// output columns. `a(kc)` gives the A fragment of head-dim chunk kc.
template <int DP, typename AFrag>
__device__ __forceinline__ void product_abt(float acc[kTileN][4],
                                            const bf16* tile, int lane,
                                            AFrag a) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t af[4];
    a(kc, af);
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) {
      uint32_t b[4];
      ldmatrix_x4(b, frag_cols<DP>(tile, 16 * i, 16 * kc, lane));
      mma_bf16(acc[2 * i], af, b[0], b[1]);
      mma_bf16(acc[2 * i + 1], af, b[2], b[3]);
    }
  }
}

// out += C x tile, where C is a 16 x 64 accumulator in registers (rounded
// to bf16 here) and the product contracts over the tile's 64 rows.
template <int DP>
__device__ __forceinline__ void product_ct(float out[DP / 8][4],
                                           const float c[kTileN][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a_from_c(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, frag_rows<DP>(tile, 16 * kk, 16 * n, lane));
      mma_bf16(out[2 * n], a, b[0], b[1]);
      mma_bf16(out[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// B9: one block per (64-row query tile, bh), the longest causal rows first;
// it loops over the key tiles its rows see (up to the diagonal when
// causal), as _dq_kernel's grid does, and no block writes what another
// reads. Each warp holds its 16 query rows of Q and dO as A fragments (D
// <= 64; at D 128 it reloads them from shared memory per product, as B8
// does with K and V) and lse (in log2 units) and delta of its rows g and
// g + 8 in registers; K and V stream through the two-stage ring:
//   S = Q Kᵀ, P = exp(S scale - lse) (masked to 0), dP = dO Vᵀ,
//   dS = P (dP - delta), dQ += dS K;
// dS goes from the accumulators to the A fragment of dS K in registers,
// and K contracts over its rows through ldmatrix.trans. dQ is multiplied
// by scale once at the end, as _dq_kernel does.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int D, float scale,
                        bool causal) {
  constexpr bool kHold = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + tile_elems<DP>();      // dO
  bf16* sK = sO + tile_elems<DP>();      // two stages
  bf16* sV = sK + 2 * tile_elems<DP>();  // two stages

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const int64_t rows = static_cast<int64_t>(blockIdx.y) * S;
  const bf16* kb = k + rows * D;
  const bf16* vb = v + rows * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int last = causal ? qt : n_tiles - 1;

  load_tile<DP>(sQ, q + rows * D, q0, S, D);
  load_tile<DP>(sO, dout + rows * D, q0, S, D);
  cp_async_commit();
  load_tile<DP>(sK, kb, 0, S, D);
  load_tile<DP>(sV, vb, 0, S, D);
  cp_async_commit();
  // Rows past S read 0 for both: their q and dO are zeros, so dS is 0.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lse2[r] = row < S ? lse[rows + row] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[rows + row] : 0.0f;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kHold ? DP / 16 : 1][4], of[kHold ? DP / 16 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      ldmatrix_x4(qf[kc], frag_rows<DP>(sQ, 16 * warp, 16 * kc, lane));
      ldmatrix_x4(of[kc], frag_rows<DP>(sO, 16 * warp, 16 * kc, lane));
    }
  }
  auto q_frag = [&](int kc, uint32_t af[4]) {
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = qf[kc][i];
    } else {
      ldmatrix_x4(af, frag_rows<DP>(sQ, 16 * warp, 16 * kc, lane));
    }
  };
  auto o_frag = [&](int kc, uint32_t af[4]) {
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = of[kc][i];
    } else {
      ldmatrix_x4(af, frag_rows<DP>(sO, 16 * warp, 16 * kc, lane));
    }
  };

  float gq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[n][e] = 0.0f;
  const float scale_log2 = scale * kLog2e;

  for (int kt = 0; kt <= last; ++kt) {
    const int stage = kt & 1;
    if (kt < last) {
      load_tile<DP>(sK + (stage ^ 1) * tile_elems<DP>(), kb, (kt + 1) * kTile,
                    S, D);
      load_tile<DP>(sV + (stage ^ 1) * tile_elems<DP>(), vb, (kt + 1) * kTile,
                    S, D);
    }
    cp_async_commit();  // empty on the last tile: the wait stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tK = sK + stage * tile_elems<DP>();
    const bf16* tV = sV + stage * tile_elems<DP>();

    // S = Q Kᵀ, then P in place: rows are this warp's queries g and g + 8
    // (registers e / 2), columns the tile's keys 8 j + 2 t + e % 2.
    float s[kTileN][4];
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    product_abt<DP>(s, tK, lane, q_frag);
    const int k0 = kt * kTile;
    const bool need_mask = (causal && kt == qt) || k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (need_mask) {
          const int query = q0 + 16 * warp + g + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const bool keep = key < S && (!causal || query >= key);
          p = keep ? p : 0.0f;
        }
        s[j][e] = p;
      }

    float dp[kTileN][4];  // dP = dO Vᵀ
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.0f;
    product_abt<DP>(dp, tV, lane, o_frag);
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dl[e >> 1];  // dS

    product_ct<DP>(gq, s, tK, lane);  // dQ += bf16(dS) K
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(dq + (rows + row) * D + d) =
            pack_bf16(gq[n][2 * r] * scale, gq[n][2 * r + 1] * scale);
    }
  }
}

template <int DP>
constexpr size_t dq_smem() {
  return 6 * tile_elems<DP>() * sizeof(bf16);  // Q, dO, K x 2, V x 2
}

template <int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out, int bh,
               int S, int D, float scale, bool causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_dq_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq_out), S, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The head dimension padded to the template it is built for.
#define HVD_MMA_DISPATCH(fn, D, ...)              \
  ((D) <= 16   ? fn<16>(__VA_ARGS__)              \
   : (D) <= 32 ? fn<32>(__VA_ARGS__)              \
   : (D) <= 64 ? fn<64>(__VA_ARGS__)              \
               : fn<128>(__VA_ARGS__))

cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq_out, int bh, int S, int D, float scale,
                    bool causal, cudaStream_t stream) {
  return HVD_MMA_DISPATCH(dq, D, q, k, v, dout, lse, delta, dq_out, bh, S, D,
                          scale, causal, stream);
}

}  // namespace hvd_flash_mma
