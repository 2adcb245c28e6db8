// Tensor-core FlashAttention for bf16 on Hopper (sm_90a): mma.sync tiles
// fed by cp.async. flash_attention.cu's C entry points launch these for
// bf16 tensors; fp32 tensors keep that file's CUDA-core kernels.
//
// They replace the three Pallas TPU kernels of
// horovod_tpu/ops/flash_attention.py:
//   B7 flash_fwd  <- _fwd_call (_fwd_kernel): o and the row logsumexp;
//   B8 flash_dkdv <- _flash_bhsd_bwd's first pallas_call (_dkdv_kernel);
//   B9 flash_dq   <- _flash_bhsd_bwd's second pallas_call (_dq_kernel).
//
// What bounds them on an H100: operations. At the GPT path's shape (BH 16,
// S 4096, D 64, causal) B7 does two products of 2 * D flops for each of
// the 134M causal (query, key) pairs, 34.4 GFLOP in all, 0.0348 ms at the
// card's 989 TFLOP/s of bf16; B8 does four, twice that; B9 three, 51.6
// GFLOP or 0.0521 ms. Every byte they must move is some thousand flops
// away, so the design keeps the logits in registers and the products on
// the tensor cores:
//   * a block of 4 warps owns a 64-row tile (queries in B7 and B9, keys in
//     B8); each warp owns 16 of its rows and keeps them as mma A fragments
//     in registers for the whole loop over the other operand's tiles;
//   * the loop's tiles stay bf16 in shared memory, loaded with 16-byte
//     cp.async copies into a two-stage ring, so tile j + 1 is in flight
//     while tile j computes; each row is padded by 16 bytes, which puts the
//     eight rows an ldmatrix reads on distinct banks;
//   * every product is mma.sync.m16n8k16 with fp32 accumulators. The
//     accumulator of one product, rounded to bf16, is the A fragment of
//     the next (flash_attention_mma.cuh), so P and dS never touch shared
//     memory; the other operand comes through ldmatrix, transposed where
//     the product contracts over its rows.
//
// Numerics against the fp32 plain versions: the products of bf16 inputs
// are exact in fp32; the scale is applied to the fp32 logits after the
// product; P (B7, B8) and dS (B8, B9) are rounded to bf16 before they
// enter a product, a relative error of at most 2^-8 each, which the
// checks add to the bf16 bound as 4 * 2^-8 * sqrt(sum P^2 V^2) (o),
// sqrt(sum P^2 dO^2) (dV), scale * sqrt(sum dS^2 Q^2) (dK) and
// scale * sqrt(sum dS^2 K^2) (dQ): round to nearest errs both ways
// (flash_attention.py, mma_rounding_terms). B7
// takes exp2 of logits pre-scaled by log2(e) (P is rounded to bf16
// anyway); lse stays fp32 in natural-log units. Masks, the -1e30 masked
// logit and l = 0 read as 1 follow the TPU kernels and flash_attention.cu.
// Do not build with --use_fast_math.
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
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// B7: one block per (64-row query tile, bh), the longest causal rows
// first. Each warp keeps its 16 query rows as A fragments and the online
// softmax state of _fwd_kernel for its rows g and g + 8 (in log2 units):
// m' = max(m, rowmax s), p = 2^(s - m'), l' = l 2^(m - m') + rowsum p,
// acc' = acc 2^(m - m') + p v; then o = acc / l and lse = (m + log2 l) ln 2,
// with l = 0 read as 1.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 2)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int S, int D, float scale,
                         bool causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + tile_elems<DP>();      // two stages
  bf16* sV = sK + 2 * tile_elems<DP>();  // two stages

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const int64_t rows = static_cast<int64_t>(blockIdx.y) * S;
  const bf16* qb = q + rows * D;
  const bf16* kb = k + rows * D;
  const bf16* vb = v + rows * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int last = causal ? qt : n_tiles - 1;

  load_tile<DP>(sQ, qb, q0, S, D);
  cp_async_commit();
  load_tile<DP>(sK, kb, 0, S, D);
  load_tile<DP>(sV, vb, 0, S, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ldmatrix_x4(qf[kc], frag_rows<DP>(sQ, 16 * warp, 16 * kc, lane));

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
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

    float s[kTileN][4];
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    product_abt<DP>(s, tK, lane, [&](int kc, uint32_t af[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = qf[kc][i];
    });

    // Scale (in log2 units), mask, and the online softmax of rows g and
    // g + 8 (registers e / 2 = 0 and 1).
    const int k0 = kt * kTile;
    const bool need_mask = causal ? kt == qt : k0 + kTile > S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int row = q0 + 16 * warp + g + 8 * (e >> 1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool keep = causal ? row >= col : col < S;
          x = keep ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    product_ct<DP>(acc, s, tV, lane);  // acc += bf16(p) v
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= S) continue;
    const float safe = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(o + (rows + row) * D + d) =
            pack_bf16(acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
    }
    if (t == 0) lse[rows + row] = (m[r] + log2f(safe)) * kLn2;
  }
}

// One query tile of B8's ring: q and dO rows (bf16), lse and delta (fp32,
// zeros past S), as cp.async copies of one group.
template <int DP>
__device__ __forceinline__ void load_query_tile(
    bf16* tQ, bf16* tO, float* tL, float* tD, const bf16* qb, const bf16* ob,
    const float* lb, const float* db, int q0, int S, int D) {
  load_tile<DP>(tQ, qb, q0, S, D);
  load_tile<DP>(tO, ob, q0, S, D);
  const int r = threadIdx.x % kTile;  // threads 0..63 lse, 64..127 delta
  const float* src = threadIdx.x < kTile ? lb : db;
  float* dst = threadIdx.x < kTile ? tL : tD;
  const bool in = q0 + r < S;
  cp_async4(dst + r, in ? src + q0 + r : src, in ? 4 : 0);
}

// B8: one block per (64-row key tile, bh), the longest causal loop first;
// it loops over the query tiles that see its keys (from the diagonal when
// causal), as _dkdv_kernel's grid does, and no block writes what another
// reads. Each warp holds its 16 key rows of K and V as A fragments (D <=
// 64; at D 128 it reloads them from shared memory per product, to stay
// within 255 registers) and works on the transposed tile, whose
// accumulators are the A fragments of the next products:
//   Sᵀ = K Qᵀ, Pᵀ = exp(Sᵀ scale - lse) (masked to 0),
//   dV += Pᵀ dO, dPᵀ = V dOᵀ, dSᵀ = Pᵀ (dPᵀ - delta), dK += dSᵀ Q;
// dK is multiplied by scale once at the end (_dkdv_kernel's q carries it).
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                          int D, float scale, bool causal) {
  constexpr bool kHold = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + tile_elems<DP>();
  bf16* sQ = sV + tile_elems<DP>();       // two stages
  bf16* sO = sQ + 2 * tile_elems<DP>();   // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * tile_elems<DP>());  // 2 x 64
  float* sD = sL + 2 * kTile;                                        // 2 x 64

  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int64_t rows = static_cast<int64_t>(blockIdx.y) * S;
  const bf16* qb = q + rows * D;
  const bf16* ob = dout + rows * D;
  const float* lb = lse + rows;
  const float* db = delta + rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int first = causal ? kt : 0;

  load_tile<DP>(sK, k + rows * D, k0, S, D);
  load_tile<DP>(sV, v + rows * D, k0, S, D);
  cp_async_commit();
  load_query_tile<DP>(sQ, sO, sL, sD, qb, ob, lb, db, first * kTile, S, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[kHold ? DP / 16 : 1][4], vf[kHold ? DP / 16 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      ldmatrix_x4(kf[kc], frag_rows<DP>(sK, 16 * warp, 16 * kc, lane));
      ldmatrix_x4(vf[kc], frag_rows<DP>(sV, 16 * warp, 16 * kc, lane));
    }
  }
  auto k_frag = [&](int kc, uint32_t af[4]) {
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = kf[kc][i];
    } else {
      ldmatrix_x4(af, frag_rows<DP>(sK, 16 * warp, 16 * kc, lane));
    }
  };
  auto v_frag = [&](int kc, uint32_t af[4]) {
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = vf[kc][i];
    } else {
      ldmatrix_x4(af, frag_rows<DP>(sV, 16 * warp, 16 * kc, lane));
    }
  };

  float gk[DP / 8][4], gv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.0f;
  const float scale_log2 = scale * kLog2e;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int stage = (qt - first) & 1;
    if (qt + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      load_query_tile<DP>(sQ + nxt * tile_elems<DP>(),
                          sO + nxt * tile_elems<DP>(), sL + nxt * kTile,
                          sD + nxt * kTile, qb, ob, lb, db, (qt + 1) * kTile,
                          S, D);
    }
    cp_async_commit();  // empty on the last tile: the wait stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tQ = sQ + stage * tile_elems<DP>();
    const bf16* tO = sO + stage * tile_elems<DP>();
    const float* tL = sL + stage * kTile;
    const float* tD = sD + stage * kTile;
    const int q0 = qt * kTile;

    // Sᵀ = K Qᵀ, then Pᵀ in place: rows are this warp's keys g and g + 8
    // (registers e / 2), columns the tile's queries 8 j + 2 t + e % 2.
    float st[kTileN][4];
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
    product_abt<DP>(st, tQ, lane, k_frag);
    const bool need_mask = (causal && qt == kt) || q0 + kTile > S;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const float lse2 = tL[col] * kLog2e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p = exp2f(fmaf(st[j][2 * r + c], scale_log2, -lse2));
          if (need_mask) {
            const int key = k0 + 16 * warp + g + 8 * r;
            const int query = q0 + col;
            const bool keep = query < S && (!causal || query >= key);
            p = keep ? p : 0.0f;
          }
          st[j][2 * r + c] = p;
        }
      }

    product_ct<DP>(gv, st, tO, lane);  // dV += bf16(Pᵀ) dO

    float dpt[kTileN][4];  // dPᵀ = V dOᵀ
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.0f;
    product_abt<DP>(dpt, tO, lane, v_frag);
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl = tD[8 * j + 2 * t + c];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st[j][2 * r + c] *= dpt[j][2 * r + c] - dl;  // dSᵀ
      }

    product_ct<DP>(gk, st, tQ, lane);  // dK += bf16(dSᵀ) Q
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + 16 * warp + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d >= D) continue;
      const int64_t at = (rows + row) * D + d;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(gk[n][2 * r] * scale, gk[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(gv[n][2 * r], gv[n][2 * r + 1]);
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
constexpr size_t fwd_smem() {
  return 5 * tile_elems<DP>() * sizeof(bf16);  // Q, K x 2, V x 2
}
template <int DP>
constexpr size_t dkdv_smem() {
  return 6 * tile_elems<DP>() * sizeof(bf16) + 4 * kTile * sizeof(float);
}
template <int DP>
constexpr size_t dq_smem() {
  return 6 * tile_elems<DP>() * sizeof(bf16);  // Q, dO, K x 2, V x 2
}

template <int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int S, int D, float scale, bool causal,
                cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_fwd_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, D, scale,
      causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int bh, int S, int D, float scale,
                 bool causal, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, bh);
  flash_dkdv_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, D, scale, causal);
  return cudaGetLastError();
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

cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int S, int D, float scale,
                     bool causal, cudaStream_t stream) {
  return HVD_MMA_DISPATCH(fwd, D, q, k, v, o, lse, bh, S, D, scale, causal,
                          stream);
}

cudaError_t dkdv_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int bh, int S, int D, float scale,
                      bool causal, cudaStream_t stream) {
  return HVD_MMA_DISPATCH(dkdv, D, q, k, v, dout, lse, delta, dk, dv, bh, S,
                          D, scale, causal, stream);
}

cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq_out, int bh, int S, int D, float scale,
                    bool causal, cudaStream_t stream) {
  return HVD_MMA_DISPATCH(dq, D, q, k, v, dout, lse, delta, dq_out, bh, S, D,
                          scale, causal, stream);
}

}  // namespace hvd_flash_mma
