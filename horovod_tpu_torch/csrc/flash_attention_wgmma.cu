// FlashAttention forward (B7), dK/dV (B8) and dQ (B9) for bf16 on Hopper
// (sm_90a): warpgroup products (wgmma) fed by TMA through an mbarrier
// ring, one producer warp and two consumer warpgroups a block.
// flash_attention.cu's C entry points launch these for bf16 tensors, and
// that file's CUDA-core kernels for fp32.
//
// They replace three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   B7 flash_fwd  <- _fwd_call (_fwd_kernel): o and the row logsumexp;
//   B8 flash_dkdv <- _flash_bhsd_bwd's first pallas_call (_dkdv_kernel);
//   B9 flash_dq   <- _flash_bhsd_bwd's second pallas_call (_dq_kernel).
//
// What bounds them on an H100: operations. At the GPT path's shape (BH 16,
// S 4096, D 64, causal) B7 does two products of 2 D flops for each of the
// 134M causal (query, key) pairs, 34.4 GFLOP, 0.0348 ms at the card's 989
// TFLOP/s of bf16; B9 does three and B8 four. Hopper reaches that rate
// only through wgmma, whose operands come from shared memory (or A from
// registers) and whose tiles are 64 rows deep, so the design is:
//   * a block of 384 threads: warpgroups 0 and 1 consume, 64 rows each
//     (queries in B7 and B9, keys in B8), and warpgroup 2 produces. Its
//     first warp issues the TMA loads of the block's own tiles once and of
//     the streamed tiles into a ring (three stages in B7, two in B8 and
//     B9), with a full and an empty mbarrier a stage; it keeps 24
//     registers (setmaxnreg) so that the consumers can hold 240;
//   * tiles land in shared memory in the 128-byte swizzle that wgmma reads
//     without bank conflicts (flash_attention_wgmma.cuh). Tensor maps are
//     3-D, {D, S, BH}: a box never crosses into the next head, and TMA
//     fills rows past S and columns past D with zeros, so D is padded to DP
//     64 or 128 in shared memory only;
//   * each product is wgmma with fp32 accumulators. The logits' products
//     take both operands from shared memory; the accumulator of one
//     product, rounded to bf16, is the register A operand of the next
//     (P V in B7, Pᵀ dO and dSᵀ Q in B8, dS K in B9), whose B operand is
//     read transposed (MN-major) from the same tiles, so nothing is
//     transposed in memory.
// B7: a block owns 128 query rows and streams 128-key tiles of K and V;
// the longest causal rows go first, key tiles past the diagonal are never
// loaded, and only the diagonal tile (causal) or the ragged last tile
// (bidirectional) is masked. Each consumer issues one tile's S = Q Kᵀ
// with the previous tile's P V and runs the softmax while P V is in
// flight. B8: a block owns 128 key rows and streams
// 64-query tiles of Q and dO from the diagonal (causal), with their lse
// and delta brought by the producer warp's 4-byte cp.async copies on the
// same full barrier (a row of lse starts at an offset of 4 S bytes, not
// 16-byte aligned for every S, so a bulk copy cannot take it). B9: a block
// owns 128 query rows, loads their Q and dO once, reads their lse and
// delta into registers, and streams 128-key tiles of K and V as B7 does;
// each consumer issues S = Q Kᵀ and dP = dO Vᵀ together and computes P
// while dP is in flight. No block writes what another reads, and the
// results are deterministic.
//
// Numerics, the same as the mma.sync kernels they replace: the products
// of bf16 operands are exact in fp32; the scale is applied to the fp32
// logits after the product; P (B7, B8) and dS (B8, B9) are rounded to
// bf16 once, before they enter a product (flash_attention.py,
// mma_rounding_terms). All take 2^(s scale log2 e - m) with the scaled
// logit and its shift in one FMA and the SM's ex2.approx (m the running
// maximum in B7, lse log2 e in B8 and B9); B7 rounds P against the running
// maximum and rescales the accumulator once a key tile; lse stays fp32 in
// natural-log units. Masks, the -1e30 initial maximum and l = 0 read as 1
// follow the TPU kernels; a masked logit gives p = 0. Do not build with
// --use_fast_math.

#include "flash_attention_wgmma.cuh"

#include <math.h>

namespace hvd_flash_wgmma {
namespace {

using bf16 = __nv_bfloat16;

// A block: two consumer warpgroups of 64 rows each (queries in B7, keys in
// B8), then the producer warpgroup.
constexpr int kThreads = 384;
constexpr int kBlockRows = 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 x 128 x 240 + 128 x 24 = 168 x 384
constexpr int kKeyTile = 128;     // B7, B9: keys of a streamed K/V tile
constexpr int kFwdStages = 3;     // B7's ring of K/V tiles
constexpr int kDqStages = 2;      // B9's ring of K/V tiles
constexpr int kQueryTile = 64;    // B8: queries of a streamed Q/dO tile
constexpr int kDkdvStages = 2;    // B8's ring of Q/dO tiles
constexpr int kColBlock = 64;     // head-dim columns of a swizzled block
constexpr float kNegInf = -1e30f;   // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of a tile of `rows` rows at padded head dim DP, and of one of its
// 64-column blocks.
__host__ __device__ constexpr int tile_bytes(int rows, int dp) {
  return rows * dp * 2;
}
__host__ __device__ constexpr int block_bytes(int rows) {
  return rows * kColBlock * 2;
}

// The first 1024-byte boundary at or after p (the launch asks for 1024
// bytes more than the layout needs).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The register A operand of k16 step k from the accumulators of columns
// 16 k .. 16 k + 15 (flash_attention_wgmma.cuh), rounded to bf16.
__device__ __forceinline__ void a_from_acc(uint32_t a[4], const float* d,
                                           int k) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

template <int DP>
constexpr size_t fwd_smem() {
  return 1024 + (1 + 2 * kFwdStages) * tile_bytes(kBlockRows, DP) +
         8 * (1 + 2 * kFwdStages);
}

// 2^x by the SM's exponential unit (MUFU.EX2, about 2 ulp; subnormal
// results flush to 0, far below what a bf16 P or an fp32 row sum of at
// least 1 keeps).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = A Bᵀ for a consumer's 64 rows of a 128-row tile A (Q; or dO in B9)
// and a 128-key tile B (K; or V in B9), contracting over DP, as one
// committed group.
template <int DP>
__device__ __forceinline__ void tile_logits(float (&s)[64], uint32_t q_addr,
                                            uint32_t k_addr) {
  wgmma_fence();
  fence_regs<64>(s);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_m64n128k16_ss(
        s,
        make_desc(q_addr + (kk / 4) * block_bytes(kBlockRows) + (kk % 4) * 32),
        make_desc(k_addr + (kk / 4) * block_bytes(kKeyTile) + (kk % 4) * 32),
        kk > 0);
  wgmma_commit();
}

// acc += bf16(P) V for a 128-key tile: P from registers, V's rows (keys)
// contracted, as one committed group.
template <int DP>
__device__ __forceinline__ void fwd_pv(float (&acc)[DP / kColBlock][32],
                                       const uint32_t (&pa)[8][4],
                                       uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < DP / kColBlock; ++b) fence_regs<32>(acc[b]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int b = 0; b < DP / kColBlock; ++b)
      wgmma_m64n64k16_rs(
          acc[b], pa[kk],
          make_desc(v_addr + b * block_bytes(kKeyTile) + kk * 2048));
  wgmma_commit();
}

// Mask, then the online softmax of rows g and g + 8 (accumulators e / 2 =
// 0 and 1 of each n-chunk) over the key tile at k0: s becomes P (fp32), m
// and l move on, and alpha = 2^(m - m') is the accumulator's rescale. The
// maximum is taken of the unscaled logits (the scale is positive, so the
// order is the same) and p = 2^(s scale log2 e - m') costs one FMA and one
// ex2; the maximum and the sum run as four independent chains a row. A
// masked logit takes no part in the maximum and gives p = 0; every row
// sees a key in tile 0, so m is finite from there on.
__device__ __forceinline__ void fwd_softmax(float (&s)[64], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            int k0, int row0, int qd, int S,
                                            float scale_log2, bool causal,
                                            bool need_mask) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (need_mask) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * qd + (e & 1);
        const bool keep = causal ? row >= col : col < S;
        x = keep ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1][j & 3] = fmaxf(mx[e >> 1][j & 3], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                fmaxf(mx[r][2], mx[r][3]));
    const float m_new = fmaxf(m[r], quad_max(row_max) * scale_log2);
    alpha[r] = ex2_ftz(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2_ftz(fmaf(s[i], scale_log2, -m[r]));
    s[i] = p;
    sum[r][(i >> 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// bf16(P) as the register A operands of the product with V.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) a_from_acc(pa[kk], s, kk);
}

// acc *= alpha of its row.
template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / kColBlock][32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int b = 0; b < DP / kColBlock; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] *= alpha[(i >> 1) & 1];
}

// B7: one block per (bh, 128-row query tile), blockIdx.x the head, so
// that blocks start in order of their work: every head's longest causal
// rows first. Each consumer warpgroup keeps the online softmax state of
// _fwd_kernel for its 64 rows (in log2 units; rows g and g + 8 of each
// warp's 16 in registers): m' = max(m, rowmax s), p = 2^(s - m'),
// l' = l 2^(m - m') + rowsum p, acc' = acc 2^(m - m') + bf16(p) v; then
// o = acc / l and lse = (m + log2 l) ln 2, with l = 0 read as 1.
// The softmax takes about as long on the SM's exponential unit as the
// products on the tensor cores (one exp2 for every 2 D = 128 flops at D
// 64), so the two must overlap: key tile kt's S = Q Kᵀ and tile kt - 1's
// P V are issued together, the softmax of tile kt waits for S alone and
// runs while P V is in flight, and only then are P packed and the
// accumulator rescaled (P V still reads the packed P of tile kt - 1).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int S, int D, float scale, bool causal) {
  constexpr int kBlocks = DP / kColBlock;
  constexpr int kTile = tile_bytes(kBlockRows, DP);  // Q, K or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + kTile;               // kFwdStages tiles
  uint8_t* sV = sK + kFwdStages * kTile;  // kFwdStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kFwdStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int n_tiles = (S + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int bh = blockIdx.x;
  const int last = causal ? qt : n_tiles - 1;  // key tiles 0 .. last
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, kTile);
      for (int b = 0; b < kBlocks; ++b)
        tma_load_3d(sQ + b * block_bytes(kBlockRows), &tq, q_full,
                    b * kColBlock, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt <= last; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kTile);
        uint8_t* tK = sK + stage * kTile;
        uint8_t* tV = sV + stage * kTile;
        for (int b = 0; b < kBlocks; ++b) {
          tma_load_3d(tK + b * block_bytes(kKeyTile), &tk, &full[stage],
                      b * kColBlock, kt * kKeyTile, bh);
          tma_load_3d(tV + b * block_bytes(kKeyTile), &tv, &full[stage],
                      b * kColBlock, kt * kKeyTile, bh);
        }
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int qd = t % 4;
    const int row0 = q0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;  // and + 8
    // This warpgroup's 64 rows in each column block of Q.
    const uint32_t q_addr = smem_u32(sQ) + 64 * wg * (kColBlock * 2);
    const uint32_t k_base = smem_u32(sK);
    const uint32_t v_base = smem_u32(sV);
    const float scale_log2 = scale * kLog2e;
    // Only the diagonal tile (causal) or the ragged last one is masked.
    auto need_mask = [&](int kt) {
      return causal ? kt == qt : (kt + 1) * kKeyTile > S;
    };

    float acc[kBlocks][32];
    float s[64];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float alpha[2];
    uint32_t pa[8][4];

    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    tile_logits<DP>(s, q_addr, k_base);
    wgmma_wait<0>();
    fence_regs<64>(s);
    fwd_softmax(s, m, l, alpha, 0, row0, qd, S, scale_log2, causal,
                need_mask(0));
    pack_p(pa, s);
    int prev = 0;  // the stage of the tile whose P is in pa
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 1; kt <= last; ++kt) {
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(&full[stage], phase);
      tile_logits<DP>(s, q_addr, k_base + stage * kTile);
      fwd_pv<DP>(acc, pa, v_base + prev * kTile);
      wgmma_wait<1>();  // S of tile kt
      fence_regs<64>(s);
      fwd_softmax(s, m, l, alpha, kt * kKeyTile, row0, qd, S, scale_log2,
                  causal, need_mask(kt));
      wgmma_wait<0>();  // P V of tile kt - 1, which reads pa
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) fence_regs<32>(acc[b]);
      if (t == 0) mbar_arrive(&empty[prev]);
      rescale<DP>(acc, alpha);
      pack_p(pa, s);
      prev = stage;
    }
    fwd_pv<DP>(acc, pa, v_base + prev * kTile);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) fence_regs<32>(acc[b]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float safe = l[r] == 0.0f ? 1.0f : l[r];
      bf16* out = o + (static_cast<int64_t>(bh) * S + row) * D;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = b * kColBlock + 8 * j + 2 * qd;
          if (d < D)
            *reinterpret_cast<uint32_t*>(out + d) =
                pack_bf16(acc[b][4 * j + 2 * r] / safe,
                          acc[b][4 * j + 2 * r + 1] / safe);
        }
      if (qd == 0)
        lse[static_cast<int64_t>(bh) * S + row] =
            (m[r] + log2f(safe)) * kLn2;
    }
  }
}

template <int DP>
constexpr size_t dkdv_smem() {
  return 1024 + 2 * tile_bytes(kBlockRows, DP) +
         2 * kDkdvStages * tile_bytes(kQueryTile, DP) +
         2 * kDkdvStages * kQueryTile * sizeof(float) +
         8 * (1 + 2 * kDkdvStages);
}

// B8: one block per (bh, 128-row key tile), blockIdx.x the head, so that
// every head's longest causal loop starts first;
// it loops over the 64-query tiles that see its keys (from the diagonal
// when causal), as _dkdv_kernel's grid does. Each consumer warpgroup owns
// 64 key rows and works on the transposed tile, whose accumulators are
// the register A operands of the next products:
//   Sᵀ = K Qᵀ, Pᵀ = exp(Sᵀ scale - lse) (masked to 0),
//   dV += bf16(Pᵀ) dO, dPᵀ = V dOᵀ, dSᵀ = Pᵀ (dPᵀ - delta),
//   dK += bf16(dSᵀ) Q;
// dK is multiplied by scale once at the end (_dkdv_kernel's q carries it).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkdv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            __grid_constant__ const CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int S, int D, float scale, bool causal) {
  constexpr int kBlocks = DP / kColBlock;
  constexpr int kKV = tile_bytes(kBlockRows, DP);
  constexpr int kQ = tile_bytes(kQueryTile, DP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + kKV;
  uint8_t* sQ = sV + kKV;               // kDkdvStages tiles
  uint8_t* sO = sQ + kDkdvStages * kQ;      // dO, kDkdvStages tiles
  float* sL = reinterpret_cast<float*>(sO + kDkdvStages * kQ);  // lse
  float* sD = sL + kDkdvStages * kQueryTile;                    // delta
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(sD + kDkdvStages * kQueryTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkdvStages;

  const int k0 = blockIdx.y * kBlockRows;
  const int bh = blockIdx.x;
  const int n_q = (S + kQueryTile - 1) / kQueryTile;
  const int first = causal ? k0 / kQueryTile : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and 32 cp.async ones
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kKV);
        for (int b = 0; b < kBlocks; ++b) {
          tma_load_3d(sK + b * block_bytes(kBlockRows), &tk, kv_full,
                      b * kColBlock, k0, bh);
          tma_load_3d(sV + b * block_bytes(kBlockRows), &tv, kv_full,
                      b * kColBlock, k0, bh);
        }
      }
      const float* lb = lse + static_cast<int64_t>(bh) * S;
      const float* db = delta + static_cast<int64_t>(bh) * S;
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = first; qt < n_q; ++qt) {
        const int q0 = qt * kQueryTile;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * kQ);
          for (int b = 0; b < kBlocks; ++b) {
            tma_load_3d(sQ + stage * kQ + b * block_bytes(kQueryTile), &tq,
                        &full[stage], b * kColBlock, q0, bh);
            tma_load_3d(sO + stage * kQ + b * block_bytes(kQueryTile), &tdo,
                        &full[stage], b * kColBlock, q0, bh);
          }
        }
        // lse and delta, zeros past S: rows lane and lane + 32.
#pragma unroll
        for (int half = 0; half < kQueryTile / 32; ++half) {
          const int i = lane + 32 * half;
          const bool in = q0 + i < S;
          cp_async4(sL + stage * kQueryTile + i, in ? lb + q0 + i : lb,
                    in ? 4 : 0);
          cp_async4(sD + stage * kQueryTile + i, in ? db + q0 + i : db,
                    in ? 4 : 0);
        }
        cp_async_arrive(&full[stage]);
        if (++stage == kDkdvStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int g = (t % 32) / 4;
    const int qd = t % 4;
    const int key0 = k0 + 64 * wg + 16 * (t / 32) + g;  // and key0 + 8
    // This warpgroup's 64 key rows in each column block of K and V.
    const uint32_t k_addr = smem_u32(sK) + 64 * wg * (kColBlock * 2);
    const uint32_t v_addr = smem_u32(sV) + 64 * wg * (kColBlock * 2);
    const float scale_log2 = scale * kLog2e;

    float gk[kBlocks][32], gv[kBlocks][32];
    float st[32], dpt[32];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) gk[b][i] = gv[b][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;

    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = first; qt < n_q; ++qt) {
      mbar_wait(&full[stage], phase);
      const uint32_t q_addr = smem_u32(sQ + stage * kQ);
      const uint32_t o_addr = smem_u32(sO + stage * kQ);
      const float* tL = sL + stage * kQueryTile;
      const float* tD = sD + stage * kQueryTile;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 keys x 64 queries over DP, as two
      // groups, so that Pᵀ is computed while dPᵀ is in flight.
      wgmma_fence();
      fence_regs<32>(st);
      fence_regs<32>(dpt);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(
            st,
            make_desc(k_addr + (kk / 4) * block_bytes(kBlockRows) +
                      (kk % 4) * 32),
            make_desc(q_addr + (kk / 4) * block_bytes(kQueryTile) +
                      (kk % 4) * 32),
            kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(
            dpt,
            make_desc(v_addr + (kk / 4) * block_bytes(kBlockRows) +
                      (kk % 4) * 32),
            make_desc(o_addr + (kk / 4) * block_bytes(kQueryTile) +
                      (kk % 4) * 32),
            kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<32>(st);

      // Pᵀ in place: rows are keys key0 and key0 + 8 (accumulators e / 2),
      // columns the tile's queries 8 j + 2 qd + e % 2.
      const int q0 = qt * kQueryTile;
      const bool need_mask =
          (causal && q0 < k0 + kBlockRows) || q0 + kQueryTile > S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * qd + c;
          const float lse2 = tL[col] * kLog2e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = ex2_ftz(fmaf(st[4 * j + 2 * r + c], scale_log2, -lse2));
            if (need_mask) {
              const int key = key0 + 8 * r;
              const int query = q0 + col;
              const bool keep = query < S && (!causal || query >= key);
              p = keep ? p : 0.0f;
            }
            st[4 * j + 2 * r + c] = p;
          }
        }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_from_acc(pa[kk], st, kk);

      wgmma_wait<0>();
      fence_regs<32>(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = tD[8 * j + 2 * qd + c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st[4 * j + 2 * r + c] *= dpt[4 * j + 2 * r + c] - dl;  // dSᵀ
        }
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_from_acc(da[kk], st, kk);

      // dV += bf16(Pᵀ) dO and dK += bf16(dSᵀ) Q, contracting over the
      // queries (the tiles' rows).
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        fence_regs<32>(gv[b]);
        fence_regs<32>(gk[b]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int b = 0; b < kBlocks; ++b) {
          wgmma_m64n64k16_rs(
              gv[b], pa[kk],
              make_desc(o_addr + b * block_bytes(kQueryTile) + kk * 2048));
          wgmma_m64n64k16_rs(
              gk[b], da[kk],
              make_desc(q_addr + b * block_bytes(kQueryTile) + kk * 2048));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        fence_regs<32>(gv[b]);
        fence_regs<32>(gk[b]);
      }
      if (t == 0) mbar_arrive(&empty[stage]);
      if (++stage == kDkdvStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 8 * r;
      if (row >= S) continue;
      const int64_t at = (static_cast<int64_t>(bh) * S + row) * D;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = b * kColBlock + 8 * j + 2 * qd;
          if (d >= D) continue;
          *reinterpret_cast<uint32_t*>(dk + at + d) =
              pack_bf16(gk[b][4 * j + 2 * r] * scale,
                        gk[b][4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at + d) =
              pack_bf16(gv[b][4 * j + 2 * r], gv[b][4 * j + 2 * r + 1]);
        }
    }
  }
}

// ---- B9 ------------------------------------------------------------------

template <int DP>
constexpr size_t dq_smem() {
  return 1024 + 2 * tile_bytes(kBlockRows, DP) +
         2 * kDqStages * tile_bytes(kKeyTile, DP) + 8 * (1 + 2 * kDqStages);
}

// B9: one block per (bh, 128-row query tile), blockIdx.x the head and the
// longest causal rows first, as B7. The producer warp loads the block's Q
// and dO once and streams 128-key tiles of K and V (up to the block's
// diagonal tile when causal) through a two-stage ring; each consumer
// warpgroup owns 64 query rows, holds their lse (log2 units) and delta in
// registers, and per key tile computes
//   S = Q Kᵀ and dP = dO Vᵀ, issued together as two groups,
//   P = 2^(S scale log2 e - lse log2 e) (masked to 0) while dP is in
//   flight,
//   dS = P (dP - delta) in fp32,
//   dQ += bf16(dS) K, K read MN-major from the same tile.
// Key tiles and query blocks are both 128 rows, so the last tile a causal
// block loads is its diagonal one, and each consumer has a row at or after
// that tile's first key: no consumer skips a tile. dQ is multiplied by
// scale once at the end (_dq_kernel's dS carries it); each block writes
// only its own rows.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __grid_constant__ const CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int D, float scale,
                          bool causal) {
  static_assert(kKeyTile == kBlockRows,
                "a causal block's last key tile is its diagonal one");
  constexpr int kBlocks = DP / kColBlock;
  constexpr int kTile = tile_bytes(kBlockRows, DP);  // Q, dO, K or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + kTile;                // dO
  uint8_t* sK = sO + kTile;                // kDqStages tiles
  uint8_t* sV = sK + kDqStages * kTile;    // kDqStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kDqStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int n_tiles = (S + kBlockRows - 1) / kBlockRows;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int bh = blockIdx.x;
  const int last = causal ? qt : n_tiles - 1;  // key tiles 0 .. last
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, 2 * kTile);
      for (int b = 0; b < kBlocks; ++b) {
        tma_load_3d(sQ + b * block_bytes(kBlockRows), &tq, q_full,
                    b * kColBlock, q0, bh);
        tma_load_3d(sO + b * block_bytes(kBlockRows), &tdo, q_full,
                    b * kColBlock, q0, bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt <= last; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kTile);
        uint8_t* tK = sK + stage * kTile;
        uint8_t* tV = sV + stage * kTile;
        for (int b = 0; b < kBlocks; ++b) {
          tma_load_3d(tK + b * block_bytes(kKeyTile), &tk, &full[stage],
                      b * kColBlock, kt * kKeyTile, bh);
          tma_load_3d(tV + b * block_bytes(kKeyTile), &tv, &full[stage],
                      b * kColBlock, kt * kKeyTile, bh);
        }
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int qd = t % 4;
    const int first_row = q0 + 64 * wg;  // this warpgroup's 64 rows
    const int row0 = first_row + 16 * (t / 32) + (t % 32) / 4;  // and + 8
    // This warpgroup's 64 rows in each column block of Q and dO.
    const uint32_t q_addr = smem_u32(sQ) + 64 * wg * (kColBlock * 2);
    const uint32_t o_addr = smem_u32(sO) + 64 * wg * (kColBlock * 2);
    const float scale_log2 = scale * kLog2e;

    // Rows past S read 0 for both: their Q and dO are zeros, so dS is 0.
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int64_t at = static_cast<int64_t>(bh) * S + row;
      lse2[r] = row < S ? lse[at] * kLog2e : 0.0f;
      dl[r] = row < S ? delta[at] : 0.0f;
    }

    float gq[kBlocks][32];
    float s[64], dp[64];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) gq[b][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.0f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt <= last; ++kt) {
      const int k0 = kt * kKeyTile;
      const uint32_t k_addr = smem_u32(sK + stage * kTile);
      const uint32_t v_addr = smem_u32(sV + stage * kTile);
      mbar_wait(&full[stage], phase);
      tile_logits<DP>(s, q_addr, k_addr);
      tile_logits<DP>(dp, o_addr, v_addr);
      wgmma_wait<1>();  // S
      fence_regs<64>(s);

      // P in place: rows row0 and row0 + 8 (accumulators e / 2), columns
      // the tile's keys k0 + 8 j + 2 qd + e % 2. Only the tiles that cross
      // this warpgroup's diagonal (causal) or S are masked.
      const bool need_mask =
          (causal && k0 + kKeyTile - 1 > first_row) || k0 + kKeyTile > S;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2_ftz(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
          if (need_mask) {
            const int row = row0 + 8 * (e >> 1);
            const int key = k0 + 8 * j + 2 * qd + (e & 1);
            const bool keep = key < S && (!causal || row >= key);
            p = keep ? p : 0.0f;
          }
          s[4 * j + e] = p;
        }

      wgmma_wait<0>();  // dP
      fence_regs<64>(dp);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= dp[i] - dl[(i >> 1) & 1];  // dS
      uint32_t da[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a_from_acc(da[kk], s, kk);

      // dQ += bf16(dS) K, contracting over the tile's keys (its rows).
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) fence_regs<32>(gq[b]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int b = 0; b < kBlocks; ++b)
          wgmma_m64n64k16_rs(
              gq[b], da[kk],
              make_desc(k_addr + b * block_bytes(kKeyTile) + kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) fence_regs<32>(gq[b]);
      if (t == 0) mbar_arrive(&empty[stage]);
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      bf16* out = dq + (static_cast<int64_t>(bh) * S + row) * D;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = b * kColBlock + 8 * j + 2 * qd;
          if (d < D)
            *reinterpret_cast<uint32_t*>(out + d) =
                pack_bf16(gq[b][4 * j + 2 * r] * scale,
                          gq[b][4 * j + 2 * r + 1] * scale);
        }
    }
  }
}

// ---- host side ----------------------------------------------------------

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  static const cudaError_t status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      err = cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
    return err;
  }();
  *out = fn;
  return status;
}

// A 3-D map {D, S, BH} of a bf16 [BH, S, D] tensor whose box is 64
// head-dim columns of `rows` rows of one head, 128-byte swizzled; reads
// past D or S are filled with zeros.
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int bh, int S, int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kColBlock, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : static_cast<cudaError_t>(res);
}

template <int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int S, int D, float scale, bool causal,
                cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  CUtensorMap tq, tk, tv;
  if (err == cudaSuccess) err = make_map(encode, &tq, q, bh, S, D, kBlockRows);
  if (err == cudaSuccess) err = make_map(encode, &tk, k, bh, S, D, kKeyTile);
  if (err == cudaSuccess) err = make_map(encode, &tv, v, bh, S, D, kKeyTile);
  constexpr size_t smem = fwd_smem<DP>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBlockRows - 1) / kBlockRows);
  flash_fwd_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, S, D, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int bh, int S, int D, float scale,
                 bool causal, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  CUtensorMap tq, tk, tv, tdo;
  if (err == cudaSuccess) err = make_map(encode, &tq, q, bh, S, D, kQueryTile);
  if (err == cudaSuccess) err = make_map(encode, &tk, k, bh, S, D, kBlockRows);
  if (err == cudaSuccess) err = make_map(encode, &tv, v, bh, S, D, kBlockRows);
  if (err == cudaSuccess)
    err = make_map(encode, &tdo, dout, bh, S, D, kQueryTile);
  constexpr size_t smem = dkdv_smem<DP>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dkdv_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBlockRows - 1) / kBlockRows);
  flash_dkdv_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, D, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq_out, int bh,
               int S, int D, float scale, bool causal, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  CUtensorMap tq, tk, tv, tdo;
  if (err == cudaSuccess) err = make_map(encode, &tq, q, bh, S, D, kBlockRows);
  if (err == cudaSuccess) err = make_map(encode, &tk, k, bh, S, D, kKeyTile);
  if (err == cudaSuccess) err = make_map(encode, &tv, v, bh, S, D, kKeyTile);
  if (err == cudaSuccess)
    err = make_map(encode, &tdo, dout, bh, S, D, kBlockRows);
  constexpr size_t smem = dq_smem<DP>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dq_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBlockRows - 1) / kBlockRows);
  flash_dq_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq_out), S, D, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// The head dimension padded to 64 or 128 columns in shared memory.
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int S, int D, float scale,
                     bool causal, cudaStream_t stream) {
  return D <= 64 ? fwd<64>(q, k, v, o, lse, bh, S, D, scale, causal, stream)
                 : fwd<128>(q, k, v, o, lse, bh, S, D, scale, causal, stream);
}

cudaError_t dkdv_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int bh, int S, int D, float scale,
                      bool causal, cudaStream_t stream) {
  return D <= 64 ? dkdv<64>(q, k, v, dout, lse, delta, dk, dv, bh, S, D,
                            scale, causal, stream)
                 : dkdv<128>(q, k, v, dout, lse, delta, dk, dv, bh, S, D,
                             scale, causal, stream);
}

cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq_out, int bh, int S, int D, float scale,
                    bool causal, cudaStream_t stream) {
  return D <= 64 ? dq<64>(q, k, v, dout, lse, delta, dq_out, bh, S, D, scale,
                          causal, stream)
                 : dq<128>(q, k, v, dout, lse, delta, dq_out, bh, S, D,
                           scale, causal, stream);
}

}  // namespace hvd_flash_wgmma
