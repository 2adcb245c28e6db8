// Tensor-core building blocks of the bf16 attention kernels
// (flash_attention_mma.cu), and the launchers that flash_attention.cu's C
// entry points dispatch bf16 calls to.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, fp32 accumulate), for
// lane = 4 * g + t (g = lane / 4 in 0..7, t = lane % 4):
//   A 16 x 16, four 32-bit registers of two bf16 each (low half first):
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B 16 x 8 (k x n), two registers: b0 = B[2t..2t+1][g],
//     b1 = B[2t+8..2t+9][g];
//   C 16 x 8 fp32, four registers: c0, c1 = C[g][2t..2t+1],
//     c2, c3 = C[g+8][2t..2t+1].
// So the C tiles of two neighbouring n-tiles, rounded to bf16 and packed in
// pairs, are the A fragment of a product that contracts over those 16
// columns: probabilities and dS never leave the registers between two
// products.
//
// ldmatrix.x4 reads four 8 x 8 bf16 matrices whose rows are 16 bytes in
// shared memory; lanes 8i..8i+7 give the row addresses of matrix i, and
// register i of lane (g, t) receives row g, columns 2t..2t+1 of matrix i
// (.trans: row 2t..2t+1, column g, i.e. the transposed matrix).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash_mma {

// Launchers (defined in flash_attention_mma.cu). Tensors are bf16
// [BH, S, D] with D a multiple of 8 up to 128 and 16-byte aligned
// pointers; lse and delta are fp32 [BH, S]. Each launches on `stream` and
// returns the launch's error code.
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int S, int D, float scale,
                     bool causal, cudaStream_t stream);
cudaError_t dkdv_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int bh, int S, int D, float scale,
                      bool causal, cudaStream_t stream);
cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int bh, int S, int D, float scale, bool causal,
                    cudaStream_t stream);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through L1; only
// `bytes` (16 or 0) are read and the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, read only when `bytes` is 4 (zero-filled when 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b for one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of 16 contraction columns held as the C tiles c[2i] and
// c[2i + 1] of a 16-row accumulator.
__device__ __forceinline__ void a_from_c(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace hvd_flash_mma
