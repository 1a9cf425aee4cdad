// Exact integer products on the int8 tensor cores (mma.sync m16n8k32,
// int32 accumulators) with a 16-bit data operand split into a signed high
// byte and an unsigned low byte, x = 256 * hi + lo, and an s8 matrix
// operand; shared by K3 (plan_trial.cu) and K6 (transform_batch.cu).
//
// 256 * sum(T * hi) + sum(T * lo) is sum(T * x) exactly for x in
// [-2^15, 2^15) and |T| <= 127 as long as every partial sum stays inside
// int32: at a 64-point contraction and |T| <= 91 (the DCT-2 and DST-7
// matrices of ops/tables.tr_matrix), |256 * sum(T * hi)| <= 256 * 64 *
// 91 * 128 = 1.9e8; tests/test_torch_exact_split.py holds this against
// int64 products at the extremes.
//
// Operands live in shared memory as byte planes, the contraction index
// contiguous, KP bytes of it (a multiple of 32; a shorter contraction is
// zero-padded) in a row of RW words, RW = 4 (mod 8): a fragment's 8 rows x
// 4 words fall on 32 distinct banks.
#pragma once

#include <stdint.h>

namespace mma_split {

__device__ __forceinline__ void mma_ss(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_us(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_su(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the row stride (words) of a plane whose contraction has K points
template <int K>
struct Plane {
  static constexpr int KP = K < 32 ? 32 : K;
  static constexpr int RW = KP / 4 + 4;
};

// the m16n8 tile (m0, n0) of A * B^T over KP bytes of contraction: A and B
// are byte planes ([m][k], [n][k]) of row stride RW words; the data operand
// (hi s8, lo u8) is A (DATA_A) or B, the matrix operand s8.  Returns
// 256 * hi + lo in c (c[0], c[1]: row m0 + g, columns n0 + 2t, + 1; c[2],
// c[3]: row m0 + g + 8; g = lane / 4, t = lane % 4).
template <int KP, int RW, bool DATA_A>
__device__ __forceinline__ void tile_product(const uint32_t* A_hi,
                                             const uint32_t* A_lo,
                                             const uint32_t* B_hi,
                                             const uint32_t* B_lo, int m0,
                                             int n0, int* c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
#pragma unroll
  for (int kb = 0; kb < KP / 32; ++kb) {
    const int ra = (m0 + g) * RW + kb * 8 + t;
    const int rb = (n0 + g) * RW + kb * 8 + t;
    uint32_t ah[4], bh[2];
    ah[0] = A_hi[ra];
    ah[1] = A_hi[ra + 8 * RW];
    ah[2] = A_hi[ra + 4];
    ah[3] = A_hi[ra + 8 * RW + 4];
    bh[0] = B_hi[rb];
    bh[1] = B_hi[rb + 4];
    if (DATA_A) {
      uint32_t al[4];
      al[0] = A_lo[ra];
      al[1] = A_lo[ra + 8 * RW];
      al[2] = A_lo[ra + 4];
      al[3] = A_lo[ra + 8 * RW + 4];
      mma_ss(hi, ah, bh);
      mma_us(lo, al, bh);
    } else {
      uint32_t bl[2];
      bl[0] = B_lo[rb];
      bl[1] = B_lo[rb + 4];
      mma_ss(hi, ah, bh);
      mma_su(lo, ah, bl);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = hi[e] * 256 + lo[e];
}

// store x (in [-2^15, 2^15)) at (row r, contraction index kk) of a split
// byte plane pair of row stride RW words
template <int RW>
__device__ __forceinline__ void put_split(uint32_t* hi, uint32_t* lo, int r,
                                          int kk, int x) {
  const int o = r * RW * 4 + kk;
  reinterpret_cast<int8_t*>(hi)[o] = (int8_t)(x >> 8);
  reinterpret_cast<uint8_t*>(lo)[o] = (uint8_t)(x & 255);
}

}  // namespace mma_split
