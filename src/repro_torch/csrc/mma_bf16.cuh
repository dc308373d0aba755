// bf16 tensor-core helpers for the bf16 forms of the per-layer kernels.
//
// mma.sync m16n8k16 (row.col, bf16 inputs, f32 accumulators) and its
// fragment layout, per thread of a warp: g = lane / 4, q = lane % 4;
//   A (16 x 16, row-major): a[0] = A[g][2q..2q+1], a[1] = A[g+8][2q..2q+1],
//                           a[2] = A[g][2q+8..2q+9], a[3] = A[g+8][2q+8..2q+9]
//   B (16 x 8, "col": stored n-major, k contiguous):
//                           b[0] = B[2q..2q+1][g], b[1] = B[2q+8..2q+9][g]
//   C (16 x 8 f32):         c[0..1] = C[g][2q..2q+1], c[2..3] = C[g+8][2q..2q+1]
// Each 32-bit register holds two bf16 values, the lower index in the low half.
//
// The products are plain register operations (not volatile), so the
// compiler may interleave one step's products with the next step's loads.
//
// Products of two bf16 values are exact in f32, so a k16 step of {0, 1}
// spikes against bf16 weights sums exact terms; the sum is exact wherever
// the weights span less than about 2^16 in magnitude.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product with a zero accumulator: d = a * b.
__device__ __forceinline__ void mma_bf16_16816_zero(float (&d)[4], const unsigned (&a)[4],
                                                    const unsigned (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// ldmatrix / stmatrix (sm_75+ / sm_90): a warp moves 8x8 matrices of
// 16-bit values between shared memory and the fragments above.  Matrix i
// takes its 8 row addresses from lanes 8i..8i+7 (each row 16 contiguous
// bytes, 16-byte aligned; .x2 reads lanes 0-15 only).  Without .trans,
// lane t receives row t/4, columns 2(t%4) and 2(t%4)+1 of each matrix in
// one register, the lower column in the low half: the layout of a[] when
// the rows in memory are A's rows (A row-major), and of b[] when they are
// B's n (B n-major, k contiguous).  With .trans lane t receives column
// t/4, rows 2(t%4) and 2(t%4)+1: the layout of a[] when the rows in
// memory are A's k (A stored k-major) and of b[] when they are B's k (B
// row-major, n contiguous).  The "memory" clobbers keep them in order
// with plain shared-memory stores around a barrier.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// The inverse of ldmatrix_x2 with .trans: lane t's register i holds row
// t/4, columns 2(t%4) and 2(t%4)+1 of fragment matrix i (a C fragment
// packed to bf16 pairs: row = M, column = N), and the matrix is written
// transposed, so memory row j (address from lane 8i + j) receives
// fragment column j: 8 consecutive M values of one N.
__device__ __forceinline__ void stmatrix_x2_trans(unsigned addr, unsigned r0, unsigned r1) {
    asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
                 :: "r"(addr), "r"(r0), "r"(r1) : "memory");
}

// Two f32 values (already bf16 values) as one register of bf16, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// x rounded to the nearest bf16 (ties to even), returned as f32.
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The reference's `out += dot(...)` with out in bf16: the tile's f32 dot is
// rounded to bf16 (preferred_element_type), then added to the bf16
// accumulator with one more rounding.  acc holds a bf16 value.
__device__ __forceinline__ float add_tile_bf16(float acc, float dot) {
    return round_bf16(__fadd_rn(acc, round_bf16(dot)));
}

// add_tile_bf16 on two values at once, the accumulators packed as bf16x2
// (lo, hi): two f32 dots rounded to bf16 by one cvt, added by one
// add.rn.bf16x2 (sm_90).  The same bits: the f32 sum of two bf16 values is
// exact wherever it can round to a different bf16 (their exponents differ
// by at most 15, 9 + 15 bits), and otherwise the smaller lies below 2^-7
// of half the larger's ulp, so both give the larger.
__device__ __forceinline__ unsigned add_tile_bf16x2(unsigned acc, float lo, float hi) {
    unsigned d, r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(acc), "r"(d));
    return r;
}

}  // namespace repro
