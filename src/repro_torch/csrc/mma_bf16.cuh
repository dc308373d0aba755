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
// Products of two bf16 values are exact in f32, so a k16 step of {0, 1}
// spikes against bf16 weights sums exact terms; the sum is exact wherever
// the weights span less than about 2^16 in magnitude.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 values of shared memory as one register.
__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned*>(p);
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

}  // namespace repro
