// cp.async helpers (sm_80+): copies from global to shared memory that do
// not pass through registers.  A source size below the copy size fills the
// rest of the destination with zeros, which masks ragged edges without a
// branch; the source pointer must still be a valid address.
#pragma once
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Loads from a 32-bit shared-memory address.  A hot loop that indexes
// shared memory through a generic pointer gets the shared window's base
// rebuilt from the cluster CTA id (S2UR) before every load, on the load's
// critical path; an address converted once outside the loop avoids it.
// volatile: the loads keep their order against the barriers around them.
__device__ __forceinline__ float4 lds128(unsigned addr) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ float lds32(unsigned addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
}

// 1 where every value is 0 or 1 (branch-free, for checks folded with &).
__device__ __forceinline__ int is_binary(float v) { return (v == 0.0f) | (v == 1.0f); }
__device__ __forceinline__ int is_binary4(float4 v) {
    return is_binary(v.x) & is_binary(v.y) & is_binary(v.z) & is_binary(v.w);
}

}  // namespace repro
