// LIF neuron update over T with the membrane resident in a register.
//
// Replaces the Pallas kernel repro/kernels/lif_update.py::lif_update_fused
// (grid (neuron-tiles, T), membrane in VMEM scratch across T).  One thread
// owns one neuron and loops over T: device memory sees one read of each
// current and one write of each spike, and the state never leaves the
// register.  Neurons past N are masked by the bounds check, so no padded
// neuron (and no v_th = +inf trick) is needed.
//
// Bound: bytes (a fused elementwise pass, nothing for tensor cores).
// Rounding: v = __fadd_rn(__fmul_rn(alpha, v), cur); strict > on v_th;
// soft reset by __fsub_rn — the same roundings as eager torch.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lif_update_kernel(const float* __restrict__ cur, const float* __restrict__ v0,
                  const float* __restrict__ alpha, const float* __restrict__ theta,
                  const float* __restrict__ vth, float* __restrict__ spikes,
                  float* __restrict__ vfin, int T, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = alpha[i], th = theta[i], vt = vth[i];
    float v = v0[i];
    for (int t = 0; t < T; ++t) {
        v = __fadd_rn(__fmul_rn(a, v), cur[(size_t)t * n + i]);
        const bool fire = v > vt;
        spikes[(size_t)t * n + i] = fire ? 1.0f : 0.0f;
        if (fire) v = __fsub_rn(v, th);
    }
    vfin[i] = v;
}

}  // namespace

extern "C" int lif_update_fused_f32(const float* cur, const float* v0,
                                    const float* alpha, const float* theta,
                                    const float* vth, float* spikes, float* vfin,
                                    int T, int n, void* stream) {
    const int grid = (n + THREADS - 1) / THREADS;
    lif_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        cur, v0, alpha, theta, vth, spikes, vfin, T, n);
    return static_cast<int>(cudaGetLastError());
}

// bf16 form: the state lives in the currents' dtype, as the reference's
// scratch does, and every operation rounds to bf16 as the reference's
// kernel body does in interpret mode (each op of `v * alpha + I_t` and of
// `v - theta * s` rounded on its own; tests/test_torch_bf16.py holds the
// plain version to it bit for bit).  In f32, the product of two bf16
// values is exact, so __fmul_rn then one rounding to bf16 is bf16's own
// product; a sum or difference is taken in f32 and rounded once, as torch
// and XLA compute a bf16 add.  s = 0 subtracts an exact zero, so only a
// firing neuron rounds there.
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(THREADS)
lif_update_bf16_kernel(const __nv_bfloat16* __restrict__ cur, const __nv_bfloat16* __restrict__ v0,
                       const __nv_bfloat16* __restrict__ alpha,
                       const __nv_bfloat16* __restrict__ theta,
                       const __nv_bfloat16* __restrict__ vth, __nv_bfloat16* __restrict__ spikes,
                       __nv_bfloat16* __restrict__ vfin, int T, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = __bfloat162float(alpha[i]), th = __bfloat162float(theta[i]),
                vt = __bfloat162float(vth[i]);
    const __nv_bfloat16 one = __float2bfloat16_rn(1.0f), zero = __float2bfloat16_rn(0.0f);
    float v = __bfloat162float(v0[i]);
    for (int t = 0; t < T; ++t) {
        v = bf(__fadd_rn(bf(__fmul_rn(v, a)), __bfloat162float(cur[(size_t)t * n + i])));
        const bool fire = v > vt;
        spikes[(size_t)t * n + i] = fire ? one : zero;
        if (fire) v = bf(__fsub_rn(v, th));
    }
    vfin[i] = __float2bfloat16_rn(v);
}

}  // namespace

extern "C" int lif_update_fused_bf16(const __nv_bfloat16* cur, const __nv_bfloat16* v0,
                                     const __nv_bfloat16* alpha, const __nv_bfloat16* theta,
                                     const __nv_bfloat16* vth, __nv_bfloat16* spikes,
                                     __nv_bfloat16* vfin, int T, int n, void* stream) {
    const int grid = (n + THREADS - 1) / THREADS;
    lif_update_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        cur, v0, alpha, theta, vth, spikes, vfin, T, n);
    return static_cast<int>(cudaGetLastError());
}
