// Weight-masked FC product (B, IN) @ (IN, OUT) with a binary left operand.
//
// Replaces the Pallas kernel repro/kernels/wm_fc.py::wm_fc_matmul (grid
// (B-tiles, OUT-tiles, IN-tiles), reduction minor).  One thread owns one
// output (b, out): it walks the inputs in order and fetches a weight only
// where the input spike is non-zero — the paper's FM = IFM AND WM fetch
// rule (§III-B).  A warp shares the spike row (broadcast loads) and reads
// 32 neighbouring weights of a row (coalesced).  No padding is needed: the
// kernel masks the ragged edge itself.
//
// Bound: bytes of the weight rows of active inputs (L2-resident across the
// batch rows); the adds are few.
// Rounding: products and sums rounded separately, in ascending input order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
wm_fc_kernel(const float* __restrict__ s, const float* __restrict__ w,
             float* __restrict__ out, int din, int dout) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = blockIdx.y;
    if (o >= dout) return;
    const float* srow = s + (size_t)b * din;
    float acc = 0.0f;
    for (int i = 0; i < din; ++i) {
        const float sv = srow[i];
        if (sv != 0.0f) acc = __fadd_rn(acc, __fmul_rn(sv, w[(size_t)i * dout + o]));
    }
    out[(size_t)b * dout + o] = acc;
}

}  // namespace

extern "C" int wm_fc_matmul_f32(const float* s, const float* w, float* out,
                                int batch, int din, int dout, void* stream) {
    dim3 grid((dout + THREADS - 1) / THREADS, batch);
    wm_fc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s, w, out, din, dout);
    return static_cast<int>(cudaGetLastError());
}
