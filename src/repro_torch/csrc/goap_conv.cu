// Static block-sparse GOAP conv product W'(OC, K) @ X'(K, OI).
//
// Replaces the Pallas kernel repro/kernels/goap_conv.py::goap_conv_block_sparse
// (grid (oc-tiles, oi-tiles, tile-slot), tile k-indices scalar-prefetched).
// Here one thread owns one output element (row = oc-tile * BO + o, column
// oi) and walks its oc-tile row's tile list in order; threads of a warp share
// the row, so every weight load is a broadcast and every X' load is
// coalesced along OI.  Padded tiles carry zero data and point at k-tile 0:
// they add exact zeros, the static-schedule no-ops of the reference.
//
// Bound: bytes.  Each X' element is one f32 read per oc row that needs it
// (served by L1/L2), and the output is written once; the adds are few.
// Rounding: products and sums rounded separately, in tile order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
goap_conv_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                 const float* __restrict__ x, float* __restrict__ out,
                 int max_tiles, int bo, int bk, int n_k_tiles, int oi) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y;                // oc-tile * bo + o
    if (col >= oi) return;
    const int r = row / bo, o = row % bo;
    float acc = 0.0f;
    for (int t = 0; t < max_tiles; ++t) {
        const int kt = cols[r * max_tiles + t];
        if (kt < 0 || kt >= n_k_tiles) {   // bad schedule: poison, never read
            acc = __int_as_float(0x7fc00000);
            break;
        }
        const float* blk = blocks + ((size_t)(r * max_tiles + t) * bo + o) * bk;
        const float* xt = x + (size_t)kt * bk * oi + col;
        for (int k = 0; k < bk; ++k) {
            const float xv = xt[(size_t)k * oi];
            if (xv != 0.0f) acc = __fadd_rn(acc, __fmul_rn(blk[k], xv));
        }
    }
    out[(size_t)row * oi + col] = acc;
}

}  // namespace

extern "C" int goap_conv_block_sparse_f32(const float* blocks, const int* cols,
                                          const float* x, float* out,
                                          int n_oc_tiles, int max_tiles, int bo,
                                          int bk, int n_k_tiles, int oi,
                                          void* stream) {
    dim3 grid((oi + THREADS - 1) / THREADS, n_oc_tiles * bo);
    goap_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        blocks, cols, x, out, max_tiles, bo, bk, n_k_tiles, oi);
    return static_cast<int>(cudaGetLastError());
}
