// Weight-masked FC product (B, IN) @ (IN, OUT) with a binary left operand.
//
// Replaces the Pallas kernel repro/kernels/wm_fc.py::wm_fc_matmul (grid
// (B-tiles, OUT-tiles, IN-tiles), reduction minor).
//
// Bound on the H100: bytes in principle (2.8 MB a batch of 64 on the paper
// model, under a microsecond), but each output is a chain of IN dependent
// adds, and 512 rows x 128 outputs give only 16K lanes of 4 outputs, about
// four warps an SM; so in practice the issue rate of the adds and of the
// shared-memory reads that feed them.  The first version gave one block to
// each batch row, so every block walked all of W again from L2, one scalar
// load per active input.  Here one block owns a tile of batch rows x a tile
// of outputs:
//   1. it streams W's rows for its outputs through shared memory in chunks
//      of IN, double-buffered with cp.async, together with the same chunk of
//      its rows' spikes: each weight row leaves L2 once per block and serves
//      every batch row of the tile;
//   2. each lane owns one batch row x 4 outputs and walks the chunk's inputs
//      in order: per 4 inputs one float4 of spikes, and per input one float4
//      of weights and 4 accumulations.  Lanes span rows x outputs, so an
//      output tile narrower than a warp (OUT = 11) still fills it.
// Compacting each row's active inputs into index lists first (the paper's
// FM = IFM AND WM rule, applied per weight read) halves the adds but costs
// a serial ballot/prefix pass and two more barriers per chunk; at four
// warps an SM it measured slower (PERF.md §6), so every weight of the
// tile is read and a zero spike adds an exact zero.
// The wrapper plans the tiles (kernels/wm_fc.py::plan_wm_fc_launch).  The
// batch lies on grid x, so it is not capped at 65,535 rows.
//
// Rounding.  Every output equals the in-order sum: inputs in ascending
// order, acc += s * w for each non-zero spike s, product and sum rounded
// separately (wm_fc_matmul_inorder).  Where a chunk's spikes are all {0, 1}
// and its weights finite (checked in shared memory per chunk), fmaf(s, w,
// acc) gives exactly that in one instruction: s == 1 makes the product
// exact, and s == 0 adds a zero to an accumulator that is never -0.  Any
// other chunk multiplies and adds with two roundings and skips zeros.  No
// tensor cores: TF32 or a reordered sum would not be exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int CHUNK = 128;         // inputs per shared-memory chunk
constexpr int S_STRIDE = CHUNK + 4;  // padded: the rows of a warp hit other banks
constexpr int STEP = 8;            // inputs per register-prefetch step

// Spikes of STEP inputs (2 float4) and their weight rows (STEP float4), at
// 32-bit shared addresses (see async_copy.cuh).
__device__ __forceinline__ void load_step(unsigned sr, unsigned wl, int out_tile, int i,
                                          float4 (&sv)[2], float4 (&wv)[STEP]) {
    sv[0] = repro::lds128(sr + 4 * i);
    sv[1] = repro::lds128(sr + 4 * (i + 4));
#pragma unroll
    for (int u = 0; u < STEP; ++u) wv[u] = repro::lds128(wl + 4 * (i + u) * out_tile);
}

// acc[c] += s[u] * w[u][c] for STEP inputs in order, as exact FFMAs.
__device__ __forceinline__ void ffma_step(const float4 (&sv)[2], const float4 (&wv)[STEP],
                                          float (&acc)[4]) {
    const float sx[STEP] = {sv[0].x, sv[0].y, sv[0].z, sv[0].w,
                            sv[1].x, sv[1].y, sv[1].z, sv[1].w};
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
        acc[0] = __fmaf_rn(sx[u], wv[u].x, acc[0]);
        acc[1] = __fmaf_rn(sx[u], wv[u].y, acc[1]);
        acc[2] = __fmaf_rn(sx[u], wv[u].z, acc[2]);
        acc[3] = __fmaf_rn(sx[u], wv[u].w, acc[3]);
    }
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
wm_fc_tile_kernel(const float* __restrict__ s, const float* __restrict__ w,
                  float* __restrict__ out, int batch, int din, int dout,
                  int rows, int out_tile) {
    extern __shared__ __align__(16) float smem[];
    float* ws = smem;                                    // [2][CHUNK][out_tile]
    float* ss = ws + 2 * CHUNK * out_tile;               // [2][rows][S_STRIDE]
    const int tid = threadIdx.x, nthr = blockDim.x;      // nthr == rows * groups
    const int groups = out_tile >> 2;                    // lanes per batch row
    const int rl = tid / groups, og = tid - rl * groups;
    const int row0 = blockIdx.x * rows, o = blockIdx.y * out_tile + og * 4;
    const bool w_vec = (dout & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const bool s_vec = (din & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
    const int n_chunks = (din + CHUNK - 1) / CHUNK;
    constexpr int Q = CHUNK / 4;                         // float4 per spike row

    // W rows [i0, i0 + CHUNK) x this lane's 4 outputs (each lane copies the
    // rows rl, rl + rows, ...) and the tile's spikes of the same inputs;
    // everything past B, IN or OUT is zero-filled
    auto issue = [&](int c) {
        const int buf = c & 1, i0 = c * CHUNK;
        float* wd = ws + buf * CHUNK * out_tile + og * 4;
        for (int i = rl; i < CHUNK; i += rows) {
            const float* src = w + (size_t)(i0 + i) * dout + o;
            if (w_vec) {
                const bool in = i0 + i < din && o < dout;
                repro::cp_async16(wd + i * out_tile, in ? src : w, in ? 16 : 0);
            } else {
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    const bool in = i0 + i < din && o + cc < dout;
                    repro::cp_async4(wd + i * out_tile + cc, in ? src + cc : w, in ? 4 : 0);
                }
            }
        }
        float* sd = ss + buf * rows * S_STRIDE;
        for (int e = tid; e < rows * Q; e += nthr) {
            const int r = e / Q, k = (e % Q) * 4;
            const float* src = s + (size_t)(row0 + r) * din + i0 + k;
            if (s_vec) {
                const bool in = row0 + r < batch && i0 + k < din;
                repro::cp_async16(sd + r * S_STRIDE + k, in ? src : s, in ? 16 : 0);
            } else {
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    const bool in = row0 + r < batch && i0 + k + cc < din;
                    repro::cp_async4(sd + r * S_STRIDE + k + cc, in ? src + cc : s,
                                     in ? 4 : 0);
                }
            }
        }
        repro::cp_async_commit();
    };

    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n_chunks > 0) issue(0);
    for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) {
            issue(c + 1);
            repro::cp_async_wait<1>();
        } else {
            repro::cp_async_wait<0>();
        }
        __syncthreads();                                 // chunk c has landed
        const float* sd = ss + (c & 1) * rows * S_STRIDE;
        const float* wd = ws + (c & 1) * CHUNK * out_tile;
        // the exact FFMA walk needs {0, 1} spikes and finite weights; each
        // thread checks the spikes and the weights it copied
        const unsigned sd_s = repro::smem_addr(sd), wd_s = repro::smem_addr(wd);
        int binary = 1;
#pragma unroll 4
        for (int e = tid; e < rows * Q; e += nthr)
            binary &= repro::is_binary4(
                repro::lds128(sd_s + 4 * ((e / Q) * S_STRIDE + (e % Q) * 4)));
#pragma unroll 4
        for (int i = rl; i < CHUNK; i += rows) {
            const float4 v = repro::lds128(wd_s + 4 * (i * out_tile + og * 4));
            binary &= isfinite(v.x) & isfinite(v.y) & isfinite(v.z) & isfinite(v.w);
        }
        binary = __syncthreads_and(binary);
        const float* sr = sd + rl * S_STRIDE;
        const float* wl = wd + og * 4;
        if (binary) {
            const unsigned sr_s = sd_s + 4 * rl * S_STRIDE, wl_s = wd_s + 16 * og;
            // two register buffers in turn: one step's STEP inputs load
            // while the other's 4*STEP FFMAs run
            float4 sa[2], wa[STEP], sb[2], wb[STEP];
            load_step(sr_s, wl_s, out_tile, 0, sa, wa);
            for (int i = 0; i < CHUNK; i += 2 * STEP) {
                load_step(sr_s, wl_s, out_tile, i + STEP, sb, wb);
                ffma_step(sa, wa, acc);
                if (i + 2 * STEP < CHUNK) load_step(sr_s, wl_s, out_tile, i + 2 * STEP, sa, wa);
                ffma_step(sb, wb, acc);
            }
        } else {
            for (int i = 0; i < CHUNK; ++i) {
                const float sx = sr[i];
                if (sx == 0.0f) continue;
                const float4 wi = *reinterpret_cast<const float4*>(wl + i * out_tile);
                acc[0] = __fadd_rn(acc[0], __fmul_rn(sx, wi.x));
                acc[1] = __fadd_rn(acc[1], __fmul_rn(sx, wi.y));
                acc[2] = __fadd_rn(acc[2], __fmul_rn(sx, wi.z));
                acc[3] = __fadd_rn(acc[3], __fmul_rn(sx, wi.w));
            }
        }
        __syncthreads();                                 // buffers free for c + 2
    }
    const int row = row0 + rl;
    if (row >= batch) return;
    float* dst = out + (size_t)row * dout + o;
    if (w_vec && (reinterpret_cast<uintptr_t>(out) & 15) == 0 && o + 4 <= dout) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
            if (o + cc < dout) dst[cc] = acc[cc];
    }
}

}  // namespace

extern "C" int wm_fc_chunked_f32(const float* s, const float* w, float* out,
                                int batch, int din, int dout, int rows,
                                int out_tile, int threads, int smem_bytes,
                                void* stream) {
    if (out_tile <= 0 || out_tile % 4 || 32 % (out_tile / 4) ||
        threads != rows * (out_tile / 4) || threads > MAX_THREADS || threads % 32 ||
        smem_bytes > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    // the largest size, once for every launch (see goap_conv.cu)
    cudaError_t err = cudaFuncSetAttribute(
        wm_fc_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((batch + rows - 1) / rows, (dout + out_tile - 1) / out_tile);
    wm_fc_tile_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        s, w, out, batch, din, dout, rows, out_tile);
    return static_cast<int>(cudaGetLastError());
}
