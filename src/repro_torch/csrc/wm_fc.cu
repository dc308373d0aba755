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

// ---------------------------------------------------------------------------
// bf16 form.
//
// The reference's kernel follows its operands' dtype: with bf16 weights
// (and the spikes cast to them) each 128-input tile's dot is accumulated
// in f32, rounded to bf16 (preferred_element_type=out.dtype) and added to
// the bf16 output with one more rounding.  One bf16 matmul rounds once, so
// it computes another function; the plain version is
// kernels/wm_fc.py::wm_fc_matmul_bf16_ref.
//
// Design: mma.sync m16n8k16 (mma_bf16.cuh) with batch rows on M, outputs
// on N and inputs on K.  A block of 4 warps owns 64 batch rows x 32
// outputs; each warp 16 rows x 4 n8 fragments.  Per 128-input tile the
// block stages its spikes (64 x 128, row-major) and its weights transposed
// to (32 outputs, 128 inputs) in shared memory, zero-filled past B, IN and
// OUT (OUT = 11 pads N to 16 with zeros), runs 8 k16 steps into f32
// fragments, then rounds: out = bf16(out + bf16(dot)).  Rows are padded by
// 8 values, so the fragment loads of a warp hit 32 distinct banks.
// Bound on the H100: bytes (the products are a few MFLOP for tensor cores
// that do 989 TFLOP/s); this first form stages with plain loads.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BF_ROWS = 64;              // batch rows per block (4 warps x 16)
constexpr int BF_OUTS = 32;              // outputs per block (4 n8 fragments)
constexpr int BF_TILE = 128;             // inputs per reference tile (block_in)
constexpr int BF_LD = BF_TILE + 8;       // bf16 values per shared row
constexpr int BF_THREADS = 128;

__global__ void __launch_bounds__(BF_THREADS)
wm_fc_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, int batch, int din, int dout) {
    __shared__ __align__(16) __nv_bfloat16 as[BF_ROWS * BF_LD];   // [row][input]
    __shared__ __align__(16) __nv_bfloat16 bs[BF_OUTS * BF_LD];   // [output][input]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = blockIdx.x * BF_ROWS, col0 = blockIdx.y * BF_OUTS;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    float acc[4][4];                         // bf16 values: [n fragment][c]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

    for (int i0 = 0; i0 < din; i0 += BF_TILE) {
        for (int e = tid; e < BF_ROWS * BF_TILE; e += BF_THREADS) {
            const int r = e / BF_TILE, k = e % BF_TILE;
            const int gr = row0 + r, gk = i0 + k;
            as[r * BF_LD + k] = (gr < batch && gk < din) ? s[(size_t)gr * din + gk] : zero;
        }
        for (int e = tid; e < BF_OUTS * BF_TILE; e += BF_THREADS) {
            const int k = e / BF_OUTS, n = e % BF_OUTS;
            const int gk = i0 + k, gn = col0 + n;
            bs[n * BF_LD + k] = (gk < din && gn < dout) ? w[(size_t)gk * dout + gn] : zero;
        }
        __syncthreads();
        float dot[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[j][c] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < BF_TILE; kk += 16) {
            const __nv_bfloat16* ap = as + (warp * 16 + g) * BF_LD + kk + 2 * q;
            const unsigned a[4] = {repro::ld_pair(ap), repro::ld_pair(ap + 8 * BF_LD),
                                   repro::ld_pair(ap + 8), repro::ld_pair(ap + 8 * BF_LD + 8)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat16* bp = bs + (j * 8 + g) * BF_LD + kk + 2 * q;
                const unsigned b[2] = {repro::ld_pair(bp), repro::ld_pair(bp + 8)};
                repro::mma_bf16_16816(dot[j], a, b);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = repro::add_tile_bf16(acc[j][c], dot[j][c]);
        __syncthreads();                     // the tiles are free for the next inputs
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int r = row0 + warp * 16 + g + (c >> 1) * 8;
            const int n = col0 + j * 8 + 2 * q + (c & 1);
            if (r < batch && n < dout) out[(size_t)r * dout + n] = __float2bfloat16_rn(acc[j][c]);
        }
    }
}

}  // namespace

extern "C" int wm_fc_bf16(const __nv_bfloat16* s, const __nv_bfloat16* w, __nv_bfloat16* out,
                          int batch, int din, int dout, void* stream) {
    if (batch <= 0 || din < 0 || dout <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((batch + BF_ROWS - 1) / BF_ROWS, (dout + BF_OUTS - 1) / BF_OUTS);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    wm_fc_bf16_kernel<<<grid, BF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s, w, out, batch, din, dout);
    return static_cast<int>(cudaGetLastError());
}
