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
// Replaces the bf16 case of the same Pallas kernel: with bf16 weights (and
// the spikes cast to them) the reference accumulates each 128-input tile's
// dot in f32, rounds it to bf16 (preferred_element_type=out.dtype) and adds
// it to the bf16 output with one more rounding, tiles in ascending order.
// One bf16 matmul rounds once, so it computes another function; the plain
// version is kernels/wm_fc.py::wm_fc_matmul_bf16_ref.
//
// Bound on the H100: bytes (1.4 MB a batch of 64 on the paper model, under
// half a microsecond; the products are a few MFLOP for tensor cores that do
// 989 TFLOP/s), so in practice the latency of getting the operands from L2
// into enough SMs.  The first form gave a block 64 rows x 32 outputs (32
// blocks on FC1), walked IN's tiles one after another and staged them with
// 2-byte loads and a transposing store.  Here:
//   1. a block owns ROWS (16 or 32) batch rows x BN (16, 32 or 64) outputs,
//      and its SPLIT warps (up to 8) take one reference tile each: the tile
//      dots are independent (each starts at zero), so they run in parallel
//      and only their rounded sum is ordered;
//   2. each warp stages its tile's spikes (ROWS x 128, row-major) and
//      weights (128 x BN, W's own row-major layout) with 16-byte cp.async,
//      in two halves of 64 inputs, so the second half is in flight while
//      the first runs on the tensor cores (mma.sync m16n8k16, f32
//      fragments); A fragments by ldmatrix.x4, B fragments straight from
//      W's layout by ldmatrix.x4.trans, no transposing pass;
//   3. each warp leaves its f32 dot in shared memory, and after a barrier
//      the block adds the SPLIT tiles to its bf16 accumulators in ascending
//      tile order: out = bf16(out + bf16(dot_t));
//      IN beyond SPLIT tiles takes further rounds;
//   4. the tile leaves as 16-byte stores.
// Rows, outputs and inputs past B, OUT and IN are zero-filled.  Operands
// whose rows are not 16-byte aligned (OUT = 11, an odd offset) are staged
// element by element instead.  The wrapper plans the tiles
// (kernels/wm_fc.py::plan_wm_fc_bf16_launch); the batch lies on grid x.
// What bounds it now (PERF.md): a launch's latency chain (load, dot,
// ordered sum, store) over a card-wide ~2.5 us floor; FC1 runs 128 blocks
// of 16 rows x 32 outputs, which beat 256 blocks of 16 outputs (those read
// each row's spikes from L2 twice as often).
// Within a tile mma.sync sums in its own order: the same bits where the
// sum is exact ({0, 1} spikes against bf16 weights; mma_bf16.cuh).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BF_TILE = 128;             // inputs per reference tile (block_in)
constexpr int BF_HALF = BF_TILE / 2;     // inputs per cp.async group
constexpr int BF_LDA = BF_TILE + 8;      // bf16 per staged spike row (17 x 16 B)
constexpr int BF_MAX_SPLIT = 8;          // warps (reference tiles) per block

__host__ __device__ constexpr int bf_ldb(int bn) { return bn + 8; }   // odd x 16 B
__host__ __device__ constexpr int bf_ldd(int bn) { return bn + 8; }   // f32 per dot row

// Shared memory of one block: per warp its spikes and weights, then the
// warps' dots [split][rows][ldd] (f32) and the accumulators.
__host__ __device__ constexpr int bf_smem(int rows, int bn, int split) {
    return split * 2 * (rows * BF_LDA + BF_TILE * bf_ldb(bn)) +
           4 * (split * rows * bf_ldd(bn) + rows * bn);
}

template <int MF, int NF>
__global__ void __launch_bounds__(32 * BF_MAX_SPLIT)
wm_fc_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, int batch, int din, int dout, int split) {
    constexpr int ROWS = 16 * MF, BN = 8 * NF, LDB = bf_ldb(BN), LDD = bf_ldd(BN);
    constexpr int WARP_ELEMS = ROWS * BF_LDA + BF_TILE * LDB;
    extern __shared__ __align__(16) unsigned char bf_smem_raw[];
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(bf_smem_raw);
    float* dots = reinterpret_cast<float*>(stage + split * WARP_ELEMS);   // [split][ROWS][LDD]
    float* accs = dots + split * ROWS * LDD;                              // [ROWS][BN]
    const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = blockIdx.x * ROWS, col0 = blockIdx.y * BN;
    const int n_tiles = (din + BF_TILE - 1) / BF_TILE;
    const bool s_vec = (din & 7) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
    const bool w_vec = (dout & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const bool o_vec = (dout & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    __nv_bfloat16* as = stage + warp * WARP_ELEMS;                        // [ROWS][BF_LDA]
    __nv_bfloat16* bs = as + ROWS * BF_LDA;                               // [BF_TILE][LDB]
    const unsigned as_s = repro::smem_addr(as), bs_s = repro::smem_addr(bs);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

    // inputs [i0 + h*64, + 64) of the warp's tile: ROWS spike rows and 64
    // weight rows, one commit group; zero past B, IN and OUT
    auto stage_half = [&](int i0, int h) {
        const int k0 = h * BF_HALF;
        for (int e = lane; e < ROWS * (BF_HALF / 8); e += 32) {
            const int r = e / (BF_HALF / 8), k = k0 + (e % (BF_HALF / 8)) * 8;
            const int gr = row0 + r, gk = i0 + k;
            __nv_bfloat16* dst = as + r * BF_LDA + k;
            const __nv_bfloat16* src = s + (size_t)gr * din + gk;
            if (s_vec) {
                const bool in = gr < batch && gk < din;
                repro::cp_async16(dst, in ? src : s, in ? 16 : 0);
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    dst[c] = (gr < batch && gk + c < din) ? src[c] : zero;
            }
        }
        for (int e = lane; e < BF_HALF * (BN / 8); e += 32) {
            const int k = k0 + e / (BN / 8), n = (e % (BN / 8)) * 8;
            const int gk = i0 + k, gn = col0 + n;
            __nv_bfloat16* dst = bs + k * LDB + n;
            const __nv_bfloat16* src = w + (size_t)gk * dout + gn;
            if (w_vec) {
                const bool in = gk < din && gn < dout;
                repro::cp_async16(dst, in ? src : w, in ? 16 : 0);
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    dst[c] = (gk < din && gn + c < dout) ? src[c] : zero;
            }
        }
        repro::cp_async_commit();
    };

    // the k16 steps of inputs [k_lo, k_lo + 64) of the staged tile into dot
    auto mma_steps = [&](int k_lo, float (&dot)[MF][NF][4]) {
#pragma unroll
        for (int kk = k_lo; kk < k_lo + BF_HALF; kk += 16) {
            unsigned a[MF][4];
#pragma unroll
            for (int mi = 0; mi < MF; ++mi)
                repro::ldmatrix_x4(a[mi], as_s + 2 * ((mi * 16 + (lane & 15)) * BF_LDA +
                                                      kk + (lane >> 4) * 8));
#pragma unroll
            for (int jp = 0; jp < NF / 2; ++jp) {
                unsigned b[4];
                repro::ldmatrix_x4_trans(b, bs_s + 2 * ((kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                        LDB + jp * 16 + (lane >> 4) * 8));
                const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
                for (int mi = 0; mi < MF; ++mi) {
                    repro::mma_bf16_16816(dot[mi][2 * jp], a[mi], b0);
                    repro::mma_bf16_16816(dot[mi][2 * jp + 1], a[mi], b1);
                }
            }
        }
    };

    for (int e = tid; e < ROWS * BN; e += nthr) accs[e] = 0.0f;
    for (int t0 = 0; t0 < n_tiles; t0 += split) {
        const int t = t0 + warp;
        if (t < n_tiles) {
            const int i0 = t * BF_TILE;
            __syncwarp();                    // the warp's last ldmatrix is done
            stage_half(i0, 0);
            stage_half(i0, 1);
            float dot[MF][NF][4];
#pragma unroll
            for (int mi = 0; mi < MF; ++mi)
#pragma unroll
                for (int j = 0; j < NF; ++j)
#pragma unroll
                    for (int c = 0; c < 4; ++c) dot[mi][j][c] = 0.0f;
            repro::cp_async_wait<1>();
            __syncwarp();                    // the first half has landed
            mma_steps(0, dot);
            repro::cp_async_wait<0>();
            __syncwarp();
            mma_steps(BF_HALF, dot);
            float* dw = dots + warp * ROWS * LDD;
#pragma unroll
            for (int mi = 0; mi < MF; ++mi)
#pragma unroll
                for (int j = 0; j < NF; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *reinterpret_cast<float2*>(dw + (mi * 16 + g + 8 * h) * LDD + j * 8 + 2 * q) =
                            make_float2(dot[mi][j][2 * h], dot[mi][j][2 * h + 1]);
        }
        __syncthreads();                     // every tile's dot is in
        const int active = min(split, n_tiles - t0);
        for (int e = tid; e < ROWS * BN; e += nthr) {
            const int r = e / BN, c = e % BN;
            float acc = accs[e];
            for (int u = 0; u < active; ++u)
                acc = repro::add_tile_bf16(acc, dots[(u * ROWS + r) * LDD + c]);
            accs[e] = acc;
        }
        __syncthreads();                     // dots free for the next round
    }
    for (int e = tid; e < ROWS * (BN / 8); e += nthr) {
        const int r = e / (BN / 8), n = (e % (BN / 8)) * 8;
        const int gr = row0 + r, gn = col0 + n;
        if (gr >= batch || gn >= dout) continue;
        const float* a = accs + r * BN + n;
        __nv_bfloat16* dst = out + (size_t)gr * dout + gn;
        if (o_vec) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(
                repro::pack_bf16(a[0], a[1]), repro::pack_bf16(a[2], a[3]),
                repro::pack_bf16(a[4], a[5]), repro::pack_bf16(a[6], a[7]));
        } else {
            for (int c = 0; c < 8 && gn + c < dout; ++c) dst[c] = __float2bfloat16_rn(a[c]);
        }
    }
}

template <int MF, int NF>
int launch_bf16(const __nv_bfloat16* s, const __nv_bfloat16* w, __nv_bfloat16* out,
                int batch, int din, int dout, int split, int smem_bytes,
                cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        wm_fc_bf16_kernel<MF, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((batch + 16 * MF - 1) / (16 * MF), (dout + 8 * NF - 1) / (8 * NF));
    wm_fc_bf16_kernel<MF, NF><<<grid, 32 * split, smem_bytes, stream>>>(
        s, w, out, batch, din, dout, split);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wm_fc_bf16(const __nv_bfloat16* s, const __nv_bfloat16* w, __nv_bfloat16* out,
                          int batch, int din, int dout, int rows, int out_tile, int split,
                          int threads, int smem_bytes, void* stream) {
    if (batch <= 0 || din < 0 || dout <= 0 || split < 1 || split > BF_MAX_SPLIT ||
        threads != 32 * split || (rows != 16 && rows != 32) ||
        (out_tile != 16 && out_tile != 32 && out_tile != 64) ||
        smem_bytes < bf_smem(rows, out_tile, split) || smem_bytes > MAX_SMEM ||
        (dout + out_tile - 1) / out_tile > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int mf = rows / 16, nf = out_tile / 8;
#define REPRO_FC_BF16(M, N)                                                          \
    if (mf == M && nf == N)                                                          \
        return launch_bf16<M, N>(s, w, out, batch, din, dout, split, smem_bytes, st);
    REPRO_FC_BF16(1, 2) REPRO_FC_BF16(1, 4) REPRO_FC_BF16(1, 8)
    REPRO_FC_BF16(2, 2) REPRO_FC_BF16(2, 4) REPRO_FC_BF16(2, 8)
#undef REPRO_FC_BF16
    return static_cast<int>(cudaErrorInvalidValue);
}
