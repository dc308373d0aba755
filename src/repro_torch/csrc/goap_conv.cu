// Static block-sparse GOAP conv product W'(OC, K) @ X'(K, OI).
//
// Replaces the Pallas kernel repro/kernels/goap_conv.py::goap_conv_block_sparse
// (grid (oc-tiles, oi-tiles, tile-slot), tile k-indices scalar-prefetched).
//
// Bound on the H100: bytes.  X' is the large operand (K_pad x OI f32, 44 MB a
// batch of 64 on the paper model) and the output is the second; the weight
// tiles are a few KB.  The first version gave each thread one output and so
// fetched every X' element once per output row that needed it (16-64 times,
// from L2).  Here a block owns every output row and walks strips of X'
// columns (blocks b, b + grid, ...; the grid is what fits on the card):
//   1. its weight tiles go into shared memory once, transposed to (tile, k,
//      row) so that one k step's rows are one vector load;
//   2. each strip (all K_pad rows) is copied into shared memory with
//      cp.async while the previous strip is walked (two buffers), so each X'
//      element leaves device memory once per launch and the copy hides
//      behind the arithmetic;
//   3. each thread owns RB rows of one oc-tile x 4 columns and walks that
//      oc-tile's tile list in list order, and each tile in k order, from
//      shared memory: per k step one float4 of X', RB/4 float4 of weights
//      (a warp broadcast) and 4*RB accumulations.
// The wrapper plans the strip width, rows per thread and grid against the
// shared memory a block may use (kernels/goap_conv.py::plan_goap_conv_launch).
//
// Rounding.  Every output equals the in-order sum: acc += w * x for each
// non-zero x, product and sum rounded separately, tile order then k order
// (goap_conv_block_sparse_inorder).  Where the strip is all {0, 1} and the
// weights are finite (spikes; checked in shared memory per strip),
// fmaf(x, w, acc) gives exactly that — x == 1 makes the product exact and
// x == 0 adds a zero to an accumulator that is never -0 — in one
// instruction; any other strip takes the two-rounding path.  No tensor
// cores: TF32 or a reordered sum would not be exact.
//
// Padded tiles carry zero data and point at k-tile 0, adding exact zeros.
// A k-tile index outside X' makes its oc-tile's rows NaN and is never read.
// The ragged edge of OI is masked here (zero-filled copies, masked stores).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use

// RB consecutive weights at shared address p (16-byte aligned when RB % 4 == 0).
template <int RB>
__device__ __forceinline__ void load_rows(unsigned p, float (&w)[RB]) {
    if constexpr (RB % 4 == 0) {
#pragma unroll
        for (int j = 0; j < RB; j += 4) {
            const float4 v = repro::lds128(p + 4 * j);
            w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < RB; ++j) w[j] = repro::lds32(p + 4 * j);
    }
}

// One oc-tile's tile list for RB rows x 4 columns.  xs: shared address of
// the strip at this thread's column; ws: of the (MT, BK, BO) tiles at this
// thread's first row.  The next k step's operands are loaded while this
// step's 4*RB accumulations run, so the shared-memory latency hides behind
// them (left to itself, ptxas issues each load just before its first use).
template <int RB, bool BINARY>
__device__ __forceinline__ void walk(unsigned xs, unsigned ws, const int* tile_cols,
                                     int max_tiles, int bk, int bo, int strip,
                                     float (&acc)[RB][4]) {
    const unsigned x_step = 4u * strip, w_step = 4u * bo;
    for (int t = 0; t < max_tiles; ++t) {
        const unsigned xp = xs + (unsigned)tile_cols[t] * bk * x_step;
        const unsigned wp = ws + (unsigned)t * bk * w_step;
        float4 x4 = repro::lds128(xp);
        float w[RB];
        load_rows<RB>(wp, w);
#pragma unroll 2
        for (int k = 0; k < bk; ++k) {
            float4 x4n = x4;
            float wn[RB];
#pragma unroll
            for (int j = 0; j < RB; ++j) wn[j] = w[j];
            if (k + 1 < bk) {
                x4n = repro::lds128(xp + (k + 1) * x_step);
                load_rows<RB>(wp + (k + 1) * w_step, wn);
            }
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int j = 0; j < RB; ++j) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if (BINARY)
                        acc[j][c] = __fmaf_rn(xv[c], w[j], acc[j][c]);
                    else if (xv[c] != 0.0f)
                        acc[j][c] = __fadd_rn(acc[j][c], __fmul_rn(w[j], xv[c]));
                }
            }
            x4 = x4n;
#pragma unroll
            for (int j = 0; j < RB; ++j) w[j] = wn[j];
        }
    }
}

template <int RB>
__global__ void __launch_bounds__(MAX_THREADS, 1)
goap_conv_strip_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                       const float* __restrict__ x, float* __restrict__ out,
                       int n_oc_tiles, int max_tiles, int bo, int bk,
                       int n_k_tiles, int oi, int strip) {
    extern __shared__ __align__(16) float smem[];
    const int k_pad = n_k_tiles * bk;
    const int n_tiles = n_oc_tiles * max_tiles;
    const size_t strip_floats = (size_t)k_pad * strip;
    float* xs = smem;                                      // [2][K_pad][strip]
    float* ws = xs + 2 * strip_floats;                     // [R][MT][BK][BO]
    int* cs = reinterpret_cast<int*>(ws + (size_t)n_tiles * bk * bo);  // [R][MT]
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int n_strips = (oi + strip - 1) / strip;
    const bool vec = (oi & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;

    // one strip, every K_pad row, into buffer buf; columns past OI zero-filled
    auto issue = [&](int s, int buf) {
        float* dst = xs + buf * strip_floats;
        const int col0 = s * strip, width = min(strip, oi - col0);
        if (vec) {
            const int groups = strip >> 2;
            for (int e = tid; e < k_pad * groups; e += nthr) {
                const int k = e / groups, c = (e - k * groups) << 2;
                const bool in = c < width;
                repro::cp_async16(dst + (size_t)k * strip + c,
                                  in ? x + (size_t)k * oi + col0 + c : x, in ? 16 : 0);
            }
        } else {
            for (int e = tid; e < k_pad * strip; e += nthr) {
                const int k = e / strip, c = e - k * strip;
                const bool in = c < width;
                repro::cp_async4(dst + e, in ? x + (size_t)k * oi + col0 + c : x,
                                 in ? 4 : 0);
            }
        }
        repro::cp_async_commit();
    };

    // the tiles, once per block, copied straight into their transposed
    // places (tile, k, row) so that a k step's BO weights are contiguous,
    // and their k-tile indices; all in flight with the first strip
    for (int e = tid; e < n_tiles * bo * bk; e += nthr) {
        const int k = e % bk, o = (e / bk) % bo, rt = e / (bk * bo);
        repro::cp_async4(ws + ((size_t)rt * bk + k) * bo + o, blocks + e, 4);
    }
    for (int e = tid; e < n_tiles; e += nthr) repro::cp_async4(cs + e, cols + e, 4);
    // the block walks strips blockIdx.x, + gridDim.x, ...: the next strip
    // is in flight while this one is walked
    int s = blockIdx.x;
    if (s < n_strips) issue(s, 0);
    else repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    int finite = 1;
    const unsigned ws_s = repro::smem_addr(ws);
#pragma unroll 4
    for (int e = tid; e < n_tiles * bo * bk; e += nthr)
        finite &= isfinite(repro::lds32(ws_s + 4 * e));
    finite = __syncthreads_and(finite);

    const int groups = strip >> 2, chunks = bo / RB;
    for (int it = 0; s < n_strips; ++it, s += gridDim.x) {
        const int buf = it & 1;
        if (it > 0) {                    // strip s was issued a walk ago
            repro::cp_async_wait<0>();
            __syncthreads();
        }
        if (s + (int)gridDim.x < n_strips) issue(s + gridDim.x, buf ^ 1);
        const float* xb = xs + buf * strip_floats;
        int binary = finite;
        const unsigned xb_s = repro::smem_addr(xb);
#pragma unroll 4
        for (int e = tid; e < (int)(strip_floats >> 2); e += nthr)
            binary &= repro::is_binary4(repro::lds128(xb_s + 16 * e));
        binary = __syncthreads_and(binary);
        const int col0 = s * strip, width = min(strip, oi - col0);
        // each item: RB rows of one oc-tile x 4 columns
        for (int item = tid; item < n_oc_tiles * chunks * groups; item += nthr) {
            const int g = item % groups, rq = item / groups;
            const int q = rq % chunks, r = rq / chunks;
            const int c = g << 2;
            if (c >= width) continue;
            const int* tile_cols = cs + r * max_tiles;
            bool bad = false;
            for (int t = 0; t < max_tiles; ++t)
                bad = bad || tile_cols[t] < 0 || tile_cols[t] >= n_k_tiles;
            float acc[RB][4];
#pragma unroll
            for (int j = 0; j < RB; ++j)
#pragma unroll
                for (int cc = 0; cc < 4; ++cc)
                    acc[j][cc] = bad ? __int_as_float(0x7fc00000) : 0.0f;
            if (!bad) {
                const unsigned wr = ws_s + 4u * (r * max_tiles * bk * bo + q * RB);
                if (binary)
                    walk<RB, true>(xb_s + 4 * c, wr, tile_cols, max_tiles, bk, bo, strip, acc);
                else
                    walk<RB, false>(xb_s + 4 * c, wr, tile_cols, max_tiles, bk, bo, strip, acc);
            }
            const int row0 = r * bo + q * RB, col = col0 + c;
#pragma unroll
            for (int j = 0; j < RB; ++j) {
                float* o = out + (size_t)(row0 + j) * oi + col;
                if (vec && c + 4 <= width) {
                    *reinterpret_cast<float4*>(o) =
                        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
                } else {
#pragma unroll
                    for (int cc = 0; cc < 4; ++cc)
                        if (c + cc < width) o[cc] = acc[j][cc];
                }
            }
        }
        __syncthreads();                  // buffer buf is free for strip s + 2 * grid
    }
}

template <int RB>
int launch(const float* blocks, const int* cols, const float* x, float* out,
           int n_oc_tiles, int max_tiles, int bo, int bk, int n_k_tiles, int oi,
           int strip, int grid, int threads, int smem_bytes, cudaStream_t stream) {
    // the largest size, once for every launch: a graph may hold launches of
    // several sizes, and a smaller maximum set later would refuse the larger
    cudaError_t err = cudaFuncSetAttribute(
        goap_conv_strip_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    goap_conv_strip_kernel<RB><<<grid, threads, smem_bytes, stream>>>(
        blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk, n_k_tiles, oi, strip);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int goap_conv_strips_f32(const float* blocks, const int* cols,
                                   const float* x, float* out, int n_oc_tiles,
                                   int max_tiles, int bo, int bk, int n_k_tiles,
                                   int oi, int strip, int rows_per_thread,
                                   int grid, int threads, int smem_bytes,
                                   void* stream) {
    if (strip <= 0 || strip % 4 || grid <= 0 || threads <= 0 || threads > MAX_THREADS ||
        threads % 32 || rows_per_thread <= 0 || bo % rows_per_thread ||
        smem_bytes > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (rows_per_thread) {
        case 8: return launch<8>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                 n_k_tiles, oi, strip, grid, threads, smem_bytes, s);
        case 4: return launch<4>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                 n_k_tiles, oi, strip, grid, threads, smem_bytes, s);
        case 2: return launch<2>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                 n_k_tiles, oi, strip, grid, threads, smem_bytes, s);
        case 1: return launch<1>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                 n_k_tiles, oi, strip, grid, threads, smem_bytes, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// bf16 form.
//
// The reference's kernel follows its operands' dtype: with bf16 tiles and
// X' every tile slot's dot (BO x BK by BK x OI) is accumulated in f32,
// rounded to bf16 (preferred_element_type=out.dtype) and added to the bf16
// output with one more rounding, slot by slot in list order.  The served
// conv never reaches this form (kernels/ops.py casts its operands to f32,
// as the reference's ops.py does); it is the kernel's contract
// (tests/test_kernels.py).  Plain version:
// kernels/goap_conv.py::goap_conv_block_sparse_bf16_ref.
//
// Design: mma.sync m16n8k16 (mma_bf16.cuh) with OI on M, the oc-tile's BO
// rows on N (the reference's BO = 8 is one n8 fragment) and BK on K in k16
// steps.  A block of 4 warps owns one oc-tile x 64 OI columns (16 a warp).
// For each tile slot it stages the tile (BO x BK, k contiguous) and the
// slot's BK rows of X' transposed to (64 columns, BK), both zero-padded to
// multiples of 8 rows and 16 k in shared memory, so a padded row or k adds
// an exact zero; then every warp runs BK/16 k steps per n8 fragment into
// f32 and rounds: out = bf16(out + bf16(dot)).  Shared rows are padded by
// 8 values (conflict-free fragment loads).  A k-tile index outside X'
// makes the oc-tile's rows NaN and is never read, as in the f32 form.
// Bound on the H100: bytes of X' and of the output.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BF_COLS = 64;              // OI columns per block (4 warps x m16)
constexpr int BF_THREADS = 128;
constexpr int BF_MAX_N = 4;              // n8 fragments: BO up to 32

__global__ void __launch_bounds__(BF_THREADS)
goap_conv_bf16_kernel(const __nv_bfloat16* __restrict__ blocks, const int* __restrict__ cols,
                      const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                      int max_tiles, int bo, int bk, int n_k_tiles, int oi) {
    extern __shared__ __align__(16) __nv_bfloat16 bf_smem[];
    const int bkp = (bk + 15) & ~15, bop = (bo + 7) & ~7, ld = bkp + 8;
    __nv_bfloat16* xs = bf_smem;                     // [64 columns][ld]
    __nv_bfloat16* ws = xs + BF_COLS * ld;           // [bop rows][ld]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3, n_frag = bop >> 3;
    const int r = blockIdx.y, o0 = blockIdx.x * BF_COLS;
    const int* tile_cols = cols + (size_t)r * max_tiles;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

    bool bad = false;
    for (int t = 0; t < max_tiles; ++t) bad |= tile_cols[t] < 0 || tile_cols[t] >= n_k_tiles;

    float acc[BF_MAX_N][4];                          // bf16 values
#pragma unroll
    for (int j = 0; j < BF_MAX_N; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

    for (int t = 0; t < max_tiles && !bad; ++t) {
        const __nv_bfloat16* tile = blocks + ((size_t)r * max_tiles + t) * bo * bk;
        const __nv_bfloat16* xk = x + (size_t)tile_cols[t] * bk * oi;
        for (int e = tid; e < bop * bkp; e += BF_THREADS) {
            const int n = e / bkp, k = e % bkp;
            ws[n * ld + k] = (n < bo && k < bk) ? tile[n * bk + k] : zero;
        }
        for (int e = tid; e < bkp * BF_COLS; e += BF_THREADS) {
            const int k = e / BF_COLS, m = e % BF_COLS;
            const int o = o0 + m;
            xs[m * ld + k] = (k < bk && o < oi) ? xk[(size_t)k * oi + o] : zero;
        }
        __syncthreads();
        float dot[BF_MAX_N][4];
#pragma unroll
        for (int j = 0; j < BF_MAX_N; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[j][c] = 0.0f;
        for (int kk = 0; kk < bkp; kk += 16) {
            const __nv_bfloat16* ap = xs + (warp * 16 + g) * ld + kk + 2 * q;
            const unsigned a[4] = {repro::ld_pair(ap), repro::ld_pair(ap + 8 * ld),
                                   repro::ld_pair(ap + 8), repro::ld_pair(ap + 8 * ld + 8)};
#pragma unroll
            for (int j = 0; j < BF_MAX_N; ++j) {
                if (j < n_frag) {
                    const __nv_bfloat16* bp = ws + (j * 8 + g) * ld + kk + 2 * q;
                    const unsigned b[2] = {repro::ld_pair(bp), repro::ld_pair(bp + 8)};
                    repro::mma_bf16_16816(dot[j], a, b);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < BF_MAX_N; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = repro::add_tile_bf16(acc[j][c], dot[j][c]);
        __syncthreads();                             // staging free for the next slot
    }
    const __nv_bfloat16 nan = __float2bfloat16_rn(__int_as_float(0x7fc00000));
#pragma unroll
    for (int j = 0; j < BF_MAX_N; ++j) {
        if (j >= n_frag) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int o = o0 + warp * 16 + g + (c >> 1) * 8;   // M: OI column
            const int n = j * 8 + 2 * q + (c & 1);              // N: row of the oc-tile
            if (o < oi && n < bo)
                out[((size_t)r * bo + n) * oi + o] = bad ? nan : __float2bfloat16_rn(acc[j][c]);
        }
    }
}

}  // namespace

extern "C" int goap_conv_bf16(const __nv_bfloat16* blocks, const int* cols,
                              const __nv_bfloat16* x, __nv_bfloat16* out, int n_oc_tiles,
                              int max_tiles, int bo, int bk, int n_k_tiles, int oi,
                              void* stream) {
    if (n_oc_tiles <= 0 || n_oc_tiles > 65535 || max_tiles < 0 || bo <= 0 ||
        bo > 8 * BF_MAX_N || bk <= 0 || oi <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bkp = (bk + 15) & ~15, bop = (bo + 7) & ~7;
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BF_COLS + bop) * (bkp + 8);
    if (smem > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        goap_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((oi + BF_COLS - 1) / BF_COLS, n_oc_tiles);
    goap_conv_bf16_kernel<<<grid, BF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        blocks, cols, x, out, max_tiles, bo, bk, n_k_tiles, oi);
    return static_cast<int>(cudaGetLastError());
}
