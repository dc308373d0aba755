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
// Replaces the bf16 case of the same Pallas kernel: with bf16 tiles and X'
// the reference accumulates every tile slot's dot (BO x BK by BK x OI) in
// f32, rounds it to bf16 (preferred_element_type=out.dtype) and adds it to
// the bf16 output with one more rounding, slot by slot in list order.  The
// served conv never reaches this form (kernels/ops.py casts its operands to
// f32, as the reference's ops.py does); it is the kernel's contract
// (tests/test_kernels.py).  Plain version:
// kernels/goap_conv.py::goap_conv_block_sparse_bf16_ref.
//
// Bound on the H100: bytes of X' (K_pad x OI bf16, 22 MB a batch of 64 on
// the paper model's three convs) and of the output.  The first form gave a
// block one oc-tile x 64 columns, so every oc-tile's block fetched the same
// X' columns again, restaged each slot's X' transposed with 2-byte loads,
// and stored 2 bytes at a time.  Here, as in the f32 form above:
//   1. a block owns every oc-tile x a strip of OI columns and walks strips
//      b, b + grid, ... (the grid is what fits on the card at once);
//   2. each strip (64, 128 or 256 columns), all K_pad rows k-major as X'
//      lies, is copied into shared memory once with 16-byte cp.async while
//      the previous strip is computed (two buffers), so X' leaves device
//      memory once per launch; each k-tile's rows are padded to a multiple
//      of 16 with zeros, and each 64 columns of a row are 128 bytes whose
//      16-byte chunks are swizzled by the row, not padded, so conv2's 192
//      rows fit twice at 256 columns;
//   3. the block's tiles are copied once, in their own (BO, BK) k-contiguous
//      layout, which is mma.sync's "col" B operand (ldmatrix.x2);
//   4. up to 16 warps walk (oc-tile, MG x 16 columns) items, MG = 4 (2
//      above BO = 16): per tile slot in list order, the A fragments of
//      X'^T come from the k-major strip by ldmatrix.x4.trans (no
//      transposing pass), BK/16 mma.sync m16n8k16 steps per n8 fragment of
//      BO (OI on M, BO on N) into f32, MG independent chains on one B
//      load; then out = bf16(out + bf16(dot)), two outputs an instruction
//      pair (add_tile_bf16x2);
//   5. each item's fragments go into an output tile in shared memory by
//      stmatrix.trans, and the tile leaves as 16-byte stores.
// What bounds it now (phase split, PERF.md): the first strip's load, which
// nothing overlaps (most blocks walk one or two strips), and the A fragment
// reads, 512 bytes of shared memory per mma.  Sharing A fragments across
// the oc-tiles of a slot, deeper strip rings, per-k-tile mbarriers (fed by
// cp.async, or by TMA boxes with the same swizzle), row-by-row bulk copies
// and output rows on M all measured slower or no faster.
// Padded rows and k add exact zeros.  A k-tile index outside X' makes its
// oc-tile's rows NaN and is never read.  The ragged edge of OI is masked
// (zero-filled copies, masked stores); operands whose rows are not 16-byte
// aligned are staged or stored element by element.  The wrapper plans the
// strip, grid and shared memory (kernels/goap_conv.py::
// plan_goap_conv_bf16_launch).  Within a slot mma.sync sums in its own
// order: the same bits where the sum is exact (mma_bf16.cuh).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BF_MAX_N = 4;              // n8 fragments: BO up to 32
constexpr int BF_MAX_WARPS = 16;
constexpr int BF_BOX = 64;               // X' columns a 128-byte row of a strip

__host__ __device__ constexpr int bf_pad16(int v) { return (v + 15) & ~15; }

// 16-column groups a warp item computes together: 4 up to two n8
// fragments of BO, else 2 (the registers of a 512-thread block).
__host__ __device__ constexpr int bf_groups(int bo) { return bo <= 16 ? 4 : 2; }

// Shared memory of one block (bytes): two strips [n_k][strip / 64][bkp][64],
// the tiles [R * MT][bop][bkp + 8] and the output tile [R * bop][strip + 8]
// in bf16, then the tile indices.
__host__ __device__ constexpr long long bf_smem(int r, int mt, int bo, int bk, int n_k,
                                                int strip) {
    return 2LL * (2LL * n_k * bf_pad16(bk) * strip +
                  (long long)r * mt * ((bo + 7) & ~7) * (bf_pad16(bk) + 8) +
                  (long long)r * ((bo + 7) & ~7) * (strip + 8)) +
           4LL * r * mt;
}

// A warp item is one oc-tile x MG groups of 16 columns: MG independent mma
// chains that hide each other's latency, and one B fragment load for all.
template <int NF>
__global__ void __launch_bounds__(32 * BF_MAX_WARPS)
goap_conv_bf16_kernel(const __nv_bfloat16* __restrict__ blocks, const int* __restrict__ cols,
                      const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                      int n_oc_tiles, int max_tiles, int bo, int bk, int n_k_tiles, int oi,
                      int strip) {
    constexpr int MG = bf_groups(8 * NF);
    extern __shared__ __align__(16) unsigned char bf_smem_raw[];
    const int bkp = bf_pad16(bk), bop = 8 * NF, ldx = strip + 8, ldw = bkp + 8;
    const int n_tiles = n_oc_tiles * max_tiles, n_box = strip / BF_BOX;
    const unsigned strip_bytes = 2u * n_k_tiles * bkp * strip;
    unsigned char* xs = bf_smem_raw;                                   // [2][n_k][n_box][bkp][64]
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(xs + 2 * strip_bytes);  // [tiles][bop][ldw]
    __nv_bfloat16* os = ws + (size_t)n_tiles * bop * ldw;              // [R * bop][ldx]
    int* cs = reinterpret_cast<int*>(os + (size_t)n_oc_tiles * bop * ldx);  // [R][MT]
    const unsigned xs_s = repro::smem_addr(xs);
    const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
    const int n_warps = nthr >> 5, groups = strip / (16 * MG);
    const int n_items = n_oc_tiles * groups;
    const int n_strips = (oi + strip - 1) / strip;
    const bool x_vec = (oi & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool o_vec = (oi & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const bool w_vec = (bk & 7) == 0 && (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

    // A strip in shared memory: k-tile kt, 64 columns b, row kk < bkp, 128
    // bytes a row, its 16-byte chunks swizzled by the row (chunk j of row kk
    // at j ^ (kk % 8)), so ldmatrix reads 8 rows of one chunk from 8
    // distinct banks without padding the rows (a strip of 256 columns fits
    // conv2's 192 rows twice).
    auto x_offset = [&](int kt, int kk, int c) {
        return (unsigned)(((kt * n_box + (c >> 6)) * bkp + kk) * 128 +
                          ((((c >> 3) & 7) ^ (kk & 7)) << 4) + ((c & 7) << 1));
    };

    // one strip, every k-tile's rows padded to bkp, into buffer buf, as one
    // commit group; columns past OI and rows past BK zero-filled.  The
    // copies go 16 bytes a thread: strip / 8 chunks a row divide the block,
    // so each thread keeps one column chunk and steps through the rows.
    const int chunks = strip >> 3, c_own = (tid & (chunks - 1)) << 3;
    const int row_first = tid / chunks, row_step = nthr / chunks;
    auto issue = [&](int s, int buf) {
        unsigned char* dst0 = xs + buf * strip_bytes;
        const int col0 = s * strip, width = min(strip, oi - col0);
        const __nv_bfloat16* src0 = x + col0 + c_own;
        int kt = row_first / bkp, kk = row_first - kt * bkp;
        for (int row = row_first; row < n_k_tiles * bkp; row += row_step) {
            unsigned char* dst = dst0 + x_offset(kt, kk, c_own);
            const __nv_bfloat16* src = src0 + (size_t)(kt * bk + kk) * oi;
            if (x_vec) {
                const bool in = kk < bk && c_own < width;
                repro::cp_async16(dst, in ? src : x, in ? 16 : 0);
            } else {
                __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
                for (int cc = 0; cc < 8; ++cc)
                    d[cc] = (kk < bk && c_own + cc < width) ? src[cc] : zero;
            }
            for (kk += row_step; kk >= bkp; kk -= bkp) ++kt;
        }
        repro::cp_async_commit();
    };

    // the tiles, once per block, rows padded to bop and k to bkp with
    // zeros, and their indices, in flight with the first strip
    const int tile_chunks = bkp >> 3;
    for (int e = tid; e < n_tiles * bop * tile_chunks; e += nthr) {
        const int k = (e % tile_chunks) << 3, rn = e / tile_chunks;
        const int n = rn % bop, rt = rn / bop;
        __nv_bfloat16* dst = ws + ((size_t)rt * bop + n) * ldw + k;
        const __nv_bfloat16* src = blocks + ((size_t)rt * bo + n) * bk + k;
        if (w_vec && n < bo && k < bk) {
            repro::cp_async16(dst, src, 16);
        } else {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) dst[cc] = (n < bo && k + cc < bk) ? src[cc] : zero;
        }
    }
    for (int e = tid; e < n_tiles; e += nthr) repro::cp_async4(cs + e, cols + e, 4);
    // the block walks strips blockIdx.x, + gridDim.x, ...: the next strip
    // is in flight while one is computed
    int s = blockIdx.x;
    if (s < n_strips) issue(s, 0);
    else repro::cp_async_commit();

    const unsigned ws_s = repro::smem_addr(ws), os_s = repro::smem_addr(os);
    // lane offsets of the ldmatrix / stmatrix rows: A's k row and 16-column
    // group (its swizzled chunk is fixed: kk is a multiple of 16), B's
    const int a_row = (lane & 7) + (lane >> 4) * 8, a_col = ((lane >> 3) & 1) * 8;
    const int b_row = lane & 7, b_col = ((lane >> 3) & 1) * 8;
    const unsigned nan2 = 0x7fc07fc0u;       // two bf16 NaNs, as the plain version's
    for (int it = 0; s < n_strips; ++it, s += gridDim.x) {
        const int buf = it & 1;
        repro::cp_async_wait<0>();
        __syncthreads();          // strip s (and the tiles) landed; the other buffer and os are free
        if (s + (int)gridDim.x < n_strips) issue(s + gridDim.x, buf ^ 1);
        const int col0 = s * strip, width = min(strip, oi - col0);
        const unsigned xb_s = xs_s + buf * strip_bytes;
        for (int item = warp; item < n_items; item += n_warps) {
            const int r = item / groups, m0 = (item - r * groups) * (16 * MG);
            if (m0 >= width) continue;
            const int* tile_cols = cs + r * max_tiles;
            // a k-tile index outside X' poisons the oc-tile (the lanes vote)
            bool bad = false;
            for (int t0 = 0; t0 < max_tiles; t0 += 32) {
                const int c = t0 + lane < max_tiles ? tile_cols[t0 + lane] : 0;
                bad |= __any_sync(0xffffffffu, c < 0 || c >= n_k_tiles);
            }
            // bf16 accumulators packed in pairs: [g][j][0] = C rows g, [1] = g + 8
            unsigned acc[MG][NF][2];
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
                for (int j = 0; j < NF; ++j) acc[g][j][0] = acc[g][j][1] = bad ? nan2 : 0u;
            unsigned xa[MG];
#pragma unroll
            for (int g = 0; g < MG; ++g) xa[g] = xb_s + x_offset(0, a_row, m0 + g * 16 + a_col);
#pragma unroll 2
            for (int t = 0; t < (bad ? 0 : max_tiles); ++t) {
                const unsigned xt = 128u * tile_cols[t] * n_box * bkp;
                const unsigned wb =
                    ws_s + 2u * (((r * max_tiles + t) * bop + b_row) * ldw + b_col);
                float dot[MG][NF][4];
                for (int kk = 0; kk < bkp; kk += 16) {
                    unsigned b[NF][2], a[MG][4];
#pragma unroll
                    for (int j = 0; j < NF; ++j) repro::ldmatrix_x2(b[j], wb + 2u * (j * 8 * ldw + kk));
#pragma unroll
                    for (int g = 0; g < MG; ++g)
                        repro::ldmatrix_x4_trans(a[g], xa[g] + xt + 128u * kk);
#pragma unroll
                    for (int g = 0; g < MG; ++g)
#pragma unroll
                        for (int j = 0; j < NF; ++j) {
                            if (kk == 0) repro::mma_bf16_16816_zero(dot[g][j], a[g], b[j]);
                            else repro::mma_bf16_16816(dot[g][j], a[g], b[j]);
                        }
                }
#pragma unroll
                for (int g = 0; g < MG; ++g)
#pragma unroll
                    for (int j = 0; j < NF; ++j) {
                        acc[g][j][0] = repro::add_tile_bf16x2(acc[g][j][0], dot[g][j][0], dot[g][j][1]);
                        acc[g][j][1] = repro::add_tile_bf16x2(acc[g][j][1], dot[g][j][2], dot[g][j][3]);
                    }
            }
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
                for (int j = 0; j < NF; ++j)
                    repro::stmatrix_x2_trans(
                        os_s + 2u * ((r * bop + j * 8 + b_row) * ldx + m0 + g * 16 + b_col),
                        acc[g][j][0], acc[g][j][1]);
        }
        __syncthreads();          // the output tile is complete
        // rows r * bo + n (n < bo) x [col0, col0 + width), 16 bytes a thread
        int r = row_first / bo, n = row_first - r * bo;
        for (int row = row_first; row < n_oc_tiles * bo; row += row_step) {
            if (c_own < width) {
                const __nv_bfloat16* src = os + (size_t)(r * bop + n) * ldx + c_own;
                __nv_bfloat16* dst = out + (size_t)row * oi + col0 + c_own;
                if (o_vec) {
                    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
                } else {
                    for (int cc = 0; cc < 8 && c_own + cc < width; ++cc) dst[cc] = src[cc];
                }
            }
            for (n += row_step; n >= bo; n -= bo) ++r;
        }
    }
    repro::cp_async_wait<0>();    // no copy outlives the block
}

template <int NF>
int launch_bf16(const __nv_bfloat16* blocks, const int* cols, const __nv_bfloat16* x,
                __nv_bfloat16* out, int n_oc_tiles, int max_tiles, int bo, int bk,
                int n_k_tiles, int oi, int strip, int grid, int threads, int smem_bytes,
                cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        goap_conv_bf16_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    goap_conv_bf16_kernel<NF><<<grid, threads, smem_bytes, stream>>>(
        blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk, n_k_tiles, oi, strip);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int goap_conv_bf16(const __nv_bfloat16* blocks, const int* cols,
                              const __nv_bfloat16* x, __nv_bfloat16* out, int n_oc_tiles,
                              int max_tiles, int bo, int bk, int n_k_tiles, int oi,
                              int strip, int grid, int threads, int smem_bytes,
                              void* stream) {
    if (n_oc_tiles <= 0 || max_tiles < 0 || bo <= 0 || bo > 8 * BF_MAX_N || bk <= 0 ||
        n_k_tiles < 0 || oi <= 0 || strip < BF_BOX || strip > 4 * BF_BOX ||
        (strip & (strip - 1)) || grid <= 0 || threads < 32 || threads % 32 ||
        threads > 32 * BF_MAX_WARPS || smem_bytes > MAX_SMEM ||
        smem_bytes < bf_smem(n_oc_tiles, max_tiles, bo, bk, n_k_tiles, strip))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch ((bo + 7) / 8) {
        case 1: return launch_bf16<1>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                      n_k_tiles, oi, strip, grid, threads, smem_bytes, st);
        case 2: return launch_bf16<2>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                      n_k_tiles, oi, strip, grid, threads, smem_bytes, st);
        case 3: return launch_bf16<3>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                      n_k_tiles, oi, strip, grid, threads, smem_bytes, st);
        default: return launch_bf16<4>(blocks, cols, x, out, n_oc_tiles, max_tiles, bo, bk,
                                       n_k_tiles, oi, strip, grid, threads, smem_bytes, st);
    }
}
