// Whole-network streaming SNN forward: one launch, one thread-block cluster
// of C CTAs per sample, split by output channel.
//
// Replaces the Pallas kernel repro/kernels/stream_fused.py::stream_fused_forward
// (grid (batch, T) with T minor and every layer's state in VMEM scratch).
// Hopper runs blocks in parallel and in no order, so the sequential T grid
// axis becomes a loop inside the cluster, which carries one sample's state
// through all T timesteps.
//
// Output-channel dataflow (the paper's): CTA q of a sample's cluster owns
// ceil(OC / C) channels of every conv and ceil(OUT / C) outputs of every
// FC, with their weights, LIF parameters and membranes in its shared
// memory.  Every layer has its own input buffer in every CTA, one copy per
// timestep parity.  A layer's (pooled) output spikes are written into the
// next layer's input copy in every CTA of the cluster with st.async
// (distributed shared memory), each counted against the receiving CTA's
// mbarrier, which the receiver waits on (see push and wait_input): no
// cluster-wide barrier between layers.  The last FC feeds the readout of
// its own CTA and pushes nothing.  A final cluster barrier keeps every CTA
// alive until CTA 0 has read the others' counters.
//
// Conv currents: a warp owns one channel x 32*P output positions (lane l
// takes positions l, l + 32, ...), so the warp shares the channel's weight
// list, read as broadcasts, and each lane keeps P independent chains.  The
// list holds the channel's nonzero weights only, in ascending shift-buffer
// row r = ci*IC + ic (the GOAP schedule of the fixed kernel), each with the
// offset into the zero-padded input rows at which position 0 reads; the
// shift buffer X' is never built.  FC currents: a thread owns an output and
// walks the compacted list of active inputs (the weight-mask fetch FM = IFM
// AND WM of paper section III-B) over the CTA's weight slice: rows held in
// shared memory where the planner finds room (kernels/stream_fused.py);
// past them, each timestep's active rows are copied into a staging area
// while the resident rows are walked, and any beyond it read from L2.
//
// Exactness.  Every current is a sequential sum in ascending r (convs) or
// ascending input index (FCs), as in the plain version
// (stream_fused_forward_ref), so the two agree bit for bit on the card.
// Inside the network every value a layer reads is a spike, 0 or 1 (Σ-Δ
// bits, LIF spikes, max-pools of spikes).  For x in {0, 1} and finite w,
// fmaf(w, x, acc) rounds acc + w*x once, and w*x is exact, so it equals
// __fadd_rn(acc, __fmul_rn(w, x)).  A skipped term (w = 0, or x = 0 in an
// FC) would add w*x = +-0, and an accumulator that starts at +0 is never -0
// (a round-to-nearest sum is -0 only when both addends are), so skipping
// changes no bit.  So a branch-free FFMA over the nonzero weights gives the
// plain version's bits.  The weights are checked finite once, on the host.
// The one place a non-binary value can enter is the first layer's input with
// encode == 0: the CTA checks each frame (a block-wide OR) and, for a frame
// that is not all {0, 1}, walks the dense weight row with separate multiply
// and add, skipping only x == 0 (conv_dense), and sums each X'
// row for the counter in ascending position before truncating it, as the
// plain version does for such a frame.  The LIF and Σ-Δ updates keep their
// rounding intrinsics so that nvcc's FMA contraction cannot change them.
//
// Counters: the gated-accumulation counter sum_r counts[r] * rowsum(X'[r])
// is linear in a {0, 1} input, so it is sum_p x[p] * cmap[p] with a static
// per-input map (kernels/stream_fused.py::counter_map); each CTA sums a
// slice of the inputs with 32-bit shared atomics (a 64-bit one is a
// compare-and-swap loop), folds them into 64-bit counters once a timestep,
// and CTA 0 adds the C partial counters through distributed shared memory
// at the end.
//
// Bound: the f32 gated adds on the CUDA cores and the shared-memory loads
// that feed them (one input load per term); the bytes are one frame read
// per timestep and the weights.  What sets the pace at batch 64 is one
// sample's chain of dependent steps: 8 timesteps x 5 layers, each waiting
// for the exchange of the layer before, with the FC sums and the conv
// walks of a CTA's share of the channels on the way (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

// Layout of the int32 meta array (kept in sync with kernels/stream_fused.py).
constexpr int HDR = 32;
constexpr int OPW = 40;
enum { H_NOPS, H_T, H_IC, H_W, H_NCLS, H_NCONV, H_C, H_NIN, H_READOUT, H_SPK,
       H_IDX, H_MASK, H_LOGIT, H_ACCS, H_FRM, H_INTEG, H_YPREV };
enum { C_KIND, C_KW, C_IC, C_OC, C_W, C_POOL, C_PER, C_P, C_SIN, C_SNEXT, C_NKW,
       C_SHFL, C_SLIST, C_GLIST, C_NLIST, C_SRP, C_GRP, C_NRP, C_SCMAP, C_GCMAP,
       C_NCMAP, C_SLIF, C_GLIF, C_NLIF, C_SV, C_GCNT, C_GW, C_CIDX,
       C_MB, C_EXPB, C_INSZ, C_NMB, C_NSZ };
enum { F_KIND, F_DIN, F_DOUT, F_PER, F_DPAD, F_SIN, F_SNEXT, F_RROWS, F_SW, F_GW,
       F_SLIF, F_GLIF, F_NLIF, F_SV, F_LAST, F_MB, F_EXPB, F_INSZ, F_NMB, F_NSZ,
       F_SROWS, F_SSTG };

enum { OP_CONV = 0, OP_FC = 1 };

constexpr int MAX_THREADS = 512;

using repro::lds128;
using repro::lds32;
using repro::smem_addr;

__device__ __forceinline__ float lif_fire(float v, float cur, float alpha,
                                          float theta, float vth, float* s) {
    float va = __fadd_rn(__fmul_rn(alpha, v), cur);
    bool fire = va > vth;
    *s = fire ? 1.0f : 0.0f;
    return fire ? __fsub_rn(va, theta) : va;
}

// Cluster barrier with release/acquire at cluster scope: it orders the
// distributed shared-memory stores before it against the loads after it.
// ptxas makes the release a GPU-scope fence (MEMBAR.ALL.GPU) and the
// acquire an L1 invalidation (CCTL.IVALL), so the kernel keeps what it
// reads after a barrier in shared memory, not in L1.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copy this CTA's slice (n words, a multiple of 4) of a per-CTA operand
// into shared memory with 16-byte cp.async.
__device__ __forceinline__ void copy_slice(float* dst, const void* src, int n) {
    const float* s = static_cast<const float*>(src);
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
        repro::cp_async16(dst + i, s + i, 16);
}

// The exchange between layers.  A layer's input buffer in every CTA has
// one copy per timestep parity and one mbarrier per copy.  A producer
// writes each output into that copy in every CTA of the cluster with
// st.async, which counts its 4 bytes against the receiving CTA's mbarrier;
// the consumer arms its mbarrier with the bytes it expects and waits for
// the phase to complete.  No cluster-wide barrier is needed: a producer
// writes a copy again two timesteps later, and by then it has waited for
// outputs that its consumer made after reading that copy.

// Write v at byte address `local` (this CTA's copy) in every CTA of the
// cluster, counted against `mbar` (same offset) there.
__device__ __forceinline__ void push(unsigned local, unsigned mbar, float v, int C) {
#pragma unroll 1
    for (int r = 0; r < C; ++r) {
        unsigned ra, rm;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(local), "r"(r));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rm) : "r"(mbar), "r"(r));
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                     :: "r"(ra), "r"(__float_as_uint(v)), "r"(rm) : "memory");
    }
}

// Wait until this CTA's copy behind `mbar` holds `bytes` (thread 0 arms
// the phase; every thread waits).  A phase that never completes traps
// after about a second rather than hang the card.
__device__ __forceinline__ void wait_input(unsigned mbar, unsigned bytes, unsigned parity) {
    if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(mbar), "r"(bytes) : "memory");
    const long long start = clock64();
    unsigned done = 0;
    while (true) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
        if (done) break;
        if (clock64() - start > (1ll << 31)) __trap();
    }
}

// List entries k .. k+3 of a conv walk: weights and byte offsets.
struct Entries {
    float w[4];
    unsigned off[4];
};

__device__ __forceinline__ Entries load_entries(unsigned laddr, int k) {
    const float4 a = lds128(laddr + 8u * k);
    const float4 b = lds128(laddr + 8u * k + 16u);
    return {{a.x, a.z, b.x, b.z},
            {4u * __float_as_uint(a.y), 4u * __float_as_uint(a.w),
             4u * __float_as_uint(b.y), 4u * __float_as_uint(b.w)}};
}

// A conv current at position p over an input that is not all {0, 1}: the
// dense weight row in ascending r, multiply and add rounded separately,
// skipping x == 0 (kept out of line: frames of this kind are rare).
__device__ __noinline__ float conv_dense(const float* wrow, const float* x,
                                         int kw, int ic, int wp, int p) {
    float a = 0.0f;
#pragma unroll 1
    for (int ci = 0; ci < kw; ++ci)
#pragma unroll 1
        for (int icc = 0; icc < ic; ++icc) {
            const float xv = x[icc * wp + ci + p];
            if (xv != 0.0f) a = __fadd_rn(a, __fmul_rn(wrow[ci * ic + icc], xv));
        }
    return a;
}

// A shared-memory load at a constant byte offset from a 32-bit address
// (the offset folds into the instruction: no add per load).
template <int OFF>
__device__ __forceinline__ float lds32_at(unsigned addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(v) : "r"(addr), "n"(OFF));
    return v;
}

// The inputs of one list entry for a lane's P positions, 32 apart: a is
// the byte address of the first.
template <int P>
__device__ __forceinline__ void load_x(unsigned a, float* x) {
    x[0] = lds32_at<0>(a);
    if (P > 1) x[1] = lds32_at<128>(a);
    if (P > 2) x[2] = lds32_at<256>(a);
    if (P > 3) x[3] = lds32_at<384>(a);
}

// One warp task of a conv over {0, 1} input: P chains (output positions
// pos0 + 32j, xbase the byte address of position pos0 in input row 0) walk
// the channel's list entries [s, e), four a step, software-pipelined: the
// entries two steps ahead and the inputs one step ahead are loaded before
// this step's FFMAs (the list region ends with 8 zero entries for the
// read-ahead).  Positions past the width read past the row, into the
// buffer's slack; their sums are not used.
template <int P>
__device__ __forceinline__ void conv_walk(unsigned laddr, int s, int e,
                                          unsigned xbase, float* acc) {
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = 0.0f;
    Entries a = load_entries(laddr, s);
    Entries b = load_entries(laddr, s + 4);
    float xa[4][P];
#pragma unroll
    for (int m = 0; m < 4; ++m) load_x<P>(xbase + a.off[m], xa[m]);
#pragma unroll 2
    for (int k = s; k < e; k += 4) {
        const Entries c = load_entries(laddr, k + 8);
        float xb[4][P];
#pragma unroll
        for (int m = 0; m < 4; ++m) load_x<P>(xbase + b.off[m], xb[m]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int j = 0; j < P; ++j) acc[j] = fmaf(a.w[m], xa[m][j], acc[j]);
        a = b;
        b = c;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int j = 0; j < P; ++j) xa[m][j] = xb[m][j];
    }
}

__device__ __forceinline__ float load_w(unsigned waddr, int i, int dpad) {
    return lds32(waddr + 4u * static_cast<unsigned>(i * dpad));
}

struct Idx8 {
    int i[8];
};

__device__ __forceinline__ Idx8 load_idx(unsigned iaddr, int j) {
    const float4 a = lds128(iaddr + 4u * j);
    const float4 b = lds128(iaddr + 4u * j + 16u);
    return {{__float_as_int(a.x), __float_as_int(a.y), __float_as_int(a.z),
             __float_as_int(a.w), __float_as_int(b.x), __float_as_int(b.y),
             __float_as_int(b.z), __float_as_int(b.w)}};
}

// An FC output's current over the n_on active inputs idx[0..n_on) of a
// {0, 1} input, all below the resident rows: waddr is the shared address of
// the output's column of the CTA's resident weight rows (row stride dpad).
// Eight inputs a step, software-pipelined like conv_walk; the read-ahead
// past n_on reads indices clamped to rmax, the last resident row.
__device__ __forceinline__ float fc_walk(unsigned waddr, unsigned iaddr,
                                         int n_on, int dpad, int rmax) {
    const int groups = n_on / 8;
    float acc = 0.0f;
    Idx8 b = load_idx(iaddr, 8);
    float wa[8];
    {
        const Idx8 a = load_idx(iaddr, 0);
#pragma unroll
        for (int m = 0; m < 8; ++m) wa[m] = load_w(waddr, min(a.i[m], rmax), dpad);
    }
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
        const Idx8 c = load_idx(iaddr, 8 * g + 16);
        float wb[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) wb[m] = load_w(waddr, min(b.i[m], rmax), dpad);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc = __fadd_rn(acc, wa[m]);
        b = c;
#pragma unroll
        for (int m = 0; m < 8; ++m) wa[m] = wb[m];
    }
    for (int j = 8 * groups; j < n_on; ++j)
        acc = __fadd_rn(acc, load_w(waddr, __float_as_int(lds32(iaddr + 4u * j)), dpad));
    return acc;
}

// Continue an FC output's sum over n staged weight rows (row stride dpad
// words from byte address a, this output's column), eight loads ahead.
__device__ __forceinline__ float stage_walk(unsigned a, int n, int dpad, float acc) {
    const unsigned step = 4u * static_cast<unsigned>(dpad);
    int j = 0;
#pragma unroll 2
    for (; j + 8 <= n; j += 8) {
        float w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = lds32(a + step * (j + m));
#pragma unroll
        for (int m = 0; m < 8; ++m) acc = __fadd_rn(acc, w[m]);
    }
#pragma unroll 1
    for (; j < n; ++j) acc = __fadd_rn(acc, lds32(a + step * j));
    return acc;
}

// Continue an FC output's sum over n active inputs whose weight rows stay
// in global memory (L2), from the index at iaddr (any 4-byte boundary):
// the weights of the next two groups of eight in flight while a group is
// added (the index region holds 32 zeros past the last active input).
__device__ __noinline__ float fc_walk_global(const float* wcol, unsigned iaddr,
                                             int n, int dpad, float acc) {
    auto load8 = [&](const Idx8& ix, float* w) {
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = __ldg(wcol + static_cast<size_t>(ix.i[m]) * dpad);
    };
    auto idx8 = [&](int j) {
        Idx8 ix;
#pragma unroll
        for (int m = 0; m < 8; ++m) ix.i[m] = __float_as_int(lds32(iaddr + 4u * (j + m)));
        return ix;
    };
    float w0[8], w1[8];
    load8(idx8(0), w0);
    load8(idx8(8), w1);
    Idx8 i2 = idx8(16);
    const int groups = n / 8;
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
        const Idx8 i3 = idx8(8 * g + 24);
        float w2[8];
        load8(i2, w2);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc = __fadd_rn(acc, w0[m]);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            w0[m] = w1[m];
            w1[m] = w2[m];
        }
        i2 = i3;
    }
#pragma unroll 1
    for (int j = 8 * groups; j < n; ++j)
        acc = __fadd_rn(acc, __ldg(wcol + static_cast<size_t>(__float_as_int(lds32(iaddr + 4u * j))) * dpad));
    return acc;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
stream_fused_kernel(const int* __restrict__ gmeta,
                    const float* __restrict__ fp,
                    const int* __restrict__ ip,
                    const float* __restrict__ frames,
                    float* __restrict__ logits_out,
                    float* __restrict__ accs_out,
                    int encode) {
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x;
    // The meta array heads shared memory: a cluster barrier invalidates L1,
    // after which each layer's fields would come from L2.
    int* smeta = reinterpret_cast<int*>(sm);
    for (int i = tid; i < HDR + OPW * gmeta[H_NOPS]; i += blockDim.x) smeta[i] = gmeta[i];
    __syncthreads();
    const int* meta = smeta;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;

    const int C = meta[H_C];
    const int q = static_cast<int>(cluster.block_rank());
    const int b = blockIdx.x / C;
    const int n_ops = meta[H_NOPS];
    const int T = meta[H_T];
    const int in_ic = meta[H_IC];
    const int in_w = meta[H_W];
    const int n_in = meta[H_NIN];
    const int n_conv = meta[H_NCONV];
    float* spk = sm + meta[H_SPK];
    int* idx = reinterpret_cast<int*>(sm + meta[H_IDX]);
    unsigned* mask = reinterpret_cast<unsigned*>(sm + meta[H_MASK]);
    float* logit = sm + meta[H_LOGIT];
    unsigned long long* accs =
        reinterpret_cast<unsigned long long*>(sm + meta[H_ACCS]);
    // this timestep's counters: 32-bit shared atomics are native, 64-bit
    // ones a compare-and-swap loop; folded into accs once a timestep
    int* cnt32 = reinterpret_cast<int*>(accs + n_conv);
    float* frm = sm + meta[H_FRM];
    float* integ = sm + meta[H_INTEG];
    float* yprev = sm + meta[H_YPREV];
    const int* first = meta + HDR;
    const int* last = meta + HDR + (n_ops - 1) * OPW;
    const int n_logit = max(0, min(last[F_PER], last[F_DOUT] - q * last[F_PER]));

    // ---- prologue: by cp.async, the frames and the first layer's operand
    //      slices (group 0), the other layers' (group 1, awaited at the
    //      second layer) and the resident FC weight rows (group 2, awaited
    //      at the first FC); every input buffer, membrane and accumulator
    //      zeroed --------------------------------------------------------
    {
        const int n = encode ? n_in : T * n_in;
        const float* src = frames + static_cast<size_t>(b) * n;
        if (n % 4 == 0) {
            copy_slice(frm, src, n);
        } else {
            for (int i = tid; i < n; i += blockDim.x) repro::cp_async4(frm + i, src + i, 4);
        }
    }
    for (int o = 0; o < n_ops; ++o) {
        const int* op = meta + HDR + o * OPW;
        if (o == 1) repro::cp_async_commit();
        if (op[C_KIND] == OP_CONV) {
            copy_slice(sm + op[C_SLIST], fp + op[C_GLIST] + static_cast<size_t>(q) * op[C_NLIST],
                       op[C_NLIST]);
            copy_slice(sm + op[C_SRP], ip + op[C_GRP] + q * op[C_NRP], op[C_NRP]);
            copy_slice(sm + op[C_SCMAP], ip + op[C_GCMAP] + q * op[C_NCMAP], op[C_NCMAP]);
            copy_slice(sm + op[C_SLIF], fp + op[C_GLIF] + q * op[C_NLIF], op[C_NLIF]);
            const int w = op[C_W], kw = op[C_KW];
            for (int i = tid; i < op[C_IC] * (w + kw - 1); i += blockDim.x) {
                sm[op[C_SIN] + i] = 0.0f;              // the zero padding
                sm[op[C_SIN] + op[C_INSZ] + i] = 0.0f;
            }
            for (int i = tid; i < op[C_PER] * w; i += blockDim.x) sm[op[C_SV] + i] = 0.0f;
        } else {
            copy_slice(sm + op[F_SLIF], fp + op[F_GLIF] + q * op[F_NLIF], op[F_NLIF]);
            for (int i = tid; i < op[F_DIN]; i += blockDim.x) sm[op[F_SIN] + i] = 0.0f;
            for (int i = tid; i < op[F_PER]; i += blockDim.x) sm[op[F_SV] + i] = 0.0f;
        }
    }
    if (n_ops == 1) repro::cp_async_commit();
    repro::cp_async_commit();
    for (int o = 0; o < n_ops; ++o) {
        const int* op = meta + HDR + o * OPW;
        if (op[F_KIND] == OP_FC && op[F_RROWS])
            copy_slice(sm + op[F_SW],
                       fp + op[F_GW] + static_cast<size_t>(q) * op[F_DIN] * op[F_DPAD],
                       op[F_RROWS] * op[F_DPAD]);
    }
    repro::cp_async_commit();
    for (int i = tid; i < n_logit; i += blockDim.x) logit[i] = 0.0f;
    for (int i = tid; i < n_conv; i += blockDim.x) {
        accs[i] = 0ull;
        cnt32[i] = 0;
    }
    for (int i = tid; i < n_in; i += blockDim.x) {
        integ[i] = 0.0f;
        yprev[i] = 0.0f;
    }
    if (tid == 0) {
        for (int o = 1; o < n_ops; ++o) {
            const int* op = meta + HDR + o * OPW;
            const unsigned mb = smem_addr(sm + op[op[C_KIND] == OP_CONV ? C_MB : F_MB]);
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(mb) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(mb + 8u) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    repro::cp_async_wait<2>();
    __syncthreads();
    cluster_sync();   // every CTA's mbarriers exist before anyone writes

    for (int t = 0; t < T; ++t) {
        const int par = t & 1;
        // ---- this timestep's frame into the first layer's input buffer ---
        int nonbinary = 0;
        {
            const bool conv0 = first[C_KIND] == OP_CONV;
            const int wp = conv0 ? in_w + first[C_KW] - 1 : in_w;
            const int left = conv0 ? (first[C_KW] - 1) / 2 : 0;
            float* x0 = sm + first[C_SIN];
            const float* src = frm + (encode ? 0 : t * n_in);
            for (int row = 0; row < in_ic; ++row)
            for (int col = tid; col < in_w; col += blockDim.x) {
                const int i = row * in_w + col;
                float v;
                if (encode) {
                    // first-order Σ-Δ: integ += x - y_prev; y = integ >= 0.5
                    const float u = __fsub_rn(__fadd_rn(integ[i], src[i]), yprev[i]);
                    v = u >= 0.5f ? 1.0f : 0.0f;
                    integ[i] = u;
                    yprev[i] = v;
                } else {
                    v = src[i];
                    nonbinary |= !repro::is_binary(v);
                }
                x0[row * wp + left + col] = v;
            }
        }
        bool binary = !__syncthreads_or(nonbinary);

        for (int o = 0; o < n_ops; ++o) {
            const int* op = meta + HDR + o * OPW;
            if (t == 0 && o == 1) {   // the other layers' operand slices
                repro::cp_async_wait<1>();
                __syncthreads();
            }
            if (op[C_KIND] == OP_CONV) {
                const int kw = op[C_KW], ic = op[C_IC], oc = op[C_OC];
                const int w = op[C_W], pool = op[C_POOL], per = op[C_PER];
                const int P = op[C_P];
                const int wp = w + kw - 1, left = (kw - 1) / 2;
                const int ch0 = q * per;
                const int n_own = max(0, min(per, oc - ch0));
                if (o > 0)
                    wait_input(smem_addr(sm + op[C_MB]) + 8u * par, op[C_EXPB], (t >> 1) & 1);
                const float* x = sm + op[C_SIN] + par * op[C_INSZ];
                // -- currents, LIF and pooled spikes of the owned channels --
                const int groups = (w + 32 * P - 1) / (32 * P);
                const int w2 = w / pool;
                const int nkw = op[C_NKW];
                const int wpn = nkw ? w2 + nkw - 1 : w2, leftn = nkw ? (nkw - 1) / 2 : 0;
                const bool shfl = op[C_SHFL] != 0;
                const int lg_pool = 31 - __clz(pool);   // shuffle pools are powers of 2
                const unsigned next = smem_addr(sm + op[C_SNEXT] + par * op[C_NSZ]);
                const unsigned next_mb = smem_addr(sm + op[C_NMB]) + 8u * par;
                const unsigned xaddr = smem_addr(x);
                const unsigned laddr = smem_addr(sm + op[C_SLIST]);
                const int* rp = reinterpret_cast<const int*>(sm + op[C_SRP]);
                const float* lif = sm + op[C_SLIF];
                float* v = sm + op[C_SV];
                for (int tk = warp; tk < n_own * groups; tk += nwarps) {
                    const int cl = tk / groups, ch = ch0 + cl;
                    const int pos0 = (tk - cl * groups) * 32 * P + lane;
                    float acc[4];
                    if (binary) {
                        const unsigned xb = xaddr + 4u * pos0;
                        if (P == 4) conv_walk<4>(laddr, rp[cl], rp[cl + 1], xb, acc);
                        else if (P == 2) conv_walk<2>(laddr, rp[cl], rp[cl + 1], xb, acc);
                        else conv_walk<1>(laddr, rp[cl], rp[cl + 1], xb, acc);
                    } else {
                        const float* wrow = fp + op[C_GW] + static_cast<size_t>(ch) * kw * ic;
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int p = pos0 + 32 * j;
                            acc[j] = j < P && p < w ? conv_dense(wrow, x, kw, ic, wp, p) : 0.0f;
                        }
                    }
                    const float alpha = lif[cl], theta = lif[per + cl], vth = lif[2 * per + cl];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (j >= P) break;
                        const int p = pos0 + 32 * j;
                        float s = 0.0f;
                        if (p < w) v[cl * w + p] = lif_fire(v[cl * w + p], acc[j], alpha, theta, vth, &s);
                        if (shfl) {   // max over the pool's neighbouring lanes
                            for (int d = 1; d < pool; d <<= 1)
                                s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, d));
                            const int jp = p >> lg_pool;
                            if ((p & (pool - 1)) == 0 && jp < w2)
                                push(next + 4u * (ch * wpn + leftn + jp), next_mb, s, C);
                        } else if (p < w) {
                            spk[cl * w + p] = s;
                        }
                    }
                }
                if (!shfl) {
                    __syncthreads();
                    for (int e = tid; e < n_own * w2; e += blockDim.x) {
                        const int cl = e / w2, j = e - cl * w2;
                        const float* sp = spk + cl * w + j * pool;
                        float m = sp[0];
#pragma unroll 1
                        for (int k = 1; k < pool; ++k) m = fmaxf(m, sp[k]);
                        push(next + 4u * ((ch0 + cl) * wpn + leftn + j), next_mb, m, C);
                    }
                }
                // -- this CTA's share of the gated-accumulation counter (after
                //    the walks, so that no warp waits for it to start) --
                long long local = 0;
                if (binary) {
                    const int n = ic * w, share = (n + C - 1) / C;
                    const int lo = q * share, hi = min(n, lo + share);
                    const int* cmap = reinterpret_cast<const int*>(sm + op[C_SCMAP]);
                    for (int e = lo + tid; e < hi; e += blockDim.x) {
                        const int row = e / w, p = e - row * w;
                        if (x[row * wp + left + p] != 0.0f) local += cmap[e - lo];
                    }
                } else {   // rows r = q, q + C, ...: X' row sums in ascending position
                    const int* counts = ip + op[C_GCNT];
                    for (int r = q + C * tid; r < kw * ic; r += C * blockDim.x) {
                        const int k = counts[r];
                        if (k == 0) continue;
                        const int ci = r / ic, icc = r - ci * ic;
                        float s = 0.0f;
#pragma unroll 1
                        for (int p = 0; p < w; ++p) s = __fadd_rn(s, x[icc * wp + ci + p]);
                        local += static_cast<long long>(k) * __float2ll_rz(s);
                    }
                }
#pragma unroll
                for (int d = 16; d > 0; d >>= 1)
                    local += __shfl_down_sync(0xffffffffu, local, d);
                if (lane == 0 && local) {
                    if (binary)   // a timestep's share fits in 32 bits
                        atomicAdd(&cnt32[op[C_CIDX]], static_cast<int>(local));
                    else
                        atomicAdd(&accs[op[C_CIDX]], static_cast<unsigned long long>(local));
                }
                // Nothing of this layer's is read by the next one but its
                // exchanged input: only the spike buffer of a general pool
                // needs every warp past its reads before it is reused.
                if (!shfl) __syncthreads();
            } else {
                const int din = op[F_DIN], dout = op[F_DOUT], per = op[F_PER];
                const int dpad = op[F_DPAD];
                const int o0 = q * per;
                const int n_own = max(0, min(per, dout - o0));
                if (o > 0)
                    wait_input(smem_addr(sm + op[F_MB]) + 8u * par, op[F_EXPB], (t >> 1) & 1);
                const float* x = sm + op[F_SIN] + par * op[F_INSZ];
                repro::cp_async_wait<0>();   // resident slices (first timestep)
                // -- compact the active inputs, in ascending order --------
                const int n_chunks = (din + 31) / 32;
                for (int ch = warp; ch < n_chunks; ch += nwarps) {
                    const int i = ch * 32 + lane;
                    const unsigned m = __ballot_sync(0xffffffffu, i < din && x[i] != 0.0f);
                    if (lane == 0) mask[ch] = m;
                }
                __syncthreads();
                // the active inputs below the resident rows (every warp)
                const int rrows = op[F_RROWS];
                int n_below = 0;
#pragma unroll 1
                for (int c = lane; c < (rrows >= din ? n_chunks : rrows / 32); c += 32)
                    n_below += __popc(mask[c]);
#pragma unroll
                for (int d = 16; d > 0; d >>= 1) n_below += __shfl_xor_sync(0xffffffffu, n_below, d);
                for (int ch = warp; ch < n_chunks; ch += nwarps) {
                    int base = 0;   // active inputs before chunk ch
#pragma unroll 1
                    for (int c = lane; c < ch; c += 32) base += __popc(mask[c]);
#pragma unroll
                    for (int d = 16; d > 0; d >>= 1)
                        base += __shfl_xor_sync(0xffffffffu, base, d);
                    const unsigned m = mask[ch];
                    if ((m >> lane) & 1u)
                        idx[base + __popc(m & ((1u << lane) - 1u))] = ch * 32 + lane;
                }
                if (warp == nwarps - 1) {   // the count, and 32 zeros for the read-ahead
                    int total = 0;
#pragma unroll 1
                    for (int c = lane; c < n_chunks; c += 32) total += __popc(mask[c]);
#pragma unroll
                    for (int d = 16; d > 0; d >>= 1)
                        total += __shfl_xor_sync(0xffffffffu, total, d);
                    idx[total + lane] = 0;
                    if (lane == 0) mask[n_chunks] = total;
                }
                __syncthreads();
                const int n_on = static_cast<int>(mask[n_chunks]);
                const int n_res = n_below;   // active inputs in resident rows
                const unsigned iaddr = smem_addr(idx);
                const float* lif = sm + op[F_SLIF];
                float* v = sm + op[F_SV];
                const unsigned next = op[F_LAST] ? 0u
                    : smem_addr(sm + op[F_SNEXT] + par * op[F_NSZ]);
                const unsigned next_mb = op[F_LAST] ? 0u : smem_addr(sm + op[F_NMB]) + 8u * par;
                // Weight rows past the resident ones: this timestep's active
                // ones (up to SROWS) are copied into the staging area by
                // every thread while the outputs' threads walk the resident
                // rows; any further ones are read from L2.
                const float* wq = fp + op[F_GW] + static_cast<size_t>(q) * din * dpad;
                const int n_st = binary && n_own > 0 ? min(n_on - n_res, op[F_SROWS]) : 0;
                float* stage = sm + op[F_SSTG];
                if (n_st > 0) {
                    const int pieces = dpad / 4;
                    for (int k = tid; k < n_st * pieces; k += blockDim.x) {
                        const int r = k / pieces, pc = k - r * pieces;
                        repro::cp_async16(stage + r * dpad + 4 * pc,
                                          wq + static_cast<size_t>(idx[n_res + r]) * dpad + 4 * pc, 16);
                    }
                    repro::cp_async_commit();
                }
                for (int base = 0; base < n_own; base += blockDim.x) {   // same trip count for all
                    const int oo = base + tid;
                    const bool mine = oo < n_own;
                    float acc = 0.0f;
                    if (binary) {
                        if (mine && n_res)
                            acc = fc_walk(smem_addr(sm + op[F_SW] + oo), iaddr, n_res, dpad, rrows - 1);
                        if (base == 0 && n_st > 0) {
                            repro::cp_async_wait<0>();
                            __syncthreads();
                        }
                        if (mine) {
                            acc = stage_walk(smem_addr(stage + oo), n_st, dpad, acc);
                            if (n_res + n_st < n_on)
                                acc = fc_walk_global(wq + oo, iaddr + 4u * (n_res + n_st),
                                                     n_on - n_res - n_st, dpad, acc);
                        }
                    } else if (mine) {
#pragma unroll 1
                        for (int j = 0; j < n_on; ++j) {
                            const int i = idx[j];
                            const float w = i < rrows ? sm[op[F_SW] + i * dpad + oo]
                                                      : wq[static_cast<size_t>(i) * dpad + oo];
                            acc = __fadd_rn(acc, __fmul_rn(x[i], w));
                        }
                    }
                    if (!mine) continue;
                    float s;
                    v[oo] = lif_fire(v[oo], acc, lif[oo], lif[per + oo], lif[2 * per + oo], &s);
                    if (op[F_LAST])
                        logit[oo] = __fadd_rn(logit[oo], meta[H_READOUT] == 0 ? acc : s);
                    else
                        push(next + 4u * (o0 + oo), next_mb, s, C);
                }
                __syncthreads();
            }
            binary = true;   // every later input is spikes
        }
        __syncthreads();   // the first input buffer and FC lists are free again
        for (int i = tid; i < n_conv; i += blockDim.x) {
            accs[i] += static_cast<unsigned long long>(static_cast<long long>(cnt32[i]));
            cnt32[i] = 0;
        }
    }

    // ---- outputs: every CTA its logits, CTA 0 the summed counters ----------
    cluster_sync();
    for (int i = tid; i < n_logit; i += blockDim.x)
        logits_out[static_cast<size_t>(b) * meta[H_NCLS] + q * last[F_PER] + i] = logit[i];
    if (q == 0) {
        for (int i = tid; i < n_conv; i += blockDim.x) {
            long long s = 0;
#pragma unroll 1
            for (int r = 0; r < C; ++r)
                s += static_cast<long long>(cluster.map_shared_rank(accs, r)[i]);
            accs_out[static_cast<size_t>(b) * n_conv + i] = __ll2float_rn(s);
        }
    }
    cluster_sync();   // CTA 0 has read every CTA's counters
}

cudaLaunchConfig_t launch_config(int batch, int cluster, int threads,
                                 int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" int stream_fused_forward_f32(const int* meta, const float* fp,
                                        const int* ip, const float* frames,
                                        float* logits, float* accs, int batch,
                                        int encode, int cluster, int threads,
                                        int smem_bytes, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(
        batch, cluster, threads, smem_bytes, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, stream_fused_kernel, meta, fp, ip, frames,
                             logits, accs, encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Clusters of this shape the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int stream_fused_max_active_clusters(int cluster, int threads,
                                                int smem_bytes, int* out) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config(1, cluster, threads, smem_bytes, nullptr, attr);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(out, stream_fused_kernel, &cfg));
}
