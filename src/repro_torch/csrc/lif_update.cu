// LIF neuron update over T with the membrane resident in a register.
//
// Replaces the Pallas kernel repro/kernels/lif_update.py::lif_update_fused
// (grid (neuron-tiles, T), membrane in VMEM scratch across T).  Device
// memory sees one read of each current and one write of each spike and of
// each final membrane; the state never leaves the register.  Neurons past
// N are masked by the bounds check, so no padded neuron (and no v_th = +inf
// trick) is needed.
//
// Operands.  The Pallas kernel takes (N,) vectors for alpha, theta, v_th
// and v0, because its BlockSpecs cut them like the currents.  Here the
// three parameters are (C,) vectors read per channel: neuron i reads
// channel (i / inner) % C (an FC layer: C = OUT, inner = 1; a conv layer:
// C = OC, inner = W; the (N,) form is C = N, inner = 1), and a null v0
// starts the membrane at zero.  So a caller builds no vector on the card.
//
// Bound: bytes (a fused elementwise pass, nothing for tensor cores).
// Rounding: v = __fadd_rn(__fmul_rn(alpha, v), cur); strict > on v_th;
// soft reset by __fsub_rn — the same roundings as eager torch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_THREADS = 256;

// x / d for 0 <= x < 2^31 by one multiply-high and a shift (d >= 1; the
// round-up method of Granlund and Montgomery, as CUTLASS's FastDivmod):
// the channel of a neuron without an integer division on the card.
struct FastDiv {
    uint32_t d, mul, shr;
};

FastDiv fast_div(uint32_t d) {
    FastDiv f{d, 0, 0};
    if (d > 1) {
        uint32_t l = 0;
        while ((1ull << l) < d) ++l;   // ceil(log2 d)
        const uint32_t p = 31 + l;
        f.mul = static_cast<uint32_t>(((1ull << p) + d - 1) / d);
        f.shr = p - 32;
    }
    return f;
}

__device__ __forceinline__ int fast_quot(int x, FastDiv f) {
    return f.d == 1 ? x : static_cast<int>(__umulhi(static_cast<uint32_t>(x), f.mul) >> f.shr);
}

// neuron i's channel (i / inner) % C
__device__ __forceinline__ int channel(int i, FastDiv inner, FastDiv C) {
    const int q = fast_quot(i, inner);
    return q - fast_quot(q, C) * static_cast<int>(C.d);
}

__global__ void __launch_bounds__(THREADS)
lif_update_kernel(const float* __restrict__ cur, const float* __restrict__ v0,
                  const float* __restrict__ alpha, const float* __restrict__ theta,
                  const float* __restrict__ vth, float* __restrict__ spikes,
                  float* __restrict__ vfin, int T, int n, FastDiv inner, FastDiv C) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int c = channel(i, inner, C);
    const float a = __ldg(alpha + c), th = __ldg(theta + c), vt = __ldg(vth + c);
    float v = v0 != nullptr ? v0[i] : 0.0f;
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
                                    int T, int n, int C, int inner, void* stream) {
    if (C < 1 || inner < 1 || n % (static_cast<long long>(C) * inner) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (n + THREADS - 1) / THREADS;
    lif_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        cur, v0, alpha, theta, vth, spikes, vfin, T, n, fast_div(inner), fast_div(C));
    return static_cast<int>(cudaGetLastError());
}

// bf16 form: the state lives in the currents' dtype, as the reference's
// scratch does, and every operation rounds to bf16 as the reference's
// kernel body does in interpret mode (each op of `v * alpha + I_t` and of
// `v - theta * s` rounded on its own; tests/test_torch_bf16.py holds the
// plain version to it bit for bit): v = bf(bf(v * a) + I), s = v > v_th
// (strict), v = bf(v - theta * s).  Here each op is one bf16x2 instruction
// on two neurons, rounding once, and that is the same function:
//   * mul.rn.bf16x2: the product of two bf16 values is exact in f32, so
//     its one rounding to bf16 is the reference's;
//   * add.rn.bf16x2: the exact sum rounded once to bf16 equals the f32 sum
//     rounded to bf16 (f32 keeps 24 >= 2 x 8 + 2 bits, so the second
//     rounding of the reference's f32-then-bf16 add cannot differ:
//     Figueroa's double-rounding bound; csrc/mma_bf16.cuh uses the same);
//   * set.gt.bf16x2 gives the spike itself, bf16 1.0 or 0.0 per neuron;
//   * fma.rn.bf16x2(-theta, s, v): theta * s is exact (theta or a zero of
//     theta's sign), so this is the reference's v - theta * s with its one
//     rounding; a neuron that does not fire keeps v (and the sign the
//     reference gives a zero there).
//
// Design for the H100.  At the paper model's shapes (T 8 x N 8,192 and T 8
// x N 704 a batch of 64) the bytes take a tenth of a microsecond: a launch
// is its fixed cost plus one chain of memory round trips and the scan.  So:
//   * a thread owns K adjacent neurons (1, 2, 4 or 8: 2 to 16 bytes a
//     load, as N and the operands' alignment allow) and issues the loads of
//     all its TT x K currents, its parameters and v0 before the scan, so
//     they are in flight together and the thread waits out one round trip,
//     not T of them.  TT (1, 2, 4, 8 or 16) is a template parameter; a
//     longer T walks chunks of TT, the last one masked (TAIL);
//   * the parameters are read per channel through the read-only path (L1
//     serves the threads of a block that share a channel; staging them in
//     shared memory measured no faster); the channel comes from two
//     multiply-high divisions (FastDiv), not integer ones;
//   * the scan runs in registers on bf16x2 pairs, four instructions a
//     pair and timestep; the spikes leave as K-wide vector stores, the
//     final membrane once.
// kernels/lif_update.py::plan_lif_bf16_launch picks K, TT and the threads a
// block.
namespace {

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t gt_bf16x2(uint32_t a, uint32_t b) {   // 1.0 or 0.0
    uint32_t d;
    asm("set.gt.bf16x2.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// K bf16 values as W 32-bit words of bf16x2 (neuron 2j in the low half of
// word j); K = 1 keeps its value in the low half of one word
template <int K>
struct Vec {
    static constexpr int W = K >= 2 ? K / 2 : 1;
    uint32_t w[W];
};

template <int K>
__device__ __forceinline__ Vec<K> load(const uint16_t* p) {
    Vec<K> v;
    if constexpr (K == 1) {
        v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else if constexpr (K == 2) {
        v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (K == 4) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
        v.w[0] = q.x; v.w[1] = q.y;
    } else {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        v.w[0] = q.x; v.w[1] = q.y; v.w[2] = q.z; v.w[3] = q.w;
    }
    return v;
}

template <int K>
__device__ __forceinline__ void store(uint16_t* p, const Vec<K>& v) {
    if constexpr (K == 1) {
        *p = static_cast<uint16_t>(v.w[0]);
    } else if constexpr (K == 2) {
        *reinterpret_cast<unsigned int*>(p) = v.w[0];
    } else if constexpr (K == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    }
}

struct LifBf16Args {
    const uint16_t* cur;
    const uint16_t* v0;       // null: the membrane starts at zero
    const uint16_t* alpha;    // (C,)
    const uint16_t* theta;
    const uint16_t* vth;
    uint16_t* spikes;
    uint16_t* vfin;
    int T, n;
    FastDiv inner, C;
};

template <int TT, int K, bool TAIL>
__device__ __forceinline__ void load_chunk(Vec<K> (&w)[TT], const uint16_t* __restrict__ cur,
                                           int t0, int T, int n, int i0) {
#pragma unroll
    for (int t = 0; t < TT; ++t)
        if (!TAIL || t0 + t < T) w[t] = load<K>(cur + (size_t)(t0 + t) * n + i0);
}

template <int TT, int K, bool TAIL>
__global__ void __launch_bounds__(MAX_THREADS) lif_bf16_kernel(const LifBf16Args p) {
    constexpr int W = Vec<K>::W;
    const uint16_t* __restrict__ cur = p.cur;
    const unsigned short* __restrict__ alpha = reinterpret_cast<const unsigned short*>(p.alpha);
    const unsigned short* __restrict__ theta = reinterpret_cast<const unsigned short*>(p.theta);
    const unsigned short* __restrict__ vth = reinterpret_cast<const unsigned short*>(p.vth);
    const int T = p.T, n = p.n, C = static_cast<int>(p.C.d), inner = static_cast<int>(p.inner.d);
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n / K) return;
    const int i0 = g * K;

    // 1. every current of the first chunk, the parameters and v0 in flight
    //    before any of them is used
    Vec<K> w[TT];
    load_chunk<TT, K, TAIL>(w, cur, 0, T, n, i0);
    uint32_t pa[K], pt[K], pv[K];
    {
        const int q = fast_quot(i0, p.inner);
        int c = q - fast_quot(q, p.C) * C, r = i0 - q * inner;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            pa[j] = __ldg(alpha + c); pt[j] = __ldg(theta + c); pv[j] = __ldg(vth + c);
            if (++r == inner) {
                r = 0;
                if (++c == C) c = 0;
            }
        }
    }
    Vec<K> v;
    if (p.v0 != nullptr) v = load<K>(p.v0 + i0);
    else {
#pragma unroll
        for (int k = 0; k < W; ++k) v.w[k] = 0u;
    }
    // the parameters as bf16x2 pairs, theta negated for the fma
    uint32_t a2[W], nth2[W], vt2[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        if constexpr (K == 1) {
            a2[k] = pa[0];
            nth2[k] = pt[0] ^ 0x8000u;
            vt2[k] = pv[0];
        } else {
            a2[k] = pa[2 * k] | (pa[2 * k + 1] << 16);
            nth2[k] = (pt[2 * k] | (pt[2 * k + 1] << 16)) ^ 0x80008000u;
            vt2[k] = pv[2 * k] | (pv[2 * k + 1] << 16);
        }
    }

    // 2. the scan in registers, chunk by chunk; spikes as K-wide stores
    for (int t0 = 0; t0 < T; t0 += TT) {
        if (t0 > 0) load_chunk<TT, K, TAIL>(w, cur, t0, T, n, i0);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            if (TAIL && t0 + t >= T) break;
            Vec<K> s;
#pragma unroll
            for (int k = 0; k < W; ++k) {
                v.w[k] = add_bf16x2(mul_bf16x2(v.w[k], a2[k]), w[t].w[k]);
                s.w[k] = gt_bf16x2(v.w[k], vt2[k]);
                v.w[k] = fma_bf16x2(nth2[k], s.w[k], v.w[k]);
            }
            store<K>(p.spikes + (size_t)(t0 + t) * n + i0, s);
        }
    }
    store<K>(p.vfin + i0, v);
}

using LifBf16Kernel = void (*)(LifBf16Args);

template <int TT, int K>
LifBf16Kernel pick_tail(bool tail) {
    return tail ? lif_bf16_kernel<TT, K, true> : lif_bf16_kernel<TT, K, false>;
}

template <int TT>
LifBf16Kernel pick_k(int k, bool tail) {
    switch (k) {
        case 1: return pick_tail<TT, 1>(tail);
        case 2: return pick_tail<TT, 2>(tail);
        case 4: return pick_tail<TT, 4>(tail);
        case 8: return pick_tail<TT, 8>(tail);
    }
    return nullptr;
}

LifBf16Kernel pick(int t_tile, int k, bool tail) {
    switch (t_tile) {
        case 1: return pick_k<1>(k, tail);
        case 2: return pick_k<2>(k, tail);
        case 4: return pick_k<4>(k, tail);
        case 8: return pick_k<8>(k, tail);
        case 16: return pick_k<16>(k, tail);
    }
    return nullptr;
}

}  // namespace

// k neurons a thread, t_tile currents of each loaded before the scan,
// `threads` a block (the plan of kernels/lif_update.py::
// plan_lif_bf16_launch).  Returns cudaErrorInvalidValue for a plan the
// kernel cannot run: k not dividing n, a tile or block size it has no
// instance for.
extern "C" int lif_update_fused_bf16(const uint16_t* cur, const uint16_t* v0,
                                     const uint16_t* alpha, const uint16_t* theta,
                                     const uint16_t* vth, uint16_t* spikes,
                                     uint16_t* vfin, int T, int n, int C, int inner,
                                     int k, int t_tile, int threads, void* stream) {
    // T = 0 takes the masked instance: no current is read, v_fin = v0
    const LifBf16Kernel kernel = pick(t_tile, k, T == 0 || T % t_tile != 0);
    if (kernel == nullptr || T < 0 || C < 1 || inner < 1 ||
        n % (static_cast<long long>(C) * inner) != 0 || n % k != 0 ||
        threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const LifBf16Args args{cur, v0, alpha, theta, vth, spikes, vfin, T, n,
                           fast_div(inner), fast_div(C)};
    const int groups = n / k;
    const int grid = (groups + threads - 1) / threads;
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(args);
    return static_cast<int>(cudaGetLastError());
}
