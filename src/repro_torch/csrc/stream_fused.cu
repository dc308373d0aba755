// Whole-network streaming SNN forward: one launch, one block per sample.
//
// Replaces the Pallas kernel repro/kernels/stream_fused.py::stream_fused_forward
// (grid (batch, T) with T minor and every layer's state in VMEM scratch).
// Hopper runs blocks in parallel and in no order, so the sequential T grid
// axis becomes a loop inside the block, and each block carries one sample's
// state through all T timesteps.
//
// Resident in shared memory for the whole launch: every conv weight matrix
// (ci-major, (OC, KW*IC)), every conv and FC membrane, two ping-pong spike
// buffers, the FC current of the readout, the logit and counter
// accumulators and, with encode != 0, the Σ-Δ integrator state.  FC weights
// stay in global memory (FC1 of the paper model is 512 KB, more than a
// block's 227 KB): each FC first compacts its active input spikes into an
// index list (the weight-mask fetch FM = IFM AND WM of paper §III-B), and
// then fetches only the weight rows of active inputs, coalesced across the
// block's output neurons; the rows stay L2-resident across blocks.
//
// The shift buffer X' is never built: the conv indexes the padded input in
// place, and the gated-accumulation counter Σ_r counts[r] * rowsum(X'[r])
// uses a windowed count of the input row, accumulated in int32.
//
// Bound: f32 adds on the CUDA cores (binary inputs make every product a
// gated add); the bytes are one frame read per timestep and the weights.
// The design keeps all state on chip; making it fast (more samples per
// block, tensor cores, TMA) is later work.
//
// Rounding: every current is a sequential sum in ascending shift-buffer row
// order (r = ci*IC + ic for convs, input index for FCs), products and sums
// rounded separately (__fmul_rn/__fadd_rn), and the LIF and Σ-Δ updates are
// written the same way.  Skipped terms are exact zeros.  The plain PyTorch
// version in repro_torch/kernels/stream_fused.py adds in the same order, so
// the two agree bit for bit on the card.
#include <cuda_runtime.h>

namespace {

// Layout of the int32 meta array (kept in sync with kernels/stream_fused.py).
constexpr int HDR = 32;
constexpr int OPW = 16;
enum { H_NOPS, H_T, H_IC, H_W, H_NCLS, H_NCONV, H_ACTA, H_ACTB, H_CUR,
       H_LOGIT, H_INTEG, H_YPREV, H_XIN, H_IDX, H_CHUNK, H_ACCS };
enum { OP_CONV = 0, OP_POOL = 1, OP_FC = 2, OP_READOUT = 3 };
enum { O_KIND, O_A, O_B, O_C, O_D, O_PW, O_PLIF, O_PCNT, O_SW, O_SV,
       O_CIDX };

constexpr int THREADS = 256;

__device__ __forceinline__ float lif_fire(float v, float cur, float alpha,
                                          float theta, float vth, float* s) {
    float va = __fadd_rn(__fmul_rn(alpha, v), cur);
    bool fire = va > vth;
    *s = fire ? 1.0f : 0.0f;
    return fire ? __fsub_rn(va, theta) : va;
}

__global__ void __launch_bounds__(THREADS)
stream_fused_kernel(const int* __restrict__ meta,
                    const float* __restrict__ params,
                    const int* __restrict__ counts,
                    const float* __restrict__ frames,
                    float* __restrict__ logits_out,
                    float* __restrict__ accs_out,
                    int encode) {
    extern __shared__ float sm[];
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;

    const int n_ops = meta[H_NOPS];
    const int T = meta[H_T];
    const int in_ic = meta[H_IC];
    const int in_w = meta[H_W];
    const int n_cls = meta[H_NCLS];
    const int n_conv = meta[H_NCONV];
    const int n_in = in_ic * in_w;
    float* logit = sm + meta[H_LOGIT];
    float* cur_buf = sm + meta[H_CUR];
    int* idx = reinterpret_cast<int*>(sm + meta[H_IDX]);
    int* chunk = reinterpret_cast<int*>(sm + meta[H_CHUNK]);
    int* accs = reinterpret_cast<int*>(sm + meta[H_ACCS]);

    // ---- load resident weights, zero every state --------------------------
    for (int o = 0; o < n_ops; ++o) {
        const int* op = meta + HDR + o * OPW;
        if (op[O_KIND] == OP_CONV) {
            const int n = op[O_C] * op[O_A] * op[O_B];
            for (int i = tid; i < n; i += blockDim.x)
                sm[op[O_SW] + i] = params[op[O_PW] + i];
            for (int i = tid; i < op[O_C] * op[O_D]; i += blockDim.x)
                sm[op[O_SV] + i] = 0.0f;
        } else if (op[O_KIND] == OP_FC) {
            for (int i = tid; i < op[O_B]; i += blockDim.x)
                sm[op[O_SV] + i] = 0.0f;
        }
    }
    for (int i = tid; i < n_cls; i += blockDim.x) logit[i] = 0.0f;
    for (int i = tid; i < n_conv; i += blockDim.x) accs[i] = 0;
    if (encode) {
        const float* src = frames + (size_t)b * n_in;
        for (int i = tid; i < n_in; i += blockDim.x) {
            sm[meta[H_INTEG] + i] = 0.0f;
            sm[meta[H_YPREV] + i] = 0.0f;
            sm[meta[H_XIN] + i] = src[i];
        }
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        float* x = sm + meta[H_ACTA];
        float* y = sm + meta[H_ACTB];
        // ---- this timestep's input frame ----------------------------------
        if (encode) {
            // first-order Σ-Δ: integ += x - y_prev; y = integ >= 0.5
            float* integ = sm + meta[H_INTEG];
            float* yprev = sm + meta[H_YPREV];
            const float* xin = sm + meta[H_XIN];
            for (int i = tid; i < n_in; i += blockDim.x) {
                float v = __fsub_rn(__fadd_rn(integ[i], xin[i]), yprev[i]);
                float s = v >= 0.5f ? 1.0f : 0.0f;
                integ[i] = v;
                yprev[i] = s;
                x[i] = s;
            }
        } else {
            const float* src = frames + ((size_t)b * T + t) * n_in;
            for (int i = tid; i < n_in; i += blockDim.x) x[i] = src[i];
        }
        __syncthreads();

        int c = in_ic, w = in_w;
        for (int o = 0; o < n_ops; ++o) {
            const int* op = meta + HDR + o * OPW;
            const int kind = op[O_KIND];
            if (kind == OP_CONV) {
                const int kw = op[O_A], ic = op[O_B], oc = op[O_C];
                const int K = kw * ic, left = (kw - 1) / 2;
                const float* wsm = sm + op[O_SW];
                float* v = sm + op[O_SV];
                const float* lif = params + op[O_PLIF];
                const int* cnt = counts + op[O_PCNT];
                // gated-accumulation counter: counts[r] * rowsum(X'[r])
                int local = 0;
                for (int r = tid; r < K; r += blockDim.x) {
                    const int k = cnt[r];
                    if (k == 0) continue;
                    const int ci = r / ic, icc = r % ic;
                    const int lo = max(0, ci - left);
                    const int hi = min(w, w + ci - left);
                    int n = 0;
                    for (int p = lo; p < hi; ++p) n += x[icc * w + p] != 0.0f;
                    local += k * n;
                }
                if (local) atomicAdd(&accs[op[O_CIDX]], local);
                // currents in ascending r = ci*IC + ic, then LIF
                for (int e = tid; e < oc * w; e += blockDim.x) {
                    const int ch = e / w, pos = e % w;
                    const float* wrow = wsm + ch * K;
                    float acc = 0.0f;
                    for (int ci = 0; ci < kw; ++ci) {
                        const int p = pos + ci - left;
                        if (p < 0 || p >= w) continue;
                        for (int icc = 0; icc < ic; ++icc) {
                            const float xv = x[icc * w + p];
                            if (xv != 0.0f)
                                acc = __fadd_rn(acc, __fmul_rn(wrow[ci * ic + icc], xv));
                        }
                    }
                    float s;
                    v[e] = lif_fire(v[e], acc, lif[ch], lif[oc + ch],
                                    lif[2 * oc + ch], &s);
                    y[e] = s;
                }
                c = oc;
            } else if (kind == OP_POOL) {
                const int pool = op[O_A], w2 = w / pool;
                for (int e = tid; e < c * w2; e += blockDim.x) {
                    const int ch = e / w2, j = e % w2;
                    float m = x[ch * w + j * pool];
                    for (int p = 1; p < pool; ++p)
                        m = fmaxf(m, x[ch * w + j * pool + p]);
                    y[e] = m;
                }
                w = w2;
            } else if (kind == OP_FC) {
                const int din = op[O_A], dout = op[O_B];
                const float* wg = params + op[O_PW];
                const float* lif = params + op[O_PLIF];
                float* v = sm + op[O_SV];
                // compact the active inputs, in ascending order
                const int n_chunks = (din + 31) / 32;
                for (int ch = warp; ch < n_chunks; ch += nwarps) {
                    const int i = ch * 32 + lane;
                    const unsigned ball =
                        __ballot_sync(0xffffffffu, i < din && x[i] != 0.0f);
                    if (lane == 0) chunk[ch] = __popc(ball);
                }
                __syncthreads();
                if (tid == 0) {
                    int run = 0;
                    for (int ch = 0; ch < n_chunks; ++ch) {
                        const int n = chunk[ch];
                        chunk[ch] = run;
                        run += n;
                    }
                    chunk[n_chunks] = run;
                }
                __syncthreads();
                for (int ch = warp; ch < n_chunks; ch += nwarps) {
                    const int i = ch * 32 + lane;
                    const bool on = i < din && x[i] != 0.0f;
                    const unsigned ball = __ballot_sync(0xffffffffu, on);
                    if (on)
                        idx[chunk[ch] + __popc(ball & ((1u << lane) - 1u))] = i;
                }
                __syncthreads();
                const int n_on = chunk[n_chunks];
                for (int oo = tid; oo < dout; oo += blockDim.x) {
                    float acc = 0.0f;
                    for (int j = 0; j < n_on; ++j) {
                        const int i = idx[j];
                        acc = __fadd_rn(acc, __fmul_rn(x[i], wg[(size_t)i * dout + oo]));
                    }
                    float s;
                    v[oo] = lif_fire(v[oo], acc, lif[oo], lif[dout + oo],
                                     lif[2 * dout + oo], &s);
                    y[oo] = s;
                    cur_buf[oo] = acc;
                }
                c = dout;
                w = 1;
            } else {  // OP_READOUT
                const int mode = op[O_A], n = op[O_B];
                for (int i = tid; i < n; i += blockDim.x)
                    logit[i] = __fadd_rn(logit[i], mode == 0 ? cur_buf[i] : x[i]);
                __syncthreads();
                continue;  // the readout passes its input through
            }
            __syncthreads();
            float* tmp = x;
            x = y;
            y = tmp;
        }
    }
    __syncthreads();
    for (int i = tid; i < n_cls; i += blockDim.x)
        logits_out[(size_t)b * n_cls + i] = logit[i];
    for (int i = tid; i < n_conv; i += blockDim.x)
        accs_out[(size_t)b * n_conv + i] = static_cast<float>(accs[i]);
}

}  // namespace

extern "C" int stream_fused_forward_f32(const int* meta, const float* params,
                                        const int* counts, const float* frames,
                                        float* logits, float* accs, int batch,
                                        int encode, int smem_bytes,
                                        void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    stream_fused_kernel<<<batch, THREADS, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        meta, params, counts, frames, logits, accs, encode);
    return static_cast<int>(cudaGetLastError());
}
