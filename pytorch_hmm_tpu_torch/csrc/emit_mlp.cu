// Neural gaussian emission for every state, one read of the observations:
// the NeuralObservationModel trunk and gaussian head of one row tile,
//
//     h1  = relu(x W1 + b1);  h2 = relu(h1 W2 + b2)
//     mo  = h2 Wm + bm;       lvo = h2 Wlv + blv
//     u   = (x - mo) - center;         wo = exp(-lvo)
//     out[r, s] = (state_const[s] - D/2 log 2pi) - 1/2 sum_d lvo[r, d]
//                 - 1/2 max(u^2 wo . A_s - 2 u wo . B_s + wo . C_s, 0)
//
// with the per-state tables A = ws^T, B = (msc ws)^T, C = (msc^2 ws)^T
// (D, S) and center computed from the parameters outside the kernel.
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/emit_mlp.py:133
// fused_gaussian_emission (_emit_mlp_kernel, a 512-row VMEM tile padded
// to 128 lanes, head dots in a compensated bf16 "3x" mode for the MXU).
//
// What bounds it on an H100 at the NeuralHMM bench shape (R = B*T =
// 16,000 rows, D = 80, H = 256, S = 12): float32 operations,
// 2*R*(D*H + H*H + 2*H*D + 3*D*S) = 4.16 GFLOP, 0.062 ms at 67 TFLOP/s,
// against ~6.4 MB of observations, weights and scores, 0.0019 ms at
// 3.35 TB/s (estimates from the shapes).
//
// Design: one 256-thread block owns 64 rows. The observation tile and
// every activation (h1, h2, mo, lvo) live in dynamic shared memory,
// feature-major (act[f * LD + r]), so nothing of the trunk or the head
// goes to device memory: obs is read once and the (R, S) scores written
// once. Each layer is a tiled product in the block: a 64-row x 64-column
// output pass walks the depth in slices of 16, staging the weight slice
// (read through L2; all weights are ~0.5 MB) in shared memory, and each
// thread accumulates a 4 x 4 register tile with float32 FMAs. mo and lvo
// overwrite the dead h1 buffer. The three head products share one pass
// and its epilogue clamps and writes the scores. Feature dims are padded
// to 16 with zero rows, so any D and H work. True float32 throughout: no
// TF32, no tensor cores (3xTF32 or wgmma are later work); the TPU's bf16
// compensation has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;        // rows per block
constexpr int BN = 64;        // output columns per pass
constexpr int BK = 16;        // depth slice staged per step; feature pad
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = (BR / TM) * (BN / TN);   // 256
constexpr int LD = BR + 4;    // row stride of a feature-major activation
constexpr float LOG_2PI = 1.8378770664093453f;

__host__ __device__ constexpr int pad16(int x) { return (x + BK - 1) / BK * BK; }

// Shared floats of one block: x (Dp), h1 or mo+lvo (max(Hp, 2 Dp)), h2
// (Hp) feature-major, three staged table slices, the row norms.
__host__ __device__ constexpr long long smem_floats(int D, int H) {
    const int dp = pad16(D), hp = pad16(H);
    return static_cast<long long>(LD) * (dp + (hp > 2 * dp ? hp : 2 * dp) + hp)
           + 3 * BK * BN + BR;
}

__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const float4 a, const float4 w) {
    const float av[TM] = {a.x, a.y, a.z, a.w};
    const float wv[TN] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// out[c][r] = act(sum_k A[k][r] W[k, c] + bias[c]) for c < N, 0 for
// N <= c < pad16(N). A holds pad16(K) feature rows, the pad rows zero.
template <bool RELU>
__device__ void layer(const float* A, int K, const float* __restrict__ W,
                      const float* __restrict__ bias, int N, float* out, float* ws) {
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
    const int np = pad16(N);
    for (int c0 = 0; c0 < np; c0 += BN) {
        float acc[TM][TN] = {};
        for (int k0 = 0; k0 < K; k0 += BK) {
            __syncthreads();   // ws is free, and A is complete
            for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
                const int k = k0 + i / BN, c = c0 + i % BN;
                ws[i] = (k < K && c < N) ? W[static_cast<long long>(k) * N + c] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < BK; ++k)
                fma_tile(acc, *reinterpret_cast<const float4*>(A + (k0 + k) * LD + ty * TM),
                         *reinterpret_cast<const float4*>(ws + k * BN + tx * TN));
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + tx * TN + j;
            if (c >= np) continue;
            float v[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const float y = acc[i][j] + (c < N ? bias[c] : 0.f);
                v[i] = c < N ? (RELU ? fmaxf(y, 0.f) : y) : 0.f;
            }
            *reinterpret_cast<float4*>(out + c * LD + ty * TM) = make_float4(v[0], v[1], v[2], v[3]);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
emit_mlp_kernel(const float* __restrict__ obs,     // (R, D)
                const float* __restrict__ w1, const float* __restrict__ b1,    // (D, H), (H,)
                const float* __restrict__ w2, const float* __restrict__ b2,    // (H, H), (H,)
                const float* __restrict__ wm, const float* __restrict__ bm,    // (H, D), (D,)
                const float* __restrict__ wlv, const float* __restrict__ blv,  // (H, D), (D,)
                const float* __restrict__ ta, const float* __restrict__ tb,
                const float* __restrict__ tc,                                  // (D, S) each
                const float* __restrict__ state_const,                         // (S,)
                const float* __restrict__ center,                              // (D,)
                float* __restrict__ out,                                       // (R, S)
                long long R, int D, int H, int S) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int dp = pad16(D), hp = pad16(H);
    float* x = smem;                                  // x, then u^2 wo
    float* h1 = x + LD * dp;                          // h1, then mo | lvo
    float* h2 = h1 + LD * (hp > 2 * dp ? hp : 2 * dp);
    float* ws = h2 + LD * hp;                         // 3 staged slices
    float* rnorm = ws + 3 * BK * BN;                  // -1/2 sum_d lvo per row
    float* mo = h1;                                   // mo, then u wo
    float* lvo = h1 + LD * dp;                        // lvo, then wo
    const long long row0 = static_cast<long long>(blockIdx.x) * BR;
    const int tid = threadIdx.x;

    // The observation tile, feature-major; rows past R and pad features 0.
    for (int i = tid; i < BR * dp; i += THREADS) {
        const int r = i / dp, d = i % dp;
        const long long gr = row0 + r;
        x[d * LD + r] = (gr < R && d < D) ? obs[gr * D + d] : 0.f;
    }
    layer<true>(x, D, w1, b1, H, h1, ws);
    layer<true>(h1, H, w2, b2, H, h2, ws);
    layer<false>(h2, H, wm, bm, D, mo, ws);
    layer<false>(h2, H, wlv, blv, D, lvo, ws);
    __syncthreads();

    if (tid < BR) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += lvo[d * LD + tid];
        rnorm[tid] = -0.5f * s;
    }
    __syncthreads();
    for (int i = tid; i < BR * D; i += THREADS) {
        const int d = i / BR, r = i % BR, at = d * LD + r;
        const float u = (x[at] - mo[at]) - center[d];
        const float wo = expf(-lvo[at]);
        const float uw = u * wo;
        x[at] = u * uw;
        mo[at] = uw;
        lvo[at] = wo;
    }

    // The three head products in one pass; pad features are 0 in both
    // operands.
    const int tx = tid % (BN / TN), ty = tid / (BN / TN);
    const float norm = -0.5f * static_cast<float>(D) * LOG_2PI;
    float* sa = ws;
    float* sb = ws + BK * BN;
    float* sc = ws + 2 * BK * BN;
    for (int c0 = 0; c0 < S; c0 += BN) {
        float tuu[TM][TN] = {}, tum[TM][TN] = {}, tmm[TM][TN] = {};
        for (int k0 = 0; k0 < D; k0 += BK) {
            __syncthreads();
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int k = k0 + i / BN, c = c0 + i % BN;
                const bool ok = k < D && c < S;
                const long long at = static_cast<long long>(k) * S + c;
                sa[i] = ok ? ta[at] : 0.f;
                sb[i] = ok ? tb[at] : 0.f;
                sc[i] = ok ? tc[at] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                const int a = (k0 + k) * LD + ty * TM, w = k * BN + tx * TN;
                fma_tile(tuu, *reinterpret_cast<const float4*>(x + a),
                         *reinterpret_cast<const float4*>(sa + w));
                fma_tile(tum, *reinterpret_cast<const float4*>(mo + a),
                         *reinterpret_cast<const float4*>(sb + w));
                fma_tile(tmm, *reinterpret_cast<const float4*>(lvo + a),
                         *reinterpret_cast<const float4*>(sc + w));
            }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const long long r = row0 + ty * TM + i;
            if (r >= R) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = c0 + tx * TN + j;
                if (c >= S) continue;
                const float mahal = fmaxf(tuu[i][j] - 2.f * tum[i][j] + tmm[i][j], 0.f);
                out[r * S + c] = ((state_const[c] + norm) + rnorm[ty * TM + i]) - 0.5f * mahal;
            }
        }
    }
}

}  // namespace

// obs (R, D); w1 (D, H), b1 (H,), w2 (H, H), b2 (H,), wm / wlv (H, D),
// bm / blv (D,); ta / tb / tc (D, S); state_const (S,); center (D,);
// out (R, S). All float32, contiguous, on `device`; the wrapper keeps
// (D, H) inside 227 KB of shared memory a block (ops/emit_mlp.py mirrors
// smem_floats). Launches on `stream` and returns cudaGetLastError() (or
// the error of the shared-memory request).
extern "C" int emit_mlp_f32(const float* obs, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* wm,
                            const float* bm, const float* wlv, const float* blv,
                            const float* ta, const float* tb, const float* tc,
                            const float* state_const, const float* center, float* out,
                            long long R, int D, int H, int S, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int bytes = static_cast<int>(smem_floats(D, H) * sizeof(float));
    err = cudaFuncSetAttribute(emit_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((R + BR - 1) / BR);
    emit_mlp_kernel<<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        obs, w1, b1, w2, b2, wm, bm, wlv, blv, ta, tb, tc, state_const, center, out, R, D, H, S);
    return static_cast<int>(cudaGetLastError());
}
