// Small-K HMM sum recursions (log semiring) for K <= 32 states: the
// forward chain, the backward chain, and both fused in one launch.
//
// Replaces three TPU kernels of pytorch_hmm_tpu/ops/:
//   hmm_forward_sum_f32   hsmm_smallk.py: hsmm_smallk_forward at duration
//                         D = 1 (_hsmm_fsum_kernel), the HMM forward of
//                         the likelihood's primal;
//   hmm_backward_sum_f32  hsmm_smallk.py: hsmm_smallk_backward at D = 1
//                         (_hsmm_bsum_kernel), the likelihood's VJP;
//   fbsum_smallk_f32      fbsum.py: fbsum_smallk (_fbsum_kernel), both
//                         chains of the EM E-step and of the ragged
//                         likelihood.
// Each computes, per sequence b, with o_t[j] = log_obs[t, j] + ld0[j]
// (ld0 = log_dur[:, 0], zero for fbsum):
//
//     alpha_0[j] = log_pi[j] + o_0[j]
//     alpha_t[j] = o_t[j] + lse_k(alpha_{t-1}[k] + log_a[k, j])
//     beta_t[i]  = lse_j(log_a[i, j] + o_{t+1}[j] + beta_{t+1}[j]),
//                  beta_t = 0 for t >= len_b - 1
//     log_z      = lse_j(alpha_{len_b - 1}[j])
//     beta_start_t[j] = o_t[j] + beta_t[j]       (backward kernel only)
//
// lse is max-shifted as the TPU kernels' _lse0 is. log_a, log_pi and
// ld0 are clamped at -1e30 as the TPU wrappers clamp them, so a
// left-to-right log_a full of -inf never gives -inf - -inf = NaN; a
// predecessor set whose max is still -inf gives -inf, not NaN. Alpha is
// causal and is not frozen past a row's end (callers mask or fill
// those frames); beta is 0 there.
//
// What bounds it on an H100: the serial chain of T frames per sequence.
// Each frame is KP shuffles and adds, a log2(KP)-level max tree, KP
// expf, a log2(KP)-level sum tree and one logf, all dependent on the
// previous frame (KP = K rounded up to 8, 16 or 32). Bytes are small
// (B*T*K floats in, one or two such tables out), and at B = 32 a warp
// per sequence fills 32 of the 132 SMs, so the card is mostly idle at
// the training headline shape: the time is chain latency, as for the
// TPU kernels.
//
// Design: one warp per chain. Lane j owns state j; it keeps column j
// of log_a in registers for the forward chain, row j for the backward
// chain, and reads the other states' previous values by __shfl_sync.
// The trees are templates with compile-time indices, so no array goes
// to local memory. log_obs is staged into shared memory 64 frames at a
// time with cp.async into a double buffer, so the next chunk's load
// runs behind the current chunk's frames. fbsum_smallk runs the two
// chains as two warps of one block: they are independent (alpha walks
// t up, beta walks t down), so the beta chain runs beside the alpha
// chain on another scheduler of the same SM and both tables cost about
// one chain's time, which is the point of the TPU's fused kernel.
// Outputs go straight to device memory, one coalesced row of K floats
// per frame, off the critical path.
//
// Time-varying mode (fbsum_smallk_tv_f32): log_a is (B, T, K, K), and
// the step into frame t reads log_a[b, t] (log_a[b, 0] is never read):
//
//     alpha_t[j] = o_t[j] + lse_k(alpha_{t-1}[k] + log_a[t][k, j])
//     beta_t[i]  = lse_j(log_a[t+1][i, j] + o_{t+1}[j] + beta_{t+1}[j])
//
// with the same -1e30 clamp. Each chain stages its sequence's matrices
// with its log-obs, TV_CHUNK(KP) frames at a time (32, 16 or 8 for
// KP = 8, 16, 32), into a cp.async double buffer in dynamic shared
// memory. The forward lane j reads column j of its frame's matrix; the
// backward lane i reads row i of frame t's matrix into registers after
// frame t, for frame t-1, so a chunk never reads its neighbour's
// buffer.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int KMAX = 32;
constexpr int CH = 64;            // frames staged per chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;     // the TPU kernels' _NEG

using Stage = float[2][CH * KMAX];

// Frames per staged chunk in time-varying mode: two chunks of
// TV_CHUNK * KP * KP floats are 16, 32 or 64 KB a chain.
template <int KP>
__host__ __device__ constexpr int tv_chunk() {
    return KP == 8 ? 32 : (KP == 16 ? 16 : 8);
}

template <int KP, int S>
__device__ __forceinline__ void max_level(float (&w)[KP]) {
#pragma unroll
    for (int i = 0; i < KP; i += 2 * S) w[i] = fmaxf(w[i], w[i + S]);
}

template <int KP, int S>
__device__ __forceinline__ void sum_level(float (&w)[KP]) {
#pragma unroll
    for (int i = 0; i < KP; i += 2 * S) w[i] += w[i + S];
}

// logsumexp of v[0..KP), max-shifted. Every index is a compile-time
// constant, so v and w stay in registers.
template <int KP>
__device__ __forceinline__ float lse(const float (&v)[KP]) {
    float w[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) w[k] = v[k];
    max_level<KP, 1>(w);
    max_level<KP, 2>(w);
    max_level<KP, 4>(w);
    if constexpr (KP >= 16) max_level<KP, 8>(w);
    if constexpr (KP >= 32) max_level<KP, 16>(w);
    const float m = (w[0] == -INFINITY) ? 0.f : w[0];
#pragma unroll
    for (int k = 0; k < KP; ++k) w[k] = expf(v[k] - m);
    sum_level<KP, 1>(w);
    sum_level<KP, 2>(w);
    sum_level<KP, 4>(w);
    if constexpr (KP >= 16) sum_level<KP, 8>(w);
    if constexpr (KP >= 32) sum_level<KP, 16>(w);
    return m + logf(w[0]);
}

// Start an asynchronous copy of n contiguous floats into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
    for (int i = lane; i < n; i += KMAX)
        __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
    __pipeline_commit();
}

__device__ __forceinline__ void wait_staged() {
    __pipeline_wait_prior(0);
    __syncwarp();
}

__device__ __forceinline__ int row_length(const int* lengths, int b, int T) {
    const int len = lengths ? lengths[b] : T;
    return max(1, min(len, T));
}

// The forward chain of one sequence, run by one warp: alpha (T, K) and
// log_z. lo is the sequence's (T, K) log-obs; log_a is (K, K), or in
// time-varying mode (TV) the sequence's (T, K, K) staged through la_s
// (two chunks of tv_chunk<KP>() frames).
template <int KP, bool TV>
__device__ void forward_chain(const float* __restrict__ lo,
                              const float* __restrict__ log_a,
                              const float* __restrict__ log_pi,
                              const float* __restrict__ ld0,
                              int len, int T, int K, int lane,
                              float* __restrict__ alpha,
                              float* __restrict__ log_z, Stage& lo_s, float* la_s) {
    constexpr int C = TV ? tv_chunk<KP>() : CH;
    const int KK = K * K;
    const bool live = lane < K;
    // a_col[k] = log_a[k, lane]; predecessors k >= K and dead lanes
    // carry NEG, which exp() turns into exact zeros. TV reloads it each
    // frame.
    float a_col[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k)
        a_col[k] = (!TV && live && k < K) ? fmaxf(log_a[k * K + lane], NEG) : NEG;
    const float d0 = (live && ld0) ? fmaxf(ld0[lane], NEG) : 0.f;
    const float pi = live ? fmaxf(log_pi[lane], NEG) : NEG;

    float a = NEG;      // alpha_{t-1}[lane]
    float afin = NEG;   // alpha_{len-1}[lane]
    int buf = 0;
    stage(lo_s[0], lo, min(C, T) * K, lane);
    if constexpr (TV) stage(la_s, log_a, min(C, T) * KK, lane);
    for (int t0 = 0; t0 < T; t0 += C, buf ^= 1) {
        const int n = min(C, T - t0);
        wait_staged();
        if (t0 + C < T) {
            stage(lo_s[buf ^ 1], lo + static_cast<long long>(t0 + C) * K,
                  min(C, T - t0 - C) * K, lane);
            if constexpr (TV)
                stage(la_s + (buf ^ 1) * C * KK, log_a + static_cast<long long>(t0 + C) * KK,
                      min(C, T - t0 - C) * KK, lane);
        }
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            const float o = live ? lo_s[buf][tf * K + lane] + d0 : 0.f;
            float nxt;
            if (t == 0) {
                nxt = pi + o;
            } else {
                if constexpr (TV) {
                    // Column `lane` of log_a[t].
                    const float* m = la_s + (buf * C + tf) * KK + lane;
#pragma unroll
                    for (int k = 0; k < KP; ++k)
                        a_col[k] = (live && k < K) ? fmaxf(m[k * K], NEG) : NEG;
                }
                float v[KP];
#pragma unroll
                for (int k = 0; k < KP; ++k) v[k] = __shfl_sync(FULL, a, k) + a_col[k];
                nxt = o + lse<KP>(v);
            }
            a = live ? nxt : NEG;
            if (live) alpha[static_cast<long long>(t) * K + lane] = a;
            if (t == len - 1) afin = a;
        }
    }
    float v[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = __shfl_sync(FULL, afin, k);
    const float z = lse<KP>(v);
    if (lane == 0) *log_z = z;
}

// The backward chain of one sequence, run by one warp: beta (T, K) and,
// when beta_start is given, o_t + beta_t (T, K). log_a and la_s as for
// forward_chain.
template <int KP, bool TV>
__device__ void backward_chain(const float* __restrict__ lo,
                               const float* __restrict__ log_a,
                               const float* __restrict__ ld0,
                               int len, int T, int K, int lane,
                               float* __restrict__ beta,
                               float* __restrict__ beta_start, Stage& lo_s, float* la_s) {
    constexpr int C = TV ? tv_chunk<KP>() : CH;
    const int KK = K * K;
    const bool live = lane < K;
    // a_row[j] = log_a[lane, j]; TV: of log_a[t + 1], loaded after frame
    // t + 1 (before the first use at t = len - 2).
    float a_row[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j)
        a_row[j] = (!TV && live && j < K) ? fmaxf(log_a[lane * K + j], NEG) : NEG;
    const float d0 = (live && ld0) ? fmaxf(ld0[lane], NEG) : 0.f;

    float bn = NEG;     // o_{t+1}[lane] + beta_{t+1}[lane]
    int buf = 0;
    // The chunk grid is the forward chain's, walked newest first, so the
    // first chunk staged may be short.
    const int last0 = ((T - 1) / C) * C;
    stage(lo_s[0], lo + static_cast<long long>(last0) * K, (T - last0) * K, lane);
    if constexpr (TV)
        stage(la_s, log_a + static_cast<long long>(last0) * KK, (T - last0) * KK, lane);
    for (int t0 = last0; t0 >= 0; t0 -= C, buf ^= 1) {
        const int n = min(C, T - t0);
        wait_staged();
        if (t0 > 0) {
            stage(lo_s[buf ^ 1], lo + static_cast<long long>(t0 - C) * K, C * K, lane);
            if constexpr (TV)
                stage(la_s + (buf ^ 1) * C * KK, log_a + static_cast<long long>(t0 - C) * KK,
                      C * KK, lane);
        }
        for (int tf = n - 1; tf >= 0; --tf) {
            const int t = t0 + tf;
            float b = 0.f;
            if (t < len - 1) {
                float v[KP];
#pragma unroll
                for (int j = 0; j < KP; ++j) v[j] = a_row[j] + __shfl_sync(FULL, bn, j);
                b = lse<KP>(v);
            }
            const float o = live ? lo_s[buf][tf * K + lane] + d0 : 0.f;
            bn = live ? o + b : NEG;
            if (live) {
                const long long at = static_cast<long long>(t) * K + lane;
                beta[at] = b;
                if (beta_start) beta_start[at] = bn;
            }
            if constexpr (TV) {
                // Row `lane` of log_a[t], for the step into t from t - 1.
                const float* m = la_s + (buf * C + tf) * KK + lane * K;
#pragma unroll
                for (int j = 0; j < KP; ++j) a_row[j] = (live && j < K) ? fmaxf(m[j], NEG) : NEG;
            }
        }
    }
}

template <int KP>
__global__ void __launch_bounds__(KMAX)
hmm_forward_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                   const float* __restrict__ log_pi, const float* __restrict__ ld0,
                   const int* __restrict__ lengths, float* __restrict__ alpha,
                   float* __restrict__ log_z, int T, int K) {
    __shared__ Stage lo_s;
    const int b = blockIdx.x;
    const long long row = static_cast<long long>(b) * T * K;
    forward_chain<KP, false>(log_obs + row, log_a, log_pi, ld0, row_length(lengths, b, T), T, K,
                             threadIdx.x, alpha + row, log_z + b, lo_s, nullptr);
}

template <int KP>
__global__ void __launch_bounds__(KMAX)
hmm_backward_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                    const float* __restrict__ ld0, const int* __restrict__ lengths,
                    float* __restrict__ beta, float* __restrict__ beta_start, int T, int K) {
    __shared__ Stage lo_s;
    const int b = blockIdx.x;
    const long long row = static_cast<long long>(b) * T * K;
    backward_chain<KP, false>(log_obs + row, log_a, ld0, row_length(lengths, b, T), T, K,
                              threadIdx.x, beta + row, beta_start + row, lo_s, nullptr);
}

// Warp 0 runs the forward chain, warp 1 the backward chain. TV: log_a
// is (B, T, K, K), staged through dynamic shared memory, two chunks of
// tv_chunk<KP>() frames for each warp.
template <int KP, bool TV = false>
__global__ void __launch_bounds__(2 * KMAX)
fbsum_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
             const float* __restrict__ log_pi, const int* __restrict__ lengths,
             float* __restrict__ alpha, float* __restrict__ beta,
             float* __restrict__ log_z, int T, int K) {
    __shared__ Stage lo_s[2];
    extern __shared__ float la_s[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / KMAX;
    const int lane = threadIdx.x % KMAX;
    const long long row = static_cast<long long>(b) * T * K;
    const int len = row_length(lengths, b, T);
    const int KK = K * K;
    const float* la = TV ? log_a + static_cast<long long>(b) * T * KK : log_a;
    float* mine = TV ? la_s + warp * 2 * tv_chunk<KP>() * KK : nullptr;
    if (warp == 0)
        forward_chain<KP, TV>(log_obs + row, la, log_pi, nullptr, len, T, K, lane,
                              alpha + row, log_z + b, lo_s[0], mine);
    else
        backward_chain<KP, TV>(log_obs + row, la, nullptr, len, T, K, lane,
                               beta + row, nullptr, lo_s[1], mine);
}

template <int KP>
cudaError_t launch_fbsum_tv(const float* log_obs, const float* log_a, const float* log_pi,
                            const int* lengths, float* alpha, float* beta, float* log_z,
                            int B, int T, int K, cudaStream_t st) {
    const int bytes = 2 * 2 * tv_chunk<KP>() * K * K * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(fbsum_kernel<KP, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    fbsum_kernel<KP, true><<<B, 2 * KMAX, bytes, st>>>(log_obs, log_a, log_pi, lengths,
                                                       alpha, beta, log_z, T, K);
    return cudaGetLastError();
}

}  // namespace

// KP: K rounded up to 8, 16 or 32.
#define LAUNCH_KP(KERNEL, B, THREADS, STREAM, ...)                                  \
    do {                                                                            \
        if (K <= 8)                                                                 \
            KERNEL<8><<<B, THREADS, 0, STREAM>>>(__VA_ARGS__);                      \
        else if (K <= 16)                                                           \
            KERNEL<16><<<B, THREADS, 0, STREAM>>>(__VA_ARGS__);                     \
        else                                                                        \
            KERNEL<32><<<B, THREADS, 0, STREAM>>>(__VA_ARGS__);                     \
    } while (0)

// All tensors float32 and contiguous on `device`: log_obs (B, T, K),
// log_a (K, K), log_pi and ld0 (K,); lengths (B,) int32 or null (every
// row has T frames). 1 <= K <= 32. Each launches on `stream` and returns
// cudaGetLastError().

// alpha (B, T, K) and log_z (B,) out.
extern "C" int hmm_forward_sum_f32(const float* log_obs, const float* log_a,
                                   const float* log_pi, const float* ld0,
                                   const int* lengths, float* alpha, float* log_z,
                                   int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hmm_forward_kernel, B, KMAX, st, log_obs, log_a, log_pi, ld0, lengths,
              alpha, log_z, T, K);
    return static_cast<int>(cudaGetLastError());
}

// beta_star and beta_start (B, T, K) out.
extern "C" int hmm_backward_sum_f32(const float* log_obs, const float* log_a,
                                    const float* ld0, const int* lengths,
                                    float* beta_star, float* beta_start,
                                    int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hmm_backward_kernel, B, KMAX, st, log_obs, log_a, ld0, lengths,
              beta_star, beta_start, T, K);
    return static_cast<int>(cudaGetLastError());
}

// alpha and beta (B, T, K) and log_z (B,) out.
extern "C" int fbsum_smallk_f32(const float* log_obs, const float* log_a,
                                const float* log_pi, const int* lengths,
                                float* alpha, float* beta, float* log_z,
                                int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(fbsum_kernel, B, 2 * KMAX, st, log_obs, log_a, log_pi, lengths,
              alpha, beta, log_z, T, K);
    return static_cast<int>(cudaGetLastError());
}

// The time-varying mode: as fbsum_smallk_f32, with log_a (B, T, K, K).
extern "C" int fbsum_smallk_tv_f32(const float* log_obs, const float* log_a,
                                   const float* log_pi, const int* lengths,
                                   float* alpha, float* beta, float* log_z,
                                   int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 8)
        err = launch_fbsum_tv<8>(log_obs, log_a, log_pi, lengths, alpha, beta, log_z, B, T, K, st);
    else if (K <= 16)
        err = launch_fbsum_tv<16>(log_obs, log_a, log_pi, lengths, alpha, beta, log_z, B, T, K, st);
    else
        err = launch_fbsum_tv<32>(log_obs, log_a, log_pi, lengths, alpha, beta, log_z, B, T, K, st);
    return static_cast<int>(err);
}
