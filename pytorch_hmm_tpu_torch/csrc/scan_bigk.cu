// Forward, backward and Viterbi chains of an HMM with up to 1024 states
// (static (K, K) transitions, optional per-row lengths), one launch each.
//
// Replaces the TPU kernels of pytorch_hmm_tpu/ops/scan.py:
//   * pallas_forward  (_forward_kernel): log alpha in the scaling form
//       c = max_i alpha_{t-1}[i]
//       alpha_t[j] = (lo_t[j] + c) + log(sum_i exp(alpha_{t-1}[i] - c) P[i, j])
//     with alpha_0 = log_pi + lo_0 and rows frozen from t = lengths[b] on;
//   * pallas_backward (_backward_kernel): log beta in the same form,
//       v = lo_{t+1} + beta_{t+1},  c = max(max_j v_j, -1e30)
//       beta_t[i] = c + log(sum_j exp(v_j - c) P[i, j])
//     with beta_t = 0 for t >= lengths[b] - 1;
//   * pallas_viterbi (_vit_trellis_kernel + _vit_backtrace_kernel): the
//     max-plus trellis delta_t[j] = max_i(delta_{t-1}[i] + log_a[i, j])
//     + lo_t[j], in exactly that add order, candidates compared with a
//     strict '>' in ascending i (the lowest-index tie, as core.viterbi's
//     argmax), so paths and scores are bit-identical to core.viterbi;
//     padded frames repeat each row's last valid state.
// P is exp(log_a), computed by the caller; the backward takes it
// transposed, so both sum chains are the same vector-matrix step.
//
// What bounds it on an H100: the serial chain of T frames per sequence.
// The bytes are small (at B=32, T=1000, K=64 the log-obs and the output
// table are 8.2 MB each, ~5 us at 3.35 TB/s) and so are the operations
// (~2 B T K^2 = 0.26 GFLOP, ~4 us at 67 TFLOP/s), but each frame depends
// on the one before: a block reduction (the max), an exp, a K-long
// sum per state and a log, with three block barriers between them.
//
// Design: one block per sequence; time is a loop inside the block. The
// block has split x kc threads (kc = K rounded up to 32): thread (g, col)
// sums rows i in [g*slice, (g+1)*slice) of column col, so the dependent
// chain per frame is slice = K / split long instead of K; the split
// partial sums meet in shared memory and thread (0, col), the column's
// owner, adds them in order of g. The (K, K) matrix sits in dynamic
// shared memory where it fits (64 KB at K=128, up to K=221); above that
// its rows are read from device memory, where they stay in L2 (4 MB at
// K=1024), each warp reading 32 consecutive columns of one row. The
// Viterbi writes 16-bit backpointers to a (B, T, K) scratch during the
// trellis and walks them back in the same launch, staging chunks of
// frames in shared memory (the matrix's, which the trellis no longer
// needs). The TPU needed two launches only because a same-kernel write
// and read-back of a DMA buffer hung on that chip.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// The matrix goes to shared memory while it takes at most this many bytes.
constexpr int SMEM_MATRIX_BYTES = 192 * 1024;
// Backpointer staging for the backtrace, and its most frames per chunk.
constexpr int PSI_STAGE_BYTES = 16384;
constexpr int PSI_MAX_FRAMES = 256;

// Thread layout of one block: kc columns (K rounded up to 32) times
// `split` row slices of `slice` rows each.
struct Plan {
    int kc, split, slice, threads;
    bool smem;
};

Plan make_plan(int K) {
    Plan p;
    p.kc = (K + 31) / 32 * 32;
    int split = p.kc / 16;                       // slices of at least 16 rows
    split = split < 8 ? split : 8;
    split = split < MAX_THREADS / p.kc ? split : MAX_THREADS / p.kc;
    p.split = split > 1 ? split : 1;
    p.slice = (K + p.split - 1) / p.split;
    p.threads = p.split * p.kc;
    p.smem = static_cast<long long>(K) * K * 4 <= SMEM_MATRIX_BYTES;
    return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// Copy the (K, K) matrix into shared memory (SMEM) or use it in place.
template <bool SMEM>
__device__ __forceinline__ const float* stage_matrix(const float* mat, float* mat_s, int K) {
    if constexpr (SMEM) {
        for (int i = threadIdx.x; i < K * K; i += blockDim.x) mat_s[i] = mat[i];
        __syncthreads();
        return mat_s;
    } else {
        return mat;
    }
}

__device__ __forceinline__ int row_length(const int* lengths, int b, int T) {
    const int len = lengths ? lengths[b] : T;
    return len < 1 ? 1 : (len > T ? T : len);
}

// The two sum chains. Forward: out = alpha, mat = P. Backward: out =
// beta, mat = P transposed, so that both read mat[i * K + col] and sum
// over i.
template <bool BACKWARD, bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
sum_chain_kernel(const float* __restrict__ log_obs,   // (B, T, K)
                 const float* __restrict__ mat,       // (K, K) probabilities
                 const float* __restrict__ log_pi,    // (K,), forward only
                 const int* __restrict__ lengths,     // (B,) or null
                 float* __restrict__ out,             // (B, T, K)
                 int T, int K, int kc, int split, int slice) {
    extern __shared__ float mat_s[];
    __shared__ float p_s[MAX_THREADS];
    __shared__ float part_s[MAX_THREADS];
    __shared__ float red_s[32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int col = tid % kc;
    const int g = tid / kc;
    const bool active = col < K;
    const bool owner = active && g == 0;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nred = kc / 32;                    // the owners' warps
    const float* lo = log_obs + static_cast<long long>(b) * T * K;
    float* o = out + static_cast<long long>(b) * T * K;
    const int len = row_length(lengths, b, T);
    const float* M = stage_matrix<SMEM>(mat, mat_s, K);
    const int i0 = g * slice;
    const int i1 = min(K, i0 + slice);

    // x: alpha_t (forward) or beta_t (backward) of the owner's state.
    float x = 0.f;
    if constexpr (BACKWARD) {
        for (int i = tid; i < (T - len + 1) * K; i += blockDim.x)
            o[static_cast<long long>(len - 1) * K + i] = 0.f;
    } else {
        if (owner) {
            x = log_pi[col] + lo[col];
            o[col] = x;
        }
    }
    for (int step = 0; step < len - 1; ++step) {
        const int t = BACKWARD ? len - 2 - step : step + 1;   // frame written
        const int tl = BACKWARD ? t + 1 : t;                  // frame of log_obs read
        const float lo_t = owner ? lo[static_cast<long long>(tl) * K + col] : 0.f;
        const float v = owner ? (BACKWARD ? lo_t + x : x) : -INFINITY;
        float m = v;
#pragma unroll
        for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        if (lane == 0 && warp < nred) red_s[warp] = m;
        __syncthreads();
        float c = red_s[0];
        for (int w = 1; w < nred; ++w) c = fmaxf(c, red_s[w]);
        if (BACKWARD) c = fmaxf(c, -1e30f);
        if (owner) p_s[col] = expf(v - c);
        __syncthreads();
        if (active) {
            // Four independent partial sums keep four row loads in flight.
            float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
            int i = i0;
            for (; i + 4 <= i1; i += 4) {
                acc0 = fmaf(p_s[i], M[i * K + col], acc0);
                acc1 = fmaf(p_s[i + 1], M[(i + 1) * K + col], acc1);
                acc2 = fmaf(p_s[i + 2], M[(i + 2) * K + col], acc2);
                acc3 = fmaf(p_s[i + 3], M[(i + 3) * K + col], acc3);
            }
            for (; i < i1; ++i) acc0 = fmaf(p_s[i], M[i * K + col], acc0);
            part_s[g * kc + col] = (acc0 + acc1) + (acc2 + acc3);
        }
        __syncthreads();
        if (owner) {
            float s = part_s[col];
            for (int q = 1; q < split; ++q) s += part_s[q * kc + col];
            x = BACKWARD ? c + logf(s) : (lo_t + c) + logf(s);
            o[static_cast<long long>(t) * K + col] = x;
        }
    }
    if constexpr (!BACKWARD) {
        // Frames past the row's end hold its last valid alpha.
        if (owner)
            for (int t = len; t < T; ++t) o[static_cast<long long>(t) * K + col] = x;
    }
}

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_kernel(const float* __restrict__ log_obs,   // (B, T, K)
               const float* __restrict__ log_a,     // (K, K)
               const float* __restrict__ log_pi,    // (K,)
               const int* __restrict__ lengths,     // (B,) or null
               int16_t* __restrict__ psi_g,         // (B, T, K) scratch
               int* __restrict__ states,            // (B, T)
               float* __restrict__ score,           // (B,)
               int T, int K, int kc, int split, int slice) {
    extern __shared__ float dyn_s[];   // the matrix, then the backpointer stage
    __shared__ float d_s[MAX_THREADS];
    __shared__ float part_v[MAX_THREADS];
    __shared__ int part_i[MAX_THREADS];
    __shared__ int st_s[PSI_MAX_FRAMES];
    __shared__ int last_s;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int col = tid % kc;
    const int g = tid / kc;
    const bool active = col < K;
    const bool owner = active && g == 0;
    const float* lo = log_obs + static_cast<long long>(b) * T * K;
    int16_t* psi = psi_g + static_cast<long long>(b) * T * K;
    int* st = states + static_cast<long long>(b) * T;
    const int len = row_length(lengths, b, T);
    const float* M = stage_matrix<SMEM>(log_a, dyn_s, K);
    const int i0 = g * slice;
    const int i1 = min(K, i0 + slice);

    float d = owner ? log_pi[col] + lo[col] : 0.f;
    for (int t = 1; t < len; ++t) {
        const float lo_t = owner ? lo[static_cast<long long>(t) * K + col] : 0.f;
        if (owner) d_s[col] = d;
        __syncthreads();
        if (active) {
            // The slice's lowest-index max, seeded with its first
            // candidate; an empty slice never wins a strict '>'.
            float best = -INFINITY;
            int arg = K;
            if (i0 < i1) {
                best = d_s[i0] + M[i0 * K + col];
                arg = i0;
                for (int i = i0 + 1; i < i1; ++i) {
                    const float cand = d_s[i] + M[i * K + col];
                    if (cand > best) {
                        best = cand;
                        arg = i;
                    }
                }
            }
            part_v[g * kc + col] = best;
            part_i[g * kc + col] = arg;
        }
        __syncthreads();
        if (owner) {
            float bv = part_v[col];
            int bi = part_i[col];
            for (int q = 1; q < split; ++q) {
                if (part_v[q * kc + col] > bv) {
                    bv = part_v[q * kc + col];
                    bi = part_i[q * kc + col];
                }
            }
            d = bv + lo_t;
            psi[static_cast<long long>(t) * K + col] = static_cast<int16_t>(bi);
        }
    }

    // Score and the lowest-index argmax of the final delta.
    if (owner) d_s[col] = d;
    __syncthreads();
    if (tid == 0) {
        float best = d_s[0];
        int s = 0;
        for (int k = 1; k < K; ++k) {
            if (d_s[k] > best) {
                best = d_s[k];
                s = k;
            }
        }
        score[b] = best;
        last_s = s;
    }
    __syncthreads();
    int s = last_s;
    for (int t = len - 1 + tid; t < T; t += blockDim.x) st[t] = s;

    // Backtrace, newest chunk first: frame t's backpointer row gives the
    // state at t - 1.
    int16_t* psi_st = reinterpret_cast<int16_t*>(dyn_s);
    int ch = PSI_STAGE_BYTES / (2 * K);
    ch = ch < PSI_MAX_FRAMES ? ch : PSI_MAX_FRAMES;
    for (int t1 = len - 1; t1 >= 1;) {
        const int t0 = max(1, t1 - ch + 1);
        const int n = t1 - t0 + 1;
        __syncthreads();
        for (int i = tid; i < n * K; i += blockDim.x)
            psi_st[i] = psi[static_cast<long long>(t0) * K + i];
        __syncthreads();
        if (tid == 0) {
            for (int t = t1; t >= t0; --t) {
                s = psi_st[(t - t0) * K + s];
                st_s[t - t0] = s;
            }
        }
        __syncthreads();
        for (int i = tid; i < n; i += blockDim.x) st[t0 - 1 + i] = st_s[i];
        t1 = t0 - 1;
    }
}

template <bool BACKWARD>
cudaError_t launch_sum(const float* log_obs, const float* mat, const float* log_pi,
                       const int* lengths, float* out, int B, int T, int K,
                       cudaStream_t st) {
    const Plan p = make_plan(K);
    const size_t bytes = p.smem ? static_cast<size_t>(K) * K * sizeof(float) : 0;
    if (p.smem) {
        cudaError_t err = allow_smem(sum_chain_kernel<BACKWARD, true>, bytes);
        if (err != cudaSuccess) return err;
        sum_chain_kernel<BACKWARD, true><<<B, p.threads, bytes, st>>>(
            log_obs, mat, log_pi, lengths, out, T, K, p.kc, p.split, p.slice);
    } else {
        sum_chain_kernel<BACKWARD, false><<<B, p.threads, 0, st>>>(
            log_obs, mat, log_pi, lengths, out, T, K, p.kc, p.split, p.slice);
    }
    return cudaGetLastError();
}

}  // namespace

// log_obs (B, T, K), pa = exp(log_a) (K, K), log_pi (K,) float32; lengths
// (B,) int32 or null; alpha (B, T, K) float32 out. All contiguous, on
// `device`; 1 <= K <= 1024. Launches on `stream`, returns cudaGetLastError().
extern "C" int scan_bigk_forward_f32(const float* log_obs, const float* pa, const float* log_pi,
                                     const int* lengths, float* alpha, int B, int T, int K,
                                     int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_sum<false>(log_obs, pa, log_pi, lengths, alpha, B, T, K,
                                              static_cast<cudaStream_t>(stream)));
}

// As scan_bigk_forward_f32, with pa_t = exp(log_a) transposed and beta out.
extern "C" int scan_bigk_backward_f32(const float* log_obs, const float* pa_t, const int* lengths,
                                      float* beta, int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_sum<true>(log_obs, pa_t, nullptr, lengths, beta, B, T, K,
                                             static_cast<cudaStream_t>(stream)));
}

// log_obs (B, T, K), log_a (K, K), log_pi (K,) float32; lengths (B,)
// int32 or null; psi (B, T, K) int16 scratch; states (B, T) int32 and
// score (B,) float32 out. All contiguous, on `device`; 1 <= K <= 1024.
extern "C" int scan_bigk_viterbi_f32(const float* log_obs, const float* log_a, const float* log_pi,
                                     const int* lengths, int16_t* psi, int* states, float* score,
                                     int B, int T, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Plan p = make_plan(K);
    size_t bytes = p.smem ? static_cast<size_t>(K) * K * sizeof(float) : 0;
    bytes = bytes > PSI_STAGE_BYTES ? bytes : PSI_STAGE_BYTES;
    if (p.smem) {
        err = allow_smem(viterbi_kernel<true>, bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        viterbi_kernel<true><<<B, p.threads, bytes, st>>>(
            log_obs, log_a, log_pi, lengths, psi, states, score, T, K, p.kc, p.split, p.slice);
    } else {
        viterbi_kernel<false><<<B, p.threads, bytes, st>>>(
            log_obs, log_a, log_pi, lengths, psi, states, score, T, K, p.kc, p.split, p.slice);
    }
    return static_cast<int>(cudaGetLastError());
}
