// Explicit-duration (semi-Markov) segment DP for S <= 32 states and
// durations 1..D, D <= 256: the Viterbi segmentation with its
// backtrace, the forward and backward sum recursions, and both sum
// chains fused in one launch.
//
// Replaces four TPU kernels of pytorch_hmm_tpu/ops/hsmm_smallk.py:
//   hsmm_viterbi_f32   hsmm_smallk_viterbi (_hsmm_trellis_kernel and
//                      _hsmm_backtrace_kernel, two launches there);
//   hsmm_forward_f32   hsmm_smallk_forward (_hsmm_fsum_kernel) at
//                      general D;
//   hsmm_backward_f32  hsmm_smallk_backward (_hsmm_bsum_kernel) at
//                      general D;
//   hsmm_fb_f32        hsmm_smallk_fb (_hsmm_fbsum_kernel), here with
//                      ragged lengths as well.
// D = 1 keeps the HMM kernels of smallk_sum.cu on the likelihood path.
//
// The recursion, per sequence b, state s, frame t, duration index j
// (duration j+1), with log_a, log_pi and log_dur clamped at -1e30:
//
//   alpha*(t, s)  = lse_{j <= t}(log_dur[s, j] + E(s, t-j..t) + mu(t-j-1, s))
//   mu(t, s)      = lse_k(alpha*(t, k) + log_a[k, s]),  mu(-1, s) = log_pi[s]
//   beta*(t, s)   = lse_k(log_a[s, k] + beta_start(t+1, k)), 0 at t = len-1
//   beta_start(t, s) = lse_{j <= len-1-t}(log_dur[s, j] + E(s, t..t+j)
//                                         + beta*(t+j, s))
//   log_z         = lse_s(alpha*(len-1, s))
//
// E is a segment's emission sum. The sum kernels keep it as a window
// ring: the slot of segment start u (forward) or end e (backward) holds
// the emissions seen since, and every frame adds its log-obs to the D
// live slots, E(t, d) = E(t-1, d-1) + lo_t. The TPU kernels take E as a
// difference of running sums C(t) - C(t-d) instead; at speech widths C
// reaches ~1e5, where that difference loses f32 digits (PERF.md, §6).
// The Viterbi kernel keeps the running sums and the operand grouping
// (log_dur + (C(t) - C(t-j-1))) + mu(t-j-1) of core.hsmm_viterbi, and its
// ties (lowest duration index, then lowest predecessor), so its paths
// and scores are bit-identical to the plain version. Its duration and
// predecessor argmax tables go to a uint8 (B, T, S) scratch in device
// memory, and the backtrace reads them back in the same launch.
//
// What bounds it on an H100: the serial chain of T frames per sequence.
// Each frame is a D-step scan of the duration ring (a max pass and an
// exp-sum pass, or one compare pass for Viterbi) and a KP-wide
// predecessor reduction over shuffles (KP = S rounded up to 8, 16 or
// 32), all dependent on the previous frame. At B = 32 a warp per chain
// fills 32 of the 132 SMs, so the card is mostly idle: the time is chain
// latency, about D + log2(KP) dependent steps a frame.
//
// Design: one warp per chain, lane s owns state s. The (D, S) rings
// (mu and E, or running sums for Viterbi, and the backward's
// beta* + E) live in shared memory, laid out [slot][lane] so the lanes'
// accesses never share a bank, and are indexed by a circular head: a
// frame writes one slot and reads D, and nothing is copied (the TPU
// kernels shift the whole ring every frame, a VMEM idiom). log_dur is
// staged once into shared memory, log_obs 64 frames at a time with
// cp.async into a double buffer. Column s (forward, Viterbi) or row s
// (backward) of log_a lives in registers. hsmm_fb runs the forward and
// backward chains as two warps of one block, which the SM schedules
// side by side.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int KMAX = 32;
constexpr int CH = 64;            // frames staged per chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;     // the TPU kernels' _NEG

using Stage = float[2][CH * KMAX];

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

// logsumexp of v[0..KP), max-shifted; an all -inf set gives -inf.
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

// One level of the argmax tree: entry i absorbs entry i+S only when the
// latter is strictly greater. Entry i always covers lower indices, so
// the tree keeps the lowest-index argmax, as a k-ascending scan with a
// strict '>' would.
template <int KP, int S>
__device__ __forceinline__ void arg_level(float (&v)[KP], int (&idx)[KP]) {
#pragma unroll
    for (int i = 0; i < KP; i += 2 * S) {
        const bool right = v[i + S] > v[i];
        idx[i] = right ? idx[i + S] : idx[i];
        v[i] = right ? v[i + S] : v[i];
    }
}

template <int KP>
__device__ __forceinline__ void tree_argmax(float (&v)[KP], int (&idx)[KP]) {
    arg_level<KP, 1>(v, idx);
    arg_level<KP, 2>(v, idx);
    arg_level<KP, 4>(v, idx);
    if constexpr (KP >= 16) arg_level<KP, 8>(v, idx);
    if constexpr (KP >= 32) arg_level<KP, 16>(v, idx);
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

// log_dur (S, D) into ld_s[j * KMAX + s], clamped at NEG; states past K
// get NEG. Run by all `nthreads` threads of the block.
__device__ __forceinline__ void load_durations(float* ld_s, const float* __restrict__ log_dur,
                                               int K, int D, int tid, int nthreads) {
    for (int i = tid; i < D * KMAX; i += nthreads) {
        const int j = i / KMAX, s = i % KMAX;
        ld_s[i] = s < K ? fmaxf(log_dur[s * D + j], NEG) : NEG;
    }
}

// The forward chain of one sequence, run by one warp: alpha* (T, K) and
// log_z. mu_r and e_r are the (D, KMAX) rings of mu(u-1) and E(u..t),
// slot u mod D for segment start u.
template <int KP>
__device__ void forward_chain(const float* __restrict__ lo, const float* __restrict__ log_a,
                              const float* __restrict__ log_pi, const float* ld_s,
                              int len, int T, int K, int D, int lane,
                              float* __restrict__ alpha, float* __restrict__ log_z,
                              Stage& lo_s, float* mu_r, float* e_r) {
    const bool live = lane < K;
    float a_col[KP];   // a_col[k] = log_a[k, lane]
#pragma unroll
    for (int k = 0; k < KP; ++k)
        a_col[k] = (live && k < K) ? fmaxf(log_a[k * K + lane], NEG) : NEG;

    float mu_prev = live ? fmaxf(log_pi[lane], NEG) : NEG;   // mu(t-1)
    float afin = NEG;
    int head = 0;                                             // slot of u = t
    int buf = 0;
    stage(lo_s[0], lo, min(CH, T) * K, lane);
    for (int t0 = 0; t0 < T; t0 += CH, buf ^= 1) {
        const int n = min(CH, T - t0);
        wait_staged();
        if (t0 + CH < T)
            stage(lo_s[buf ^ 1], lo + static_cast<long long>(t0 + CH) * K,
                  min(CH, T - t0 - CH) * K, lane);
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            const float o = live ? lo_s[buf][tf * K + lane] : 0.f;
            mu_r[head * KMAX + lane] = mu_prev;
            e_r[head * KMAX + lane] = 0.f;
            const int nj = min(D - 1, t);
            // Pass 1: extend every live window by frame t, and the max.
            float m = -INFINITY;
            int slot = head;
            for (int j = 0; j <= nj; ++j) {
                const int at = slot * KMAX + lane;
                const float e = e_r[at] + o;
                e_r[at] = e;
                m = fmaxf(m, (ld_s[j * KMAX + lane] + e) + mu_r[at]);
                slot = slot == 0 ? D - 1 : slot - 1;
            }
            // Pass 2: the shifted sum of exponentials.
            const float mm = (m == -INFINITY) ? 0.f : m;
            float sum = 0.f;
            slot = head;
            for (int j = 0; j <= nj; ++j) {
                const int at = slot * KMAX + lane;
                sum += expf((ld_s[j * KMAX + lane] + e_r[at]) + mu_r[at] - mm);
                slot = slot == 0 ? D - 1 : slot - 1;
            }
            const float val = live ? mm + logf(sum) : NEG;
            if (live) alpha[static_cast<long long>(t) * K + lane] = val;
            if (t == len - 1) afin = val;
            float v[KP];
#pragma unroll
            for (int k = 0; k < KP; ++k) v[k] = __shfl_sync(FULL, val, k) + a_col[k];
            mu_prev = live ? lse<KP>(v) : NEG;
            head = head + 1 == D ? 0 : head + 1;
        }
    }
    float v[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = __shfl_sync(FULL, afin, k);
    const float z = lse<KP>(v);
    if (lane == 0) *log_z = z;
}

// The backward chain of one sequence, run by one warp: beta* and
// beta_start (T, K). v_r is the (D, KMAX) ring of beta*(e) + E(t..e),
// slot e mod D for segment end e. Frames past the row's end read their
// log-obs as 0 and give beta_start = -inf (no segment fits).
template <int KP>
__device__ void backward_chain(const float* __restrict__ lo, const float* __restrict__ log_a,
                               const float* ld_s, int len, int T, int K, int D, int lane,
                               float* __restrict__ beta_star, float* __restrict__ beta_start,
                               Stage& lo_s, float* v_r) {
    const bool live = lane < K;
    float a_row[KP];   // a_row[k] = log_a[lane, k]
#pragma unroll
    for (int k = 0; k < KP; ++k)
        a_row[k] = (live && k < K) ? fmaxf(log_a[lane * K + k], NEG) : NEG;

    float bn = NEG;    // beta_start(t+1, lane)
    int head = (T - 1) % D;   // slot of e = t
    int buf = 0;
    const int last0 = ((T - 1) / CH) * CH;
    stage(lo_s[0], lo + static_cast<long long>(last0) * K, (T - last0) * K, lane);
    for (int t0 = last0; t0 >= 0; t0 -= CH, buf ^= 1) {
        const int n = min(CH, T - t0);
        wait_staged();
        if (t0 > 0)
            stage(lo_s[buf ^ 1], lo + static_cast<long long>(t0 - CH) * K, CH * K, lane);
        for (int tf = n - 1; tf >= 0; --tf) {
            const int t = t0 + tf;
            float bstar = 0.f;
            if (t != len - 1) {
                float v[KP];
#pragma unroll
                for (int k = 0; k < KP; ++k) v[k] = a_row[k] + __shfl_sync(FULL, bn, k);
                bstar = lse<KP>(v);
            }
            const float o = (live && t < len) ? lo_s[buf][tf * K + lane] : 0.f;
            v_r[head * KMAX + lane] = bstar;
            const int nj = min(D - 1, len - 1 - t);
            float m = -INFINITY;
            int slot = head;
            for (int j = 0; j <= nj; ++j) {
                const int at = slot * KMAX + lane;
                const float e = v_r[at] + o;
                v_r[at] = e;
                m = fmaxf(m, ld_s[j * KMAX + lane] + e);
                slot = slot + 1 == D ? 0 : slot + 1;
            }
            const float mm = (m == -INFINITY) ? 0.f : m;
            float sum = 0.f;
            slot = head;
            for (int j = 0; j <= nj; ++j) {
                sum += expf(ld_s[j * KMAX + lane] + v_r[slot * KMAX + lane] - mm);
                slot = slot + 1 == D ? 0 : slot + 1;
            }
            const float bs = mm + logf(sum);
            bn = live ? bs : NEG;
            if (live) {
                const long long at = static_cast<long long>(t) * K + lane;
                beta_star[at] = bstar;
                beta_start[at] = bs;
            }
            head = head == 0 ? D - 1 : head - 1;
        }
    }
}

template <int KP>
__global__ void __launch_bounds__(KMAX)
hsmm_forward_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                    const float* __restrict__ log_pi, const float* __restrict__ log_dur,
                    const int* __restrict__ lengths, float* __restrict__ alpha,
                    float* __restrict__ log_z, int T, int K, int D) {
    __shared__ Stage lo_s;
    extern __shared__ float dyn[];
    float* ld_s = dyn;
    float* mu_r = ld_s + D * KMAX;
    float* e_r = mu_r + D * KMAX;
    const int b = blockIdx.x;
    load_durations(ld_s, log_dur, K, D, threadIdx.x, KMAX);
    __syncwarp();
    const long long row = static_cast<long long>(b) * T * K;
    forward_chain<KP>(log_obs + row, log_a, log_pi, ld_s, row_length(lengths, b, T), T, K, D,
                      threadIdx.x, alpha + row, log_z + b, lo_s, mu_r, e_r);
}

template <int KP>
__global__ void __launch_bounds__(KMAX)
hsmm_backward_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                     const float* __restrict__ log_dur, const int* __restrict__ lengths,
                     float* __restrict__ beta_star, float* __restrict__ beta_start,
                     int T, int K, int D) {
    __shared__ Stage lo_s;
    extern __shared__ float dyn[];
    float* ld_s = dyn;
    float* v_r = ld_s + D * KMAX;
    const int b = blockIdx.x;
    load_durations(ld_s, log_dur, K, D, threadIdx.x, KMAX);
    __syncwarp();
    const long long row = static_cast<long long>(b) * T * K;
    backward_chain<KP>(log_obs + row, log_a, ld_s, row_length(lengths, b, T), T, K, D,
                       threadIdx.x, beta_star + row, beta_start + row, lo_s, v_r);
}

// Warp 0 runs the forward chain, warp 1 the backward chain.
template <int KP>
__global__ void __launch_bounds__(2 * KMAX)
hsmm_fb_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
               const float* __restrict__ log_pi, const float* __restrict__ log_dur,
               const int* __restrict__ lengths, float* __restrict__ alpha,
               float* __restrict__ log_z, float* __restrict__ beta_star,
               float* __restrict__ beta_start, int T, int K, int D) {
    __shared__ Stage lo_s[2];
    extern __shared__ float dyn[];
    float* ld_s = dyn;
    float* mu_r = ld_s + D * KMAX;
    float* e_r = mu_r + D * KMAX;
    float* v_r = e_r + D * KMAX;
    const int b = blockIdx.x;
    const int warp = threadIdx.x / KMAX;
    const int lane = threadIdx.x % KMAX;
    load_durations(ld_s, log_dur, K, D, threadIdx.x, 2 * KMAX);
    __syncthreads();
    const long long row = static_cast<long long>(b) * T * K;
    const int len = row_length(lengths, b, T);
    if (warp == 0)
        forward_chain<KP>(log_obs + row, log_a, log_pi, ld_s, len, T, K, D, lane,
                          alpha + row, log_z + b, lo_s[0], mu_r, e_r);
    else
        backward_chain<KP>(log_obs + row, log_a, ld_s, len, T, K, D, lane,
                           beta_star + row, beta_start + row, lo_s[1], v_r);
}

// Segment Viterbi of one sequence per block (one warp): the trellis
// over frames t < len, writing the duration and predecessor argmax
// tables, then the backtrace by lane 0 over tables staged back newest
// first. mu_r and c_r are the (D, KMAX) rings of mu(u-1) and the
// running sum C(u-1), slot u mod D for segment start u.
template <int KP>
__global__ void __launch_bounds__(KMAX)
hsmm_viterbi_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                    const float* __restrict__ log_pi, const float* __restrict__ log_dur,
                    const int* __restrict__ lengths, uint8_t* __restrict__ dstar_g,
                    uint8_t* __restrict__ phi_g, int* __restrict__ states,
                    float* __restrict__ score, int T, int K, int D) {
    __shared__ Stage lo_s;
    __shared__ uint8_t ds_s[CH * KMAX];
    __shared__ uint8_t ph_s[CH * KMAX];
    __shared__ int st_s[CH];
    extern __shared__ float dyn[];
    float* ld_s = dyn;
    float* mu_r = ld_s + D * KMAX;
    float* c_r = mu_r + D * KMAX;

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const bool live = lane < K;
    const long long row = static_cast<long long>(b) * T * K;
    const float* lo = log_obs + row;
    uint8_t* dstar = dstar_g + row;
    uint8_t* phi = phi_g + row;
    int* st = states + static_cast<long long>(b) * T;
    const int len = row_length(lengths, b, T);
    load_durations(ld_s, log_dur, K, D, lane, KMAX);
    __syncwarp();

    // a_col[k] = log_a[k, lane] clamped at NEG; predecessors past K get
    // -inf, which never wins a strict '>' against a real state.
    float a_col[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k)
        a_col[k] = (live && k < K) ? fmaxf(log_a[k * K + lane], NEG) : -INFINITY;

    // mu(-1) = log_pi unclamped, as core.hsmm_viterbi seeds its ring.
    float mu_prev = live ? log_pi[lane] : NEG;
    float c_run = 0.f;                 // C(t-1)
    float dfin = NEG;
    int dsfin = 0;
    int head = 0;
    int buf = 0;
    stage(lo_s[0], lo, min(CH, len) * K, lane);
    for (int t0 = 0; t0 < len; t0 += CH, buf ^= 1) {
        const int n = min(CH, len - t0);
        wait_staged();
        if (t0 + CH < len)
            stage(lo_s[buf ^ 1], lo + static_cast<long long>(t0 + CH) * K,
                  min(CH, len - t0 - CH) * K, lane);
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            const float o = live ? lo_s[buf][tf * K + lane] : 0.f;
            const float c_t = c_run + o;
            mu_r[head * KMAX + lane] = mu_prev;
            c_r[head * KMAX + lane] = c_run;
            // Durations j <= t in ascending order with a strict '>':
            // the lowest index wins ties. Durations j > t score NEG in
            // the plain version; the first of them can still win.
            const int nj = min(D - 1, t);
            float best = 0.f;
            int bj = 0;
            int slot = head;
            for (int j = 0; j <= nj; ++j) {
                const int at = slot * KMAX + lane;
                const float s = (ld_s[j * KMAX + lane] + (c_t - c_r[at])) + mu_r[at];
                if (j == 0 || s > best) {
                    best = s;
                    bj = j;
                }
                slot = slot == 0 ? D - 1 : slot - 1;
            }
            if (nj < D - 1 && NEG > best) {
                best = NEG;
                bj = nj + 1;
            }
            const float val = live ? best : -INFINITY;
            float v[KP];
            int idx[KP];
#pragma unroll
            for (int k = 0; k < KP; ++k) {
                v[k] = __shfl_sync(FULL, val, k) + a_col[k];
                idx[k] = k;
            }
            tree_argmax<KP>(v, idx);
            mu_prev = v[0];
            if (live) {
                const long long at = static_cast<long long>(t) * K + lane;
                dstar[at] = static_cast<uint8_t>(bj);
                phi[at] = static_cast<uint8_t>(idx[0]);
            }
            if (t == len - 1) {
                dfin = val;
                dsfin = bj;
            }
            c_run = c_t;
            head = head + 1 == D ? 0 : head + 1;
        }
    }
    __syncthreads();   // the tables in device memory, for the backtrace

    // Score and the lowest-index argmax of the final frame's delta.
    float best = __shfl_sync(FULL, dfin, 0);
    int s = 0;
    for (int k = 1; k < K; ++k) {
        const float v = __shfl_sync(FULL, dfin, k);
        if (v > best) {
            best = v;
            s = k;
        }
    }
    int left = __shfl_sync(FULL, dsfin, s) + 1;   // frames of the segment left
    if (lane == 0) score[b] = best;

    // Backtrace, newest chunk first. Staged row tf of a chunk at t0
    // holds frame t0 + tf - 1: the tables that frame t0 + tf reads.
    const int last0 = ((T - 1) / CH) * CH;
    for (int t0 = last0; t0 >= 0; t0 -= CH) {
        const int n = min(CH, T - t0);
        if (t0 < len) {
            const long long base = static_cast<long long>(t0 - 1) * K;
            for (int i = (t0 == 0 ? K : 0) + lane; i < n * K; i += KMAX) {
                ds_s[i] = dstar[base + i];
                ph_s[i] = phi[base + i];
            }
        }
        __syncthreads();
        if (lane == 0) {
            for (int tf = n - 1; tf >= 0; --tf) {
                const int t = t0 + tf;
                st_s[tf] = s;
                if (t >= len || t == 0) continue;   // padding repeats the final state
                if (--left == 0) {
                    s = ph_s[tf * K + s];
                    left = ds_s[tf * K + s] + 1;
                }
            }
        }
        __syncthreads();
        for (int i = lane; i < n; i += KMAX) st[t0 + i] = st_s[i];
        __syncthreads();
    }
}

// Dynamic shared memory of the rings and the duration table: `rings`
// (D, KMAX) float arrays, the table included.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int D, int rings, size_t* bytes) {
    *bytes = static_cast<size_t>(rings) * D * KMAX * sizeof(float);
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*bytes));
}

}  // namespace

// KP: K rounded up to 8, 16 or 32. RINGS counts the (D, KMAX) float
// arrays of dynamic shared memory.
#define LAUNCH_KP(KERNEL, RINGS, B, THREADS, STREAM, ...)                          \
    do {                                                                           \
        size_t bytes = 0;                                                          \
        cudaError_t e_;                                                            \
        if (K <= 8) {                                                              \
            if ((e_ = prepare(KERNEL<8>, D, RINGS, &bytes)) != cudaSuccess)        \
                return static_cast<int>(e_);                                       \
            KERNEL<8><<<B, THREADS, bytes, STREAM>>>(__VA_ARGS__);                 \
        } else if (K <= 16) {                                                      \
            if ((e_ = prepare(KERNEL<16>, D, RINGS, &bytes)) != cudaSuccess)       \
                return static_cast<int>(e_);                                       \
            KERNEL<16><<<B, THREADS, bytes, STREAM>>>(__VA_ARGS__);                \
        } else {                                                                   \
            if ((e_ = prepare(KERNEL<32>, D, RINGS, &bytes)) != cudaSuccess)       \
                return static_cast<int>(e_);                                       \
            KERNEL<32><<<B, THREADS, bytes, STREAM>>>(__VA_ARGS__);                \
        }                                                                          \
    } while (0)

// All tensors contiguous on `device`: log_obs (B, T, K), log_a (K, K),
// log_pi (K,), log_dur (K, D) float32; lengths (B,) int32 or null (every
// row has T frames). 1 <= K <= 32, 1 <= D <= 256. Each launches on
// `stream` and returns the first CUDA error, or cudaGetLastError().

// alpha* (B, T, K) and log_z (B,) out.
extern "C" int hsmm_forward_f32(const float* log_obs, const float* log_a, const float* log_pi,
                                const float* log_dur, const int* lengths, float* alpha,
                                float* log_z, int B, int T, int K, int D, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hsmm_forward_kernel, 3, B, KMAX, st, log_obs, log_a, log_pi, log_dur, lengths,
              alpha, log_z, T, K, D);
    return static_cast<int>(cudaGetLastError());
}

// beta* and beta_start (B, T, K) out.
extern "C" int hsmm_backward_f32(const float* log_obs, const float* log_a, const float* log_dur,
                                 const int* lengths, float* beta_star, float* beta_start,
                                 int B, int T, int K, int D, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hsmm_backward_kernel, 2, B, KMAX, st, log_obs, log_a, log_dur, lengths,
              beta_star, beta_start, T, K, D);
    return static_cast<int>(cudaGetLastError());
}

// alpha*, beta*, beta_start (B, T, K) and log_z (B,) out.
extern "C" int hsmm_fb_f32(const float* log_obs, const float* log_a, const float* log_pi,
                           const float* log_dur, const int* lengths, float* alpha,
                           float* log_z, float* beta_star, float* beta_start,
                           int B, int T, int K, int D, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hsmm_fb_kernel, 4, B, 2 * KMAX, st, log_obs, log_a, log_pi, log_dur, lengths,
              alpha, log_z, beta_star, beta_start, T, K, D);
    return static_cast<int>(cudaGetLastError());
}

// dstar, phi (B, T, K) uint8 scratch; states (B, T) int32 and score
// (B,) float32 out.
extern "C" int hsmm_viterbi_f32(const float* log_obs, const float* log_a, const float* log_pi,
                                const float* log_dur, const int* lengths, uint8_t* dstar,
                                uint8_t* phi, int* states, float* score,
                                int B, int T, int K, int D, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    LAUNCH_KP(hsmm_viterbi_kernel, 3, B, KMAX, st, log_obs, log_a, log_pi, log_dur, lengths,
              dstar, phi, states, score, T, K, D);
    return static_cast<int>(cudaGetLastError());
}
