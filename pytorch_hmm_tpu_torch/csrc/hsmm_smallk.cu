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
// (backward) of log_a lives in registers. hsmm_fb has a design of its
// own, which takes the window's older terms off the chain (below).

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

// ---- hsmm_fb: both sum chains, the window's older terms off the chain ----
//
// Of frame t's window terms only j = 0 depends on the frame before: the
// forward's alpha*(t) needs mu(t-1) there, while its terms j >= 1 use
// mu(t-2..t-D) and emissions, all known a frame earlier; the backward's
// beta_start(t) needs beta*(t) for j = 0 and beta*(t+1..) for j >= 1. So
// each chain runs in two roles a frame apart, which meet at one block
// barrier a frame:
//   * the chain warp keeps the dependent step alone: the two-way lse of
//     the j = 0 term with the older terms' (max, sum), then the
//     predecessor lse. L = 32 / KP lanes hold a state, each taking KP / L
//     predecessors; their maxima and sums join by xor shuffles, so a lane
//     runs KP / L exps a frame instead of KP.
//   * helper warps work a frame ahead: G lanes a state, lane g taking the
//     window terms j = 1 + g + G i (at most NJ, their log_dur in
//     registers), extend the window ring by the next frame's emission and
//     reduce the next frame's older terms to their max and their sum
//     under it (xor shuffles over the G lanes).
// Each term and its grouping are forward_chain's and backward_chain's;
// only the sums run in another order, and the exps and logs are the MUFU
// approximations (see lse_join). The ring is laid out [state][slot] at a
// stride of D rounded up to 32, plus G, so a warp's lanes fall in
// distinct banks. One chain a block: block b < B runs sequence b's
// forward chain, block B + b its backward chain. What is left bounds it:
// the frame barrier and, at the bench's S = 10, D = 20, the helpers'
// ~5 terms a lane and four shuffle levels against the chain's join and
// predecessor lse, each several hundred cycles a frame (the phase probe;
// PERF.md).
//
// The lane split (G, NJ) and the shared bytes are fb_plan in
// ops/hsmm_smallk.py, which the entry point checks.

constexpr int FB_MAX_LANES = 16;   // G, lanes a state
constexpr int FB_TERMS = 8;        // NJ below D = 130; 16 above

__host__ __device__ inline int fb_stride(int D, int G) { return (D + 31) / 32 * 32 + G % 32; }

// Bytes of dynamic shared memory: the (K, stride) ring of float2, the
// emissions of two 64-frame chunks, and the exchange vectors.
__host__ __device__ inline size_t fb_bytes(int K, int D, int G) {
    return sizeof(float) * (2 * static_cast<size_t>(K) * fb_stride(D, G) + 2 * CH * K + 6 * KMAX);
}

#ifdef HSMM_SMALLK_PROBE
// The phase probe (-DHSMM_SMALLK_PROBE, reached only through
// hsmm_fb_probe_f32): the chain's lane 0 and the first helper thread each
// sum, over a 64-frame chunk, the cycles (clock64()) of their steps of a
// frame, each stamped after an instruction that consumes the step's result
// (so it has completed), into g_probe[(block * chunks + chunk) * 6 +
// phase]: the chain's join (from its first loads' arrival: the two-way
// lse, the table stores), its predecessor lse, its wait for the frame
// barrier (which blocks at the first load after it); the helpers' terms
// (ring loads and stores, the max), their reduction (the exps, the
// shuffles, the exchange stores), their wait.
constexpr int PROBE_PHASES = 6;
__device__ long long* g_probe;
#define PROBE_CLOCK() clock64()
#else
#define PROBE_CLOCK() 0ll
#endif

#ifdef HSMM_SMALLK_PROBE
// A clock stamp that issues after a and b have arrived: the volatile add
// consumes them and keeps its place before the volatile clock read.
__device__ __forceinline__ long long stamp_after(float a, float b) {
    float d;
    asm volatile("add.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return clock64();
}
#endif

// log(exp(x) + s exp(m)): the j = 0 term joined with the older terms'
// max m and their sum s under it (m = -inf, s = 0 when there are none).
// Branch-free, its two exps side by side. The chains' exps and logs are
// the MUFU approximations (__expf, __logf): a few ulp on the terms near
// the max, which carry the sums, and ~2^-21 absolute on a log, the order
// of the sums' own rounding; the tables stay within chip_smoke.py's
// tolerances against the plain version and float64.
__device__ __forceinline__ float lse_join(float x, float m, float s) {
    const float mx = fmaxf(x, m);
    const float v = mx + __logf(__expf(x - mx) + s * __expf(m - mx));
    return m == -INFINITY ? x : v;
}

// Shared-memory loads and stores at 32-bit shared addresses computed
// outside the frame loop (through generic pointers the compiler rebuilds
// the shared window's base inside it). Volatile: they keep their order
// against the barriers.
__device__ __forceinline__ uint32_t saddr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lds(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ float2 lds2(uint32_t a) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v));
}

// The predecessor lse of state s = lane / L over its lane's KP / L
// predecessors k = h (KP / L) + i, from their values val (held by lane
// k L) plus a[i], joined over the state's L lanes.
template <int KP>
__device__ __forceinline__ float lse_pred(float val, const float (&a)[KP * KP / 32], int h) {
    constexpr int L = 32 / KP, M = KP / L;
    float v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) v[i] = __shfl_sync(FULL, val, (h * M + i) * L) + a[i];
    float m = v[0];
#pragma unroll
    for (int i = 1; i < M; ++i) m = fmaxf(m, v[i]);
#pragma unroll
    for (int o = 1; o < L; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    if (m == -INFINITY) m = 0.f;
    float w[M];
#pragma unroll
    for (int i = 0; i < M; ++i) w[i] = __expf(v[i] - m);
#pragma unroll
    for (int st = 1; st < M; st <<= 1)
#pragma unroll
        for (int i = 0; i + st < M; i += 2 * st) w[i] += w[i + st];
    float sum = w[0];
#pragma unroll
    for (int o = 1; o < L; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
    return m + __logf(sum);
}

// One chain of one sequence: FORWARD writes alpha* and log_z, else beta*
// and beta_start.
template <int KP, int NJ, int G, bool FORWARD>
__device__ void fb_chain(float* dyn, const float* __restrict__ lo, const float* __restrict__ log_a,
                         const float* __restrict__ log_pi, const float* __restrict__ log_dur, int len,
                         int T, int K, int D, float* __restrict__ out0,
                         float* __restrict__ out1, float* __restrict__ log_z) {
    constexpr int L = 32 / KP, M = KP / L;
    const int DP = fb_stride(D, G);
    float* ring = dyn;                           // (K, DP) float2 (E, mu) forward, float backward
    float* lo_s = ring + 2 * K * DP;             // frame t's emissions at (t & 127) K
    float* xch = lo_s + 2 * CH * K;              // (2, KMAX): mu(t) or beta*(t)
    float* om = xch + 2 * KMAX;                  // (2, KMAX): the older terms' max
    float* os = om + 2 * KMAX;                   // (2, KMAX): their sum under it
    float2* ring2 = reinterpret_cast<float2*>(ring);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int nch = (T + CH - 1) / CH;
    const bool chain = tid < 32;
    // Chain lane: state cs = lane / L, part h. Helper thread: state hs,
    // lane hg of its G.
    const int cs = lane / L, h = lane % L;
    const int hs = (tid - 32) / G, hg = (tid - 32) % G;
    const bool live = chain ? cs < K : hs < K;
    const int s = chain ? cs : hs;

    // Stage chunk c of the emissions (helper warp 0), waited by the same
    // lanes and published by the frame barrier.
    auto stage_chunk = [&](int c) {
        const int n = min(CH, T - c * CH);
        stage(lo_s + (c & 1) * CH * K, lo + static_cast<long long>(c) * CH * K, n * K, lane);
    };
    const int last = nch - 1;
    if (tid >= 32 && tid < 64) {
        if (FORWARD) {
            stage_chunk(0);
            if (last >= 1) stage_chunk(1);
        } else {
            stage_chunk(last);
            if (last >= 1) stage_chunk(last - 1);
        }
        __pipeline_wait_prior(0);
    }

    float carry = NEG;       // the chain's: mu(t-1), or beta*(t)
    float ld0 = NEG, afin = NEG;
    float a[M];              // forward log_a[k, s], backward log_a[s, k]; k = h M + i
    float ldj[NJ];           // helper: log_dur[s, 1 + hg + G i]
    if (chain) {
        ld0 = live ? fmaxf(log_dur[s * D], NEG) : NEG;
#pragma unroll
        for (int i = 0; i < M; ++i) {
            const int k = h * M + i;
            a[i] = live && k < K ? fmaxf(FORWARD ? log_a[k * K + s] : log_a[s * K + k], NEG) : NEG;
        }
        if (FORWARD) {
            carry = live ? fmaxf(log_pi[s], NEG) : NEG;
            if (h == 0) {
                xch[KMAX + s] = carry;   // mu(-1) for the helpers' frame 0
                om[s] = -INFINITY;       // no older terms at frame 0
                os[s] = 0.f;
            }
        } else if (h == 0) {
            om[((T - 1) & 1) * KMAX + s] = -INFINITY;   // none past the end
            os[((T - 1) & 1) * KMAX + s] = 0.f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            const int j = 1 + hg + G * i;
            ldj[i] = live && j < D ? fmaxf(log_dur[s * D + j], NEG) : NEG;
        }
    }
    __syncthreads();
    if (chain && !FORWARD) {
        // beta*(T-1): 0 at a row's last frame, else from beta_start(T) = NEG.
        const float bs = lse_pred<KP>(NEG, a, h);
        carry = T - 1 == len - 1 ? 0.f : (live ? bs : NEG);
        if (h == 0) xch[((T - 1) & 1) * KMAX + s] = carry;
    }
    if (FORWARD && !chain && live && hg == 0) ring2[s * DP].x = lo_s[s];   // E(0..0)
    __syncthreads();

    long long acc[3] = {0, 0, 0};   // the probe's sums of this thread's steps
    long long c0 = PROBE_CLOCK(), cb = 0, cm = 0;
    int ck = FORWARD ? 0 : last;
    int head = 0;            // helper: (t + 1) mod D forward, t mod D backward
    if (!FORWARD) head = (T - 1) % D;
    else head = D == 1 ? 0 : 1;
    // This thread's shared addresses: its state's emission in chunk row 0,
    // exchange entries, ring row.
    const uint32_t a_lo = saddr(lo_s) + 4 * s, a_xch = saddr(xch) + 4 * s;
    const uint32_t a_om = saddr(om) + 4 * s, a_os = saddr(os) + 4 * s;
    const uint32_t a_ring = saddr(ring) + (FORWARD ? 8 : 4) * s * DP;
    for (int step = 0; step < T; ++step) {
        const int t = FORWARD ? step : T - 1 - step;
        const uint32_t par = (t & 1) * KMAX * 4;       // frame t's exchange half
        const uint32_t row = (t & 127) * K * 4;        // frame t's emission row
        if (chain) {
            if (FORWARD) {
                const float o = live ? lds(a_lo + row) : 0.f;
                const float term0 = (ld0 + o) + carry;
                const float om_t = lds(a_om + par), os_t = lds(a_os + par);
#ifdef HSMM_SMALLK_PROBE
                cb = stamp_after(term0, om_t + os_t);
#endif
                const float val = live ? lse_join(term0, om_t, os_t) : NEG;
                if (live && h == 0) out0[static_cast<long long>(t) * K + s] = val;
                if (t == len - 1) afin = val;
                cm = PROBE_CLOCK();
                const float mu = lse_pred<KP>(val, a, h);
                carry = live ? mu : NEG;
                if (h == 0) sts(a_xch + par, carry);
            } else {
                const float o = live && t < len ? lds(a_lo + row) : 0.f;
                const float om_t = lds(a_om + par), os_t = lds(a_os + par);
#ifdef HSMM_SMALLK_PROBE
                cb = stamp_after(o, om_t + os_t);
#endif
                float bs = -INFINITY;
                if (t < len) bs = lse_join(ld0 + (carry + o), om_t, os_t);
                if (live && h == 0) {
                    const long long at = static_cast<long long>(t) * K + s;
                    out0[at] = carry;
                    out1[at] = bs;
                }
                cm = PROBE_CLOCK();
                if (t > 0) {
                    const float bn = live ? bs : NEG;
                    const float next = lse_pred<KP>(bn, a, h);
                    carry = t - 1 == len - 1 ? 0.f : next;
                    if (h == 0) sts(a_xch + (KMAX * 4 - par), carry);
                }
            }
        } else {
            // The next frame's older terms: forward frame t + 1 from mu(t-1)
            // on, backward frame t - 1 from beta*(t) on.
            const bool more = FORWARD ? t + 1 < T : t >= 1;
            if (more) {
                const int tn = FORWARD ? t + 1 : t - 1;
                const int nj = FORWARD ? min(D - 1, tn) : min(D - 1, len - 1 - tn);
                const uint32_t npar = KMAX * 4 - par;    // frame tn's exchange half
                const float in = live ? lds(a_xch + (FORWARD ? npar : par)) : 0.f;
                float o1 = 0.f, o0 = 0.f;
                if (live) {
                    o1 = FORWARD || tn < len ? lds(a_lo + (tn & 127) * K * 4) : 0.f;
                    if (!FORWARD) o0 = t < len ? lds(a_lo + row) : 0.f;
                }
#ifdef HSMM_SMALLK_PROBE
                cb = stamp_after(in, o1 + o0);
#endif
                // Every ring load before any store, so the loads issue
                // together (the compiler cannot tell the slots apart).
                // Forward: segment start u = t + 1 - j, E(u..t+1) and
                // mu(u-1); backward: segment end e = t - 1 + j, beta*(e) +
                // E(t-1..e).
                float term[NJ], upd[NJ];
                int at[NJ];
                float2 em[NJ];
#pragma unroll
                for (int i = 0; i < NJ; ++i) {
                    const int j = 1 + hg + G * i;
                    int slot = FORWARD ? head - j : head + j - 1;
                    if (FORWARD && slot < 0) slot += D;
                    if (!FORWARD && slot >= D) slot -= D;
                    at[i] = live && j <= nj ? slot : -1;
                    em[i] = make_float2(0.f, 0.f);
                    if (at[i] >= 0) {
                        if (FORWARD) em[i] = lds2(a_ring + 8 * slot);
                        else if (j > 1) em[i].x = lds(a_ring + 4 * slot);
                    }
                }
                float m = -INFINITY;
#pragma unroll
                for (int i = 0; i < NJ; ++i) {
                    const int j = 1 + hg + G * i;
                    if (FORWARD) {
                        upd[i] = em[i].x + o1;
                        term[i] = (ldj[i] + upd[i]) + (j == 1 ? in : em[i].y);
                    } else {
                        upd[i] = (j == 1 ? in + o0 : em[i].x) + o1;
                        term[i] = ldj[i] + upd[i];
                    }
                    if (at[i] < 0) term[i] = -INFINITY;
                    m = fmaxf(m, term[i]);
                }
#pragma unroll
                for (int i = 0; i < NJ; ++i)
                    if (at[i] >= 0) sts(a_ring + (FORWARD ? 8 : 4) * at[i], upd[i]);
#pragma unroll
                for (int o = 1; o < G; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
                const float mm = m == -INFINITY ? 0.f : m;
#ifdef HSMM_SMALLK_PROBE
                asm volatile("" ::"f"(mm));
                cm = PROBE_CLOCK();
#endif
                float w[NJ];
#pragma unroll
                for (int i = 0; i < NJ; ++i) w[i] = __expf(term[i] - mm);
#pragma unroll
                for (int st = 1; st < NJ; st <<= 1)
#pragma unroll
                    for (int i = 0; i + st < NJ; i += 2 * st) w[i] += w[i + st];
                float sum = w[0];
#pragma unroll
                for (int o = 1; o < G; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
                if (live && hg == 0) {
                    sts(a_om + npar, m);
                    sts(a_os + npar, sum);
                    if (FORWARD) {
                        sts(a_ring + 8 * head, o1);                                // E(t+1..t+1)
                        sts(a_ring + 8 * (head == 0 ? D - 1 : head - 1) + 4, in);  // mu(t-1), slot t
                    }
                }
            }
            // The emissions a chunk ahead: issued at a chunk's first frame,
            // waited at its middle (the chunk is whole whenever another
            // follows), published by the barrier.
            if (tid < 64) {
                const int c = t / CH, f = t % CH;
                if (FORWARD && c >= 1 && c + 1 <= last) {
                    if (f == 0) stage_chunk(c + 1);
                    if (f == CH / 2) __pipeline_wait_prior(0);
                }
                if (!FORWARD && c < last && c >= 1) {
                    if (f == CH - 1) stage_chunk(c - 1);
                    if (f == CH / 2) __pipeline_wait_prior(0);
                }
            }
            head = FORWARD ? (head + 1 == D ? 0 : head + 1) : (head == 0 ? D - 1 : head - 1);
        }
#ifdef HSMM_SMALLK_PROBE
        const long long c1 = PROBE_CLOCK();
        __syncthreads();
        const long long c2 = PROBE_CLOCK();
        if (cm == 0) cb = cm = c0;   // no step this frame
        acc[0] += cm - cb;
        acc[1] += c1 - cm;
        acc[2] += (c2 - c1) + (cb - c0);
        c0 = c2;
        cb = cm = 0;
        const int nck = FORWARD ? (step + 1 < T ? (t + 1) / CH : -1) : (t >= 1 ? (t - 1) / CH : -1);
        if (nck != ck) {
            if (tid == 0 || tid == 32) {
                long long* p = g_probe + (static_cast<long long>(blockIdx.x) * nch + ck) * PROBE_PHASES +
                               (tid == 0 ? 0 : 3);
                p[0] = acc[0];
                p[1] = acc[1];
                p[2] = acc[2];
            }
            acc[0] = acc[1] = acc[2] = 0;
            ck = nck;
        }
#else
        __syncthreads();
#endif
    }
    if (FORWARD && chain) {
        float v[KP];
#pragma unroll
        for (int k = 0; k < KP; ++k) v[k] = __shfl_sync(FULL, afin, k * L);
        const float z = lse<KP>(v);
        if (lane == 0) *log_z = z;
    }
}

template <int KP, int NJ, int G>
__global__ void __launch_bounds__(32 + (KP * G > 32 ? KP * G : 32))
hsmm_fb_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
               const float* __restrict__ log_pi, const float* __restrict__ log_dur,
               const int* __restrict__ lengths, float* __restrict__ alpha,
               float* __restrict__ log_z, float* __restrict__ beta_star,
               float* __restrict__ beta_start, int B, int T, int K, int D) {
    extern __shared__ __align__(16) float dyn_fb[];
    const bool forward = blockIdx.x < B;
    const int b = forward ? blockIdx.x : blockIdx.x - B;
    const long long row = static_cast<long long>(b) * T * K;
    const int len = row_length(lengths, b, T);
    if (forward)
        fb_chain<KP, NJ, G, true>(dyn_fb, log_obs + row, log_a, log_pi, log_dur, len, T, K, D,
                               alpha + row, nullptr, log_z + b);
    else
        fb_chain<KP, NJ, G, false>(dyn_fb, log_obs + row, log_a, log_pi, log_dur, len, T, K, D,
                                beta_star + row, beta_start + row, nullptr);
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

// alpha*, beta*, beta_start (B, T, K) and log_z (B,) out; G lanes a
// state and `bytes` of shared memory, fb_plan's (refused unless G is a
// power of two up to 16 whose slices of 8 or 16 terms cover the window and
// bytes hold fb_bytes).
static cudaError_t hsmm_fb_launch(const float* log_obs, const float* log_a, const float* log_pi,
                                  const float* log_dur, const int* lengths, float* alpha,
                                  float* log_z, float* beta_star, float* beta_start, int B, int T,
                                  int K, int D, int G, int bytes, cudaStream_t st) {
    const int per_lane = (D - 1 + G - 1) / G;
    const int threads = 32 * (1 + (K * G + 31) / 32);
    if (G < 1 || G > FB_MAX_LANES || (G & (G - 1)) != 0 || per_lane > 2 * FB_TERMS ||
        threads > 1024 || bytes < static_cast<long long>(fb_bytes(K, D, G)) || K < 1 || K > KMAX ||
        D < 1 || B < 1 || T < 1)
        return cudaErrorInvalidValue;
    const bool wide = per_lane > FB_TERMS;
#define FB_LAUNCH(KP_, NJ_, G_)                                                                 \
    do {                                                                                        \
        auto kernel = hsmm_fb_kernel<KP_, NJ_, G_>;                                             \
        cudaError_t e_ = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                              bytes);                                           \
        if (e_ != cudaSuccess) return e_;                                                       \
        kernel<<<2 * B, threads, bytes, st>>>(log_obs, log_a, log_pi, log_dur, lengths, alpha,   \
                                              log_z, beta_star, beta_start, B, T, K, D);        \
    } while (0)
#define FB_LANES(KP_)                                                     \
    do {                                                                  \
        if (G == 1) FB_LAUNCH(KP_, FB_TERMS, 1);                          \
        else if (G == 2) FB_LAUNCH(KP_, FB_TERMS, 2);                     \
        else if (G == 4) FB_LAUNCH(KP_, FB_TERMS, 4);                     \
        else if (G == 8) FB_LAUNCH(KP_, FB_TERMS, 8);                     \
        else if (!wide) FB_LAUNCH(KP_, FB_TERMS, 16);                     \
        else FB_LAUNCH(KP_, 2 * FB_TERMS, 16);                            \
    } while (0)
    if (K <= 8) FB_LANES(8);
    else if (K <= 16) FB_LANES(16);
    else FB_LANES(32);
#undef FB_LANES
#undef FB_LAUNCH
    return cudaGetLastError();
}

extern "C" int hsmm_fb_f32(const float* log_obs, const float* log_a, const float* log_pi,
                           const float* log_dur, const int* lengths, float* alpha,
                           float* log_z, float* beta_star, float* beta_start,
                           int B, int T, int K, int D, int G, int bytes, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(hsmm_fb_launch(log_obs, log_a, log_pi, log_dur, lengths, alpha, log_z,
                                           beta_star, beta_start, B, T, K, D, G, bytes,
                                           static_cast<cudaStream_t>(stream)));
}

#ifdef HSMM_SMALLK_PROBE
// hsmm_fb, probed: arguments as hsmm_fb_f32 plus probe, (2, B,
// ceil(T / 64), 6) int64 cycles out (block x = chain B + b).
extern "C" int hsmm_fb_probe_f32(const float* log_obs, const float* log_a, const float* log_pi,
                                 const float* log_dur, const int* lengths, float* alpha,
                                 float* log_z, float* beta_star, float* beta_start,
                                 long long* probe, int B, int T, int K, int D, int G, int bytes,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyToSymbolAsync(g_probe, &probe, sizeof(probe), 0, cudaMemcpyHostToDevice,
                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(hsmm_fb_launch(log_obs, log_a, log_pi, log_dur, lengths, alpha, log_z,
                                           beta_star, beta_start, B, T, K, D, G, bytes,
                                           static_cast<cudaStream_t>(stream)));
}
#endif

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
