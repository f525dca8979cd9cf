// Exact batched Viterbi decode for K <= 32 states: max-plus trellis,
// per-frame backpointers and the backtrace, in one launch.
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/smallk.py: smallk_viterbi
// (_trellis_psi_kernel + _gather_backtrace_kernel, two launches there).
// Each frame computes, as pytorch_hmm_tpu.core.viterbi and its port
// pytorch_hmm_tpu_torch.core.viterbi do,
//
//     delta_t[j] = max_k(delta_{t-1}[k] + log_a[k, j]) + log_obs[t, j]
//
// in that add order; ties go to the lowest predecessor k (a strict '>'
// that never lets a higher index displace an equal lower one, and no
// -inf sentinel seed), frames t >= lengths[b] keep delta frozen and point
// psi at their own state (so padded frames repeat the last valid state),
// and the score is the max of each row's frozen final delta.
//
// Bounded chain. The plain versions run that recursion on raw scores:
// at GMM scale (|log_obs| ~ 125 a frame) delta reaches ~1.25e5 by
// T=1000, where one float32 ulp is ~8e-3, and the score drifts by tenths
// of a nat there and by whole nats at T=4096. This kernel keeps delta at
// O(1e2) whatever T is: each frame's largest score m_t is taken out of its
// log_obs where the chunk is staged into shared memory, off the chain,
// and once a staged chunk delta is renormalised by its largest lane (one
// warp reduce a chunk). Both are constants across a frame's states, so
// every argmax, tie and path is the recursion's own; what was taken out
// (m_t on each row's valid frames, and each chunk's renormaliser) is
// summed in double and added to the final best. The paths equal the
// plain versions' except where two candidates tie to within the plain
// versions' own rounding; the scores are closer to the exact ones.
//
// What bounds it on an H100: the serial chain of T frames per sequence,
// each about KP shuffles and adds and a log2(KP)-deep compare tree long
// (KP = K rounded up to 8, 16 or 32). Bytes are small
// (B*T*K floats in, B*T*K bytes of backpointers out and back). With one
// warp per sequence, B = 32 occupies 32 of the 132 SMs with one warp
// each, so the card is mostly idle at the decode headline shape; that is
// expected here, and spreading sequences over more of the card is later
// work.
//
// Design: one warp (one block) per sequence; lane j owns state j and
// keeps column j of log_a in registers. delta_k reaches lane j by
// __shfl_sync. log_obs is staged in shared memory a chunk of frames at a
// time (one coalesced read of CH*K contiguous floats per chunk, written
// at a frame stride of K | 1), so the frame loop waits on device memory
// once per chunk, not once per frame; then each lane shifts two of the
// chunk's frames by their largest score.
// Backpointers are written to device memory as uint8 (B, T, K). After the
// trellis the same warp stages psi back chunk by chunk, newest first, and
// lane 0 walks it from the lowest-index argmax of the final delta.
//
// Time-varying mode (smallk_viterbi_tv_f32): log_a is (B, T, K, K) and
// frame t's step reads log_a[b, t] (log_a[b, 0] is never read), with the
// same add order, ties, padding rule and bounded chain. Each frame's
// column no longer fits a register file loaded once, so the sequence's
// matrices are staged into dynamic shared memory with cp.async,
// TV_CHUNK(KP) frames at a time (32, 16 or 8 frames for KP = 8, 16, 32)
// into a double buffer: the next chunk's copy runs behind the current
// chunk's frames, and lane j reads column j of its frame's matrix from
// shared memory (consecutive lanes, consecutive words) where the static
// mode reads registers.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int KMAX = 32;
constexpr int CH = 64;          // frames staged per chunk
constexpr unsigned FULL = 0xffffffffu;

// One level of the argmax tree: entry i (a multiple of 2*S) absorbs
// entry i+S. Entry i always covers lower indices than entry i+S, so
// taking the right only when strictly greater keeps the lowest-index
// argmax, exactly as a k-ascending scan with a strict '>' would. Every
// index is a compile-time constant, so v and idx stay in registers.
template <int KP, int S>
__device__ __forceinline__ void tree_level(float (&v)[KP], int (&idx)[KP]) {
#pragma unroll
    for (int i = 0; i < KP; i += 2 * S) {
        const bool right = v[i + S] > v[i];
        idx[i] = right ? idx[i + S] : idx[i];
        v[i] = right ? v[i + S] : v[i];
    }
}

// Max and lowest-index argmax of v[0..KP) into v[0], idx[0].
template <int KP>
__device__ __forceinline__ void tree_argmax(float (&v)[KP], int (&idx)[KP]) {
    tree_level<KP, 1>(v, idx);
    tree_level<KP, 2>(v, idx);
    tree_level<KP, 4>(v, idx);
    if constexpr (KP >= 16) tree_level<KP, 8>(v, idx);
    if constexpr (KP >= 32) tree_level<KP, 16>(v, idx);
}

// Frames of time-varying matrices per staged chunk: two chunks of
// TV_CHUNK * KP * KP floats are 16, 32 or 64 KB. Each divides CH, so
// matrix chunks never straddle a log-obs chunk.
template <int KP>
__host__ __device__ constexpr int tv_chunk() {
    return KP == 8 ? 32 : (KP == 16 ? 16 : 8);
}

// Start an asynchronous copy of n contiguous floats into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
    for (int i = lane; i < n; i += KMAX)
        __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
    __pipeline_commit();
}

// KP: the state count K rounded up to 8, 16 or 32; the per-frame max
// over predecessors is a log2(KP)-level tree. TV: log_a is (B, T, K, K).
template <int KP, bool TV>
__global__ void __launch_bounds__(KMAX)
smallk_viterbi_kernel(const float* __restrict__ log_obs,   // (B, T, K)
                      const float* __restrict__ log_a,     // (K, K) or (B, T, K, K)
                      const float* __restrict__ log_pi,    // (K,)
                      const int* __restrict__ lengths,     // (B,)
                      uint8_t* __restrict__ psi_g,         // (B, T, K)
                      int* __restrict__ states,            // (B, T)
                      float* __restrict__ score,           // (B,)
                      int T, int K) {
    __shared__ float lo_s[CH * (KMAX + 1)];
    __shared__ uint8_t psi_s[CH * KMAX];
    __shared__ int st_s[CH];
    extern __shared__ float la_s[];   // TV: two chunks of tv_chunk<KP>() (K, K) frames

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const bool live = lane < K;
    const float* lo = log_obs + static_cast<long long>(b) * T * K;
    uint8_t* psi = psi_g + static_cast<long long>(b) * T * K;
    int* st = states + static_cast<long long>(b) * T;
    const int len = lengths[b];
    // Staged frames sit ks = K | 1 floats apart: an odd stride, so the 32
    // lanes reading one state of 32 frames (the shift pass) hit 32 banks.
    // Element i of a chunk, frame i / K and state i % K, goes to (f, r),
    // stepped along with i.
    const int ks = K | 1;
    const int f0 = lane / K, r0 = lane % K, df = KMAX / K, dr = KMAX % K;

    // Column `lane` of log_a: a_col[k] = log_a[k, lane]. Predecessors
    // k >= K get -inf: they can never win a strict '>' against a real
    // state, and sit to the right of every real one in the tree.
    // In TV mode a_col is reloaded each frame from the staged matrices.
    float a_col[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k)
        a_col[k] = (!TV && live && k < K) ? log_a[k * K + lane] : -INFINITY;
    constexpr int CT = tv_chunk<KP>();
    const int KK = K * K;
    const float* la = TV ? log_a + static_cast<long long>(b) * T * KK : log_a;
    if constexpr (TV) stage(la_s, la, min(CT, T) * KK, lane);

    float delta = 0.f;
    // What this lane took out of the chain: the shifts of its frames of
    // each chunk, and on lane 0 the renormalisers too.
    double removed = 0.0;
    for (int t0 = 0; t0 < T; t0 += CH) {
        const int n = min(CH, T - t0);
        for (int i = lane, f = f0, r = r0; i < n * K; i += KMAX) {
            lo_s[f * ks + r] = lo[static_cast<long long>(t0) * K + i];
            f += df;
            r += dr;
            if (r >= K) {
                r -= K;
                ++f;
            }
        }
        __syncthreads();
        // Lane i shifts frames i and i + 32 of the chunk by their largest
        // score (none where it is not finite: an all -inf frame stays so).
        for (int tf = lane; tf < n; tf += KMAX) {
            float* f = lo_s + tf * ks;
            float m = f[0];
            for (int k = 1; k < K; ++k) m = fmaxf(m, f[k]);
            if (!isfinite(m)) m = 0.f;
            for (int k = 0; k < K; ++k) f[k] -= m;
            const int t = t0 + tf;
            if (t == 0 || t < len) removed += m;
        }
        __syncthreads();
        if (t0 > 0) {
            // Renormalise delta by its largest live lane: lanes 0..KP-1
            // hold every live state, so a KP-wide butterfly reaches lane 0.
            float c = live ? delta : -INFINITY;
#pragma unroll
            for (int off = KP / 2; off > 0; off >>= 1)
                c = fmaxf(c, __shfl_xor_sync(FULL, c, off));
            if (!isfinite(c)) c = 0.f;
            if (live) delta -= c;
            if (lane == 0) removed += c;
        }
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            if constexpr (TV) {
                if (t % CT == 0) {
                    // This chunk's matrices have landed; the other buffer
                    // (read by every lane in the chunk before) takes the
                    // next chunk's.
                    __pipeline_wait_prior(0);
                    __syncwarp();
                    const int nt = t + CT;
                    if (nt < T)
                        stage(la_s + (((t / CT) & 1) ^ 1) * CT * KK,
                              la + static_cast<long long>(nt) * KK, min(CT, T - nt) * KK, lane);
                }
            }
            const float o = live ? lo_s[tf * ks + lane] : 0.f;
            if (t == 0) {
                delta = live ? log_pi[lane] + o : 0.f;
                continue;
            }
            if constexpr (TV) {
                // Column `lane` of log_a[b, t].
                const float* m = la_s + (((t / CT) & 1) * CT + t % CT) * KK + lane;
#pragma unroll
                for (int k = 0; k < KP; ++k) a_col[k] = (live && k < K) ? m[k * K] : -INFINITY;
            }
            float v[KP];
            int idx[KP];
#pragma unroll
            for (int k = 0; k < KP; ++k) {
                v[k] = __shfl_sync(FULL, delta, k) + a_col[k];
                idx[k] = k;
            }
            tree_argmax<KP>(v, idx);
            const float best = v[0];
            const int arg = idx[0];
            const bool keep = t < len;
            if (keep) delta = best + o;
            if (live)
                psi[static_cast<long long>(t) * K + lane] =
                    static_cast<uint8_t>(keep ? arg : lane);
        }
        __syncthreads();
    }

    // Score and the lowest-index argmax of the final delta.
    float best = __shfl_sync(FULL, delta, 0);
    int s = 0;
    for (int k = 1; k < K; ++k) {
        const float v = __shfl_sync(FULL, delta, k);
        if (v > best) {
            best = v;
            s = k;
        }
    }
#pragma unroll
    for (int off = KMAX / 2; off > 0; off >>= 1)
        removed += __shfl_down_sync(FULL, removed, off);
    if (lane == 0) score[b] = static_cast<float>(static_cast<double>(best) + removed);

    // Backtrace, newest chunk first. The chunk grid is the trellis's, so
    // the last chunk may be short.
    const int last0 = ((T - 1) / CH) * CH;
    for (int t0 = last0; t0 >= 0; t0 -= CH) {
        const int n = min(CH, T - t0);
        for (int i = lane; i < n * K; i += KMAX)
            psi_s[i] = psi[static_cast<long long>(t0) * K + i];
        __syncthreads();
        if (lane == 0) {
            for (int tf = n - 1; tf >= 0; --tf) {
                st_s[tf] = s;
                if (t0 + tf > 0) s = psi_s[tf * K + s];
            }
        }
        __syncthreads();
        for (int i = lane; i < n; i += KMAX) st[t0 + i] = st_s[i];
        __syncthreads();
    }
}

}  // namespace

// log_obs (B, T, K), log_a (K, K), log_pi (K,) float32; lengths (B,)
// int32; psi (B, T, K) uint8 scratch; states (B, T) int32 and score (B,)
// float32 out. All contiguous, on `device`; 1 <= K <= 32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int smallk_viterbi_f32(const float* log_obs, const float* log_a,
                                  const float* log_pi, const int* lengths,
                                  uint8_t* psi, int* states, float* score,
                                  int B, int T, int K, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 8)
        smallk_viterbi_kernel<8, false><<<B, KMAX, 0, st>>>(
            log_obs, log_a, log_pi, lengths, psi, states, score, T, K);
    else if (K <= 16)
        smallk_viterbi_kernel<16, false><<<B, KMAX, 0, st>>>(
            log_obs, log_a, log_pi, lengths, psi, states, score, T, K);
    else
        smallk_viterbi_kernel<32, false><<<B, KMAX, 0, st>>>(
            log_obs, log_a, log_pi, lengths, psi, states, score, T, K);
    return static_cast<int>(cudaGetLastError());
}

namespace {

template <int KP>
cudaError_t launch_tv(const float* log_obs, const float* log_a, const float* log_pi,
                      const int* lengths, uint8_t* psi, int* states, float* score,
                      int B, int T, int K, cudaStream_t st) {
    const int bytes = 2 * tv_chunk<KP>() * K * K * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(smallk_viterbi_kernel<KP, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    smallk_viterbi_kernel<KP, true><<<B, KMAX, bytes, st>>>(
        log_obs, log_a, log_pi, lengths, psi, states, score, T, K);
    return cudaGetLastError();
}

}  // namespace

// The time-varying mode: as smallk_viterbi_f32, with log_a (B, T, K, K).
extern "C" int smallk_viterbi_tv_f32(const float* log_obs, const float* log_a,
                                     const float* log_pi, const int* lengths,
                                     uint8_t* psi, int* states, float* score,
                                     int B, int T, int K, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 8)
        err = launch_tv<8>(log_obs, log_a, log_pi, lengths, psi, states, score, B, T, K, st);
    else if (K <= 16)
        err = launch_tv<16>(log_obs, log_a, log_pi, lengths, psi, states, score, B, T, K, st);
    else
        err = launch_tv<32>(log_obs, log_a, log_pi, lengths, psi, states, score, B, T, K, st);
    return static_cast<int>(err);
}
