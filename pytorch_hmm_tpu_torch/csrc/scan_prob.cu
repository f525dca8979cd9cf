// Long-sequence forward, backward and fused forward-backward chains of an
// HMM with up to 128 states, in scaled probability space (static (K, K)
// transitions, no lengths), one launch each.
//
// Replaces the TPU kernels of pytorch_hmm_tpu/ops/scan.py:
//   * pallas_forward_prob  (_forward_prob_kernel),
//   * pallas_backward_prob (_backward_prob_kernel),
//   * pallas_fb_prob       (_fb_prob_kernel), both chains in one pass.
// Per sequence, with m_t = max(max_k lo_t[k], -1e30), e_t = exp(lo_t - m_t)
// and P = exp(log_a) (computed by the caller):
//   forward:  q_0 = pi * e_0,  q_t = (q_{t-1} @ P) * e_t;
//   backward: q = 1 above T - 1;  s_t = q @ P^T is stored, then q = s_t * e_t.
// Every rs frames, at frames aligned to multiples of rs (t % rs == 0 going
// up, (t + 1) % rs == 0 going down), the carried q is divided by
// r = max(max_k q, 1e-37) before its product, and C += log r. Then
//   log alpha_t = log(max(q_t, 1e-37)) + C_t + sum_{u <= t} m_u,
//   log beta_t  = log(max(s_t, 1e-37)) + C_t + sum_{u > t} m_u,
// with C_t the sum of the rescales made on the way to frame t. C is carried
// in double: it adds T / rs + T / 64 terms and reaches |log alpha| (~2.5e5
// at T = 131072 on raw emissions), where float32 sums would drift by tens
// of ulps; in double each frame's shift is rounded to float32 once. The kernels
// write each table split from its per-frame shift (C_t plus the m sum):
// the relative rows keep one frame's magnitude however long the sequence,
// so posteriors normalized per frame keep float32 precision, and the
// caller adds the shifts for the tables and takes log Z from the last row.
//
// What bounds it on an H100: the serial chain of T frames per sequence.
// At B = 32, T = 131072, K = 64 the bytes are 1.07 GB a table (~0.32 ms
// each at 3.35 TB/s) and the products 2 B T K^2 = 34 GFLOP a chain (~0.5 ms
// at 67 TFLOP/s), but each frame's product needs the frame before. The
// log-space kernels of scan_bigk.cu take a max, an exp, a K-long sum and a
// log on every frame with three block barriers between them; here only
// the K-long dot and one multiply stay on the chain, and the exp, the max
// of the emissions, the prefix sums of m and the log run as passes over a
// whole chunk of frames, off it.
//
// Design: one block per chain; time is a loop inside the block. Thread
// (col, sl) of the block's 4 * KP threads (KP = K rounded up to a power of
// two, at least 16) owns output column col and the sl-th quarter of its
// K-long sum, with that quarter of P's column (forward) or row (backward)
// in registers. The carried q sits in shared memory, double buffered and
// swizzled so that the four quarters' 16-byte loads fall on distinct
// banks; the quarters meet by two xor-shuffles, so a frame costs one block
// barrier. The same loads give the rescale's max over K (the four
// quarters cover every state), so the rescale needs no extra barrier.
// Log-obs arrive 64 frames at a time with cp.async into a double buffer,
// the next chunk's copy running behind the current chunk's passes. A
// pre-pass turns a chunk into e_t in place and scans its m (prefix sums
// going up, suffix sums going down); the chain overwrites each e_t with
// the q_t (or s_t) it produced, as the TPU kernel stages outputs over dead
// input rows; a post-pass takes the logs, adds the shifts and writes the
// chunk's rows, coalesced. The fused kernel is one launch of 2B blocks,
// the forward chains and the backward chains: they are independent, and
// where the TPU's sequential grid had to interleave them in one program
// for the second to ride the first's latency, the H100 runs them side by
// side on separate SMs (64 of 132 at B = 32).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TC = 64;                // frames staged per chunk
constexpr int LPC = 4;                // threads per column: quarters of the sum
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;         // the TPU kernels' _NEG
constexpr float FLOOR = 1e-37f;       // the rescale and log floor

// Shared memory of one chain, in floats: two chunk slots of TC x KP
// (log-obs, then e_t, then the chain's outputs), two carried q vectors,
// and per frame m, its scan, and C.
template <int KP>
__host__ __device__ constexpr int chain_floats() {
    return 2 * TC * KP + 2 * KP + 3 * TC;
}

// One chain's shared memory. Every buffer is addressed by arithmetic
// on these pointers, so no array of pointers is indexed at run time (that
// would put the struct in local memory, on the chain's path).
struct Chain {
    float* slots;     // two (TC, KP) chunk slots
    float* q;         // two (KP) carried vectors, swizzled
    float* m;         // (TC) per-frame max
    float* scan;      // (TC) inclusive prefix (forward) or suffix (backward) sum of m
    float* crec;      // (TC) C of each frame
};

template <int KP>
__device__ Chain carve(float* base) {
    Chain c;
    c.slots = base;
    c.q = base + 2 * TC * KP;
    c.m = c.q + 2 * KP;
    c.scan = c.m + TC;
    c.crec = c.scan + TC;
    return c;
}

// Position of state i in a swizzled q vector: quarter sl = i / SL reads
// its v-th float4 at float4 index v * LPC + sl, so one load instruction
// of the four quarters touches 16 consecutive floats.
template <int KP>
__device__ __forceinline__ int qpos(int i) {
    constexpr int SL = KP / LPC;
    return ((i % SL) / 4 * LPC + i / SL) * 4 + (i & 3);
}

// Copy frames [t0, t0 + n) of one sequence's (T, K) log-obs into a
// (TC, KP) slot, 4 bytes per asynchronous copy (any K).
__device__ __forceinline__ void stage_chunk(float* dst, const float* lo, int t0, int n, int K,
                                            int KP) {
    const float* src = lo + static_cast<long long>(t0) * K;
    for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) {
        const int f = idx / K;
        __pipeline_memcpy_async(dst + f * KP + (idx - f * K), src + idx, sizeof(float));
    }
}

// Each frame's m into c.m and its row into e = exp(lo - m), 0 on the
// padded states; one warp per frame.
template <int KP>
__device__ void prepass(const Chain& c, float* e, int n, int K) {
    const int lane = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    for (int f = threadIdx.x >> 5; f < n; f += nw) {
        float* row = e + f * KP;
        float v[(KP + 31) / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < (KP + 31) / 32; ++r) {
            const int k = lane + 32 * r;
            v[r] = k < K ? row[k] : -INFINITY;
            mx = fmaxf(mx, v[r]);
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m = fmaxf(mx, NEG);
#pragma unroll
        for (int r = 0; r < (KP + 31) / 32; ++r) {
            const int k = lane + 32 * r;
            if (k < KP) row[k] = k < K ? expf(v[r] - m) : 0.f;
        }
        if (lane == 0) c.m[f] = m;
    }
}

// Inclusive scan of m[0..n), n <= 64, by one warp: prefix sums, or with
// REVERSE suffix sums (out[f] = sum of m[f..n)).
template <bool REVERSE>
__device__ void scan_m(const float* m, float* out, int n) {
    const int lane = threadIdx.x & 31;
    const int i0 = 2 * lane, i1 = 2 * lane + 1;
    const float a = i0 < n ? m[REVERSE ? n - 1 - i0 : i0] : 0.f;
    const float b = i1 < n ? m[REVERSE ? n - 1 - i1 : i1] : 0.f;
    float s = a + b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += y;
    }
    float excl = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) excl = 0.f;
    if (i0 < n) out[REVERSE ? n - 1 - i0 : i0] = excl + a;
    if (i1 < n) out[REVERSE ? n - 1 - i1 : i1] = (excl + a) + b;
}

// Thread (col, sl)'s quarter of a carried q vector.
template <int KP>
__device__ __forceinline__ void load_q(const float* q, int sl, float4 (&x)[KP / LPC / 4]) {
    const float4* qv = reinterpret_cast<const float4*>(q);
#pragma unroll
    for (int v = 0; v < KP / LPC / 4; ++v) x[v] = qv[v * LPC + sl];
}

// Divide a carried q (held as its four quarters by the four threads of a
// column) by r = max(max q, 1e-37), and add log r to C.
template <int KP>
__device__ __forceinline__ void rescale(float4 (&x)[KP / LPC / 4], double& C) {
    float mx = 0.f;
#pragma unroll
    for (int v = 0; v < KP / LPC / 4; ++v)
        mx = fmaxf(mx, fmaxf(fmaxf(x[v].x, x[v].y), fmaxf(x[v].z, x[v].w)));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float r = fmaxf(mx, FLOOR);
    const float inv = 1.f / r;
    C += logf(r);
#pragma unroll
    for (int v = 0; v < KP / LPC / 4; ++v) {
        x[v].x *= inv;
        x[v].y *= inv;
        x[v].z *= inv;
        x[v].w *= inv;
    }
}

// The quarter's part of q @ M (M's quarter in p), four independent
// accumulators keeping four products in flight.
template <int KP>
__device__ __forceinline__ float quarter_dot(const float4 (&x)[KP / LPC / 4],
                                             const float (&p)[KP / LPC]) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int v = 0; v < KP / LPC / 4; ++v) {
        a0 = fmaf(x[v].x, p[4 * v], a0);
        a1 = fmaf(x[v].y, p[4 * v + 1], a1);
        a2 = fmaf(x[v].z, p[4 * v + 2], a2);
        a3 = fmaf(x[v].w, p[4 * v + 3], a3);
    }
    return (a0 + a1) + (a2 + a3);
}

// Rows of a finished chunk to device memory, split from their shifts:
// out[t0 + f, k] = log(max(x, 1e-37)) and shift_out[t0 + f] = crec[f] +
// scan[f] (forward) or crec[f] + (scan[f] - m[f]) (backward).
template <bool BACKWARD>
__device__ void postpass(const Chain& c, const float* x, float* out, float* shift_out, int t0,
                         int n, int K, int KP) {
    float* o = out + static_cast<long long>(t0) * K;
    for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) {
        const int f = idx / K;
        o[idx] = logf(fmaxf(x[f * KP + (idx - f * K)], FLOOR));
    }
    for (int f = threadIdx.x; f < n; f += blockDim.x)
        shift_out[t0 + f] = BACKWARD ? c.crec[f] + (c.scan[f] - c.m[f]) : c.crec[f] + c.scan[f];
}

// One chain of one sequence, run by the whole block: the forward chain
// writes alpha (B, T, K) rows, the backward chain beta rows.
template <int KP, bool BACKWARD>
__device__ void run_chain(float* smem, const float* lo, const float* pa, const float* log_pi,
                          float* out, float* shift_out, int T, int K, int rs) {
    constexpr int SL = KP / LPC;
    const Chain c = carve<KP>(smem);
    const int tid = threadIdx.x;
    const int col = tid / LPC;
    const int sl = tid % LPC;

    // Quarter sl of P's column col (forward: q @ P) or of its row col
    // (backward: q @ P^T), zero outside K.
    float p[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
        const int r = sl * SL + i;
        p[i] = r < K && col < K ? (BACKWARD ? pa[col * K + r] : pa[r * K + col]) : 0.f;
    }
    const float pi_col = !BACKWARD && col < K ? expf(log_pi[col]) : 0.f;
    const int my_q = qpos<KP>(col);
    if (sl == 0) c.q[my_q] = BACKWARD && col < K ? 1.f : 0.f;

    // Chunks in the chain's order; `cur` picks the carried q buffer.
    const int nch = (T + TC - 1) / TC;
    auto chunk = [&](int j) { return BACKWARD ? nch - 1 - j : j; };
    auto rows = [&](int ck) { return min(TC, T - ck * TC); };
    stage_chunk(c.slots, lo, chunk(0) * TC, rows(chunk(0)), K, KP);
    __pipeline_commit();
    double C = 0.0;
    int cur = 0;
    for (int j = 0; j < nch; ++j) {
        const int ck = chunk(j), t0 = ck * TC, n = rows(ck);
        const int off = (j & 1) * TC * KP;
        if (j + 1 < nch) {
            const int nk = chunk(j + 1);
            stage_chunk(c.slots + (TC * KP - off), lo, nk * TC, rows(nk), K, KP);
            __pipeline_commit();
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        float* e = c.slots + off;
        prepass<KP>(c, e, n, K);
        __syncthreads();
        if ((tid >> 5) == 0) scan_m<BACKWARD>(c.m, c.scan, n);

        // The frame's phase in the rescale interval: the forward rescales
        // at t % rs == 0, the backward at (t + 1) % rs == 0.
        int ph = (BACKWARD ? t0 + n : t0) % rs;
        for (int i = 0; i < n; ++i) {
            const int f = BACKWARD ? n - 1 - i : i;
            const int t = t0 + f;
            float4 x[SL / 4];
            load_q<KP>(c.q + cur * KP, sl, x);
            if (ph == 0 && (BACKWARD ? t + 1 < T : t > 0)) rescale<KP>(x, C);
            float s = quarter_dot<KP>(x, p);
            s += __shfl_xor_sync(FULL, s, 1);
            s += __shfl_xor_sync(FULL, s, 2);
            float* ep = e + f * KP + col;
            // Forward: q_t = s * e_t is carried and staged. Backward: s_t is
            // staged and s_t * e_t carried.
            const float staged = BACKWARD ? s : (t == 0 ? pi_col : s) * *ep;
            const float carried = BACKWARD ? s * *ep : staged;
            cur ^= 1;
            if (sl == 0) {
                c.q[cur * KP + my_q] = carried;
                *ep = staged;
            }
            if (tid == 0) c.crec[f] = static_cast<float>(C);
            ph = BACKWARD ? (ph == 0 ? rs - 1 : ph - 1) : (ph + 1 == rs ? 0 : ph + 1);
            __syncthreads();
        }
        postpass<BACKWARD>(c, e, out, shift_out, t0, n, K, KP);
        C += BACKWARD ? c.scan[0] : c.scan[n - 1];
        __syncthreads();
    }
}

// The outputs of one launch: the relative tables and their per-frame
// shifts, null for the chain a launch does not run.
struct Out {
    float* alpha;         // (B, T, K)
    float* beta;          // (B, T, K)
    float* alpha_shift;   // (B, T)
    float* beta_shift;    // (B, T)
};

// Block x runs the forward chain of sequence x, or with BOTH the backward
// chain of sequence x - B for x >= B: one launch of 2B independent blocks.
template <int KP, bool FWD, bool BOTH>
__global__ void __launch_bounds__(KP* LPC)
prob_chain_kernel(const float* __restrict__ log_obs,   // (B, T, K)
                  const float* __restrict__ pa,        // (K, K) exp(log_a)
                  const float* __restrict__ log_pi,    // (K,), forward only
                  Out out, int B, int T, int K, int rs) {
    extern __shared__ __align__(16) float smem[];
    const bool forward = BOTH ? blockIdx.x < B : FWD;
    const int b = BOTH && !forward ? blockIdx.x - B : blockIdx.x;
    const long long base = static_cast<long long>(b) * T * K;
    const long long frames = static_cast<long long>(b) * T;
    if (forward)
        run_chain<KP, false>(smem, log_obs + base, pa, log_pi, out.alpha + base,
                             out.alpha_shift + frames, T, K, rs);
    else
        run_chain<KP, true>(smem, log_obs + base, pa, nullptr, out.beta + base,
                            out.beta_shift + frames, T, K, rs);
}

template <int KP, bool FWD, bool BOTH>
cudaError_t launch_kp(const float* log_obs, const float* pa, const float* log_pi, Out out, int B,
                      int T, int K, int rs, cudaStream_t st) {
    const size_t bytes = sizeof(float) * chain_floats<KP>();
    auto kernel = prob_chain_kernel<KP, FWD, BOTH>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<BOTH ? 2 * B : B, KP * LPC, bytes, st>>>(log_obs, pa, log_pi, out, B, T, K, rs);
    return cudaGetLastError();
}

template <bool FWD, bool BOTH>
int launch(const float* log_obs, const float* pa, const float* log_pi, Out out, int B, int T,
           int K, int rs, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (K < 1 || K > 128 || rs < 1 || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 16) err = launch_kp<16, FWD, BOTH>(log_obs, pa, log_pi, out, B, T, K, rs, st);
    else if (K <= 32) err = launch_kp<32, FWD, BOTH>(log_obs, pa, log_pi, out, B, T, K, rs, st);
    else if (K <= 64) err = launch_kp<64, FWD, BOTH>(log_obs, pa, log_pi, out, B, T, K, rs, st);
    else err = launch_kp<128, FWD, BOTH>(log_obs, pa, log_pi, out, B, T, K, rs, st);
    return static_cast<int>(err);
}

}  // namespace

// log_obs (B, T, K), pa = exp(log_a) (K, K), log_pi (K,) float32 in;
// alpha (B, T, K) and alpha_shift (B, T) float32 out, log alpha = alpha +
// alpha_shift. All contiguous, on `device`; 1 <= K <= 128, rs >= 1.
// Launches on `stream`, returns a CUDA error code.
extern "C" int scan_prob_forward_f32(const float* log_obs, const float* pa, const float* log_pi,
                                     float* alpha, float* alpha_shift, int B, int T, int K,
                                     int rs, int device, void* stream) {
    return launch<true, false>(log_obs, pa, log_pi, Out{alpha, nullptr, alpha_shift, nullptr}, B,
                               T, K, rs, device, stream);
}

// As scan_prob_forward_f32, with beta and beta_shift out and no log_pi.
extern "C" int scan_prob_backward_f32(const float* log_obs, const float* pa, float* beta,
                                      float* beta_shift, int B, int T, int K, int rs, int device,
                                      void* stream) {
    return launch<false, false>(log_obs, pa, nullptr, Out{nullptr, beta, nullptr, beta_shift}, B,
                                T, K, rs, device, stream);
}

// Both chains in one launch of 2B blocks: alpha, alpha_shift, beta and
// beta_shift out.
extern "C" int scan_prob_fb_f32(const float* log_obs, const float* pa, const float* log_pi,
                                float* alpha, float* beta, float* alpha_shift, float* beta_shift,
                                int B, int T, int K, int rs, int device, void* stream) {
    return launch<true, true>(log_obs, pa, log_pi, Out{alpha, beta, alpha_shift, beta_shift}, B, T,
                              K, rs, device, stream);
}
