// The banded CTC lattice: forward (alpha), backward (beta) and Viterbi
// (forced alignment) chains over the 2U+1 blank-interleaved label lattice,
// one launch each.
//
// Replaces the TPU kernels of pytorch_hmm_tpu/ops/ctc_kernel.py:
//   * ctc_lattice_forward  (_ctc_fwd_kernel, _ctc_fwd_wide_kernel and
//     _ctc_fwd_wide_packed_kernel, three layouts of one function):
//       alpha_0 = a0 where lengths[b] > 0, else -1e30;
//       alpha_t[s] = (lp_t[s] + lse3(alpha[s], alpha[s-1], alpha[s-2] + skip_add[s])) + vmask[s]
//     for t < lengths[b]; later frames repeat the row before.
//   * ctc_lattice_backward (_ctc_bwd_kernel and its two wide layouts):
//       m = beta_{t+1} + lp_{t+1}
//       beta_t[s] = lse3(m[s], m[s+1], m[s+2] + skip_fwd[s]) + vmask[s]
//     for t + 1 < lengths[b]; the other frames hold the terminal row bT.
//   * ctc_lattice_viterbi (_ctc_vit_kernel) and ctc_lattice_viterbi_wide
//     (_ctc_vit_wide_fwd_kernel + _ctc_vit_wide_bt_kernel): the same
//     trellis with max for lse3, best = max(max(d, adv), skip) and the
//     choice 0 / 1 / 2 (stay > advance > skip on exact ties) stored per
//     frame and position; the end position is end1 iff its score >= end2's,
//     and the walk back gives each frame's lattice position. Frames at or
//     past lengths[b] keep their delta and step back by 0.
// lse3(a, b, c) = m + log((exp(a - m) + exp(b - m)) + exp(c - m)), m the
// max, in the TPU kernels' order; positions outside the lattice read -1e30.
//
// What bounds it on an H100: the serial chain of T frames per sequence.
// At B=16, T=500, S=101 the bytes are 3.2 MB a table (~2 us at 3.35 TB/s)
// and the operations ~0.1 GFLOP (~2 us at 67 TFLOP/s); at B=4, T=2048,
// S=2001 the emissions are 65.6 MB (~40 us). Each frame needs the frame
// before, and each position its two lower (forward) or upper (backward)
// neighbours, so a frame costs one exchange between threads, three exps
// and a log on the chain. Measured by chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W: forward / backward 0.30 / 0.22 ms at B=16, T=500,
// S=101 (0.4-0.6 us a frame) and 1.9 / 2.0 ms at B=4, T=2048, S=2001;
// Viterbi 0.24 ms resident at S=101, 1.5 ms streamed at S=2001.
//
// Design: one block per sequence, time a loop inside the block. Thread i
// owns the lattice positions 2i and 2i + 1 (S <= 2048: at most 1024
// threads) and keeps their values, masks and the next frame's emissions in
// registers (the emission load is issued a frame ahead, off the chain).
// The neighbours come from the thread before (forward) or after (backward)
// by one warp shuffle; the warp's edge thread leaves its pair in shared
// memory, double buffered by frame parity, so a frame costs one block
// barrier. Each frame's row goes out as consecutive floats. Threads past
// the lattice hold -1e30. The TPU kernels' VMEM-driven variants (lane
// tiles up to S=512, wide packed, wide per row) are one layout here.
//
// The Viterbi keeps its choices as bytes: resident in dynamic shared
// memory (T * S bytes, 50.5 KB at T=500, S=101) when a sequence's table
// fits (row 22), else in a (B, T, S) byte buffer in device memory (row 23,
// any T: 16.4 MB at B=4, T=2048, S=2001). The walk back is a serial chain
// of dependent loads run by one thread in the same launch. For the
// streamed table it runs over chunks of CH frames: the position moves down
// at most 2 a frame, so a chunk only needs the window [p - 2(CH - 1), p]
// of each of its frames (p the position at the chunk's newest frame); the
// whole block stages that window into shared memory, coalesced, and the
// walk reads it there instead of paying device-memory latency per frame.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_S = 2048;
constexpr int MAX_THREADS = MAX_S / 2;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;          // the TPU kernels' _NEG
constexpr int CH = 128;                // frames per staged chunk of the streamed walk
constexpr int WIN = 2 * CH - 1;        // positions per staged frame

__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float m = fmaxf(fmaxf(a, b), c);
    return m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
}

// One sequence's lattice as this thread sees it: positions s0 and s0 + 1.
struct Pair {
    int s0;
    bool v0, v1;   // inside the lattice
};

__device__ __forceinline__ Pair pair_of(int S) {
    Pair p;
    p.s0 = 2 * threadIdx.x;
    p.v0 = p.s0 < S;
    p.v1 = p.s0 + 1 < S;
    return p;
}

// Two values of a (B, S) or (T, S) row at the thread's positions, `fill`
// outside the lattice.
__device__ __forceinline__ void load2(const float* row, const Pair& p, float fill, float& x0,
                                      float& x1) {
    x0 = p.v0 ? row[p.s0] : fill;
    x1 = p.v1 ? row[p.s0 + 1] : fill;
}

__device__ __forceinline__ void store2(float* row, const Pair& p, float x0, float x1) {
    if (p.v0) row[p.s0] = x0;
    if (p.v1) row[p.s0 + 1] = x1;
}

// The pair of the thread before (positions s0 - 2 and s0 - 1), -1e30 below
// position 0. One block barrier; `edge` is double buffered by `par`.
__device__ __forceinline__ void from_below(float x0, float x1, float2 (*edge)[MAX_WARPS], int par,
                                           float& m2, float& m1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 31) edge[par][warp] = make_float2(x0, x1);
    m2 = __shfl_up_sync(FULL, x0, 1);
    m1 = __shfl_up_sync(FULL, x1, 1);
    __syncthreads();
    if (lane == 0) {
        const float2 e = warp > 0 ? edge[par][warp - 1] : make_float2(NEG, NEG);
        m2 = e.x;
        m1 = e.y;
    }
}

// The pair of the thread after (positions s0 + 2 and s0 + 3), -1e30 past
// the block's last thread (whose positions lie past the lattice's end).
__device__ __forceinline__ void from_above(float x0, float x1, float2 (*edge)[MAX_WARPS], int par,
                                           float& p2, float& p3) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) edge[par][warp] = make_float2(x0, x1);
    p2 = __shfl_down_sync(FULL, x0, 1);
    p3 = __shfl_down_sync(FULL, x1, 1);
    __syncthreads();
    if (lane == 31) {
        const float2 e =
            warp + 1 < static_cast<int>(blockDim.x >> 5) ? edge[par][warp + 1] : make_float2(NEG, NEG);
        p2 = e.x;
        p3 = e.y;
    }
}

__device__ __forceinline__ int row_length(const int* lengths, int T) {
    const int len = lengths[blockIdx.x];
    return len < 0 ? 0 : (len > T ? T : len);
}

__global__ void __launch_bounds__(MAX_THREADS)
ctc_forward_kernel(const float* __restrict__ lp,        // (B, T, S)
                   const float* __restrict__ skip_add,  // (B, S)
                   const float* __restrict__ vmask,     // (B, S)
                   const float* __restrict__ a0,        // (B, S)
                   const int* __restrict__ lengths,     // (B,)
                   float* __restrict__ alpha,           // (B, T, S)
                   int T, int S) {
    __shared__ float2 edge[2][MAX_WARPS];
    const Pair p = pair_of(S);
    const long long row = static_cast<long long>(blockIdx.x) * S;
    const float* lpb = lp + row * T;
    float* out = alpha + row * T;
    const int len = row_length(lengths, T);
    float sk0, sk1, vm0, vm1, x0, x1;
    load2(skip_add + row, p, NEG, sk0, sk1);
    load2(vmask + row, p, NEG, vm0, vm1);
    load2(a0 + row, p, NEG, x0, x1);
    if (len == 0) x0 = x1 = NEG;
    store2(out, p, x0, x1);
    float l0 = 0.f, l1 = 0.f;
    if (len > 1) load2(lpb + S, p, 0.f, l0, l1);
    for (int t = 1; t < len; ++t) {
        const float c0 = l0, c1 = l1;
        if (t + 1 < len) load2(lpb + static_cast<long long>(t + 1) * S, p, 0.f, l0, l1);
        float m2, m1;
        from_below(x0, x1, edge, t & 1, m2, m1);
        const float n0 = (c0 + lse3(x0, m1, m2 + sk0)) + vm0;
        const float n1 = (c1 + lse3(x1, x0, m1 + sk1)) + vm1;
        x0 = p.v0 ? n0 : NEG;
        x1 = p.v1 ? n1 : NEG;
        store2(out + static_cast<long long>(t) * S, p, x0, x1);
    }
    for (int t = len > 1 ? len : 1; t < T; ++t) store2(out + static_cast<long long>(t) * S, p, x0, x1);
}

__global__ void __launch_bounds__(MAX_THREADS)
ctc_backward_kernel(const float* __restrict__ lp,        // (B, T, S)
                    const float* __restrict__ skip_fwd,  // (B, S)
                    const float* __restrict__ vmask,     // (B, S)
                    const float* __restrict__ bT,        // (B, S)
                    const int* __restrict__ lengths,     // (B,)
                    float* __restrict__ beta,            // (B, T, S)
                    int T, int S) {
    __shared__ float2 edge[2][MAX_WARPS];
    const Pair p = pair_of(S);
    const long long row = static_cast<long long>(blockIdx.x) * S;
    const float* lpb = lp + row * T;
    float* out = beta + row * T;
    const int len = row_length(lengths, T);
    float sk0, sk1, vm0, vm1, e0, e1;
    load2(skip_fwd + row, p, NEG, sk0, sk1);
    load2(vmask + row, p, NEG, vm0, vm1);
    load2(bT + row, p, NEG, e0, e1);
    // Frames whose successor is at or past the row's end hold bT.
    for (int t = len > 0 ? len - 1 : 0; t < T; ++t)
        store2(out + static_cast<long long>(t) * S, p, e0, e1);
    float x0 = e0, x1 = e1;
    float l0 = 0.f, l1 = 0.f;
    if (len > 1) load2(lpb + static_cast<long long>(len - 1) * S, p, 0.f, l0, l1);
    for (int t = len - 2; t >= 0; --t) {
        const float m0 = p.v0 ? x0 + l0 : NEG;
        const float m1 = p.v1 ? x1 + l1 : NEG;
        if (t > 0) load2(lpb + static_cast<long long>(t) * S, p, 0.f, l0, l1);
        float q2, q3;
        from_above(m0, m1, edge, t & 1, q2, q3);
        const float n0 = lse3(m0, m1, q2 + sk0) + vm0;
        const float n1 = lse3(m1, q2, q3 + sk1) + vm1;
        x0 = p.v0 ? n0 : NEG;
        x1 = p.v1 ? n1 : NEG;
        store2(out + static_cast<long long>(t) * S, p, x0, x1);
    }
}

// Max and choice at one position: stay d, advance adv, skip sk.
__device__ __forceinline__ float best3(float d, float adv, float sk, uint8_t& choice) {
    const float best = fmaxf(fmaxf(d, adv), sk);
    choice = best == d ? 0 : (best == adv ? 1 : 2);
    return best;
}

// RESIDENT: the choices in dynamic shared memory (T * S bytes); otherwise
// in `choices` (B, T, S) in device memory, and the dynamic shared memory
// holds the walk's staged windows (CH * WIN bytes).
template <bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
ctc_viterbi_kernel(const float* __restrict__ lp,        // (B, T, S)
                   const float* __restrict__ skip_add,  // (B, S)
                   const float* __restrict__ vmask,     // (B, S)
                   const float* __restrict__ a0,        // (B, S)
                   const int* __restrict__ lengths,     // (B,)
                   const int* __restrict__ end1,        // (B,)
                   const int* __restrict__ end2,        // (B,)
                   uint8_t* __restrict__ choices,       // (B, T, S), streamed only
                   int* __restrict__ positions,         // (B, T)
                   float* __restrict__ score,           // (B,)
                   int T, int S) {
    extern __shared__ __align__(16) uint8_t dyn[];
    __shared__ float2 edge[2][MAX_WARPS];
    __shared__ float dfin[MAX_S];
    __shared__ int pos_s;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const Pair p = pair_of(S);
    const long long row = static_cast<long long>(b) * S;
    const float* lpb = lp + row * T;
    uint8_t* ch = RESIDENT ? dyn : choices + row * T;
    int* pos_out = positions + static_cast<long long>(b) * T;
    const int len = row_length(lengths, T);
    float sk0, sk1, vm0, vm1, d0, d1;
    load2(skip_add + row, p, NEG, sk0, sk1);
    load2(vmask + row, p, NEG, vm0, vm1);
    load2(a0 + row, p, NEG, d0, d1);
    float l0 = 0.f, l1 = 0.f;
    if (len > 1) load2(lpb + S, p, 0.f, l0, l1);
    for (int t = 1; t < len; ++t) {
        const float c0 = l0, c1 = l1;
        if (t + 1 < len) load2(lpb + static_cast<long long>(t + 1) * S, p, 0.f, l0, l1);
        float m2, m1;
        from_below(d0, d1, edge, t & 1, m2, m1);
        uint8_t k0, k1;
        const float n0 = (c0 + best3(d0, m1, m2 + sk0, k0)) + vm0;
        const float n1 = (c1 + best3(d1, d0, m1 + sk1, k1)) + vm1;
        uint8_t* chr = ch + static_cast<long long>(t) * S;
        if (p.v0) chr[p.s0] = k0;
        if (p.v1) chr[p.s0 + 1] = k1;
        d0 = p.v0 ? n0 : NEG;
        d1 = p.v1 ? n1 : NEG;
    }
    if (p.v0) dfin[p.s0] = d0;
    if (p.v1) dfin[p.s0 + 1] = d1;
    // Also makes this block's choices visible to the walking thread.
    __syncthreads();
    if (tid == 0) {
        const int e1 = min(max(end1[b], 0), S - 1), e2 = min(max(end2[b], 0), S - 1);
        const float v1 = dfin[e1], v2 = dfin[e2];
        const int last = v1 >= v2 ? e1 : e2;
        score[b] = fmaxf(v1, v2);
        pos_out[T - 1] = last;
        pos_s = last;
    }
    // Frame t's choice gives the position at t - 1; frames t >= len step
    // back by 0. A step below position 0 (only on paths of -1e30 scores)
    // stops at 0.
    if constexpr (RESIDENT) {
        if (tid == 0) {
            int q = pos_s;
            for (int t = T - 1; t >= 1; --t) {
                if (t < len) q = max(q - ch[static_cast<long long>(t) * S + q], 0);
                pos_out[t - 1] = q;
            }
        }
    } else {
        __syncthreads();
        for (int t1 = T - 1; t1 >= 1; t1 -= CH) {
            const int pos = pos_s;
            const int n = min(CH, t1);           // frames t1, t1 - 1, ..., t1 - n + 1
            const int lo = max(pos - 2 * (n - 1), 0);
            for (int i = tid; i < n * WIN; i += blockDim.x) {
                const int f = i / WIN;
                const int t = t1 - f;
                const int s = lo + (i - f * WIN);
                dyn[i] = t < len && s < S ? ch[static_cast<long long>(t) * S + s] : 0;
            }
            __syncthreads();
            if (tid == 0) {
                int q = pos;
                for (int f = 0; f < n; ++f) {
                    q = max(q - dyn[f * WIN + (q - lo)], 0);
                    pos_out[t1 - f - 1] = q;
                }
                pos_s = q;
            }
            __syncthreads();
        }
    }
}

int threads_for(int S) {
    const int pairs = (S + 1) / 2;
    return (pairs + 31) / 32 * 32;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

cudaError_t check_shape(int device, int B, int T, int S) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (B < 1 || T < 1 || S < 1 || S > MAX_S) return cudaErrorInvalidValue;
    return cudaSuccess;
}

}  // namespace

// lp (B, T, S), skip_add, vmask, a0 (B, S) float32; lengths (B,) int32;
// alpha (B, T, S) float32 out. All contiguous, on `device`; 1 <= S <= 2048.
// Launches on `stream`, returns a CUDA error code.
extern "C" int ctc_lattice_forward_f32(const float* lp, const float* skip_add, const float* vmask,
                                       const float* a0, const int* lengths, float* alpha, int B,
                                       int T, int S, int device, void* stream) {
    cudaError_t err = check_shape(device, B, T, S);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_forward_kernel<<<B, threads_for(S), 0, static_cast<cudaStream_t>(stream)>>>(
        lp, skip_add, vmask, a0, lengths, alpha, T, S);
    return static_cast<int>(cudaGetLastError());
}

// As ctc_lattice_forward_f32 with skip_fwd and the terminal rows bT in and
// beta (B, T, S) out.
extern "C" int ctc_lattice_backward_f32(const float* lp, const float* skip_fwd, const float* vmask,
                                        const float* bT, const int* lengths, float* beta, int B,
                                        int T, int S, int device, void* stream) {
    cudaError_t err = check_shape(device, B, T, S);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_backward_kernel<<<B, threads_for(S), 0, static_cast<cudaStream_t>(stream)>>>(
        lp, skip_fwd, vmask, bT, lengths, beta, T, S);
    return static_cast<int>(cudaGetLastError());
}

// lp (B, T, S), skip_add, vmask, a0 (B, S) float32; lengths, end1, end2
// (B,) int32; positions (B, T) int32 and score (B,) float32 out. The
// choice table of one sequence, T * S bytes, must fit shared memory
// (the caller's predicate). Launches on `stream`, returns a CUDA error code.
extern "C" int ctc_lattice_viterbi_f32(const float* lp, const float* skip_add, const float* vmask,
                                       const float* a0, const int* lengths, const int* end1,
                                       const int* end2, int* positions, float* score, int B,
                                       int T, int S, int device, void* stream) {
    cudaError_t err = check_shape(device, B, T, S);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = static_cast<size_t>(T) * S;
    err = allow_smem(ctc_viterbi_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_viterbi_kernel<true><<<B, threads_for(S), bytes, static_cast<cudaStream_t>(stream)>>>(
        lp, skip_add, vmask, a0, lengths, end1, end2, nullptr, positions, score, T, S);
    return static_cast<int>(cudaGetLastError());
}

// As ctc_lattice_viterbi_f32 at any T, with the choices written to
// `choices` (B, T, S) uint8 scratch in device memory.
extern "C" int ctc_lattice_viterbi_wide_f32(const float* lp, const float* skip_add,
                                            const float* vmask, const float* a0,
                                            const int* lengths, const int* end1, const int* end2,
                                            uint8_t* choices, int* positions, float* score, int B,
                                            int T, int S, int device, void* stream) {
    cudaError_t err = check_shape(device, B, T, S);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_viterbi_kernel<false><<<B, threads_for(S), CH * WIN, static_cast<cudaStream_t>(stream)>>>(
        lp, skip_add, vmask, a0, lengths, end1, end2, choices, positions, score, T, S);
    return static_cast<int>(cudaGetLastError());
}
