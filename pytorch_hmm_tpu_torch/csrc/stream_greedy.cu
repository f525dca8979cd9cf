// Frame-greedy streaming chunk decode over a carried (prev, has_prev).
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/stream.py:
// pallas_greedy_chunk (_greedy_kernel). Each frame t of the chunk scores
//
//     scores[s] = has ? log_a[prev, s] + log_obs[t, s] : log_obs[t, s] - log_s
//
// (log_s = log S rounded to float32 once on the host), takes the argmax
// with ties to the lowest state, writes the state and its score, and
// moves prev to it when t < n_valid. has is has_prev on frame 0 and
// has_prev || n_valid > 0 after it, as in the JAX package's XLA scan
// (pytorch_hmm_tpu/streaming.py:488-514), which the outputs equal bit
// for bit: the same two-operand sums, an exact max.
//
// What bounds it on an H100: the serial chain of T frames, each one
// shared-memory read of the previous state's transition row, a compare
// per owned state and a five-level shuffle argmax (about 0.2 us a frame).
// The bytes (T*S + S*S floats in, 2*T words out) take under a
// microsecond at 3.35 TB/s; the roofline does not bind.
//
// Design: one warp for the chunk; lane l owns states l, l+32, l+64, l+96
// (S <= 128). log_a sits in shared memory for the whole chunk; log_obs is
// staged CH frames at a time with one coalesced read, so the frame loop
// waits on device memory once per CH frames. No TPU layout is kept: no
// one-hot rows multiplied on a matrix unit, no padding to 128 lanes.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int SMAX = 128;
constexpr int PER_LANE = SMAX / WARP;
constexpr int CH = 32;          // frames of log-obs staged per chunk
constexpr unsigned FULL = 0xffffffffu;

// Warp argmax: the larger value wins, an equal value goes to the lower
// index. The order is total, so the butterfly leaves every lane holding
// the same winner.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, v, off);
        const int oi = __shfl_xor_sync(FULL, i, off);
        if (ov > v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
}

__global__ void __launch_bounds__(WARP)
greedy_chunk_kernel(const float* __restrict__ log_a,     // (S, S)
                    const float* __restrict__ log_obs,   // (T, S)
                    const int* __restrict__ n_valid,     // (1,)
                    const int* __restrict__ prev_in,     // ()
                    const uint8_t* __restrict__ has_in,  // () bool
                    int* __restrict__ states,            // (T,)
                    float* __restrict__ scores,          // (T,)
                    int* __restrict__ prev_out,          // ()
                    uint8_t* __restrict__ has_out,       // () bool
                    int T, int S, float log_s) {
    extern __shared__ float smem[];
    float* la_s = smem;              // S * S
    float* lo_s = smem + S * S;      // CH * S

    const int lane = threadIdx.x;
    for (int i = lane; i < S * S; i += WARP) la_s[i] = log_a[i];
    const int nv = n_valid[0];
    const bool has0 = has_in[0] != 0;
    // An out-of-range carried state is clamped so the row read stays
    // inside log_a; valid carries never are.
    int prev = min(max(prev_in[0], 0), S - 1);

    for (int t0 = 0; t0 < T; t0 += CH) {
        const int n = min(CH, T - t0);
        __syncwarp();
        for (int i = lane; i < n * S; i += WARP)
            lo_s[i] = log_obs[static_cast<long long>(t0) * S + i];
        __syncwarp();
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            const bool has = has0 || (t > 0 && nv > 0);
            const float* row = la_s + prev * S;
            const float* lo = lo_s + tf * S;
            float best = -INFINITY;
            int arg = INT_MAX;
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int s = lane + j * WARP;
                if (s < S) {
                    const float v = has ? row[s] + lo[s] : lo[s] - log_s;
                    // Ascending s: only a strictly larger value displaces.
                    if (arg == INT_MAX || v > best) {
                        best = v;
                        arg = s;
                    }
                }
            }
            warp_argmax(best, arg);
            if (lane == 0) {
                states[t] = arg;
                scores[t] = best;
            }
            if (t < nv) prev = arg;
        }
    }
    if (lane == 0) {
        prev_out[0] = prev;
        has_out[0] = (has0 || nv > 0) ? 1 : 0;
    }
}

}  // namespace

// log_a (S, S), log_obs (T, S) float32; n_valid (1,) and prev () int32;
// has () bool; states (T,) int32, scores (T,) float32, prev_out () int32
// and has_out () bool out. All contiguous, on `device`; 1 <= S <= 128,
// 1 <= T. Launches one warp on `stream` and returns cudaGetLastError().
extern "C" int greedy_chunk_f32(const float* log_a, const float* log_obs,
                                const int* n_valid, const int* prev_in,
                                const uint8_t* has_in, int* states,
                                float* scores, int* prev_out,
                                uint8_t* has_out, int T, int S, float log_s,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = sizeof(float) * static_cast<size_t>(S * S + CH * S);
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(greedy_chunk_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    greedy_chunk_kernel<<<1, WARP, bytes, static_cast<cudaStream_t>(stream)>>>(
        log_a, log_obs, n_valid, prev_in, has_in, states, scores, prev_out,
        has_out, T, S, log_s);
    return static_cast<int>(cudaGetLastError());
}
