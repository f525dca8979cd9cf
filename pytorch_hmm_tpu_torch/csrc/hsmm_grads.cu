// The closed-form cotangents of an explicit-duration HMM's log-likelihood
// from its forward and backward tables: for sum_b g_b * log Z_b, the
// gradients with respect to log_obs (B, T, S), log_a (S, S), log_pi (S)
// and log_dur (S, D), which are the HSMM's posterior expectations (frame
// occupancy, segment transitions, the first segment's state, segments by
// duration). S <= 32 states, D <= 256 durations, any B and T.
//
// Replaces no TPU kernel: the JAX package leaves this table algebra to
// XLA as jnp code (pytorch_hmm_tpu/core/hsmm.py:289, hsmm_grads_from_tables,
// which _hsmm_lz_bwd calls). Its plain version is core.hsmm_grads_from_tables,
// which on the card is some 320 elementwise launches over (B, T-1, S, S)
// and (B, T-d+1, S) intermediates.
//
// Per row b of valid length L, with g = g_b, lz = log_z[b], log_a and
// log_dur clamped at -1e30 and every table on the same (shifted) emissions:
//
//   nu(u, s)    = log_pi[s] at u = 0, else lse_i(alpha(u-1, i) + log_a[i, s])
//   start(u, s) = exp(nu(u, s) + bstart(u, s) - lz)
//   end(u, s)   = exp(alpha(u, s) + bstar(u, s) - lz)
//   d_log_obs(t, s)  = g * clamp(sum_{u<=t} start(u, s) - sum_{u<t} end(u, s), 0, 1)
//   d_log_a[i, j]   += g * sum_{1<=u<L} exp(alpha(u-1, i) + log_a[i, j] + bstart(u, j) - lz)
//   d_log_pi[s]     += g * exp(log_pi[s] + bstart(0, s) - lz)
//   d_log_dur[s, d-1] += g * sum_{u+d-1<L} exp(nu(u, s) + log_dur[s, d-1] + E_d(u, s)
//                                             + bstar(u+d-1, s) - lz)
//   E_d(u, s)   = E_{d-1}(u, s) + log_obs(u+d-1, s),  E_0 = 0
//
// The window sums are built up one duration at a time, as the plain
// version does: never as a difference of running sums, which at speech
// widths cancels two ~1e5 terms in f32.
//
// What bounds it on an H100: bytes. At the training cell's shape (B=1024,
// T=1000, S=10, D=20, rows of 250-1000 frames, 640K valid frames) the four
// tables are read once over the valid frames, 25.6 MB each, and d_log_obs
// is written once: about 128 MB, 0.04 ms at 3.35 TB/s. The exponentials
// come next: S^2 + S^2 + S*D + 2S a frame (420 at S=10, 0.27 G in all),
// about 0.07 ms on the SFUs of 132 SMs. On an H100 (700 W) the two
// launches take 0.57-0.60 ms there, 15 times the bound by bytes, where
// the plain version takes 12.2 ms.
//
// Design. One block of 32*S threads takes one part of one row: the
// wrapper splits each row into P parts along T (hsmm_smallk.table_grads_plan,
// from B and the card's SMs, so that B=32 fills the card as B=1024 does),
// and a block stops at the row's length: padded frames are neither read
// nor computed, only written as 0. The block walks its part in tiles of 64
// frames. A tile stages alpha (one frame of halo back), beta_start, and
// beta* and log_obs (D-1 frames of halo ahead, for the windows) in shared
// memory, rows strided by S rounded up to odd so that lanes on successive
// frames of one state hit distinct banks. Then:
//   1. each (frame, state): nu by a max-shifted logsumexp over the S
//      predecessors, start, end;
//   2. each thread owns one transition (i, j) and a slice of the frames
//      (32/S slices a pair) and accumulates its terms in a register;
//   3. warp s owns state s: its lanes take 32 start frames, loop d = 1..D
//      with the window sum carried in a register, and reduce each d's 32
//      terms across the warp by shuffles into the state's row of a
//      shared-memory accumulator;
//   4. warp s scans start - end over its state's frames (a warp scan a 32
//      frames, the carry across chunks and tiles in a register), so the
//      occupancy needs no second pass where a row is one block;
//   5. the tile's d_log_obs rows are stored coalesced.
// No float atomics anywhere: each block writes its row part's float32
// partials of d_log_a, d_log_pi and d_log_dur (times g) and its occupancy
// total to scratch, and a second launch sums the partials in a fixed order
// in float64 and, where a row has more than one part, adds to each later
// part's occupancy the totals of the parts before it, clamps and scales.
// The same inputs give the same gradients bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int KMAX = 32;
constexpr int DMAX = 256;
constexpr int TILE = 64;           // frames a tile, a multiple of 32
constexpr int SLICES = 32;         // warps of a reduce block, each a slice of the partials
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;      // core.hsmm's _NEG

// Floats of dynamic shared memory a block: alpha (TILE + 1 rows), beta_start,
// nu, start - end, end (TILE rows each), beta* and log_obs (TILE + D - 1
// rows each), all strided S | 1; log_a (S, S); the duration sums (S, D).
long long grads_floats(int S, int D) {
    return static_cast<long long>(S | 1) * (7 * TILE + 2 * D - 1) + S * S + S * D;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

__global__ void __launch_bounds__(32 * KMAX)
hsmm_table_grads_kernel(const float* __restrict__ log_obs, const float* __restrict__ log_a,
                        const float* __restrict__ log_pi, const float* __restrict__ log_dur,
                        const float* __restrict__ alpha, const float* __restrict__ bstar,
                        const float* __restrict__ bstart, const float* __restrict__ log_z,
                        const int* __restrict__ lengths, const float* __restrict__ g,
                        float* __restrict__ d_log_obs, float* __restrict__ part,
                        float* __restrict__ tot, int T, int S, int D, int P, int span) {
    extern __shared__ float sm[];
    const int SP = S | 1;
    float* A = sm;                          // alpha, frames t0-1 ..
    float* BS = A + (TILE + 1) * SP;        // beta_start, frames t0 ..
    float* BR = BS + TILE * SP;             // beta*, frames t0 .. t0+TILE+D-2
    float* LO = BR + (TILE + D - 1) * SP;   // log_obs, the same frames
    float* NU = LO + (TILE + D - 1) * SP;   // nu, frames t0 ..
    float* X = NU + TILE * SP;              // start - end, then the occupancy
    float* EN = X + TILE * SP;              // end
    float* LA = EN + TILE * SP;             // log_a, clamped
    float* ACC = LA + S * S;                // the duration sums (S, D)

    const int tid = threadIdx.x, nth = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.x / P, p = blockIdx.x - b * P;
    const int L = lengths ? min(max(lengths[b], 0), T) : T;
    const int ta = p * span, te = min(T, ta + span), tb = min(te, L);
    const float lz = log_z[b], gb = g[b];
    const size_t row = static_cast<size_t>(b) * T * S;

    for (int i = tid; i < S * S; i += nth) LA[i] = fmaxf(log_a[i], NEG);
    for (int i = tid; i < S * D; i += nth) ACC[i] = 0.f;

    // Step 2's transition (i, j) and slice of frames.
    const int pairs = S * S, slices = KMAX / S;
    const bool xi_on = tid < pairs * slices;
    const int xi_i = (tid % pairs) / S, xi_j = tid % S, slice = tid / pairs;
    float xacc = 0.f;
    // Steps 3-4: warp s owns state s; carry is the part's sum of start - end so far.
    const int s = warp;
    const float* ld_row = log_dur + static_cast<size_t>(s) * D;
    float carry = 0.f;

    for (int t0 = ta; t0 < tb; t0 += TILE) {
        const int n = min(TILE, tb - t0);
        for (int i = tid; i < (n + 1) * S; i += nth) {
            const int r = i / S, c = i - r * S;
            const long long f = static_cast<long long>(t0) - 1 + r;
            A[r * SP + c] = f >= 0 ? alpha[row + f * S + c] : NEG;
        }
        const float* bs_src = bstart + row + static_cast<size_t>(t0) * S;
        for (int i = tid; i < n * S; i += nth) {
            const int r = i / S, c = i - r * S;
            BS[r * SP + c] = bs_src[i];
        }
        // Window rows at and past the row's end read as 0; their terms are
        // masked, so they only keep E finite.
        const int live = min(n + D - 1, L - t0);
        const size_t w0 = row + static_cast<size_t>(t0) * S;
        for (int i = tid; i < (TILE + D - 1) * S; i += nth) {
            const int r = i / S, c = i - r * S;
            const bool in = r < live;
            BR[r * SP + c] = in ? bstar[w0 + i] : 0.f;
            LO[r * SP + c] = in ? log_obs[w0 + i] : 0.f;
        }
        __syncthreads();

        // 1. nu, start and end of each (frame, state).
        for (int i = tid; i < n * S; i += nth) {
            const int r = i / S, j = i - r * S;
            float nu;
            if (t0 + r == 0) {
                nu = log_pi[j];
            } else {
                const float* a = A + r * SP;   // alpha(u-1)
                float m = -INFINITY;
                for (int k = 0; k < S; ++k) m = fmaxf(m, a[k] + LA[k * S + j]);
                if (!isfinite(m)) m = 0.f;
                float sum = 0.f;
                for (int k = 0; k < S; ++k) sum += __expf(a[k] + LA[k * S + j] - m);
                nu = m + logf(sum);
            }
            const float st = __expf(nu + BS[r * SP + j] - lz);
            const float en = __expf(A[(r + 1) * SP + j] + BR[r * SP + j] - lz);
            NU[r * SP + j] = nu;
            X[r * SP + j] = st - en;
            EN[r * SP + j] = en;
        }
        __syncthreads();

        // 2. Transitions into the tile's frames u >= 1.
        if (xi_on) {
            const float la = LA[xi_i * S + xi_j];
            for (int r = slice; r < n; r += slices)
                if (t0 + r > 0)
                    xacc += __expf(A[r * SP + xi_i] + la + BS[r * SP + xi_j] - lz);
        }

        // 3. Segments of state s by duration, lanes over start frames.
        for (int c0 = 0; c0 < n; c0 += 32) {
            const int r = c0 + lane;
            const bool on = r < n;
            const int u = t0 + r;
            const float nu = on ? NU[r * SP + s] : 0.f;
            const int dmax = min(D, L - (t0 + c0));
            float E = 0.f;
            for (int d = 1; d <= dmax; ++d) {
                const int f = r + d - 1;
                E += LO[f * SP + s];
                const float ld = fmaxf(__ldg(ld_row + d - 1), NEG);
                const float term = (on && u + d - 1 < L)
                                       ? __expf(nu + ld + E + BR[f * SP + s] - lz) : 0.f;
                const float sum = warp_sum(term);
                if (lane == 0) ACC[s * D + d - 1] += sum;
            }
        }

        // 4. Occupancy of state s: the running sum of start - end, plus end.
        for (int c0 = 0; c0 < n; c0 += 32) {
            const int r = c0 + lane;
            const bool on = r < n;
            float x = on ? X[r * SP + s] : 0.f;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float y = __shfl_up_sync(FULL, x, o);
                if (lane >= o) x += y;
            }
            const float run = carry + x;
            if (on) X[r * SP + s] = run + EN[r * SP + s];
            carry = __shfl_sync(FULL, run, 31);
        }
        __syncthreads();

        // 5. The tile's d_log_obs: final in a row's first part; a later
        // part's occupancy still lacks the parts before it (second launch).
        float* out = d_log_obs + row + static_cast<size_t>(t0) * S;
        for (int i = tid; i < n * S; i += nth) {
            const int r = i / S, c = i - r * S;
            const float G = X[r * SP + c];
            out[i] = p == 0 ? gb * clamp01(G) : G;
        }
        // The next tile's staging writes none of what step 5 reads.
    }

    const int z0 = max(ta, tb);
    for (int i = tid; i < (te - z0) * S; i += nth)
        d_log_obs[row + static_cast<size_t>(z0) * S + i] = 0.f;

    // Partials of this part: transitions (slices summed in order), the first
    // segment's state (part 0), durations; and the occupancy total.
    A[tid] = xacc;
    __syncthreads();
    float* out = part + static_cast<size_t>(blockIdx.x) * (pairs + S + S * D);
    if (tid < pairs) {
        float sum = 0.f;
        for (int k = 0; k < slices; ++k) sum += A[k * pairs + tid];
        out[tid] = gb * sum;
    }
    if (tid < S)
        out[pairs + tid] = p == 0 ? gb * __expf(log_pi[tid] + bstart[row + tid] - lz) : 0.f;
    for (int i = tid; i < S * D; i += nth) out[pairs + S + i] = gb * ACC[i];
    if (lane == 0) tot[static_cast<size_t>(blockIdx.x) * S + warp] = carry;
}

// Blocks below `reduce_blocks`: 32 of the NV = S*S + S + S*D sums each,
// every slice of SLICES summing the partials k = slice mod SLICES in
// float64, the slices then summed in order. The rest: one block per later
// part (b, p >= 1) of a row split in P parts.
__global__ void __launch_bounds__(32 * SLICES)
hsmm_table_grads_reduce_kernel(const float* __restrict__ part, const float* __restrict__ tot,
                               const int* __restrict__ lengths, const float* __restrict__ g,
                               float* __restrict__ d_log_obs, float* __restrict__ d_log_a,
                               float* __restrict__ d_log_pi, float* __restrict__ d_log_dur,
                               int NB, int T, int S, int D, int P, int span, int reduce_blocks) {
    const int tid = threadIdx.x;
    if (static_cast<int>(blockIdx.x) < reduce_blocks) {
        __shared__ double acc[SLICES][32];
        const int NV = S * S + S + S * D;
        const int lane = tid & 31, sl = tid >> 5;
        const int v = blockIdx.x * 32 + lane;
        double sum = 0.0;
        if (v < NV)
            for (int k = sl; k < NB; k += SLICES) sum += part[static_cast<size_t>(k) * NV + v];
        acc[sl][lane] = sum;
        __syncthreads();
        if (sl == 0 && v < NV) {
            double total = 0.0;
            for (int k = 0; k < SLICES; ++k) total += acc[k][lane];
            const float out = static_cast<float>(total);
            if (v < S * S) d_log_a[v] = out;
            else if (v < S * S + S) d_log_pi[v - S * S] = out;
            else d_log_dur[v - S * S - S] = out;
        }
        return;
    }
    const int q = blockIdx.x - reduce_blocks;
    const int b = q / (P - 1), p = 1 + q % (P - 1);
    const int L = lengths ? min(max(lengths[b], 0), T) : T;
    const int ta = p * span, tb = min(min(T, ta + span), L);
    if (ta >= tb) return;
    __shared__ float carry[KMAX];
    if (tid < S) {
        float c = 0.f;
        for (int k = 0; k < p; ++k) c += tot[(static_cast<size_t>(b) * P + k) * S + tid];
        carry[tid] = c;
    }
    __syncthreads();
    const float gb = g[b];
    float* out = d_log_obs + (static_cast<size_t>(b) * T + ta) * S;
    for (int i = tid; i < (tb - ta) * S; i += blockDim.x) out[i] = gb * clamp01(out[i] + carry[i % S]);
}

}  // namespace

// All tensors contiguous on `device`: log_obs, alpha, bstar, bstart (B, T,
// K), log_a (K, K), log_pi (K,), log_dur (K, D), log_z and g (B,) float32;
// lengths (B,) int32 or null (every row has T frames). Out: d_log_obs (B,
// T, K), d_log_a (K, K), d_log_pi (K,), d_log_dur (K, D); scratch: part
// (B * P, K*K + K + K*D) and tot (B * P, K). P parts of `span` frames a
// row and `bytes` of shared memory a block, hsmm_smallk.table_grads_plan's
// (refused unless P * span covers T and bytes hold grads_floats). Two
// launches on `stream`; returns the first CUDA error.
extern "C" int hsmm_table_grads_f32(const float* log_obs, const float* log_a, const float* log_pi,
                                    const float* log_dur, const float* alpha, const float* bstar,
                                    const float* bstart, const float* log_z, const int* lengths,
                                    const float* g, float* d_log_obs, float* d_log_a,
                                    float* d_log_pi, float* d_log_dur, float* part, float* tot,
                                    int B, int T, int K, int D, int P, int span, int bytes,
                                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (K < 1 || K > KMAX || D < 1 || D > DMAX || B < 1 || T < 1 || P < 1 || span < 1 ||
        static_cast<long long>(P) * span < T || bytes < 4 * grads_floats(K, D))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = cudaFuncSetAttribute(hsmm_table_grads_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int NB = B * P;
    hsmm_table_grads_kernel<<<NB, 32 * K, bytes, st>>>(log_obs, log_a, log_pi, log_dur, alpha,
                                                       bstar, bstart, log_z, lengths, g,
                                                       d_log_obs, part, tot, T, K, D, P, span);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int reduce_blocks = (K * K + K + K * D + 31) / 32;
    hsmm_table_grads_reduce_kernel<<<reduce_blocks + B * (P - 1), 32 * SLICES, 0, st>>>(
        part, tot, lengths, g, d_log_obs, d_log_a, d_log_pi, d_log_dur, NB, T, K, D, P, span,
        reduce_blocks);
    return static_cast<int>(cudaGetLastError());
}
