// Diagonal-GMM emission scoring and the Viterbi trellis of an HMM with
// up to 128 states in one launch: the (B, T, S) scores never go to
// device memory.
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/fused.py: fused_gmm_viterbi
// (_fused_trellis_kernel, then scan._vit_backtrace_kernel). Each state's
// score is the log-sum over its C components of
//
//     const[s, c] + sum_d x_d^2 A[c, d, s] + x_d Bm[c, d, s]
//     A = -1 / (2 var),  Bm = mean / var,
//     const = log w - (D log 2pi + sum_d log var + sum_d mean^2 / var) / 2
//
// (the caller builds A, Bm and const from the parameters), then the
// trellis delta_t[j] = max_i(delta_{t-1}[i] + log_a[i, j]) + lo_t[j],
// candidates compared with a strict '>' in ascending i (the lowest-index
// tie, as core.viterbi), padded frames repeating each row's last valid
// state. The scores round differently from the unfused route (emission
// products, then a logsumexp) in their last bits; the trellis on given
// scores is the one of csrc/scan_bigk.cu.
//
// What bounds it on an H100: at B=32, T=1000, S=64, C=2, D=80 the
// emission is 4 B T S C D = 1.3 GFLOP (~20 us at 67 TFLOP/s) and the
// bytes are the features (10 MB); but the trellis is a serial chain of T
// frames per sequence, two block barriers a frame, and the emission of
// a chunk of frames runs before that chunk's trellis, not beside it.
//
// Design: one block of 256 threads per sequence. The tables (80 KB at
// S=64, C=2, D=80; read from device memory if they pass 100 KB) and
// log_a (S x S) sit in dynamic shared memory. Per chunk of 64 frames, each
// thread scores (frame, state) pairs, the C components one after another
// with a running log-sum, into a (64, S) shared buffer; then the trellis
// runs the chunk's frames from there, thread (g, col) taking the
// lowest-index max over rows [g*slice, (g+1)*slice) of column col and the
// column's owner combining the slices in order. Backpointers go to a
// (B, T, S) uint8 scratch and are walked back in the same launch, staged
// in shared memory chunk by chunk.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STATES = 128;
constexpr int TC = 64;                       // frames scored per chunk
constexpr int TABLE_SMEM_BYTES = 100 * 1024;
constexpr int PSI_STAGE_BYTES = 8192;
constexpr int PSI_MAX_FRAMES = 256;

__global__ void __launch_bounds__(THREADS)
fused_gmm_kernel(const float* __restrict__ obs,      // (B, T, D)
                 const float* __restrict__ a_tab,    // (C, D, S)
                 const float* __restrict__ b_tab,    // (C, D, S)
                 const float* __restrict__ cn,       // (C, S)
                 const float* __restrict__ log_a,    // (S, S)
                 const float* __restrict__ log_pi,   // (S,)
                 const int* __restrict__ lengths,    // (B,) or null
                 uint8_t* __restrict__ psi_g,        // (B, T, S) scratch
                 int* __restrict__ states,           // (B, T)
                 float* __restrict__ score,          // (B,)
                 int T, int D, int S, int C, int kc, int split, int slice,
                 int tables_in_smem) {
    extern __shared__ float dyn_s[];   // log_a (S*S), scores (TC*S), tables
    __shared__ float d_s[MAX_STATES];
    __shared__ float part_v[THREADS];
    __shared__ int part_i[THREADS];
    __shared__ uint8_t psi_st[PSI_STAGE_BYTES];
    __shared__ int st_s[PSI_MAX_FRAMES];
    __shared__ int last_s;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int col = tid % kc;
    const int g = tid / kc;
    const bool active = col < S && g < split;
    const bool owner = col < S && g == 0;
    const float* x = obs + static_cast<long long>(b) * T * D;
    uint8_t* psi = psi_g + static_cast<long long>(b) * T * S;
    int* st = states + static_cast<long long>(b) * T;
    int len = lengths ? lengths[b] : T;
    len = len < 1 ? 1 : (len > T ? T : len);

    float* la_s = dyn_s;
    float* lo_s = la_s + S * S;
    const int n_tab = C * D * S;
    const float* A = a_tab;
    const float* Bm = b_tab;
    for (int i = tid; i < S * S; i += THREADS) la_s[i] = log_a[i];
    if (tables_in_smem) {
        float* t_s = lo_s + TC * S;
        for (int i = tid; i < n_tab; i += THREADS) {
            t_s[i] = a_tab[i];
            t_s[n_tab + i] = b_tab[i];
        }
        A = t_s;
        Bm = t_s + n_tab;
    }
    __syncthreads();
    const int i0 = g * slice;
    const int i1 = min(S, i0 + slice);

    float d = 0.f;
    for (int t0 = 0; t0 < len; t0 += TC) {
        const int n = min(TC, len - t0);
        // Emission scores of the chunk's frames.
        for (int p = tid; p < n * S; p += THREADS) {
            const int tf = p / S;
            const int s = p % S;
            const float* xr = x + static_cast<long long>(t0 + tf) * D;
            float m = -INFINITY, sum = 0.f;
            for (int c = 0; c < C; ++c) {
                const float* ac = A + c * D * S + s;
                const float* bc = Bm + c * D * S + s;
                // The x^2 and x terms in two independent chains.
                float acc2 = 0.f, acc1 = 0.f;
                for (int k = 0; k < D; ++k) {
                    const float xv = xr[k];
                    acc2 = fmaf(xv * xv, ac[k * S], acc2);
                    acc1 = fmaf(xv, bc[k * S], acc1);
                }
                const float acc = cn[c * S + s] + (acc2 + acc1);
                if (c == 0) {
                    m = acc;
                    sum = 1.f;
                } else if (acc > m) {
                    sum = sum * expf(m - acc) + 1.f;
                    m = acc;
                } else {
                    sum += expf(acc - m);
                }
            }
            lo_s[tf * S + s] = m + logf(sum);
        }
        __syncthreads();
        // The trellis over the chunk.
        for (int tf = 0; tf < n; ++tf) {
            const int t = t0 + tf;
            const float lo_t = owner ? lo_s[tf * S + col] : 0.f;
            if (t == 0) {
                if (owner) d = log_pi[col] + lo_t;
                continue;
            }
            if (owner) d_s[col] = d;
            __syncthreads();
            if (active) {
                float best = -INFINITY;
                int arg = S;
                if (i0 < i1) {
                    best = d_s[i0] + la_s[i0 * S + col];
                    arg = i0;
                    for (int i = i0 + 1; i < i1; ++i) {
                        const float cand = d_s[i] + la_s[i * S + col];
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
                psi[static_cast<long long>(t) * S + col] = static_cast<uint8_t>(bi);
            }
        }
        __syncthreads();   // the next chunk's scores overwrite lo_s
    }

    // Score and the lowest-index argmax of the final delta.
    if (owner) d_s[col] = d;
    __syncthreads();
    if (tid == 0) {
        float best = d_s[0];
        int s = 0;
        for (int k = 1; k < S; ++k) {
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
    for (int t = len - 1 + tid; t < T; t += THREADS) st[t] = s;

    // Backtrace, newest chunk first: frame t's backpointer row gives the
    // state at t - 1.
    int ch = PSI_STAGE_BYTES / S;
    ch = ch < PSI_MAX_FRAMES ? ch : PSI_MAX_FRAMES;
    for (int t1 = len - 1; t1 >= 1;) {
        const int t0 = max(1, t1 - ch + 1);
        const int n = t1 - t0 + 1;
        __syncthreads();
        for (int i = tid; i < n * S; i += THREADS)
            psi_st[i] = psi[static_cast<long long>(t0) * S + i];
        __syncthreads();
        if (tid == 0) {
            for (int t = t1; t >= t0; --t) {
                s = psi_st[(t - t0) * S + s];
                st_s[t - t0] = s;
            }
        }
        __syncthreads();
        for (int i = tid; i < n; i += THREADS) st[t0 - 1 + i] = st_s[i];
        t1 = t0 - 1;
    }
}

}  // namespace

// obs (B, T, D), a_tab and b_tab (C, D, S), cn (C, S), log_a (S, S),
// log_pi (S,) float32; lengths (B,) int32 or null; psi (B, T, S) uint8
// scratch; states (B, T) int32 and score (B,) float32 out. All contiguous,
// on `device`; 1 <= S <= 128. Launches on `stream`, returns
// cudaGetLastError().
extern "C" int fused_gmm_viterbi_f32(const float* obs, const float* a_tab, const float* b_tab,
                                     const float* cn, const float* log_a, const float* log_pi,
                                     const int* lengths, uint8_t* psi, int* states, float* score,
                                     int B, int T, int D, int S, int C, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int kc = (S + 31) / 32 * 32;
    const int split = THREADS / kc;
    const int slice = (S + split - 1) / split;
    const long long table_bytes = 2LL * C * D * S * sizeof(float);
    const int tables_in_smem = table_bytes <= TABLE_SMEM_BYTES;
    const size_t bytes = (static_cast<size_t>(S) * S + static_cast<size_t>(TC) * S) * sizeof(float)
                         + (tables_in_smem ? static_cast<size_t>(table_bytes) : 0);
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(fused_gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    fused_gmm_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        obs, a_tab, b_tab, cn, log_a, log_pi, lengths, psi, states, score,
        T, D, S, C, kc, split, slice, tables_in_smem);
    return static_cast<int>(cudaGetLastError());
}
