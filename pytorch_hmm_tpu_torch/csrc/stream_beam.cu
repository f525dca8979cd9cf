// Fixed-width beam decode of one chunk for N streams in one launch.
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/stream_multi.py:
// pallas_beam_chunk_multi (_beam_multi_kernel and the history merge after
// it). Per stream, each valid frame t (t < n_valid[n]) of the chunk does
// what the JAX package's XLA scan does (pytorch_hmm_tpu/streaming.py:
// 758-790), with the same operand grouping:
//
//     table[w, s] = path_len == 0 ? sc[w] + lo[t, s]
//                                 : (sc[w] + log_a[ls[w], s]) + lo[t, s]
//     best[s], parent[s] = max and lowest argmax of table[:, s] over w
//     the W states of largest best (ties to the lower state) fill slots
//     0..W-1 in that order; each slot keeps its state and its parent slot
//     path_len = min(path_len + 1, H)
//
// and frames t >= n_valid[n] leave the carry as it was. The path history
// (W, H) of each slot is the last H states of its lineage: the incoming
// history of its start-of-chunk ancestor, then the states the chunk
// decoded. The kernel records (state, parent slot) per frame and slot in
// shared memory, walks each final slot back through them at the end of
// the chunk, and writes the merged history with integer copies. Scores,
// states, histories and path_len equal the XLA scan's bit for bit.
//
// What bounds it on an H100: the serial chain of T frames of each
// stream, each a W-term max per state (a dependent pair of shared-memory
// reads per term: the slot's state, then its transition row), a rank
// count over the S states and two warp barriers, then a T-step
// backtrace; about 1.3 us a frame at S=12, W=8. The bytes (N*T*S floats
// of log-obs, N*W*H history words in and out) take a tenth of a
// microsecond at 3.35 TB/s at N=16; the roofline does not bind. Streams
// are independent chains, one block each, so N streams cost about one
// stream's time until the 132 SMs fill.
//
// Design: one warp (one block) per stream, grid N, so any N launches;
// lane l owns states l, l+32, l+64, l+96 (S <= 128). log_a sits in shared
// memory for the whole chunk, log_obs is staged CH frames at a time, the
// W <= 8 scores and states of the beam live in shared memory, and the
// per-frame record is 2*T*W bytes. No TPU layout is kept: no one-hot
// rows multiplied on a matrix unit, no float einsum over the histories
// (exact only below 2^24), no padding to 128 lanes.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int SMAX = 128;
constexpr int WMAX = 8;
constexpr int PER_LANE = SMAX / WARP;
constexpr int CH = 32;          // frames of log-obs staged per chunk

struct Smem {
    float* la;        // S * S
    float* lo;        // CH * S
    float* best;      // SMAX
    float* sc;        // WMAX
    int* ls;          // WMAX
    int* anc;         // WMAX
    uint8_t* rec_st;  // T * W, frame-major: the state of slot r at frame t
    uint8_t* rec_par; // T * W: the parent slot of slot r at frame t
};

__host__ __device__ inline size_t smem_bytes(int T, int S, int W) {
    return sizeof(float) * static_cast<size_t>(S * S + CH * S + SMAX + WMAX)
           + sizeof(int) * 2 * WMAX + 2 * static_cast<size_t>(T) * W;
}

__device__ inline Smem carve(unsigned char* base, int S, int T, int W) {
    Smem m;
    m.la = reinterpret_cast<float*>(base);
    m.lo = m.la + S * S;
    m.best = m.lo + CH * S;
    m.sc = m.best + SMAX;
    m.ls = reinterpret_cast<int*>(m.sc + WMAX);
    m.anc = m.ls + WMAX;
    m.rec_st = reinterpret_cast<uint8_t*>(m.anc + WMAX);
    m.rec_par = m.rec_st + static_cast<size_t>(T) * W;
    return m;
}

__global__ void __launch_bounds__(WARP)
beam_chunk_kernel(const float* __restrict__ log_a,      // (S, S)
                  const float* __restrict__ log_obs,    // (N, T, S)
                  const int* __restrict__ n_valid,      // (N,)
                  const float* __restrict__ scores_in,  // (N, W)
                  const int* __restrict__ states_in,    // (N, W)
                  const int* __restrict__ paths_in,     // (N, W, H)
                  const int* __restrict__ plen_in,      // (N,)
                  float* __restrict__ scores_out,       // (N, W)
                  int* __restrict__ states_out,         // (N, W)
                  int* __restrict__ paths_out,          // (N, W, H)
                  int* __restrict__ plen_out,           // (N,)
                  int T, int S, int W, int H) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem m = carve(smem_raw, S, T, W);
    const int n = blockIdx.x;
    const int lane = threadIdx.x;
    const float* lo_g = log_obs + static_cast<long long>(n) * T * S;

    for (int i = lane; i < S * S; i += WARP) m.la[i] = log_a[i];
    if (lane < W) {
        m.sc[lane] = scores_in[n * W + lane];
        // Clamped so the row read stays inside log_a; valid carries are
        // never out of range.
        m.ls[lane] = min(max(states_in[n * W + lane], 0), S - 1);
    }
    const int nv = min(max(n_valid[n], 0), T);
    int pl = plen_in[n];

    for (int t0 = 0; t0 < nv; t0 += CH) {
        const int nc = min(CH, nv - t0);
        __syncwarp();
        for (int i = lane; i < nc * S; i += WARP)
            m.lo[i] = lo_g[static_cast<long long>(t0) * S + i];
        __syncwarp();
        for (int tf = 0; tf < nc; ++tf) {
            const int t = t0 + tf;
            const bool first = pl == 0;
            const float* lo = m.lo + tf * S;
            float bv[PER_LANE];
            int bp[PER_LANE];
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int s = lane + j * WARP;
                bv[j] = -INFINITY;
                bp[j] = 0;
                if (s < S) {
                    const float o = lo[s];
                    // Ascending w: only a strictly larger value displaces,
                    // so the parent is the lowest slot on ties.
                    for (int w = 0; w < W; ++w) {
                        const float v = first ? m.sc[w] + o
                                              : (m.sc[w] + m.la[m.ls[w] * S + s]) + o;
                        if (w == 0 || v > bv[j]) {
                            bv[j] = v;
                            bp[j] = w;
                        }
                    }
                    m.best[s] = bv[j];
                }
            }
            __syncwarp();
            // Rank of each owned state: the states that beat it (a larger
            // best, or an equal one at a lower index). Ranks 0..W-1 fill
            // the beam's slots in top-k order.
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int s = lane + j * WARP;
                if (s < S) {
                    int r = 0;
                    for (int s2 = 0; s2 < S && r < W; ++s2) {
                        const float b2 = m.best[s2];
                        r += (b2 > bv[j]) || (b2 == bv[j] && s2 < s);
                    }
                    if (r < W) {
                        m.sc[r] = bv[j];
                        m.ls[r] = s;
                        m.rec_st[t * W + r] = static_cast<uint8_t>(s);
                        m.rec_par[t * W + r] = static_cast<uint8_t>(bp[j]);
                    }
                }
            }
            pl = min(pl + 1, H);
            __syncwarp();
        }
    }

    // Backtrace: lane w walks final slot w back to its start-of-chunk
    // ancestor, writing the chunk's states that stay in the last H.
    int* out = paths_out + static_cast<long long>(n) * W * H;
    if (lane < W) {
        int cur = lane;
        int* row = out + static_cast<long long>(lane) * H;
        for (int t = nv - 1; t >= 0; --t) {
            const int h = H - nv + t;
            if (h >= 0) row[h] = m.rec_st[t * W + cur];
            cur = m.rec_par[t * W + cur];
        }
        m.anc[lane] = cur;
        scores_out[n * W + lane] = m.sc[lane];
        states_out[n * W + lane] = m.ls[lane];
    }
    __syncwarp();
    // The inherited part: the ancestor's history shifted left by nv.
    const int keep = H - nv;
    if (keep > 0) {
        const int* in = paths_in + static_cast<long long>(n) * W * H;
        for (int w = 0; w < W; ++w) {
            const int* src = in + static_cast<long long>(m.anc[w]) * H + nv;
            int* dst = out + static_cast<long long>(w) * H;
            for (int h = lane; h < keep; h += WARP) dst[h] = src[h];
        }
    }
    if (lane == 0) plen_out[n] = pl;
}

}  // namespace

// log_a (S, S), log_obs (N, T, S), scores_in (N, W) float32; n_valid (N,),
// states_in (N, W), paths_in (N, W, H), plen_in (N,) int32; the outputs
// likewise, not aliasing the inputs. All contiguous, on `device`;
// 1 <= S <= 128, 1 <= W <= min(8, S), 1 <= T <= 1024, 1 <= H <= 1024,
// N >= 1. Launches N warps on `stream` and returns cudaGetLastError().
extern "C" int beam_chunk_f32(const float* log_a, const float* log_obs,
                              const int* n_valid, const float* scores_in,
                              const int* states_in, const int* paths_in,
                              const int* plen_in, float* scores_out,
                              int* states_out, int* paths_out, int* plen_out,
                              int N, int T, int S, int W, int H, int device,
                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = smem_bytes(T, S, W);
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(beam_chunk_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    beam_chunk_kernel<<<N, WARP, bytes, static_cast<cudaStream_t>(stream)>>>(
        log_a, log_obs, n_valid, scores_in, states_in, paths_in, plen_in,
        scores_out, states_out, paths_out, plen_out, T, S, W, H);
    return static_cast<int>(cudaGetLastError());
}
