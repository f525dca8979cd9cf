// Large-state sequence log-likelihood: the prob-space chain
//   q_t = (bf16(q_{t-1}) @ P) * exp(lo_t - m_t),  C += m_t,  m_t = max_k lo_t
// with P = bf16(exp(log_a)), bf16 products summed in float32 on the tensor
// cores (mma.sync m16n8k16), one launch for the whole sequence.
//
// Replaces the TPU kernel of pytorch_hmm_tpu/ops/bigk.py
// (bigk_log_likelihood, _bigk_kernel). Frame 0 is the prior:
// q_0 = exp(log_pi + (lo_0 - m_0)), rescaled by its row max r (floored at
// 1e-37) as q * (1/r), C = log r + m_0. Later frames rescale the same way
// after every 16 frames of each t_chunk-frame chunk and at each chunk's end
// (chunk 0 holds frames 1..t_chunk-1), the reference's schedule. The output
// is log(max(q, 1e-37)) + C per state; the wrapper takes its logsumexp.
//
// What bounds it on an H100: each frame is a (B, K) @ (K, K) product on a
// chain serial over T. At B=48, T=2048, K=512 the 201 MB of log-obs take
// 0.060 ms at 3.35 TB/s and the 51.5 GFLOP 0.052 ms at 989 TFLOP/s (bf16):
// bytes bound it. The chain's frames cannot overlap, so the product of one
// frame runs on the blocks of the batch alone (3 at B=48), and P, 512 KB of
// bf16 at K=512, is read again every frame.
//
// Design: one block per tile of 16 batch rows (one mma M tile) and 8-16
// warps; warp w owns NT n-tiles (8 states each) of the output, K padded to a
// multiple of 64 (Kp). The wrapper lays P out in B-fragment order (each
// 16x8 tile as 32 lanes x 8 contiguous bytes), so a warp's fragment load is
// 256 coalesced bytes. The first k-tiles of P that fit are staged once into
// shared memory (all of P up to Kp=256; 11 of 32 k-tiles at Kp=512, 4 of 64
// at Kp=1024); the rest stream from L2 every frame. q lives in shared memory
// as bf16, double buffered by frame parity, rows padded by 8 values so the A
// fragment reads hit 32 banks. Each thread holds the log-obs at its
// accumulator positions, loaded a frame ahead; the row max m_t is reduced
// over the 4 lanes of a row by shuffles and over the warps through shared
// memory, a frame ahead too, so a frame costs one block barrier (three at a
// rescale frame, which needs the row max of q).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int ROWS = 16;            // batch rows per block: one mma M tile
constexpr int MAX_WARPS = 16;
constexpr int MAX_K = 1024;
constexpr int MAX_B = 4096;
constexpr int RESCALE = 16;
constexpr float FLOOR = 1e-37f;
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Two floats as a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool rescale_after(int t, int tc) {
    const int c = t / tc, f = t - c * tc;
    const int pos = c == 0 ? f - 1 : f;
    const int n = c == 0 ? tc - 1 : tc;
    return (pos + 1) % RESCALE == 0 || pos == n - 1;
}

// Max over the 4 lanes that share a row of the accumulator.
__device__ __forceinline__ float group_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int NT>
struct Frame {
    float a[NT][2];   // row g, columns col(n) + {0, 1}
    float b[NT][2];   // row g + 8
};

// This thread's log-obs of frame t: rows b0+g and b0+g+8, columns
// c0 + 8n + {0, 1}; -inf past K (so exp gives 0), 0 past B.
template <int NT>
__device__ __forceinline__ void load_frame(Frame<NT>& f, const float* __restrict__ lo, int t, int T,
                                           int K, int rowA, int rowB, bool okA, bool okB, int c0) {
    const float* pa = lo + (static_cast<long long>(rowA) * T + t) * K;
    const float* pb = lo + (static_cast<long long>(rowB) * T + t) * K;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + e;
            const bool in = col < K;
            f.a[n][e] = in ? (okA ? __ldg(pa + col) : 0.f) : -INFINITY;
            f.b[n][e] = in ? (okB ? __ldg(pb + col) : 0.f) : -INFINITY;
        }
    }
}

// Partial row maxima of `f` (this warp's columns) into red[warp][16].
template <int NT>
__device__ __forceinline__ void partial_max(const float (&a)[NT][2], const float (&b)[NT][2],
                                            float* red, int warp, int g, int q4) {
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        ma = fmaxf(ma, fmaxf(a[n][0], a[n][1]));
        mb = fmaxf(mb, fmaxf(b[n][0], b[n][1]));
    }
    ma = group_max(ma);
    mb = group_max(mb);
    if (q4 == 0) {
        red[warp * ROWS + g] = ma;
        red[warp * ROWS + g + 8] = mb;
    }
}

__device__ __forceinline__ float row_max(const float* red, int nwarps, int row) {
    float m = -INFINITY;
    for (int w = 0; w < nwarps; ++w) m = fmaxf(m, red[w * ROWS + row]);
    return m;
}

// q *= 1/r, C += log r with r the row max of q over all columns (floored).
template <int NT>
__device__ __forceinline__ void rescale(float (&q)[NT][4], float& ca, float& cb, float* red,
                                        int nwarps, int warp, int g, int q4) {
    float ma = 0.f, mb = 0.f;   // q >= 0
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        ma = fmaxf(ma, fmaxf(q[n][0], q[n][1]));
        mb = fmaxf(mb, fmaxf(q[n][2], q[n][3]));
    }
    ma = group_max(ma);
    mb = group_max(mb);
    if (q4 == 0) {
        red[warp * ROWS + g] = ma;
        red[warp * ROWS + g + 8] = mb;
    }
    __syncthreads();
    const float ra = fmaxf(row_max(red, nwarps, g), FLOOR);
    const float rb = fmaxf(row_max(red, nwarps, g + 8), FLOOR);
    __syncthreads();   // every warp has read red before it is written again
    const float ia = 1.0f / ra, ib = 1.0f / rb;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        q[n][0] *= ia;
        q[n][1] *= ia;
        q[n][2] *= ib;
        q[n][3] *= ib;
    }
    ca += logf(ra);
    cb += logf(rb);
}

// bf16(q) into the q buffer `qs` (16 rows of QS bf16 values, as words).
template <int NT>
__device__ __forceinline__ void store_q(uint32_t* qs, const float (&q)[NT][4], int QS, int g,
                                        int c0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int col = c0 + 8 * n;
        qs[(g * QS + col) >> 1] = pack_bf16(q[n][0], q[n][1]);
        qs[((g + 8) * QS + col) >> 1] = pack_bf16(q[n][2], q[n][3]);
    }
}

template <int NT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
bigk_kernel(const float* __restrict__ lo,    // (B, T, K)
            const uint2* __restrict__ pf,    // (Kp/16, Kp/8, 32) B fragments of P
            const float* __restrict__ lpi,   // (K,)
            float* __restrict__ out,         // (B, K)
            int B, int T, int K, int Kp, int tc, int kt_res) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ntiles = Kp / 8;
    const int KT = Kp / 16;
    const int QS = Kp + 8;
    uint2* pres = reinterpret_cast<uint2*>(smem);
    uint32_t* qbuf = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(kt_res) * ntiles * 256);
    float* red_m = reinterpret_cast<float*>(qbuf + ROWS * QS);   // (2, MAX_WARPS, 16)
    float* red_q = red_m + 2 * MAX_WARPS * ROWS;                  // (MAX_WARPS, 16)

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int g = lane >> 2, q4 = lane & 3;
    const int rowA = blockIdx.x * ROWS + g, rowB = rowA + 8;
    const bool okA = rowA < B, okB = rowB < B;
    const int c0 = warp * NT * 8 + 2 * q4;   // first column of n-tile 0
    const int tile0 = warp * NT;              // this warp's first n-tile

    {   // Stage the resident k-tiles of P.
        const uint4* src = reinterpret_cast<const uint4*>(pf);
        uint4* dst = reinterpret_cast<uint4*>(pres);
        const int n16 = kt_res * ntiles * 16;
        for (int x = tid; x < n16; x += blockDim.x) dst[x] = src[x];
    }

    // Frame 0: the prior.
    Frame<NT> cur;
    load_frame(cur, lo, 0, T, K, rowA, rowB, okA, okB, c0);
    partial_max(cur.a, cur.b, red_m, warp, g, q4);
    __syncthreads();
    float ma = row_max(red_m, nwarps, g), mb = row_max(red_m, nwarps, g + 8);
    float q[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + e;
            const float p = col < K ? __ldg(lpi + col) : 0.f;
            q[n][e] = col < K ? expf(p + (cur.a[n][e] - ma)) : 0.f;
            q[n][2 + e] = col < K ? expf(p + (cur.b[n][e] - mb)) : 0.f;
        }
    }
    float ca = 0.f, cb = 0.f;
    rescale(q, ca, cb, red_q, nwarps, warp, g, q4);
    ca += ma;
    cb += mb;
    store_q(qbuf + ROWS * QS / 2, q, QS, g, c0);   // frame 1 reads buffer 1
    if (T > 1) {
        load_frame(cur, lo, 1, T, K, rowA, rowB, okA, okB, c0);
        partial_max(cur.a, cur.b, red_m + MAX_WARPS * ROWS, warp, g, q4);
    }

    for (int t = 1; t < T; ++t) {
        const int par = t & 1;
        __syncthreads();
        ma = row_max(red_m + par * MAX_WARPS * ROWS, nwarps, g);
        mb = row_max(red_m + par * MAX_WARPS * ROWS, nwarps, g + 8);
        float e[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            e[n][0] = expf(cur.a[n][0] - ma);
            e[n][1] = expf(cur.a[n][1] - ma);
            e[n][2] = expf(cur.b[n][0] - mb);
            e[n][3] = expf(cur.b[n][1] - mb);
        }
        const bool more = t + 1 < T;
        if (more) load_frame(cur, lo, t + 1, T, K, rowA, rowB, okA, okB, c0);

#pragma unroll
        for (int n = 0; n < NT; ++n) q[n][0] = q[n][1] = q[n][2] = q[n][3] = 0.f;
        const uint32_t* qa = qbuf + par * (ROWS * QS / 2);
#pragma unroll 2
        for (int kt = 0; kt < KT; ++kt) {
            const int k0 = kt * 16 + 2 * q4;
            uint32_t a[4];
            a[0] = qa[(g * QS + k0) >> 1];
            a[1] = qa[((g + 8) * QS + k0) >> 1];
            a[2] = qa[(g * QS + k0 + 8) >> 1];
            a[3] = qa[((g + 8) * QS + k0 + 8) >> 1];
            const uint2* src = (kt < kt_res ? pres : pf) + (kt * ntiles + tile0) * 32 + lane;
            uint2 bfrag[NT];
#pragma unroll
            for (int n = 0; n < NT; ++n) bfrag[n] = src[n * 32];
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(q[n], a, bfrag[n]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int x = 0; x < 4; ++x) q[n][x] *= e[n][x];
        }
        ca += ma;
        cb += mb;
        if (rescale_after(t, tc)) rescale(q, ca, cb, red_q, nwarps, warp, g, q4);
        if (more) {
            store_q(qbuf + (1 - par) * (ROWS * QS / 2), q, QS, g, c0);
            partial_max(cur.a, cur.b, red_m + (1 - par) * MAX_WARPS * ROWS, warp, g, q4);
        }
    }

#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + e;
            if (col < K) {
                if (okA) out[static_cast<long long>(rowA) * K + col] = logf(fmaxf(q[n][e], FLOOR)) + ca;
                if (okB) out[static_cast<long long>(rowB) * K + col] = logf(fmaxf(q[n][2 + e], FLOOR)) + cb;
            }
        }
    }
}

template <int NT>
cudaError_t launch(const float* lo, const uint2* pf, const float* lpi, float* out, int B, int T,
                   int K, int Kp, int tc, int warps, cudaStream_t stream) {
    const int ntiles = Kp / 8, KT = Kp / 16;
    const size_t fixed = static_cast<size_t>(ROWS) * (Kp + 8) * 2 * 2     // q, two buffers
                         + static_cast<size_t>(3) * MAX_WARPS * ROWS * 4;  // red_m, red_q
    const size_t per_kt = static_cast<size_t>(ntiles) * 256;
    int kt_res = static_cast<int>((SMEM_LIMIT - fixed) / per_kt);
    if (kt_res > KT) kt_res = KT;
    const size_t smem = fixed + kt_res * per_kt;
    auto kernel = bigk_kernel<NT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int blocks = (B + ROWS - 1) / ROWS;
    kernel<<<blocks, warps * 32, smem, stream>>>(lo, pf, lpi, out, B, T, K, Kp, tc, kt_res);
    return cudaGetLastError();
}

}  // namespace

// log_obs (B, T, K) float32, frags (Kp/16, Kp/8, 32, 4) bf16 (P = bf16(exp
// log_a), zero-padded to Kp = K rounded up to 64, in B-fragment order),
// log_pi (K,) float32, out (B, K) float32; all contiguous on `device`.
// 1 <= K <= 1024, 1 <= B <= 4096, T % t_chunk == 0. Launches on `stream`,
// returns a CUDA error code.
extern "C" int bigk_scoring_f32(const float* lo, const void* frags, const float* lpi, float* out,
                                int B, int T, int K, int t_chunk, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B < 1 || B > MAX_B || K < 1 || K > MAX_K || T < 1 || t_chunk < 1 || T % t_chunk != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int Kp = (K + 63) / 64 * 64;
    const int ntiles = Kp / 8;
    const int NT = ntiles <= 16 ? 1 : ntiles <= 32 ? 2 : ntiles <= 64 ? 4 : 8;
    const int warps = ntiles / NT;
    const uint2* pf = static_cast<const uint2*>(frags);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (NT) {
        case 1: err = launch<1>(lo, pf, lpi, out, B, T, K, Kp, t_chunk, warps, s); break;
        case 2: err = launch<2>(lo, pf, lpi, out, B, T, K, Kp, t_chunk, warps, s); break;
        case 4: err = launch<4>(lo, pf, lpi, out, B, T, K, Kp, t_chunk, warps, s); break;
        default: err = launch<8>(lo, pf, lpi, out, B, T, K, Kp, t_chunk, warps, s); break;
    }
    return static_cast<int>(err);
}
