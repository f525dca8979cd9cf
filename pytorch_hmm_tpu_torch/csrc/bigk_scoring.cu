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
// bytes bound it. The frames cannot overlap, so what a frame costs is the
// latency of its product, its exchange and its barrier.
//
// Design: a thread-block cluster of CS CTAs (the plan, ops/bigk.py
// cluster_plan, picks CS from Kp = K rounded up to 64 and B: one CTA per
// 64 columns while every cluster fits on the card at once, else the
// fewest CTAs whose slice fits; CS = 16 at Kp = 1024 is a non-portable
// cluster size) per tile of 16 batch rows. CTA c
// owns the NC = Kp / CS columns [c NC, (c + 1) NC) of P (NC = 64, 128, 192
// or 256) and keeps that slice, all Kp rows, resident in shared memory in
// mma B-fragment order (128 KB at Kp = 1024, CS = 16), loaded once. Every
// CTA holds the whole bf16 q of its 16 rows, double buffered by frame
// parity. A frame:
//  1. max(8, NC / 16) warps compute the CTA's 16 x NC slice of
//     q_{t-1} @ P: warp w takes a quarter of the k-tiles (w % 4) and
//     NTW = 4 (NC = 64) or 8 n-tiles, so a warp runs NTW independent
//     accumulator chains Kp / 64 deep; the four k partials meet in shared
//     memory behind one block barrier;
//  2. 2 NC owner threads (a row and 8 columns each) sum them, multiply by
//     exp(lo_t - m_t) (log-obs of their columns loaded a frame ahead, m_t
//     from the row maxima exchanged a frame ahead), and on a rescale frame
//     exchange their row maxima of q through distributed shared memory
//     behind a second cluster barrier, so every CTA scales by the same r
//     and keeps the same C; maxima travel per 64-column group, Kp / 64
//     slots a row whatever CS is;
//  3. the owners store the bf16 slice with 16-byte st.shared::cluster into
//     every CTA's q buffer of the next parity, and their partial row maxima
//     of lo_{t+1} into every CTA's exchange slots;
//  4. one cluster barrier (arrive.release / wait.acquire) ends the frame.
// The host takes CS and the shared memory bytes from the plan, checks that
// the bytes cover the kernel's carve (carve() below) and checks
// cudaOccupancyMaxActiveClusters for the (CS, shared memory, threads)
// before each launch, returning an error where the card cannot hold one
// cluster: there is no other route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int ROWS = 16;                 // batch rows per cluster: one mma M tile
constexpr int GC = 64;                   // columns of a row-maximum group
constexpr int KSPLIT = 4;                // warps along k
constexpr int MAX_CS = 16;
constexpr int MAX_K = 1024;
constexpr int MAX_B = 4096;
constexpr int RESCALE = 16;
constexpr float FLOOR = 1e-37f;
constexpr size_t SMEM_LIMIT = 232448;    // dynamic shared memory a block may take

// The tiling of a CTA that owns NC columns.
template <int NC>
struct Tile {
    static constexpr int NTC = NC / 8;                       // its mma n-tiles
    static constexpr int OWNERS = ROWS * NC / 8;             // a row and 8 columns each
    static constexpr int THREADS = OWNERS > 256 ? OWNERS : 256;
    static constexpr int WARPS = THREADS / 32;
    static constexpr int NTW = NTC / (WARPS / KSPLIT);       // n-tiles a warp
    static constexpr int RS = NC + 8;                        // row stride of the k partials (floats)
    static_assert(NC % GC == 0 && NTC % (WARPS / KSPLIT) == 0, "tile");
};

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

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ unsigned cluster_index() {
    unsigned r;
    asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
    return r;
}

// The address of this CTA's shared `p` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned peer(const void* p, unsigned rank) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_peer(unsigned addr, uint4 v) {
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
}

__device__ __forceinline__ void st_peer(unsigned addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Every thread of every CTA of the cluster: writes before it (local and
// remote) are visible to reads after it.
__device__ __forceinline__ void cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Max over the 8 owner lanes of one row.
__device__ __forceinline__ float owners_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float max8(const float (&v)[8], float m) {
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, v[i]);
    return m;
}

// An owner's log-obs of frame t: its row, columns col .. col + 7; -inf
// past K (so exp gives 0), 0 past B. `vec`: the rows are 16-byte aligned
// (K % 4 == 0 and an aligned base), so whole groups load as float4.
__device__ __forceinline__ void load_lo(float (&v)[8], const float* __restrict__ lo, int row, int B,
                                        int t, int T, int K, int col, int vec) {
    if (row >= B) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col + i < K ? 0.f : -INFINITY;
        return;
    }
    const float* p = lo + (static_cast<long long>(row) * T + t) * K + col;
    if (vec && col + 8 <= K) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col + i < K ? __ldg(p + i) : -INFINITY;
    }
}

struct Smem {
    uint2* pres;      // (KT, NTC, 32) B fragments of this CTA's slice of P
    uint32_t* qbuf;   // (2, ROWS, Kp + 8) bf16 as words
    float* red;       // (KSPLIT, ROWS, NC + 8) k partials
    float* mx;        // (2, Kp / 64, ROWS) partial row maxima of lo, by frame parity
    float* rs;        // (Kp / 64, ROWS) partial row maxima of q on rescale frames
    unsigned char* end;
};

// Where each array sits in a CTA's shared memory from `base`: the one
// layout the kernel uses, and the host's check of the plan's bytes.
__host__ __device__ __forceinline__ Smem carve(unsigned char* base, int kp, int nc) {
    Smem s;
    s.pres = reinterpret_cast<uint2*>(base);
    s.qbuf = reinterpret_cast<uint32_t*>(base + static_cast<size_t>(kp) * nc * 2);
    s.red = reinterpret_cast<float*>(s.qbuf + ROWS * (kp + 8));
    s.mx = s.red + KSPLIT * ROWS * (nc + 8);
    s.rs = s.mx + 2 * (kp / GC) * ROWS;
    s.end = reinterpret_cast<unsigned char*>(s.rs + (kp / GC) * ROWS);
    return s;
}

size_t carve_bytes(int kp, int nc) {
    unsigned char base[16];
    return static_cast<size_t>(carve(base, kp, nc).end - base);
}

// Owners: this group's partial max of the row (8 lanes) into slot `slot`
// of `slots` (Kp / 64, ROWS) in every CTA.
__device__ __forceinline__ void push_max(float* slots, float m, unsigned rank, int cs, int slot, int row,
                                         int c8) {
    m = owners_max(m);
    if (c8 == 0) {
        for (int i = 0; i < cs; ++i) st_peer(peer(slots + slot * ROWS + row, (rank + i) % cs), m);
    }
}

__device__ __forceinline__ float slots_max(const float* slots, int gs, int row) {
    float m = -INFINITY;
    for (int i = 0; i < gs; ++i) m = fmaxf(m, slots[i * ROWS + row]);
    return m;
}

// q *= 1/r, C += log r, r the row max of q over every CTA's columns
// (floored). Every thread of the cluster calls it (one cluster barrier).
__device__ __forceinline__ void rescale(float (&q)[8], float& c, const Smem& s, bool owner, unsigned rank,
                                        int cs, int gs, int slot, int row, int c8) {
    if (owner) push_max(s.rs, max8(q, 0.f), rank, cs, slot, row, c8);   // q >= 0
    cluster_sync();
    if (owner) {
        const float r = fmaxf(slots_max(s.rs, gs, row), FLOOR);
        const float inv = 1.0f / r;
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] *= inv;
        c += logf(r);
    }
}

// Owners: bf16(q) into columns col .. col + 7 of every CTA's q buffer `qb`.
__device__ __forceinline__ void push_q(uint32_t* qb, const float (&q)[8], unsigned rank, int cs, int QS,
                                       int row, int col) {
    const uint4 v = make_uint4(pack_bf16(q[0], q[1]), pack_bf16(q[2], q[3]), pack_bf16(q[4], q[5]),
                               pack_bf16(q[6], q[7]));
    const uint32_t* at = qb + ((row * QS + col) >> 1);
    for (int i = 0; i < cs; ++i) st_peer(peer(at, (rank + i) % cs), v);
}

template <int NC>
__global__ void __launch_bounds__(Tile<NC>::THREADS, 1)
bigk_cluster_kernel(const float* __restrict__ lo,    // (B, T, K)
                    const uint4* __restrict__ pf,    // (CS, KT, NTC, 32, 4) bf16 slices of P
                    const float* __restrict__ lpi,   // (K,)
                    float* __restrict__ out,         // (B, K)
                    int B, int T, int K, int Kp, int cs, int tc, int vec) {
    using Tl = Tile<NC>;
    constexpr int NTC = Tl::NTC, NTW = Tl::NTW, RS = Tl::RS;
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem s = carve(smem, Kp, NC);
    const int KT = Kp / 16;
    const int KTW = KT / KSPLIT;                        // k-tiles a warp
    const int GS = Kp / GC;                             // row-maximum slots
    const int QS = Kp + 8;
    const unsigned rank = cluster_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q4 = lane & 3;
    const int kg = warp % KSPLIT, nt0 = (warp / KSPLIT) * NTW;
    const bool owner = tid < Tl::OWNERS;
    const int grp = tid >> 7;                          // an owner's 64-column group
    const int row = (tid >> 3) & (ROWS - 1), c8 = tid & 7;
    const int lcol = grp * GC + c8 * 8;                // its first column in the slice
    const int col = static_cast<int>(rank) * NC + lcol;
    const int slot = static_cast<int>(rank) * (NC / GC) + grp;
    const int brow = static_cast<int>(cluster_index()) * ROWS + row;

    {   // Stage this CTA's slice of P.
        const int n16 = KT * NTC * 16;
        const uint4* src = pf + static_cast<size_t>(rank) * n16;
        uint4* dst = reinterpret_cast<uint4*>(s.pres);
        for (int i = tid; i < n16; i += Tl::THREADS) dst[i] = src[i];
    }
    cluster_sync();   // every CTA has started and staged its slice

    // Frame 0: the prior.
    float lc[8], ln[8], q[8] = {}, c = 0.f;
    if (owner) {
        load_lo(lc, lo, brow, B, 0, T, K, col, vec);
        push_max(s.mx, max8(lc, -INFINITY), rank, cs, slot, row, c8);
        if (T > 1) load_lo(ln, lo, brow, B, 1, T, K, col, vec);
    }
    cluster_sync();
    float m = 0.f;
    if (owner) {
        m = slots_max(s.mx, GS, row);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            q[i] = col + i < K ? expf(__ldg(lpi + col + i) + (lc[i] - m)) : 0.f;
    }
    rescale(q, c, s, owner, rank, cs, GS, slot, row, c8);
    c += m;
    if (T > 1) {
        if (owner) {
            push_q(s.qbuf + ROWS * QS / 2, q, rank, cs, QS, row, col);   // frame 1 reads buffer 1
            push_max(s.mx + GS * ROWS, max8(ln, -INFINITY), rank, cs, slot, row, c8);
#pragma unroll
            for (int i = 0; i < 8; ++i) lc[i] = ln[i];
        }
        cluster_sync();
    }

    for (int t = 1; t < T; ++t) {
        const int par = t & 1;
        const bool more = t + 1 < T;
        float e[8];
        if (owner) {
            if (more) load_lo(ln, lo, brow, B, t + 1, T, K, col, vec);
            m = slots_max(s.mx + par * GS * ROWS, GS, row);
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = expf(lc[i] - m);
        }

        float acc[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        const uint32_t* qa = s.qbuf + par * (ROWS * QS / 2);
        const uint2* pb = s.pres + (kg * KTW * NTC + nt0) * 32 + lane;
#pragma unroll 2
        for (int j = 0; j < KTW; ++j) {
            const int k0 = (kg * KTW + j) * 16 + 2 * q4;
            uint32_t a[4];
            a[0] = qa[(g * QS + k0) >> 1];
            a[1] = qa[((g + 8) * QS + k0) >> 1];
            a[2] = qa[(g * QS + k0 + 8) >> 1];
            a[3] = qa[((g + 8) * QS + k0 + 8) >> 1];
            uint2 b[NTW];
#pragma unroll
            for (int n = 0; n < NTW; ++n) b[n] = pb[(j * NTC + n) * 32];
#pragma unroll
            for (int n = 0; n < NTW; ++n) mma_bf16(acc[n], a, b[n]);
        }
        float* red = s.red + kg * ROWS * RS;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
            const int cc = (nt0 + n) * 8 + 2 * q4;
            *reinterpret_cast<float2*>(red + g * RS + cc) = make_float2(acc[n][0], acc[n][1]);
            *reinterpret_cast<float2*>(red + (g + 8) * RS + cc) = make_float2(acc[n][2], acc[n][3]);
        }
        __syncthreads();

        if (owner) {
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = 0.f;
#pragma unroll
            for (int k = 0; k < KSPLIT; ++k) {
                const float* p = s.red + (k * ROWS + row) * RS + lcol;
                const float4 x0 = *reinterpret_cast<const float4*>(p);
                const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
                q[0] += x0.x; q[1] += x0.y; q[2] += x0.z; q[3] += x0.w;
                q[4] += x1.x; q[5] += x1.y; q[6] += x1.z; q[7] += x1.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] *= e[i];
            c += m;
        }
        if (rescale_after(t, tc)) rescale(q, c, s, owner, rank, cs, GS, slot, row, c8);
        if (more && owner) {
            push_q(s.qbuf + (1 - par) * (ROWS * QS / 2), q, rank, cs, QS, row, col);
            push_max(s.mx + (1 - par) * GS * ROWS, max8(ln, -INFINITY), rank, cs, slot, row, c8);
#pragma unroll
            for (int i = 0; i < 8; ++i) lc[i] = ln[i];
        }
        cluster_sync();
    }

    if (owner && brow < B) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (col + i < K) out[static_cast<long long>(brow) * K + col + i] = logf(fmaxf(q[i], FLOOR)) + c;
    }
    cluster_sync();   // no CTA leaves while a peer may still address its shared memory
}

// `iters` cluster barriers in one cluster of `cs` CTAs; with `push`, each
// preceded by the frame's exchange at Kp = 1024 (128 threads storing 16
// bytes into each CTA).
__global__ void __launch_bounds__(256, 1) cluster_probe_kernel(int cs, int iters, int push) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* qb = reinterpret_cast<uint32_t*>(smem);
    const unsigned rank = cluster_rank();
    const int tid = threadIdx.x;
    const int QS = MAX_K + 8;
    float q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = static_cast<float>(tid + i);
    cluster_sync();
    for (int it = 0; it < iters; ++it) {
        if (push && tid < 128)
            push_q(qb + (it & 1) * (ROWS * QS / 2), q, rank, cs, QS, tid >> 3,
                   static_cast<int>(rank) * 64 + (tid & 7) * 8);
        cluster_sync();
    }
}

cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, const void* kernel, int blocks,
                      int threads, int cs, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (cs > 8) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(cs);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    return clusters > 0 ? cudaSuccess : cudaErrorInvalidClusterSize;
}

// The kernel for a plan of `cs` CTAs over `kp` padded states with `smem`
// bytes a CTA, and its threads; nullptr where the plan does not fit it
// (a slice width without an instantiation, or too few bytes for carve()).
const void* plan_kernel(int kp, int cs, size_t smem, int& threads) {
    if (cs < 1 || cs > MAX_CS || kp % cs != 0 || smem > SMEM_LIMIT) return nullptr;
    const int nc = kp / cs;
    if (smem < carve_bytes(kp, nc)) return nullptr;
    switch (nc) {
        case 64: threads = Tile<64>::THREADS; return reinterpret_cast<const void*>(bigk_cluster_kernel<64>);
        case 128: threads = Tile<128>::THREADS; return reinterpret_cast<const void*>(bigk_cluster_kernel<128>);
        case 192: threads = Tile<192>::THREADS; return reinterpret_cast<const void*>(bigk_cluster_kernel<192>);
        case 256: threads = Tile<256>::THREADS; return reinterpret_cast<const void*>(bigk_cluster_kernel<256>);
        default: return nullptr;
    }
}

}  // namespace

// log_obs (B, T, K) float32; frags (CS, Kp/16, Kp/(8 CS), 32, 4) bf16: P =
// bf16(exp log_a), zero-padded to Kp = K rounded up to 64, cut into CS
// column slices, each in B-fragment order (ops/bigk.py cluster_fragments);
// log_pi (K,) float32, out (B, K) float32; all contiguous on `device`.
// 1 <= K <= 1024, 1 <= B <= 4096, T % t_chunk == 0. `cs` and `smem` are the
// plan's (ops/bigk.py cluster_plan): CTAs a cluster (Kp / cs one of 64,
// 128, 192, 256) and dynamic shared memory bytes a CTA, at least what the
// kernel's carve takes. Launches ceil(B / 16) clusters on `stream`;
// returns a CUDA error code (cudaErrorInvalidClusterSize where the card
// cannot hold one such cluster).
extern "C" int bigk_scoring_f32(const float* lo, const void* frags, const float* lpi, float* out,
                                int B, int T, int K, int cs, int smem, int t_chunk, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B < 1 || B > MAX_B || K < 1 || K > MAX_K || T < 1 || t_chunk < 1 || T % t_chunk != 0 || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int Kp = (K + 63) / 64 * 64;
    int threads = 0;
    const void* kernel = plan_kernel(Kp, cs, static_cast<size_t>(smem), threads);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const int tiles = (B + ROWS - 1) / ROWS;
    err = configure(cfg, attr, kernel, tiles * cs, threads, cs, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec = (K % 4 == 0 && reinterpret_cast<uintptr_t>(lo) % 16 == 0) ? 1 : 0;
    const uint4* pf = static_cast<const uint4*>(frags);
    switch (Kp / cs) {
        case 64: err = cudaLaunchKernelEx(&cfg, bigk_cluster_kernel<64>, lo, pf, lpi, out, B, T, K, Kp, cs,
                                          t_chunk, vec); break;
        case 128: err = cudaLaunchKernelEx(&cfg, bigk_cluster_kernel<128>, lo, pf, lpi, out, B, T, K, Kp, cs,
                                           t_chunk, vec); break;
        case 192: err = cudaLaunchKernelEx(&cfg, bigk_cluster_kernel<192>, lo, pf, lpi, out, B, T, K, Kp, cs,
                                           t_chunk, vec); break;
        default: err = cudaLaunchKernelEx(&cfg, bigk_cluster_kernel<256>, lo, pf, lpi, out, B, T, K, Kp, cs,
                                          t_chunk, vec); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The clusters of the plan (`cs`, `smem`) for K states that the card holds
// at once, into *clusters (0 where it cannot hold one).
extern "C" int bigk_active_clusters(int K, int cs, int smem, int device, int* clusters) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (K < 1 || K > MAX_K || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int Kp = (K + 63) / 64 * 64;
    int threads = 0;
    const void* kernel = plan_kernel(Kp, cs, static_cast<size_t>(smem), threads);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = configure(cfg, attr, kernel, cs, threads, cs, static_cast<size_t>(smem), nullptr);
    if (err != cudaSuccess && err != cudaErrorInvalidClusterSize) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// One cluster of `cs` CTAs running `iters` cluster barriers (with `push`,
// each after the q exchange of a Kp = 1024 frame): a probe of what the
// kernel's frames cost beside their products. Launches on `stream`.
extern "C" int bigk_cluster_probe(int cs, int iters, int push, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cs < 1 || cs > MAX_CS || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(2) * ROWS * (MAX_K + 8) * 2;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = configure(cfg, attr, reinterpret_cast<const void*>(cluster_probe_kernel), cs, 256, cs, smem,
                    static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, cs, iters, push);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
