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
// (the caller builds the tables from the parameters), then the trellis
// delta_t[j] = max_i(delta_{t-1}[i] + log_a[i, j]) + lo_t[j], candidates
// compared with a strict '>' in ascending i (the lowest-index tie, as
// core.viterbi), padded frames repeating each row's last valid state. The
// scores round differently from the unfused route (emission products,
// then a logsumexp) in their last bits; the trellis on given scores is
// the one of csrc/scan_bigk.cu.
//
// What bounds it on an H100: at B=32, T=1000, S=64, C=2, D=80 the emission
// is 4 B T S C D = 1.3 GFLOP of float32 products (~20 us at 67 TFLOP/s
// over the card, but one block a sequence runs on one SM: 32 of 132) and
// the trellis a serial chain of T frames a sequence. The earlier design
// ran them in turns, a chunk's emission (scalar, re-reading and squaring
// each frame's features once per state) and then its trellis, with two
// block barriers a frame: 2.3 us a frame, two thirds of it emission.
//
// Design: warp roles on a ring of NS chunk slots of 64 frames, each guarded
// by mbarriers (full, done, empty), with no block barrier in the frame loop
// (as csrc/scan_prob.cu):
//   * NPW producer warps score chunk j + 1 while the chain runs chunk j.
//     They build the tables [A; Bm] (2 D x N, column s CP + c, CP = C
//     rounded up to a power of two) and the constants from the parameters
//     in shared memory, so the caller launches with no table work. The
//     chunk's features arrive by one cp.async.bulk (4-byte cp.async where
//     the rows are not 16-byte aligned; straight reads where the chunk
//     does not fit), are squared once a frame into [x^2; x] rows,
//     transposed (2 KD x 64, a k-block at a time) and multiplied against
//     the tables: a thread holds an 8-frame x 8-column tile (4 x 16 at CP =
//     16) of float32 FMA sums, never TF32. The logsumexp over a state's
//     components runs in registers; the scores go to the slot.
//   * the chain warps run the trellis: L threads a column, each with its
//     SEG rows of log_a's column in registers. On a frame's dependent path
//     only the max: the candidates delta_i + log_a[i, j], their max (the L
//     parts joined by xor shuffles), the new delta stored to a
//     double-buffered, swizzled vector, and an arrival on that buffer's
//     mbarrier. Then, while the other chain warps catch up, the argmax:
//     the lowest row whose candidate equals the max (the strict '>' in
//     ascending i of core.viterbi), which overwrites the frame's consumed
//     score in the slot as its backpointer. A frame waits on the mbarrier
//     of the delta before it.
//   * a store warp writes each finished slot's backpointers to the
//     (B, T, S) uint8 scratch, coalesced, and frees the slot; the
//     backtrace reads them back in the same launch.
// The tables stay resident in shared memory while they fit beside the
// ring, the transposed k-block and the raw chunk within 227 KB; else they
// are rebuilt a k-block at a time. The plan (KD, resident, raw) is
// fused_plan in ops/fused.py, which the entry point checks. What is left
// bounds it: each chain thread's own instruction stream, the max and then
// the argmax over its rows, several hundred cycles a frame at S = 64
// (the phase probe; PERF.md), and the pipeline's fill before frame 0
// (the tables and the first chunk's scores).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TC = 64;          // frames a chunk
constexpr int NS = 2;           // ring slots
constexpr int NPW = 4;          // producer warps
constexpr int XS = TC + 4;      // row stride of the transposed features
constexpr int BARS = 10;        // full, done, empty per slot; raw copy; two delta buffers; pad
constexpr int BT_MAX_FRAMES = 256;
constexpr unsigned FULL = 0xffffffffu;

#ifdef FUSED_GMM_PROBE
// The phase probe (-DFUSED_GMM_PROBE, reached only through
// fused_gmm_probe_f32): each role stamps its phases of a chunk with
// clock64(), each stamp after an instruction that consumes the phase's
// result, into g_probe[(block * chunks + chunk) * 10 + phase]: the chain's
// wait for its slot, then over its frames the waits for the delta before,
// the max and its stores, the argmax (thread 0); the producers' waits
// (slot, raw chunk), transposes (and table rows when streamed), products
// and scores (producer thread 0); the store warp's work (lane 0); the
// block's backtrace once (at chunk 0).
constexpr int PROBE_PHASES = 10;
__device__ long long* g_probe;
#define PROBE_SET(j, nch, i, cycles) \
    (g_probe[(static_cast<long long>(blockIdx.x) * (nch) + (j)) * PROBE_PHASES + (i)] = (cycles))
#define PROBE_CLOCK() clock64()
#else
#define PROBE_SET(j, nch, i, cycles) ((void)0)
#define PROBE_CLOCK() 0ll
#endif

// mbarrier and bulk-copy primitives (shared::cta addresses), as in
// csrc/scan_prob.cu.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return ok != 0;
}

// A wait past 2^34 cycles (~9 s) traps: a fault surfaces as a launch
// error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const long long start = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Shared-memory loads and stores at 32-bit shared addresses computed
// outside the frame loop (through generic pointers the compiler rebuilds
// the shared window's base inside it). Volatile: they keep their order
// against the barriers.
__device__ __forceinline__ float lds(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v));
}

__device__ __forceinline__ void sts_i(uint32_t a, int v) {
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v));
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p, size_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (bytes & 15) == 0;
}

// The chain at padded K: L threads a column (two above 32 states), NCW
// warps, SEG rows a thread.
template <int KP>
struct Vs {
    static constexpr int L = KP >= 64 ? 2 : 1;
    static constexpr int NCHAIN = KP * L;
    static constexpr int NCW = NCHAIN / 32;
    static constexpr int SEG = KP / L;
    static constexpr int THREADS = 32 * (NCW + NPW + 1);
    static_assert(SEG % 8 == 0 && NCHAIN % 32 == 0, "chain shape");
};

// Position of state i in the swizzled delta vector of L parts: part sl
// reads its v-th float4 at float4 index v L + sl.
template <int KP, int L>
__device__ __forceinline__ int vs_pos(int i) {
    constexpr int SEG = KP / L;
    return (((i % SEG) >> 2) * L + i / SEG) * 4 + (i & 3);
}

__device__ __forceinline__ void producer_sync() {
    asm volatile("bar.sync 2, %0;" ::"n"(32 * NPW) : "memory");
}

// Dynamic shared memory in bytes: barriers, the delta vectors, the
// constants, the ring, the tables (whole, or a k-block), the transposed
// k-block and the raw chunk. fused_plan in ops/fused.py computes the same.
__host__ __device__ inline size_t fused_bytes(int KP, int SP, int N, int D, int KD, int resident,
                                              int raw) {
    return sizeof(uint64_t) * BARS +
           sizeof(float) * (2 * static_cast<size_t>(KP) + N + static_cast<size_t>(NS) * TC * SP +
                            2 * static_cast<size_t>(resident ? D : KD) * N + 2 * static_cast<size_t>(KD) * XS +
                            (raw ? static_cast<size_t>(TC) * D : 0));
}

struct Args {
    const float* obs;        // (B, T, D)
    const float* means;      // (S, C, D)
    const float* log_vars;   // (S, C, D)
    const float* log_w;      // (S, C)
    const float* log_a;      // (S, S)
    const float* log_pi;     // (S,)
    const int* lengths;      // (B,) or null
    uint8_t* psi;            // (B, T, S) scratch
    int* states;             // (B, T)
    float* score;            // (B,)
    float dl2pi;             // D log(2 pi), rounded to float
    int T, D, S, C, SP, N, KD, resident, raw;
};

// Rows [d0, d0 + nd) of the tables into dst (2 nd, N): row 2 dl the x^2
// weights A = -1 / (2 var), row 2 dl + 1 the x weights Bm = mean / var of
// feature d0 + dl, column s CP + c; zero on padded columns. The arithmetic
// of emission_tables in ops/fused.py. By the producer threads.
template <int CP>
__device__ void build_tables(float* dst, const Args& g, int d0, int nd, int ptid) {
    const int N = g.N;
    for (int idx = ptid; idx < nd * N; idx += 32 * NPW) {
        const int dl = idx / N, col = idx - dl * N;
        const int s = col / CP, c = col - s * CP;
        float a = 0.f, bm = 0.f;
        if (s < g.S && c < g.C) {
            const long long p = static_cast<long long>(s * g.C + c) * g.D + d0 + dl;
            const float iv = expf(-g.log_vars[p]);
            a = -0.5f * iv;
            bm = g.means[p] * iv;
        }
        dst[2 * dl * N + col] = a;
        dst[(2 * dl + 1) * N + col] = bm;
    }
}

// The producers' tile: TF frames x TS columns a thread.
template <int CP>
struct Tile {
    static constexpr int TS = CP > 8 ? CP : 8;
    static constexpr int TF = 64 / TS;
};

template <int KP, int CP>
__global__ void __launch_bounds__(Vs<KP>::THREADS)
fused_gmm_kernel(Args g) {
    using V = Vs<KP>;
    using TL = Tile<CP>;
    constexpr int L = V::L, SEG = V::SEG, NCW = V::NCW;
    constexpr int TF = TL::TF, TS = TL::TS;
    extern __shared__ __align__(16) float dyn[];
    __shared__ int st_s[BT_MAX_FRAMES];
    __shared__ int last_s;

    const int T = g.T, D = g.D, S = g.S, SP = g.SP, N = g.N, KD = g.KD;
    uint64_t* bars = reinterpret_cast<uint64_t*>(dyn);
    uint64_t* full = bars;
    uint64_t* done = bars + NS;
    uint64_t* empty = bars + 2 * NS;
    uint64_t* rawbar = bars + 3 * NS;
    uint64_t* dbar = bars + 3 * NS + 1;                 // delta stored, by buffer
    float* dbuf = dyn + 2 * BARS;                       // (2, KP) swizzled delta
    float* cn_s = dbuf + 2 * KP;                        // (N,) constants
    float* ring = cn_s + N;                             // (NS, TC, SP)
    float* tab_s = ring + NS * TC * SP;                 // (2 D or 2 KD, N)
    float* xt = tab_s + 2 * (g.resident ? D : KD) * N;  // (2 KD, XS)
    float* raw_s = xt + 2 * KD * XS;                    // (TC, D) when staged

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const float* x = g.obs + static_cast<long long>(b) * T * D;
    uint8_t* psi = g.psi + static_cast<long long>(b) * T * S;
    int* st = g.states + static_cast<long long>(b) * T;
    int len = g.lengths ? g.lengths[b] : T;
    len = len < 1 ? 1 : (len > T ? T : len);
    const int nch = (len + TC - 1) / TC;
    const int nprobe = (T + TC - 1) / TC;

    if (tid == 0) {
        for (int s = 0; s < NS; ++s) {
            mbar_init(full + s, 32 * NPW);
            mbar_init(done + s, V::NCHAIN);
            mbar_init(empty + s, 32);
        }
        mbar_init(rawbar, 1);
        mbar_init(dbar, V::NCHAIN);
        mbar_init(dbar + 1, V::NCHAIN);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp < NCW) {
        // Chain: thread (col, sl) holds rows sl SEG .. sl SEG + SEG - 1 of
        // log_a's column col.
        const int col = tid / L, sl = tid % L;
        const bool writer = sl == 0;
        const bool real = col < S;
        float la[SEG];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
            const int r = sl * SEG + i;
            la[i] = r < S && real ? g.log_a[r * S + col] : -INFINITY;
        }
        const float pi = real ? g.log_pi[col] : -INFINITY;
        const uint32_t d_rd = smem_addr(dbuf) + sl * 16;
        const uint32_t d_wr = smem_addr(dbuf + vs_pos<KP, L>(col));
        for (int j = 0; j < nch; ++j) {
            const int s = j % NS, t0 = j * TC, n = min(TC, len - t0);
            // This column in the slot: frame f's score, then its backpointer.
            const uint32_t a_col = smem_addr(ring + s * TC * SP + col);
            const long long c0 = PROBE_CLOCK();
            mbar_wait(full + s, (j / NS) & 1);
            const long long c1 = PROBE_CLOCK();
            float lo_next = writer && real ? lds(a_col) : -INFINITY;
            long long waits = 0, maxes = 0, args = 0;
            for (int f = 0; f < n; ++f) {
                const int t = t0 + f;
                const float lo = lo_next;
                if (f + 1 < n && writer && real) lo_next = lds(a_col + (f + 1) * SP * 4);
                const long long cs = PROBE_CLOCK();
                long long cw = cs;
                float d, m = 0.f;
                float xv[SEG];
                if (t == 0) {
                    d = pi + lo;
                } else {
                    // The candidates delta_{t-1}[i] + log_a[i, j] of this
                    // thread's rows, and the column's max.
                    mbar_wait(dbar + ((t - 1) & 1), ((t - 1) >> 1) & 1);
                    cw = PROBE_CLOCK();
                    const uint32_t qb = d_rd + ((t - 1) & 1) * KP * 4;
#pragma unroll
                    for (int v = 0; v < SEG / 4; ++v) {
                        float4 e;
                        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                                     : "=f"(e.x), "=f"(e.y), "=f"(e.z), "=f"(e.w)
                                     : "r"(qb + v * L * 16));
                        xv[4 * v] = e.x + la[4 * v];
                        xv[4 * v + 1] = e.y + la[4 * v + 1];
                        xv[4 * v + 2] = e.z + la[4 * v + 2];
                        xv[4 * v + 3] = e.w + la[4 * v + 3];
                    }
                    float w[8];   // eight running maxima, then their tree
#pragma unroll
                    for (int i = 0; i < 8; ++i) w[i] = xv[i];
#pragma unroll
                    for (int i = 8; i < SEG; ++i) w[i % 8] = fmaxf(w[i % 8], xv[i]);
#pragma unroll
                    for (int st = 1; st < 8; st <<= 1)
#pragma unroll
                        for (int i = 0; i + st < 8; i += 2 * st) w[i] = fmaxf(w[i], w[i + st]);
                    m = w[0];
#pragma unroll
                    for (int o = 1; o < L; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
                    d = m + lo;
                }
                if (!real) d = -INFINITY;
                if (writer) sts(d_wr + (t & 1) * KP * 4, d);
                mbar_arrive(dbar + (t & 1));
                const long long cd = PROBE_CLOCK();
                if (t > 0) {
                    // Off the dependent path: the backpointer, the lowest row
                    // whose candidate equals the max.
                    int arg = KP;
#pragma unroll
                    for (int i = SEG - 1; i >= 0; --i)
                        if (xv[i] == m) arg = sl * SEG + i;
#pragma unroll
                    for (int o = 1; o < L; o <<= 1) arg = min(arg, __shfl_xor_sync(FULL, arg, o));
                    if (writer && real) sts_i(a_col + f * SP * 4, arg);
                }
#ifdef FUSED_GMM_PROBE
                waits += cw - cs;
                maxes += cd - cw;
                args += clock64() - cd;
#endif
            }
            if (tid == 0) {
                PROBE_SET(j, nprobe, 0, c1 - c0);
                PROBE_SET(j, nprobe, 1, waits);
                PROBE_SET(j, nprobe, 2, maxes);
                PROBE_SET(j, nprobe, 3, args);
            }
            mbar_arrive(done + s);
        }
    } else if (warp < NCW + NPW) {
        // Producers: score each chunk into its slot, a chunk ahead.
        const int ptid = tid - 32 * NCW, pw = warp - NCW;
        constexpr int NFT = TC / TF;                 // frame tiles
        const int tiles = NFT * (N / TS);
        const bool has_tile = ptid < tiles;
        const int f0 = (ptid % NFT) * TF, c0 = (ptid / NFT) * TS;
        const int nkb = (D + KD - 1) / KD;
        int raw_phase = 0;
        // Chunk j's rows: staged by one bulk copy, 4-byte copies, or read
        // in place.
        auto issue_raw = [&](int j) {
            const int n = min(TC, len - j * TC);
            const float* src = x + static_cast<long long>(j) * TC * D;
            const unsigned bytes = static_cast<unsigned>(n * D) * sizeof(float);
            if (aligned16(src, bytes)) {
                if (ptid == 0) {
                    fence_proxy_async();
                    mbar_arrive_tx(rawbar, bytes);
                    bulk_copy(raw_s, src, bytes, rawbar);
                }
            } else {
                for (int i = ptid; i < n * D; i += 32 * NPW)
                    __pipeline_memcpy_async(raw_s + i, src + i, sizeof(float));
                __pipeline_commit();
            }
        };
        auto wait_raw = [&](int j) {
            const int n = min(TC, len - j * TC);
            const float* src = x + static_cast<long long>(j) * TC * D;
            if (aligned16(src, static_cast<size_t>(n * D) * sizeof(float))) {
                mbar_wait(rawbar, raw_phase & 1);
                ++raw_phase;
            } else {
                __pipeline_wait_prior(0);
                producer_sync();
            }
        };
        if (g.raw) issue_raw(0);
        // The constants, a column a thread (the arithmetic of
        // emission_tables), and the tables when they stay resident.
        if (ptid < N) {
            const int s = ptid / CP, c = ptid - s * CP;
            float v = -INFINITY;
            if (s < S && c < g.C) {
                const long long p = static_cast<long long>(s * g.C + c) * D;
                float slv = 0.f, sq = 0.f;
                for (int d = 0; d < D; ++d) {
                    const float lv = g.log_vars[p + d], mu = g.means[p + d];
                    slv += lv;
                    sq += (mu * mu) * expf(-lv);
                }
                v = (g.log_w[s * g.C + c] - 0.5f * (g.dl2pi + slv)) - 0.5f * sq;
            }
            cn_s[ptid] = v;
        }
        if (g.resident) build_tables<CP>(tab_s, g, 0, D, ptid);
        producer_sync();
        float cn[TS];
#pragma unroll
        for (int c = 0; c < TS; ++c) cn[c] = has_tile ? cn_s[c0 + c] : 0.f;
        for (int j = 0; j < nch; ++j) {
            const int s = j % NS, t0 = j * TC, n = min(TC, len - t0);
            long long waited = 0, transposed = 0, multiplied = 0;
            long long w0 = PROBE_CLOCK();
            if (j >= NS) mbar_wait(empty + s, (j / NS - 1) & 1);
            waited += PROBE_CLOCK() - w0;
            float acc[TF][TS];
#pragma unroll
            for (int f = 0; f < TF; ++f)
#pragma unroll
                for (int c = 0; c < TS; ++c) acc[f][c] = 0.f;
            for (int kb = 0; kb < nkb; ++kb) {
                const int kd = kb * KD, kc = min(KD, D - kd);
                const float* tk = tab_s + (g.resident ? 2 * kd * N : 0);
                if (!g.resident) build_tables<CP>(tab_s, g, kd, kc, ptid);
                w0 = PROBE_CLOCK();
                if (kb == 0 && g.raw) wait_raw(j);
                const long long ct = PROBE_CLOCK();
                waited += ct - w0;
                // [x^2; x] of the k-block, transposed: lanes take 8 features x
                // 4 frames, the warps 16 frames at a time.
                const float* src = g.raw ? raw_s : x + static_cast<long long>(t0) * D;
                for (int kq = 0; kq < kc; kq += 8) {
                    const int k = kq + (lane & 7);
                    for (int fq = pw * 4; fq < TC; fq += 4 * NPW) {
                        const int f = fq + (lane >> 3);
                        if (k < kc) {
                            const float v = f < n ? src[f * D + kd + k] : 0.f;
                            xt[(2 * k) * XS + f] = v * v;
                            xt[(2 * k + 1) * XS + f] = v;
                        }
                    }
                }
                if (kb == nkb - 1 && g.raw && j + 1 < nch) {
                    producer_sync();   // the raw chunk is read: stage the next
                    issue_raw(j + 1);
                }
                producer_sync();
                const long long cp0 = PROBE_CLOCK();
                transposed += cp0 - ct;
                if (has_tile) {
                    for (int k = 0; k < kc; ++k) {
                        const float* xr = xt + 2 * k * XS + f0;
                        const float* tr = tk + 2 * k * N + c0;
                        float x2[TF], x1[TF], av[TS], bv[TS];
#pragma unroll
                        for (int f = 0; f < TF; f += 4) {
                            const float4 p = *reinterpret_cast<const float4*>(xr + f);
                            const float4 q = *reinterpret_cast<const float4*>(xr + XS + f);
                            x2[f] = p.x; x2[f + 1] = p.y; x2[f + 2] = p.z; x2[f + 3] = p.w;
                            x1[f] = q.x; x1[f + 1] = q.y; x1[f + 2] = q.z; x1[f + 3] = q.w;
                        }
#pragma unroll
                        for (int c = 0; c < TS; c += 4) {
                            const float4 p = *reinterpret_cast<const float4*>(tr + c);
                            const float4 q = *reinterpret_cast<const float4*>(tr + N + c);
                            av[c] = p.x; av[c + 1] = p.y; av[c + 2] = p.z; av[c + 3] = p.w;
                            bv[c] = q.x; bv[c + 1] = q.y; bv[c + 2] = q.z; bv[c + 3] = q.w;
                        }
#pragma unroll
                        for (int f = 0; f < TF; ++f)
#pragma unroll
                            for (int c = 0; c < TS; ++c) {
                                acc[f][c] = fmaf(x2[f], av[c], acc[f][c]);
                                acc[f][c] = fmaf(x1[f], bv[c], acc[f][c]);
                            }
                    }
                }
                producer_sync();   // the k-block's rows and tables are free
                multiplied += PROBE_CLOCK() - cp0;
            }
            const long long cq = PROBE_CLOCK();
            // The logsumexp over each state's CP components, into the slot.
            float* slot = ring + s * TC * SP;
            if (has_tile) {
#pragma unroll
                for (int f = 0; f < TF; ++f) {
                    if (f0 + f >= n) continue;
#pragma unroll
                    for (int q = 0; q < TS / CP; ++q) {
                        const int state = c0 / CP + q;
                        float v[CP];
                        float m = -INFINITY;
#pragma unroll
                        for (int c = 0; c < CP; ++c) {
                            v[c] = acc[f][q * CP + c] + cn[q * CP + c];
                            m = fmaxf(m, v[c]);
                        }
                        float sc = m;
                        if (CP > 1 && m != -INFINITY) {
                            float sum = 0.f;
#pragma unroll
                            for (int c = 0; c < CP; ++c) sum += expf(v[c] - m);
                            sc = m + logf(sum);
                        }
                        if (state < S) slot[(f0 + f) * SP + state] = sc;
                    }
                }
            }
            if (ptid == 0) {
                PROBE_SET(j, nprobe, 4, waited);
                PROBE_SET(j, nprobe, 5, transposed);
                PROBE_SET(j, nprobe, 6, multiplied);
                PROBE_SET(j, nprobe, 7, PROBE_CLOCK() - cq);
            }
            mbar_arrive(full + s);
        }
    } else {
        // Store warp: each finished slot's backpointers to the scratch.
        for (int j = 0; j < nch; ++j) {
            const int s = j % NS, t0 = j * TC, n = min(TC, len - t0);
            const int* slot_i = reinterpret_cast<const int*>(ring + s * TC * SP);
            mbar_wait(done + s, (j / NS) & 1);
            const long long c0 = PROBE_CLOCK();
            uint8_t* rows = psi + static_cast<long long>(t0) * S;
            const int f1 = t0 == 0 ? 1 : 0;
            if ((S & 3) == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0) {
                // Four backpointers a 32-bit store.
                const int q = S / 4;
                for (int i = f1 * q + lane; i < n * q; i += 32) {
                    const int f = i / q, k = 4 * (i - f * q);
                    const int4 v = *reinterpret_cast<const int4*>(slot_i + f * SP + k);
                    *reinterpret_cast<uint32_t*>(rows + f * S + k) =
                        (v.x & 0xff) | (v.y & 0xff) << 8 | (v.z & 0xff) << 16 | static_cast<uint32_t>(v.w & 0xff) << 24;
                }
            } else {
                for (int f = f1; f < n; ++f)
                    for (int k = lane; k < S; k += 32)
                        rows[f * S + k] = static_cast<uint8_t>(slot_i[f * SP + k]);
            }
            if (lane == 0) PROBE_SET(j, nprobe, 8, PROBE_CLOCK() - c0);
            mbar_arrive(empty + s);
        }
    }

    // Every role is done: the final delta and the scratch are written.
    // Score and the lowest-index argmax of the final delta, then the
    // backtrace.
    __syncthreads();
    const long long c2 = PROBE_CLOCK();
    if (tid == 0) {
        const float* dl = dbuf + ((len - 1) & 1) * KP;
        float best = dl[vs_pos<KP, L>(0)];
        int k0 = 0;
        for (int k = 1; k < S; ++k) {
            const float v = dl[vs_pos<KP, L>(k)];
            if (v > best) {
                best = v;
                k0 = k;
            }
        }
        g.score[b] = best;
        last_s = k0;
    }
    __syncthreads();
    int s = last_s;
    for (int t = len - 1 + tid; t < T; t += blockDim.x) st[t] = s;
    // Newest chunk first: frame t's backpointer row gives the state at
    // t - 1; rows staged in the ring's bytes.
    uint8_t* psi_st = reinterpret_cast<uint8_t*>(ring);
    int ch = NS * TC * SP * static_cast<int>(sizeof(float)) / S;
    ch = ch < BT_MAX_FRAMES ? ch : BT_MAX_FRAMES;
    for (int t1 = len - 1; t1 >= 1;) {
        const int t0 = max(1, t1 - ch + 1);
        const int n = t1 - t0 + 1;
        __syncthreads();
        for (int i = tid; i < n * S; i += blockDim.x) psi_st[i] = psi[static_cast<long long>(t0) * S + i];
        __syncthreads();
        if (tid == 0) {
            for (int t = t1; t >= t0; --t) {
                s = psi_st[(t - t0) * S + s];
                st_s[t - t0] = s;
            }
        }
        __syncthreads();
        for (int i = tid; i < n; i += blockDim.x) st[t0 - 1 + i] = st_s[i];
        t1 = t0 - 1;
    }
    if (tid == 0) PROBE_SET(0, nprobe, 9, PROBE_CLOCK() - c2);
}

template <int KP, int CP>
cudaError_t launch_kp(const Args& a, int B, size_t bytes, cudaStream_t st) {
    auto kernel = fused_gmm_kernel<KP, CP>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<B, Vs<KP>::THREADS, bytes, st>>>(a);
    return cudaGetLastError();
}

// Padded states KP with every CP the envelope allows there.
cudaError_t launch(const Args& a, int B, int CP, int bytes, cudaStream_t st) {
    const int S = a.S;
    const int KP = S <= 32 ? 32 : S <= 64 ? 64 : 128;
    const size_t need = fused_bytes(KP, a.SP, a.N, a.D, a.KD, a.resident, a.raw);
    if (S < 1 || S > 128 || a.SP != (S + 7) / 8 * 8 || a.N != a.SP * CP || a.N > 128 || a.KD < 1 ||
        a.KD > a.D || B < 1 || a.T < 1 || bytes < static_cast<long long>(need))
        return cudaErrorInvalidValue;
    if (KP == 128 && CP == 1) return launch_kp<128, 1>(a, B, bytes, st);
    if (KP == 64 && CP == 1) return launch_kp<64, 1>(a, B, bytes, st);
    if (KP == 64 && CP == 2) return launch_kp<64, 2>(a, B, bytes, st);
    if (KP == 32 && CP == 1) return launch_kp<32, 1>(a, B, bytes, st);
    if (KP == 32 && CP == 2) return launch_kp<32, 2>(a, B, bytes, st);
    if (KP == 32 && CP == 4) return launch_kp<32, 4>(a, B, bytes, st);
    if (KP == 32 && CP == 8) return launch_kp<32, 8>(a, B, bytes, st);
    if (KP == 32 && CP == 16) return launch_kp<32, 16>(a, B, bytes, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// obs (B, T, D), means and log_vars (S, C, D), log_w (S, C), log_a (S, S),
// log_pi (S,) float32; lengths (B,) int32 or null; psi (B, T, S) uint8
// scratch; states (B, T) int32 and score (B,) float32 out. All contiguous,
// on `device`; 1 <= S <= 128, ceil8(S) CP <= 128 with CP = C rounded up to
// a power of two; dl2pi = D log(2 pi); KD, resident, raw and `bytes` of
// shared memory from fused_plan (refused when short of the kernel's
// carve). Launches on `stream`, returns cudaGetLastError().
extern "C" int fused_gmm_viterbi_f32(const float* obs, const float* means, const float* log_vars,
                                     const float* log_w, const float* log_a, const float* log_pi,
                                     const int* lengths, uint8_t* psi, int* states, float* score,
                                     float dl2pi, int B, int T, int D, int S, int C, int CP, int KD,
                                     int resident, int raw, int bytes, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int SP = (S + 7) / 8 * 8;
    if (C < 1 || C > CP) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{obs, means, log_vars, log_w, log_a, log_pi, lengths, psi, states, score, dl2pi,
                 T, D, S, C, SP, SP * CP, KD, resident, raw};
    return static_cast<int>(launch(a, B, CP, bytes, static_cast<cudaStream_t>(stream)));
}

#ifdef FUSED_GMM_PROBE
// The decode, probed: arguments as fused_gmm_viterbi_f32 plus probe,
// (B, ceil(T / 64), 10) int64 cycles out.
extern "C" int fused_gmm_probe_f32(const float* obs, const float* means, const float* log_vars,
                                   const float* log_w, const float* log_a, const float* log_pi,
                                   const int* lengths, uint8_t* psi, int* states, float* score,
                                   long long* probe, float dl2pi, int B, int T, int D, int S, int C,
                                   int CP, int KD, int resident, int raw, int bytes, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyToSymbolAsync(g_probe, &probe, sizeof(probe), 0, cudaMemcpyHostToDevice,
                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return fused_gmm_viterbi_f32(obs, means, log_vars, log_w, log_a, log_pi, lengths, psi, states,
                                 score, dl2pi, B, T, D, S, C, CP, KD, resident, raw, bytes, device,
                                 stream);
}
#endif
