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
// at 67 TFLOP/s), but each frame's product needs the frame before. Only
// the K-long dot and one multiply belong on the chain; the exp, the max of
// the emissions, the prefix sums of m and the log run over whole chunks of
// 64 frames, off it. One block runs one chain, time a loop inside it; the
// fused launch is 2B blocks, the forward chains and the backward chains,
// side by side on separate SMs (64 of 132 at B = 32), where the TPU's
// sequential grid had to interleave them in one program.
//
// Warp-specialised: the chunk passes are off the chain's path. Chain
// warps run only the frame loop; one producer warp works ahead, staging
// chunk j + 1 (one cp.async.bulk of the chunk's contiguous rows where the
// source is 16-byte aligned, else 4-byte cp.async) while it turns chunk j
// into e_t in place and scans its m; epilogue warps work behind, taking
// the logs of the finished rows, adding the shifts and writing them. The
// chunks pass through a ring of NS slots in shared memory, each guarded by
// mbarriers (full, chain done, empty, copy), with no block barrier after
// set-up. The chain threads split each K-long sum in L parts, their part
// of P in registers (Ws, by padded K): at K <= 32 one chain warp, a column
// a thread, the parts all-reduced by xor shuffles; at K = 64 and 128 KP
// chain threads, L columns a thread, the parts reduce-scattered, so each
// thread reads KP / L of q a frame instead of KP. The frame's q is traded
// through a double-buffered, swizzled shared vector under a named barrier
// of the chain warps alone (bar.warp.sync for one warp), at 32-bit shared
// addresses computed outside the loop. On the chain's path per frame: the
// q loads, the dot, the shuffles, one multiply by e_t (loaded a frame
// ahead), one shared store and the barrier. The rescale frames come as a
// bit mask made once a chunk; a rescale takes the max of the q already
// loaded and scales the dot after it (q/r @ P = (q @ P) / r), and thread 0
// records r. The epilogue turns the recorded r into C per frame (a double
// scan over the chunk), so the chain carries no C. What is left bounds it:
// the frame's dependent latency (shared store, barrier, loads, dot,
// reduction), 170-300 cycles at K <= 64 (the phase probe's frame loop;
// PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TC = 64;                // frames staged per chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;         // the TPU kernels' _NEG
constexpr float FLOOR = 1e-37f;       // the rescale and log floor

#ifdef SCAN_PROB_PROBE
// The phase probe, a separate build (-DSCAN_PROB_PROBE) reached only
// through scan_prob_probe_f32. Each role stamps its own phases of a chunk
// with clock64(): the chain's wait for its slot and frame loop (thread
// 0), the producer's wait for a free slot or a copy and its work (lane
// 0), the first epilogue warp's work (lane 0), stored to
// g_probe[(block * chunks + chunk) * 5 + phase].
constexpr int PROBE_PHASES = 5;
__device__ long long* g_probe;
#define PROBE_WS(j, nch, i, cycles) \
    (g_probe[(static_cast<long long>(blockIdx.x) * (nch) + (j)) * PROBE_PHASES + (i)] = (cycles))
#define PROBE_CLOCK() clock64()
#else
#define PROBE_WS(j, nch, i, cycles) ((void)0)
#define PROBE_CLOCK() 0ll
#endif

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

// mbarrier primitives (shared::cta addresses).
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

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait past 2^34 cycles (~9 s; a chunk takes microseconds) traps, so a
// fault surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const long long start = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - start > (1ll << 34)) __trap();
}

// One bulk asynchronous copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from device memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Shared-memory loads and stores at 32-bit shared addresses, computed once
// outside the frame loop: through generic pointers the compiler rebuilds
// the shared window's base (a read of SR_CgaCtaId) inside the loop, on
// the chain's path. Volatile, so they keep their order against the
// barriers.
__device__ __forceinline__ float4 lds4(uint32_t a) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(a));
    return v;
}

__device__ __forceinline__ float lds(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v));
}

// Orders this thread's generic-proxy shared accesses before later
// async-proxy ones (a bulk copy into a slot written before).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The shape of the chain at padded K: NCW chain warps, one producer warp,
// NEPI epilogue warps, a ring of NS chunk slots. The chain threads split
// the K-long sums in L parts. At K <= 32 (SCATTER false) one chain warp,
// a column a thread (L = 32 / KP threads a column, all-reduced by xor
// shuffles). At K = 64 and 128 (SCATTER) KP chain threads, a group of L
// threads owning L columns (L columns a thread, one part of the rows
// each), the parts reduce-scattered by xor shuffles so that each thread
// ends with one column's sum: each thread reads KP / L of q a frame
// instead of KP (the shared reads that bound the frame once several
// blocks share an SM).
// The fastest of the variants kernel_ab.py timed on the H100 (PERF.md).
template <int KP>
struct Ws {
    static constexpr bool SCATTER = KP >= 64;
    static constexpr int NCW = SCATTER ? KP / 32 : 1;
    static constexpr int NCHAIN = 32 * NCW;     // chain threads
    static constexpr int L = SCATTER ? KP / 32 : NCHAIN / KP;   // parts of a sum
    static constexpr int C = SCATTER ? L : 1;   // columns a thread
    static constexpr int SEG = KP / L;          // rows of the sum a thread holds
    static constexpr int NEPI = KP <= 32 ? 1 : KP == 64 ? 2 : 4;
    static constexpr int NS = KP >= 128 ? 3 : 4;
    static constexpr int THREADS = 32 * (NCW + 1 + NEPI);
    static constexpr int SIDE = 3 * TC;         // a slot's m, scan of m, rescale records
    static constexpr int BARS = 4 * NS;         // full, chain done, empty, copy per slot
    static constexpr size_t BYTES =
        sizeof(float) * (NS * TC * KP + 2 * KP + NS * SIDE) + sizeof(uint64_t) * BARS;
    static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "threads per column");
    static_assert(SCATTER ? NCHAIN == KP : NCHAIN == KP * L, "a column a thread, or L");
    static_assert(SEG >= 4 && SEG % 4 == 0, "sum part");
};

// Position of state i in a swizzled q vector of L parts: part sl = i / SEG
// reads its v-th float4 at float4 index v * L + sl, so one load
// instruction of the L parts touches 16 L consecutive bytes.
template <int KP, int L>
__device__ __forceinline__ int ws_pos(int i) {
    constexpr int SEG = KP / L;
    return (((i % SEG) >> 2) * L + i / SEG) * 4 + (i & 3);
}

// Bit i set when the i-th frame of a chunk, in the chain's order, is a
// rescale frame: t % rs == 0 and t > 0 going up (t = t0 + i), (t + 1) % rs
// == 0 and t + 1 < T going down (t = t0 + n - 1 - i).
template <bool BACKWARD>
__device__ __forceinline__ uint64_t rescale_mask(int t0, int n, int T, int rs) {
    uint64_t mask = 0;
    int i;
    if (BACKWARD) {
        i = (t0 + n) % rs;
        if (i == 0 && t0 + n == T) i = rs;
    } else {
        i = (rs - t0 % rs) % rs;
        if (i == 0 && t0 == 0) i = rs;
    }
    for (; i < n; i += rs) mask |= 1ull << i;
    return mask;
}

// The part sl of q @ M a thread holds (M's part in p), eight
// accumulators keeping eight products in flight.
template <int SEG>
__device__ __forceinline__ float seg_dot(const float4 (&x)[SEG / 4], const float (&p)[SEG]) {
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < SEG / 4; ++v) {
        float* acc = a + 4 * (v & 1);
        acc[0] = fmaf(x[v].x, p[4 * v], acc[0]);
        acc[1] = fmaf(x[v].y, p[4 * v + 1], acc[1]);
        acc[2] = fmaf(x[v].z, p[4 * v + 2], acc[2]);
        acc[3] = fmaf(x[v].w, p[4 * v + 3], acc[3]);
    }
    return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// As seg_dot with two accumulators, for a thread that holds C columns
// (2 C products in flight).
template <int SEG>
__device__ __forceinline__ float seg_dot2(const float4 (&x)[SEG / 4], const float (&p)[SEG]) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int v = 0; v < SEG / 4; ++v) {
        a0 = fmaf(x[v].x, p[4 * v], a0);
        a1 = fmaf(x[v].y, p[4 * v + 1], a1);
        a0 = fmaf(x[v].z, p[4 * v + 2], a0);
        a1 = fmaf(x[v].w, p[4 * v + 3], a1);
    }
    return a0 + a1;
}

// The chain warps' barrier: a named barrier over them alone, or the
// warp's own for one warp.
template <int NCW>
__device__ __forceinline__ void chain_sync() {
    if (NCW == 1)
        asm volatile("bar.warp.sync -1;" ::: "memory");
    else
        asm volatile("bar.sync 1, %0;" ::"n"(32 * NCW) : "memory");
}

// The producer warp's pre-pass over a slot holding n raw rows packed at
// stride K: each row becomes e = exp(lo - m) at stride KP (0 on the padded
// states, read as -inf) and its m goes to m_out. Rows go from the last down, four row
// groups a step with all loads before any store, so a row's writes never
// reach raw rows not yet read (row f's writes start at f KP >= f K).
template <int KP>
__device__ void ws_prepass(float* slot, float* m_out, int n, int K) {
    constexpr int W = KP < 32 ? KP : 32;        // lanes a row
    constexpr int RPW = 32 / W;                 // rows a warp instruction
    constexpr int EPL = KP / W;                 // elements a lane
    constexpr int G = 4;                        // row groups a step
    const int lane = threadIdx.x & 31;
    const int h = lane / W, k0 = lane % W;
    const int top = ((n - 1) / (RPW * G)) * (RPW * G);
    for (int fb = top; fb >= 0; fb -= RPW * G) {
        float v[G][EPL];
        float mx[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int f = fb + (G - 1 - g) * RPW + h;
            mx[g] = -INFINITY;
#pragma unroll
            for (int r = 0; r < EPL; ++r) {
                const int k = k0 + W * r;
                v[g][r] = f < n && k < K ? slot[f * K + k] : -INFINITY;
                mx[g] = fmaxf(mx[g], v[g][r]);
            }
        }
#pragma unroll
        for (int off = W / 2; off; off >>= 1)
#pragma unroll
            for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], off));
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int f = fb + (G - 1 - g) * RPW + h;
            const float m = fmaxf(mx[g], NEG);
            // exp(-inf - m) = 0 on the padded states: no branch, so the
            // row groups' exps overlap.
            float ex[EPL];
#pragma unroll
            for (int r = 0; r < EPL; ++r) ex[r] = expf(v[g][r] - m);
            if (f < n) {
#pragma unroll
                for (int r = 0; r < EPL; ++r) slot[f * KP + k0 + W * r] = ex[r];
                if (k0 == 0) m_out[f] = m;
            }
        }
    }
}

// One chain of one sequence by a warp-specialised block: the forward
// chain writes alpha (B, T, K) rows, the backward chain beta rows.
template <int KP, bool BACKWARD>
__device__ void run_ws(float* smem, const float* lo, const float* pa, const float* log_pi, float* out,
                       float* shift_out, int T, int K, int rs) {
    using S = Ws<KP>;
    constexpr int L = S::L, C = S::C, SEG = S::SEG, NS = S::NS, NCW = S::NCW;
    float* slots = smem;
    float* q = slots + NS * TC * KP;
    float* side = q + 2 * KP;
    uint64_t* bars = reinterpret_cast<uint64_t*>(side + NS * S::SIDE);
    uint64_t* full = bars;
    uint64_t* done = bars + NS;
    uint64_t* empty = bars + 2 * NS;
    uint64_t* copied = bars + 3 * NS;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nch = (T + TC - 1) / TC;
    auto chunk = [&](int j) { return BACKWARD ? nch - 1 - j : j; };
    auto rows = [&](int ck) { return min(TC, T - ck * TC); };

    if (tid == 0) {
        for (int s = 0; s < NS; ++s) {
            mbar_init(full + s, 32);
            mbar_init(done + s, S::NCHAIN);
            mbar_init(empty + s, 32 * S::NEPI);
            mbar_init(copied + s, 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (tid < S::NCHAIN && (C == L || tid % L == 0)) {
        const int col = C == L ? tid : tid / L;
        q[ws_pos<KP, L>(col)] = BACKWARD && col < K ? 1.f : 0.f;
    }
    __syncthreads();

    if (warp < NCW) {
        // Chain warps: the frame loop. Thread (grp, sl) holds rows sl SEG to
        // (sl + 1) SEG of P's column grp (C = 1) or of columns grp L to grp L +
        // L - 1 (C = L); its own output column is col.
        const int grp = tid / L, sl = tid % L;
        const int col = C == L ? tid : grp;
        const bool writer = C == L || sl == 0;
        float p[C][SEG];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int pc = C == L ? grp * L + c : grp;
#pragma unroll
            for (int i = 0; i < SEG; ++i) {
                const int r = sl * SEG + i;
                p[c][i] = r < K && pc < K ? (BACKWARD ? pa[pc * K + r] : pa[r * K + pc]) : 0.f;
            }
        }
        const float pi_col = !BACKWARD && col < K ? expf(log_pi[col]) : 0.f;
        // Shared addresses: this thread's part of a q buffer, its column's
        // slot in one, and (per chunk) its column of the slot.
        constexpr uint32_t QBYTES = KP * 4, ROW = KP * 4;
        const uint32_t q_rd = smem_addr(q) + sl * 16;
        const uint32_t q_wr = smem_addr(q) + ws_pos<KP, L>(col) * 4;
        int cur = 0;
        for (int j = 0; j < nch; ++j) {
            const int s = j % NS, ck = chunk(j), t0 = ck * TC, n = rows(ck);
            const uint32_t ea = smem_addr(slots + s * TC * KP) + col * 4;
            const uint32_t ra = smem_addr(side + s * S::SIDE + 2 * TC);
            const uint64_t mask = rescale_mask<BACKWARD>(t0, n, T, rs);
            const long long c0 = PROBE_CLOCK();
            mbar_wait(full + s, (j / NS) & 1);
            const long long c1 = PROBE_CLOCK();
            float ev = lds(ea + (BACKWARD ? n - 1 : 0) * ROW);
            for (int i = 0; i < n; ++i) {
                const int f = BACKWARD ? n - 1 - i : i;
                float4 x[SEG / 4];
                const uint32_t qb = q_rd + cur * QBYTES;
#pragma unroll
                for (int v = 0; v < SEG / 4; ++v) x[v] = lds4(qb + v * L * 16);
                // The next frame's e_t, off this frame's path.
                const float en = i + 1 < n ? lds(ea + (BACKWARD ? f - 1 : f + 1) * ROW) : 0.f;
                float sum;
                if constexpr (C == 1) {
                    sum = seg_dot<SEG>(x, p[0]);
#pragma unroll
                    for (int o = 1; o < L; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
                } else {
                    float v[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) v[c] = seg_dot2<SEG>(x, p[c]);
                    // Reduce-scatter over the group: at each level the lanes
                    // with bit h keep the upper half of their columns and
                    // send the lower half to the partner, so lane sl ends
                    // with column grp L + sl summed over all L parts.
#pragma unroll
                    for (int h = L / 2; h >= 1; h >>= 1) {
                        const bool upper = sl & h;
#pragma unroll
                        for (int c = 0; c < h; ++c) {
                            const float send = upper ? v[c] : v[c + h];
                            const float keep = upper ? v[c + h] : v[c];
                            v[c] = keep + __shfl_xor_sync(FULL, send, h);
                        }
                    }
                    sum = v[0];
                }
                if ((mask >> i) & 1) {
                    float mx = 0.f;
#pragma unroll
                    for (int v = 0; v < SEG / 4; ++v)
                        mx = fmaxf(mx, fmaxf(fmaxf(x[v].x, x[v].y), fmaxf(x[v].z, x[v].w)));
#pragma unroll
                    for (int o = 1; o < L; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
                    const float r = fmaxf(mx, FLOOR);
                    sum *= 1.f / r;
                    if (tid == 0) sts(ra + f * 4, r);
                }
                // Forward: q_t = s * e_t is carried and staged. Backward:
                // s_t is staged and s_t * e_t carried.
                const float staged = BACKWARD ? sum : (t0 + f == 0 ? pi_col : sum) * ev;
                const float carried = BACKWARD ? sum * ev : staged;
                ev = en;
                cur ^= 1;
                if (writer) {
                    sts(q_wr + cur * QBYTES, carried);
                    sts(ea + f * ROW, staged);
                }
                chain_sync<NCW>();
            }
            if (tid == 0) {
                PROBE_WS(j, nch, 0, c1 - c0);
                PROBE_WS(j, nch, 1, PROBE_CLOCK() - c1);
            }
            fence_proxy_async();
            mbar_arrive(done + s);
        }
    } else if (warp == NCW) {
        // Producer warp: stage, pre-pass and m scan, a chunk ahead; chunk
        // j + 1's copy is in flight while chunk j's pre-pass runs.
        long long waited = 0;
        auto stage = [&](int j) {
            const int s = j % NS, ck = chunk(j), t0 = ck * TC, n = rows(ck);
            float* slot = slots + s * TC * KP;
            const long long w0 = PROBE_CLOCK();
            if (j >= NS) mbar_wait(empty + s, (j / NS - 1) & 1);
            waited += PROBE_CLOCK() - w0;
            fence_proxy_async();
            __syncwarp();
            const float* src = lo + static_cast<long long>(t0) * K;
            const unsigned bytes = static_cast<unsigned>(n * K) * sizeof(float);
            if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
                if (lane == 0) {
                    mbar_arrive_tx(copied + s, bytes);
                    bulk_copy(slot, src, bytes, copied + s);
                }
            } else {
                for (int idx = lane; idx < n * K; idx += 32)
                    __pipeline_memcpy_async(slot + idx, src + idx, sizeof(float));
                __pipeline_commit();
                __pipeline_wait_prior(0);
                __syncwarp();
                if (lane == 0) mbar_arrive(copied + s);
            }
        };
        stage(0);
        for (int j = 0; j < nch; ++j) {
            const long long c0 = PROBE_CLOCK();
            waited = 0;
            if (j + 1 < nch) stage(j + 1);
            const int s = j % NS, n = rows(chunk(j));
            float* slot = slots + s * TC * KP;
            float* m = side + s * S::SIDE;
            const long long w0 = PROBE_CLOCK();
            mbar_wait(copied + s, (j / NS) & 1);
            waited += PROBE_CLOCK() - w0;
            ws_prepass<KP>(slot, m, n, K);
            __syncwarp();
            scan_m<BACKWARD>(m, m + TC, n);
            __syncwarp();
            if (lane == 0) {
                PROBE_WS(j, nch, 2, waited);
                PROBE_WS(j, nch, 3, PROBE_CLOCK() - c0 - waited);
            }
            mbar_arrive(full + s);
        }
    } else {
        // Epilogue warps: logs, shifts and stores, a chunk behind.
        const int ew = warp - NCW - 1;
        double c_sum = 0.0;   // C after the chunks before, in double
        for (int j = 0; j < nch; ++j) {
            const int s = j % NS, ck = chunk(j), t0 = ck * TC, n = rows(ck);
            const float* x = slots + s * TC * KP;
            const float* m = side + s * S::SIDE;
            const float* scan = m + TC;
            const float* rrec = scan + TC;
            mbar_wait(done + s, (j / NS) & 1);
            const long long c0 = PROBE_CLOCK();
            // The chunk's rows are n K contiguous floats of the table: lanes
            // walk them flat (coalesced stores), four loads in flight a lane.
            // f = idx / K by a float product, exact for idx < 2^13.
            float* o = out + static_cast<long long>(t0) * K;
            const uint32_t xa = smem_addr(x);
            const int total = n * K;
            const float inv_k = 1.f / K;
            constexpr int STEP = 32 * S::NEPI;
            for (int base = ew * 32 + lane; base < total; base += 4 * STEP) {
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int idx = base + u * STEP;
                    const int f = static_cast<int>((idx + 0.5f) * inv_k);
                    v[u] = idx < total ? lds(xa + (f * KP + idx - f * K) * 4) : 1.f;
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (base + u * STEP < total) o[base + u * STEP] = logf(fmaxf(v[u], FLOOR));
            }
            if (ew == 0) {
                // C of each frame: the rescales' logs scanned in double in
                // the chain's order (two frames a lane), on top of the C
                // the chunks before left.
                const uint64_t mask = rescale_mask<BACKWARD>(t0, n, T, rs);
                const int i0 = 2 * lane, i1 = i0 + 1;
                const int f0 = BACKWARD ? n - 1 - i0 : i0, f1 = BACKWARD ? n - 1 - i1 : i1;
                const double d0 = i0 < n && ((mask >> i0) & 1) ? static_cast<double>(logf(rrec[f0])) : 0.0;
                const double d1 = i1 < n && ((mask >> i1) & 1) ? static_cast<double>(logf(rrec[f1])) : 0.0;
                double incl = d0 + d1;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const double y = __shfl_up_sync(FULL, incl, off);
                    if (lane >= off) incl += y;
                }
                double excl = __shfl_up_sync(FULL, incl, 1);
                if (lane == 0) excl = 0.0;
                if (i0 < n) {
                    const float cf = static_cast<float>(c_sum + (excl + d0));
                    shift_out[t0 + f0] = BACKWARD ? cf + (scan[f0] - m[f0]) : cf + scan[f0];
                }
                if (i1 < n) {
                    const float cf = static_cast<float>(c_sum + (excl + d0 + d1));
                    shift_out[t0 + f1] = BACKWARD ? cf + (scan[f1] - m[f1]) : cf + scan[f1];
                }
                c_sum += __shfl_sync(FULL, incl, 31);
                c_sum += BACKWARD ? scan[0] : scan[n - 1];
                if (lane == 0) PROBE_WS(j, nch, 4, PROBE_CLOCK() - c0);
            }
            mbar_arrive(empty + s);
        }
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
__global__ void __launch_bounds__(Ws<KP>::THREADS)
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
        run_ws<KP, false>(smem, log_obs + base, pa, log_pi, out.alpha + base, out.alpha_shift + frames, T,
                          K, rs);
    else
        run_ws<KP, true>(smem, log_obs + base, pa, nullptr, out.beta + base, out.beta_shift + frames, T, K,
                         rs);
}

template <int KP, bool FWD, bool BOTH>
cudaError_t launch_kp(const float* log_obs, const float* pa, const float* log_pi, Out out, int B,
                      int T, int K, int rs, cudaStream_t st) {
    constexpr size_t bytes = Ws<KP>::BYTES;
    auto kernel = prob_chain_kernel<KP, FWD, BOTH>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<BOTH ? 2 * B : B, Ws<KP>::THREADS, bytes, st>>>(log_obs, pa, log_pi, out, B, T, K, rs);
    return cudaGetLastError();
}

// The chains at the padded K: 16, 32, 64 or 128.
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

#ifdef SCAN_PROB_PROBE
// The chains, probed: arguments as scan_prob_fb_f32 (null tables for a
// chain not run) plus probe, (blocks, ceil(T / 64), 5) int64 cycles out,
// and chains = 1 the forward, 2 the backward, 3 both in one launch.
extern "C" int scan_prob_probe_f32(const float* log_obs, const float* pa, const float* log_pi,
                                   float* alpha, float* beta, float* alpha_shift,
                                   float* beta_shift, long long* probe, int B, int T, int K,
                                   int rs, int chains, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyToSymbolAsync(g_probe, &probe, sizeof(probe), 0, cudaMemcpyHostToDevice,
                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    const Out out{alpha, beta, alpha_shift, beta_shift};
    if (chains == 1) return launch<true, false>(log_obs, pa, log_pi, out, B, T, K, rs, device, stream);
    if (chains == 2) return launch<false, false>(log_obs, pa, nullptr, out, B, T, K, rs, device, stream);
    if (chains == 3) return launch<true, true>(log_obs, pa, log_pi, out, B, T, K, rs, device, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
#endif
