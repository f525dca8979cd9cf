// Diagonal-Gaussian Mahalanobis term for every mixture component, one
// read of the observations:
//
//     out[r, n] = sum_d x[r,d]^2 * Wq[d,n] + x[r,d] * Wl[d,n]  + b[n]
//
// Replaces the TPU kernel pytorch_hmm_tpu/ops/emit.py: diag_quadratic
// (_diag_quad_kernel), which squares each row tile in registers and hits
// it with two VMEM-resident (D, N) weight dots.
//
// What bounds it on an H100 at the decode headline shape (R = B*T =
// 32,000 rows, D = 80, N = S*C = 48): it moves ~10.2 MB of observations
// and ~6.1 MB of output, 4.9 us at 3.35 TB/s, and does ~0.50 GFLOP of
// float32 FMA, 7.4 us on the CUDA cores at 67 TFLOP/s: operations bound
// it (chip_smoke.py's bound, 0.0074 ms). True float32 throughout: no
// TF32, no bf16, no tensor cores.
//
// Design for Hopper (the plan, ops/emit.py:dq_plan, picks the column
// tile, the weight residency and the shared memory bytes per launch; the
// host checks those bytes against layout() below):
// * Column tile sized to N: 8 column groups of TN = ceil(N / (8 * tiles))
//   columns, tiles = ceil(N / 64), so N = 48 is one tile of 48 (TN = 6)
//   with no padded columns and N = 256 four tiles of 64 (tiles of 32 and
//   48 measured slower on the card there).
// * Weights resident: the tile's Wq and Wl columns (all of D) are staged
//   into shared memory once per block with cp.async, in the first unit's
//   copy group, 30 KB at D = 80, N = 48. Where they would pass 96 KB
//   (large D) each D chunk's weights ride in the ring beside the
//   observations instead.
// * Observations stream through a 4-stage ring of (128-row tile, 16-float
//   D chunk) units filled with 16-byte cp.async (4-byte where D % 4 != 0,
//   zero-filled past R and D), so the copies of the next units overlap
//   this unit's FMAs; one block barrier a unit. Blocks are persistent
//   over row tiles (grid = the blocks that fit at once, one column tile
//   per grid row), walking their units with counters, not divisions.
// * Each thread holds an 8-row x TN-column register tile: per 4 features
//   8 16-byte loads of x (one per row), squared in registers at the point
//   of use, and per feature TN-wide vector loads of Wq and Wl; the FMA
//   order per term is fmaf(x^2, wq, acc) then fmaf(x, wl, acc).
// * A finished tile, bias added, goes through a shared staging tile and
//   out as 16-byte row segments, so every store fills whole sectors (a
//   thread's own 24-byte segments did not, and cost more than the FMAs).
//
// Measured times are in PERF.md (chip_smoke.py, H100).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TM = 8;                        // rows per thread
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 4 * TM;           // 128 rows: a warp is 4 row groups x 8 column groups
constexpr int DC = 16;                       // features per ring unit
constexpr int STAGES = 4;
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory a block may take

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's shared memory in floats, for D features, column groups of
// TN and resident weights or not: the one layout the kernel carves, and
// the host's check of the plan's bytes.
struct Layout {
    int stage;    // floats of one ring unit
    int wl_res;   // the resident Wl tile (Wq's sits at 0)
    int ring;     // the ring of STAGES units
    int ostage;   // the (BM, 8 TN + 4) output staging tile
    int end;
};

__host__ __device__ __forceinline__ Layout layout(int D, int TN, int resident) {
    const int bn = 8 * TN, nch = (D + DC - 1) / DC;
    Layout l;
    l.stage = BM * DC + (resident ? 0 : 2 * DC * bn);
    l.wl_res = nch * DC * bn;
    l.ring = resident ? 2 * nch * DC * bn : 0;
    l.ostage = l.ring + STAGES * l.stage;
    l.end = l.ostage + BM * (bn + 4);
    return l;
}

// Where tile column c sits in a weight row. At TN = 8 the two 4-column
// halves of column groups 4-7 swap places, so the 8 groups' 16-byte loads
// of one half fall on distinct banks without padding the row.
template <int TN>
__device__ __forceinline__ int wpos(int c) {
    if constexpr (TN == 8) {
        const int cg = c >> 3, j = c & 7;
        return cg * 8 + ((((j >> 2) ^ (cg >> 2)) & 1) << 2) + (j & 3);
    } else {
        return c;
    }
}

// A column group's TN floats of a weight row (`sw`: its halves swapped,
// see wpos), in the widest aligned vectors.
template <int TN>
__device__ __forceinline__ void load_cols(float (&v)[TN], const float* p, int sw) {
    if constexpr (TN % 4 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
            const float4 w = *reinterpret_cast<const float4*>(p + ((((j >> 2) ^ sw) & 1) << 2) + (j & ~7));
            v[j] = w.x; v[j + 1] = w.y; v[j + 2] = w.z; v[j + 3] = w.w;
        }
    } else if constexpr (TN % 2 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 2) {
            const float2 w = *reinterpret_cast<const float2*>(p + j);
            v[j] = w.x; v[j + 1] = w.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = p[j];
    }
}

template <int TN>
__global__ void __launch_bounds__(THREADS)
diag_quadratic_kernel(const float* __restrict__ x,
                      const float* __restrict__ wq,
                      const float* __restrict__ wl,
                      const float* __restrict__ bias,
                      float* __restrict__ out,
                      long long R, int D, int N, int resident, int xvec, int wvec) {
    constexpr int BN = 8 * TN;
    constexpr int WRS = BN;                  // floats per feature row of a weight tile
    constexpr int OS = BN + 4;               // row stride of the output staging tile
    extern __shared__ __align__(16) float smem[];

    const int nch = (D + DC - 1) / DC;
    const Layout lay = layout(D, TN, resident);
    const int stage = lay.stage;
    float* wq_res = smem;                    // (nch * DC, WRS) when resident
    float* wl_res = smem + lay.wl_res;
    float* ring = smem + lay.ring;
    float* ostage = smem + lay.ostage;       // (BM, OS): a finished tile on its way out

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = lane & 7, rg = lane >> 3;
    const int sw = TN == 8 ? cg >> 2 : 0;        // this group's halves swapped (wpos)
    const int rbase = warp * 4 * TM + rg * TM;   // this thread's first row in the tile
    const int col0 = blockIdx.y * BN;
    const long long rtiles = (R + BM - 1) / BM;
    const int ntiles = static_cast<int>((rtiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
    const int units = ntiles * nch;

    // Copy the weights of features d0 .. d0 + nk - 1 of this column tile
    // into a (nk, BN) pair of tiles, zero past D and N: 16 bytes a copy
    // where N % 4 == 0 (four columns never straddle N).
    auto put_w = [&](float* dq, float* dl, int d0, int nk) {
        const int w = wvec ? 4 : 1;
        for (int i = tid; i < nk * BN / w; i += THREADS) {
            const int k = i / (BN / w), c = w * (i % (BN / w));
            const int gd = d0 + k, gc = col0 + c;
            const bool ok = gd < D && gc < N;
            const long long off = ok ? static_cast<long long>(gd) * N + gc : 0;
            const int at = k * WRS + wpos<TN>(c);
            if (wvec) {
                cp_async16(dq + at, wq + off, ok ? 16 : 0);
                cp_async16(dl + at, wl + off, ok ? 16 : 0);
            } else {
                cp_async4(dq + at, wq + off, ok ? 4 : 0);
                cp_async4(dl + at, wl + off, ok ? 4 : 0);
            }
        }
    };


    // Resident weights travel with the first unit's copy group.
    if (resident) put_w(wq_res, wl_res, 0, nch * DC);

    // Copy the next unit (this block's tile `it`, D chunk `ic`) into stage
    // `is`, then step the cursor; counters, not divisions, walk the units.
    int is = 0, it = 0, ic = 0;
    auto fetch = [&]() {
        float* xs = ring + is * stage;
        const long long row0 = (blockIdx.x + static_cast<long long>(it) * gridDim.x) * BM;
        const int d0 = ic * DC;
        if (xvec) {
            for (int i = tid; i < BM * DC / 4; i += THREADS) {
                const int r = i / (DC / 4), p = 4 * (i % (DC / 4));
                const long long gr = row0 + r;
                const bool ok = gr < R && d0 + p < D;
                cp_async16(xs + r * DC + p, ok ? x + gr * D + d0 + p : x, ok ? 16 : 0);
            }
        } else {
            for (int i = tid; i < BM * DC; i += THREADS) {
                const int r = i / DC, p = i % DC;
                const long long gr = row0 + r;
                const bool ok = gr < R && d0 + p < D;
                cp_async4(xs + r * DC + p, ok ? x + gr * D + d0 + p : x, ok ? 4 : 0);
            }
        }
        if (!resident) put_w(xs + BM * DC, xs + BM * DC + DC * WRS, d0, DC);
        is = is + 1 == STAGES ? 0 : is + 1;
        if (++ic == nch) ic = 0, ++it;
    };

    float b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int c = col0 + cg * TN + j;
        b[j] = c < N ? bias[c] : 0.f;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < units) fetch();
        cp_async_commit();
    }

    int cs = 0, ct = 0, ch = 0;   // the unit computed: stage, tile, chunk
    for (int u = 0; u < units; ++u) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // unit u has landed everywhere; stage (u - 1) % STAGES is free
        if (u + STAGES - 1 < units) fetch();
        cp_async_commit();

        const float* xs = ring + cs * stage;
        const float* wqs = resident ? wq_res + ch * DC * WRS : xs + BM * DC;
        const float* wls = resident ? wl_res + ch * DC * WRS : xs + BM * DC + DC * WRS;
        const float* xr = xs + rbase * DC;
        wqs += cg * TN;
        wls += cg * TN;
#pragma unroll
        for (int d4 = 0; d4 < DC / 4; ++d4) {
            float4 xv[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * DC + 4 * d4);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
                float q[TN], l[TN];
                load_cols<TN>(q, wqs + (4 * d4 + dd) * WRS, sw);
                load_cols<TN>(l, wls + (4 * d4 + dd) * WRS, sw);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float xi = reinterpret_cast<const float*>(&xv[i])[dd];
                    const float x2 = xi * xi;
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        acc[i][j] = fmaf(x2, q[j], acc[i][j]);
                        acc[i][j] = fmaf(xi, l[j], acc[i][j]);
                    }
                }
            }
        }

        if (ch == nch - 1) {
            // Stage the tile (plus the bias), then write it out row segment
            // by row segment, 16 bytes a thread where N % 4 == 0, so every
            // store fills whole sectors.
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                float* o = ostage + (rbase + i) * OS + cg * TN;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    o[j] = acc[i][j] + b[j];
                    acc[i][j] = 0.f;
                }
            }
            __syncthreads();
            const long long row0 = (blockIdx.x + static_cast<long long>(ct) * gridDim.x) * BM;
            const int ncols = N - col0 < BN ? N - col0 : BN;
            if (N % 4 == 0) {
                for (int i = tid; i < BM * (BN / 4); i += THREADS) {
                    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
                    if (row0 + r < R && c < ncols)
                        *reinterpret_cast<float4*>(out + (row0 + r) * N + col0 + c) =
                            *reinterpret_cast<const float4*>(ostage + r * OS + c);
                }
            } else {
                for (int i = tid; i < BM * BN; i += THREADS) {
                    const int r = i / BN, c = i % BN;
                    if (row0 + r < R && c < ncols) out[(row0 + r) * N + col0 + c] = ostage[r * OS + c];
                }
            }
        }
        cs = cs + 1 == STAGES ? 0 : cs + 1;
        if (++ch == nch) ch = 0, ++ct;
    }
    cp_async_wait<0>();
}

// Per-instantiation launch state: the dynamic shared memory limit is
// raised once, and the blocks an SM holds are cached per byte count.
struct Occupancy {
    bool raised = false;
    int smem = -1;
    int blocks = 0;
};

template <int TN>
cudaError_t launch(const float* x, const float* wq, const float* wl, const float* bias, float* out,
                   long long R, int D, int N, int ct, int resident, int smem, int device,
                   cudaStream_t stream) {
    static Occupancy occ;
    if (smem > SMEM_LIMIT || smem < 4LL * layout(D, TN, resident).end
        || static_cast<long long>(ct) * 8 * TN < N)
        return cudaErrorInvalidValue;
    auto kernel = diag_quadratic_kernel<TN>;
    cudaError_t err;
    if (!occ.raised) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (err != cudaSuccess) return err;
        occ.raised = true;
    }
    if (occ.smem != smem) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.blocks, kernel, THREADS, smem);
        if (err != cudaSuccess) return err;
        if (occ.blocks < 1) return cudaErrorInvalidConfiguration;
        occ.smem = smem;
    }
    static int sms[64] = {};
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (sms[device] == 0) {
        err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
    }
    const long long rtiles = (R + BM - 1) / BM;
    long long gx = static_cast<long long>(sms[device]) * occ.blocks / ct;
    if (gx < 1) gx = 1;
    if (gx > rtiles) gx = rtiles;
    const int xvec = (D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
    const int wvec = (N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0
                      && reinterpret_cast<uintptr_t>(wl) % 16 == 0) ? 1 : 0;
    kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(ct)), THREADS, smem, stream>>>(
        x, wq, wl, bias, out, R, D, N, resident, xvec, wvec);
    return cudaGetLastError();
}

}  // namespace

// x (R, D), wq / wl (D, N), bias (N,), out (R, N): float32, contiguous,
// on `device`. The launch plan is the wrapper's (ops/emit.py:dq_plan):
// `tn` (1..8) columns per thread, `ct` column tiles of 8 tn columns
// covering N, `resident` (the weights staged once per block, or riding in
// the ring) and `smem` dynamic shared memory bytes a block, at least what
// layout() carves. Launches on `stream` and returns a CUDA error code.
extern "C" int diag_quadratic_f32(const float* x, const float* wq, const float* wl,
                                  const float* bias, float* out, long long R, int D, int N,
                                  int tn, int ct, int resident, int smem, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (R < 1 || D < 1 || N < 1 || ct < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (tn) {
        case 1: err = launch<1>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 2: err = launch<2>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 3: err = launch<3>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 4: err = launch<4>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 5: err = launch<5>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 6: err = launch<6>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 7: err = launch<7>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        case 8: err = launch<8>(x, wq, wl, bias, out, R, D, N, ct, resident, smem, device, s); break;
        default: err = cudaErrorInvalidValue; break;
    }
    return static_cast<int>(err);
}
