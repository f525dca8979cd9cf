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
// and ~6.1 MB of output, about 5 us at 3.35 TB/s, and does ~0.49 GFLOP
// of float32 FMA, about 7 us on the CUDA cores (67 TFLOP/s). Both are
// estimates from the shapes, not measurements. The two bounds are close,
// so the kernel must neither re-read x nor starve the FMA pipes.
//
// Design: a tiled shared-memory product. Each 256-thread block owns a
// 64-row x 64-column output tile and walks D in slices of 16. Per slice
// it stages x (and x^2, squared once in float32 as it is loaded, before
// any product, like the TPU kernel) and the matching Wq / Wl slices in
// shared memory; each thread then accumulates a 4 x 4 register tile with
// two float32 FMAs per term and adds the bias last. Every observation is
// read from device memory once per column tile, and N <= 64 (the GMM
// decode case) is a single column tile. Ragged edges in R, D and N are
// masked in the kernel. True float32 throughout: no TF32, no bf16, no
// tensor cores; a wgmma path is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // columns per block
constexpr int BK = 16;        // D slice staged per step
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int XPAD = 4;       // keeps the transposed x stores off one bank

__global__ void __launch_bounds__(THREADS)
diag_quadratic_kernel(const float* __restrict__ x,
                      const float* __restrict__ wq,
                      const float* __restrict__ wl,
                      const float* __restrict__ bias,
                      float* __restrict__ out,
                      long long R, int D, int N) {
    __shared__ float xs[BK][BM + XPAD];
    __shared__ float x2s[BK][BM + XPAD];
    __shared__ float wqs[BK][BN];
    __shared__ float wls[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
    const long long row0 = static_cast<long long>(blockIdx.x) * BM;
    const int col0 = blockIdx.y * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
        // x slice: neighbouring threads read neighbouring d of one row.
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int r = i / BK, k = i % BK;
            const long long gr = row0 + r;
            const int gk = k0 + k;
            const float v = (gr < R && gk < D) ? x[gr * D + gk] : 0.f;
            xs[k][r] = v;
            x2s[k][r] = v * v;
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int k = i / BN, c = i % BN;
            const int gk = k0 + k, gc = col0 + c;
            const bool ok = gk < D && gc < N;
            wqs[k][c] = ok ? wq[static_cast<long long>(gk) * N + gc] : 0.f;
            wls[k][c] = ok ? wl[static_cast<long long>(gk) * N + gc] : 0.f;
        }
        __syncthreads();

#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], a2[TM], q[TN], l[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                a[i] = xs[k][ty * TM + i];
                a2[i] = x2s[k][ty * TM + i];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                q[j] = wqs[k][tx * TN + j];
                l[j] = wls[k][tx * TN + j];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc[i][j] = fmaf(a2[i], q[j], acc[i][j]);
                    acc[i][j] = fmaf(a[i], l[j], acc[i][j]);
                }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long r = row0 + ty * TM + i;
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c < N) out[r * N + c] = acc[i][j] + bias[c];
        }
    }
}

}  // namespace

// x (R, D), wq / wl (D, N), bias (N,), out (R, N): float32, contiguous,
// on `device`. Launches on `stream` and returns cudaGetLastError().
extern "C" int diag_quadratic_f32(const float* x, const float* wq,
                                  const float* wl, const float* bias,
                                  float* out, long long R, int D, int N,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((R + BM - 1) / BM),
                    static_cast<unsigned>((N + BN - 1) / BN));
    diag_quadratic_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x, wq, wl, bias, out, R, D, N);
    return static_cast<int>(cudaGetLastError());
}
