// Hard DTW over a distance matrix: the anti-diagonal min-plus wavefront and
// the walk back over its choices, in one launch.
//
// Replaces the TPU kernel of pytorch_hmm_tpu/ops/dtw.py (pallas_dtw,
// _dtw_kernel). Cell (i, j) lies on anti-diagonal k = i + j:
//   c0 = D[i-1, j-1] + d   (rabiner_juang: + 2d)
//   c1 = D[i-1, j]   + d
//   c2 = D[i, j-1]   + d,   d = dist[i, j]
//   D[i, j] = min(min(c0, c1), c2), choice = 0 if D == c0, else 1 if D == c1,
//   else 2 (so three +inf candidates give 0); D[0, 0] = d; cells off the
//   matrix are +inf.
// Then from (N-1, M-1), N+M-1 steps: emit (i, j), step by the choice (0:
// both, 1: i only, 2: j only), stop at the origin and stay there. The path
// is written reversed (origin first) with length = #{(i, j) : i + j > 0} + 1,
// the reference's convention. Adds and compares only: no contraction can
// change a value (2d is exact), so the result is bit-identical to the plain
// version's.
//
// What bounds it on an H100: the N+M-1 dependent diagonals. At 500x500 the
// bytes are 1 MB (~0.3 us at 3.35 TB/s); the time is set by 999 diagonals a
// block barrier apart and the walk back's 999 dependent reads.
//
// Design: one block per alignment. Thread t owns rows i = t + r * blockDim
// (r < R, R = 1, 2 or 4, so N <= 4096 at 1024 threads). Diagonals k-2, k-1
// and k live in a ring of three N-float rows in shared memory, so one
// __syncthreads() a diagonal orders every read of k-1, k-2 against the next
// write. Each thread loads its distances a diagonal ahead: the read
// dist[i, k-i] strides by M-1 floats across threads (uncoalesced, off the
// chain). The choices are 2 bits a cell: a thread packs 16 diagonals of each
// of its rows in a register and stores the word once every 16 diagonals into
// a (ceil((N+M-1)/16), N) word table, row-contiguous so the stores coalesce.
// The table lives in dynamic shared memory while it and the ring fit
// (126 KB at 500x500), else in a device buffer the wrapper allocates. One
// thread walks back in the same launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_N = 4096;
constexpr int MAX_M = 65536;
// Dynamic shared memory a block may take on an H100: 227 KB.
constexpr size_t SMEM_LIMIT = 232448;

template <int R, bool SMEM_TABLE>
__global__ void __launch_bounds__(MAX_THREADS)
dtw_kernel(const float* __restrict__ dist,    // (N, M)
           uint32_t* __restrict__ gtable,     // (NW, N), used unless SMEM_TABLE
           int* __restrict__ path_i,          // (N + M - 1,)
           int* __restrict__ path_j,          // (N + M - 1,)
           int* __restrict__ length,          // ()
           float* __restrict__ cost,          // ()
           int N, int M, int rj) {
    extern __shared__ __align__(16) uint32_t smem[];
    float* ring = reinterpret_cast<float*>(smem);          // (3, N)
    uint32_t* table = SMEM_TABLE ? smem + 3 * N : gtable;  // (NW, N)
    const float INF = __int_as_float(0x7f800000);
    const int W2 = N + M - 1;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    for (int x = tid; x < 3 * N; x += nt) ring[x] = INF;
    float dnext[R];
    uint32_t pack[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = tid + r * nt;
        dnext[r] = (i == 0) ? dist[0] : INF;
        pack[r] = 0u;
    }
    __syncthreads();

    for (int k = 0; k < W2; ++k) {
        float* cur = ring + (k % 3) * N;
        const float* p1 = ring + ((k + 2) % 3) * N;   // diagonal k-1
        const float* p2 = ring + ((k + 1) % 3) * N;   // diagonal k-2
        float dcur[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            dcur[r] = dnext[r];
            const int i = tid + r * nt;
            const int j = k + 1 - i;
            dnext[r] = (i < N && j >= 0 && j < M)
                           ? __ldg(dist + static_cast<long long>(i) * M + j) : INF;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = tid + r * nt;
            if (i < N) {
                const int j = k - i;
                const float d = dcur[r];
                const float diag = i > 0 ? p2[i - 1] : INF;
                const float up = i > 0 ? p1[i - 1] : INF;
                const float left = p1[i];
                const float c0 = rj ? diag + 2.0f * d : diag + d;
                const float c1 = up + d;
                const float c2 = left + d;
                float best = fminf(fminf(c0, c1), c2);
                const uint32_t choice = best == c0 ? 0u : (best == c1 ? 1u : 2u);
                if (k == 0 && i == 0) best = d;
                if (j < 0 || j >= M) best = INF;
                cur[i] = best;
                pack[r] |= choice << (2 * (k & 15));
                if ((k & 15) == 15 || k == W2 - 1) {
                    table[static_cast<long long>(k >> 4) * N + i] = pack[r];
                    pack[r] = 0u;
                }
            }
        }
        // Orders this diagonal's writes before the next one's reads, and
        // the table's stores before the walk.
        __syncthreads();
    }

    if (tid == 0) {
        int i = N - 1, j = M - 1, moved = 0;
        for (int t = 0; t < W2; ++t) {
            path_i[W2 - 1 - t] = i;
            path_j[W2 - 1 - t] = j;
            moved += (i + j) > 0;
            const int k = i + j;
            const uint32_t c = (table[static_cast<long long>(k >> 4) * N + i] >> (2 * (k & 15))) & 3u;
            const bool origin = i == 0 && j == 0;
            const int ni = origin ? 0 : i - (c == 2u ? 0 : 1);
            const int nj = origin ? 0 : j - (c == 1u ? 0 : 1);
            i = max(ni, 0);
            j = max(nj, 0);
        }
        *length = moved + 1;
        *cost = ring[((W2 - 1) % 3) * N + N - 1];
    }
}

template <int R, bool SMEM_TABLE>
cudaError_t launch(const float* dist, uint32_t* gtable, int* path_i, int* path_j, int* length,
                   float* cost, int N, int M, int rj, int threads, size_t smem, cudaStream_t stream) {
    auto kernel = dtw_kernel<R, SMEM_TABLE>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    kernel<<<1, threads, smem, stream>>>(dist, gtable, path_i, path_j, length, cost, N, M, rj);
    return cudaGetLastError();
}

}  // namespace

// dist (N, M) float32, contiguous, on `device`; table: (ceil((N+M-1)/16) * N)
// 32-bit words of device scratch, used when the choice table does not fit
// shared memory; path_i, path_j (N+M-1,) int32, length () int32 and cost ()
// float32 out. 1 <= N <= 4096, 1 <= M <= 65536; rj != 0 selects the
// rabiner_juang pattern. Launches on `stream`, returns a CUDA error code.
extern "C" int dtw_f32(const float* dist, uint32_t* table, int* path_i, int* path_j, int* length,
                       float* cost, int N, int M, int rj, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (N < 1 || M < 1 || N > MAX_N || M > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
    const int R = N <= MAX_THREADS ? 1 : (N <= 2 * MAX_THREADS ? 2 : 4);
    const int rows = (N + R - 1) / R;
    const int threads = (rows + 31) / 32 * 32;
    const long long words = static_cast<long long>((N + M - 1 + 15) / 16) * N;
    const size_t ring = static_cast<size_t>(3) * N * sizeof(float);
    const size_t with_table = ring + static_cast<size_t>(words) * sizeof(uint32_t);
    const bool in_smem = with_table <= SMEM_LIMIT;
    const size_t smem = in_smem ? with_table : ring;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int pattern = rj != 0;
    if (in_smem) {
        if (R == 1) err = launch<1, true>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
        else if (R == 2) err = launch<2, true>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
        else err = launch<4, true>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
    } else {
        if (R == 1) err = launch<1, false>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
        else if (R == 2) err = launch<2, false>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
        else err = launch<4, false>(dist, table, path_i, path_j, length, cost, N, M, pattern, threads, smem, s);
    }
    return static_cast<int>(err);
}
