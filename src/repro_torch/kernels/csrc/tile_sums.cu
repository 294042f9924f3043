// One-pass row and column sums of a stack of matrices, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/checksum_verify/kernel.py
// (_tile_sums_kernel / tile_sums_pallas) together with the vmap that
// ops.tile_sums_batch puts around it: each element of x (B, m, n) is read
// once, cast to the accumulator type, and added into its row's and its
// column's sum.
//
// What bounds it on this card: bytes. Two additions per element read.
//
// What the design does about that: every element is loaded exactly once,
// 32 neighbouring threads on 32 neighbouring columns, with RM x RN
// independent loads in flight per thread; the batch is a grid axis; and x
// is addressed through its three strides, so the data block of a stack of
// full-checksum matrices (V[:, :-1, :-1]) is read in place instead of
// being copied first. A block reduces its TM x TN tile to TM row partials
// (a shuffle tree over the warp that shares the row) and TN column
// partials (through shared memory, in a fixed order); the caller adds the
// partials across tiles. No atomics, so results repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;    // threads along n: one warp shares a row
constexpr int TY = 8;     // threads along m
constexpr int TM = 64;    // rows per block
constexpr int TN = 128;   // columns per block
constexpr int RM = TM / TY;
constexpr int RN = TN / TX;
static_assert(TX == 32, "the row reduction is a warp shuffle");

template <typename TAcc> __device__ __forceinline__ TAcc to_acc(float v) { return static_cast<TAcc>(v); }
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(double v) { return static_cast<TAcc>(v); }
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(__nv_bfloat16 v) {
    return static_cast<TAcc>(__bfloat162float(v));
}

template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(TX * TY)
tile_sums_kernel(const TIn* __restrict__ x, TAcc* __restrict__ rowp, TAcc* __restrict__ colp,
                 int m, int n, long long sb, long long sm, long long sn, int mi, int nj)
{
    __shared__ TAcc red[TY][TN];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const long long bidx = blockIdx.x;
    const int ti = blockIdx.y, tj = blockIdx.z;
    const int row0 = ti * TM, col0 = tj * TN;
    const TIn* xb = x + bidx * sb;

    TAcc colacc[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) colacc[j] = TAcc(0);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int r = row0 + ty + i * TY;
        TAcc s = TAcc(0);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int cc = col0 + tx + j * TX;
            const TAcc v = (r < m && cc < n) ? to_acc<TAcc>(xb[(long long)r * sm + (long long)cc * sn]) : TAcc(0);
            s += v;
            colacc[j] += v;
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tx == 0 && r < m) rowp[(bidx * m + r) * nj + tj] = s;
    }

#pragma unroll
    for (int j = 0; j < RN; ++j) red[ty][tx + j * TX] = colacc[j];
    __syncthreads();
    const int tid = ty * TX + tx;
    if (tid < TN) {
        TAcc s = TAcc(0);
        for (int t = 0; t < TY; ++t) s += red[t][tid];
        const int cc = col0 + tid;
        if (cc < n) colp[(bidx * mi + ti) * n + cc] = s;
    }
}

template <typename TIn, typename TAcc>
int launch(const void* x, void* rowp, void* colp, int batch, int m, int n,
           long long sb, long long sm, long long sn, void* stream)
{
    if (batch <= 0 || m <= 0 || n <= 0) return 0;
    const int mi = (m + TM - 1) / TM, nj = (n + TN - 1) / TN;
    const dim3 block(TX, TY);
    const dim3 grid(batch, mi, nj);
    tile_sums_kernel<TIn, TAcc><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TIn*>(x), static_cast<TAcc*>(rowp), static_cast<TAcc*>(colp),
        m, n, sb, sm, sn, mi, nj);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (input type, accumulator type). x is (batch, m, n)
// with element strides (sb, sm, sn); rowp is (batch, m, ceil(n / TN)) and
// colp is (batch, ceil(m / TM), n), contiguous, in the accumulator type.
// Returns cudaGetLastError() of the launch.
extern "C" {

int tile_sums_tile_m() { return TM; }
int tile_sums_tile_n() { return TN; }

int tile_sums_f32(const void* x, void* rowp, void* colp, int batch, int m, int n,
                  long long sb, long long sm, long long sn, void* stream) {
    return launch<float, float>(x, rowp, colp, batch, m, n, sb, sm, sn, stream);
}

int tile_sums_bf16(const void* x, void* rowp, void* colp, int batch, int m, int n,
                   long long sb, long long sm, long long sn, void* stream) {
    return launch<__nv_bfloat16, float>(x, rowp, colp, batch, m, n, sb, sm, sn, stream);
}

int tile_sums_f64(const void* x, void* rowp, void* colp, int batch, int m, int n,
                  long long sb, long long sm, long long sn, void* stream) {
    return launch<double, double>(x, rowp, colp, batch, m, n, sb, sm, sn, stream);
}

}  // extern "C"
