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
// Inputs f16, bf16, f32 or f64, accumulated in f32 or f64, each element
// converted to the accumulator as it loads (the reference's
// x.astype(acc_dtype)).
//
// What the design does about that: every element is loaded exactly once,
// 32 neighbouring threads on 32 neighbouring columns, with RM x RN
// independent loads in flight per thread; the tiles of one matrix are
// grid x and the batch is grid y (at most 65535 matrices a launch, so a
// longer stack is cut into launches), so no count of tiles or matrices
// refuses a shape; and x
// is addressed through its three strides, so the data block of a stack of
// full-checksum matrices (V[:, :-1, :-1]) is read in place instead of
// being copied first. A block reduces its TM x TN tile to TM row partials
// (a shuffle tree over the warp that shares the row) and TN column
// partials (through shared memory, in a fixed order); the caller adds the
// partials across tiles. No atomics, so results repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(__half v) {
    return static_cast<TAcc>(__half2float(v));
}

template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(TX * TY)
tile_sums_kernel(const TIn* __restrict__ x, TAcc* __restrict__ rowp, TAcc* __restrict__ colp,
                 int m, int n, long long sb, long long sm, long long sn, int mi, int nj)
{
    __shared__ TAcc red[TY][TN];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const long long bidx = blockIdx.y;
    const int ti = static_cast<int>(blockIdx.x) / nj, tj = static_cast<int>(blockIdx.x) % nj;
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
    // matrices b0 .. b0 + 65535 of the stack in one launch
    constexpr int MAX_BATCH = 65535;
    for (long long b0 = 0; b0 < batch; b0 += MAX_BATCH) {
        const long long left = batch - b0;
        const dim3 grid(mi * nj, static_cast<unsigned>(left < MAX_BATCH ? left : MAX_BATCH));
        tile_sums_kernel<TIn, TAcc><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const TIn*>(x) + b0 * sb, static_cast<TAcc*>(rowp) + b0 * m * nj,
            static_cast<TAcc*>(colp) + b0 * mi * n, m, n, sb, sm, sn, mi, nj);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

// One entry point per (input type, accumulator type), tile_sums_<in>_<acc>
// for inputs f16, bf16, f32, f64 and accumulators f32, f64. x is (batch,
// m, n) with element strides (sb, sm, sn); rowp is (batch, m, ceil(n / TN))
// and colp is (batch, ceil(m / TM), n), contiguous, in the accumulator type.
// Returns cudaGetLastError() of the launches.
extern "C" {

int tile_sums_tile_m() { return TM; }
int tile_sums_tile_n() { return TN; }

#define TILE_SUMS_ENTRY(NAME, TIN, TACC)                                                    \
    int NAME(const void* x, void* rowp, void* colp, int batch, int m, int n, long long sb,  \
             long long sm, long long sn, void* stream) {                                    \
        return launch<TIN, TACC>(x, rowp, colp, batch, m, n, sb, sm, sn, stream);           \
    }
TILE_SUMS_ENTRY(tile_sums_f16_f32, __half, float)
TILE_SUMS_ENTRY(tile_sums_f16_f64, __half, double)
TILE_SUMS_ENTRY(tile_sums_bf16_f32, __nv_bfloat16, float)
TILE_SUMS_ENTRY(tile_sums_bf16_f64, __nv_bfloat16, double)
TILE_SUMS_ENTRY(tile_sums_f32_f32, float, float)
TILE_SUMS_ENTRY(tile_sums_f32_f64, float, double)
TILE_SUMS_ENTRY(tile_sums_f64_f32, double, float)
TILE_SUMS_ENTRY(tile_sums_f64_f64, double, double)
#undef TILE_SUMS_ENTRY

}  // extern "C"
