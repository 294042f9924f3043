// Matrix product with a fused ABFT-checksum epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul/kernel.py
// (_abft_mm_kernel / abft_matmul_pallas): C = a @ b accumulated in TAcc,
// plus per-tile row sums (m, n/BN) and column sums (m/BM, n) of the
// accumulator, taken before the cast to the output type.
//
// What bounds it on this card: operations. The sweep's shape is
// (W, n) @ (n, n) in float64 with W in the hundreds, about W/4 FMAs for
// every byte of the operator, far above the card's FMA-to-byte ratio.
//
// What the design does about that: each block owns one BM x BN tile of C
// and loops over k itself (blocks run in any order, so nothing is carried
// between them); the operands are staged through shared memory in BK-deep
// slabs and every thread keeps an RM x RN accumulator in registers, so
// each value read from shared memory feeds RM or RN FMAs. Plain FMA in the
// accumulator type: float32 products are exact IEEE, not TF32. Ragged
// edges are masked in the kernel (zero on load, no store), so callers do
// not pad. The checksum partials are reduced across the block through
// shared memory in a fixed order and across tiles by the caller: no
// atomics, so results repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows of C per block
constexpr int BN = 64;   // columns of C per block
constexpr int BK = 16;   // depth of one shared-memory slab
constexpr int TX = 16;   // threads along n
constexpr int TY = 16;   // threads along m
constexpr int RM = BM / TY;
constexpr int RN = BN / TX;
static_assert(BM == BN && TX == TY, "the reduction scratch is shared");

template <typename TAcc> __device__ __forceinline__ TAcc to_acc(float v) { return static_cast<TAcc>(v); }
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(double v) { return static_cast<TAcc>(v); }
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(__nv_bfloat16 v) {
    return static_cast<TAcc>(__bfloat162float(v));
}

template <typename TOut, typename TAcc> struct Cast {
    static __device__ __forceinline__ TOut from(TAcc v) { return static_cast<TOut>(v); }
};
template <> struct Cast<__nv_bfloat16, float> {
    static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

template <typename TIn, typename TAcc, typename TOut>
__global__ void __launch_bounds__(TX * TY)
abft_mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
               TOut* __restrict__ c, TAcc* __restrict__ rowp, TAcc* __restrict__ colp,
               int m, int k, int n, long long lda, long long ldb, long long ldc, int nj)
{
    __shared__ TAcc As[BK][BM + 1];   // a tile, transposed: As[kk][row]
    __shared__ TAcc Bs[BK][BN];
    __shared__ TAcc red[BM][TX + 1];  // checksum partials of the block

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TX + tx;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

    TAcc acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = TAcc(0);

    for (int k0 = 0; k0 < k; k0 += BK) {
        for (int idx = tid; idx < BM * BK; idx += TX * TY) {
            const int r = idx / BK, kk = idx % BK;
            const int gr = row0 + r, gk = k0 + kk;
            As[kk][r] = (gr < m && gk < k) ? to_acc<TAcc>(a[(long long)gr * lda + gk]) : TAcc(0);
        }
        for (int idx = tid; idx < BK * BN; idx += TX * TY) {
            const int kk = idx / BN, cc = idx % BN;
            const int gk = k0 + kk, gc = col0 + cc;
            Bs[kk][cc] = (gk < k && gc < n) ? to_acc<TAcc>(b[(long long)gk * ldb + gc]) : TAcc(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            TAcc av[RM], bv[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
            for (int j = 0; j < RN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }

    // epilogue: the C tile, then the tile's row and column sums, all from
    // the accumulator before the cast
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int gr = row0 + ty + i * TY;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int gc = col0 + tx + j * TX;
            if (gr < m && gc < n) c[(long long)gr * ldc + gc] = Cast<TOut, TAcc>::from(acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        TAcc s = TAcc(0);
#pragma unroll
        for (int j = 0; j < RN; ++j) s += acc[i][j];
        red[ty + i * TY][tx] = s;
    }
    __syncthreads();
    if (tid < BM) {
        TAcc s = TAcc(0);
        for (int t = 0; t < TX; ++t) s += red[tid][t];
        const int gr = row0 + tid;
        if (gr < m) rowp[(long long)gr * nj + blockIdx.x] = s;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < RN; ++j) {
        TAcc s = TAcc(0);
#pragma unroll
        for (int i = 0; i < RM; ++i) s += acc[i][j];
        red[tx + j * TX][ty] = s;
    }
    __syncthreads();
    if (tid < BN) {
        TAcc s = TAcc(0);
        for (int t = 0; t < TY; ++t) s += red[tid][t];
        const int gc = col0 + tid;
        if (gc < n) colp[(long long)blockIdx.y * n + gc] = s;
    }
}

template <typename TIn, typename TAcc, typename TOut>
int launch(const void* a, const void* b, void* c, void* rowp, void* colp,
           int m, int k, int n, long long lda, long long ldb, long long ldc, void* stream)
{
    if (m <= 0 || n <= 0) return 0;
    const dim3 block(TX, TY);
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    abft_mm_kernel<TIn, TAcc, TOut><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c),
        static_cast<TAcc*>(rowp), static_cast<TAcc*>(colp), m, k, n, lda, ldb, ldc,
        static_cast<int>(grid.x));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (input type, accumulator type); the output has the
// input's type. a is (m, k) with row stride lda, b is (k, n) with ldb, c is
// (m, n) with ldc, all with unit column stride; rowp is (m, ceil(n / BN))
// and colp is (ceil(m / BM), n), contiguous, in the accumulator type.
// Returns cudaGetLastError() of the launch.
extern "C" {

int abft_mm_tile_m() { return BM; }
int abft_mm_tile_n() { return BN; }

int abft_mm_f32(const void* a, const void* b, void* c, void* rowp, void* colp, int m, int k, int n,
                long long lda, long long ldb, long long ldc, void* stream) {
    return launch<float, float, float>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
}

int abft_mm_bf16(const void* a, const void* b, void* c, void* rowp, void* colp, int m, int k, int n,
                 long long lda, long long ldb, long long ldc, void* stream) {
    return launch<__nv_bfloat16, float, __nv_bfloat16>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
}

int abft_mm_f64(const void* a, const void* b, void* c, void* rowp, void* colp, int m, int k, int n,
                long long lda, long long ldb, long long ldc, void* stream) {
    return launch<double, double, double>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
}

}  // extern "C"
