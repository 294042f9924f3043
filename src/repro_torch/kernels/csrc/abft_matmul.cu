// Matrix product with a fused ABFT-checksum epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul/kernel.py
// (_abft_mm_kernel / abft_matmul_pallas): C = a @ b accumulated in TAcc,
// plus per-tile row sums (m, n/BN) and column sums (m/BM, n) of the
// accumulator, taken before the cast to the output type.
//
// What bounds it on this card: operations. The sweep's shape is
// (W, n) @ (n, n) in float64 with W in the hundreds, about W/4 FMAs for
// every byte of the operator, far above the card's FMA-to-byte ratio: at
// (256, 4096) @ (4096, 4096), 8.6e9 flops take 0.128 ms at the FP64
// tensor-core peak (67 TFLOP/s) against 0.15 GB of bytes (0.045 ms).
//
// Which type takes which kernel (by the type alone, at build time):
//
// * f64 -> abft_mm_f64_dmma_kernel, on the FP64 tensor cores (DMMA;
//   wgmma has no f64 form): mma.sync.m16n8k4 f64, one of the shapes that
//   sm_90 added. On an H100 the m8n8k4 shape of sm_80 ran at about half
//   the rate (0.32 against 0.21 ms at the sweep's shape, kernel_variants.py)
//   and m16n8k8 and m16n8k16 were no faster; MMA_M / MMA_K select the shape
//   at build time so that script can time the others. A block of 4 warps
//   owns a 64 x 64 tile of C; each warp a 32 x 32 quarter, held as 2 x 4
//   fragments of 16 x 8 (32 doubles a thread). The operands come through a 4-stage
//   cp.async ring of 16-deep slabs, so three slabs are in flight while one
//   computes; rows of the shared-memory slabs are padded so that every
//   fragment load is free of bank conflicts. 16-byte copies where the
//   operands allow (even row strides, aligned starts), else 8-byte ones;
//   the ragged edge is zero-filled on load (copy size 0 or 8 of 16) and not
//   stored.
// * every other (input, accumulator) pair -> abft_mm_kernel, plain FMA on
//   the CUDA cores in the accumulator's type: inputs f16, bf16, f32 or f64,
//   accumulator f32 or f64, each element converted to the accumulator as it
//   loads (the reference's astype / preferred_element_type). float32
//   products stay exact IEEE, not TF32, which would miss the f32 checks.
//   Operands are staged through shared memory in 16-deep slabs and every
//   thread keeps a 4 x 4 accumulator. None of these runs on the sweep,
//   which calls gemm_batch in f64 only; abft_matmul takes f32 (the
//   reference accumulates in f32 whatever its inputs).
//
// Both operands have one type: the caller promotes the narrower of two
// to the wider (exact, as jnp.dot's promotion). C is written in the input
// type, or in the accumulator's when the caller asks for it (c_acc): a C
// of a third type (a's, narrower than the promoted operands) is then one
// rounding of the accumulator away, taken by the caller.
//
// Both keep the 64 x 64 tile, so the partials' layout does not depend on
// the type. Column tiles are grid x; row tiles are grid y, at most 65535 a
// launch, so a taller a is cut into launches of 65535 row tiles each. The epilogue is fused and repeatable: C and the tile's row and
// column sums are taken from the accumulator registers before the cast,
// reduced within a warp by shuffles and across warps through shared
// memory, always in the same order, and across tiles by the caller: no
// atomics, so results repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
template <typename TAcc> __device__ __forceinline__ TAcc to_acc(__half v) {
    return static_cast<TAcc>(__half2float(v));
}

// the accumulator rounded once to the output type
template <typename TOut, typename TAcc> struct Cast {
    static __device__ __forceinline__ TOut from(TAcc v) { return static_cast<TOut>(v); }
};
template <> struct Cast<__nv_bfloat16, float> {
    static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};
template <> struct Cast<__nv_bfloat16, double> {
    static __device__ __forceinline__ __nv_bfloat16 from(double v) { return __double2bfloat16(v); }
};
template <> struct Cast<__half, float> {
    static __device__ __forceinline__ __half from(float v) { return __float2half(v); }
};
template <> struct Cast<__half, double> {
    static __device__ __forceinline__ __half from(double v) { return __double2half(v); }
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

// row tiles of one launch: CUDA's limit on grid y
constexpr int MAX_ROW_TILES = 65535;

template <typename TIn, typename TAcc, typename TOut>
int launch(const void* a, const void* b, void* c, void* rowp, void* colp,
           int m, int k, int n, long long lda, long long ldb, long long ldc, void* stream)
{
    if (m <= 0 || n <= 0) return 0;
    const dim3 block(TX, TY);
    const int nj = (n + BN - 1) / BN;
    // rows r0 .. r0 + rows of a, c and rowp, and row tile r0 / BM of colp
    for (long long r0 = 0; r0 < m; r0 += static_cast<long long>(MAX_ROW_TILES) * BM) {
        const long long left = m - r0, most = static_cast<long long>(MAX_ROW_TILES) * BM;
        const int rows = static_cast<int>(left < most ? left : most);
        const dim3 grid(nj, (rows + BM - 1) / BM);
        abft_mm_kernel<TIn, TAcc, TOut><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const TIn*>(a) + r0 * lda, static_cast<const TIn*>(b),
            static_cast<TOut*>(c) + r0 * ldc, static_cast<TAcc*>(rowp) + r0 * nj,
            static_cast<TAcc*>(colp) + r0 / BM * n, rows, k, n, lda, ldb, ldc, nj);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}


// ---------------------------------------------------------------------------
// f64: FP64 tensor cores (DMMA), cp.async ring
// ---------------------------------------------------------------------------

namespace dmma {

constexpr int BK = 16;                  // depth of one slab
constexpr int STAGES = 4;               // slabs in the ring
constexpr int WM = 32, WN = 32;         // C of one warp
constexpr int MMA_M = 16, MMA_K = 4;    // DMMA shape: m16n8k4 (or m8n8k4, m16n8k{8,16})
constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int FM = WM / MMA_M, FN = WN / 8;  // DMMA tiles of a warp
constexpr int HM = MMA_M / 8, QK = MMA_K / 4;
constexpr int AREG = HM * QK, BREG = QK, CREG = 2 * HM;
constexpr int LDA = BK + 4;             // row strides in doubles, both 32
constexpr int LDB = BN + 4;             // bytes mod 128 (no bank conflicts)
constexpr int STAGE = BM * LDA + BK * LDB;
constexpr int SMEM = STAGES * STAGE * static_cast<int>(sizeof(double));
static_assert(BM % WM == 0 && BN % WN == 0 && WM % MMA_M == 0 && WN % 8 == 0, "warp tiles");
static_assert(BK % MMA_K == 0 && (MMA_M == 16 || MMA_K == 4), "DMMA shapes");
static_assert((BM * BK / 2) % NT == 0 && (BK * BN / 2) % NT == 0, "slab copies");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(double* dst, const double* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy8(double* dst, const double* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// slab k0 .. k0 + BK of a's rows row0.. and b's columns col0.. into one
// stage; what lies beyond m, k or n is zero-filled
template <bool VEC>
__device__ __forceinline__ void load_slab(double* As, double* Bs,
                                          const double* __restrict__ a,
                                          const double* __restrict__ b,
                                          int m, int k, int n, long long lda, long long ldb,
                                          int row0, int col0, int k0, int tid) {
    if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < BM * BK / 2 / NT; ++i) {
            const int e = tid + i * NT;
            const int r = e / (BK / 2), c = (e % (BK / 2)) * 2;
            const int gr = row0 + r, gk = k0 + c;
            const int bytes = gr < m ? 8 * max(0, min(2, k - gk)) : 0;
            copy16(As + r * LDA + c, bytes ? a + gr * lda + gk : a, bytes);
        }
#pragma unroll
        for (int i = 0; i < BK * BN / 2 / NT; ++i) {
            const int e = tid + i * NT;
            const int r = e / (BN / 2), c = (e % (BN / 2)) * 2;
            const int gk = k0 + r, gc = col0 + c;
            const int bytes = gk < k ? 8 * max(0, min(2, n - gc)) : 0;
            copy16(Bs + r * LDB + c, bytes ? b + gk * ldb + gc : b, bytes);
        }
    } else {
#pragma unroll
        for (int i = 0; i < BM * BK / NT; ++i) {
            const int e = tid + i * NT;
            const int r = e / BK, c = e % BK;
            const int gr = row0 + r, gk = k0 + c;
            const bool in = gr < m && gk < k;
            copy8(As + r * LDA + c, in ? a + gr * lda + gk : a, in ? 8 : 0);
        }
#pragma unroll
        for (int i = 0; i < BK * BN / NT; ++i) {
            const int e = tid + i * NT;
            const int r = e / BN, c = e % BN;
            const int gk = k0 + r, gc = col0 + c;
            const bool in = gk < k && gc < n;
            copy8(Bs + r * LDB + c, in ? b + gk * ldb + gc : b, in ? 8 : 0);
        }
    }
}

// c (MMA_M x 8) += a (MMA_M x MMA_K, row) * b (MMA_K x 8, col). Lane
// (g, t) = (lane / 4, lane % 4) holds a[HM * q + h] = A[g + 8h][t + 4q],
// b[q] = B[t + 4q][g] and c[2h + e] = C[g + 8h][2t + e]
__device__ __forceinline__ void dmma(double (&c)[CREG], const double (&a)[AREG],
                                     const double (&b)[BREG]) {
    if constexpr (MMA_M == 8) {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
    } else if constexpr (MMA_K == 4) {
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                     : "d"(a[0]), "d"(a[1]), "d"(b[0]));
    } else if constexpr (MMA_K == 8) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
    } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
                     "{%0,%1,%2,%3};\n"
                     : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]),
                       "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                       "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
    }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
abft_mm_f64_dmma_kernel(const double* __restrict__ a, const double* __restrict__ b,
                        double* __restrict__ c, double* __restrict__ rowp,
                        double* __restrict__ colp, int m, int k, int n,
                        long long lda, long long ldb, long long ldc, int nj)
{
    extern __shared__ __align__(16) double ring[];   // STAGES x (As, Bs)
    __shared__ double red_row[WARPS_N][BM];           // per warp column
    __shared__ double red_col[WARPS_M][BN];           // per warp row

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const int n_k = (k + BK - 1) / BK;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_k)
            load_slab<VEC>(ring + s * STAGE, ring + s * STAGE + BM * LDA, a, b,
                           m, k, n, lda, ldb, row0, col0, s * BK, tid);
        asm volatile("cp.async.commit_group;\n" ::);
    }

    double acc[FM][FN][CREG];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int r = 0; r < CREG; ++r) acc[i][j][r] = 0.0;

    for (int kt = 0; kt < n_k; ++kt) {
        asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
        __syncthreads();          // slab kt landed; slab kt - 1's stage is free
        const int nxt = kt + STAGES - 1;
        if (nxt < n_k) {
            double* st = ring + (nxt % STAGES) * STAGE;
            load_slab<VEC>(st, st + BM * LDA, a, b, m, k, n, lda, ldb,
                           row0, col0, nxt * BK, tid);
        }
        asm volatile("cp.async.commit_group;\n" ::);

        const double* As = ring + (kt % STAGES) * STAGE + (wm * WM + g) * LDA + t;
        const double* Bs = ring + (kt % STAGES) * STAGE + BM * LDA + t * LDB + wn * WN + g;
#pragma unroll
        for (int kk = 0; kk < BK; kk += MMA_K) {
            double af[FM][AREG], bf[FN][BREG];
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int q = 0; q < QK; ++q)
#pragma unroll
                    for (int h = 0; h < HM; ++h)
                        af[i][HM * q + h] = As[(i * MMA_M + 8 * h) * LDA + kk + 4 * q];
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
                for (int q = 0; q < QK; ++q) bf[j][q] = Bs[(kk + 4 * q) * LDB + j * 8];
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) dmma(acc[i][j], af[i], bf[j]);
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);

    // epilogue, all from the f64 fragments: C, then the tile's row and
    // column sums (zero-filled rows and columns add exact zeros)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < HM; ++h) {
            const int gr = row0 + wm * WM + i * MMA_M + 8 * h + g;
            if (gr >= m) continue;
#pragma unroll
            for (int j = 0; j < FN; ++j) {
                const int gc = col0 + wn * WN + j * 8 + 2 * t;
                if (gc < n) c[gr * ldc + gc] = acc[i][j][2 * h];
                if (gc + 1 < n) c[gr * ldc + gc + 1] = acc[i][j][2 * h + 1];
            }
        }
    // rows: a lane's values, then the quad (t), then the warps of the
    // block row in order; columns: a lane's values, then the 8 groups (g),
    // then the warps of the block column in order
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < HM; ++h) {
            double s = 0.0;
#pragma unroll
            for (int j = 0; j < FN; ++j) s += acc[i][j][2 * h] + acc[i][j][2 * h + 1];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t == 0) red_row[wn][wm * WM + i * MMA_M + 8 * h + g] = s;
        }
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            double s = 0.0;
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int h = 0; h < HM; ++h) s += acc[i][j][2 * h + e];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (g == 0) red_col[wm][wn * WN + j * 8 + 2 * t + e] = s;
        }
    __syncthreads();
    for (int idx = tid; idx < BM + BN; idx += NT) {
        double s = 0.0;
        if (idx < BM) {
            const int gr = row0 + idx;
#pragma unroll
            for (int w = 0; w < WARPS_N; ++w) s += red_row[w][idx];
            if (gr < m) rowp[static_cast<long long>(gr) * nj + blockIdx.x] = s;
        } else {
            const int cc = idx - BM, gc = col0 + cc;
#pragma unroll
            for (int w = 0; w < WARPS_M; ++w) s += red_col[w][cc];
            if (gc < n) colp[static_cast<long long>(blockIdx.y) * n + gc] = s;
        }
    }
}

template <bool VEC>
int launch(const void* a, const void* b, void* c, void* rowp, void* colp,
           int m, int k, int n, long long lda, long long ldb, long long ldc, int nj,
           void* stream)
{
    const cudaError_t err = cudaFuncSetAttribute(
        abft_mm_f64_dmma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(nj, (m + BM - 1) / BM);
    abft_mm_f64_dmma_kernel<VEC><<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(a), static_cast<const double*>(b), static_cast<double*>(c),
        static_cast<double*>(rowp), static_cast<double*>(colp), m, k, n, lda, ldb, ldc, nj);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dmma

int launch_f64(const void* a, const void* b, void* c, void* rowp, void* colp,
               int m, int k, int n, long long lda, long long ldb, long long ldc, void* stream)
{
    if (m <= 0 || n <= 0) return 0;
    const int nj = (n + BN - 1) / BN;
    for (long long r0 = 0; r0 < m; r0 += static_cast<long long>(MAX_ROW_TILES) * BM) {
        const long long left = m - r0, most = static_cast<long long>(MAX_ROW_TILES) * BM;
        const int rows = static_cast<int>(left < most ? left : most);
        const double* ar = static_cast<const double*>(a) + r0 * lda;
        // 16-byte copies need 16-byte aligned starts and even row strides
        const bool vec = reinterpret_cast<uintptr_t>(ar) % 16 == 0
                         && reinterpret_cast<uintptr_t>(b) % 16 == 0
                         && lda % 2 == 0 && ldb % 2 == 0;
        double* cr = static_cast<double*>(c) + r0 * ldc;
        double* rr = static_cast<double*>(rowp) + r0 * nj;
        double* cp = static_cast<double*>(colp) + r0 / BM * n;
        const int err = vec ? dmma::launch<true>(ar, b, cr, rr, cp, rows, k, n, lda, ldb, ldc, nj, stream)
                            : dmma::launch<false>(ar, b, cr, rr, cp, rows, k, n, lda, ldb, ldc, nj, stream);
        if (err != 0) return err;
    }
    return 0;
}

// one (input, accumulator) pair: C in the input type, or in the
// accumulator's where c_acc is set and the two differ (only f32 and f64
// inputs, the types a promoted pair of operands can have)
template <typename TIn, typename TAcc>
int launch_pair(const void* a, const void* b, void* c, void* rowp, void* colp,
                int m, int k, int n, long long lda, long long ldb, long long ldc, int c_acc,
                void* stream)
{
    if constexpr (std::is_same<TIn, double>::value && std::is_same<TAcc, double>::value) {
        return launch_f64(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
    } else {
        if constexpr (!std::is_same<TIn, TAcc>::value && sizeof(TIn) >= 4) {
            if (c_acc)
                return launch<TIn, TAcc, TAcc>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
        }
        return launch<TIn, TAcc, TIn>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, stream);
    }
}

}  // namespace

// One entry point per (input type, accumulator type), abft_mm_<in>_<acc>
// for inputs f16, bf16, f32, f64 and accumulators f32, f64; C has the input
// type, or the accumulator's where c_acc is set (f32 and f64 inputs). a is
// (m, k) with row stride lda, b is (k, n) with ldb, c is (m, n) with ldc,
// all with unit column stride; rowp is (m, ceil(n / BN)) and colp is
// (ceil(m / BM), n), contiguous, in the accumulator type.
// Returns cudaGetLastError() of the launches.
extern "C" {

int abft_mm_tile_m() { return BM; }
int abft_mm_tile_n() { return BN; }

#define ABFT_MM_ENTRY(NAME, TIN, TACC)                                                         \
    int NAME(const void* a, const void* b, void* c, void* rowp, void* colp, int m, int k,      \
             int n, long long lda, long long ldb, long long ldc, int c_acc, void* stream) {    \
        return launch_pair<TIN, TACC>(a, b, c, rowp, colp, m, k, n, lda, ldb, ldc, c_acc,      \
                                      stream);                                                  \
    }
ABFT_MM_ENTRY(abft_mm_f16_f32, __half, float)
ABFT_MM_ENTRY(abft_mm_f16_f64, __half, double)
ABFT_MM_ENTRY(abft_mm_bf16_f32, __nv_bfloat16, float)
ABFT_MM_ENTRY(abft_mm_bf16_f64, __nv_bfloat16, double)
ABFT_MM_ENTRY(abft_mm_f32_f32, float, float)
ABFT_MM_ENTRY(abft_mm_f32_f64, float, double)
ABFT_MM_ENTRY(abft_mm_f64_f32, double, float)
ABFT_MM_ENTRY(abft_mm_f64_f64, double, double)
#undef ABFT_MM_ENTRY

}  // extern "C"
