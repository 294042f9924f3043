// Blockwise causal GQA attention, forward only (flash attention), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_pallas) together with the transposes
// of its wrapper ops.py: for every query row, softmax(q k^T * scale) v
// over the keys it may see, with the online-softmax state (running max m,
// normaliser l, f32 accumulator) carried across key tiles so the S x S
// score matrix never reaches device memory. Numbers as in the reference:
// q, k and v are taken to f32 as they load; scale = 1/sqrt(hd) multiplies
// the f32 logits after the dot; the causal mask compares absolute
// positions; a masked logit is NEG_INF = -1e30; p = masked ? 0 :
// exp(logit - m_new), so a fully masked tile adds exactly 0; l sums the
// unrounded f32 p; the result is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on this card: operations. At the serving prefill's
// shape, q (2, 4096, 32, 128) and k/v (2, 4096, 8, 128) in bf16, causal
// attention needs 2 * 2 * S^2 * hd * B * H / 2 = 2.75e11 flops against
// 0.17 GB of bytes: 0.28 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 0.05 ms of memory traffic.
//
// Which input takes which kernel (chosen by the entry point's type and the
// head dim; nothing falls back at run time). One entry point per type:
// flash_attention_bf16, _f16, _f32 and _f64. The wrapper (kernel.py,
// route()) sends q, k, v of mixed or other types to _f32 after a cast to
// f32 (what the reference's kernel does inside), and pads a bf16 or f16
// head dim that is not a multiple of 8 with zero columns.
//
// * bf16 and f16, hd <= 256 -> flash_fwd_wgmma_kernel<E, HD>, on the
//   tensor cores through wgmma (.f32.bf16.bf16 or .f32.f16.f16; one code,
//   the same descriptors and swizzle). Q, K and V stay in shared memory
//   in their 2-byte type in the swizzled layout the wgmma matrix
//   descriptors name (128-byte swizzle at hd >= 64, 64 or 32 bytes below).
//   K and V tiles come through a 3-stage cp.async ring, one tile ahead of
//   the one computed. q k^T is wgmma m64n(BKV)k16 with both operands in
//   shared memory and an f32 accumulator; 2-byte x 2-byte products are
//   exact in f32, so the scores differ from an f32 dot only by summation
//   order. The online softmax runs on the accumulator fragments in
//   registers (row max and sum over the 4 lanes of a quad). P.V is wgmma
//   m64n(HD)k16 with P from registers and V read transposed from shared
//   memory. P is split in two, hi = E(p) and lo = E(p - hi), and both
//   products go into the same f32 accumulator: p is carried to about 16
//   bits (bf16) or 22 bits (f16) instead of 8 or 11. A single bf16 P misses
//   the check this kernel is held to (two ulps of the f32-P result) at
//   about 5 % of the prefill's outputs, a single f16 P at about 1 %; the
//   split costs 1.5 x the MMA work of a single P. In f16, lo falls below
//   the normal range (6.1e-5) for most p, so it is kept on the subnormal
//   grid of 2^-24: an absolute error of at most 2^-25 in each p, below an
//   f16 ulp of the output (tests/test_torch_flash.py emulates it at the
//   prefill's length; no scaling of P is needed). A warpgroup whose rows
//   all lie above a key tile skips it. Tiles (Tiles<HD>):
//   - hd <= 128: two warpgroups, 128 query rows a block, 128-row key
//     tiles: (128 + 2 * 3 * 128) * HD * 2 bytes + 1 KB = 225 KB at hd 128,
//     one block an SM. Chosen by timing (kernel_variants.py).
//   - 128 < hd <= 256 (tile 256): that ring would take 448 KB of the 227
//     KB a block may have. One warpgroup, 64 query rows a block and
//     64-row key tiles with the same 3-stage ring: (64 + 2 * 3 * 64) * 256
//     * 2 bytes + 1 KB = 225 KB. The P.V accumulator (m64n256) is 128 f32
//     registers a thread. (128 query rows with 64-row key tiles would need
//     a ring of 2 stages, which gives up loading ahead.)
// * f32 and f64, hd <= 256 -> flash_fwd_kernel<T, HD, false>, every product
//   and sum in full f32 FMA on the CUDA cores (no TF32, which would miss
//   the f32 check of 1e-5): tiles staged in shared memory as f32 (f64 is
//   rounded to f32 as it loads, as the reference's astype(f32), and the
//   result rounded back: it computes in f32, not f64), 256 threads each
//   keeping a 4 x 4 block of scores and a 4 x (HD/16) block of the output.
//   64 query rows and 64-row key tiles: ((64 + 2 * 64) * (HD + 4) + 64 *
//   68) * 4 bytes = 116 KB at HD 128, 212 KB at HD 256. It is off the
//   serving path (the prefill runs bf16).
// * any type, hd > 256 -> flash_fwd_kernel<T, 128, true>: the same FMA
//   kernel over 128-column chunks. Grid z is the chunk of output columns a
//   block writes; each block builds its scores by looping over the head
//   dim in 128-column chunks of q and k (loaded again for each), then
//   multiplies P by its own 128 columns of v. The scores are computed once
//   for every output chunk (hd / 128 times): simple, right, and slower
//   than it need be. 116 KB, as HD 128.
//
// Tile widths: 16, 32, 64, 128 and 256 (bf16 and f16 on wgmma, f32 and f64
// by FMA). A head dim off them runs in the next one with the columns
// beyond hd zero in q, k and v (zero-filled as the tiles load), which adds
// nothing to q.k and gives zero columns in p.v, and only the first hd
// output columns are stored. The scale stays 1/sqrt(hd). Exact, at the
// cost of the padded columns' work (hubert-xlarge's hd 80 runs in the 128
// tile).
//
// All read the inputs through their strides in (B, S, heads, hd) layout
// (unit stride on hd): no transposed copies. Query head h reads key/value
// head h / (H / KV), so the GQA repeat is never materialised. The ragged
// edge (S not a multiple of the tile) is masked here, not padded by the
// caller. Key tiles wholly above the diagonal are skipped: such a tile
// would leave m, l and acc unchanged (alpha = exp(0) = 1, every p = 0), so
// skipping it is exact. Grid x is batch x query head and grid y the query
// tiles, the longest first to even out the causal triangle; a launch takes
// at most 65535 query tiles, so a longer sequence is cut into launches.
//
// What the wgmma design leaves on the table: TMA loads from a producer
// warp (the loads are cp.async by every thread, so a block-wide barrier
// separates key tiles), warp specialisation with the softmax of one
// warpgroup overlapping the products of the other, and a persistent
// schedule.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// f32 and f64 (and any type past hd 256): CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr int TX = 16;            // threads along keys / head dim
constexpr int TY = 16;            // threads along query rows
constexpr int NT = TX * TY;
constexpr int RQ = BQ / TY;       // query rows per thread
constexpr int RK = BK / TX;       // key columns per thread
constexpr int PAD = 4;            // keeps rows 16-byte aligned
constexpr int LDP = BK + PAD;     // row stride of the probability tile
constexpr int CHUNK = 128;        // columns of a chunk past hd 256
constexpr int MAX_GRID_Y = 65535; // CUDA's limit on grid y: query tiles a launch
constexpr float NEG_INF = -1e30f;
static_assert(RQ == 4 && RK == 4, "the score block of a thread is 4 x 4");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<double>(double v) { return static_cast<float>(v); }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_f32<double>(float v) { return static_cast<double>(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

template <int HD>
constexpr int smem_bytes() {
    return ((BQ + 2 * BK) * (HD + PAD) + BQ * LDP) * static_cast<int>(sizeof(float));
}

// rows [r0, r0 + ROWS) and columns [c0, c0 + HD) of one head's (S, hd)
// slice, row stride rs, into a (ROWS, HD + PAD) f32 tile; rows at or beyond
// S and columns at or beyond hd (the tile width HD is the next instantiated
// one, or a chunk) are zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long rs, int r0, int S, int hd, int tid,
                                          int c0 = 0) {
    constexpr int LD = HD + PAD;
#pragma unroll 4
    for (int e = tid; e < ROWS * HD; e += NT) {
        const int r = e / HD, d = e % HD;
        const int s = r0 + r;
        dst[r * LD + d] = s < S && c0 + d < hd
                          ? to_f32(src[static_cast<long long>(s) * rs + c0 + d]) : 0.f;
    }
}

// s[i][j] += q row ty*RQ + i . k row tx + j*TX over the tile's HD columns
template <int HD>
__device__ __forceinline__ void add_scores(float (&s)[RQ][RK], const float* Qs, const float* Ks,
                                           int tx, int ty) {
    constexpr int LD = HD + PAD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
        float4 qv[RQ], kv[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
            qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RQ + i) * LD + d]);
#pragma unroll
        for (int j = 0; j < RK; ++j)
            kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + j * TX) * LD + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                float a = s[i][j];
                a = fmaf(qv[i].x, kv[j].x, a);
                a = fmaf(qv[i].y, kv[j].y, a);
                a = fmaf(qv[i].z, kv[j].z, a);
                a = fmaf(qv[i].w, kv[j].w, a);
                s[i][j] = a;
            }
    }
}

// One block per (batch x query head, query tile, output chunk). Without
// CHUNKED the tile holds the whole head dim (hd <= HD): Q loads once and
// the scores take one pass. With CHUNKED (hd > 256, HD = CHUNK) the scores
// loop over the head dim in HD-column chunks of q and k, and the block
// writes output columns [blockIdx.z * HD, + HD). One block per SM is all
// the shared memory allows at hd = 128 and above, so the register budget
// is the whole 255 a thread may have.
template <typename T, int HD, bool CHUNKED>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int hd, int groups, int causal, float scale, int qt_hi,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh)
{
    constexpr int LD = HD + PAD;
    constexpr int DC = HD / TX;   // output columns per thread: 1, 2, 4, 8 or 16
    static_assert(HD % TX == 0 && HD % 4 == 0, "tile width must be a multiple of 16");

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;             // (BQ, LD)
    float* Ks = Qs + BQ * LD;     // (BK, LD)
    float* Vs = Ks + BK * LD;     // (BK, LD)
    float* Ps = Vs + BK * LD;     // (BQ, LDP)

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
    const int qt = qt_hi - static_cast<int>(blockIdx.y);
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / groups;
    const int q0 = qt * BQ;
    const int c0 = CHUNKED ? static_cast<int>(blockIdx.z) * HD : 0;   // first output column

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + kvh * ksh;
    const T* vb = v + b * vsb + kvh * vsh;

    if constexpr (!CHUNKED) load_tile<T, HD, BQ>(Qs, qb, qss, q0, S, hd, tid);

    float acc[RQ][DC];
    float m[RQ], l[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    int n_kt = (S + BK - 1) / BK;
    if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);   // exact skip, see above

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        // scores of rows ty*RQ + i against keys tx + j*TX
        float s[RQ][RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
        if constexpr (CHUNKED) {
            for (int d0 = 0; d0 < hd; d0 += HD) {
                __syncthreads();      // the previous chunk's Qs, Ks (tile's Vs, Ps) are consumed
                load_tile<T, HD, BQ>(Qs, qb, qss, q0, S, hd, tid, d0);
                load_tile<T, HD, BK>(Ks, kb, kss, k0, S, hd, tid, d0);
                __syncthreads();
                add_scores<HD>(s, Qs, Ks, tx, ty);
            }
            // the block's own output columns of v; read after the barrier below
            load_tile<T, HD, BK>(Vs, vb, vss, k0, S, hd, tid, c0);
        } else {
            __syncthreads();          // the previous tile's Ks, Vs, Ps are consumed
            load_tile<T, HD, BK>(Ks, kb, kss, k0, S, hd, tid);
            load_tile<T, HD, BK>(Vs, vb, vss, k0, S, hd, tid);
            __syncthreads();
            add_scores<HD>(s, Qs, Ks, tx, ty);
        }

        // online softmax; the 16 threads of a row are 16 lanes of one warp
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int qpos = q0 + ty * RQ + i;
            bool ok[RK];
            float mc = NEG_INF;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int kpos = k0 + tx + j * TX;
                ok[j] = kpos < S && (!causal || kpos <= qpos);
                s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
                mc = fmaxf(mc, s[i][j]);
            }
#pragma unroll
            for (int off = TX / 2; off > 0; off >>= 1)
                mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
            const float m_new = fmaxf(m[i], mc);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
                rs += s[i][j];
            }
#pragma unroll
            for (int off = TX / 2; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
            for (int j = 0; j < RK; ++j) Ps[(ty * RQ + i) * LDP + tx + j * TX] = s[i][j];
        }
        __syncthreads();

        // acc += P V; a thread's columns are tx*4 + 64*jj + e (hd >= 64)
        // or tx*DC + e (hd < 64), so neighbouring lanes read neighbouring
        // addresses of a value row
#pragma unroll 2
        for (int c = 0; c < BK; c += 4) {
            float4 pv[RQ];
#pragma unroll
            for (int i = 0; i < RQ; ++i)
                pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * RQ + i) * LDP + c]);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const float* vrow = &Vs[(c + cc) * LD];
                float vv[DC];
                if constexpr (DC >= 4) {
#pragma unroll
                    for (int jj = 0; jj < DC / 4; ++jj) {
                        const float4 t = *reinterpret_cast<const float4*>(&vrow[jj * 4 * TX + tx * 4]);
                        vv[jj * 4 + 0] = t.x;
                        vv[jj * 4 + 1] = t.y;
                        vv[jj * 4 + 2] = t.z;
                        vv[jj * 4 + 3] = t.w;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < DC; ++e) vv[e] = vrow[tx * DC + e];
                }
#pragma unroll
                for (int i = 0; i < RQ; ++i) {
                    const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
                    for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
                }
            }
        }
    }

    // o (B, S, H, hd), contiguous: the block's columns c0 .. c0 + HD, those
    // below hd
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int r = q0 + ty * RQ + i;
        if (r >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        T* orow = o + ((static_cast<long long>(b) * S + r) * H + h) * hd + c0;
#pragma unroll
        for (int e = 0; e < DC; ++e) {
            const int d = DC >= 4 ? (e / 4) * 4 * TX + tx * 4 + (e % 4) : tx * DC + e;
            if (c0 + d < hd) orow[d] = from_f32<T>(acc[i][e] / denom);
        }
    }
}

template <typename T, int HD, bool CHUNKED>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, int KV, int hd, int causal, float scale,
              long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, void* stream)
{
    constexpr int smem = smem_bytes<HD>();
    // above 48 KB of dynamic shared memory the kernel must opt in; the
    // attribute is per device, so it is set before every launch
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(TX, TY);
    const int n_qt = (S + BQ - 1) / BQ;
    const int n_ch = CHUNKED ? (hd + HD - 1) / HD : 1;
    for (int y0 = 0; y0 < n_qt; y0 += MAX_GRID_Y) {
        const dim3 grid(B * H, n_qt - y0 < MAX_GRID_Y ? n_qt - y0 : MAX_GRID_Y, n_ch);
        flash_fwd_kernel<T, HD, CHUNKED><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<T*>(o), S, H, hd, H / KV, causal, scale, n_qt - 1 - y0,
            qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// bf16 and f16: tensor cores (wgmma), cp.async ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;           // query rows per block: two warpgroups of 64
constexpr int BKV = 128;          // key rows per tile
constexpr int NT = 256;
constexpr int AHEAD = 1;          // key tiles in flight ahead of the one computed
// A stage is rewritten at the top of an iteration, before the barrier, while
// another warp may still compute the previous tile: the ring holds tiles
// kt - 1 .. kt + AHEAD.
constexpr int STAGES = AHEAD + 2;

// The tiles of a tile width: BQ, BKV and NT above up to 128 columns; at 256
// one warpgroup of 64 query rows and 64-row key tiles, what a ring of
// STAGES stages leaves room for in 227 KB (see the header)
template <int HD> struct Tiles {
    static constexpr bool WIDE = HD > 128;
    static constexpr int BQ = WIDE ? 64 : wg::BQ;
    static constexpr int BKV = WIDE ? 64 : wg::BKV;
    static constexpr int NT = WIDE ? 128 : wg::NT;
};

template <int HD>
constexpr int smem_bytes() {
    // + 1 KB to align the tiles to the 1 KB period of the swizzle
    return (Tiles<HD>::BQ + 2 * STAGES * Tiles<HD>::BKV) * HD * 2 + 1024;
}

// Shared-memory layout of a (rows, HD) tile of 2-byte values, as wgmma reads
// it: HD is cut into column blocks of RB bytes a row (64 values, or all of
// HD when it is smaller), each block stored row after row, and within every
// 8-row group the 16-byte chunks of a row XOR-swizzled by the row (the
// 128-, 64- or 32-byte swizzle of the matrix descriptor, MODE).
template <int HD> struct Layout {
    static constexpr int RB = (HD < 64 ? HD : 64) * 2;
    static constexpr int MASK = RB / 16 - 1;
    static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (of HD / 8) of row r in a (ROWS, HD) tile
template <int HD, int ROWS>
__device__ __forceinline__ int chunk_at(int r, int c) {
    constexpr int RB = Layout<HD>::RB, CB = RB / 16;
    const int x = (c / CB) * ROWS * RB + r * RB + (c % CB) * 16;
    return x ^ (((x >> 7) & Layout<HD>::MASK) << 4);
}

// rows [r0, r0 + ROWS) of one head's (S, hd) slice, row stride rs, into a
// tile by 16-byte cp.async from the block's NTH threads; rows at or beyond
// S and the chunks at or beyond hd (hd a multiple of 8, the tile width HD
// the next instantiated one) are zero-filled
template <typename E, int HD, int ROWS, int NTH>
__device__ __forceinline__ void load_tile(unsigned char* dst, const E* __restrict__ src,
                                          long long rs, int r0, int S, int hd, int tid) {
    constexpr int CH = HD / 8, N = ROWS * CH;
#pragma unroll
    for (int i = 0; i < (N + NTH - 1) / NTH; ++i) {
        const int e = tid + i * NTH;
        if (N % NTH == 0 || e < N) {
            const int r = e / CH, c = e % CH, s = r0 + r;
            const bool in = s < S && c * 8 < hd;
            const E* g = src + static_cast<long long>(s < S ? s : S - 1) * rs + (in ? c * 8 : 0);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(smem_u32(dst + chunk_at<HD, ROWS>(r, c))), "l"(g),
                            "r"(in ? 16 : 0));
        }
    }
}

// wgmma matrix descriptor: start address, leading and stride byte offsets,
// swizzle mode (tiles start on a 1 KB boundary, so the base offset is 0)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t mode) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
           | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
           | (mode << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// registers an asynchronous wgmma reads or writes stay where they are until
// this point: neither moved, reused nor read early by the compiler
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x) :: "memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x) :: "memory"); }

template <typename E> constexpr bool is_f16 = std::is_same<E, __half>::value;

// p (two f32) as hi = E(p) and lo = E(p - hi), each an E pair with the
// first value in the low half; p - hi is exact in f32
template <typename E>
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
    if constexpr (is_f16<E>) {
        const __half2 h = __floats2half2_rn(x, y);
        const __half2 l = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
        hi = *reinterpret_cast<const uint32_t*>(&h);
        lo = *reinterpret_cast<const uint32_t*>(&l);
    } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
        const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
        hi = *reinterpret_cast<const uint32_t*>(&h);
        lo = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// two f32 rounded to an E pair, stored at an aligned address
template <typename E>
__device__ __forceinline__ void store2(E* dst, float x, float y) {
    if constexpr (is_f16<E>)
        *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x, y);
    else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// d (64 x N, f32) += a (64 x 16) * b (16 x N), a and b of type E. ss: a and
// b from shared memory, both K-major, d overwritten where scale_d is 0; rs:
// a from registers (the mma.sync A fragment of each warp's 16 rows), b
// MN-major (transposed). Lane (g, t) = (lane / 4, lane % 4) of warp w holds
// d[4j + 2i + e] = D[16w + g + 8i][8j + 2t + e].
// The instruction of one shape for bf16 (TY "bf16") or f16 (TY "f16")
// operands; the operand lists follow the macro.
#define WG_SS_N64(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                 : "l"(da), "l"(db), "r"(scale_d))
#define WG_SS_N128(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
                 : "l"(da), "l"(db), "r"(scale_d))
#define WG_RS_N16(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WG_RS_N32(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WG_RS_N64(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WG_RS_N128(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WG_RS_N256(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))


template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (is_f16<E>) WG_SS_N64("f16"); else WG_SS_N64("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (is_f16<E>) WG_SS_N128("f16"); else WG_SS_N128("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (is_f16<E>) WG_RS_N16("f16"); else WG_RS_N16("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (is_f16<E>) WG_RS_N32("f16"); else WG_RS_N32("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (is_f16<E>) WG_RS_N64("f16"); else WG_RS_N64("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (is_f16<E>) WG_RS_N128("f16"); else WG_RS_N128("bf16");
}
template <typename E>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (is_f16<E>) WG_RS_N256("f16"); else WG_RS_N256("bf16");
}
#undef WG_SS_N64
#undef WG_SS_N128
#undef WG_RS_N16
#undef WG_RS_N32
#undef WG_RS_N64
#undef WG_RS_N128
#undef WG_RS_N256

// N = the key tile: 128 up to hd 128 (64 in kernel_variants.py's 64-key
// variant), 64 at hd 256
template <typename E, int N>
__device__ __forceinline__ void qk(float (&s)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (N == 128) wgmma_ss_n128<E>(s, da, db, scale_d);
    else wgmma_ss_n64<E>(s, da, db, scale_d);
}

template <typename E, int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (HD == 256) wgmma_rs_n256<E>(o, a, db);
    else if constexpr (HD == 128) wgmma_rs_n128<E>(o, a, db);
    else if constexpr (HD == 64) wgmma_rs_n64<E>(o, a, db);
    else if constexpr (HD == 32) wgmma_rs_n32<E>(o, a, db);
    else wgmma_rs_n16<E>(o, a, db);
}

// Grid (B * H, query tiles), longest query tile first; one warpgroup per
// 64 query rows. A thread keeps 64 x HD / 128 accumulator values and
// 64 x BKV / 128 scores, so one block an SM.
template <typename E, int HD>
__global__ void __launch_bounds__(Tiles<HD>::NT, 1)
flash_fwd_wgmma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ o,
                       int S, int H, int hd, int groups, int causal, float scale_log2, int qt_hi,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh)
{
    constexpr int BQ = Tiles<HD>::BQ, BKV = Tiles<HD>::BKV, NT = Tiles<HD>::NT;
    constexpr int RB = Layout<HD>::RB;
    constexpr uint64_t MODE = Layout<HD>::MODE;
    constexpr int KS = HD / 16;           // k16 steps of q.k
    constexpr int NS = BKV / 8;           // n8 column groups of the scores
    constexpr int KC = BKV / 16;          // k16 steps of p.v
    constexpr int QB = BQ * HD * 2, KB = BKV * HD * 2;   // tile bytes
    static_assert(HD % 16 == 0 && HD <= 256, "tile width 16, 32, 64, 128 or 256");
    static_assert(sizeof(E) == 2, "2-byte operands");

    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* Ks = Qs + QB;                  // STAGES x (BKV, HD)
    unsigned char* Vs = Ks + STAGES * KB;         // STAGES x (BKV, HD)
    const uint32_t q_s = smem_u32(Qs), k_s = smem_u32(Ks), v_s = smem_u32(Vs);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wgi = warp >> 2;                    // warpgroup
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / groups;
    const int qt = qt_hi - static_cast<int>(blockIdx.y);
    const int q0 = qt * BQ;
    const int g0 = q0 + wgi * 64;                 // first query row of the warpgroup
    const int row_a = g0 + (warp & 3) * 16 + g, row_b = row_a + 8;

    const E* qb = q + b * qsb + h * qsh;
    const E* kb = k + b * ksb + kvh * ksh;
    const E* vb = v + b * vsb + kvh * vsh;

    int n_kt = (S + BKV - 1) / BKV;
    if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BKV + 1);   // exact skip

    // Q with the first key tile, then one group per key tile
    load_tile<E, HD, BQ, NT>(Qs, qb, qss, q0, S, hd, tid);
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
        if (i < n_kt) {
            load_tile<E, HD, BKV, NT>(Ks + i * KB, kb, kss, i * BKV, S, hd, tid);
            load_tile<E, HD, BKV, NT>(Vs + i * KB, vb, vss, i * BKV, S, hd, tid);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    }

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    // rows row_a (i = 0) and row_b (i = 1); m in units of log2
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int kt = 0; kt < n_kt; ++kt) {
        if (kt + AHEAD < n_kt) {
            const int st = (kt + AHEAD) % STAGES;
            load_tile<E, HD, BKV, NT>(Ks + st * KB, kb, kss, (kt + AHEAD) * BKV, S, hd, tid);
            load_tile<E, HD, BKV, NT>(Vs + st * KB, vb, vss, (kt + AHEAD) * BKV, S, hd, tid);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group %0;\n" :: "n"(AHEAD));   // tile kt landed
        // cp.async writes through the generic proxy, wgmma reads through the
        // async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();

        const int k0 = kt * BKV, st = kt % STAGES;
        // a warpgroup whose rows all precede the tile's first key skips it
        if (causal && k0 > g0 + 63) continue;

        // scores s = q k^T, f32, on the tensor cores
        float s[NS * 4];
#pragma unroll
        for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
#pragma unroll
        for (int i = 0; i < NS * 4; ++i) keep(s[i]);
        fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            const int nb = kk * 32 / RB, in = kk * 32 % RB;   // column block, bytes into it
            qk<E, BKV>(s, desc(q_s + nb * BQ * RB + wgi * 64 * RB + in, 16, 8 * RB, MODE),
                       desc(k_s + st * KB + nb * BKV * RB + in, 16, 8 * RB, MODE), kk > 0);
        }
        commit();
        wait();
#pragma unroll
        for (int i = 0; i < NS * 4; ++i) keep(s[i]);

        // scale after the dot (in units of log2), mask, row max over the
        // quad that holds a row
        const bool edge = (causal && k0 + BKV - 1 > g0) || k0 + BKV > S;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[4 * j + e] * scale_log2;
                if (edge) {
                    const int kpos = k0 + j * 8 + 2 * t + (e & 1);
                    const int qpos = e < 2 ? row_a : row_b;
                    if (kpos >= S || (causal && kpos > qpos)) x = NEG_INF;
                }
                s[4 * j + e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            alpha[i] = exp2f(m[i] - mx[i]);
            m[i] = mx[i];
        }
        // p = masked ? 0 : exp(logit - m_new); l takes the unrounded p
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                bool ok = true;
                if (edge) {
                    const int kpos = k0 + j * 8 + 2 * t + (e & 1);
                    const int qpos = e < 2 ? row_a : row_b;
                    ok = kpos < S && (!causal || kpos <= qpos);
                }
                const float p = ok ? exp2f(s[4 * j + e] - mx[e >> 1]) : 0.f;
                s[4 * j + e] = p;
                rs[e >> 1] += p;
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            acc[4 * j + 0] *= alpha[0];
            acc[4 * j + 1] *= alpha[0];
            acc[4 * j + 2] *= alpha[1];
            acc[4 * j + 3] *= alpha[1];
        }

        // acc += P V over 16-key steps, P = hi + lo as the register operand,
        // V (keys x HD, HD contiguous) read transposed
        uint32_t ph[KC][4], pl[KC][4];
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split<E>(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], ph[kc][r], pl[kc][r]);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) keep(acc[i]);
        fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
            const uint64_t dv = desc(v_s + st * KB + kc * 16 * RB, BKV * RB, 8 * RB, MODE);
            pv<E, HD>(acc, ph[kc], dv);
            pv<E, HD>(acc, pl[kc], dv);
        }
        commit();
        wait();
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) keep(acc[i]);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                keep(ph[kc][r]);
                keep(pl[kc][r]);
            }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);

    // the 4 lanes of a quad hold parts of the same two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    // o (B, S, H, hd), contiguous: the first hd of the tile's HD columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = i == 0 ? row_a : row_b;
        if (r >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        E* orow = o + ((static_cast<long long>(b) * S + r) * H + h) * hd;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            if (j * 8 < hd)
                store2<E>(orow + j * 8 + 2 * t, acc[4 * j + 2 * i] / denom,
                          acc[4 * j + 2 * i + 1] / denom);
    }
}

}  // namespace wg

template <typename E, int HD>
int launch_wgmma_hd(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int H, int KV, int hd, int causal, float scale,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh, void* stream)
{
    using TL = wg::Tiles<HD>;
    constexpr int smem = wg::smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        wg::flash_fwd_wgmma_kernel<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // scores are scaled into units of log2 so the kernel exponentiates with
    // exp2: exp(x * scale - m) == exp2(x * scale * log2(e) - m * log2(e))
    const float scale_log2 = scale * 1.4426950408889634f;
    const int n_qt = (S + TL::BQ - 1) / TL::BQ;
    for (int y0 = 0; y0 < n_qt; y0 += MAX_GRID_Y) {
        const dim3 grid(B * H, n_qt - y0 < MAX_GRID_Y ? n_qt - y0 : MAX_GRID_Y);
        wg::flash_fwd_wgmma_kernel<E, HD><<<grid, TL::NT, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
            static_cast<E*>(o), S, H, hd, H / KV, causal, scale_log2, n_qt - 1 - y0,
            qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// the kernel of each input type up to hd 256: bf16 and f16 -> tensor cores
// (launch_wgmma_hd), f32 and f64 -> FMA (launch_hd)
template <typename T, int HD>
int launch_type_hd(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int hd, int causal, float scale,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, void* stream)
{
    if constexpr (sizeof(T) == 2)
        return launch_wgmma_hd<T, HD>(q, k, v, o, B, S, H, KV, hd, causal, scale,
                                      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
    else
        return launch_hd<T, HD, false>(q, k, v, o, B, S, H, KV, hd, causal, scale,
                                       qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           int B, int S, int H, int KV, int hd, int causal, float scale,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, void* stream)
{
    if (B <= 0 || S <= 0 || H <= 0) return 0;
    if (KV <= 0 || H % KV != 0 || hd <= 0) return static_cast<int>(cudaErrorInvalidValue);
    // the 2-byte types copy 16-byte chunks: a head dim up to 256 must be a
    // multiple of 8 (the wrapper pads one that is not with zero columns)
    if (sizeof(T) == 2 && hd <= 256 && hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    // the next instantiated tile width: its columns beyond hd are zero in q,
    // k and v, which adds nothing to q.k and gives zero output columns in
    // p.v, and only the first hd columns are stored
#define FLASH_HD(N) \
    if (hd <= N) return launch_type_hd<T, N>(q, k, v, o, B, S, H, KV, hd, causal, scale, \
                                             qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
    FLASH_HD(16)
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(128)
    FLASH_HD(256)
#undef FLASH_HD
    // past 256 columns: the FMA kernel over 128-column chunks, any type
    return launch_hd<T, CHUNK, true>(q, k, v, o, B, S, H, KV, hd, causal, scale,
                                     qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
}

}  // namespace

// One entry point per input type, flash_attention_<bf16|f16|f32|f64>. q is
// (B, S, H, hd) and k, v are (B, S, KV, hd), each with element strides
// (batch, seq, head) and unit stride on hd; o is (B, S, H, hd), contiguous,
// in the input type. Any head dim: up to 256 the next tile width of 16, 32,
// 64, 128 and 256 with the columns beyond hd zero, past 256 in 128-column
// chunks. The bf16 and f16 kernels copy 16-byte chunks up to hd 256: their
// inputs must be 16-byte aligned with strides that are multiples of 8, and
// hd a multiple of 8.
// Returns cudaGetLastError() of the launches.
extern "C" {

#define FLASH_ENTRY(NAME, T)                                                                 \
    int NAME(const void* q, const void* k, const void* v, void* o, int B, int S, int H,     \
             int KV, int hd, int causal, float scale, long long qsb, long long qss,         \
             long long qsh, long long ksb, long long kss, long long ksh, long long vsb,     \
             long long vss, long long vsh, void* stream) {                                  \
        return launch<T>(q, k, v, o, B, S, H, KV, hd, causal, scale, qsb, qss, qsh, ksb,    \
                         kss, ksh, vsb, vss, vsh, stream);                                  \
    }
FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_f64, double)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
FLASH_ENTRY(flash_attention_f16, __half)
#undef FLASH_ENTRY

}  // extern "C"
