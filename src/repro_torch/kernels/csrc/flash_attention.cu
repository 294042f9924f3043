// Blockwise causal GQA attention, forward only (flash attention), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_pallas) together with the transposes
// of its wrapper ops.py: for every query row, softmax(q k^T * scale) v
// over the keys it may see, with the online-softmax state (running max m,
// normaliser l, f32 accumulator) carried across key tiles so the S x S
// score matrix never reaches device memory. Numbers as in the reference:
// scale = 1/sqrt(hd) multiplies the f32 logits after the dot; the causal
// mask compares absolute positions; a masked logit is NEG_INF = -1e30;
// p = masked ? 0 : exp(logit - m_new), so a fully masked tile adds exactly
// 0; the result is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on this card: operations. At the serving prefill's
// shape, q (2, 4096, 32, 128) and k/v (2, 4096, 8, 128) in bf16, causal
// attention needs 2 * 2 * S^2 * hd * B * H / 2 = 2.75e11 flops against
// 0.17 GB of bytes: 0.28 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 4.1 ms at the f32 rate (67 TFLOP/s) this kernel computes at, 0.05 ms of
// memory traffic.
//
// What the design does about that: one block owns one (batch, query head,
// 64-row query tile) and loops over 64-row key tiles itself (blocks run
// in no order, so nothing is carried between them); the state stays in
// registers. Tiles are staged in shared memory as f32; 256 threads each
// keep a 4 x 4 block of scores and a 4 x (hd/16) block of the output, fed
// by 16-byte shared-memory loads, so every value loaded feeds four FMAs.
// The inputs are read through their strides in (B, S, heads, hd) layout
// (unit stride on hd): no transposed copies. Query head h reads key/value
// head h / (H / KV), so the GQA repeat is never materialised. The ragged
// edge (S not a multiple of 64) is masked here, not padded by the caller.
// Key tiles wholly above the diagonal are skipped: such a tile would leave
// m, l and acc unchanged (alpha = exp(0) = 1, every p = 0), so skipping it
// is exact, not an approximation. Query tiles are issued longest-first to
// even out the causal triangle.
//
// Precision: every product and sum in full f32 FMA, no TF32, for f32 and
// bf16 inputs alike (bf16 values are widened on load), so bf16 outputs
// differ from the reference only by the final rounding and summation order.
//
// What this simple design leaves on the table: the tensor cores (mma.sync
// or wgmma with bf16 operands would be 15x the f32 FMA rate), TMA and
// cp.async double buffering (tile loads are not overlapped with compute),
// and occupancy (about 116 KB of shared memory at hd = 128 keeps one block
// of 8 warps on each SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr int TX = 16;            // threads along keys / head dim
constexpr int TY = 16;            // threads along query rows
constexpr int NT = TX * TY;
constexpr int RQ = BQ / TY;       // query rows per thread
constexpr int RK = BK / TX;       // key columns per thread
constexpr int PAD = 4;            // keeps rows 16-byte aligned
constexpr int LDP = BK + PAD;     // row stride of the probability tile
constexpr float NEG_INF = -1e30f;
static_assert(RQ == 4 && RK == 4, "the score block of a thread is 4 x 4");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <int HD>
constexpr int smem_bytes() {
    return ((BQ + 2 * BK) * (HD + PAD) + BQ * LDP) * static_cast<int>(sizeof(float));
}

// rows [r0, r0 + ROWS) of one head's (S, HD) slice, row stride rs, into a
// (ROWS, HD + PAD) f32 tile; rows at or beyond S are zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long rs, int r0, int S, int tid) {
    constexpr int LD = HD + PAD;
#pragma unroll 4
    for (int e = tid; e < ROWS * HD; e += NT) {
        const int r = e / HD, d = e % HD;
        const int s = r0 + r;
        dst[r * LD + d] = s < S ? to_f32(src[static_cast<long long>(s) * rs + d]) : 0.f;
    }
}

// one block per SM is all the shared memory allows at hd = 128, so the
// register budget is the whole 255 a thread may have
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int groups, int causal, float scale,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh)
{
    constexpr int LD = HD + PAD;
    constexpr int DC = HD / TX;   // output columns per thread: 1, 2, 4 or 8
    static_assert(HD % TX == 0 && HD % 4 == 0, "head_dim must be a multiple of 16");

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;             // (BQ, LD)
    float* Ks = Qs + BQ * LD;     // (BK, LD)
    float* Vs = Ks + BK * LD;     // (BK, LD)
    float* Ps = Vs + BK * LD;     // (BQ, LDP)

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
    const int n_qt = (S + BQ - 1) / BQ;
    const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int kvh = h / groups;
    const int q0 = qt * BQ;

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + kvh * ksh;
    const T* vb = v + b * vsb + kvh * vsh;

    load_tile<T, HD, BQ>(Qs, qb, qss, q0, S, tid);

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
        __syncthreads();          // the previous tile's Ks, Vs, Ps are consumed
        load_tile<T, HD, BK>(Ks, kb, kss, k0, S, tid);
        load_tile<T, HD, BK>(Vs, vb, vss, k0, S, tid);
        __syncthreads();

        // scores of rows ty*RQ + i against keys tx + j*TX
        float s[RQ][RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
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

    // o (B, S, H, HD), contiguous
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int r = q0 + ty * RQ + i;
        if (r >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        T* orow = o + ((static_cast<long long>(b) * S + r) * H + h) * HD;
#pragma unroll
        for (int e = 0; e < DC; ++e) {
            const int d = DC >= 4 ? (e / 4) * 4 * TX + tx * 4 + (e % 4) : tx * DC + e;
            orow[d] = from_f32<T>(acc[i][e] / denom);
        }
    }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, int KV, int causal, float scale,
              long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, void* stream)
{
    constexpr int smem = smem_bytes<HD>();
    // above 48 KB of dynamic shared memory the kernel must opt in; the
    // attribute is per device, so it is set before every launch
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(TX, TY);
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<T, HD><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, H, H / KV, causal, scale,
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           int B, int S, int H, int KV, int hd, int causal, float scale,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, void* stream)
{
    if (B <= 0 || S <= 0 || H <= 0) return 0;
    if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_HD(N) \
    case N: return launch_hd<T, N>(q, k, v, o, B, S, H, KV, causal, scale, \
                                   qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
    switch (hd) {
        FLASH_HD(16)
        FLASH_HD(32)
        FLASH_HD(64)
        FLASH_HD(128)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_HD
}

}  // namespace

// One entry point per input type. q is (B, S, H, hd) and k, v are
// (B, S, KV, hd), each with element strides (batch, seq, head) and unit
// stride on hd; o is (B, S, H, hd), contiguous, in the input type.
// hd is 16, 32, 64 or 128. Returns cudaGetLastError() of the launch.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int hd, int causal, float scale,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh, void* stream) {
    return launch<float>(q, k, v, o, B, S, H, KV, hd, causal, scale,
                         qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int hd, int causal, float scale,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal, scale,
                                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, stream);
}

}  // extern "C"
