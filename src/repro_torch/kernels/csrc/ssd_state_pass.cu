// The SSD's state passing across chunks, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a Python
// loop that XLA fuses. In the port that loop launched two elementwise
// operations a chunk in the forward, again in the recompute of
// remat="dots", and about five in the backward, where every chunk's
// select_backward also filled a zero copy of the whole (B, nc, H, hd, N)
// state contributions. Here one launch does each direction.
//
// Forward, per (b, h) row of L = hd * N elements:
//     out[c] = state_c,   state_0 = 0,   state_{c+1} = state_c * a_c + s[c]
// Backward, from g = d loss / d out:
//     H_{nc-1} = g[nc-1],   H_c = g[c] + H_{c+1} * a_c
//     ds[c] = H_{c+1} (0 for the last chunk),
//     da[c] = sum over the row of H_{c+1} * out[c]
// The products and sums are __fmul_rn then __fadd_rn, never contracted
// into an FMA, so out and ds equal the loop's (and its autograd's) bit for
// bit. da is written as one partial a warp, (B, nc, H, warps), each warp
// summing its lanes in a fixed shuffle tree; the caller adds the warps'
// partials in a second step. No atomics, so every result repeats.
//
// What bounds it on this card: bytes. The forward reads s and writes out
// (2 x 4 B an element a chunk), the backward reads g and out and writes ds
// (3 x 4 B); a handful of flops an element.
//
// What the design does about that: each thread owns VEC neighbouring
// elements of one row (16-byte loads and stores where the row allows it),
// so a warp touches 512 contiguous bytes of each chunk; the loads of the
// next PF chunks are issued before the dependent arithmetic of the
// current ones, since they do not depend on the carried state. The blocks
// of a row and the rows are one flat grid; s and g are read through their
// batch, chunk and head strides (each row's L elements contiguous).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PF = 4;  // chunks whose loads are in flight at once

template <int VEC> struct Vec { float v[VEC]; };

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
    Vec<VEC> r;
    if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) r.v[i] = __ldg(p + i);
    }
    return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& r) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
    }
}

// One block: THREADS * VEC elements of one (b, h) row, every chunk.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
state_pass_fwd_kernel(const float* __restrict__ a, const float* __restrict__ s,
                      float* __restrict__ out, int nc, int H, int L, int nseg,
                      long long sb, long long sc, long long sh)
{
    const long long row = blockIdx.x / nseg;
    const int seg = static_cast<int>(blockIdx.x % nseg);
    const long long b = row / H;
    const int h = static_cast<int>(row % H);
    const int e = (seg * THREADS + static_cast<int>(threadIdx.x)) * VEC;
    if (e >= L) return;

    const float* sp = s + b * sb + h * sh + e;
    const float* ap = a + b * nc * H + h;
    const long long ostep = static_cast<long long>(H) * L;
    float* op = out + b * nc * ostep + static_cast<long long>(h) * L + e;

    Vec<VEC> st;
#pragma unroll
    for (int i = 0; i < VEC; ++i) st.v[i] = 0.0f;

    for (int c0 = 0; c0 < nc; c0 += PF) {
        Vec<VEC> nx[PF];
        float ac[PF];
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            if (c0 + k < nc) {
                nx[k] = load<VEC>(sp + (c0 + k) * sc);
                ac[k] = __ldg(ap + static_cast<long long>(c0 + k) * H);
            }
        }
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            if (c0 + k < nc) {
                store<VEC>(op + (c0 + k) * ostep, st);
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    st.v[i] = __fadd_rn(__fmul_rn(st.v[i], ac[k]), nx[k].v[i]);
            }
        }
    }
}

// One block: THREADS * VEC elements of one (b, h) row, chunks in reverse.
// Warps whose lanes lie past the row's end take part in the shuffles with
// zeros; a warp wholly past it writes nothing.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
state_pass_bwd_kernel(const float* __restrict__ a, const float* __restrict__ st,
                      const float* __restrict__ g, float* __restrict__ ds,
                      float* __restrict__ dap, int nc, int H, int L, int nseg,
                      int warps, long long gb, long long gc, long long gh)
{
    const long long row = blockIdx.x / nseg;
    const int seg = static_cast<int>(blockIdx.x % nseg);
    const long long b = row / H;
    const int h = static_cast<int>(row % H);
    const int t = seg * THREADS + static_cast<int>(threadIdx.x);
    const int e = t * VEC;
    const int w = t / 32, lane = t % 32;
    const bool in = e < L;
    if (w >= warps) return;  // the whole warp lies past the row

    const float* gp = g + b * gb + h * gh + e;
    const float* ap = a + b * nc * H + h;
    const long long step = static_cast<long long>(H) * L;
    const long long base = b * nc * step + static_cast<long long>(h) * L + e;
    const float* sp = st + base;
    float* dp = ds + base;
    // partial of (b, c, h, w) at ((b * nc + c) * H + h) * warps + w
    float* pp = dap + (b * nc * H + h) * warps + w;
    const long long pstep = static_cast<long long>(H) * warps;

    Vec<VEC> hv, zero;
#pragma unroll
    for (int i = 0; i < VEC; ++i) zero.v[i] = 0.0f;
    // the last chunk's state feeds nothing: its ds and da are zero
    if (in) {
        store<VEC>(dp + (nc - 1) * step, zero);
        hv = load<VEC>(gp + (nc - 1) * gc);
    } else {
        hv = zero;
    }
    if (lane == 0) pp[(nc - 1) * pstep] = 0.0f;

    for (int c0 = nc - 2; c0 >= 0; c0 -= PF) {
        Vec<VEC> gx[PF], sx[PF];
        float ac[PF];
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            const int c = c0 - k;
            if (c >= 0) {
                ac[k] = __ldg(ap + static_cast<long long>(c) * H);
                if (in) {
                    sx[k] = load<VEC>(sp + c * step);
                    if (c > 0) gx[k] = load<VEC>(gp + c * gc);
                } else {
                    sx[k] = zero;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            const int c = c0 - k;
            if (c >= 0) {
                if (in) store<VEC>(dp + c * step, hv);
                float p = 0.0f;
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    p = __fadd_rn(p, __fmul_rn(hv.v[i], sx[k].v[i]));
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
                if (lane == 0) pp[c * pstep] = p;
                if (c > 0 && in) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i)
                        hv.v[i] = __fadd_rn(gx[k].v[i], __fmul_rn(hv.v[i], ac[k]));
                }
            }
        }
    }
}

long long blocks_for(int B, int H, int L, int vec, int* nseg) {
    *nseg = (L + THREADS * vec - 1) / (THREADS * vec);
    return static_cast<long long>(B) * H * *nseg;
}

constexpr long long MAX_GRID = 2147483647LL;

}  // namespace

// a (B, nc, H) contiguous; s (B, nc, H, L) with element strides (sb, sc, sh)
// and each row's L elements contiguous; out (B, nc, H, L) contiguous. vec is
// 4 (L, the strides and the pointers in multiples of 16 bytes) or 1. ds and
// out in the backward are contiguous, g as s; dap is (B, nc, H, warps),
// warps = ssd_state_pass_warps(L, vec). Each returns cudaGetLastError() of
// its launch, or cudaErrorInvalidValue for a vec or a grid it cannot take.
extern "C" {

int ssd_state_pass_warps(int L, int vec) { return (L + 32 * vec - 1) / (32 * vec); }

int ssd_state_pass_fwd(const void* a, const void* s, void* out, int B, int nc, int H, int L,
                       long long sb, long long sc, long long sh, int vec, void* stream)
{
    if (B <= 0 || nc <= 0 || H <= 0 || L <= 0) return 0;
    int nseg;
    const long long blocks = blocks_for(B, H, L, vec, &nseg);
    if (blocks > MAX_GRID || (vec != 4 && vec != 1)) return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* af = static_cast<const float*>(a);
    const auto* sf = static_cast<const float*>(s);
    auto* of = static_cast<float*>(out);
    if (vec == 4)
        state_pass_fwd_kernel<4><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
            af, sf, of, nc, H, L, nseg, sb, sc, sh);
    else
        state_pass_fwd_kernel<1><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
            af, sf, of, nc, H, L, nseg, sb, sc, sh);
    return static_cast<int>(cudaGetLastError());
}

int ssd_state_pass_bwd(const void* a, const void* states, const void* g, void* ds, void* dap,
                       int B, int nc, int H, int L, long long gb, long long gc, long long gh,
                       int vec, void* stream)
{
    if (B <= 0 || nc <= 0 || H <= 0 || L <= 0) return 0;
    int nseg;
    const long long blocks = blocks_for(B, H, L, vec, &nseg);
    if (blocks > MAX_GRID || (vec != 4 && vec != 1)) return static_cast<int>(cudaErrorInvalidValue);
    const int warps = ssd_state_pass_warps(L, vec);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* af = static_cast<const float*>(a);
    const auto* sf = static_cast<const float*>(states);
    const auto* gf = static_cast<const float*>(g);
    auto* df = static_cast<float*>(ds);
    auto* pf = static_cast<float*>(dap);
    if (vec == 4)
        state_pass_bwd_kernel<4><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
            af, sf, gf, df, pf, nc, H, L, nseg, warps, gb, gc, gh);
    else
        state_pass_bwd_kernel<1><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
            af, sf, gf, df, pf, nc, H, L, nseg, warps, gb, gc, gh);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
