// K11: the BiCGStab recurrence of zephyr_tpu_torch.solver.krylov, fused
// into six kernels that stream each field once and keep every scalar of
// the recurrence on the device.
//
// A step of right-preconditioned BiCGStab on R right-hand sides, fields
// (R, N) complex64 (N = B * nz * nx a lane), M the preconditioner, A the
// operator, lanes frozen once their own loop has ended:
//
//   prologue  rhat = r; ||b||, atol = tol ||b||, <r, r>; rho = alpha =
//             omega = 1, k = 0, act = ||r|| > atol && k < maxiter
//   p         beta = (rho' alpha) / (rho omega), rho' = <rhat, r>;
//             p = r + beta (p - omega v)                    (in place)
//             [phat = M p, v = A phat: the port's own kernels]
//   rv        <rhat, v>; alpha' = rho' / <rhat, v>
//   s         s = r - alpha' v
//             [shat = M s, t = A shat]
//   ts        <t, t>, <t, s>; omega' = <t, s> / <t, t>
//   xr        x += alpha' phat + omega' shat; r = s - omega' t (in place);
//             <rhat, r>, <r, r>; rho, alpha, omega, k, down, act of the
//             lanes that were active
//
// Each division is the recurrence's _safe_div (0 where |den| < FLT_MIN,
// torch.finfo(float32).tiny); a lane breaks down when |rho'|, |<rhat, v>|
// or |omega'| falls below it. The plain twins (ops/krylov_kernels.py)
// compute the same steps in torch.
//
// Replaces no Pallas kernel: the JAX package leaves this algebra (the
// dots, axpys and selects of zephyr_tpu/solver/krylov.py::bicgstab) to
// XLA's fusion of jnp operations; eager torch ran it as ~30 kernels a step
// that wrote every product to memory before summing it (~50 field passes,
// 62 with frozen lanes). These kernels make 19: prologue 3 (once a
// solve), p 4, rv 2, s 3, ts 2, xr 8 (read x, phat, shat, s, t, rhat,
// write x and r).
//
// Bound on the card: device-memory bytes (a few flops a complex element).
// Design: a launch is a grid (G, R), one lane a grid row. Block g of a
// lane takes elements [g C, (g + 1) C) of it, C a multiple of the block's
// 256 threads; G follows R and N (ops/krylov_kernels.py plan(): about
// eight blocks an SM in all, at least 1024 elements a block, at most 1024
// blocks a lane), so a lane's partials stay few from a 64^2 coarse grid
// to 2304 x 768. A frozen lane's blocks return at once: freezing copies
// nothing (its p, v, s hold what they held, and its x and r stay).
// Reductions are deterministic: each thread sums its elements in float in
// a fixed order, the block reduces by warp shuffles and shared memory in
// double, in a fixed order, into its partial; the last block of the lane
// to finish (an integer atomic counter a lane, after a __threadfence)
// sums the G partials in a fixed order in double, resets the counter and
// updates the lane's scalars. No floating-point atomics, so two runs of
// one input agree bit for bit. Kernels take the zk_ prefix: they are
// algebra, not one of K1-K9.

#include <cfloat>

#include "zt_common.cuh"

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Rows of the scalar block sc (NSC, R) float32 and of the flags fl
// (NFL, R) int32; a complex scalar takes two rows (re, im). The same
// numbers are in ops/krylov_kernels.py.
enum { RHO = 0, ALPHA = 2, OMEGA = 4, RHON = 6, ALPHAN = 8, OMEGAN = 10,
       TOL = 12, ATOL = 13, BNORM = 14, RNORM = 15 };
enum { ACT = 0, KIT = 1, DOWN = 2, BAD = 3, COUNT = 4 };

// A launch's per-lane state and its geometry (a kernel argument).
struct ZkLanes {
    float* sc;
    int* fl;
    double* part;       // (3, R, G) partial sums
    int R, G;
    long long N, C;     // elements a lane, a block
};

namespace {

__device__ __forceinline__ float2 get_c(const ZkLanes& L, int row, int lane) {
    return make_float2(L.sc[row * L.R + lane], L.sc[(row + 1) * L.R + lane]);
}

__device__ __forceinline__ void set_c(const ZkLanes& L, int row, int lane,
                                      float2 v) {
    L.sc[row * L.R + lane] = v.x;
    L.sc[(row + 1) * L.R + lane] = v.y;
}

__device__ __forceinline__ int& flag(const ZkLanes& L, int row, int lane) {
    return L.fl[row * L.R + lane];
}

// conj(a) * b
__device__ __forceinline__ float2 cdotc(float2 a, float2 b) {
    return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// |z|, as torch.abs of a complex64
__device__ __forceinline__ float zk_abs(float2 z) { return hypotf(z.x, z.y); }

// a / b with the scaling of c10::complex<float>'s division (numpy's)
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
    const float ac = fabsf(b.x), ad = fabsf(b.y);
    if (ac >= ad) {
        const float rat = b.y / b.x, scl = 1.0f / (b.x + b.y * rat);
        return make_float2((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
    }
    const float rat = b.x / b.y, scl = 1.0f / (b.y + b.x * rat);
    return make_float2((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

// _safe_div: num / den, or 0 on (near-)breakdown of the denominator
__device__ __forceinline__ float2 safe_div(float2 num, float2 den) {
    if (zk_abs(den) < FLT_MIN) return make_float2(0.f, 0.f);
    return cdiv(num, den);
}

// The block's sums of v[0..NV), in thread 0, in a fixed order: warp
// shuffles, then the warps' sums in warp order. smem holds NV * WARPS.
template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV], double* smem) {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
            v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
        if (l == 0) smem[k * WARPS + w] = v[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            double s = 0.0;
            for (int j = 0; j < WARPS; ++j) s += smem[k * WARPS + j];
            v[k] = s;
        }
    }
}

// Write this block's partials v (its block_sum, in thread 0) and count it
// in. In the last block of the lane to arrive, every thread sums the
// lane's G partials (thread j those of blocks j, j + 256, ..., then
// block_sum), the counter goes back to 0, and thread 0 returns true with
// the sums in v. Every other thread of every block returns false.
template <int NV>
__device__ __forceinline__ bool lane_sums(const ZkLanes& L, int lane,
                                          double (&v)[NV], double* smem) {
    __shared__ int last;
    block_sum<NV>(v, smem);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
            L.part[((long long)k * L.R + lane) * L.G + blockIdx.x] = v[k];
        __threadfence();
        last = atomicAdd(&flag(L, COUNT, lane), 1) == L.G - 1;
    }
    __syncthreads();
    if (!last) return false;
    __threadfence();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        double s = 0.0;
        for (int j = threadIdx.x; j < L.G; j += THREADS)
            s += __ldcg(&L.part[((long long)k * L.R + lane) * L.G + j]);
        v[k] = s;
    }
    __syncthreads();    // smem is free again
    block_sum<NV>(v, smem);
    if (threadIdx.x != 0) return false;
    flag(L, COUNT, lane) = 0;
    return true;
}

// The element range of block blockIdx.x of its lane, offset to the lane.
__device__ __forceinline__ void chunk(const ZkLanes& L, int lane,
                                      long long& base, long long& lo,
                                      long long& hi) {
    base = (long long)lane * L.N;
    lo = (long long)blockIdx.x * L.C;
    hi = lo + L.C < L.N ? lo + L.C : L.N;
}

}  // namespace

__global__ void __launch_bounds__(THREADS) zk_bicgstab_prologue_kernel(
        const float2* __restrict__ b, const float2* __restrict__ r,
        float2* __restrict__ rhat, ZkLanes L, int maxiter) {
    __shared__ double smem[2 * WARPS];
    const int lane = blockIdx.y;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    float bb = 0.f, rr = 0.f;
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS) {
        const float2 bv = b[i], rv = r[i];
        rhat[i] = rv;
        bb += bv.x * bv.x + bv.y * bv.y;
        rr += rv.x * rv.x + rv.y * rv.y;
    }
    double v[2] = {bb, rr};
    if (!lane_sums<2>(L, lane, v, smem)) return;
    float bnorm = sqrtf((float)v[0]);
    bnorm = bnorm > 0.f ? bnorm : 1.f;
    const float atol = L.sc[TOL * L.R + lane] * bnorm;
    const float rnorm = sqrtf((float)v[1]);
    const float2 one = make_float2(1.f, 0.f);
    set_c(L, RHO, lane, one);
    set_c(L, ALPHA, lane, one);
    set_c(L, OMEGA, lane, one);
    set_c(L, RHON, lane, make_float2((float)v[1], 0.f));
    L.sc[ATOL * L.R + lane] = atol;
    L.sc[BNORM * L.R + lane] = bnorm;
    L.sc[RNORM * L.R + lane] = rnorm;
    flag(L, KIT, lane) = 0;
    flag(L, DOWN, lane) = 0;
    flag(L, BAD, lane) = 0;
    flag(L, ACT, lane) = rnorm > atol && 0 < maxiter;
}

// p and v are not __restrict__: with an identity preconditioner and
// operator (tests) v is p.
__global__ void __launch_bounds__(THREADS) zk_bicgstab_p_kernel(
        const float2* __restrict__ r, float2* p, const float2* v, ZkLanes L) {
    const int lane = blockIdx.y;
    if (!flag(L, ACT, lane)) return;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    const float2 omega = get_c(L, OMEGA, lane);
    const float2 beta = safe_div(cmul(get_c(L, RHON, lane),
                                      get_c(L, ALPHA, lane)),
                                 cmul(get_c(L, RHO, lane), omega));
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS)
        p[i] = cadd(r[i], cmul(beta, csub(p[i], cmul(omega, v[i]))));
}

__global__ void __launch_bounds__(THREADS) zk_bicgstab_rv_kernel(
        const float2* __restrict__ rhat, const float2* __restrict__ v,
        ZkLanes L) {
    __shared__ double smem[2 * WARPS];
    const int lane = blockIdx.y;
    if (!flag(L, ACT, lane)) return;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS)
        acc = cadd(acc, cdotc(rhat[i], v[i]));
    double sums[2] = {acc.x, acc.y};
    if (!lane_sums<2>(L, lane, sums, smem)) return;
    const float2 denom = make_float2((float)sums[0], (float)sums[1]);
    const float2 rhon = get_c(L, RHON, lane);
    set_c(L, ALPHAN, lane, safe_div(rhon, denom));
    flag(L, BAD, lane) = zk_abs(rhon) < FLT_MIN || zk_abs(denom) < FLT_MIN;
}

__global__ void __launch_bounds__(THREADS) zk_bicgstab_s_kernel(
        const float2* __restrict__ r, const float2* __restrict__ v,
        float2* __restrict__ s, ZkLanes L) {
    const int lane = blockIdx.y;
    if (!flag(L, ACT, lane)) return;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    const float2 alpha = get_c(L, ALPHAN, lane);
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS)
        s[i] = csub(r[i], cmul(alpha, v[i]));
}

__global__ void __launch_bounds__(THREADS) zk_bicgstab_ts_kernel(
        const float2* __restrict__ t, const float2* __restrict__ s,
        ZkLanes L) {
    __shared__ double smem[3 * WARPS];
    const int lane = blockIdx.y;
    if (!flag(L, ACT, lane)) return;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    float tt = 0.f;
    float2 ts = make_float2(0.f, 0.f);
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS) {
        const float2 tv = t[i];
        tt += tv.x * tv.x + tv.y * tv.y;
        ts = cadd(ts, cdotc(tv, s[i]));
    }
    double sums[3] = {tt, ts.x, ts.y};
    if (!lane_sums<3>(L, lane, sums, smem)) return;
    set_c(L, OMEGAN, lane,
          safe_div(make_float2((float)sums[1], (float)sums[2]),
                   make_float2((float)sums[0], 0.f)));
}

__global__ void __launch_bounds__(THREADS) zk_bicgstab_xr_kernel(
        const float2* __restrict__ rhat, float2* __restrict__ x,
        float2* __restrict__ r, const float2* __restrict__ s,
        const float2* __restrict__ t, const float2* __restrict__ phat,
        const float2* __restrict__ shat, ZkLanes L, int maxiter) {
    __shared__ double smem[3 * WARPS];
    const int lane = blockIdx.y;
    if (!flag(L, ACT, lane)) return;
    long long base, lo, hi;
    chunk(L, lane, base, lo, hi);
    const float2 alpha = get_c(L, ALPHAN, lane);
    const float2 omega = get_c(L, OMEGAN, lane);
    float2 hr = make_float2(0.f, 0.f);
    float rr = 0.f;
#pragma unroll 4
    for (long long i = base + lo + threadIdx.x; i < base + hi; i += THREADS) {
        x[i] = cadd(cadd(x[i], cmul(alpha, phat[i])), cmul(omega, shat[i]));
        const float2 rn = csub(s[i], cmul(omega, t[i]));
        r[i] = rn;
        hr = cadd(hr, cdotc(rhat[i], rn));
        rr += rn.x * rn.x + rn.y * rn.y;
    }
    double sums[3] = {hr.x, hr.y, rr};
    if (!lane_sums<3>(L, lane, sums, smem)) return;
    set_c(L, RHO, lane, get_c(L, RHON, lane));
    set_c(L, ALPHA, lane, alpha);
    set_c(L, OMEGA, lane, omega);
    set_c(L, RHON, lane, make_float2((float)sums[0], (float)sums[1]));
    const float rnorm = sqrtf((float)sums[2]);
    L.sc[RNORM * L.R + lane] = rnorm;
    const int k = flag(L, KIT, lane) + 1;
    const int down = flag(L, BAD, lane) || zk_abs(omega) < FLT_MIN;
    flag(L, KIT, lane) = k;
    flag(L, DOWN, lane) = down;
    flag(L, ACT, lane) = rnorm > L.sc[ATOL * L.R + lane] && k < maxiter
                         && !down;
}

namespace {

ZkLanes lanes(void* sc, void* fl, void* part, int R, int G, long long N,
            long long C) {
    return ZkLanes{(float*)sc, (int*)fl, (double*)part, R, G, N, C};
}

}  // namespace

#define ZK_GRID dim3(G, R), dim3(THREADS), 0, (cudaStream_t)stream

ZT_EXPORT int zk_bicgstab_prologue(const void* b, const void* r, void* rhat,
                                   void* sc, void* fl, void* part, int R,
                                   int G, long long N, long long C,
                                   int maxiter, void* stream) {
    zk_bicgstab_prologue_kernel<<<ZK_GRID>>>(
        (const float2*)b, (const float2*)r, (float2*)rhat,
        lanes(sc, fl, part, R, G, N, C), maxiter);
    return (int)cudaGetLastError();
}

ZT_EXPORT int zk_bicgstab_p(const void* r, void* p, const void* v, void* sc,
                            void* fl, void* part, int R, int G, long long N,
                            long long C, void* stream) {
    zk_bicgstab_p_kernel<<<ZK_GRID>>>(
        (const float2*)r, (float2*)p, (const float2*)v,
        lanes(sc, fl, part, R, G, N, C));
    return (int)cudaGetLastError();
}

ZT_EXPORT int zk_bicgstab_rv(const void* rhat, const void* v, void* sc,
                             void* fl, void* part, int R, int G, long long N,
                             long long C, void* stream) {
    zk_bicgstab_rv_kernel<<<ZK_GRID>>>(
        (const float2*)rhat, (const float2*)v,
        lanes(sc, fl, part, R, G, N, C));
    return (int)cudaGetLastError();
}

ZT_EXPORT int zk_bicgstab_s(const void* r, const void* v, void* s, void* sc,
                            void* fl, void* part, int R, int G, long long N,
                            long long C, void* stream) {
    zk_bicgstab_s_kernel<<<ZK_GRID>>>(
        (const float2*)r, (const float2*)v, (float2*)s,
        lanes(sc, fl, part, R, G, N, C));
    return (int)cudaGetLastError();
}

ZT_EXPORT int zk_bicgstab_ts(const void* t, const void* s, void* sc,
                             void* fl, void* part, int R, int G, long long N,
                             long long C, void* stream) {
    zk_bicgstab_ts_kernel<<<ZK_GRID>>>(
        (const float2*)t, (const float2*)s,
        lanes(sc, fl, part, R, G, N, C));
    return (int)cudaGetLastError();
}

ZT_EXPORT int zk_bicgstab_xr(const void* rhat, void* x, void* r,
                             const void* s, const void* t, const void* phat,
                             const void* shat, void* sc, void* fl,
                             void* part, int R, int G, long long N,
                             long long C, int maxiter, void* stream) {
    zk_bicgstab_xr_kernel<<<ZK_GRID>>>(
        (const float2*)rhat, (float2*)x, (float2*)r, (const float2*)s,
        (const float2*)t, (const float2*)phat, (const float2*)shat,
        lanes(sc, fl, part, R, G, N, C), maxiter);
    return (int)cudaGetLastError();
}
