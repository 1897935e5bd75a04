// K9: the downstroke of one scalar multigrid level without the
// restriction, in one pass.
//
//   u1 = D b                                  (damped Jacobi from zero)
//   u2 = u1 + D (b - A u1)                    -> u_out
//   res = mask (b - A u2)                     -> res_out
//
// b, u_out, res_out (R, nz, nx) and D = omega * dinv (nz, nx) complex64,
// mask (nz, nx) float32, planes (9, nz, nx) complex64; zero extension
// outside the grid in every stage. Any nz, nx >= 1, odd sizes included.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::
// presmooth2_residual_pallas_batched (kernel body _ps2r_kernel): the
// public multigrid.presmooth_residual on a scalar level at nu1 = 2.
//
// Bound on the card: device-memory bytes. Per point it must read the 9
// planes, D and the mask once (84 B) and, per RHS, b once and write u2
// and the residual once (24 B); ~165 flops per point and RHS.
// Design: K2's stages 0-2 without the restriction. A block owns a
// K9_T x K9_T tile of one RHS, the RHS the fastest grid index (the R
// blocks of a tile share the plane reads through the L2). b is loaded
// with a 2-cell halo into shared memory; u1 covers the whole frame, u2
// the frame less one cell (the residual needs u2 on a 1-cell halo of the
// tile), so both iterates stay in shared memory and device memory sees b
// in and u2, res out, on the tile's own points.

#include "zt_common.cuh"

#define K9_T 32             // output points per tile side
#define K9_H 2              // halo of the loaded frame
#define K9_S (K9_T + 2 * K9_H)
#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS)
zt_presmooth_residual_kernel(const float2* __restrict__ planes,
                             const float2* __restrict__ D,
                             const float* __restrict__ mask,
                             const float2* __restrict__ b,
                             float2* __restrict__ u_out,
                             float2* __restrict__ res_out, int nz, int nx) {
    constexpr int S = K9_S;
    __shared__ float2 b_s[S][S];
    __shared__ float2 u1_s[S][S];
    __shared__ float2 u2_s[S][S];

    const int zb = blockIdx.z * K9_T - K9_H, xb = blockIdx.y * K9_T - K9_H;
    const int r = blockIdx.x;
    const long long plane = (long long)nz * nx;
    const float2* br = b + r * plane;
    const float2 zero = make_float2(0.f, 0.f);

    // stage 0: b and u1 = D b on the whole frame
    for (int q = threadIdx.x; q < S * S; q += K9_THREADS) {
        const int qi = q / S, qj = q % S;
        const int z = zb + qi, x = xb + qj;
        float2 bv = zero, uv = zero;
        if (z >= 0 && z < nz && x >= 0 && x < nx) {
            const long long p = (long long)z * nx + x;
            bv = br[p];
            uv = cmul(D[p], bv);
        }
        b_s[qi][qj] = bv;
        u1_s[qi][qj] = uv;
    }
    __syncthreads();

    // stage 1: u2 = u1 + D (b - A u1) on the frame [1, S-1)
    for (int q = threadIdx.x; q < (S - 2) * (S - 2); q += K9_THREADS) {
        const int qi = 1 + q / (S - 2), qj = 1 + q % (S - 2);
        const int z = zb + qi, x = xb + qj;
        float2 v = zero;
        if (z >= 0 && z < nz && x >= 0 && x < nx) {
            const long long p = (long long)z * nx + x;
            float2 au = zero;
#pragma unroll
            for (int k = 0; k < 9; ++k)
                au = cadd(au, cmul(planes[k * plane + p],
                                   u1_s[qi + off_dz(k)][qj + off_dx(k)]));
            v = cadd(u1_s[qi][qj], cmul(D[p], csub(b_s[qi][qj], au)));
        }
        u2_s[qi][qj] = v;
    }
    __syncthreads();

    // stage 2: res = mask (b - A u2) on the tile; u2 and res to memory
    float2* ur = u_out + r * plane;
    float2* rr = res_out + r * plane;
    for (int q = threadIdx.x; q < K9_T * K9_T; q += K9_THREADS) {
        const int qi = K9_H + q / K9_T, qj = K9_H + q % K9_T;
        const int z = zb + qi, x = xb + qj;
        if (z >= nz || x >= nx) continue;
        const long long p = (long long)z * nx + x;
        float2 au = zero;
#pragma unroll
        for (int k = 0; k < 9; ++k)
            au = cadd(au, cmul(planes[k * plane + p],
                               u2_s[qi + off_dz(k)][qj + off_dx(k)]));
        ur[p] = u2_s[qi][qj];
        rr[p] = cscale(mask[p], csub(b_s[qi][qj], au));
    }
}

ZT_EXPORT int zt_presmooth_residual(const void* planes, const void* D,
                                    const void* mask, const void* b,
                                    void* u, void* res, int R, int nz,
                                    int nx, void* stream) {
    // the RHS index varies fastest, so the R blocks of one tile run
    // together and share its plane reads through the L2
    const dim3 grid(R, ceil_div(nx, K9_T), ceil_div(nz, K9_T));
    zt_presmooth_residual_kernel<<<grid, K9_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)D, (const float*)mask,
        (const float2*)b, (float2*)u, (float2*)res, nz, nx);
    return (int)cudaGetLastError();
}
