// K6: two damped-Jacobi sweeps of a batch in one pass, for a scalar
// 9-point operator.
//
//   u1 = u + D (b - A u)          (FROM_ZERO: u = 0, so u1 = D b)
//   u2 = u1 + D (b - A u1)        -> out
//   (A v)[z, x] = sum_k planes[k, z, x] * v[z + dz_k, x + dx_k]
//
// with zero extension outside the (nz, nx) grid in every stage; planes
// (9, nz, nx) and D = omega * dinv (nz, nx) are shared by the R
// right-hand sides of b, u, out (R, nz, nx), all complex64. Any nz, nx
// >= 1, odd sizes included.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::jacobi_sweep2_pallas_batched
// (kernel body _jacobi2_kernel, both its from-zero and its u variant):
// the scalar multigrid smoother at mg_nu1 >= 3 or mg_nu2 >= 3.
//
// Bound on the card: device-memory bytes. Per point it must read the 9
// planes and D once (80 B) and, per RHS, b (and u) once and write u2 once
// (16 B from zero, 24 B with u); the two applies are ~165 flops per point
// and RHS, far below the compute roof.
// Design: K2's frame machinery. A block owns a K6_T x K6_T output tile of
// one RHS; the RHS is the fastest grid index, so the R blocks of a tile
// run together and the planes come from device memory about once, the
// other reads hitting the L2. b (and u) are loaded with a halo of H cells
// (1 from zero, 2 with u) into shared memory, u1 is computed one cell
// wider than the tile and stays in shared memory; device memory sees b
// (and u) in and u2 out. Points outside the grid hold zero in every
// stage, which is the stencil's zero extension.

#include "zt_common.cuh"

#define K6_T 32             // output points per tile side
#define K6_THREADS 256

template <bool FROM_ZERO>
__global__ void __launch_bounds__(K6_THREADS)
zt_jacobi_sweep2_kernel(const float2* __restrict__ planes,
                        const float2* __restrict__ D,
                        const float2* __restrict__ b,
                        const float2* __restrict__ u,
                        float2* __restrict__ out, int nz, int nx) {
    constexpr int H = FROM_ZERO ? 1 : 2;     // halo of the loaded frame
    constexpr int S = K6_T + 2 * H;          // shared frame side
    __shared__ float2 b_s[S][S];
    __shared__ float2 u_s[FROM_ZERO ? 1 : S][S];   // unused from zero
    __shared__ float2 u1_s[S][S];

    const int zb = blockIdx.z * K6_T - H, xb = blockIdx.y * K6_T - H;
    const int r = blockIdx.x;
    const long long plane = (long long)nz * nx;
    const float2* br = b + r * plane;
    const float2* ur = FROM_ZERO ? nullptr : u + r * plane;
    const float2 zero = make_float2(0.f, 0.f);

    // stage 0: b (and u) on the whole frame; from zero also u1 = D b
    for (int q = threadIdx.x; q < S * S; q += K6_THREADS) {
        const int qi = q / S, qj = q % S;
        const int z = zb + qi, x = xb + qj;
        float2 bv = zero, uv = zero;
        const bool in = z >= 0 && z < nz && x >= 0 && x < nx;
        const long long p = (long long)z * nx + x;
        if (in) bv = br[p];
        b_s[qi][qj] = bv;
        if (FROM_ZERO) {
            u1_s[qi][qj] = in ? cmul(D[p], bv) : zero;
        } else {
            if (in) uv = ur[p];
            u_s[qi][qj] = uv;
        }
    }
    __syncthreads();

    // stage 1 (with u): u1 = u + D (b - A u) on the frame [1, S-1)
    if (!FROM_ZERO) {
        for (int q = threadIdx.x; q < (S - 2) * (S - 2);
             q += K6_THREADS) {
            const int qi = 1 + q / (S - 2), qj = 1 + q % (S - 2);
            const int z = zb + qi, x = xb + qj;
            float2 v = zero;
            if (z >= 0 && z < nz && x >= 0 && x < nx) {
                const long long p = (long long)z * nx + x;
                float2 au = zero;
#pragma unroll
                for (int k = 0; k < 9; ++k)
                    au = cadd(au, cmul(planes[k * plane + p],
                                       u_s[qi + off_dz(k)][qj + off_dx(k)]));
                v = cadd(u_s[qi][qj], cmul(D[p], csub(b_s[qi][qj], au)));
            }
            u1_s[qi][qj] = v;
        }
        __syncthreads();
    }

    // stage 2: u2 = u1 + D (b - A u1) on the tile, straight to out
    float2* outr = out + r * plane;
    for (int q = threadIdx.x; q < K6_T * K6_T; q += K6_THREADS) {
        const int qi = H + q / K6_T, qj = H + q % K6_T;
        const int z = zb + qi, x = xb + qj;
        if (z >= nz || x >= nx) continue;
        const long long p = (long long)z * nx + x;
        float2 au = zero;
#pragma unroll
        for (int k = 0; k < 9; ++k)
            au = cadd(au, cmul(planes[k * plane + p],
                               u1_s[qi + off_dz(k)][qj + off_dx(k)]));
        outr[p] = cadd(u1_s[qi][qj], cmul(D[p], csub(b_s[qi][qj], au)));
    }
}

ZT_EXPORT int zt_jacobi_sweep2(const void* planes, const void* D,
                               const void* b, const void* u, void* out,
                               int R, int nz, int nx, void* stream) {
    // the RHS index varies fastest, so the R blocks of one tile run
    // together and share its plane reads through the L2
    const dim3 grid(R, ceil_div(nx, K6_T), ceil_div(nz, K6_T));
    cudaStream_t s = (cudaStream_t)stream;
    if (u == nullptr) {
        zt_jacobi_sweep2_kernel<true><<<grid, K6_THREADS, 0, s>>>(
            (const float2*)planes, (const float2*)D, (const float2*)b,
            nullptr, (float2*)out, nz, nx);
    } else {
        zt_jacobi_sweep2_kernel<false><<<grid, K6_THREADS, 0, s>>>(
            (const float2*)planes, (const float2*)D, (const float2*)b,
            (const float2*)u, (float2*)out, nz, nx);
    }
    return (int)cudaGetLastError();
}
