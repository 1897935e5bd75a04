// K2: the V-cycle downstroke of one scalar multigrid level in one pass.
//
//   u1 = D b                                  (damped Jacobi from zero)
//   u2 = u1 + D (b - A u1)                    (NSWEEPS = 2 only)
//   res = mask (b - A u_last)
//   rc[I, J] = 1/4 sum_{a,b in -1..1} w(a) w(b) res[2I+a, 2J+b],
//              w = (.5, 1, .5), zero outside the grid
//
// b, u (R, nz, nx) and D = omega * dinv (nz, nx) complex64, mask (nz, nx)
// float32, rc (R, (nz+1)//2, (nx+1)//2) complex64. Any nz, nx >= 1, odd
// sizes included (the last coarse row/column then sits on the last fine
// one and its outer tent taps fall outside the grid).
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::
// presmooth2_restrict_pallas_batched (kernel body _ps2rr_kernel_rb, both
// its nsweeps=2 and nsweeps=1 variants).
//
// Bound on the card: device-memory bytes — it reads b once and writes u
// and the quarter-size rc; the two stencil applies and the restriction
// are ~50 flops per fine point per sweep, far below the compute roof.
// Design: a block owns a 2*TC x 2*TC fine tile (TC x TC coarse outputs)
// for one RHS; the RHS is the fastest grid index, so the R blocks of a
// tile are resident together and the 9 planes come from device memory
// about once, the other R-1 reads hitting the L2. It loads b with a halo of NSWEEPS+1 cells on the low side
// and NSWEEPS on the high side into shared memory and recomputes each
// sweep on a region one cell larger than the next stage needs, so u1, u2
// and the residual live only in shared memory; device memory sees b in,
// u and rc out. Points outside the grid are held at zero in every stage,
// which is the stencil's zero extension.

#include "zt_common.cuh"

#define K2_TC 16            // coarse outputs per tile side
#define K2_F (2 * K2_TC)    // fine points per tile side
#define K2_THREADS 256

template <int NSWEEPS>
__global__ void __launch_bounds__(K2_THREADS)
zt_presmooth_restrict_kernel(const float2* __restrict__ planes,
                             const float2* __restrict__ D,
                             const float* __restrict__ mask,
                             const float2* __restrict__ b,
                             float2* __restrict__ u_out,
                             float2* __restrict__ rc,
                             int nz, int nx) {
    constexpr int L = NSWEEPS + 1;            // low-side halo
    constexpr int S = K2_F + 2 * NSWEEPS + 1; // shared frame side
    __shared__ float2 b_s[S][S];
    __shared__ float2 u1_s[S][S];
    __shared__ float2 u2_s[S][S];   // unused when NSWEEPS = 1
    __shared__ float2 res_s[S][S];
    float2 (*ul)[S] = NSWEEPS == 2 ? u2_s : u1_s;   // the last iterate

    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const int I0 = blockIdx.z * K2_TC, J0 = blockIdx.y * K2_TC;
    const int zb = 2 * I0 - L, xb = 2 * J0 - L;   // frame origin (fine)
    const int r = blockIdx.x;
    const long long plane = (long long)nz * nx;
    const float2* br = b + r * plane;
    const float2 zero = make_float2(0.f, 0.f);

    // stage 0: b and u1 = D b on the whole frame
    for (int q = threadIdx.x; q < S * S; q += K2_THREADS) {
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

    // stage 1 (NSWEEPS = 2): u2 = u1 + D (b - A u1), frame [1, S-1)
    if (NSWEEPS == 2) {
        for (int q = threadIdx.x; q < (S - 2) * (S - 2);
             q += K2_THREADS) {
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
    }

    // stage 2: res = mask (b - A u_last), frame [NSWEEPS, S-NSWEEPS)
    {
        const int W = S - 2 * NSWEEPS;
        for (int q = threadIdx.x; q < W * W; q += K2_THREADS) {
            const int qi = NSWEEPS + q / W, qj = NSWEEPS + q % W;
            const int z = zb + qi, x = xb + qj;
            float2 v = zero;
            if (z >= 0 && z < nz && x >= 0 && x < nx) {
                const long long p = (long long)z * nx + x;
                float2 au = zero;
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    au = cadd(au, cmul(planes[k * plane + p],
                                       ul[qi + off_dz(k)][qj + off_dx(k)]));
                }
                v = cscale(mask[p], csub(b_s[qi][qj], au));
            }
            res_s[qi][qj] = v;
        }
    }
    __syncthreads();

    // restriction: separable tent in z, then in x, then 1/4
    const long long cplane = (long long)nzc * nxc;
    for (int q = threadIdx.x; q < K2_TC * K2_TC; q += K2_THREADS) {
        const int I = I0 + q / K2_TC, J = J0 + q % K2_TC;
        if (I >= nzc || J >= nxc) continue;
        const int ci = 2 * I - zb, cj = 2 * J - xb;
        float2 t[3];
#pragma unroll
        for (int d = -1; d <= 1; ++d)
            t[d + 1] = cadd(res_s[ci][cj + d],
                            cscale(0.5f, cadd(res_s[ci + 1][cj + d],
                                              res_s[ci - 1][cj + d])));
        const float2 v = cadd(t[1], cscale(0.5f, cadd(t[2], t[0])));
        rc[r * cplane + (long long)I * nxc + J] = cscale(0.25f, v);
    }

    // the smoothed iterate on the tile's own fine points
    float2* ur = u_out + r * plane;
    for (int q = threadIdx.x; q < K2_F * K2_F; q += K2_THREADS) {
        const int qi = L + q / K2_F, qj = L + q % K2_F;
        const int z = zb + qi, x = xb + qj;
        if (z >= nz || x >= nx) continue;
        ur[(long long)z * nx + x] = ul[qi][qj];
    }
}

ZT_EXPORT int zt_presmooth_restrict(const void* planes, const void* D,
                                    const void* mask, const void* b,
                                    void* u, void* rc, int R, int nz,
                                    int nx, int nsweeps, void* stream) {
    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    // the RHS index varies fastest, so the R blocks of one tile run
    // together and share its plane reads through the L2
    const dim3 grid(R, ceil_div(nxc, K2_TC), ceil_div(nzc, K2_TC));
    cudaStream_t s = (cudaStream_t)stream;
    if (nsweeps == 2) {
        zt_presmooth_restrict_kernel<2><<<grid, K2_THREADS, 0, s>>>(
            (const float2*)planes, (const float2*)D, (const float*)mask,
            (const float2*)b, (float2*)u, (float2*)rc, nz, nx);
    } else if (nsweeps == 1) {
        zt_presmooth_restrict_kernel<1><<<grid, K2_THREADS, 0, s>>>(
            (const float2*)planes, (const float2*)D, (const float*)mask,
            (const float2*)b, (float2*)u, (float2*)rc, nz, nx);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
