// K5: one damped-Jacobi sweep of a batch, for a scalar 9-point operator.
//
//   out[r, z, x] = u[r, z, x] + D[z, x] (b[r, z, x] - (A u[r])[z, x])
//   (A u)[z, x]  = sum_k planes[k, z, x] * u[z + dz_k, x + dx_k]
//
// with zero extension outside the (nz, nx) grid; planes (9, nz, nx) and
// D = omega * dinv (nz, nx) are shared by the R right-hand sides of
// b, u, out (R, nz, nx), all complex64. Any nz, nx >= 1.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::jacobi_sweep_pallas_batched
// (kernel body _jacobi_kernel_batched, launched by _batched_call): the
// second post-smoothing sweep of a V-cycle level at mg_nu2 = 2 (the
// default SolverConfig), after the fused upstroke K4.
//
// Bound on the card: device-memory bytes. Per point it must read the 9
// planes and D once and b, u once per RHS, and write out once per RHS:
// (10 + 3 R) * 8 bytes; the 9 neighbour reads of u hit the cache lines of
// the neighbouring threads (L1/L2). About 45 flops per point and RHS.
// Design: K1's layout. One thread per (z, x) point keeps its 9
// coefficients and D in registers and loops over the R right-hand sides,
// so the planes and D cross device memory once per launch instead of R
// times; neighbouring threads take neighbouring x, so every access is
// coalesced. The zero-extension halo is a predicate per tap.

#include "zt_common.cuh"

__global__ void zt_jacobi_sweep_kernel(const float2* __restrict__ planes,
                                       const float2* __restrict__ D,
                                       const float2* __restrict__ b,
                                       const float2* __restrict__ u,
                                       float2* __restrict__ out,
                                       int R, int nz, int nx) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int z = blockIdx.y * blockDim.y + threadIdx.y;
    if (z >= nz || x >= nx) return;
    const long long plane = (long long)nz * nx;
    const long long p = (long long)z * nx + x;

    float2 c[9];
    long long off[9];
    bool ok[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int zz = z + off_dz(k), xx = x + off_dx(k);
        ok[k] = zz >= 0 && zz < nz && xx >= 0 && xx < nx;
        off[k] = (long long)zz * nx + xx;
        c[k] = planes[k * plane + p];
    }
    const float2 d = D[p];
    for (int r = 0; r < R; ++r) {
        const float2* ur = u + r * plane;
        float2 au = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            if (ok[k]) au = cadd(au, cmul(c[k], ur[off[k]]));
        }
        out[r * plane + p] = cadd(ur[p], cmul(d, csub(b[r * plane + p], au)));
    }
}

ZT_EXPORT int zt_jacobi_sweep(const void* planes, const void* D,
                              const void* b, const void* u, void* out,
                              int R, int nz, int nx, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid(ceil_div(nx, 32), ceil_div(nz, 8));
    zt_jacobi_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)D, (const float2*)b,
        (const float2*)u, (float2*)out, R, nz, nx);
    return (int)cudaGetLastError();
}
