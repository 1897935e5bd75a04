// K1: batched scalar 9-point stencil apply.
//
//   out[r, z, x] = sum_k planes[k, z, x] * u[r, z + dz_k, x + dx_k]
//
// with zero extension outside the (nz, nx) grid; planes (9, nz, nx) are
// shared by the R right-hand sides of u (R, nz, nx), all complex64.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::apply_stencil_pallas_batched
// (kernel body _apply_kernel_rb): the Krylov matvec, the chunk true
// residual and the fused cycle's half-grid residual.
//
// Bound on the card: device-memory bytes. Per output point it reads
// 9 plane values and writes one value per RHS; the 9 neighbour reads of u
// hit the same cache lines as the neighbouring threads' (L1/L2 reuse), so
// the floor is (9 + 2 R) * 8 bytes per point.
// Design: one thread per (z, x) point holds its 9 coefficients in
// registers and loops over R, so the planes are read once per launch and
// not R times; neighbouring threads take neighbouring x, so every access
// is coalesced. The zero-extension halo is a predicate per tap.

#include "zt_common.cuh"

__global__ void zt_apply_stencil_kernel(const float2* __restrict__ planes,
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
    for (int r = 0; r < R; ++r) {
        const float2* ur = u + r * plane;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            if (ok[k]) acc = cadd(acc, cmul(c[k], ur[off[k]]));
        }
        out[r * plane + p] = acc;
    }
}

ZT_EXPORT int zt_apply_stencil(const void* planes, const void* u, void* out,
                               int R, int nz, int nx, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid(ceil_div(nx, 32), ceil_div(nz, 8));
    zt_apply_stencil_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)u, (float2*)out, R, nz, nx);
    return (int)cudaGetLastError();
}
