// K8: batched 2x2 block 9-point stencil apply (the Eurus TTI operator).
//
//   out[r, i, z, x] = sum_j sum_k planes[i, j, k, z, x]
//                                 * u[r, j, z + dz_k, x + dx_k]
//
// with zero extension outside the (nz, nx) grid; planes (2, 2, 9, nz, nx)
// are shared by the R right-hand sides of u (R, 2, nz, nx), all complex64
// read in place as float2. Any nz, nx >= 1.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::
// apply_block_stencil_pallas_batched (kernel body _apply_block_kernel_rb):
// every operator apply of a TTI solve, i.e. the Krylov matvec, the
// hybrid preconditioner's 'mult' residual and the residuals of the
// alternating-line smoother on every multigrid level.
//
// Bound on the card: device-memory bytes. Per point it must read the 36
// plane values once and, per RHS, the two components of u and write the
// two of out: (36 + 4 R) * 8 bytes. The 9 neighbour reads of u hit the
// cache lines of the neighbouring threads (L1/L2). About 290 flops per
// point and RHS, far below the card's rate at that traffic.
// Design: K1's layout. One thread per (z, x) point holds its 36
// coefficients in registers (72 of them) and loops over the R right-hand
// sides, so the planes cross device memory once per launch and not R
// times; neighbouring threads take neighbouring x, so every access is
// coalesced. Per tap it loads both components of u once and feeds all
// four blocks. The zero-extension halo is a predicate per tap. Each
// output sums block (i, 0) over the taps, then block (i, 1), then adds
// the two, in the order of the plain twin.

#include "zt_common.cuh"

__global__ void __launch_bounds__(256)
zt_apply_block_stencil_kernel(const float2* __restrict__ planes,
                              const float2* __restrict__ u,
                              float2* __restrict__ out,
                              int R, int nz, int nx) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int z = blockIdx.y * blockDim.y + threadIdx.y;
    if (z >= nz || x >= nx) return;
    const long long plane = (long long)nz * nx;
    const long long p = (long long)z * nx + x;

    // c[(i * 2 + j) * 9 + k] = planes[i, j, k, z, x]
    float2 c[36];
#pragma unroll
    for (int q = 0; q < 36; ++q) c[q] = planes[q * plane + p];

    bool ok[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int zz = z + off_dz(k), xx = x + off_dx(k);
        ok[k] = zz >= 0 && zz < nz && xx >= 0 && xx < nx;
    }

    for (int r = 0; r < R; ++r) {
        const float2* u0 = u + (2LL * r) * plane + p;
        const float2* u1 = u0 + plane;
        // s[i][j]: the sum over taps of block (i, j)
        float2 s00 = make_float2(0.f, 0.f), s01 = s00, s10 = s00, s11 = s00;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            if (ok[k]) {
                const long long d = (long long)off_dz(k) * nx + off_dx(k);
                const float2 v0 = u0[d], v1 = u1[d];
                s00 = cadd(s00, cmul(c[k], v0));
                s01 = cadd(s01, cmul(c[9 + k], v1));
                s10 = cadd(s10, cmul(c[18 + k], v0));
                s11 = cadd(s11, cmul(c[27 + k], v1));
            }
        }
        float2* o = out + (2LL * r) * plane + p;
        o[0] = cadd(s00, s01);
        o[plane] = cadd(s10, s11);
    }
}

ZT_EXPORT int zt_apply_block_stencil(const void* planes, const void* u,
                                     void* out, int R, int nz, int nx,
                                     void* stream) {
    const dim3 block(32, 8);
    const dim3 grid(ceil_div(nx, 32), ceil_div(nz, 8));
    zt_apply_block_stencil_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)u, (float2*)out, R, nz, nx);
    return (int)cudaGetLastError();
}
