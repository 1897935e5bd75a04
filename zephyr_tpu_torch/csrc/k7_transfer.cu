// K7: the standalone multigrid transfer operators, batched.
//
// restrict: full weighting, v (R, nz, nx) -> out (R, nzc, nxc) with
//   nzc = (nz + 1) / 2, nxc = (nx + 1) / 2:
//     out[I, J] = 1/4 sum_{a, b in -1..1} w(a) w(b) v[2I + a, 2J + b],
//     w = (1/2, 1, 1/2), v = 0 outside the grid;
// prolong: bilinear, vc (R, nzc, nxc) -> out (R, nz, nx), nz <= 2 nzc and
//   nx <= 2 nxc: per axis an even fine index 2I takes vc[I] and an odd one
//   2I + 1 takes (vc[I + 1] + vc[I]) / 2, vc = 0 past the coarse grid
//   (the zero-interleave-and-tent of _prolong_ref, cropped to (nz, nx)).
// All complex64. Any sizes, odd ones included. Both evaluate the z pass
// before the x pass in the twins' order of operations.
//
// Replaces zephyr_tpu/ops/pallas_transfer.py::restrict_pallas_batched and
// prolong_pallas_batched (both through _transfer_call, kernel body
// _transfer_kernel): the reduced-resolution spectral solve of the
// 'mult' hybrid preconditioner at fft_scale=2, which every transpose
// solve (the backward of ``solve``) runs.
//
// Bound on the card: device-memory bytes. restrict reads the fine field
// once and writes a quarter of it, 1.25 * 8 bytes per fine point; prolong
// reads a quarter and writes the fine field, the same. Under 10 flops per
// fine point.
// Design: a direct gather, not the TPU kernel's banded matmuls (those
// existed to keep stride-2 access off the TPU's lanes, and took only
// even, tile-aligned sizes). One thread per OUTPUT point and RHS, the RHS
// in the grid's z index; neighbouring threads take neighbouring output x,
// so writes are coalesced and the 9 (restrict) or 1-4 (prolong) taps of
// a warp fall on a few shared cache lines. Out-of-grid taps are
// predicates.

#include "zt_common.cuh"

__device__ __forceinline__ float2 tap(const float2* __restrict__ v, int z,
                                      int x, int nz, int nx) {
    return (z >= 0 && z < nz && x >= 0 && x < nx)
               ? v[(long long)z * nx + x]
               : make_float2(0.f, 0.f);
}

__global__ void zt_restrict_kernel(const float2* __restrict__ v,
                                   float2* __restrict__ out, int nz, int nx) {
    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const int J = blockIdx.x * blockDim.x + threadIdx.x;
    const int I = blockIdx.y * blockDim.y + threadIdx.y;
    if (I >= nzc || J >= nxc) return;
    const int r = blockIdx.z;
    const float2* vr = v + (long long)r * nz * nx;
    const int z = 2 * I, x = 2 * J;
    // tent in z per column, then in x, then 1/4 (as _restrict_ref)
    float2 t[3];
#pragma unroll
    for (int d = -1; d <= 1; ++d)
        t[d + 1] = cadd(tap(vr, z, x + d, nz, nx),
                        cscale(0.5f, cadd(tap(vr, z + 1, x + d, nz, nx),
                                          tap(vr, z - 1, x + d, nz, nx))));
    const float2 o = cadd(t[1], cscale(0.5f, cadd(t[2], t[0])));
    out[(long long)r * nzc * nxc + (long long)I * nxc + J] = cscale(0.25f, o);
}

// the z pass of the prolongation at fine row z, coarse column J
__device__ __forceinline__ float2 prolong_z(const float2* __restrict__ vc,
                                            int z, int J, int nzc, int nxc) {
    if (J >= nxc) return make_float2(0.f, 0.f);
    const int I = z >> 1;
    if (!(z & 1)) return vc[(long long)I * nxc + J];
    const float2 hi = I + 1 < nzc ? vc[(long long)(I + 1) * nxc + J]
                                  : make_float2(0.f, 0.f);
    return cscale(0.5f, cadd(hi, vc[(long long)I * nxc + J]));
}

__global__ void zt_prolong_kernel(const float2* __restrict__ vc,
                                  float2* __restrict__ out, int nzc, int nxc,
                                  int nz, int nx) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int z = blockIdx.y * blockDim.y + threadIdx.y;
    if (z >= nz || x >= nx) return;
    const int r = blockIdx.z;
    const float2* vr = vc + (long long)r * nzc * nxc;
    const int J = x >> 1;
    float2 o;
    if (!(x & 1))
        o = prolong_z(vr, z, J, nzc, nxc);
    else
        o = cscale(0.5f, cadd(prolong_z(vr, z, J + 1, nzc, nxc),
                              prolong_z(vr, z, J, nzc, nxc)));
    out[(long long)r * nz * nx + (long long)z * nx + x] = o;
}

ZT_EXPORT int zt_restrict(const void* v, void* out, int R, int nz, int nx,
                          void* stream) {
    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const dim3 block(32, 8);
    const dim3 grid(ceil_div(nxc, 32), ceil_div(nzc, 8), R);
    zt_restrict_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)v, (float2*)out, nz, nx);
    return (int)cudaGetLastError();
}

ZT_EXPORT int zt_prolong(const void* vc, void* out, int R, int nzc, int nxc,
                         int nz, int nx, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid(ceil_div(nx, 32), ceil_div(nz, 8), R);
    zt_prolong_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)vc, (float2*)out, nzc, nxc, nz, nx);
    return (int)cudaGetLastError();
}
