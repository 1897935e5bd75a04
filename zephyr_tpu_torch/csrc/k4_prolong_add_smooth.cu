// K4: the V-cycle upstroke of one scalar multigrid level in one pass.
//
//   u1  = u + mask P(ec)
//   out = u1 + D (b - A u1)
//
// with P the bilinear prolongation from the ((nz+1)//2, (nx+1)//2) grid:
// an even fine index 2I takes ec[I], an odd one 2I+1 takes
// (ec[I] + ec[I+1]) / 2 (ec[I+1] = 0 past the coarse grid), per axis,
// cropped to (nz, nx). b, u, out (R, nz, nx), ec (R, nzc, nxc) and
// D = omega * dinv (nz, nx) complex64; mask (nz, nx) float32.
//
// Replaces zephyr_tpu/ops/pallas_stencil.py::
// prolong_add_smooth_pallas_batched (kernel body _pas_kernel_rb).
//
// Bound on the card: device-memory bytes — b, u and out at full size plus
// a quarter-size ec and the 9 planes; about 45 flops per point.
// Design: a block owns a T x T fine tile of one RHS; the RHS is the
// fastest grid index, so a tile's R blocks run together and share the
// plane, D and mask reads through the L2. It builds u1 on the tile plus
// a one-cell halo in shared memory straight from ec and u (the
// prolongation is at most four coarse reads per point, served by L1), so
// the corrected iterate never goes to device memory, then runs the sweep
// from shared memory. Points outside the grid are held at zero.

#include "zt_common.cuh"

#define K4_T 32
#define K4_THREADS 256

__device__ __forceinline__ float2 prolong_at(const float2* __restrict__ ec,
                                             int z, int x, int nzc,
                                             int nxc) {
    // bilinear tent weights, separable; coarse points past the grid are 0
    const int i0 = z >> 1, j0 = x >> 1;
    const bool zodd = z & 1, xodd = x & 1;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        if (a == 1 && !zodd) break;
        const int I = i0 + a;
        if (I >= nzc) continue;
        const float wz = zodd ? 0.5f : 1.0f;
        const float2* row = ec + (long long)I * nxc;
        float2 v = row[j0];
        if (xodd) {
            const float2 v1 = j0 + 1 < nxc ? row[j0 + 1]
                                           : make_float2(0.f, 0.f);
            v = cscale(0.5f, cadd(v, v1));
        }
        acc = cadd(acc, cscale(wz, v));
    }
    return acc;
}

__global__ void __launch_bounds__(K4_THREADS)
zt_prolong_add_smooth_kernel(const float2* __restrict__ planes,
                             const float2* __restrict__ D,
                             const float* __restrict__ mask,
                             const float2* __restrict__ b,
                             const float2* __restrict__ u,
                             const float2* __restrict__ ec,
                             float2* __restrict__ out, int nz, int nx) {
    constexpr int S = K4_T + 2;
    __shared__ float2 u1_s[S][S];

    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const int z0 = blockIdx.z * K4_T, x0 = blockIdx.y * K4_T;
    const int r = blockIdx.x;
    const long long plane = (long long)nz * nx;
    const float2* ur = u + r * plane;
    const float2* ecr = ec + r * (long long)nzc * nxc;
    const float2 zero = make_float2(0.f, 0.f);

    for (int q = threadIdx.x; q < S * S; q += K4_THREADS) {
        const int qi = q / S, qj = q % S;
        const int z = z0 - 1 + qi, x = x0 - 1 + qj;
        float2 v = zero;
        if (z >= 0 && z < nz && x >= 0 && x < nx) {
            const long long p = (long long)z * nx + x;
            v = cadd(ur[p], cscale(mask[p], prolong_at(ecr, z, x, nzc,
                                                       nxc)));
        }
        u1_s[qi][qj] = v;
    }
    __syncthreads();

    const float2* brr = b + r * plane;
    float2* outr = out + r * plane;
    for (int q = threadIdx.x; q < K4_T * K4_T; q += K4_THREADS) {
        const int qi = 1 + q / K4_T, qj = 1 + q % K4_T;
        const int z = z0 - 1 + qi, x = x0 - 1 + qj;
        if (z >= nz || x >= nx) continue;
        const long long p = (long long)z * nx + x;
        float2 au = zero;
#pragma unroll
        for (int k = 0; k < 9; ++k)
            au = cadd(au, cmul(planes[k * plane + p],
                               u1_s[qi + off_dz(k)][qj + off_dx(k)]));
        outr[p] = cadd(u1_s[qi][qj], cmul(D[p], csub(brr[p], au)));
    }
}

ZT_EXPORT int zt_prolong_add_smooth(const void* planes, const void* D,
                                    const void* mask, const void* b,
                                    const void* u, const void* ec, void* out,
                                    int R, int nz, int nx, void* stream) {
    const dim3 grid(R, ceil_div(nx, K4_T), ceil_div(nz, K4_T));
    zt_prolong_add_smooth_kernel<<<grid, K4_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)D, (const float*)mask,
        (const float2*)b, (const float2*)u, (const float2*)ec,
        (float2*)out, nz, nx);
    return (int)cudaGetLastError();
}
