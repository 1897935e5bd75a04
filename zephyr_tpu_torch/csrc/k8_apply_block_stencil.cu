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
// two of out: (36 + 4 R) * 8 bytes. About 290 flops per point and RHS,
// far below the card's rate at that traffic. The earlier design (one
// thread per point holding all 36 coefficients, 108 registers, so two
// 256-thread blocks an SM; each thread walked the R RHS one after another
// with 18 gathered 8-byte loads of u a RHS through L1) took 2.43 ms at
// 2048^2 x 16, 41% of the bound (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): an extra RHS cost 3.5x its byte share, while at R = 1 it ran
// at 88% of the bound, so the per-RHS part was slow: too few warps in
// flight for its chains of dependent loads.
// Design (K2's frame idea, k2_presmooth_restrict.cu): a block owns a 4 x
// 32 tile for a group of G RHS (cuda_kernels._k8_group). Its 256 threads
// split the coefficients: thread pair (2p, 2p + 1) of a warp takes point p
// of a 16-point row strip, one output component i each, and keeps the 18
// coefficients of row i of the block (36 registers), loaded once and
// applied to every RHS of the group; the launch bound caps a thread at 64
// registers, so four blocks (32 warps) fit an SM. The two components of u
// on the tile plus a 1-cell halo (one frame cell a thread) stream through
// a double-buffered shared ring by cp.async with zero fill, K8_RP RHS a
// pass, issued right after the pass's one barrier so the next frames load
// while the current ones are applied; the 9 taps come from shared memory,
// and the two threads of a point read the same words (a broadcast, so a
// warp's tap load is one 128-byte wavefront). An 8 x 32 tile (512
// threads, two blocks an SM) ran 5% slower at 2048^2 x 16. Each output
// sums block (i, 0) over the taps, then block (i, 1), then adds the two,
// in the order of the plain twin (stencil.apply_block_stencil), so the
// kernel equals its twin bit for bit; a tap outside the grid multiplies a
// zero, as the twin's zero padding does.

#include "zt_common.cuh"

#define K8_TX 32            // tile width (points)
#define K8_TZ 4             // tile rows
#define K8_RP 4             // RHS a pass
#define K8_THREADS (2 * K8_TX * K8_TZ)
#define K8_FX (K8_TX + 2)                  // frame row (halo 1)
#define K8_NF ((K8_TZ + 2) * K8_FX)        // one component's frame

// four blocks an SM: at most 64 registers a thread
__global__ void __launch_bounds__(K8_THREADS, 4)
zt_apply_block_stencil_kernel(const float2* __restrict__ planes,
                              const float2* __restrict__ u,
                              float2* __restrict__ out, int R, int nz,
                              int nx, int G) {
    constexpr int FX = K8_FX, NF = K8_NF, RP = K8_RP;
    static_assert(NF <= K8_THREADS, "a thread for every frame cell");
    // the ring of frames [2][RP][2 components][NF]
    extern __shared__ float2 ring[];

    const int tid = threadIdx.x;
    const int zb = blockIdx.y * K8_TZ - 1, xb = blockIdx.x * K8_TX - 1;
    const long long plane = (long long)nz * nx;
    const int r0 = blockIdx.z * G;
    const int nr = min(G, R - r0);
    const int npass = (nr + RP - 1) / RP;

    // the frame cell this thread copies (the frames of pass k: RHS r0 +
    // RP k ..; none past the group), zero outside the grid
    const int fz = zb + tid / FX, fx = xb + tid % FX;
    const bool f_ok = fz >= 0 && fz < nz && fx >= 0 && fx < nx;
    const float2* f_src = u + (f_ok ? (long long)fz * nx + fx : 0)
                          + 2LL * r0 * plane;
    auto issue = [&](int k) {
        if (tid < NF) {
            float2* dst = ring + (k & 1) * RP * 2 * NF + tid;
            const int ne = min(RP, nr - RP * k);
            for (int e = 0; e < ne; ++e) {
                const float2* src = f_src + 2LL * (RP * k + e) * plane;
                cp_async<8>(dst + 2 * e * NF, f_ok ? src : u, f_ok);
                cp_async<8>(dst + (2 * e + 1) * NF, f_ok ? src + plane : u,
                            f_ok);
            }
        }
        cp_async_commit();
    };
    issue(0);   // in flight while the coefficients load

    // this thread's point and output component i; c[j][k] =
    // planes[i, j, k, z, x]
    const int i = tid & 1;
    const int pz = (tid >> 1) / K8_TX, px = (tid >> 1) % K8_TX;
    const int z = zb + 1 + pz, x = xb + 1 + px;
    const bool in = z < nz && x < nx;
    const long long p = in ? (long long)z * nx + x : 0;
    float2 c[2][9];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 9; ++k)
            c[j][k] = in ? planes[((2 * i + j) * 9 + k) * plane + p]
                         : make_float2(0.f, 0.f);

    const int w0 = (pz + 1) * FX + px + 1;        // the point's frame cell
    float2* o = out + (2LL * r0 + i) * plane + p;
    for (int k = 0; k < npass; ++k) {
        cp_async_wait<0>();
        __syncthreads();   // the frames of pass k are in; pass k-1 is done
        if (k + 1 < npass) issue(k + 1);
        if (!in) continue;
        const float2* fr = ring + (k & 1) * RP * 2 * NF + w0;
        // one RHS at a time: the warps of an SM hide the latency, and the
        // coefficients leave no registers for a second one
#pragma unroll 1
        for (int e = 0; e < min(RP, nr - RP * k); ++e) {
            const float2* f0 = fr + 2 * e * NF;
            const float2* f1 = f0 + NF;
            // s0, s1: the sums over the taps of blocks (i, 0) and (i, 1)
            float2 s0 = make_float2(0.f, 0.f), s1 = s0;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int d = off_dz(t) * FX + off_dx(t);
                s0 = cadd(s0, cmul(c[0][t], f0[d]));
                s1 = cadd(s1, cmul(c[1][t], f1[d]));
            }
            o[2LL * (RP * k + e) * plane] = cadd(s0, s1);
        }
    }
}

// g: RHS a block (cuda_kernels._k8_group)
ZT_EXPORT int zt_apply_block_stencil(const void* planes, const void* u,
                                     void* out, int R, int nz, int nx, int g,
                                     void* stream) {
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int smem = (int)(2 * K8_RP * 2 * K8_NF * sizeof(float2));
    const dim3 grid(ceil_div(nx, K8_TX), ceil_div(nz, K8_TZ), ceil_div(R, g));
    zt_apply_block_stencil_kernel<<<grid, K8_THREADS, smem,
                                    (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)u, (float2*)out, R, nz, nx, g);
    return (int)cudaGetLastError();
}
