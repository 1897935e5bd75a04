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
// and the residual once (24 B); ~165 flops per point and RHS, far below
// the compute roof. The earlier design (one block per (RHS, 32 x 32
// tile), 256 threads) read the 9 planes and D from global memory in both
// stencil stages of every block, so at R = 16 the coefficients crossed
// the L2 about 32 times per launch against once for the bound: 2.075 ms
// at 2048^2 x 16 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), 28% of it.
// Design (K6's frame from u, k6_jacobi_sweep2.cu, with one field): a
// block owns a 16 x 32 output tile for a group of G RHS
// (cuda_kernels._k9_group). Its 320 threads load the tile's coefficients
// once, into registers: each owns a vertical pair of points of the tile
// plus one cell (34 x 18: 306 pairs; zt_common.cuh's stencil_pair) and
// keeps their 9 planes, D and mask (42 floats), and the first 108 threads
// each keep D at one cell of the frame's outer ring, outside the pairs;
// all of it serves every RHS of the group. The b frames (the tile with a
// halo of 2: 20 x 36 cells) stream through a double-buffered shared ring
// by cp.async with zero fill, two RHS a pass. Each thread copies exactly
// the frame cells it owns (its pair's points and its ring cell), so after
// its own cp.async wait it forms u1 = D b on them with no barrier first:
// a pass takes two barriers, one after u1 (the frames and u1 are then
// whole, and the next pass's frames are issued) and one after u2 (u2 on
// the tile plus one cell, from registers to u_out on the tile's own
// points), then the residual on the tile; u1 and u2 live only in shared
// memory. Two blocks fit an SM (the launch bound, 96 registers), so one
// block's loads and barriers overlap the other's stencils. Points outside
// the grid hold zero in every stage, which is the stencil's zero
// extension. Stage structure and summation order are the twin's
// (stencil._ps2r_ref on _jacobi2z_ref), so the kernel equals its twin bit
// for bit. Bytes at 2048^2 x 16 (G = 16): coefficients 84 B x (18 x 34) /
// (16 x 32) per point once, b 8 B per point per RHS in (plus its halo
// re-reads from the L2), u2 and the residual 16 B out. Tried on the same
// card at 2048^2 x 16 (PERF.md): the frames copied by a strided loop,
// with a barrier before u1 (three a pass), 0.951 ms; u1 formed inside the
// sweep from a shared D frame (two barriers; 96 registers and an 8 B
// spill) 1.028 ms; this design with four RHS a pass 0.926 ms (0.183 at
// R = 1); this design 0.884 ms (0.163 at R = 1).

#include "zt_common.cuh"

#define K9_TX 32            // output points per tile row
#define K9_TZ 16            // output rows per tile
#define K9_RP 2             // RHS a pass: their stages share the barriers

// The frame and thread layout of a K9_TZ x K9_TX output tile.
struct K9Frame {
    static constexpr int H = 2;                        // halo of the frames
    static constexpr int S = K9_TX + 2 * H;            // frame row: 36
    static constexpr int NF = (K9_TZ + 2 * H) * S;     // frame cells: 720
    // the pairs' region, rows [1, 1 + CZ) and columns [1, 1 + CX) of the
    // frame: the tile plus one cell, where u2 is needed
    static constexpr int CX = K9_TX + 2;
    static constexpr int CZ = K9_TZ + 2;
    static constexpr int NRB = CZ / 2;                 // pairs a column
    static constexpr int THREADS = (CX * NRB + 31) / 32 * 32;  // 320
    static constexpr int NRING = NF - CX * CZ;         // outer ring: 108
};

// frame cell of outer-ring cell t: rows 0 and CZ + 1, then columns 0 and
// S - 1 of the rows between
__device__ __forceinline__ int k9_ring_cell(int t) {
    using F = K9Frame;
    if (t < F::S) return t;
    if (t < 2 * F::S) return (F::CZ + 1) * F::S + t - F::S;
    t -= 2 * F::S;
    return (1 + t / 2) * F::S + (t & 1) * (F::S - 1);
}

// two blocks an SM: one block's loads overlap the other's stencils
__global__ void __launch_bounds__(K9Frame::THREADS, 2)
zt_presmooth_residual_kernel(const float2* __restrict__ planes,
                             const float2* __restrict__ D,
                             const float* __restrict__ mask,
                             const float2* __restrict__ b,
                             float2* __restrict__ u_out,
                             float2* __restrict__ res_out, int R, int nz,
                             int nx, int G) {
    using F = K9Frame;
    constexpr int H = F::H, S = F::S, NF = F::NF, CX = F::CX;
    constexpr int NT = F::THREADS, RP = K9_RP;
    static_assert(F::CZ % 2 == 0, "every pair lies in the region");
    static_assert(F::NRING <= NT, "a thread for every ring cell");
    // the ring of b frames [2][RP][NF], then u1 [RP][NF] and u2 [RP][NF]
    extern __shared__ float2 sm[];
    float2* ring = sm;
    float2* u1_s = sm + 2 * RP * NF;
    float2* u2_s = u1_s + RP * NF;

    const int tid = threadIdx.x;
    const int zb = blockIdx.y * K9_TZ - H, xb = blockIdx.x * K9_TX - H;
    const long long plane = (long long)nz * nx;
    const int r0 = blockIdx.z * G;
    const int nr = min(G, R - r0);
    const int npass = (nr + RP - 1) / RP;
    const float2 zero = make_float2(0.f, 0.f);

    // the region by vertical pairs: thread t < CX * NRB owns column
    // t % CX, rows 2 (t / CX) and 2 (t / CX) + 1 of the region, with their
    // 9 planes, D and mask in registers
    const int pcol = tid % CX, prow = 2 * (tid / CX);
    const bool pair_ok = tid < CX * F::NRB;
    const int qi0 = 1 + prow, qj = 1 + pcol;    // the first point's frame cell
    unsigned inc = 0u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int z = zb + qi0 + p, x = xb + qj;
        if (pair_ok && z >= 0 && z < nz && x >= 0 && x < nx) inc |= 1u << p;
    }
    // this thread's cell of the frame's outer ring
    const bool ring_ok = tid < F::NRING;
    const int rq = ring_ok ? k9_ring_cell(tid) : 0;
    const int rz = zb + rq / S, rx = xb + rq % S;
    const bool ring_in = ring_ok && rz >= 0 && rz < nz && rx >= 0 && rx < nx;
    // the frames of pass k (RHS r0 + RP k ..; none past the group): each
    // thread copies the cells it reads in stage 1 (its pair's points and
    // its ring cell), so its own wait makes them visible to it
    auto issue = [&](int k) {
        float2* dst = ring + (k & 1) * RP * NF;
#pragma unroll
        for (int e = 0; e < RP; ++e) {
            const int r = RP * k + e;
            if (r >= nr) break;
            const float2* src = b + (r0 + r) * plane;
            if (pair_ok) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const bool ok = (inc >> p) & 1u;
                    const long long i = (long long)(zb + qi0 + p) * nx + xb
                                        + qj;
                    cp_async<8>(dst + e * NF + (qi0 + p) * S + qj,
                                ok ? src + i : b, ok);
                }
            }
            if (ring_ok) {
                cp_async<8>(dst + e * NF + rq,
                            ring_in ? src + (long long)rz * nx + rx : b,
                            ring_in);
            }
        }
        cp_async_commit();
    };
    issue(0);   // in flight while the coefficients load

    // the pair's 9 planes, D and mask, and D at the ring cell
    float2 pc[2][9], dc[2];
    float mc[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        dc[p] = zero;
        mc[p] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) pc[p][t] = zero;
        if ((inc >> p) & 1u) {
            const long long i = (long long)(zb + qi0 + p) * nx + xb + qj;
#pragma unroll
            for (int t = 0; t < 9; ++t) pc[p][t] = planes[t * plane + i];
            dc[p] = D[i];
            mc[p] = mask[i];
        }
    }
    const float2 dr = ring_in ? D[(long long)rz * nx + rx] : zero;

    // the pair's points on the tile (u2 and the residual go out there):
    // the region is the tile plus one cell, so a pair of the first or
    // last row has one point on it. Rows 0 and CZ + 1 of u2_s are never
    // written: the residual stage reads them only in the windows of
    // points off the tile, which it does not compute.
    const bool col_out = qj >= H && qj < H + K9_TX;
    unsigned out_bits = 0u;
#pragma unroll
    for (int p = 0; p < 2; ++p)
        if (col_out && qi0 + p >= H && qi0 + p < H + K9_TZ)
            out_bits |= 1u << p;
    const unsigned inc_out = inc & out_bits;

    for (int k = 0; k < npass; ++k) {
        const float2* fr = ring + (k & 1) * RP * NF;
        const int ne = min(RP, nr - RP * k);    // RHS of this pass
        cp_async_wait<0>();   // this thread's cells of the frames of pass k

        // stage 1: u1 = D b on the whole frame (the pairs' points and the
        // outer ring), each thread on the cells it copied
#pragma unroll
        for (int e = 0; e < RP; ++e) {
            if (e >= ne) break;
            if (pair_ok) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int q = e * NF + (qi0 + p) * S + qj;
                    u1_s[q] = ((inc >> p) & 1u) ? cmul(dc[p], fr[q]) : zero;
                }
            }
            if (ring_ok)
                u1_s[e * NF + rq] = ring_in ? cmul(dr, fr[e * NF + rq])
                                            : zero;
        }
        __syncthreads();   // frames and u1 of pass k in; pass k-1 is done
        if (k + 1 < npass) issue(k + 1);

        // stage 2: u2 = u1 + D (b - A u1) on the region, to u_out from
        // registers on the tile
        if (pair_ok) {
#pragma unroll
            for (int e = 0; e < RP; ++e) {
                if (e >= ne) break;
                float2 v[2];
                stencil_pair<S, true>(u1_s + e * NF, fr + e * NF, v, pc, dc,
                                      mc, inc, qi0, qj, true);
                u2_s[e * NF + qi0 * S + qj] = v[0];
                u2_s[e * NF + (qi0 + 1) * S + qj] = v[1];
                float2* o = u_out + (r0 + RP * k + e) * plane;
#pragma unroll
                for (int p = 0; p < 2; ++p)
                    if ((inc_out >> p) & 1u)
                        o[(long long)(zb + qi0 + p) * nx + xb + qj] = v[p];
            }
        }
        __syncthreads();

        // stage 3: res = mask (b - A u2) on the tile
        if (inc_out) {
#pragma unroll
            for (int e = 0; e < RP; ++e) {
                if (e >= ne) break;
                float2 v[2];
                stencil_pair<S, false>(u2_s + e * NF, fr + e * NF, v, pc, dc,
                                       mc, inc_out, qi0, qj, true);
                float2* o = res_out + (r0 + RP * k + e) * plane;
#pragma unroll
                for (int p = 0; p < 2; ++p)
                    if ((inc_out >> p) & 1u)
                        o[(long long)(zb + qi0 + p) * nx + xb + qj] = v[p];
            }
        }
    }
}

// g: RHS a block (cuda_kernels._k9_group)
ZT_EXPORT int zt_presmooth_residual(const void* planes, const void* D,
                                    const void* mask, const void* b,
                                    void* u, void* res, int R, int nz,
                                    int nx, int g, void* stream) {
    if (g < 1) return (int)cudaErrorInvalidValue;
    // the b ring, u1 and u2: 45 KB, within the default 48 KB a block may
    // take without cudaFuncSetAttribute
    constexpr int smem = (int)(4 * K9_RP * K9Frame::NF * sizeof(float2));
    static_assert(smem <= 48 * 1024, "above 48 KB: use smem_limit_once");
    const dim3 grid(ceil_div(nx, K9_TX), ceil_div(nz, K9_TZ),
                    ceil_div(R, g));
    zt_presmooth_residual_kernel<<<grid, K9Frame::THREADS, smem,
                                   (cudaStream_t)stream>>>(
        (const float2*)planes, (const float2*)D, (const float*)mask,
        (const float2*)b, (float2*)u, (float2*)res, R, nz, nx, g);
    return (int)cudaGetLastError();
}
