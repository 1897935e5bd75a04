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
// and RHS, far below the compute roof. The earlier design (one block per
// (RHS, 32 x 32 tile), 256 threads) read the 9 planes and D from global
// memory in both stencil stages of every block, so at R = 16 the
// coefficients crossed the L2 about 32 times per launch against once for
// the bound: 2.10 ms from u and 0.95 ms from zero at 2048^2 x 16 (NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md), 28% and 44% of the bound.
// Design (K2's frame, k2_presmooth_restrict.cu, on a smaller tile): a
// block owns a 16 x 32 output tile for a group of G RHS
// (cuda_kernels._k6_group). Its threads (320 from u, 256 from zero) load
// the tile's coefficients once, into registers: each owns a vertical pair
// of points of the stencil region (zt_common.cuh's stencil_pair) and keeps
// their 9 planes and D, and applies them to every RHS of the group. The
// frames (b and u with a halo of 2 from u; b with a halo of 1 from zero)
// stream through a double-buffered shared ring by cp.async with zero
// fill, two RHS a pass: the next pass's frames are issued right after the
// pass's first barrier, so they load while the current ones are smoothed,
// and a pass needs two barriers. u1 lives only in shared memory (from u it
// is computed on the tile plus one cell, from zero as D b on the frame);
// u2 goes from registers straight to out on the tile's own points. Two
// blocks fit an SM (the launch bound), so one block's coefficient loads
// and barriers overlap the other's stencils: a 32 x 32 tile, one block an
// SM, ran 6% (from u) and 5% (from zero) slower at 2048^2 x 16 and up to
// 9% slower at R = 1 on the same card. Points outside the grid hold zero
// in every stage, which is the stencil's zero extension. Stage structure
// and summation order are the twin's (stencil._jacobi2_ref,
// _jacobi2z_ref), so the kernel equals its twin bit for bit. Bytes at
// 2048^2 x 16 (G = 16): coefficients 80 B x (18 x 34) / (16 x 32) per
// point once, the fields 8 B per point per RHS (from zero) or 16 B (from
// u) in and 8 B out, plus their halo re-reads from the L2.

#include "zt_common.cuh"

#define K6_TX 32            // output points per tile row
#define K6_TZ 16            // output rows per tile
#define K6_RP 2             // RHS a pass: their stages share the barriers

// The frame and thread layout of a K6_TZ x K6_TX output tile.
template <bool FROM_ZERO>
struct K6Frame {
    static constexpr int TZ = K6_TZ;
    static constexpr int H = FROM_ZERO ? 1 : 2;       // halo of the frames
    static constexpr int S = K6_TX + 2 * H;           // frame row
    static constexpr int NF = (TZ + 2 * H) * S;
    static constexpr int NFLD = FROM_ZERO ? 1 : 2;    // b (and u) a RHS
    // the pairs' region, rows [1, 1 + CZ) and columns [1, 1 + CX) of the
    // frame: from zero the tile (one stencil stage); from u the tile plus
    // one cell, where u1 is needed
    static constexpr int CX = FROM_ZERO ? K6_TX : K6_TX + 2;
    static constexpr int CZ = FROM_ZERO ? TZ : TZ + 2;
    static constexpr int NRB = (CZ + 1) / 2;          // pairs a column
    static constexpr int THREADS = (CX * NRB + 31) / 32 * 32;  // 320, 256
};

// two blocks an SM: one block's loads overlap the other's stencils
template <bool FROM_ZERO>
__global__ void __launch_bounds__(K6Frame<FROM_ZERO>::THREADS, 2)
zt_jacobi_sweep2_kernel(const float2* __restrict__ planes,
                        const float2* __restrict__ D,
                        const float2* __restrict__ b,
                        const float2* __restrict__ u,
                        float2* __restrict__ out, int R, int nz, int nx,
                        int G) {
    using F = K6Frame<FROM_ZERO>;
    constexpr int TZ = F::TZ, H = F::H, S = F::S, NF = F::NF;
    constexpr int NFLD = F::NFLD;
    constexpr int CX = F::CX, CZ = F::CZ, NT = F::THREADS, RP = K6_RP;
    constexpr int PF = FROM_ZERO ? (NF + NT - 1) / NT : 1;
    // the ring of frames [2][RP][NFLD][NF] (field 0 b, field 1 u), then
    // u1 [RP][NF]
    extern __shared__ float2 sm[];
    float2* ring = sm;
    float2* u1_s = sm + 2 * RP * NFLD * NF;

    const int tid = threadIdx.x;
    const int zb = blockIdx.y * TZ - H, xb = blockIdx.x * K6_TX - H;
    const long long plane = (long long)nz * nx;
    const int r0 = blockIdx.z * G;
    const int nr = min(G, R - r0);
    const int npass = (nr + RP - 1) / RP;
    const float2 zero = make_float2(0.f, 0.f);

    // the frames of pass k (RHS r0 + RP k ..; none past the group)
    auto issue = [&](int k) {
        float2* dst = ring + (k & 1) * RP * NFLD * NF;
#pragma unroll
        for (int e = 0; e < RP; ++e) {
            const int r = RP * k + e;
            if (r >= nr) break;
#pragma unroll
            for (int f = 0; f < NFLD; ++f) {
                const float2* src = (f == 0 ? b : u) + (r0 + r) * plane;
                for (int q = tid; q < NF; q += NT) {
                    const int z = zb + q / S, x = xb + q % S;
                    const bool ok = z >= 0 && z < nz && x >= 0 && x < nx;
                    cp_async<8>(dst + (e * NFLD + f) * NF + q,
                                ok ? src + (long long)z * nx + x : b, ok);
                }
            }
        }
        cp_async_commit();
    };
    issue(0);   // in flight while the coefficients load

    // from zero, D on this thread's frame points (u1 = D b)
    float2 d0[PF];
    unsigned in0 = 0u;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        const int q = tid + k * NT;
        const int z = zb + q / S, x = xb + q % S;
        d0[k] = zero;
        if (FROM_ZERO && q < NF && z >= 0 && z < nz && x >= 0 && x < nx) {
            in0 |= 1u << k;
            d0[k] = D[(long long)z * nx + x];
        }
    }
    // the region by vertical pairs: thread t < CX * NRB owns column
    // t % CX, rows 2 (t / CX) and 2 (t / CX) + 1 of the region, with their
    // 9 planes and D in registers
    const int pcol = tid % CX, prow = 2 * (tid / CX);
    const bool pair_ok = tid < CX * F::NRB;
    const bool has2 = prow + 1 < CZ;
    const int qi0 = 1 + prow, qj = 1 + pcol;    // the first point's frame cell
    float2 pc[2][9], dc[2];
    const float mc[2] = {0.f, 0.f};             // no residual stage here
    unsigned inc = 0u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int z = zb + qi0 + p, x = xb + qj;
        dc[p] = zero;
#pragma unroll
        for (int t = 0; t < 9; ++t) pc[p][t] = zero;
        if (pair_ok && (p == 0 || has2) && z >= 0 && z < nz && x >= 0
            && x < nx) {
            inc |= 1u << p;
            const long long i = (long long)z * nx + x;
#pragma unroll
            for (int t = 0; t < 9; ++t) pc[p][t] = planes[t * plane + i];
            dc[p] = D[i];
        }
    }
    // from u, the stencil of stage 2 reads u1 on the frame's outer ring,
    // which stage 1 never writes
    if (!FROM_ZERO)
        for (int q = tid; q < RP * NF; q += NT) u1_s[q] = zero;

    // whether the pair's column is on the tile, where u2 is stored (from
    // zero the region is the tile; from u it is one cell wider)
    const bool col_out = qj >= H && qj < H + K6_TX;
    for (int k = 0; k < npass; ++k) {
        cp_async_wait<0>();
        __syncthreads();   // the frames of pass k are in; pass k-1 is done
        if (k + 1 < npass) issue(k + 1);
        const float2* fr = ring + (k & 1) * RP * NFLD * NF;
        const int ne = min(RP, nr - RP * k);    // RHS of this pass

        if (FROM_ZERO) {
            // stage 1: u1 = D b on the whole frame
#pragma unroll
            for (int j = 0; j < PF; ++j) {
                const int q = tid + j * NT;
                if (q < NF) {
                    const bool in = (in0 >> j) & 1u;
#pragma unroll
                    for (int e = 0; e < RP; ++e)
                        if (e < ne)
                            u1_s[e * NF + q] =
                                in ? cmul(d0[j], fr[e * NF + q]) : zero;
                }
            }
        } else if (pair_ok) {
            // stage 1: u1 = u + D (b - A u) on the region
#pragma unroll
            for (int e = 0; e < RP; ++e) {
                if (e >= ne) break;
                float2 v[2];
                stencil_pair<S, true>(fr + (2 * e + 1) * NF, fr + 2 * e * NF,
                                      v, pc, dc, mc, inc, qi0, qj, has2);
                u1_s[e * NF + qi0 * S + qj] = v[0];
                if (has2) u1_s[e * NF + (qi0 + 1) * S + qj] = v[1];
            }
        }
        __syncthreads();

        // stage 2: u2 = u1 + D (b - A u1), from registers to out
        if (pair_ok && col_out) {
#pragma unroll
            for (int e = 0; e < RP; ++e) {
                if (e >= ne) break;
                float2 v[2];
                stencil_pair<S, true>(u1_s + e * NF, fr + NFLD * e * NF, v,
                                      pc, dc, mc, inc, qi0, qj, has2);
                float2* o = out + (r0 + RP * k + e) * plane;
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int qi = qi0 + p;
                    if (((inc >> p) & 1u) && qi >= H && qi < H + TZ)
                        o[(long long)(zb + qi) * nx + xb + qj] = v[p];
                }
            }
        }
    }
}

template <bool FROM_ZERO>
static int launch_j2(const void* planes, const void* D, const void* b,
                     const void* u, void* out, int R, int nz, int nx, int g,
                     cudaStream_t s) {
    using F = K6Frame<FROM_ZERO>;
    const int smem = (int)((2 * F::NFLD + 1) * K6_RP * F::NF
                           * sizeof(float2));
    static bool smem_set[ZT_MAX_DEVICES] = {};
    cudaError_t err = smem_limit_once(zt_jacobi_sweep2_kernel<FROM_ZERO>,
                                      smem, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(nx, K6_TX), ceil_div(nz, K6_TZ),
                    ceil_div(R, g));
    zt_jacobi_sweep2_kernel<FROM_ZERO><<<grid, F::THREADS, smem, s>>>(
        (const float2*)planes, (const float2*)D, (const float2*)b,
        (const float2*)u, (float2*)out, R, nz, nx, g);
    return (int)cudaGetLastError();
}

// u == nullptr: from zero; g: RHS a block (cuda_kernels._k6_group)
ZT_EXPORT int zt_jacobi_sweep2(const void* planes, const void* D,
                               const void* b, const void* u, void* out,
                               int R, int nz, int nx, int g, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g < 1) return (int)cudaErrorInvalidValue;
    if (u == nullptr)
        return launch_j2<true>(planes, D, b, u, out, R, nz, nx, g, s);
    return launch_j2<false>(planes, D, b, u, out, R, nz, nx, g, s);
}
