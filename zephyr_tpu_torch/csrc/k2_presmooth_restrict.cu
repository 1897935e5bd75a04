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
// Bound on the card: device-memory bytes. Each fine point needs its 9
// planes, D and the mask once (84 B) and, per RHS, b in (8 B), u out (8 B)
// and a quarter of rc (2 B); the two stencil applies and the restriction
// are ~200 flops per point per RHS, far below the compute roof. The earlier
// design ran one block per (RHS, tile) and read the coefficients from
// global memory in both stencil stages of every block: ~13 GB of L2
// traffic per launch at 2048^2 x 16 against a 1.56 GB floor.
// Design (the whole-batch frame of the JAX kernel _ps2rr_kernel_rb): a
// block owns a 32 x 32 fine tile (16 x 16 coarse outputs) for a group of G
// RHS (the wrapper, cuda_kernels._ps_group, picks G so that every level
// still launches about two blocks an SM). Its 640 threads load the tile's
// coefficients once, into registers: each thread owns a vertical pair of
// points of the stencil region and keeps their 9 planes, D and mask (42
// floats), plus D at its points of the frame, and applies them to every
// RHS of the group; the pair reads the 4 x 3 window of its two stencils
// once. The b frames (the tile with a halo of NSWEEPS+1 cells below and
// NSWEEPS above) stream through a double-buffered shared ring by cp.async
// with zero fill, two RHS a pass, so the next pass's frames load while the
// current ones are smoothed, their residual formed and restricted. Each
// sweep is recomputed on a region one cell wider than the next stage
// needs, so u1, u2 and the residual live only in shared memory; points
// outside the grid hold zero in every stage, which is the stencil's zero
// extension. Stage structure and summation order are the twin's. Bytes at
// 2048^2 x 16 (G = 16): coefficients 84 B x (35/32)^2 per point once, the
// field ~21 B per point per RHS: ~1.8 GB of device memory (0.54 ms at the
// card's rate). Measured ~1.27 ms on an H100 (PERF.md): the time an extra
// RHS adds is ~3.4x its byte share, and it hardly moved with the thread
// count, the RHS a pass, a 16 x 16 tile or the paired window (variants
// tried while building this one), so neither occupancy, barrier count nor
// shared-memory loads alone set it.

#include "zt_common.cuh"

#define K2_TC 16            // coarse outputs per tile side
#define K2_F (2 * K2_TC)    // fine points per tile side
#define K2_THREADS 640      // a thread for every vertical pair (35 x 18)
#define K2_RP 2             // RHS a pass: their stages share the barriers

template <int NSWEEPS>
struct K2Frame {
    static constexpr int L = NSWEEPS + 1;              // low-side halo
    static constexpr int S = K2_F + 2 * NSWEEPS + 1;   // frame side
    static constexpr int NF = S * S;
};

// One stencil stage (zt_common.cuh's stencil_pair) at a thread's vertical
// pair of region points, written to the frame out (the second point only
// when it lies in the region).
template <int NSWEEPS, bool SWEEP>
__device__ __forceinline__ void stage_pair(
        const float2* __restrict__ u, const float2* __restrict__ bs,
        float2* __restrict__ out, const float2 (&pc)[2][9],
        const float2 (&dc)[2], const float (&mc)[2], unsigned inc, int qi0,
        int qj, int prow) {
    constexpr int S = K2Frame<NSWEEPS>::S;
    const bool has2 = prow + 1 < S - 2;
    float2 v[2];
    stencil_pair<S, SWEEP>(u, bs, v, pc, dc, mc, inc, qi0, qj, has2);
    out[qi0 * S + qj] = v[0];
    if (has2) out[(qi0 + 1) * S + qj] = v[1];
}

template <int NSWEEPS>
__global__ void __launch_bounds__(K2_THREADS, 1)
zt_presmooth_restrict_kernel(const float2* __restrict__ planes,
                             const float2* __restrict__ D,
                             const float* __restrict__ mask,
                             const float2* __restrict__ b,
                             float2* __restrict__ u_out,
                             float2* __restrict__ rc,
                             int R, int nz, int nx, int G) {
    constexpr int L = K2Frame<NSWEEPS>::L;
    constexpr int S = K2Frame<NSWEEPS>::S;
    constexpr int NF = K2Frame<NSWEEPS>::NF;
    constexpr int RP = K2_RP;
    constexpr int C = S - 2;                  // stencil region [1, S-1)^2
    constexpr int PF = (NF + K2_THREADS - 1) / K2_THREADS;
    constexpr int NRB = (C + 1) / 2;          // vertical pairs a column
    static_assert(C * NRB <= K2_THREADS, "a thread for every pair");
    // the ring of b frames [2][RP][NF], then u1 [RP][NF] (the residual at
    // NSWEEPS = 2) and u2 [RP][NF] (the residual at NSWEEPS = 1)
    extern __shared__ float2 sm[];
    float2* ring = sm;
    float2* u1_s = sm + 2 * RP * NF;
    float2* u2_s = u1_s + RP * NF;
    float2* ul = NSWEEPS == 2 ? u2_s : u1_s;    // the last iterate
    float2* res_s = NSWEEPS == 2 ? u1_s : u2_s;

    const int tid = threadIdx.x;
    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const int I0 = blockIdx.y * K2_TC, J0 = blockIdx.x * K2_TC;
    const int zb = 2 * I0 - L, xb = 2 * J0 - L;   // frame origin (fine)
    const long long plane = (long long)nz * nx;
    const int r0 = blockIdx.z * G;
    const int nr = min(G, R - r0);
    const int npass = (nr + RP - 1) / RP;
    const float2 zero = make_float2(0.f, 0.f);

    // the frames of pass k (RHS r0 + RP k ..), zeros past the group
    auto issue = [&](int k) {
        float2* dst = ring + (k & 1) * RP * NF;
        for (int e = 0; e < RP; ++e) {
            const int r = RP * k + e;
            const float2* br = b + (r0 + r) * plane;
            for (int q = tid; q < NF; q += K2_THREADS) {
                const int z = zb + q / S, x = xb + q % S;
                const bool ok = r < nr && z >= 0 && z < nz && x >= 0
                                && x < nx;
                cp_async<8>(dst + e * NF + q,
                            ok ? br + (long long)z * nx + x : b, ok);
            }
        }
        cp_async_commit();
    };
    issue(0);   // in flight while the coefficients load

    // this thread's coefficients: D on its frame points (stage 0); the 9
    // planes, D and the mask on its points of the stencil region
    float2 d0[PF];
    unsigned in0 = 0u;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        const int q = tid + k * K2_THREADS;
        const int z = zb + q / S, x = xb + q % S;
        d0[k] = zero;
        if (q < NF && z >= 0 && z < nz && x >= 0 && x < nx) {
            in0 |= 1u << k;
            d0[k] = D[(long long)z * nx + x];
        }
    }
    // the stencil region by vertical pairs: thread t < C * NRB owns column
    // t % C, rows 2 (t / C) and 2 (t / C) + 1 of the region (two points
    // share the 4 x 3 window of their stencils)
    const int pcol = tid % C, prow = 2 * (tid / C);
    const bool pair_ok = tid < C * NRB;
    const int qi0 = 1 + prow, qj = 1 + pcol;    // the first point's frame cell
    float2 pc[2][9], dc[2];
    float mc[2];
    unsigned inc = 0u;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int z = zb + qi0 + k, x = xb + qj;
        dc[k] = zero;
        mc[k] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) pc[k][t] = zero;
        if (pair_ok && prow + k < C && z >= 0 && z < nz && x >= 0
            && x < nx) {
            inc |= 1u << k;
            const long long p = (long long)z * nx + x;
#pragma unroll
            for (int t = 0; t < 9; ++t) pc[k][t] = planes[t * plane + p];
            dc[k] = D[p];
            mc[k] = mask[p];
        }
    }
    // the frame ring of u2 is read (stage 2) but never written
    for (int q = tid; q < RP * NF; q += K2_THREADS) u2_s[q] = zero;

    const long long cplane = (long long)nzc * nxc;
    for (int k = 0; k < npass; ++k) {
        if (k + 1 < npass) {
            issue(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float2* bs = ring + (k & 1) * RP * NF;

        // stage 0: u1 = D b on the whole frame
#pragma unroll
        for (int j = 0; j < PF; ++j) {
            const int q = tid + j * K2_THREADS;
            if (q < NF) {
                const bool in = (in0 >> j) & 1u;
#pragma unroll
                for (int e = 0; e < RP; ++e)
                    u1_s[e * NF + q] = in ? cmul(d0[j], bs[e * NF + q]) : zero;
            }
        }
        __syncthreads();

        // stage 1 (NSWEEPS = 2): u2 = u1 + D (b - A u1) on [1, S-1)^2
        if (NSWEEPS == 2) {
            if (pair_ok) {
#pragma unroll
                for (int e = 0; e < RP; ++e)
                    stage_pair<NSWEEPS, true>(
                        u1_s + e * NF, bs + e * NF, u2_s + e * NF, pc, dc,
                        mc, inc, qi0, qj, prow);
            }
            __syncthreads();
        }

        // stage 2: res = mask (b - A u_last) on [1, S-1)^2 (the restriction
        // reads [NSWEEPS, S - NSWEEPS)^2; at NSWEEPS = 2 the outer ring of
        // the region reads u2's zero frame ring and is not used)
        if (pair_ok) {
#pragma unroll
            for (int e = 0; e < RP; ++e)
                stage_pair<NSWEEPS, false>(
                    ul + e * NF, bs + e * NF, res_s + e * NF, pc, dc, mc, inc,
                    qi0, qj, prow);
        }
        __syncthreads();

        for (int e = 0; e < RP; ++e) {
            const int r = r0 + RP * k + e;
            if (RP * k + e >= nr) break;
            const float2* rse = res_s + e * NF;
            // restriction: separable tent in z, then in x, then 1/4
            for (int q = tid; q < K2_TC * K2_TC; q += K2_THREADS) {
                const int I = I0 + q / K2_TC, J = J0 + q % K2_TC;
                if (I >= nzc || J >= nxc) continue;
                const int ci = (2 * I - zb) * S + 2 * J - xb;
                float2 t[3];
#pragma unroll
                for (int d = -1; d <= 1; ++d)
                    t[d + 1] = cadd(rse[ci + d],
                                    cscale(0.5f, cadd(rse[ci + S + d],
                                                      rse[ci - S + d])));
                const float2 v = cadd(t[1], cscale(0.5f, cadd(t[2], t[0])));
                rc[r * cplane + (long long)I * nxc + J] = cscale(0.25f, v);
            }
            // the smoothed iterate on the tile's own fine points
            float2* ur = u_out + r * plane;
            for (int q = tid; q < K2_F * K2_F; q += K2_THREADS) {
                const int qi = L + q / K2_F, qj = L + q % K2_F;
                const int z = zb + qi, x = xb + qj;
                if (z >= nz || x >= nx) continue;
                ur[(long long)z * nx + x] = ul[e * NF + qi * S + qj];
            }
        }
        // every read of this pass's frames and of u1/u2 is done before the
        // next frames land in this ring slot and stage 0 rewrites u1
        __syncthreads();
    }
}

template <int NSWEEPS>
static int launch_ps(const void* planes, const void* D, const void* mask,
                     const void* b, void* u, void* rc, int R, int nz,
                     int nx, int g, cudaStream_t s) {
    const int nzc = (nz + 1) / 2, nxc = (nx + 1) / 2;
    const int smem = (int)(4 * K2_RP * K2Frame<NSWEEPS>::NF
                           * sizeof(float2));
    static bool smem_set[ZT_MAX_DEVICES] = {};
    cudaError_t err = smem_limit_once(
        zt_presmooth_restrict_kernel<NSWEEPS>, smem, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(nxc, K2_TC), ceil_div(nzc, K2_TC),
                    ceil_div(R, g));
    zt_presmooth_restrict_kernel<NSWEEPS><<<grid, K2_THREADS, smem, s>>>(
        (const float2*)planes, (const float2*)D, (const float*)mask,
        (const float2*)b, (float2*)u, (float2*)rc, R, nz, nx, g);
    return (int)cudaGetLastError();
}

// g: RHS a block (cuda_kernels._ps_group)
ZT_EXPORT int zt_presmooth_restrict(const void* planes, const void* D,
                                    const void* mask, const void* b,
                                    void* u, void* rc, int R, int nz,
                                    int nx, int nsweeps, int g,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g < 1) return (int)cudaErrorInvalidValue;
    if (nsweeps == 2)
        return launch_ps<2>(planes, D, mask, b, u, rc, R, nz, nx, g, s);
    if (nsweeps == 1)
        return launch_ps<1>(planes, D, mask, b, u, rc, R, nz, nx, g, s);
    return (int)cudaErrorInvalidValue;
}
