// K3: the right-hand-side sweep of the stratified interior solve's
// parallel cyclic reduction (PCR), with precomputed bf16 factors.
//
//   for level = 0 .. L-1, s = 2^level (L: the levels with s < nz, at most
//   nsteps; a level with s >= nz passes b through):
//       b[z] <- b[z] + alpha_s[z] b[z-s] + gamma_s[z] b[z+s]
//              (zero fill outside 0 <= z < nz)
//   x = dinv b
//
// independently for every column (kx) of every right-hand side (RHS).
// b and x are (R, nz, nx) complex64; x is a separate tensor (the output
// race of the TPU kernel at odd level counts, fault F3, cannot occur).
// The factors come in the port's packed layout (stratified.
// pack_pcr_factors, built once per prepared operator): (nsteps + 1, nx, nz)
// words of 8 bytes, word [l][x][z] = the four bf16 parts (alpha re, alpha
// im, gamma re, gamma im) of level l at (z, x), and word [nsteps][x][z] =
// (dinv re, dinv im, 0, 0). bf16 upcasts exactly to float32; all
// arithmetic is float32 in the twin's order (b + alpha lo, then + gamma hi,
// then times dinv).
//
// Replaces zephyr_tpu/ops/pallas_pcr.py::pcr_sweep_pallas_rb (kernel body
// _pcr_kernel_rb) and its per-(column, RHS) variant pcr_sweep_pallas
// (_pcr_kernel).
//
// Bound on the card: bytes. Per launch the field moves 16 B per point per
// RHS through device memory and the factors 8 B per point per level. An
// earlier design (a strip of columns in ping-pong shared buffers) read the
// factors again for every RHS, as 2-byte loads from
// four planes (a quarter of each 32 B sector used at 4 columns a strip):
// ~24 GB of L2 traffic at nz = 2048 x 16 RHS, and its time on an H100 grew
// linearly in R (7.41 ms at R = 16, 0.52 at R = 1).
// Design:
// - A column's state lives in registers: a column of NZP = W * 32 * K
//   rows (W warps, K slots a lane; rows >= nz hold zero) gives lane t of
//   warp w rows z = w * 32K + 32 j + t, j < K. Each thread applies a
//   level's factor word to the same rows of G RHS, so one factor load
//   feeds G RHS (G = 4 at nz <= 256, 2 above, 1 past nz = 12,800's shared
//   budget; the wrapper, cuda_kernels._pcr_plan, chooses K, W, G).
// - Levels with s < 32 exchange neighbours by __shfl_sync inside the warp
//   (a rotation of each slot, carried from the slot below or above); the
//   carries across warps of one column go through shared memory between
//   two named barriers of that column's warps only (bar.sync id, 32 W).
//   Levels with s >= 32 reach beyond the warp's span: the column's state
//   goes to its shared region and each row reads z - s and z + s back.
// - A factor word is read coalesced: lanes read 32 consecutive z of one
//   column, 256 contiguous bytes. The next level's word of slot j is
//   requested as soon as slot j of this level is done, so a whole level
//   of arithmetic covers its latency; after the last level the slots hold
//   dinv.
// - Field I/O: a block owns CB = 4 adjacent columns (a 32 B sector of each
//   row) of G RHS; rows are staged into shared memory by cp.async with
//   zero fill, read in column ownership, and written back the same way.
// Expected traffic at nz = 2048, 2048 columns, R = 16, G = 2: L2 -> SM
// 8 RHS groups x 11 levels x 33.5 MB = 2.9 GB of factor words, device
// memory ~1.1 GB of field plus ~0.4 GB of factors (the RHS groups of a
// column run together, blockIdx.x fastest, so L2 serves the repeats).
// Measured on an H100 (PERF.md): 0.36 ms at nz = 1024, 0.54 at the 8-panel
// width, 1.58 at nz = 2048 (R = 16); each RHS group still costs about one
// pass over the factors, and one 512-thread block an SM (128 registers a
// thread; ptxas spills a few words at K = 16, G = 2) runs its staging,
// shuffles and shared-memory levels one after another. Keeping the
// in-thread slot shifts in registers (chained, in place) spilled heavily
// at G = 2 and lost; more RHS a thread (G = 4) needs narrower blocks and
// lost on field sectors.

#include "zt_common.cuh"

#define K3_LMAX 14   // levels with s < 16384 (the largest column)

__device__ __forceinline__ float2 bf16x2_to_c(unsigned int w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
    return make_float2(__shfl_sync(0xffffffffu, v.x, src),
                       __shfl_sync(0xffffffffu, v.y, src));
}

__device__ __forceinline__ float2 pcr_update(float2 v, uint2 f, float2 lo,
                                             float2 hi) {
    v = cadd(v, cmul(bf16x2_to_c(f.x), lo));
    return cadd(v, cmul(bf16x2_to_c(f.y), hi));
}

template <int K, int G, int MAXT>
__global__ void __launch_bounds__(MAXT)
zt_pcr_sweep_kernel(const uint2* __restrict__ fac,
                    const float2* __restrict__ b, float2* __restrict__ out,
                    int R, int nz, int nx, int nsteps, int L, int W,
                    int CB) {
    constexpr int Z = 32 * K;
    // one warp a column below K = 4, so every level that runs has s < 32 K
    constexpr int LMAX = K >= 4 ? K3_LMAX : 5 + (K == 2);
    extern __shared__ float2 sm[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = warp / W, w = warp % W;
    const int NZP = W * Z;
    const int x0 = blockIdx.y * CB, x = x0 + c;
    const int r0 = blockIdx.x * G;
    const long long plane = (long long)nz * nx;
    const long long fl = (long long)nx * nz;
    float2* xb = sm + (long long)c * G * NZP;   // this column: [g][z]
    const float2 zero = make_float2(0.f, 0.f);

    // stage the field: rows z < NZP of the CB columns of G RHS, the
    // column index fastest (each row's CB values are contiguous)
    for (int g = 0; g < G; ++g) {
        const int r = r0 + g;
        for (int e = threadIdx.x; e < NZP * CB; e += blockDim.x) {
            const int z = e / CB, cc = e % CB, xx = x0 + cc;
            const bool ok = r < R && z < nz && xx < nx;
            cp_async<8>(sm + ((long long)cc * G + g) * NZP + z,
                        ok ? b + r * plane + (long long)z * nx + xx : b, ok);
        }
    }
    cp_async_commit();

    // the first level's factor words (dinv's when no level runs)
    const bool colok = x < nx;
    const uint2* fcol = fac + (long long)x * nz;
    const int z0 = w * Z + lane;
    uint2 f[K];
    {
        const long long off = (long long)(L > 0 ? 0 : nsteps) * fl;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int z = z0 + 32 * j;
            f[j] = colok && z < nz ? fcol[off + z] : make_uint2(0u, 0u);
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    float2 v[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < K; ++j) v[g][j] = xb[g * NZP + z0 + 32 * j];

    const int bar_id = 1 + c, bar_n = 32 * W;
#pragma unroll
    for (int lvl = 0; lvl < LMAX; ++lvl) {
        if (lvl >= L) break;
        const int s = 1 << lvl;
        const long long noff = (long long)(lvl + 1 < L ? lvl + 1 : nsteps)
                               * fl;
        if (s < 32) {
            // neighbours by warp rotation; carries across warps
            float2 clo[G], chi[G];
#pragma unroll
            for (int g = 0; g < G; ++g) clo[g] = chi[g] = zero;
            if (W > 1) {
                named_bar(bar_id, bar_n);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    xb[g * NZP + w * Z + 32 * (K - 1) + lane] =
                        shfl2(v[g][K - 1], (lane - s) & 31);
                    xb[g * NZP + w * Z + lane] =
                        shfl2(v[g][0], (lane + s) & 31);
                }
                named_bar(bar_id, bar_n);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    if (w > 0)
                        clo[g] = xb[g * NZP + (w - 1) * Z + 32 * (K - 1)
                                    + lane];
                    if (w < W - 1)
                        chi[g] = xb[g * NZP + (w + 1) * Z + lane];
                }
            }
            float2 upp[G], dn[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                upp[g] = clo[g];
                dn[g] = shfl2(v[g][0], (lane + s) & 31);
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float2 up = shfl2(v[g][j], (lane - s) & 31);
                    const float2 dnn = j + 1 < K
                        ? shfl2(v[g][j + 1], (lane + s) & 31) : chi[g];
                    const float2 lo = lane >= s ? up : upp[g];
                    const float2 hi = lane + s < 32 ? dn[g] : dnn;
                    v[g][j] = pcr_update(v[g][j], f[j], lo, hi);
                    upp[g] = up;
                    dn[g] = dnn;
                }
                const int z = z0 + 32 * j;
                f[j] = colok && z < nz ? fcol[noff + z] : make_uint2(0u, 0u);
            }
        } else {
            // beyond the warp's span: through the column's shared region
            if (W > 1) named_bar(bar_id, bar_n); else __syncwarp();
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int j = 0; j < K; ++j) xb[g * NZP + z0 + 32 * j] = v[g][j];
            if (W > 1) named_bar(bar_id, bar_n); else __syncwarp();
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int z = z0 + 32 * j;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float2 lo = z >= s ? xb[g * NZP + z - s] : zero;
                    const float2 hi = z + s < NZP ? xb[g * NZP + z + s] : zero;
                    v[g][j] = pcr_update(v[g][j], f[j], lo, hi);
                }
                f[j] = colok && z < nz ? fcol[noff + z] : make_uint2(0u, 0u);
            }
        }
    }

    // x = dinv b (the slots now hold dinv's words), staged back to rows
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < K; ++j)
            xb[g * NZP + z0 + 32 * j] = cmul(v[g][j], bf16x2_to_c(f[j].x));
    __syncthreads();
    for (int g = 0; g < G; ++g) {
        const int r = r0 + g;
        if (r >= R) break;
        for (int e = threadIdx.x; e < nz * CB; e += blockDim.x) {
            const int z = e / CB, cc = e % CB, xx = x0 + cc;
            if (xx < nx)
                out[r * plane + (long long)z * nx + xx] =
                    sm[((long long)cc * G + g) * NZP + z];
        }
    }
}

template <int K, int G, int MAXT>
static int launch_pcr(const void* fac, const void* b, void* out, int R,
                      int nz, int nx, int nsteps, int L, int W, int CB,
                      cudaStream_t stream) {
    const int NZP = W * 32 * K;
    const int threads = CB * W * 32;
    const int smem = (int)((long long)CB * G * NZP * sizeof(float2));
    if (threads > MAXT) return (int)cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        zt_pcr_sweep_kernel<K, G, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(R, G), ceil_div(nx, CB));
    zt_pcr_sweep_kernel<K, G, MAXT><<<grid, threads, smem, stream>>>(
        (const uint2*)fac, (const float2*)b, (float2*)out, R, nz, nx,
        nsteps, L, W, CB);
    return (int)cudaGetLastError();
}

// k, g, w, cb: the plan of cuda_kernels._pcr_plan (slots a lane, RHS a
// thread, warps a column, columns a block); levels: the levels that run.
ZT_EXPORT int zt_pcr_sweep(const void* fac, const void* b, void* out, int R,
                           int nz, int nx, int nsteps, int levels, int k,
                           int g, int w, int cb, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (w > 1 && k < 4) return (int)cudaErrorInvalidValue;
#define K3_CASE(KK, GG, MT)                                                 \
    if (k == KK && g == GG && cb * w * 32 <= MT)                            \
        return launch_pcr<KK, GG, MT>(fac, b, out, R, nz, nx, nsteps,       \
                                      levels, w, cb, s);
    K3_CASE(1, 1, 512) K3_CASE(1, 2, 512) K3_CASE(1, 4, 512)
    K3_CASE(2, 1, 512) K3_CASE(2, 2, 512) K3_CASE(2, 4, 512)
    K3_CASE(4, 1, 512) K3_CASE(4, 2, 512) K3_CASE(4, 4, 512)
    K3_CASE(8, 1, 512) K3_CASE(8, 2, 512) K3_CASE(8, 4, 512)
    K3_CASE(16, 1, 512) K3_CASE(16, 2, 512) K3_CASE(16, 1, 1024)
#undef K3_CASE
    return (int)cudaErrorInvalidValue;
}
