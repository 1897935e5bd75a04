// K3: the right-hand-side sweep of the stratified interior solve's
// parallel cyclic reduction (PCR), with precomputed bf16 factors.
//
//   for level = 0 .. nsteps-1, s = 2^level:
//       b[z] <- b[z] + alpha_s[z] b[z-s] + gamma_s[z] b[z+s]
//              (zero fill outside 0 <= z < nz; a level with s >= nz
//               passes b through)
//   x = dinv b
//
// independently for every column (kx) of every right-hand side.
// alphas, gammas (nsteps, 2, nz, nx) and dinv (2, nz, nx) are bfloat16
// re/im planes, upcast exactly to float32; b and x (R, nz, nx) complex64;
// all arithmetic in float32.
//
// Replaces zephyr_tpu/ops/pallas_pcr.py::pcr_sweep_pallas_rb (kernel body
// _pcr_kernel_rb) and its per-(column, RHS) variant pcr_sweep_pallas
// (_pcr_kernel).
//
// Bound on the card: device-memory bytes and latency. The field is read
// and written once per launch; the factors are 8 bytes per point per level
// (nsteps = 10 at nz = 1024, so one pass over them outweighs the field
// stream of a few RHS), and every level waits on the previous one.
// Design: a block owns a strip of TX columns over the full depth nz of one
// RHS, held in shared memory across ALL levels (the level recurrence
// couples rows up to nz/2 apart, so no smaller tile is closed). Each level
// reads a ping buffer and writes a pong buffer, with a block-wide barrier
// between levels; the result goes from the last buffer to the separate
// output tensor, never back over a buffer still being read (the output
// race of the TPU kernel at odd level counts cannot occur). TX is the
// widest power of two <= 32 whose two buffers fit in 200 KB of shared
// memory (TX = 8 at nz = 1024). The shared memory allows one block per
// SM, so a block runs 1024 threads to keep enough loads in flight; the
// RHS is the fastest grid index, so the R blocks of a strip run together
// and read its factors from device memory about once (L2 hits after).

#include "zt_common.cuh"

#define K3_THREADS 1024

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
    return __uint_as_float(((unsigned int)h) << 16);
}

__device__ __forceinline__ float2 load_bf16_pair(
        const uint16_t* __restrict__ p, long long plane, long long idx) {
    return make_float2(bf16_to_f32(p[idx]), bf16_to_f32(p[plane + idx]));
}

__global__ void __launch_bounds__(K3_THREADS)
zt_pcr_sweep_kernel(const uint16_t* __restrict__ alphas,
                    const uint16_t* __restrict__ gammas,
                    const uint16_t* __restrict__ dinv,
                    const float2* __restrict__ b,
                    float2* __restrict__ out,
                    int nz, int nx, int nsteps, int TX) {
    extern __shared__ float2 smem[];
    float2* src = smem;
    float2* dst = smem + (long long)nz * TX;

    const int x0 = blockIdx.y * TX;
    const int r = blockIdx.x;
    const long long plane = (long long)nz * nx;
    const int n = nz * TX;
    const float2* br = b + r * plane;

    for (int e = threadIdx.x; e < n; e += K3_THREADS) {
        const int z = e / TX, x = x0 + e % TX;
        src[e] = x < nx ? br[(long long)z * nx + x] : make_float2(0.f, 0.f);
    }
    __syncthreads();

    for (int lvl = 0; lvl < nsteps; ++lvl) {
        const int s = 1 << lvl;
        if (s >= nz) continue;   // pass-through level
        const uint16_t* al = alphas + (long long)lvl * 2 * plane;
        const uint16_t* ga = gammas + (long long)lvl * 2 * plane;
        for (int e = threadIdx.x; e < n; e += K3_THREADS) {
            const int z = e / TX, x = x0 + e % TX;
            float2 v = src[e];
            if (x < nx) {
                const long long idx = (long long)z * nx + x;
                if (z >= s)
                    v = cadd(v, cmul(load_bf16_pair(al, plane, idx),
                                     src[e - s * TX]));
                if (z + s < nz)
                    v = cadd(v, cmul(load_bf16_pair(ga, plane, idx),
                                     src[e + s * TX]));
            }
            dst[e] = v;
        }
        __syncthreads();
        float2* t = src;
        src = dst;
        dst = t;
    }

    float2* orow = out + r * plane;
    for (int e = threadIdx.x; e < n; e += K3_THREADS) {
        const int z = e / TX, x = x0 + e % TX;
        if (x >= nx) continue;
        const long long idx = (long long)z * nx + x;
        orow[idx] = cmul(src[e], load_bf16_pair(dinv, plane, idx));
    }
}

// tx: the strip width, chosen by the wrapper (cuda_kernels._pcr_tx) so
// that the two buffers, 2 * nz * tx * 8 bytes, fit in shared memory.
ZT_EXPORT int zt_pcr_sweep(const void* alphas, const void* gammas,
                           const void* dinv, const void* b, void* out, int R,
                           int nz, int nx, int nsteps, int tx,
                           void* stream) {
    const int smem = (int)(2LL * nz * tx * sizeof(float2));
    cudaError_t err = cudaFuncSetAttribute(
        zt_pcr_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(R, ceil_div(nx, tx));
    zt_pcr_sweep_kernel<<<grid, K3_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint16_t*)alphas, (const uint16_t*)gammas,
        (const uint16_t*)dinv, (const float2*)b, (float2*)out, nz, nx,
        nsteps, tx);
    return (int)cudaGetLastError();
}
