// Shared helpers of the zephyr_tpu_torch CUDA kernels.
//
// Complex fields are complex64 tensors read in place as float2 (re, im);
// every kernel exports a plain C launcher that takes raw device pointers
// and a cudaStream_t, launches on that stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ZT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cscale(float s, float2 a) {
    return make_float2(s * a.x, s * a.y);
}

// Stencil plane k = (dz + 1) * 3 + (dx + 1), as zephyr_tpu's OFFSETS.
__device__ __forceinline__ int off_dz(int k) { return k / 3 - 1; }
__device__ __forceinline__ int off_dx(int k) { return k % 3 - 1; }

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
    return (a + b - 1) / b;
}

#define ZT_MAX_DEVICES 64

// Let kernel take `bytes` of dynamic shared memory (above the default 48
// KB), once a device: cudaFuncSetAttribute costs the host microseconds, as
// much as a small level's whole launch. `done` holds the flags, one a
// device, of one kernel at one size (a function-local static of its
// launcher).
template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel kernel, int bytes,
                                   bool (&done)[ZT_MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool keep = dev >= 0 && dev < ZT_MAX_DEVICES;
    if (keep && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && keep) done[dev] = true;
    return err;
}

// Asynchronous global -> shared copies (Ampere's cp.async, on Hopper too):
// BYTES (4 or 8) bytes from src to dst, or zeros when ok is false (the
// source size is then 0 and src is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? BYTES : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a barrier of the n threads (a multiple of 32) that name barrier id
// (1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_bar(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One stencil stage of the scalar kernels at a thread's vertical pair of
// cells (qi0, qj) and (qi0 + 1, qj) of a shared frame of side S (the
// second only when has2): SWEEP: v = u + D (b - A u) (a damped-Jacobi
// sweep), else v = mask (b - A u) (the residual). The 4 x 3 window of u
// is read once for both points; each point sums its 9 products in the
// order of the plain twin (stencil.apply_stencil). Points outside the
// grid (their bit of inc clear) get zero, the stencil's zero extension.
template <int S, bool SWEEP>
__device__ __forceinline__ void stencil_pair(
        const float2* __restrict__ u, const float2* __restrict__ bs,
        float2 (&v)[2], const float2 (&pc)[2][9], const float2 (&dc)[2],
        const float (&mc)[2], unsigned inc, int qi0, int qj, bool has2) {
    const float2 zero = make_float2(0.f, 0.f);
    float2 w[4][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            w[r][c] = r < 3 || has2 ? u[(qi0 - 1 + r) * S + qj - 1 + c]
                                    : zero;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        v[p] = zero;
        if ((inc >> p) & 1u) {
            float2 au = zero;
#pragma unroll
            for (int t = 0; t < 9; ++t)
                au = cadd(au, cmul(pc[p][t],
                                   w[p + 1 + off_dz(t)][1 + off_dx(t)]));
            const float2 bv = bs[(qi0 + p) * S + qj];
            v[p] = SWEEP ? cadd(w[p + 1][1], cmul(dc[p], csub(bv, au)))
                         : cscale(mc[p], csub(bv, au));
        }
    }
}
