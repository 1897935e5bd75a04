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
