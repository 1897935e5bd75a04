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
