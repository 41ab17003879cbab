// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, the element types, strided
// operands and the f32 staging of a tile into shared memory.
//
// Every operand is addressed through element strides (batch, sequence,
// head) with a unit-stride head dimension, so q, k and v may be role
// views of one fused [B, T, nh, 3, hd] projection, and gradients may land
// in role slices of one fused buffer.  Offsets are 64-bit.  Inputs and
// outputs are float or __nv_bfloat16; everything a kernel sums is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paddle_flash {

constexpr int kB = 64;                  // rows of a q or k/v tile
constexpr int kThreads = 256;           // 16 x 16 threads, 4 x 4 rows each
constexpr float kNegInf = -1e30f;       // the TPU kernels' mask value

// Element strides of one [B, T, H, D] operand; D is unit-stride.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);           // round to nearest even
}

// Base pointer of head h of batch b.
template <typename T>
__device__ __forceinline__ T* head_ptr(T* p, Strides s, int b, int h) {
  return p + (long long)b * s.b + (long long)h * s.h;
}

// Stage rows [t0, t0 + kB) of two operands of one head into shared memory
// as f32 (row pitches `pa`, `pb`; operand a times `mul_a`); rows at or
// past `T_len` read as zeros.  One loop for both: the index arithmetic is
// shared, and the loads take the read-only path (`__ldg`).
template <typename T, int D>
__device__ __forceinline__ void stage_tiles(
    float* dst_a, int pa, const T* src_a, long long stride_a, float mul_a,
    float* dst_b, int pb, const T* src_b, long long stride_b, int t0,
    int T_len) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = t0 + r;
    const bool in = t < T_len;
    dst_a[r * pa + c] =
        in ? to_f32(__ldg(src_a + (long long)t * stride_a + c)) * mul_a : 0.f;
    dst_b[r * pb + c] =
        in ? to_f32(__ldg(src_b + (long long)t * stride_b + c)) : 0.f;
  }
}

// Ask for more than the 48 KB default of dynamic shared memory once per
// kernel instantiation.
template <typename K>
__host__ int opt_in_smem(K kernel, int bytes, int* done) {
  if (bytes > 48 * 1024 && *done < bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    *done = bytes;
  }
  return 0;
}

}  // namespace paddle_flash
