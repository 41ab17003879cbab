// Shared pieces of the LayerNorm and conv + batch-norm kernels
// (layer_norm.cu, ln_matmul.cu, conv_bn.cu): 16-byte row loads and stores
// of float or bf16 as f32, parameters of either type, warp sums, the f32
// row statistics of the reference and the fixed-order column sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paddle_ln {

// Elements of T in one 16-byte vector.
template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  static constexpr int n = 4;
};
template <>
struct VecOf<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // nearest even
  return v;
}

// 16 bytes at p (16-byte aligned), read-only path, as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}

// V elements (V a multiple of 4) from p as f32: float4 loads, or one 16-
// or 8-byte load of bf16 (p aligned to the load).  For a row of another
// type than the one that sets the lane's vector width.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
#pragma unroll
  for (int v = 0; v < V; v += 4) load16(p + v, f + v);
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  if constexpr (V == 8) {
    load16(p, f);
  } else {
    static_assert(V == 4, "bf16 vectors of 4 or 8");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

// Element i of a float (bf16 == 0) or bf16 parameter vector, as f32.
__device__ __forceinline__ float param_at(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : __ldg(static_cast<const float*>(p) + i);
}

// V parameters from column c (c % V == 0) of a float (bf16 == 0) or bf16
// vector, as f32, with 16- or 8-byte loads (the vector is 16-byte aligned).
template <int V>
__device__ __forceinline__ void load_params(const void* p, int bf16, int c,
                                            float* f) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + c;
    if constexpr (V == 8) {
      load16(q, f);
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    }
  } else {
    const float* q = static_cast<const float*>(p) + c;
#pragma unroll
    for (int v = 0; v < V; v += 4) load16(q + v, f + v);
  }
}

// Butterfly sum over the warp: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and rstd of rows [row0, row0 + rows) of x (row stride ldx, K
// columns, K % VecOf<T>::n == 0), as the reference computes them: f32,
// mean = sum / K, var = sum((x - mean)^2) / K, rstd = rsqrt(var + eps).
// A warp takes R rows at a time, so R rows' loads and shuffle sums are in
// flight together (one row at a time leaves the warp waiting on latency);
// the second pass re-reads rows the first has just brought into L1.  Rows
// at or past N get 0 and 0.
template <typename T, int R = 4>
__device__ void row_stats(const T* __restrict__ x, long long ldx, int row0,
                          int rows, int N, int K, float eps, float* s_mu,
                          float* s_rs) {
  constexpr int V = VecOf<T>::n;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = (threadIdx.x >> 5) * R; r < rows; r += nwarps * R) {
    const T* xr[R];
    bool live[R];
    float s[R], mu[R], q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      live[i] = r + i < rows && row0 + r + i < N;
      xr[i] = x + (long long)(row0 + r + i) * ldx;
      s[i] = q[i] = 0.f;
    }
    for (int c = lane * V; c < K; c += 32 * V) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!live[i]) continue;
        float f[V];
        load16(xr[i] + c, f);
#pragma unroll
        for (int e = 0; e < V; ++e) s[i] += f[e];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) mu[i] = warp_sum(s[i]) / (float)K;
    for (int c = lane * V; c < K; c += 32 * V) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!live[i]) continue;
        float f[V];
        load16(xr[i] + c, f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = f[e] - mu[i];
          q[i] += d * d;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float rs = rsqrtf(warp_sum(q[i]) / (float)K + eps);
      if (lane == 0 && r + i < rows) {
        s_mu[r + i] = live[i] ? mu[i] : 0.f;
        s_rs[r + i] = live[i] ? rs : 0.f;
      }
    }
  }
}

// out [2, C] = the column sums of part [2, nblk, C], each column's
// partials added in block order (8 strided runs, then the 8 run sums): the
// second stage of the fixed-order sums of layer_norm.cu (dw, db) and
// conv_bn.cu (the batch-norm statistics).  Launch with 256 threads and a
// grid of (ceil(C / 32), 2).  Static: each source that includes this
// header keeps its own copy, so their objects link together.
static __global__ void __launch_bounds__(256)
colsum2_kernel(const float* __restrict__ part, float* __restrict__ out,
               int nblk, int C) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const float* p = part + (long long)blockIdx.y * nblk * C;
  float acc = 0.f;
  if (c < C)
    for (int i = ty; i < nblk; i += 8) acc += __ldg(p + (long long)i * C + c);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k][tx];
    out[(long long)blockIdx.y * C + c] = s;
  }
}

}  // namespace paddle_ln
