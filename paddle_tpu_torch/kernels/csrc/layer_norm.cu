// LayerNorm over the last axis for Hopper (sm_90a), float or bf16 rows:
// the forward, the backward's dx with per-block partials of dw and db, and
// the fixed-order column sum of those partials.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/layer_norm.py:
//   * `_ln_fwd_impl` -> `_ln_fwd_kernel`: y = (x - mu) * rstd * w + b in
//     x's type, and the f32 mean and rstd of every row;
//   * `_ln_bwd_impl` -> `_ln_bwd_kernel`: dx = rstd * (dy*w - mean(dy*w)
//     - xhat * mean(dy*w*xhat)) in x's type, and the f32 column sums
//     dw = sum over rows of dy * xhat, db = sum over rows of dy.
//
// Layout: x, y, dx [N, C] contiguous and 16-byte aligned, C % 8 == 0
// (the wrapper checks); dy [N, C] in x's type or, beside bf16 x, in f32
// (the ln_matmul backward's f32 gradient of the normalised rows); w and b
// [C], float or bf16 (a flag each); mean and rstd [N] f32.
//
// What bounds them on the H100: a few flops an element against two (fwd)
// or three (bwd) element reads and writes, so device-memory bytes:
// 2*N*C*s + 8*N and 3*N*C*s + 8*N (s bytes an element) at 3.35 TB/s.  The
// design moves each element once: a warp owns a row, each lane reads its
// part with 16-byte loads and keeps it in registers (at most 8 vectors a
// lane: C <= 2048 in bf16, 1024 in f32), so the mean, the variance (two
// passes, as the reference) and the output come from one read.  w and b
// are re-read for every row with vector loads that hit L1: holding them in
// registers would cost a block of warps an SM, and the warps in flight are
// what keep enough bytes moving.
//
// dw and db cross rows.  The TPU summed them in scratch memory over a
// sequential grid; blocks here run in parallel and in no order, so the sum
// is two-stage and fixed: each warp accumulates its rows in registers, the
// block's 8 warps add theirs in warp order into one f32 partial row per
// block, and a second kernel sums each column's partials in block order.
// No atomics: the gradients repeat bitwise.  The number of blocks follows
// from N alone (not from the card), and with it the order of the sums.
// The ragged edge (N not a multiple of a block's rows, C not a multiple of
// a lane round) is masked here, not padded.
//
// Wider rows (any C % 8 == 0 past the register limit) take the `wide`
// kernels, with the same arithmetic in the same order per row:
//   * forward: a warp a row, three sweeps over it (sum; squared
//     deviations; output), the second and third re-reading the row, which
//     the first has just brought into L1/L2;
//   * backward: a block owns a run of rows as above.  First its warps
//     sweep each row for mean(dy*w) and mean(dy*w*xhat) (kept in an f32
//     [2, N] scratch); then the block's threads own columns, 16 bytes each,
//     and walk the block's rows in order: dx, and dw and db summed over
//     the rows in row order into the block's partial row.  x and dy are
//     read twice; no per-column state has to fit a lane's registers.
#include <type_traits>

#include "ln_common.cuh"

namespace {

using namespace paddle_ln;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNV = 8;            // 16-byte vectors a lane holds a row
constexpr int kMaxFwdBlocks = 2048;  // the forward's warps walk the rest
constexpr int kMaxBwdBlocks = 256;   // partial rows of dw and db at most

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
              int w_bf16, const void* __restrict__ b, int b_bf16,
              T* __restrict__ y, float* __restrict__ mu_out,
              float* __restrict__ rs_out, int N, int C, float eps) {
  constexpr int V = VecOf<T>::n;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < N;
       row += gridDim.x * kWarps) {
    const T* xr = x + (long long)row * C;
    float v[NV][V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) {
        load16(xr + c, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[j][e];
    }
    const float mu = warp_sum(s) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if ((lane + 32 * j) * V < C) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[j][e] -= mu;
          q += v[j][e] * v[j][e];
        }
      }
    }
    const float rs = rsqrtf(warp_sum(q) / (float)C + eps);
    T* yr = y + (long long)row * C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) {
        float o[V], wv[V], bv[V];
        load_params<V>(w, w_bf16, c, wv);
        load_params<V>(b, b_bf16, c, bv);
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = v[j][e] * rs * wv[e] + bv[e];
        store16(yr + c, o);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rs_out[row] = rs;
    }
  }
}

// Block b owns rows [b * rows_per_block, ...); part is [2, gridDim.x, C]:
// the dw partials, then the db partials.  Two blocks an SM (at most 128
// registers a thread), so the 256 blocks of a large N run in one wave.
template <typename T, typename TD, int NV>
__global__ void __launch_bounds__(kThreads, 2)
ln_bwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
              int w_bf16, const float* __restrict__ mu,
              const float* __restrict__ rs, const TD* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ part, int N, int C,
              int rows_per_block) {
  constexpr int V = VecOf<T>::n;
  constexpr int W = 32 * V;  // the columns of one lane round
  __shared__ float red[kWarps][W];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dwa[NV][V], dba[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dwa[j][e] = dba[j][e] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(N, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const float m = __ldg(mu + row), r = __ldg(rs + row);
    const long long off = (long long)row * C;
    float xh[NV][V], g[NV][V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      float xv[V], dv[V], wv[V];
      if (c < C) {
        load16(x + off + c, xv);
        load_vec<V>(dy + off + c, dv);
        load_params<V>(w, w_bf16, c, wv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[e] = dv[e] = wv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xh[j][e] = (xv[e] - m) * r;
        g[j][e] = dv[e] * wv[e];
        s1 += g[j][e];
        s2 += g[j][e] * xh[j][e];
        dwa[j][e] += dv[e] * xh[j][e];
        dba[j][e] += dv[e];
      }
    }
    const float m1 = warp_sum(s1) / (float)C;
    const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = r * (g[j][e] - m1 - xh[j][e] * m2);
        store16(dx + off + c, o);
      }
    }
  }
  // the block's partial row: the warps' sums added in warp order
  float* pw = part + (long long)blockIdx.x * C;
  float* pb = part + ((long long)gridDim.x + blockIdx.x) * C;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[warp][lane * V + e] = which ? dba[j][e] : dwa[j][e];
      __syncthreads();
      const int c = j * W + threadIdx.x;
      if (threadIdx.x < W && c < C) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) acc += red[k][threadIdx.x];
        (which ? pb : pw)[c] = acc;
      }
    }
  }
}

// The forward of rows wider than the registers hold: three sweeps a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_wide_kernel(const T* __restrict__ x, const void* __restrict__ w,
                   int w_bf16, const void* __restrict__ b, int b_bf16,
                   T* __restrict__ y, float* __restrict__ mu_out,
                   float* __restrict__ rs_out, int N, int C, float eps) {
  constexpr int V = VecOf<T>::n;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < N;
       row += gridDim.x * kWarps) {
    const T* xr = x + (long long)row * C;
    float s = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float f[V];
      load16(xr + c, f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += f[e];
    }
    const float mu = warp_sum(s) / (float)C;
    float q = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float f[V];
      load16(xr + c, f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = f[e] - mu;
        q += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(q) / (float)C + eps);
    T* yr = y + (long long)row * C;
    for (int c = lane * V; c < C; c += 32 * V) {
      float f[V], o[V], wv[V], bv[V];
      load16(xr + c, f);
      load_params<V>(w, w_bf16, c, wv);
      load_params<V>(b, b_bf16, c, bv);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (f[e] - mu) * rs * wv[e] + bv[e];
      store16(yr + c, o);
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rs_out[row] = rs;
    }
  }
}

// The backward of rows wider than the registers hold.  m12 [2, N] f32
// scratch: mean(dy*w) and mean(dy*w*xhat) of each row; part as
// ln_bwd_kernel's.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ln_bwd_wide_kernel(const T* __restrict__ x, const void* __restrict__ w,
                   int w_bf16, const float* __restrict__ mu,
                   const float* __restrict__ rs, const TD* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part,
                   float* m12, int N, int C, int rows_per_block) {
  constexpr int V = VecOf<T>::n;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(N, r0 + rows_per_block);
  for (int row = r0 + (threadIdx.x >> 5); row < r1; row += kWarps) {
    const float m = __ldg(mu + row), r = __ldg(rs + row);
    const long long off = (long long)row * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float xv[V], dv[V], wv[V];
      load16(x + off + c, xv);
      load_vec<V>(dy + off + c, dv);
      load_params<V>(w, w_bf16, c, wv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xv[e] - m) * r, g = dv[e] * wv[e];
        s1 += g;
        s2 += g * xh;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m12[row] = s1 / (float)C;
      m12[N + row] = s2 / (float)C;
    }
  }
  __syncthreads();
  float* pw = part + (long long)blockIdx.x * C;
  float* pb = part + ((long long)gridDim.x + blockIdx.x) * C;
  for (int c = threadIdx.x * V; c < C; c += kThreads * V) {
    float wv[V], dwa[V], dba[V];
    load_params<V>(w, w_bf16, c, wv);
#pragma unroll
    for (int e = 0; e < V; ++e) dwa[e] = dba[e] = 0.f;
    for (int row = r0; row < r1; ++row) {
      const float m = __ldg(mu + row), r = __ldg(rs + row);
      const float m1 = m12[row], m2 = m12[N + row];
      const long long off = (long long)row * C;
      float xv[V], dv[V], o[V];
      load16(x + off + c, xv);
      load_vec<V>(dy + off + c, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xv[e] - m) * r, g = dv[e] * wv[e];
        o[e] = r * (g - m1 - xh * m2);
        dwa[e] += dv[e] * xh;
        dba[e] += dv[e];
      }
      store16(dx + off + c, o);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      pw[c + e] = dwa[e];
      pb[c + e] = dba[e];
    }
  }
}

// The smallest instantiated vector count a lane needs to cover C (0: the
// row is wider than the registers hold).
template <typename T>
int vectors_for(int C) {
  const int need = (C + 32 * VecOf<T>::n - 1) / (32 * VecOf<T>::n);
  const int have[] = {1, 2, 3, 4, 6, 8};
  for (int nv : have)
    if (nv >= need) return nv;
  return 0;
}

// f(std::integral_constant<int, NV>) for the lane's vector count of C, or
// f(std::integral_constant<int, 0>) for the wide kernels.
template <typename T, typename F>
int by_vectors(int C, F f) {
  switch (vectors_for<T>(C)) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 6: return f(std::integral_constant<int, 6>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return f(std::integral_constant<int, 0>());
  }
}

template <typename T>
int run_fwd(const void* x, const void* w, int w_bf16, const void* b,
            int b_bf16, void* y, float* mu, float* rs, int N, int C,
            float eps, cudaStream_t s) {
  int grid = (N + kWarps - 1) / kWarps;
  if (grid > kMaxFwdBlocks) grid = kMaxFwdBlocks;
  return by_vectors<T>(C, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    if constexpr (NV == 0)
      ln_fwd_wide_kernel<T><<<grid, kThreads, 0, s>>>(
          (const T*)x, w, w_bf16, b, b_bf16, (T*)y, mu, rs, N, C, eps);
    else
      ln_fwd_kernel<T, NV><<<grid, kThreads, 0, s>>>(
          (const T*)x, w, w_bf16, b, b_bf16, (T*)y, mu, rs, N, C, eps);
    return (int)cudaGetLastError();
  });
}

template <typename T, typename TD>
int run_bwd(const void* x, const void* w, int w_bf16, const float* mu,
            const float* rs, const void* dy, void* dx, float* part,
            float* m12, int N, int C, int nblk, cudaStream_t s) {
  const int rows = (N + nblk - 1) / nblk;
  return by_vectors<T>(C, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    if constexpr (NV == 0) {
      if (!m12) return (int)cudaErrorInvalidValue;
      ln_bwd_wide_kernel<T, TD><<<nblk, kThreads, 0, s>>>(
          (const T*)x, w, w_bf16, mu, rs, (const TD*)dy, (T*)dx, part, m12,
          N, C, rows);
    } else {
      ln_bwd_kernel<T, TD, NV><<<nblk, kThreads, 0, s>>>(
          (const T*)x, w, w_bf16, mu, rs, (const TD*)dy, (T*)dx, part, N, C,
          rows);
    }
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// The widest row the register kernels hold (dtype 0 float, 1 bf16); wider
// rows take the wide kernels, whose backward needs the m12 scratch.
int paddle_layer_norm_max_c(int dtype) {
  return 32 * kMaxNV * (dtype == 1 ? 8 : 4);
}

// Blocks (and partial rows) of the backward for N rows: at least 8 rows a
// block, at most kMaxBwdBlocks blocks.
int paddle_layer_norm_bwd_blocks(int N) {
  int rows = (N + kMaxBwdBlocks - 1) / kMaxBwdBlocks;
  if (rows < kWarps) rows = kWarps;
  const int nblk = (N + rows - 1) / rows;
  return nblk > 0 ? nblk : 1;
}

// dtype, w_dtype, b_dtype: 0 float, 1 bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).
int paddle_layer_norm_fwd(const void* x, const void* w, const void* b,
                          void* y, float* mu, float* rs, int N, int C,
                          float eps, int dtype, int w_dtype, int b_dtype,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_fwd<float>(x, w, w_dtype, b, b_dtype, y, mu, rs, N, C, eps,
                          s);
  if (dtype == 1)
    return run_fwd<__nv_bfloat16>(x, w, w_dtype, b, b_dtype, y, mu, rs, N,
                                  C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// part: [2, nblk, C] f32 scratch, nblk from paddle_layer_norm_bwd_blocks;
// m12: [2, N] f32 scratch for C > paddle_layer_norm_max_c(dtype) (else
// unused).  dx in x's type (dtype); dy_dtype is dtype, or 0 (float) beside
// bf16 x.
int paddle_layer_norm_bwd(const void* x, const void* w, const float* mu,
                          const float* rs, const void* dy, void* dx,
                          float* part, float* m12, int N, int C, int nblk,
                          int dtype, int w_dtype, int dy_dtype,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || C <= 0 || C % 8 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && dy_dtype == 0)
    return run_bwd<float, float>(x, w, w_dtype, mu, rs, dy, dx, part, m12,
                                 N, C, nblk, s);
  if (dtype == 1 && dy_dtype == 1)
    return run_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, w_dtype, mu, rs, dy, dx, part, m12, N, C, nblk, s);
  if (dtype == 1 && dy_dtype == 0)
    return run_bwd<__nv_bfloat16, float>(x, w, w_dtype, mu, rs, dy, dx,
                                         part, m12, N, C, nblk, s);
  return (int)cudaErrorInvalidValue;
}

// dwb [2, C] f32: row 0 dw, row 1 db.
int paddle_layer_norm_bwd_reduce(const float* part, float* dwb, int nblk,
                                 int C, void* stream) {
  if (nblk <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((C + 31) / 32, 2);
  colsum2_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(part, dwb, nblk,
                                                         C);
  return (int)cudaGetLastError();
}

}  // extern "C"
