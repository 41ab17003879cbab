// Paged decode attention for Hopper (sm_90a): the serving decode read.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/paged_attention.py
// `paged_decode_attention` -> `_decode_kernel`.
//
// Operands: q [B, W, H, D] f32; k_pages/v_pages [NP, P, H, D] f32 or int8
// with k_scale/v_scale [NP, P] f32 (int8 only); page_table [B, n_pt] i32;
// lengths [B] i32 (row b's new positions are start .. start+W-1, already
// written to the pools).  Output [B, W, H, D] f32.
//
// Design: one block of 256 threads (8 warps) per (row b, head h).  The
// block loads its own row's page ids into shared memory (clamped to
// [0, NP-1]: sentinel entries >= NP read the last real page, as the TPU
// kernel's `jnp.minimum(pt, NP - 1)` does, and the mask excludes them).
// Only positions p < start + W can be attended by any query of the row,
// so only those are read: pages past the live span are skipped (the TPU
// kernel's `i*P < start + W` guard) and bytes scale with resident tokens.
//   pass 1 (K): a warp takes one position at a time, lanes split D, and
//     the int8 value is dequantized right after its load (q_i8 * scale);
//     the masked scaled score (col <= start + row, else -1e30) lands in
//     a [W, n_pt*P] f32 scores array in shared memory.
//   softmax: the WHOLE row, in f32, max then exp then divide by the sum
//     — deliberately not an online rescale, so the probabilities match
//     the plain gather-then-softmax read (greedy argmax parity).
//   pass 2 (V): probs @ V with the same warp-per-position split; each warp
//     keeps partial sums in registers, reduced across warps at the end.
// Parked rows (start >= n_pt*P: idle slots whose table is all sentinel)
// read nothing and write zeros; the engine never reads their output.
//
// What bounds it on the H100: bytes.  Each live position costs 2*H*D
// pool elements (K and V) for 4*W*D flops per head, about 0.5 flop/byte
// at W=1 f32, far under the ridge; int8 pools stream a quarter of the f32
// bytes.  The design streams each resident K and V byte once, with four
// positions' loads in flight per warp to cover device-memory latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 8;
constexpr int kUnroll = 4;              // positions in flight per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int W, int H, int P, int n_pt, int NP, float scale) {
  constexpr int DC = D / 32;            // elements of D per lane
  constexpr bool kQuant = sizeof(T) == 1;
  const int virt = n_pt * P;
  extern __shared__ float smem[];
  float* sS = smem;                     // [W][virt] scores, then probs
  float* sQ = sS + W * virt;            // [W][D]
  float* sAcc = sQ + W * D;             // [kWarps][W][D]
  int* sPT = reinterpret_cast<int*>(sAcc + kWarps * W * D);   // [n_pt]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long hd = (long)H * D;
  float* ob = out + (long)b * W * hd + (long)h * D;
  const int start = lengths[b];

  if (start >= virt) {                  // parked row: read nothing
    for (int i = tid; i < W * D; i += kThreads) ob[(i / D) * hd + i % D] = 0.f;
    return;
  }
  for (int i = tid; i < W * D; i += kThreads)
    sQ[i] = q[((long)b * W + i / D) * hd + (long)h * D + i % D];
  for (int i = tid; i < n_pt; i += kThreads)
    sPT[i] = min(max(page_table[(long)b * n_pt + i], 0), NP - 1);
  __syncthreads();

  const int live = min(virt, start + W);

  // pass 1: scores over the live positions
  for (int p0 = warp * kUnroll; p0 < live; p0 += kWarps * kUnroll) {
    float kv[kUnroll][DC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
      if (p < live) {
        const int pid = sPT[p / P], off = p % P;
        const T* kr = k_pages + ((long)pid * P + off) * hd + (long)h * D;
        const float ks = kQuant ? k_scale[(long)pid * P + off] : 1.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) kv[u][c] = (float)kr[lane + 32 * c] * ks;
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c) kv[u][c] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) {
        if (w >= W) break;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) part = fmaf(sQ[w * D + lane + 32 * c], kv[u][c], part);
        part = warp_sum(part);
        if (lane == 0 && p < live)
          sS[w * virt + p] = (p <= start + w) ? part * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // whole-row softmax; positions >= live would hold -1e30 and contribute
  // exp(-1e30 - max) == 0 exactly, so the row is reduced over [0, live)
  for (int w = warp; w < W; w += kWarps) {
    float* row = sS + w * virt;
    float mx = kNegInf;
    for (int p = lane; p < live; p += 32) mx = fmaxf(mx, row[p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < live; p += 32) {
      const float e = expf(row[p] - mx);
      row[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int p = lane; p < live; p += 32) row[p] = row[p] / sum;
  }
  __syncthreads();

  // pass 2: probs @ V
  float acc[kMaxW][DC];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[w][c] = 0.f;
  for (int p0 = warp * kUnroll; p0 < live; p0 += kWarps * kUnroll) {
    float vv[kUnroll][DC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
      if (p < live) {
        const int pid = sPT[p / P], off = p % P;
        const T* vr = v_pages + ((long)pid * P + off) * hd + (long)h * D;
        const float vs = kQuant ? v_scale[(long)pid * P + off] : 1.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[u][c] = (float)vr[lane + 32 * c] * vs;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
      if (p >= live) break;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) {
        if (w >= W) break;
        const float pr = sS[w * virt + p];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[w][c] = fmaf(pr, vv[u][c], acc[w][c]);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    if (w >= W) break;
#pragma unroll
    for (int c = 0; c < DC; ++c) sAcc[(warp * W + w) * D + lane + 32 * c] = acc[w][c];
  }
  __syncthreads();
  for (int i = tid; i < W * D; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += sAcc[wp * W * D + i];
    ob[(i / D) * hd + i % D] = s;
  }
}

int paged_smem_bytes(int W, int D, int P, int n_pt) {
  return (W * n_pt * P + W * D + kWarps * W * D) * (int)sizeof(float) +
         n_pt * (int)sizeof(int);
}

template <typename T, int D>
int launch_paged(const float* q, const void* k_pages, const void* v_pages,
                 const float* k_scale, const float* v_scale,
                 const int* page_table, const int* lengths, float* out, int B,
                 int W, int H, int P, int n_pt, int NP, float scale,
                 cudaStream_t stream) {
  const int smem = paged_smem_bytes(W, D, P, n_pt);
  static int smem_set = 0;              // opt-in above the 48 KB default
  if (smem > 48 * 1024 && smem_set < smem) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(H, B);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      k_scale, v_scale, page_table, lengths, out, W, H, P, n_pt, NP, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const float* q, const void* kp, const void* vp,
               const float* ks, const float* vs, const int* pt,
               const int* len, float* out, int B, int W, int H, int D, int P,
               int n_pt, int NP, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_paged<T, 32>(q, kp, vp, ks, vs, pt, len, out, B, W, H, P, n_pt, NP, scale, s);
    case 64: return launch_paged<T, 64>(q, kp, vp, ks, vs, pt, len, out, B, W, H, P, n_pt, NP, scale, s);
    case 128: return launch_paged<T, 128>(q, kp, vp, ks, vs, pt, len, out, B, W, H, P, n_pt, NP, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int paddle_paged_attention_max_w() { return kMaxW; }

// Shared-memory bytes one block requests for these shapes.
int paddle_paged_attention_smem_bytes(int W, int D, int P, int n_pt) {
  return paged_smem_bytes(W, D, P, n_pt);
}

// Returns cudaGetLastError() after the launch (0 on success).
int paddle_paged_decode_attention(const float* q, const void* k_pages,
                                  const void* v_pages, const float* k_scale,
                                  const float* v_scale, const int* page_table,
                                  const int* lengths, float* out, int B, int W,
                                  int H, int D, int P, int n_pt, int NP,
                                  float scale, int quant, void* stream) {
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (quant)
    return dispatch_d<int8_t>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                              lengths, out, B, W, H, D, P, n_pt, NP, scale, s);
  return dispatch_d<float>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           lengths, out, B, W, H, D, P, n_pt, NP, scale, s);
}

}  // extern "C"
