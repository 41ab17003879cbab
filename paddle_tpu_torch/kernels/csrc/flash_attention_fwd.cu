// Flash-attention forward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/flash_attention.py
// `_flash_fwd` -> `_fwd_kernel`, reached through `flash_attention_bthd`.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H, D], out like q, lse [B*H, Tq]
// (the wrapper views it as [B*H, Tq, 1]), all f32 and contiguous.  The
// kernel reads the [B, T, H, D] layout through strides, so the wrapper
// makes no transposed copies.
//
// Design: one block of 256 threads per (b*h, 64-row q tile).  The block
// keeps its scaled Q tile in shared memory and loops over 64-row K/V
// tiles staged in shared memory, carrying the online-softmax state
// (running max m, running sum l, output accumulator) in registers.  A
// thread owns 4 q rows x 4 key columns of each score tile and 4 q rows x
// D/16 output columns; row reductions are shuffles over the 16 lanes that
// share those rows.  Sums are plain f32 FMAs (no tensor cores, no TF32).
//
// What bounds it on the H100: at GPT head sizes (D = 64) the work is
// about 4*Tq*Tk*D flops against 4*B*T*H*D*4 bytes, so prompts of a few
// hundred tokens are above the f32 ridge (67 TFLOP/s over 3.35 TB/s,
// ~20 flop/byte): operations bound it.  Without wgmma the f32 FMA pipe is
// the roof, and this first version feeds it from shared memory (8 shared
// loads per 16 FMAs in the score loop), so shared-memory bandwidth is
// what it actually hits.  wgmma/TMA tiles are later work.
//
// Semantics kept from the TPU kernel:
//   * the scale folds into q once, as it is staged (`_scaled_scores`);
//   * the causal diagonal is shifted by offset = Tk - Tq (`_flash_fwd`);
//   * masked scores are -1e30, not -inf (`_NEG_INF`);
//   * l is clamped at 1e-30 before the divide and the log;
//   * lse = m + log(l) is written for the backward of a later port.
//   The ragged edge (T not a tile multiple) is masked here, not padded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int flash_smem_floats() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1]
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int H,
                 float scale, int causal) {
  constexpr int DJ = D / 16;            // output columns per thread
  constexpr int QS = D + 1;             // padded row strides (bank spread)
  constexpr int PS = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * D;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int offset = Tk - Tq;
  const long rs = (long)H * D;          // stride between sequence positions
  const float* qb = q + (long)b * Tq * rs + (long)h * D;
  const float* kb = k + (long)b * Tk * rs + (long)h * D;
  const float* vb = v + (long)b * Tk * rs + (long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = q0 + r;
    sQ[r * QS + c] = t < Tq ? qb[(long)t * rs + c] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: key tiles strictly above the shifted diagonal of this q tile
  // hold no live column for any of its rows, so the loop stops before them
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, q0 + kBQ + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - (i / D) * D;
      const int t = k0 + r;
      const bool in = t < Tk;
      sK[r * QS + c] = in ? kb[(long)t * rs + c] : 0.f;
      sV[r * D + c] = in ? vb[(long)t * rs + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Tk && (!causal || col <= row + offset);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + (long)b * Tq * rs + (long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(long)row * rs + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0) lse[(long)bh * Tq + row] = m[i] + logf(lc);
  }
}

template <int D>
int launch_flash(const float* q, const float* k, const float* v, float* out,
                 float* lse, int B, int Tq, int Tk, int H, float scale,
                 int causal, cudaStream_t stream) {
  const int smem = flash_smem_floats<D>() * (int)sizeof(float);
  static int smem_set = 0;              // opt-in above the 48 KB default
  if (smem > 48 * 1024 && smem_set < smem) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block requests for head size D (0: unsupported).
int paddle_flash_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return flash_smem_floats<32>() * (int)sizeof(float);
    case 64: return flash_smem_floats<64>() * (int)sizeof(float);
    case 128: return flash_smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}

// Returns cudaGetLastError() after the launch (0 on success).
int paddle_flash_attention_fwd(const float* q, const float* k, const float* v,
                               float* out, float* lse, int B, int Tq, int Tk,
                               int H, int D, float scale, int causal,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_flash<32>(q, k, v, out, lse, B, Tq, Tk, H, scale, causal, s);
    case 64: return launch_flash<64>(q, k, v, out, lse, B, Tq, Tk, H, scale, causal, s);
    case 128: return launch_flash<128>(q, k, v, out, lse, B, Tq, Tk, H, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
