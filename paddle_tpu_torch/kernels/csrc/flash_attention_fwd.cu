// Flash-attention forward for Hopper (sm_90a), float or bf16 operands.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py
//   * `_flash_fwd` -> `_fwd_kernel` (separate q, k, v; reached through
//     `flash_attention_bthd`), and
//   * `_flash_fused_fwd_impl` (the same kernel body over one fused
//     [BH, 3, T, D] operand through role-selecting index maps; reached
//     through `flash_attention_qkv_fused`).
// One kernel serves both: q, k, v and out are addressed through element
// strides (batch, sequence, head), so the three role views of one
// [B, T, nh, 3, hd] projection are read in place, with no copy.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H, D], out [B, Tq, H, D], each with
// its own strides and a unit-stride D; lse [B*H, Tq] f32 contiguous (the
// wrapper views it as [B*H, Tq, 1]).  Inputs and out are float or bf16;
// the staged tiles, the softmax state, the accumulator and lse are f32.
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
// about 4*Tq*Tk*D flops against 4*B*T*H*D elements, so prompts of a few
// hundred tokens are above the ridge: operations bound it.  Without wgmma
// the f32 FMA pipe is the roof, and this version feeds it from shared
// memory (8 shared loads per 16 FMAs in the score loop), so shared-memory
// bandwidth is what it actually hits.  wgmma/TMA tiles are later work.
//
// Semantics kept from the TPU kernel:
//   * the scale folds into q once, as it is staged (`_scaled_scores`);
//   * the causal diagonal is shifted by offset = Tk - Tq (`_flash_fwd`);
//   * masked scores are -1e30, not -inf (`_NEG_INF`);
//   * l is clamped at 1e-30 before the divide and the log;
//   * lse = m + log(l) is written for the backward.
//   The ragged edge (T not a tile multiple) is masked here, not padded.
//   A causal q tile with no live key at all (Tq > Tk) writes zeros.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace paddle_flash;

template <typename T>
struct FwdArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* lse;
  Strides sq, sk, sv, so;
  int Tq, Tk, H;
  float scale;
  int causal;
};

template <int D>
constexpr int fwd_smem_floats() {
  // sQ [kB][D+1], sK [kB][D+1], sV [kB][D], sP [kB][kB+1]
  return kB * (D + 1) + kB * (D + 1) + kB * D + kB * (kB + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(FwdArgs<T> a) {
  constexpr int DJ = D / 16;            // output columns per thread
  constexpr int QS = D + 1;             // padded row pitch (bank spread)
  constexpr int PS = kB + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kB * QS;
  float* sV = sK + kB * QS;
  float* sP = sV + kB * D;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int Tq = a.Tq, Tk = a.Tk;
  const int offset = Tk - Tq;
  const T* qb = head_ptr(a.q, a.sq, b, h);
  const T* kb = head_ptr(a.k, a.sk, b, h);
  const T* vb = head_ptr(a.v, a.sv, b, h);

  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = q0 + r;
    sQ[r * QS + c] =
        t < Tq ? to_f32(__ldg(qb + (long long)t * a.sq.t + c)) * a.scale : 0.f;
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
  if (a.causal) kv_end = min(Tk, q0 + kB + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();                    // previous tile's readers are done
    stage_tiles<T, D>(sK, QS, kb, a.sk.t, 1.f, sV, D, vb, a.sv.t, k0, Tk);
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
        const bool ok = col < Tk && (!a.causal || col <= row + offset);
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
    for (int kk = 0; kk < kB; ++kk) {
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

  T* ob = head_ptr(a.out, a.so, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)row * a.so.t + tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
    if (tx == 0) a.lse[(long long)bh * Tq + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const long long* st, int B, int Tq, int Tk, int H,
               float scale, int causal, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  static int smem_set = 0;
  int e = opt_in_smem(flash_fwd_kernel<T, D>, smem, &smem_set);
  if (e) return e;
  FwdArgs<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.out = (T*)out;
  a.lse = lse;
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  a.so = {st[9], st[10], st[11]};
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.scale = scale;
  a.causal = causal;
  dim3 grid((Tq + kB - 1) / kB, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* q, const void* k, const void* v, void* out,
                 float* lse, const long long* st, int B, int Tq, int Tk,
                 int H, int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch_fwd<T, 32>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
    case 64: return launch_fwd<T, 64>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
    case 128: return launch_fwd<T, 128>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block requests for head size D (0: unsupported).
int paddle_flash_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return fwd_smem_floats<32>() * (int)sizeof(float);
    case 64: return fwd_smem_floats<64>() * (int)sizeof(float);
    case 128: return fwd_smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}

// strides: 12 element strides, (batch, sequence, head) of q, k, v, out.
// dtype: 0 float, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
int paddle_flash_attention_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse,
                               const long long* strides, int B, int Tq,
                               int Tk, int H, int D, float scale, int causal,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_fwd<float>(q, k, v, out, lse, strides, B, Tq, Tk, H, D,
                               scale, causal, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(q, k, v, out, lse, strides, B, Tq,
                                       Tk, H, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
