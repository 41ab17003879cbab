// Flash-attention backward for Hopper (sm_90a), float or bf16 operands.
//
// Replaces the Pallas TPU backward kernels of
// paddle_tpu/kernels/flash_attention.py:
//   * `_bwd_fused_kernel` (:239), the single-tile backward, launched by
//     `_flash_bwd` (:371) on separate q, k, v and by
//     `_flash_fused_bwd_impl` (:534) into one fused dqkv output;
//   * `_bwd_dq_kernel` (:275) and `_bwd_dkv_kernel` (:306), the FA2 split
//     that `_flash_bwd` (:402, :425) runs when a sequence outgrows a tile.
// The TPU's choice between them is a VMEM tiling choice; on Hopper one
// design serves every T: the FA2 split, as two kernels.
//
//   dkv kernel: one block per (b*h, 64-row K/V tile).  It stages its K and
//     V tiles in shared memory and loops over the q tiles from the causal
//     diagonal to the end.  For each it recomputes s = (q*scale) k^T with
//     the -1e30 mask, p = exp(s - lse), dP = dO v^T and ds = p (dP - delta),
//     and accumulates dv += p^T dO and dk += ds^T (q*scale) in registers.
//   dq kernel: one block per (b*h, 64-row q tile).  It loops over the K/V
//     tiles up to the diagonal, recomputes p and ds the same way and
//     accumulates dq += ds k, times scale at the end.
// No atomics: every gradient element is summed by one thread in a fixed
// order, so the card's gradients repeat run to run.
//
// Layout: q, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D]; dO [B, Tq, H, D];
// each addressed through its own element strides with a unit-stride D, so
// q, k, v may be role views of one [B, T, nh, 3, hd] projection and dq,
// dk, dv role slices of one gradient buffer of that shape (what the
// fused TPU kernel writes as `fused_out`).  lse and delta = rowsum(dO * O)
// are [B*H, Tq] f32; delta comes from one torch reduction, as JAX computes
// it outside its kernel.  Gradients are written in the operand type.
//
// What bounds it on the H100: five tile products (s, dP, dv, dk in the
// dkv kernel; s, dP and dq again in the dq kernel) over D = 64, about
// 10*Tq*Tk*D/2 causal flops per head plus the dq kernel's recompute,
// against ~8 reads/writes of [T, D] per head: at T = 1024 operations bound
// it by two orders of magnitude.  This version runs f32 FMAs fed from
// shared memory (no tensor cores), 4 q rows x 4 key columns per thread,
// so the FMA pipe and shared-memory bandwidth are its roof; wgmma/TMA
// tiles are later work (hopper-kernels guide, sections 1 and 4).
//
// Semantics kept from the TPU kernels: the scale folds into q (and into k
// for dq); the causal diagonal is shifted by offset = Tk - Tq (`:357`);
// masked scores are -1e30 before exp(s - lse).  The TPU pads lse with 1e30
// so that padded q rows give p = 0; here the kernels mask rows past Tq and
// keys past Tk themselves.  A causal q row with no live key (Tq > Tk) gets
// zero gradients, as the forward kernel gives it a zero output.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace paddle_flash;

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int Tq, Tk, H;
  float scale;
  int causal;
};

template <int D>
constexpr int dkv_smem_floats() {
  // sK, sV, sQ, sO [kB][D+1]; sP, sS [kB][kB+1]; lse, delta [kB]
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

template <int D>
constexpr int dq_smem_floats() {
  // sQ, sO, sK, sV [kB][D+1]; sS [kB][kB+1]; lse, delta [kB]
  return 4 * kB * (D + 1) + kB * (kB + 1) + 2 * kB;
}

// lse and delta of rows [q0, q0 + kB); rows past Tq read as 0.
__device__ __forceinline__ void stage_rows(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, long long base,
                                           int q0, int Tq) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const int t = q0 + i;
    sL[i] = t < Tq ? lse[base + t] : 0.f;
    sD[i] = t < Tq ? delta[base + t] : 0.f;
  }
}

// p = exp(s - lse) for one score, with the forward's mask: a masked key
// scores -1e30; rows past Tq and keys past Tk give 0.
__device__ __forceinline__ float recompute_p(float s, int row, int col,
                                             int Tq, int Tk, int causal,
                                             int offset, float lse_row) {
  if (row >= Tq || col >= Tk) return 0.f;
  if (causal && col > row + offset) s = kNegInf;
  return expf(s - lse_row);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(BwdArgs<T> a) {
  constexpr int DJ = D / 16;
  constexpr int QS = D + 1;
  constexpr int PS = kB + 1;
  extern __shared__ float smem[];
  float* sK = smem;                     // [kv][d]
  float* sV = sK + kB * QS;
  float* sQ = sV + kB * QS;             // q * scale, [q][d]
  float* sO = sQ + kB * QS;             // dO, [q][d]
  float* sP = sO + kB * QS;             // p, [kv][q]
  float* sS = sP + kB * PS;             // ds, [kv][q]
  float* sL = sS + kB * PS;
  float* sD = sL + kB;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;              // q columns tx + 16 j
  const int ty = tid >> 4;              // kv rows ty * 4 + i
  const int Tq = a.Tq, Tk = a.Tk;
  const int offset = Tk - Tq;
  const long long lbase = (long long)bh * Tq;
  const T* qb = head_ptr(a.q, a.sq, b, h);
  const T* ob = head_ptr(a.dout, a.sdo, b, h);

  stage_tiles<T, D>(sK, QS, head_ptr(a.k, a.sk, b, h), a.sk.t, 1.f, sV, QS,
                    head_ptr(a.v, a.sv, b, h), a.sv.t, k0, Tk);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: q rows below k0 - offset see none of this tile's keys, so the
  // loop starts at the q tile holding row k0 - offset
  int q_begin = 0;
  if (a.causal) q_begin = (max(0, k0 - offset) / kB) * kB;

  for (int q0 = q_begin; q0 < Tq; q0 += kB) {
    __syncthreads();                    // previous tile's readers are done
    stage_tiles<T, D>(sQ, QS, qb, a.sq.t, a.scale, sO, QS, ob, a.sdo.t, q0,
                      Tq);
    stage_rows(sL, sD, a.lse, a.delta, lbase, q0, Tq);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * QS + d];
        vv[i] = sV[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * QS + d];
        ov[j] = sO[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;      // q row within the tile
        const float p = recompute_p(s[i][j], q0 + r, k0 + ty * 4 + i, Tq, Tk,
                                    a.causal, offset, sL[r]);
        sP[(ty * 4 + i) * PS + r] = p;
        sS[(ty * 4 + i) * PS + r] = p * (dp[i][j] - sD[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty * 4 + i) * PS + qq];
        sv[i] = sS[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sO[qq * QS + tx + 16 * j];
        qv[j] = sQ[qq * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dkb = head_ptr(a.dk, a.sdk, b, h);
  T* dvb = head_ptr(a.dv, a.sdv, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long long)row * a.sdk.t + tx + 16 * j] = from_f32<T>(dk[i][j]);
      dvb[(long long)row * a.sdv.t + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(BwdArgs<T> a) {
  constexpr int DJ = D / 16;
  constexpr int QS = D + 1;
  constexpr int PS = kB + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                     // q * scale, [q][d]
  float* sO = sQ + kB * QS;             // dO, [q][d]
  float* sK = sO + kB * QS;             // [kv][d]
  float* sV = sK + kB * QS;
  float* sS = sV + kB * QS;             // ds, [q][kv]
  float* sL = sS + kB * PS;
  float* sD = sL + kB;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;              // kv columns tx + 16 j
  const int ty = tid >> 4;              // q rows ty * 4 + i
  const int Tq = a.Tq, Tk = a.Tk;
  const int offset = Tk - Tq;
  const T* kb = head_ptr(a.k, a.sk, b, h);
  const T* vb = head_ptr(a.v, a.sv, b, h);

  stage_tiles<T, D>(sQ, QS, head_ptr(a.q, a.sq, b, h), a.sq.t, a.scale, sO,
                    QS, head_ptr(a.dout, a.sdo, b, h), a.sdo.t, q0, Tq);
  stage_rows(sL, sD, a.lse, a.delta, (long long)bh * Tq, q0, Tq);

  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  // causal: key tiles strictly above the shifted diagonal hold no live
  // column for any row of this q tile
  int kv_end = Tk;
  if (a.causal) kv_end = min(Tk, q0 + kB + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();
    stage_tiles<T, D>(sK, QS, kb, a.sk.t, 1.f, sV, QS, vb, a.sv.t, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * QS + d];
        ov[i] = sO[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * QS + d];
        vv[j] = sV[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;         // q row within the tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = recompute_p(s[i][j], q0 + r, k0 + c, Tq, Tk,
                                    a.causal, offset, sL[r]);
        sS[r * PS + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[kk * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }

  T* dqb = head_ptr(a.dq, a.sdq, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(long long)row * a.sdq.t + tx + 16 * j] =
          from_f32<T>(dq[i][j] * a.scale);
  }
}

// strides: 21 element strides, (batch, sequence, head) of q, k, v, dO,
// dq, dk, dv.
template <typename T>
BwdArgs<T> make_args(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, const long long* st,
                     int Tq, int Tk, int H, float scale, int causal) {
  BwdArgs<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.dout = (const T*)dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = (T*)dq;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  Strides* dst[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *dst[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.scale = scale;
  a.causal = causal;
  return a;
}

template <typename T, int D>
int launch_bwd(int which, const BwdArgs<T>& a, int B, cudaStream_t stream) {
  static int dkv_set = 0, dq_set = 0;
  if (which == 0) {
    const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
    int e = opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem, &dkv_set);
    if (e) return e;
    dim3 grid((a.Tk + kB - 1) / kB, B * a.H);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    const int smem = dq_smem_floats<D>() * (int)sizeof(float);
    int e = opt_in_smem(flash_bwd_dq_kernel<T, D>, smem, &dq_set);
    if (e) return e;
    dim3 grid((a.Tq + kB - 1) / kB, B * a.H);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int which, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, const long long* st, int B,
                 int Tq, int Tk, int H, int D, float scale, int causal,
                 cudaStream_t s) {
  BwdArgs<T> a = make_args<T>(q, k, v, dout, lse, delta, dq, dk, dv, st, Tq,
                              Tk, H, scale, causal);
  switch (D) {
    case 32: return launch_bwd<T, 32>(which, a, B, s);
    case 64: return launch_bwd<T, 64>(which, a, B, s);
    case 128: return launch_bwd<T, 128>(which, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_entry(int which, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, void* dk, void* dv, const long long* strides, int B,
              int Tq, int Tk, int H, int D, float scale, int causal,
              int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_bwd<float>(which, q, k, v, dout, lse, delta, dq, dk, dv,
                               strides, B, Tq, Tk, H, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(which, q, k, v, dout, lse, delta, dq,
                                       dk, dv, strides, B, Tq, Tk, H, D,
                                       scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dk, dv of one backward.  strides: 21 element strides (batch, sequence,
// head) of q, k, v, dO, dq, dk, dv (dq's are read but unused).  dtype: 0
// float, 1 bfloat16.  Returns cudaGetLastError() after the launch.
int paddle_flash_attention_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int B, int Tq,
                                   int Tk, int H, int D, float scale,
                                   int causal, int dtype, void* stream) {
  return bwd_entry(0, q, k, v, dout, lse, delta, nullptr, dk, dv, strides,
                   B, Tq, Tk, H, D, scale, causal, dtype, stream);
}

// dq of one backward; the same strides (dk's and dv's unused).
int paddle_flash_attention_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, const long long* strides, int B,
                                  int Tq, int Tk, int H, int D, float scale,
                                  int causal, int dtype, void* stream) {
  return bwd_entry(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                   strides, B, Tq, Tk, H, D, scale, causal, dtype, stream);
}

}  // extern "C"
