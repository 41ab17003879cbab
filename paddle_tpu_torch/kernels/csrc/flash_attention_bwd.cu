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
// order, so the card's gradients repeat run to run.  The dq kernel's
// recompute of s and dP (about 40% more flops than the algorithm's five
// products) is the price of that.
//
// float operands run the f32-FMA kernels described above (no TF32: the
// f32 paths hold 1e-4).  bf16 operands run wgmma + TMA kernels of the same
// split, 384 threads a block: warpgroup 2 produces (TMA loads into
// mbarrier-guarded two-stage rings of bf16 tiles), warpgroups 0 and 1
// consume 64 rows each with f32 accumulators in registers (setmaxnreg:
// 24 / 240 registers, 40 / 232 in dk/dv, whose producer lanes stage lse
// and delta).
//   dkv (`flash_bwd_dkv_bf16_kernel`): a block keeps a 128-row K/V tile
//     in shared memory and walks 64-row q tiles (q, dO by TMA; lse * log2
//     e and delta by the producer warp's lanes).  Per tile: S^T = K Q^T and
//     dP^T = V dO^T (shared x shared, both K-major), P^T = exp2(S^T - lse)
//     and dS^T = P^T (dP^T - delta) in registers, then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T as bf16 register A operands and the
//     same q / dO tiles read MN-major.
//   dq (`flash_bwd_dq_bf16_kernel`): a block keeps 128 q rows (q, dO) and
//     walks 64-key K/V tiles: S = Q K^T, dP = dO V^T, dS, dQ += dS K (K
//     read MN-major).
// Only tiles that cross the causal diagonal or the ragged edge are masked;
// tiles wholly masked for the block are skipped (for one warpgroup, not
// computed).  delta = rowsum(dO * O) comes from `flash_bwd_delta_kernel`
// (f32 sums of the operands, both types), launched before dk/dv.
//
// Layout: q, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D]; dO [B, Tq, H, D];
// each addressed through its own element strides with a unit-stride D, so
// q, k, v may be role views of one [B, T, nh, 3, hd] projection and dq,
// dk, dv role slices of one gradient buffer of that shape (what the
// fused TPU kernel writes as `fused_out`).  lse and delta = rowsum(dO * O)
// are [B*H, Tq] f32; delta comes from the delta kernel here (JAX computes
// it outside its kernel).  Gradients are written in the operand type.
//
// What bounds it on the H100: five tile products (s, dP, dv, dk in the
// dkv kernel; s, dP and dq again in the dq kernel) over D = 64, about
// 10*Tq*Tk*D/2 causal flops per head plus the dq kernel's recompute,
// against ~8 reads/writes of [T, D] per head: at T = 1024 operations bound
// it by two orders of magnitude.  The f32 version runs FMAs fed from
// shared memory (no tensor cores), 4 q rows x 4 key columns per thread,
// so the FMA pipe and shared-memory bandwidth are its roof; the bf16
// version runs on the tensor cores.
//
// Semantics kept from the TPU kernels: the scale folds into q (and into k
// for dq); the causal diagonal is shifted by offset = Tk - Tq (`:357`);
// masked scores are -1e30 before exp(s - lse).  The TPU pads lse with 1e30
// so that padded q rows give p = 0; here the kernels mask rows past Tq and
// keys past Tk themselves.  A masked score gives p = 0 in every kernel
// here, whatever the lse, so a causal row with no live key (i < Tq - Tk)
// adds nothing in them and gets dq = 0.  The reference's p on such a row
// follows its tiles (`DeadRule`, flash_common.cuh): 1 on the keys its q
// tile visits.  After dk/dv and dq, only when causal and Tq > Tk (never
// on the GPT path, Tq <= Tk), two small kernels add what those p give:
// `flash_dead_dq_kernel` writes the rows' dq and `flash_dead_dkv_kernel`
// adds their terms to dk and dv, in f32 from the operands.
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

// p = exp(s - lse) for one score; a masked key (exp(-1e30 - lse) on a row
// with live keys), rows past Tq and keys past Tk give 0.
__device__ __forceinline__ float recompute_p(float s, int row, int col,
                                             int Tq, int Tk, int causal,
                                             int offset, float lse_row) {
  if (row >= Tq || col >= Tk) return 0.f;
  if (causal && col > row + offset) return 0.f;
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
    case 16: return launch_bwd<T, 16>(which, a, B, s);
    case 32: return launch_bwd<T, 32>(which, a, B, s);
    case 64: return launch_bwd<T, 64>(which, a, B, s);
    case 128: return launch_bwd<T, 128>(which, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// -- delta = rowsum(dO * O) ----------------------------------------------------

// Rows are (b*h, t) in delta's order.  VEC: each lane reads 16 bytes of
// O and of dO, L = D * sizeof(T) / 16 lanes a row, 32 / L rows a warp
// (out and dO rows 16-byte aligned); otherwise one row a warp, one element
// a lane at a time.
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b);
template <>
__device__ __forceinline__ float dot16<float>(uint4 a, uint4 b) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* out, Strides so, const T* dout, Strides sdo,
                       float* delta, int B, int Tq, int H, int D) {
  const int lane = threadIdx.x & 31;
  const int L = VEC ? D * (int)sizeof(T) / 16 : 32;   // lanes a row
  const long long row = ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) *
                            (32 / L) + lane / L;
  const int sub = lane % L;
  const bool live = row < (long long)B * H * Tq;
  float acc = 0.f;
  if (live) {
    const int t = (int)(row % Tq), bh = (int)(row / Tq);
    const int b = bh / H, h = bh - (bh / H) * H;
    const T* o = head_ptr(out, so, b, h) + (long long)t * so.t;
    const T* g = head_ptr(dout, sdo, b, h) + (long long)t * sdo.t;
    if (VEC) {
      acc = dot16<T>(__ldg(reinterpret_cast<const uint4*>(o) + sub),
                     __ldg(reinterpret_cast<const uint4*>(g) + sub));
    } else {
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f32(__ldg(o + d)), to_f32(__ldg(g + d)), acc);
    }
  }
  for (int x = L / 2; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (live && sub == 0) delta[row] = acc;
}

template <typename T>
int launch_delta(const void* out, Strides so, const void* dout, Strides sdo,
                 float* delta, int B, int Tq, int H, int D, cudaStream_t s) {
  const long long rows = (long long)B * H * Tq;
  if (rows == 0) return 0;
  const int sz = (int)sizeof(T);
  auto a16 = [&](const void* p, Strides st) {
    return !((uintptr_t)p & 15) && st.b * sz % 16 == 0 &&
           st.t * sz % 16 == 0 && st.h * sz % 16 == 0;
  };
  const bool vec = D * sz % 16 == 0 && D * sz / 16 <= 32 && a16(out, so) &&
                   a16(dout, sdo);
  const long long per_block = vec ? 8LL * (32 / (D * sz / 16)) : 8LL;
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  if (vec)
    flash_bwd_delta_kernel<T, true><<<blocks, 256, 0, s>>>(
        (const T*)out, so, (const T*)dout, sdo, delta, B, Tq, H, D);
  else
    flash_bwd_delta_kernel<T, false><<<blocks, 256, 0, s>>>(
        (const T*)out, so, (const T*)dout, sdo, delta, B, Tq, H, D);
  return (int)cudaGetLastError();
}

// -- bf16: wgmma + TMA ---------------------------------------------------------

struct Bf16BwdArgs {
  Map q, k, v, dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16* g0;                    // dk (dkv kernel) or dq
  __nv_bfloat16* g1;                    // dv (dkv kernel)
  Strides s0, s1;
  int Tq, Tk, H;
  float scale, scale_log2;
  int causal;
};

// dkv: 128 K/V rows a block, 64-row q tiles; dq: 128 q rows, 64-key tiles
template <int D>
struct DkvTiles {
  static constexpr int BK = 128, BQ = 64, S = 2;
  static constexpr int KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  // q, dO, then lse and delta (2 x 256 bytes), padded so that every
  // stage's tiles stay 1024-byte aligned
  static constexpr int STAGE = 2 * Q_BYTES + 1024;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + S * STAGE + 8 * (1 + 2 * S);
};

template <int D>
struct DqTiles {
  static constexpr int BQ = 128, BK = 64, S = 2;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * S * KV_BYTES + 8 * (1 + 2 * S);
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_bf16_kernel(__grid_constant__ const Bf16BwdArgs a) {
  using namespace paddle_sm90;
  using G = DkvTiles<D>;
  using TL = Tile<D>;
  constexpr int BK = G::BK, BQ = G::BQ, S = G::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sm;
  uint8_t* sV = sK + G::KV_BYTES;
  uint8_t* ring = sV + G::KV_BYTES;     // S x {q, dO, lse, delta}
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + S * G::STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int k0 = blockIdx.y * BK;       // lowest keys (most q tiles) first
  const int Tq = a.Tq, Tk = a.Tk, offset = Tk - Tq;
  // causal: q rows below k0 - offset see none of this tile's keys
  const int q_begin = a.causal ? (max(0, k0 - offset) / BQ) * BQ : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + BQ - 1) / BQ : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);          // every producer lane
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                        // producer: warp 8
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x - 256;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * G::KV_BYTES);
        TL::template load<BK>(sK, &a.k.map, kv_full, a.k.pos, k0, h, b);
        TL::template load<BK>(sV, &a.v.map, kv_full, a.v.pos, k0, h, b);
      }
      const long long base = (long long)bh * Tq;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S, q0 = q_begin + it * BQ;
        uint8_t* st = ring + s * G::STAGE;
        float* sL = reinterpret_cast<float*>(st + 2 * G::Q_BYTES);
        float* sD = sL + BQ;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        // rows past Tq: lse = +1e30 gives p = 0, delta 0
        for (int i = lane; i < BQ; i += 32) {
          const int t = q0 + i;
          sL[i] = t < Tq ? a.lse[base + t] * kLog2e : 1e30f;
          sD[i] = t < Tq ? a.delta[base + t] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * G::Q_BYTES);
          TL::template load<BQ>(st, &a.q.map, &full[s], a.q.pos, q0, h, b);
          TL::template load<BQ>(st + G::Q_BYTES, &a.dout.map, &full[s],
                                a.dout.pos, q0, h, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {                              // consumers: 64 K/V rows each
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int first = k0 + wg * 64;
    const int kr0 = first + (tid >> 5) * 16 + (lane >> 2), kr1 = kr0 + 8;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_tile = smem_u32(sK), v_tile = smem_u32(sV);
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S, ph = (it / S) & 1, q0 = q_begin + it * BQ;
      if (a.causal && q0 + BQ - 1 + offset < first) {  // all masked here
        // The masked tiles are this warpgroup's first ones, so it waits on
        // the stage again later.  A wait tests the phase's parity only:
        // had this phase not completed, the stage's next wait (the other
        // parity) would pass at once and read the ring before its tiles
        // landed.  Waiting here keeps every consumer in step with the
        // phases.  (The forward and dq kernels skip trailing tiles only.)
        mbar_wait(&full[s], ph);
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      uint8_t* st = ring + s * G::STAGE;
      const float* sL = reinterpret_cast<const float*>(st + 2 * G::Q_BYTES);
      const float* sD = sL + BQ;
      const uint32_t q_tile = smem_u32(st), o_tile = q_tile + G::Q_BYTES;
      float sc[BQ / 2], dp[BQ / 2];
      mbar_wait(&full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(sc, TL::template kmajor<BK>(k_tile, wg * 64, kk),
                        TL::template kmajor<BQ>(q_tile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, TL::template kmajor<BK>(v_tile, wg * 64, kk),
                        TL::template kmajor<BQ>(o_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // element i: kv row (i & 2 ? kr1 : kr0), q column c = 8 (i / 4) +
      // 2 (lane % 4) + (i & 1) of the tile
      const bool whole = !a.causal || first + 63 <= q0 + offset;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        float p = exp2f(sc[i] * a.scale_log2 - sL[c]);
        if (!whole && ((i & 2) ? kr1 : kr0) > q0 + c + offset) p = 0.f;
        sc[i] = p;
        dp[i] = p * (dp[i] - sD[c]);
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
          da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D>(dv, pa[kk], TL::template mnmajor<BQ>(o_tile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D>(dk, da[kk], TL::template mnmajor<BQ>(q_tile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int n_valid = min(64, Tk - first);
    store_rows<D, BK>(dk, a.scale, sK, wg * 64,
                      head_ptr(a.g0, a.s0, b, h) + (long long)first * a.s0.t,
                      a.s0.t, n_valid, 1 + wg);
    store_rows<D, BK>(dv, 1.f, sV, wg * 64,
                      head_ptr(a.g1, a.s1, b, h) + (long long)first * a.s1.t,
                      a.s1.t, n_valid, 1 + wg);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_bf16_kernel(__grid_constant__ const Bf16BwdArgs a) {
  using namespace paddle_sm90;
  using G = DqTiles<D>;
  using TL = Tile<D>;
  constexpr int BQ = G::BQ, BK = G::BK, S = G::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = sm;
  uint8_t* sO = sQ + G::Q_BYTES;        // dO
  uint8_t* sK = sO + G::Q_BYTES;
  uint8_t* sV = sK + S * G::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + S * G::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int Tq = a.Tq, Tk = a.Tk, offset = Tk - Tq;
  const int kv_end = a.causal ? min(Tk, q0 + BQ + offset) : Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                        // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * G::Q_BYTES);
      TL::template load<BQ>(sQ, &a.q.map, q_full, a.q.pos, q0, h, b);
      TL::template load<BQ>(sO, &a.dout.map, q_full, a.dout.pos, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * G::KV_BYTES);
        TL::template load<BK>(sK + s * G::KV_BYTES, &a.k.map, &full[s],
                              a.k.pos, it * BK, h, b);
        TL::template load<BK>(sV + s * G::KV_BYTES, &a.v.map, &full[s],
                              a.v.pos, it * BK, h, b);
      }
    }
  } else {                              // consumers: 64 q rows each
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int first = q0 + wg * 64;
    const int r0 = first + (tid >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
    const long long base = (long long)bh * Tq;
    const float lse0 = r0 < Tq ? a.lse[base + r0] * kLog2e : 0.f;
    const float lse1 = r1 < Tq ? a.lse[base + r1] * kLog2e : 0.f;
    const float del0 = r0 < Tq ? a.delta[base + r0] : 0.f;
    const float del1 = r1 < Tq ? a.delta[base + r1] : 0.f;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t q_tile = smem_u32(sQ), o_tile = smem_u32(sO);
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S, ph = (it / S) & 1, k0 = it * BK;
      if (a.causal && k0 > first + 63 + offset) {   // no live key here
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_tile = smem_u32(sK + s * G::KV_BYTES);
      const uint32_t v_tile = smem_u32(sV + s * G::KV_BYTES);
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(&full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, TL::template kmajor<BQ>(q_tile, wg * 64, kk),
                        TL::template kmajor<BK>(k_tile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, TL::template kmajor<BQ>(o_tile, wg * 64, kk),
                        TL::template kmajor<BK>(v_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool whole = (!a.causal || k0 + BK - 1 <= first + offset) &&
                         k0 + BK <= Tk;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const bool hi = i & 2;
        float p = exp2f(sc[i] * a.scale_log2 - (hi ? lse1 : lse0));
        if (!whole) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (col >= Tk || (a.causal && col > (hi ? r1 : r0) + offset))
            p = 0.f;
        }
        dp[i] = p * (dp[i] - (hi ? del1 : del0));
      }
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(dq, da[kk], TL::template mnmajor<BK>(k_tile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows<D, BQ>(dq, a.scale, sQ, wg * 64,
                      head_ptr(a.g0, a.s0, b, h) + (long long)first * a.s0.t,
                      a.s0.t, min(64, Tq - first), 1 + wg);
  }
}

// The bf16 launch of one backward kernel (which: 0 dk/dv, 1 dq).
template <int D>
int launch_bwd_bf16(int which, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, const long long* st, int B,
                    int Tq, int Tk, int H, float scale, int causal,
                    cudaStream_t stream) {
  using namespace paddle_sm90;
  constexpr int W = Tile<D>::W, SWB = Tile<D>::SWB;
  const int q_rows = which == 0 ? DkvTiles<D>::BQ : DqTiles<D>::BQ;
  const int k_rows = which == 0 ? DkvTiles<D>::BK : DqTiles<D>::BK;
  Bf16BwdArgs a;
  int e;
  if ((e = encode_map(&a.q.map, &a.q.pos, q, st[0], st[1], st[2], B, Tq, H,
                      D, W, q_rows, SWB)) ||
      (e = encode_map(&a.k.map, &a.k.pos, k, st[3], st[4], st[5], B, Tk, H,
                      D, W, k_rows, SWB)) ||
      (e = encode_map(&a.v.map, &a.v.pos, v, st[6], st[7], st[8], B, Tk, H,
                      D, W, k_rows, SWB)) ||
      (e = encode_map(&a.dout.map, &a.dout.pos, dout, st[9], st[10], st[11],
                      B, Tq, H, D, W, q_rows, SWB)))
    return e;
  a.lse = lse;
  a.delta = delta;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  static int dkv_set = 0, dq_set = 0;
  if (which == 0) {
    if (!rows16(dk, st + 15) || !rows16(dv, st + 18))
      return (int)cudaErrorInvalidValue;
    a.g0 = (__nv_bfloat16*)dk;
    a.g1 = (__nv_bfloat16*)dv;
    a.s0 = {st[15], st[16], st[17]};
    a.s1 = {st[18], st[19], st[20]};
    constexpr int smem = DkvTiles<D>::SMEM;
    if ((e = opt_in_smem(flash_bwd_dkv_bf16_kernel<D>, smem, &dkv_set)))
      return e;
    dim3 grid(B * H, (Tk + k_rows - 1) / k_rows);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kWgThreads, smem, stream>>>(a);
  } else {
    if (!rows16(dq, st + 12)) return (int)cudaErrorInvalidValue;
    a.g0 = (__nv_bfloat16*)dq;
    a.g1 = nullptr;
    a.s0 = {st[12], st[13], st[14]};
    a.s1 = a.s0;
    constexpr int smem = DqTiles<D>::SMEM;
    if ((e = opt_in_smem(flash_bwd_dq_bf16_kernel<D>, smem, &dq_set)))
      return e;
    dim3 grid(B * H, (Tq + q_rows - 1) / q_rows);
    flash_bwd_dq_bf16_kernel<D><<<grid, kWgThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch_bwd_bf16(int which, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, const long long* st,
                      int B, int Tq, int Tk, int H, int D, float scale,
                      int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd_bf16<16>(which, q, k, v, dout, lse, delta, dq, dk, dv, st, B, Tq, Tk, H, scale, causal, s);
    case 32: return launch_bwd_bf16<32>(which, q, k, v, dout, lse, delta, dq, dk, dv, st, B, Tq, Tk, H, scale, causal, s);
    case 64: return launch_bwd_bf16<64>(which, q, k, v, dout, lse, delta, dq, dk, dv, st, B, Tq, Tk, H, scale, causal, s);
    case 128: return launch_bwd_bf16<128>(which, q, k, v, dout, lse, delta, dq, dk, dv, st, B, Tq, Tk, H, scale, causal, s);
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
  if (dtype == 1)                       // bf16: the wgmma + TMA kernels
    return dispatch_bwd_bf16(which, q, k, v, dout, lse, delta, dq, dk, dv,
                             strides, B, Tq, Tk, H, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// -- causal rows with no live key ----------------------------------------------

// dq of row i = blockIdx.x < Tq - Tk of head blockIdx.y: ds_c = dO_i . v_c -
// delta_i on the row's bwd_keys keys (p = 1), then dq_i = scale * sum_c
// ds_c k_c, a thread a column (D <= 128); written over the main kernels'
// zeros.  128 threads; keys in chunks of 256 (ds in shared memory).
template <typename T>
__global__ void __launch_bounds__(128)
flash_dead_dq_kernel(BwdArgs<T> a, int D) {
  __shared__ float s_do[128], s_ds[256];
  const DeadRule rule(a.Tq, a.Tk);
  const int i = blockIdx.x, bh = blockIdx.y, b = bh / a.H;
  const int h = bh - b * a.H;
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const int keys = rule.bwd_keys(i);
  const T* oi = head_ptr(a.dout, a.sdo, b, h) + (long long)i * a.sdo.t;
  s_do[j] = j < D ? to_f32(oi[j]) : 0.f;
  const float delta = a.delta[(long long)bh * a.Tq + i];
  const T* vb = head_ptr(a.v, a.sv, b, h);
  const T* kb = head_ptr(a.k, a.sk, b, h);
  __syncthreads();
  float acc = 0.f;
  for (int c0 = 0; c0 < keys; c0 += 256) {
    const int c1 = min(keys, c0 + 256);
    for (int c = c0 + warp; c < c1; c += 4) {
      float d = 0.f;
      for (int jj = lane; jj < D; jj += 32)
        d += s_do[jj] * to_f32(vb[(long long)c * a.sv.t + jj]);
      d = warp_sum(d);
      if (lane == 0) s_ds[c - c0] = d - delta;
    }
    __syncthreads();
    if (j < D)
      for (int c = c0; c < c1; ++c)
        acc += s_ds[c - c0] * to_f32(kb[(long long)c * a.sk.t + j]);
    __syncthreads();
  }
  if (j < D)
    head_ptr(a.dq, a.sdq, b, h)[(long long)i * a.sdq.t + j] =
        from_f32<T>(acc * a.scale);
}

// dk and dv of key c = blockIdx.x of head blockIdx.y: the terms of the rows
// i < Tq - Tk whose bwd_keys pass c: dv_c += dO_i, dk_c += scale * ds_ic q_i
// with ds_ic = dO_i . v_c - delta_i.  A warp takes every fourth row, a lane
// columns lane + 32 m; the four warps' sums are added in warp order, then
// to the main kernel's dk and dv.
template <typename T>
__global__ void __launch_bounds__(128)
flash_dead_dkv_kernel(BwdArgs<T> a, int D) {
  __shared__ float s_v[128], red[4][2][128];
  const DeadRule rule(a.Tq, a.Tk);
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H;
  const int h = bh - b * a.H, n_dead = a.Tq - a.Tk;
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const T* vc = head_ptr(a.v, a.sv, b, h) + (long long)c * a.sv.t;
  s_v[j] = j < D ? to_f32(vc[j]) : 0.f;
  __syncthreads();
  const T* qb = head_ptr(a.q, a.sq, b, h);
  const T* ob = head_ptr(a.dout, a.sdo, b, h);
  float ak[4] = {0.f, 0.f, 0.f, 0.f}, av[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = warp; i < n_dead; i += 4) {
    if (rule.bwd_keys(i) <= c) continue;
    const T* qi = qb + (long long)i * a.sq.t;
    const T* oi = ob + (long long)i * a.sdo.t;
    float dv[4], d = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = lane + 32 * m;
      dv[m] = jj < D ? to_f32(oi[jj]) : 0.f;
      d += dv[m] * s_v[jj];
    }
    const float ds = warp_sum(d) - a.delta[(long long)bh * a.Tq + i];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = lane + 32 * m;
      if (jj < D) {
        ak[m] += ds * to_f32(qi[jj]);
        av[m] += dv[m];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    red[warp][0][lane + 32 * m] = ak[m];
    red[warp][1][lane + 32 * m] = av[m];
  }
  __syncthreads();
  if (j < D) {
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sk += red[w][0][j];
      sv += red[w][1][j];
    }
    T* dk = head_ptr(a.dk, a.sdk, b, h) + (long long)c * a.sdk.t + j;
    T* dv = head_ptr(a.dv, a.sdv, b, h) + (long long)c * a.sdv.t + j;
    *dk = from_f32<T>(to_f32(*dk) + sk * a.scale);
    *dv = from_f32<T>(to_f32(*dv) + sv);
  }
}

template <typename T>
int launch_dead_bwd(const void* q, const void* k, const void* v,
                    const void* dout, const float* delta, void* dq, void* dk,
                    void* dv, const long long* st, int B, int Tq, int Tk,
                    int H, int D, float scale, cudaStream_t s) {
  if (D > 128 || Tq <= Tk) return (int)cudaErrorInvalidValue;
  BwdArgs<T> a = make_args<T>(q, k, v, dout, nullptr, delta, dq, dk, dv, st,
                              Tq, Tk, H, scale, 1);
  flash_dead_dq_kernel<T><<<dim3(Tq - Tk, B * H), 128, 0, s>>>(a, D);
  int e = (int)cudaGetLastError();
  if (e) return e;
  // the keys of the last dead row (the most: bwd_keys grows with the row)
  const int keys = DeadRule(Tq, Tk).bwd_keys(Tq - Tk - 1);
  if (keys > 0)
    flash_dead_dkv_kernel<T><<<dim3(keys, B * H), 128, 0, s>>>(a, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dk, dv of one backward.  strides: 21 element strides (batch, sequence,
// head) of q, k, v, dO, dq, dk, dv (dq's are read but unused).  dtype: 0
// float, 1 bfloat16 (every operand 16-byte aligned with strides multiples
// of 8 elements, or cudaErrorInvalidValue).  Returns cudaGetLastError()
// after the launch.
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

// delta = rowsum(dO * O) as f32 [B*H, Tq] (16-byte loads where the rows
// allow).  strides: 6
// element strides (batch, sequence, head) of out and dO.  dtype: 0 float,
// 1 bfloat16.  Returns cudaGetLastError() after the launch.
int paddle_flash_attention_bwd_delta(const void* out, const void* dout,
                                     float* delta, const long long* strides,
                                     int B, int Tq, int H, int D, int dtype,
                                     void* stream) {
  const Strides so = {strides[0], strides[1], strides[2]};
  const Strides sdo = {strides[3], strides[4], strides[5]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_delta<float>(out, so, dout, sdo, delta, B, Tq, H, D, s);
  if (dtype == 1)
    return launch_delta<__nv_bfloat16>(out, so, dout, sdo, delta, B, Tq, H,
                                       D, s);
  return (int)cudaErrorInvalidValue;
}

// The causal rows i < Tq - Tk (Tq > Tk) of a backward whose delta, dk/dv
// and dq kernels have run: dq of those rows written, their terms added to
// dk and dv.  strides and dtype as paddle_flash_attention_bwd_dkv.
int paddle_flash_attention_dead_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* delta, void* dq, void* dk,
                                    void* dv, const long long* strides, int B,
                                    int Tq, int Tk, int H, int D, float scale,
                                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dead_bwd<float>(q, k, v, dout, delta, dq, dk, dv, strides,
                                  B, Tq, Tk, H, D, scale, s);
  if (dtype == 1)
    return launch_dead_bwd<__nv_bfloat16>(q, k, v, dout, delta, dq, dk, dv,
                                          strides, B, Tq, Tk, H, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
