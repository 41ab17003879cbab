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
// Two designs, chosen by the operand type.
//
// float (f32 FMAs, no TF32, so the f32 paths hold 1e-4 against their plain
// versions): one block of 256 threads per (b*h, 64-row q tile).  The block
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
// bandwidth is what it actually hits.
//
// bf16 (tensor cores, `flash_fwd_bf16_kernel`): one block of 384 threads
// per (b*h, 128-row q tile), the longest causal tiles launched first.
// Warpgroup 2 is the producer: one thread issues TMA loads of the Q tile
// and of 128-key (64 for D = 128) K and V tiles into a two-stage ring of
// bf16 tiles guarded by mbarriers (full: bytes landed; empty: both
// consumers done).  Warpgroups 0 and 1 own 64 q rows each: S = Q K^T by
// wgmma from shared memory (both K-major), the online softmax on the f32
// accumulator registers (row reductions over the 4 lanes of a quad, exp2
// with log2(e) folded into the scale), P rounded to bf16 in registers and
// fed back as wgmma's A operand for O += P V (V read MN-major from the same
// tile layout).  Only tiles that cross the causal diagonal or the ragged
// edge are masked; tiles wholly above the diagonal are never loaded (for
// a warpgroup whose rows they miss, not computed).  setmaxnreg gives the
// consumers 240 registers and the producer 24.  The epilogue stages O
// through the warpgroup's own Q rows for 16-byte stores.  Operations bound
// it (~4*T^2*D/2 causal flops against 8*T*D bytes a head).
//
// Semantics kept from the TPU kernel:
//   * the scale folds into q once, as it is staged (`_scaled_scores`);
//     the bf16 kernel applies it to the f32 scores instead (folding it
//     into a bf16 q would round it once more);
//   * the causal diagonal is shifted by offset = Tk - Tq (`_flash_fwd`);
//   * masked scores are -1e30, not -inf (`_NEG_INF`);
//   * l is clamped at 1e-30 before the divide and the log;
//   * lse = m + log(l) is written for the backward.
//   The ragged edge (T not a tile multiple) is masked here, not padded.
//   A causal q tile with no live key at all (Tq > Tk) writes zeros; in
//   the bf16 kernel every row with no live key does, whatever its tile.
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


// -- bf16: wgmma + TMA ---------------------------------------------------------

struct Bf16FwdArgs {
  Map q, k, v;
  __nv_bfloat16* out;
  float* lse;
  Strides so;
  int Tq, Tk, H;
  float scale_log2;                     // scale * log2(e)
  int causal;
};

template <int D>
struct FwdTiles {
  static constexpr int BM = 128, BN = D <= 64 ? 128 : 64, S = 2;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  // 1024 bytes of alignment slack, Q, the K and V rings, 1 + 3 S barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * S * KV_BYTES + 8 * (1 + 3 * S);
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_bf16_kernel(__grid_constant__ const Bf16FwdArgs a) {
  using namespace paddle_sm90;
  using G = FwdTiles<D>;
  using TL = Tile<D>;
  constexpr int BM = G::BM, BN = G::BN, S = G::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = sm;
  uint8_t* sK = sQ + G::Q_BYTES;
  uint8_t* sV = sK + S * G::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + S * G::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // longest tiles first
  const int Tq = a.Tq, Tk = a.Tk, offset = Tk - Tq;
  const int kv_end = a.causal ? min(Tk, q0 + BM + offset) : Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                        // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      TL::template load<BM>(sQ, &a.q.map, q_full, a.q.pos, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], G::KV_BYTES);
        TL::template load<BN>(sK + s * G::KV_BYTES, &a.k.map, &k_full[s],
                              a.k.pos, it * BN, h, b);
        mbar_expect_tx(&v_full[s], G::KV_BYTES);
        TL::template load<BN>(sV + s * G::KV_BYTES, &a.v.map, &v_full[s],
                              a.v.pos, it * BN, h, b);
      }
    }
  } else {                              // consumers: 64 q rows each
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int row_in = (tid >> 5) * 16 + (lane >> 2);
    const int first = q0 + wg * 64;     // this warpgroup's rows
    const int r0 = first + row_in, r1 = r0 + 8;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const float neg = kNegInf * kLog2e;  // the mask value, log2 units
    float m0 = neg, m1 = neg, l0 = 0.f, l1 = 0.f;
    const uint32_t q_tile = smem_u32(sQ);
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S, ph = (it / S) & 1, k0 = it * BN;
      if (a.causal && k0 > first + 63 + offset) {   // no live key here
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      float sc[BN / 2];
      mbar_wait(&k_full[s], ph);
      const uint32_t k_tile = smem_u32(sK + s * G::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, TL::template kmajor<BM>(q_tile, wg * 64, kk),
                        TL::template kmajor<BN>(k_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool whole = (!a.causal || k0 + BN - 1 <= first + offset) &&
                         k0 + BN <= Tk;
      float mx0 = neg, mx1 = neg;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float t = sc[i] * a.scale_log2;
        if (!whole) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (col >= Tk || (a.causal && col > row + offset)) t = neg;
        }
        sc[i] = t;
        if (i & 2) mx1 = fmaxf(mx1, t);
        else mx0 = fmaxf(mx0, t);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row with no live key yet keeps p = 0 (exp2 of the mask value)
      const float ref0 = n0 == neg ? 0.f : n0, ref1 = n1 == neg ? 0.f : n1;
      const float al0 = exp2f(m0 - ref0), al1 = exp2f(m1 - ref1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = exp2f(sc[i] - ((i & 2) ? ref1 : ref0));
        sc[i] = p;
        if (i & 2) sum1 += p;
        else sum0 += p;
      }
      l0 = l0 * al0 + sum0;             // per-lane partials, summed at the end
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

      mbar_wait(&v_full[s], ph);
      const uint32_t v_tile = smem_u32(sV + s * G::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], TL::template mnmajor<BN>(v_tile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    float inv[D / 2];                   // O / l, row by row
#pragma unroll
    for (int i = 0; i < D / 2; ++i) inv[i] = o[i] / ((i & 2) ? lc1 : lc0);
    if ((lane & 3) == 0) {
      if (r0 < Tq)
        a.lse[(long long)bh * Tq + r0] =
            (m0 == neg ? kNegInf : m0 * kLn2) + logf(lc0);
      if (r1 < Tq)
        a.lse[(long long)bh * Tq + r1] =
            (m1 == neg ? kNegInf : m1 * kLn2) + logf(lc1);
    }
    __nv_bfloat16* ob = head_ptr(a.out, a.so, b, h) + (long long)first * a.so.t;
    store_rows<D, BM>(inv, 1.f, sQ, wg * 64, ob, a.so.t,
                      min(64, Tq - first), 1 + wg);
  }
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                    float* lse, const long long* st, int B, int Tq, int Tk,
                    int H, float scale, int causal, cudaStream_t stream) {
  using G = FwdTiles<D>;
  static int smem_set = 0;
  int e = opt_in_smem(flash_fwd_bf16_kernel<D>, G::SMEM, &smem_set);
  if (e) return e;
  if (!rows16(out, st + 9)) return (int)cudaErrorInvalidValue;
  Bf16FwdArgs a;
  constexpr int W = Tile<D>::W, SWB = Tile<D>::SWB;
  if ((e = paddle_sm90::encode_map(&a.q.map, &a.q.pos, q, st[0], st[1], st[2],
                                   B, Tq, H, D, W, G::BM, SWB)) ||
      (e = paddle_sm90::encode_map(&a.k.map, &a.k.pos, k, st[3], st[4], st[5],
                                   B, Tk, H, D, W, G::BN, SWB)) ||
      (e = paddle_sm90::encode_map(&a.v.map, &a.v.pos, v, st[6], st[7], st[8],
                                   B, Tk, H, D, W, G::BN, SWB)))
    return e;
  a.out = (__nv_bfloat16*)out;
  a.lse = lse;
  a.so = {st[9], st[10], st[11]};
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  dim3 grid(B * H, (Tq + G::BM - 1) / G::BM);
  flash_fwd_bf16_kernel<D><<<grid, kWgThreads, G::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                      float* lse, const long long* st, int B, int Tq, int Tk,
                      int H, int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch_fwd_bf16<32>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
    case 64: return launch_fwd_bf16<64>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
    case 128: return launch_fwd_bf16<128>(q, k, v, out, lse, st, B, Tq, Tk, H, scale, causal, s);
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
// dtype: 0 float, 1 bfloat16 (q, k, v and out 16-byte aligned, strides
// multiples of 8 elements, or cudaErrorInvalidValue).  Returns cudaGetLastError() after the
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
  if (dtype == 1)                       // bf16: the wgmma + TMA kernel
    return dispatch_fwd_bf16(q, k, v, out, lse, strides, B, Tq, Tk, H, D,
                             scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
