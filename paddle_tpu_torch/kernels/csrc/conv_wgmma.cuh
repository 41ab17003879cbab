// The conv + batch-norm GEMM on wgmma + TMA (sm_90a): one persistent
// producer/consumer kernel template, instanced for the 1x1 GEMM
// (conv_wgmma_1x1.cu: `conv1x1_wgmma`, kernels 11 and 13) and the 3x3
// implicit GEMM (conv_wgmma_3x3.cu: `conv3x3_wgmma`, kernel 12).  What it
// computes, and the design, are in conv_bn.cu's header.
#pragma once

#include "ln_common.cuh"
#include "sm90.cuh"

namespace paddle_conv {

// The arguments of paddle_conv_bn_wgmma (conv_bn.cu) for one launch.
struct ConvCall {
  const void* x;
  const float* s;
  const float* b;
  const void* w;
  void* y;
  float* part;
  int M, K, N, H, W, C, pro, stats, bn, nwg, groups;
  cudaStream_t stream;
};

int conv1x1_wgmma(const ConvCall& c);
int conv3x3_wgmma(const ConvCall& c);

namespace {

using namespace paddle_ln;

constexpr int BK = 64;                  // a K slice: one 128-byte swizzled row
constexpr int kBlk = 64 * 64 * 2;       // one [64][64] bf16 block: 8 KB
constexpr int kSbMax = 2048;            // s and b staged in shared memory

struct ConvArgs {
  CUtensorMap xmap, wmap, ymap;
  const float* s;
  const float* b;
  float* part;
  int M, K, N;                          // K = 9 C for the 3x3
  int H, W, C;                          // the 3x3's image and channels
  int pro, stats, row_tiles;
};

// BM = 64 NWG rows (one consumer warpgroup each) x BN columns a tile.
template <int BN, int NWG>
struct ConvCfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT = NWG * 2 * kBlk;           // two blocks a wg
  static constexpr int RED = NWG * 4 * 2 * BN * 4;     // [warp][2][BN] f32
  static constexpr int SB = 2 * kSbMax * 4;            // s, b f32
  // a block's share of the SM's 232448 bytes (two blocks an SM at NWG = 1)
  static constexpr int BUDGET = NWG == 1 ? 232448 / 2 - 1024 : 232448;
  // as many ring stages as the rest leaves (at most 8): the loads in
  // flight, not the tensor cores, pace a slice from L2
  static constexpr int S0 = (BUDGET - 1024 - OUT - RED - SB - 256) / STAGE;
  static constexpr int S = S0 < 8 ? S0 : 8;
  // alignment slack, the ring, output staging, statistics, s and b, 3 S
  // barriers
  static constexpr int SMEM = 1024 + S * STAGE + OUT + RED + SB + 24 * S;
  static constexpr int THREADS = 128 * (NWG + 1);
  static_assert(S >= 3 && SMEM <= BUDGET, "conv_wgmma: shared memory");
};

// Barrier `id` over the n threads of the consumer warpgroups.
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// One step of the statistics' halving exchange over the lanes `o` apart:
// a lane keeps columns [0, n) of its 2 n (the lower lane) or [n, 2 n) (the
// upper), sends the other half and adds its partner's into su[0, n) and
// sq[0, n).
template <int n>
__device__ __forceinline__ void halve(float* su, float* sq, int lane, int o) {
  const bool hi = lane & o;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float ku = hi ? su[i + n] : su[i], tu = hi ? su[i] : su[i + n];
    const float kq = hi ? sq[i + n] : sq[i], tq = hi ? sq[i] : sq[i + n];
    su[i] = ku + __shfl_xor_sync(0xffffffffu, tu, o);
    sq[i] = kq + __shfl_xor_sync(0xffffffffu, tq, o);
  }
}

template <bool CONV3, int BN, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1)
conv_wgmma_kernel(__grid_constant__ const ConvArgs a) {
  using namespace paddle_sm90;
  using Cfg = ConvCfg<BN, NWG>;
  constexpr int BM = Cfg::BM, S = Cfg::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_out = sm + S * Cfg::STAGE;
  float* s_red = reinterpret_cast<float*>(s_out + Cfg::OUT);
  float* s_sb = s_red + NWG * 4 * 2 * BN;  // s, then b
  uint64_t* full = reinterpret_cast<uint64_t*>(s_sb + 2 * kSbMax);
  uint64_t* empty = full + S;
  uint64_t* ready = empty + S;          // the 3x3's masked stages
  const int wg = threadIdx.x >> 7;
  const int nk = (a.K + BK - 1) / BK;
  const int cpt = CONV3 ? a.C / BK : 1;  // K slices a tap
  const int col0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);    // lane 0 of each consumer warp
      mbar_init(&ready[i], 96);         // the masking threads
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < NWG * 4 * 2 * BN; i += Cfg::THREADS)
    s_red[i] = 0.f;
  // the in-kernel prologue's s and b, staged once a block, off the
  // slices' path; past kSbMax channels they are read where they lie
  const bool sb_smem = !CONV3 && a.pro && a.K <= kSbMax;
  if (sb_smem)
    for (int i = threadIdx.x; i < a.K; i += Cfg::THREADS) {
      s_sb[i] = a.s[i];
      s_sb[kSbMax + i] = a.b[i];
    }
  __syncthreads();
  const float* ps = sb_smem ? s_sb : a.s;
  const float* pb = sb_smem ? s_sb + kSbMax : a.b;

  if (wg == NWG) {                      // producer warpgroup
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    const int pt = threadIdx.x - NWG * 128;
    if (pt == 0) {                      // the TMA thread
      int s = 0, ph = 0;
      for (int rt = blockIdx.y; rt < a.row_tiles; rt += gridDim.y) {
        const int r0 = rt * BM;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], Cfg::STAGE);
          uint8_t* st = sm + s * Cfg::STAGE;
          if (CONV3) {
            // the tap's pixels are the tile's rows shifted by (di-1) W +
            // (dj-1) in the flat [n H W, C] image; rows that leave the
            // image row or the image are zeroed by the masking warps,
            // rows past either end of x arrive as zeros
            const int tap = ks / cpt;
            tma_load_2d(st, &a.xmap, &full[s], (ks - tap * cpt) * BK,
                        r0 + (tap / 3 - 1) * a.W + tap % 3 - 1);
          } else {
            tma_load_2d(st, &a.xmap, &full[s], ks * BK, r0);
          }
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + Cfg::A_BYTES + j * kBlk, &a.wmap, &full[s],
                        col0 + 64 * j, ks * BK);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (CONV3 && pt >= 32) {
      // warps 1-3, the masking warps: the 3x3's taps outside the image
      // (x is through the prologue already) read a neighbouring pixel
      // through the shifted box; each of these threads owns rows pt - 32
      // and pt + 64 of the tile and writes a row that falls outside as 0,
      // then hands the stage on (ready), so the consumers never stop for
      // the masking
      const int mt = pt - 32;
      int s = 0, ph = 0;
      for (int rt = blockIdx.y; rt < a.row_tiles; rt += gridDim.y) {
        int ih[2], iw[2];
        bool in[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = rt * BM + mt + 96 * i;
          in[i] = mt + 96 * i < BM && m < a.M;
          const int rem = m % (a.H * a.W);
          ih[i] = rem / a.W;
          iw[i] = rem - ih[i] * a.W;
        }
        for (int ks = 0; ks < nk; ++ks) {
          const int tap = ks / cpt, di = tap / 3 - 1, dj = tap % 3 - 1;
          mbar_wait(&full[s], ph);
          uint8_t* st = sm + s * Cfg::STAGE;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int hh = ih[i] + di, ww = iw[i] + dj;
            if (in[i] && (hh < 0 || hh >= a.H || ww < 0 || ww >= a.W)) {
              uint4* row = reinterpret_cast<uint4*>(st + (mt + 96 * i) * 128);
#pragma unroll
              for (int c8 = 0; c8 < 8; ++c8)
                row[c8] = make_uint4(0u, 0u, 0u, 0u);
            }
          }
          fence_proxy_async();          // the zeros, before wgmma reads
          mbar_arrive(&ready[s]);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: 64 rows of the tile each
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int bar = 1 + wg;               // the warpgroup's named barrier
  // a stage is theirs once TMA has landed it (and, for the 3x3, the
  // masking warps have zeroed its taps outside the image)
  uint64_t* gate = CONV3 ? ready : full;
  // the prologue: this thread's 16-byte chunk nc (columns 8 nc .. 8 nc +
  // 7 of a slice) of rows nr + 16 i (i < 4) of the warpgroup's 64
  const int nr = tid >> 3, nc = tid & 7;
  uint8_t* my_out = s_out + wg * 2 * kBlk;
  float* my_red = s_red + (wg * 4 + warp) * 2 * BN;
  float acc[BN / 2];
  int s = 0, ph = 0, prev = 0;
  int stores = 0;                       // output blocks staged so far
  for (int rt = blockIdx.y; rt < a.row_tiles; rt += gridDim.y) {
    const int wr0 = rt * BM + wg * 64;  // the warpgroup's first row
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = wr0 + nr + 16 * i < a.M;
    for (int ks = 0; ks < nk; ++ks) {
      // the slice's scale and shift, fetched before its tile lands
      const int c = ks * BK + 8 * nc;
      const bool cin = c < a.K;         // K % 8 == 0: all 8 or none
      float sv[8], bv[8];
      if (!CONV3 && a.pro && cin) {
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const float4 sq4 = *reinterpret_cast<const float4*>(ps + c + e);
          const float4 bq4 = *reinterpret_cast<const float4*>(pb + c + e);
          sv[e] = sq4.x, sv[e + 1] = sq4.y, sv[e + 2] = sq4.z,
          sv[e + 3] = sq4.w;
          bv[e] = bq4.x, bv[e + 1] = bq4.y, bv[e + 2] = bq4.z,
          bv[e + 3] = bq4.w;
        }
      }
      mbar_wait(&gate[s], ph);
      uint8_t* st = sm + s * Cfg::STAGE;
      if (!CONV3 && a.pro) {
        // relu(x * s + b) in f32, each operation rounded, to bf16, in
        // place; an element past M or K is 0 after the prologue (TMA's
        // zero fill would become relu(b))
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wg * 64 + nr + 16 * i;
          uint4* p = reinterpret_cast<uint4*>(st + row * 128 +
                                              ((nc ^ (row & 7)) << 4));
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (cin && in[i]) {
            float f[8];
            unpack8(*p, f);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              f[e] = fmaxf(__fadd_rn(__fmul_rn(f[e], sv[e]), bv[e]), 0.f);
            o = pack8(f);
          }
          *p = o;
        }
        fence_proxy_async();            // the writes, before wgmma reads
        warpgroup_bar(bar);
      }
      // A: the warpgroup's 64 rows, K-major; B: W's [64 k][BN] slice as
      // TMA wrote it from the row-major [K, N] weight, MN-major
      const uint32_t xa = smem_u32(st) + wg * 64 * 128;
      const uint32_t wt = smem_u32(st) + Cfg::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN, 1>(acc, make_desc(xa + kk * 32, 16, 1024, 1),
                        make_desc(wt + kk * 16 * 128, 64 * 128, 1024, 1),
                        ks > 0 || kk > 0);
      wgmma_commit();
      // the previous slice's products are done: release its stage
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: accumulator rows warp * 16 + lane / 4 (+ 8), columns
    // 8 j + 2 (lane % 4) (+ 1)
    const int row = warp * 16 + (lane >> 2), t4 = lane & 3;
    if (a.stats) {
      // column sums of the f32 accumulator over the warp's 16 rows (rows
      // past M masked), then over the 8 lanes of a column (equal lane %
      // 4) by a halving exchange in a fixed order, a 64-column block at a
      // time: at each of the offsets 16, 8, 4 a lane keeps one half of its
      // 16 column values, sends the other and adds its partner's, so each
      // lane ends with 2, added into the warp's own row of s_red (the
      // block's tiles in their fixed order)
      const bool v0 = wr0 + row < a.M, v1 = wr0 + row + 8 < a.M;
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb) {
        float su[16], sq[16];
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          const int q = 4 * (8 * cb + (v >> 1)) + (v & 1);
          const float x0 = v0 ? acc[q] : 0.f, x1 = v1 ? acc[q + 2] : 0.f;
          su[v] = x0 + x1;
          sq[v] = x0 * x0 + x1 * x1;
        }
        halve<8>(su, sq, lane, 16);
        halve<4>(su, sq, lane, 8);
        halve<2>(su, sq, lane, 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {    // column value v = i + 2 (lane / 4)
          const int v = i + 2 * (lane >> 2);
          const int cc = 64 * cb + 8 * (v >> 1) + 2 * t4 + (v & 1);
          my_red[cc] += su[i];
          my_red[BN + cc] += sq[i];
        }
      }
    }
    // y: 64-column blocks of the warpgroup's bf16 rows staged in shared
    // memory (two buffers in turn), each TMA stored as one bulk group that
    // runs on under the next block and the next tile; the map clips rows
    // past M and columns past N
    const bool live = wr0 < a.M;
#pragma unroll
    for (int cb = 0; cb < BN / 64; ++cb) {
      uint8_t* buf = my_out + (stores++ & 1) * kBlk;
      if (tid == 0) bulk_wait_read<1>();  // this buffer's last store
      warpgroup_bar(bar);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h, j = 8 * cb + jj;
          *reinterpret_cast<uint32_t*>(buf + r * 128 + ((jj ^ (r & 7)) << 4) +
                                       4 * t4) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      fence_proxy_async();
      warpgroup_bar(bar);
      if (tid == 0) {                   // an empty group keeps the count
        if (live && col0 + 64 * cb < a.N)
          tma_store_2d(&a.ymap, buf, col0 + 64 * cb, wr0);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
  if (a.stats) {
    // the block's partial row: its warps' rows added in warp order
    named_bar(3, 128 * NWG);
    const long long G = gridDim.y;
    for (int t = threadIdx.x; t < BN; t += 128 * NWG) {
      if (col0 + t >= a.N) continue;
      float sm1 = 0.f, sq = 0.f;
      for (int w = 0; w < 4 * NWG; ++w) {
        sm1 += s_red[w * 2 * BN + t];
        sq += s_red[w * 2 * BN + BN + t];
      }
      a.part[(long long)blockIdx.y * a.N + col0 + t] = sm1;
      a.part[(G + blockIdx.y) * a.N + col0 + t] = sq;
    }
  }
}

template <bool CONV3, int BN, int NWG>
int launch_instance(const ConvArgs& a, int groups, cudaStream_t st) {
  using Cfg = ConvCfg<BN, NWG>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma_kernel<CONV3, BN, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, groups);
  conv_wgmma_kernel<CONV3, BN, NWG><<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      a);
  return (int)cudaGetLastError();
}

// The tensor maps, then the instance of the call's tile: (BN, NWG) one of
// (64, 1), (64, 2), (128, 2), (256, 2) (conv_bn.py's `conv_plan`).
template <bool CONV3>
int launch_conv(const ConvCall& c) {
  using paddle_sm90::encode_2d;
  const int bm = 64 * c.nwg;
  ConvArgs a;
  const long long ax = CONV3 ? c.C : c.K;  // x's row: channels or K
  int e;
  if ((e = encode_2d(&a.xmap, c.x, c.M, ax, ax, BK, bm)) ||
      (e = encode_2d(&a.wmap, c.w, c.K, c.N, c.N, 64, BK)) ||
      (e = encode_2d(&a.ymap, c.y, c.M, c.N, c.N, 64, 64)))
    return e;
  a.s = c.s;
  a.b = c.b;
  a.part = c.part;
  a.M = c.M;
  a.K = c.K;
  a.N = c.N;
  a.H = c.H;
  a.W = c.W;
  a.C = c.C;
  a.pro = c.pro;
  a.stats = c.stats;
  a.row_tiles = (c.M + bm - 1) / bm;
  if (c.groups < 1 || c.groups > a.row_tiles || c.groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (c.bn == 64 && c.nwg == 1)
    return launch_instance<CONV3, 64, 1>(a, c.groups, c.stream);
  if (c.bn == 64 && c.nwg == 2)
    return launch_instance<CONV3, 64, 2>(a, c.groups, c.stream);
  if (c.bn == 128 && c.nwg == 2)
    return launch_instance<CONV3, 128, 2>(a, c.groups, c.stream);
  if (c.bn == 256 && c.nwg == 2)
    return launch_instance<CONV3, 256, 2>(a, c.groups, c.stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_conv
