// LayerNorm fused into the projection it feeds, for Hopper (sm_90a):
// out = LN(x; g, b) @ W^T.
//
// Replaces the Pallas TPU kernel of paddle_tpu/kernels/ln_matmul.py
// (`_ln_matmul_fwd_impl` -> `_kernel`).
//
// Layout: x [N, K] rows (row stride ldx); W [M, K], the port's
// nn.Linear.weight (row stride ldw), read in place, with no transposed
// copy; out [N, M] contiguous, in x's type; g and b [K], float or bf16 (a
// flag each); stats [2, N] f32 scratch (the bf16 path writes the rows'
// mean, then their rstd).  K % 8 == 0 and 16-byte aligned rows (the
// wrapper checks); the N, M and K edges are masked or zero-filled here,
// not padded.
//
// Semantics kept from the TPU kernel: f32 statistics (mean, then the mean
// of the squared deviations, rsqrt(var + eps)); the normalised row
// (x - mean) * rstd * g + b rounded to x's type before the product; f32
// accumulation; the output rounded to x's type; the projection's bias
// added outside.  The LayerNorm is not folded into the weight: that would
// drop the rounding of the normalised row.
//
// What bounds it on the H100: at the GPT shapes (N = 16384 rows, K = 768,
// M = 2304 or 3072) 2*N*K*M flops against N*K + M*K + N*M elements, some
// 450 flops a byte in bf16, above the card's ridge of ~295: operations
// bound it, at 989 TFLOP/s dense bf16 on the tensor cores.
//
// Design (bf16), two launches:
//   1. `ln_stats_kernel`: the mean and rstd of every row (row_stats: a
//      warp four rows at a time, 16-byte loads) into `stats`, one read of
//      x (25 MB at N = 16384, K = 768: ~8 us at 3.35 TB/s).
//   2. `ln_matmul_wgmma_kernel`: persistent, one block of 384 threads an
//      SM walking 128 x 256 output tiles, the column tiles of a row tile
//      side by side so that x's rows stay in the 50 MB L2.  Warpgroup 2
//      is the producer: one thread keeps TMA loads of x's [128, 64] slice
//      and W's [256, 64] slice (bf16, 128-byte swizzle, zeros past N, M
//      and K) in flight into a 4-stage mbarrier ring (full: the bytes
//      landed; empty: the 8 consumer warps are done).  Warpgroups 0 and
//      1 own 64 rows each.  Per slice each normalises its rows of x's
//      tile in place in shared memory, in f32 ((x - mean) * rstd * g + b,
//      g and b read through L1, zero past K so the K edge adds nothing),
//      rounded to bf16, then issues wgmma m64n256k16 with that tile as
//      the K-major A and W's tile as the K-major B, read where TMA wrote
//      them (f32 accumulators in registers).  A slice's products are
//      committed and waited for at depth 1, so the normalisation of slice
//      k+1 runs while the tensor cores work on slice k; a stage is
//      released when the products that read it are done.  The epilogue
//      rounds the accumulators to bf16 into swizzled 64-column blocks
//      (two 8 KB buffers a warpgroup, in turns) that TMA stores, the N
//      and M edges clipped by the map, so the stores run on under the
//      next block and tile; an M that TMA cannot store (M % 8 != 0) takes
//      masked direct stores.  setmaxnreg: 240 registers for the
//      consumers, 24 for the producer.
//   Why A goes through shared memory and not registers: with the
//   normalised fragment as wgmma's register A, the next slice's
//   fragments are written while this slice's products are in flight, and
//   ptxas then serialises every wgmma (C7513); measured on the H100 that
//   design ran at 0.18 ms (qkv), the epilogue's scattered 4-byte stores
//   taking a third of it.
//
// f32 operands take a CUDA-core path (64 x 64 tiles, 16-wide slices, 4 x 4
// outputs a thread, f32 FMAs, the statistics in a prologue of each block):
// no tensor cores, so no TF32 rounding.
#include "ln_common.cuh"
#include "sm90.cuh"

namespace {

using namespace paddle_ln;

constexpr int kThreads = 256;

// -- bf16: the row statistics ----------------------------------------------
constexpr int kStatRows = 32;  // a block's rows: 8 warps x 4 rows

__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, int N,
                int K, float eps, float* __restrict__ mu,
                float* __restrict__ rs) {
  __shared__ float s_mu[kStatRows], s_rs[kStatRows];
  const int row0 = blockIdx.x * kStatRows;
  row_stats(x, ldx, row0, kStatRows, N, K, eps, s_mu, s_rs);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kStatRows && row0 + r < N) {
    mu[row0 + r] = s_mu[r];
    rs[row0 + r] = s_rs[r];
  }
}

// -- bf16: wgmma + TMA ------------------------------------------------------
constexpr int BM = 128;              // rows of a tile: two warpgroups of 64
constexpr int BN = 256;              // columns of a tile
constexpr int BK = 64;               // a K slice: one 128-byte swizzled row
constexpr int S = 4;                 // stages of the ring
constexpr int X_BYTES = BM * BK * 2, W_BYTES = BN * BK * 2;
constexpr int STAGE = X_BYTES + W_BYTES;
// a warpgroup's output staging: two [64 rows][64 columns] bf16 blocks,
// 128-byte swizzled, each the source of one TMA store
constexpr int kOutBlock = 64 * 64 * 2;
// 1024 bytes of alignment slack, the S stages of {x slice, W slice}, the
// two warpgroups' output staging, 2 S barriers: 230464 of the 232448
// bytes a block may have on the H100
constexpr int kWgSmem = 1024 + S * STAGE + 4 * kOutBlock + 16 * S;
static_assert(kWgSmem <= 232448, "ln_matmul: shared memory");

struct WgArgs {
  CUtensorMap xmap, wmap, omap;
  paddle_sm90::MapPos xpos, wpos, opos;
  const float* mu;
  const float* rs;
  const void* g;
  const void* b;
  int g_bf16, b_bf16;
  __nv_bfloat16* out;
  int N, K, M, n_col_tiles, n_tiles;
  int tma_out;                         // M % 8 == 0: TMA stores the output
};

// Two adjacent outputs of one row, rounded to bf16, masked at the edges
// (the epilogue for an M that TMA cannot store).
__device__ __forceinline__ void store2(__nv_bfloat16* out, int row, int col,
                                       float v0, float v1, int N, int M) {
  if (row >= N) return;
  __nv_bfloat16* o = out + (long long)row * M + col;
  if (col < M) o[0] = __float2bfloat16(v0);
  if (col + 1 < M) o[1] = __float2bfloat16(v1);
}

__global__ void __launch_bounds__(384, 1)
ln_matmul_wgmma_kernel(__grid_constant__ const WgArgs a) {
  using namespace paddle_sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nk = (a.K + BK - 1) / BK;
  uint8_t* s_out = sm + S * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_out + 4 * kOutBlock);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                        // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
        const int r0 = (t / a.n_col_tiles) * BM;
        const int c0 = (t % a.n_col_tiles) * BN;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          uint8_t* st = sm + s * STAGE;
          tma_load(st, &a.xmap, &full[s], a.xpos, ks * BK, r0, 0, 0);
          tma_load(st + X_BYTES, &a.wmap, &full[s], a.wpos, ks * BK, c0,
                   0, 0);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {                              // consumers: 64 rows each
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int bar = 1 + wg;             // the warpgroup's named barrier
    // the normalisation: this thread's 16-byte chunk nc (columns 8 nc ..
    // 8 nc + 7 of a slice) of rows nr + 16 i (i < 4) of the warpgroup's 64
    const int nr = tid >> 3, nc = tid & 7;
    uint8_t* my_out = s_out + wg * 2 * kOutBlock;
    float acc[BN / 2];
    int s = 0, ph = 0, prev = 0;
    for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      const int r0 = (t / a.n_col_tiles) * BM;
      const int c0 = (t % a.n_col_tiles) * BN;
      float mu[4], rs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + wg * 64 + nr + 16 * i;
        mu[i] = row < a.N ? a.mu[row] : 0.f;
        rs[i] = row < a.N ? a.rs[row] : 0.f;
      }
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[s], ph);
        uint8_t* xt = sm + s * STAGE;
        // normalise the warpgroup's 64 rows of x's slice in place, in f32,
        // rounded to bf16 (the swizzle moves a row's chunks, not its
        // columns' g and b; zeros past K, so the K edge adds nothing)
        float gv[8], bv[8];
        const int c = ks * BK + 8 * nc;
        if (c < a.K) {                  // K % 8 == 0: all 8 or none
          load_params<8>(a.g, a.g_bf16, c, gv);
          load_params<8>(a.b, a.b_bf16, c, bv);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) gv[e] = bv[e] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wg * 64 + nr + 16 * i;
          uint4* p = reinterpret_cast<uint4*>(xt + row * 128 +
                                              ((nc ^ (row & 7)) << 4));
          float f[8];
          unpack8(*p, f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (f[e] - mu[i]) * rs[i] * gv[e] + bv[e];
          *p = pack8(f);
        }
        fence_proxy_async();            // the writes, before wgmma reads
        warpgroup_bar(bar);
        const uint32_t xa = smem_u32(xt) + wg * 64 * 128;
        const uint32_t wt = smem_u32(xt) + X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN>(acc, make_desc(xa + kk * 32, 16, 1024, 1),
                       make_desc(wt + kk * 32, 16, 1024, 1),
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
      if (a.tma_out) {
        // 64-column blocks of the tile's bf16 rows staged in shared memory
        // (two buffers in turn), each TMA stored as one bulk group that
        // runs on while the next block, and the next tile, go ahead
        const bool live = r0 + wg * 64 < a.N;
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          uint8_t* buf = my_out + (cb & 1) * kOutBlock;
          if (tid == 0) bulk_wait_read<1>();  // this buffer's last store
          warpgroup_bar(bar);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = row + 8 * h, j = 8 * cb + jj;
              *reinterpret_cast<uint32_t*>(
                  buf + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t4) =
                  pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          fence_proxy_async();
          warpgroup_bar(bar);
          if (tid == 0) {               // an empty group keeps the count
            if (live && c0 + 64 * cb < a.M)
              tma_store(&a.omap, a.opos, buf, c0 + 64 * cb, r0 + wg * 64, 0,
                        0);
            bulk_commit();
          }
        }
      } else {
        const int ra = r0 + wg * 64 + row;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c0 + 8 * j + 2 * t4;
          store2(a.out, ra, col, acc[4 * j], acc[4 * j + 1], a.N, a.M);
          store2(a.out, ra + 8, col, acc[4 * j + 2], acc[4 * j + 3], a.N,
                 a.M);
        }
      }
    }
    if (a.tma_out && tid == 0) bulk_wait<0>();
  }
}

// -- f32: CUDA cores ---------------------------------------------------------
constexpr int FM = 64, FN = 64, FK = 16, FP = FM + 4;

__global__ void __launch_bounds__(kThreads)
ln_matmul_f32_kernel(const float* __restrict__ x, long long ldx,
                     const void* __restrict__ g, int g_bf16,
                     const void* __restrict__ b, int b_bf16,
                     const float* __restrict__ w, long long ldw,
                     float* __restrict__ out, int N, int K, int M,
                     float eps) {
  __shared__ __align__(16) float sA[FK][FP];  // [k][tile row]
  __shared__ __align__(16) float sB[FK][FP];  // [k][tile column]
  __shared__ float s_mu[FM], s_rs[FM];
  extern __shared__ float s_par[];
  float* s_g = s_par;
  float* s_b = s_par + K;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * FM, col0 = blockIdx.x * FN;
  for (int i = tid; i < K; i += kThreads) {
    s_g[i] = param_at(g, g_bf16, i);
    s_b[i] = param_at(b, b_bf16, i);
  }
  row_stats(x, ldx, row0, FM, N, K, eps, s_mu, s_rs);
  __syncthreads();

  // staging: one 16-byte vector a thread: tile row tid / 4, columns
  // 4 (tid % 4) .. + 4 of the slice
  const int sr = tid >> 2, sc = (tid & 3) * 4;
  float4 ra, rb;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int k0) {
    const int k = k0 + sc;
    ra = row0 + sr < N && k < K
             ? __ldg(reinterpret_cast<const float4*>(x + (row0 + sr) * ldx + k))
             : zero;
    rb = col0 + sr < M && k < K
             ? __ldg(reinterpret_cast<const float4*>(w + (col0 + sr) * ldw + k))
             : zero;
  };
  auto stage = [&](int k0) {
    const int k = k0 + sc;
    float f[4] = {ra.x, ra.y, ra.z, ra.w};
    const bool in = row0 + sr < N && k < K;
    const float mu = s_mu[sr], rs = s_rs[sr];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sA[sc + e][sr] = in ? (f[e] - mu) * rs * s_g[k + e] + s_b[k + e] : 0.f;
    sB[sc + 0][sr] = rb.x;
    sB[sc + 1][sr] = rb.y;
    sB[sc + 2][sr] = rb.z;
    sB[sc + 3][sr] = rb.w;
  };

  const int ty = tid >> 4, tx = tid & 15;  // rows 4 ty.., columns 4 tx..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();
    stage(k0);
    __syncthreads();
    if (k0 + FK < K) fetch(k0 + FK);
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < M) out[(long long)row * M + col] = acc[i][j];
    }
  }
}

template <typename K>
int opt_in_smem(K kernel, int bytes, int* done) {
  // the static tiles and the dynamic parameters share the block's budget
  if (bytes > 16 * 1024 && *done < bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    *done = bytes;
  }
  return 0;
}


int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The statistics pass, then the persistent product.
int launch_wgmma(const void* x, long long ldx, const void* g, int g_bf16,
                 const void* b, int b_bf16, const void* w, long long ldw,
                 void* out, float* stats, int N, int K, int M, float eps,
                 cudaStream_t s) {
  static int done = 0;
  int e = opt_in_smem(ln_matmul_wgmma_kernel, kWgSmem, &done);
  if (e) return e;
  WgArgs a;
  a.tma_out = M % 8 == 0 && ((uintptr_t)out & 15) == 0;
  if ((e = paddle_sm90::encode_map(&a.xmap, &a.xpos, x, 0, ldx, 0, 1, N, 1,
                                   K, BK, BM, 128)) ||
      (e = paddle_sm90::encode_map(&a.wmap, &a.wpos, w, 0, ldw, 0, 1, M, 1,
                                   K, BK, BN, 128)) ||
      (a.tma_out &&
       (e = paddle_sm90::encode_map(&a.omap, &a.opos, out, 0, M, 0, 1, N, 1,
                                    M, 64, 64, 128))))
    return e;
  a.mu = stats;
  a.rs = stats + N;
  a.g = g;
  a.b = b;
  a.g_bf16 = g_bf16;
  a.b_bf16 = b_bf16;
  a.out = (__nv_bfloat16*)out;
  a.N = N;
  a.K = K;
  a.M = M;
  a.n_col_tiles = (M + BN - 1) / BN;
  const long long tiles = (long long)a.n_col_tiles * ((N + BM - 1) / BM);
  if (tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  ln_stats_kernel<<<(N + kStatRows - 1) / kStatRows, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, ldx, N, K, eps, stats, stats + N);
  if ((e = (int)cudaGetLastError())) return e;
  const int grid = a.n_tiles < sm_count() ? a.n_tiles : sm_count();
  ln_matmul_wgmma_kernel<<<grid, 384, kWgSmem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float, 1 bfloat16 (x, W and out); g_dtype, b_dtype likewise
// for the LayerNorm parameters; stats: [2, N] f32 scratch for the bf16
// path (the rows' mean and rstd; unused for float).  Returns
// cudaGetLastError() after the last launch (0 on success).
int paddle_ln_matmul(const void* x, long long ldx, const void* g,
                     const void* b, const void* w, long long ldw, void* out,
                     float* stats, int N, int K, int M, float eps, int dtype,
                     int g_dtype, int b_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || M <= 0 || K <= 0 || K % 8 || ldx % 8 || ldw % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (!stats) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, ldx, g, g_dtype, b, b_dtype, w, ldw, out, stats,
                        N, K, M, eps, s);
  }
  if (dtype == 0) {
    static int done = 0;
    const int smem = 2 * K * (int)sizeof(float);
    const dim3 grid((M + FN - 1) / FN, (N + FM - 1) / FM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const int e = opt_in_smem(ln_matmul_f32_kernel, smem, &done);
    if (e) return e;
    ln_matmul_f32_kernel<<<grid, kThreads, smem, s>>>(
        (const float*)x, ldx, g, g_dtype, b, b_dtype, (const float*)w, ldw,
        (float*)out, N, K, M, eps);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
