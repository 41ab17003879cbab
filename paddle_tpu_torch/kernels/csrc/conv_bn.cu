// The conv + batch-norm experiment kernels, for Hopper (sm_90a): one GEMM
// template whose instances replace the five Pallas kernel bodies of the
// experiment scripts.
//
//   PROLOGUE STATS CONV3   replaces (Pallas body -> entry point)
//   0        0     0       tools/exp_conv_bn2.py `_k_mm`   -> run_mm
//   0        1     0       tools/exp_conv_bn2.py `_k_stat` -> run_mm(nstat)
//   1        0     0       tools/exp_conv_bn2.py `_k_pro`  -> run_pro
//   1        1     0       tools/exp_conv_bn.py  `_kernel` -> fused_conv1x1_bn
//   1        1     1       tools/exp_conv3x3.py  `_kernel` -> fused3x3
//
// What it computes: y = A @ W with bf16 operands and an f32 accumulator, y
// rounded to bf16.  A is x [M, K] (a 1x1 conv over NHWC rows) or, under
// CONV3, the implicit im2col of an NHWC image x [n, H, W, C] for a 3x3,
// stride-1, SAME conv: output pixel m, column k = (3 di + dj) C + c reads
// x[img, h + di - 1, w + dj - 1, c]; W is [K, N] row-major, the JAX
// layout ([K, N], or HWIO = [9 C, Co] for the 3x3), read in place.
// PROLOGUE applies the previous batch norm and relu to A as it is staged:
// relu(x * s[c] + b[c]) in f32 (a multiply and an add, each rounded, as the
// reference and the plain version compute it), rounded to bf16 before the
// product.  Taps outside the image and rows or columns past the edge read
// 0 AFTER the prologue (not relu(b)).  STATS writes, per block, the f32
// column sums of y and y^2 over the block's rows, taken from the f32
// accumulator (not the rounded y), padded rows masked; a second kernel
// (the fixed-order column sum of ln_common.cuh, which LayerNorm's dw and db
// use too) adds the blocks' partials,
// so the statistics repeat bitwise (no atomics).  The TPU kernels carried
// the sum across a sequential grid axis; here each block walks a fixed set
// of row tiles itself and sums them in order.
//
// What bounds it on the H100: 2 M K N flops against 2 (M K + K N + M N)
// bytes.  With K or N of 64-256 (ResNet-50's 1x1 convs at 56^2 and 28^2)
// that is under the card's ridge of ~295 flops a byte: bytes bound it, at
// 3.35 TB/s, so the prologue and the statistics ride on loads and stores
// the product needs anyway, and x is read once per 128-column tile (the
// tiles of one row run side by side, so the re-reads hit the 50 MB L2).
// The 3x3 convs and the wide 1x1 convs at 14^2 and 7^2 sit near or above
// the ridge: operations bound them, at 989 TFLOP/s dense bf16.
//
// Design: a block of 8 warps owns a 128 x 128 tile of y at a time (128 x
// 64 when N <= 64, so the 64-channel layers of the 56^2 stage do not
// multiply zero columns) and walks the row tiles blockIdx.y, blockIdx.y +
// gridDim.y, ... of its column tile (gridDim.y is chosen by the caller so
// the grid fills the card about twice).  The K loop takes 32-wide slices
// in two shared-memory stages: the next slice's 16-byte global loads are
// issued into registers before the current slice's products and staged
// (prologue applied) after them, one barrier a slice.  A is read with
// ldmatrix, W with ldmatrix.trans from its row-major [K, N] slice (no
// transposed copy); each warp multiplies a 64 x 32 (or 64 x 16) sub-tile
// with mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers) and
// writes y from the registers.  The column sums of each row tile are
// reduced over the warp with shuffles and added into the block's
// shared-memory row, each column owned by one thread.
// Not yet: wgmma, TMA loads, a deeper ring, and a 3x3 tile that re-uses
// the shifted rows it has staged for the neighbouring taps.
#include "ln_common.cuh"

namespace {

using namespace paddle_ln;

constexpr int kThreads = 256;
constexpr int BM = 128, BK = 32;
constexpr int LDA = BK + 8;   // bf16 pitch of a staged A slice row (80 B)

// A tile is BM x TBN, TBN 128 or 64 (N <= 64: the 56^2 layers' 64
// channels would leave half of a 128-wide tile idle).
template <int TBN>
struct Tile {
  static constexpr int LDB = TBN + 8;  // bf16 pitch of a staged W row
  static constexpr int kStageElems = BM * LDA + BK * LDB;
  static constexpr int kStageBytes = kStageElems * 2;
  static constexpr int NJ = TBN / 32;          // n8 tiles a warp
  static constexpr int kVecRow = TBN / 8;      // 16-byte vectors a W row
  static constexpr int kRowsPass = kThreads / kVecRow;
  static constexpr int kWVec = BK / kRowsPass;  // W vectors a thread
};

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, each 8 x 8 matrix transposed: rows in shared memory are k.
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// dynamic shared memory: two stages, then s and b as f32 (P floats each)
template <int TBN>
__host__ __device__ constexpr int smem_bytes(bool prologue, int P) {
  return 2 * Tile<TBN>::kStageBytes + (prologue ? 2 * P * 4 : 0);
}

template <bool PRO, bool STATS, bool CONV3, int TBN>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ s, const float* __restrict__ b,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 int M, int K, int N, int H, int W, int C) {
  using T = Tile<TBN>;
  constexpr int LDB = T::LDB, NJ = T::NJ, kStageElems = T::kStageElems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[STATS ? 2 : 1][2][TBN];  // [warp row][sum, sumsq]
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int P = CONV3 ? C : K;
  float* s_s = reinterpret_cast<float*>(smem + 2 * T::kStageBytes);
  float* s_b = s_s + P;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * TBN;
  const int row_tiles = (M + BM - 1) / BM;
  if (PRO)
    for (int i = tid; i < P; i += kThreads) {
      s_s[i] = s[i];
      s_b[i] = b[i];
    }
  if (STATS)
    for (int i = tid; i < 2 * 2 * TBN; i += kThreads)
      (&s_red[0][0][0])[i] = 0.f;
  __syncthreads();

  // staging: A vector r (0, 1) of a slice is tile row sr + 64 r, columns
  // sc .. sc + 8; W vector r is slice row kb + kRowsPass r, columns
  // cb .. cb + 8
  const int sr = tid >> 2, sc = (tid & 3) * 8;
  const int kb = tid / T::kVecRow, cb = (tid % T::kVecRow) * 8;
  const int wm = warp >> 2, wn = warp & 3;  // a 64 x TBN/4 sub-tile a warp
  // ldmatrix row addresses of this lane: A rows lane % 16, columns
  // 8 (lane / 16); W slice rows (k) lane % 8 + 8 ((lane / 8) % 2),
  // columns 8 (lane / 16) of each 16-column pair
  const int a_off = (wm * 64 + (lane & 15)) * LDA + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                    wn * (TBN / 4) + (lane >> 4) * 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int row0 = rt * BM;
    int pimg[2] = {0, 0}, ph[2] = {0, 0}, pw[2] = {0, 0};
    if (CONV3) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row0 + sr + 64 * r;
        pimg[r] = m / (H * W);
        const int rem = m - pimg[r] * H * W;
        ph[r] = rem / W;
        pw[r] = rem - ph[r] * W;
      }
    }
    uint4 ra[2], rb[T::kWVec];
    bool okA[2];
    auto fetch = [&](int k0) {
      const int k = k0 + sc;
      const int tap = CONV3 ? k / C : 0, c = k - tap * C;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool ok = row0 + sr + 64 * r < M && k < K;
        long long off;
        if (CONV3) {
          const int hh = ph[r] + tap / 3 - 1, ww = pw[r] + tap % 3 - 1;
          ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
          off = (((long long)pimg[r] * H + hh) * W + ww) * C + c;
        } else {
          off = (long long)(row0 + sr + 64 * r) * K + k;
        }
        okA[r] = ok;
        ra[r] = ok ? __ldg(reinterpret_cast<const uint4*>(x + off)) : zero;
      }
#pragma unroll
      for (int r = 0; r < T::kWVec; ++r) {
        const int kr = k0 + kb + T::kRowsPass * r;
        rb[r] = kr < K && col0 + cb < N
                    ? __ldg(reinterpret_cast<const uint4*>(
                          w + (long long)kr * N + col0 + cb))
                    : zero;
      }
    };
    auto stage = [&](int buf, int k0) {
      __nv_bfloat16* sA = stages + buf * kStageElems;
      __nv_bfloat16* sB = sA + BM * LDA;
      const int k = k0 + sc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint4 o = ra[r];
        if (PRO && okA[r]) {
          const int c = CONV3 ? k % C : k;
          float f[8];
          unpack8(ra[r], f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = fmaxf(__fadd_rn(__fmul_rn(f[e], s_s[c + e]), s_b[c + e]),
                         0.f);
          o = pack8(f);
        }
        *reinterpret_cast<uint4*>(sA + (sr + 64 * r) * LDA + sc) = o;
      }
#pragma unroll
      for (int r = 0; r < T::kWVec; ++r)
        *reinterpret_cast<uint4*>(sB + (kb + T::kRowsPass * r) * LDB + cb) =
            rb[r];
    };

    float acc[4][NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    fetch(0);
    stage(0, 0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool more = k0 + BK < K;
      if (more) fetch(k0 + BK);
      const __nv_bfloat16* sA = stages + buf * kStageElems;
      const __nv_bfloat16* sB = sA + BM * LDA;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[4][4], bf[NJ][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4(af[i], sA + a_off + i * 16 * LDA + kk);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          unsigned r[4];
          ldsm_x4_trans(r, sB + b_off + kk * LDB + jj * 16);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
      if (more) stage(buf ^ 1, k0 + BK);
      __syncthreads();
      buf ^= 1;
    }

    // epilogue from the registers: a lane holds rows lane / 4 and
    // lane / 4 + 8, columns 2 (lane % 4) .. + 1 of each m16n8 tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = col0 + wn * (TBN / 4) + j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wm * 64 + i * 16 + (lane >> 2) + 8 * h;
          if (row < M && col < N)
            *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
                __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
    if (STATS) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sm = 0.f, sq = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + wm * 64 + i * 16 + (lane >> 2) + 8 * h;
              const float v = acc[i][j][2 * h + e];
              if (row < M) {
                sm += v;
                sq += v * v;
              }
            }
          // the lanes of one column (equal lane % 4), in a fixed order
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sm += __shfl_xor_sync(0xffffffffu, sm, o);
            sq += __shfl_xor_sync(0xffffffffu, sq, o);
          }
          if (lane < 4) {
            const int c = wn * (TBN / 4) + j * 8 + lane * 2 + e;
            s_red[wm][0][c] += sm;
            s_red[wm][1][c] += sq;
          }
        }
      }
    }
  }

  if (STATS) {
    // the block's partial row: the two warp rows added in order
    __syncthreads();
    const long long G = gridDim.y;
    for (int t = tid; t < TBN; t += kThreads) {
      if (col0 + t >= N) continue;
      part[(long long)blockIdx.y * N + col0 + t] = s_red[0][0][t] + s_red[1][0][t];
      part[(G + blockIdx.y) * N + col0 + t] = s_red[0][1][t] + s_red[1][1][t];
    }
  }
}

template <bool PRO, bool STATS, bool CONV3, int TBN>
int launch_tile(const void* x, const float* s, const float* b, const void* w,
                void* y, float* part, int M, int K, int N, int H, int W,
                int C, int groups, cudaStream_t stream) {
  static int done = 0;
  const int smem = smem_bytes<TBN>(PRO, CONV3 ? C : K);
  if (smem > 48 * 1024 && done < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_gemm_kernel<PRO, STATS, CONV3, TBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    done = smem;
  }
  const dim3 grid((N + TBN - 1) / TBN, groups);
  conv_gemm_kernel<PRO, STATS, CONV3, TBN><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, s, b, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)y, part, M, K, N, H, W, C);
  return (int)cudaGetLastError();
}

// 64-wide tiles when N fits one, else 128-wide.
template <bool PRO, bool STATS, bool CONV3>
int launch(const void* x, const float* s, const float* b, const void* w,
           void* y, float* part, int M, int K, int N, int H, int W, int C,
           int groups, cudaStream_t stream) {
  if (N <= 64)
    return launch_tile<PRO, STATS, CONV3, 64>(x, s, b, w, y, part, M, K, N,
                                              H, W, C, groups, stream);
  return launch_tile<PRO, STATS, CONV3, 128>(x, s, b, w, y, part, M, K, N, H,
                                             W, C, groups, stream);
}

}  // namespace

extern "C" {

// x bf16 [M, K] (or NHWC [n, H, W, C] with conv3, K = 9 C, M = n H W); s, b
// f32 [K] (or [C]) when prologue; w bf16 [K, N] row-major; y bf16 [M, N];
// part f32 [2, groups, N] when stats (the column sums of y and y^2 of each
// block row).  K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (the
// wrapper checks).  groups: the blocks along M, 1 <= groups <= ceil(M /
// 128).  Returns cudaGetLastError() after the launch (0 on success).
int paddle_conv_bn_gemm(const void* x, const float* s, const float* b,
                        const void* w, void* y, float* part, int M, int K,
                        int N, int H, int W, int C, int prologue, int stats,
                        int conv3, int groups, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || groups < 1 ||
      groups > (M + BM - 1) / BM || groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (conv3) {
    if (!prologue || !stats || C <= 0 || C % 8 || K != 9 * C ||
        (long long)H * W <= 0 || M % (H * W))
      return (int)cudaErrorInvalidValue;
    return launch<true, true, true>(x, s, b, w, y, part, M, K, N, H, W, C,
                                    groups, st);
  }
  if (prologue && stats)
    return launch<true, true, false>(x, s, b, w, y, part, M, K, N, 0, 0, 0,
                                     groups, st);
  if (prologue)
    return launch<true, false, false>(x, s, b, w, y, part, M, K, N, 0, 0, 0,
                                      groups, st);
  if (stats)
    return launch<false, true, false>(x, s, b, w, y, part, M, K, N, 0, 0, 0,
                                      groups, st);
  return launch<false, false, false>(x, s, b, w, y, part, M, K, N, 0, 0, 0,
                                     groups, st);
}

// stats [2, N] f32 = the column sums of part [2, groups, N], in block order.
int paddle_conv_bn_colsum(const float* part, float* stats, int groups, int N,
                          void* stream) {
  if (groups <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + 31) / 32, 2);
  colsum2_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(part, stats, groups,
                                                         N);
  return (int)cudaGetLastError();
}

}  // extern "C"
