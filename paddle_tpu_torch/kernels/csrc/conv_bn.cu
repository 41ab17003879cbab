// The conv + batch-norm experiment kernels, for Hopper (sm_90a): they
// replace the five Pallas kernel bodies of the experiment scripts.
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
// use too) adds the blocks' partials [2, groups, N] in block order, so the
// statistics repeat bitwise (no atomics).  The TPU kernels carried the sum
// across a sequential grid axis; here block (column tile cx, group g) walks
// the row tiles g, g + groups, ... of column tile cx itself, in that fixed
// order, and sums them in order.
//
// What bounds it on the H100: 2 M K N flops against 2 (M K + K N + M N)
// bytes.  With K or N of 64-256 (ResNet-50's 1x1 convs at 56^2 and 28^2)
// that is under the card's ridge of ~295 flops a byte: bytes bound it, at
// 3.35 TB/s.  The 3x3 convs and the wide 1x1 convs at 14^2 and 7^2 sit
// near or above the ridge: operations bound them, at 989 TFLOP/s dense
// bf16.
//
// Two routes, chosen by shape in conv_bn.py (`conv_plan`), never by a
// failed build or launch:
//
// (1) `conv1x1_wgmma` and `conv3x3_wgmma` (conv_wgmma.cuh, instanced in
//     conv_wgmma_1x1.cu and conv_wgmma_3x3.cu): every 1x1, and every 3x3
//     with C % 64 == 0.  A persistent block of one producer warpgroup and
//     NWG = 2 (128-row tiles; one block an SM) or 1 (64-row tiles; two
//     blocks an SM, for small M) consumer warpgroups of 64 rows each; BN
//     = 64, 128 or 256 columns, the widest that leaves half the card's
//     SMs a tile (each slice's fixed cost buys more products: 98 tiles of
//     128 x 256 took 0.0254 ms at M=12544 K=1024 N=256, 196 of 128 x 128
//     0.0374, tools/conv_bn_sweep.py on the H100).  Block (cx,
//     g) walks the row tiles g, g + groups, ... of column tile cx.  One
//     producer thread keeps x's [BM, 64] K slice and W's [64, BN] slice
//     (bf16, 128-byte swizzle) in flight in a 3-8 stage mbarrier ring (as
//     deep as shared memory allows: loads in flight, not the tensor
//     cores, pace a slice from L2), running on into the block's next tile
//     while the consumers store the last one.  W is read in place as
//     wgmma's MN-major B (its [K, N] rows are the reduction: the
//     descriptor's transpose flag, sm90.cuh `wgmma_ss<N, 1>`), no
//     transposed copy.  The consumers issue wgmma m64nBNk16 on x's tile as
//     the K-major A, waited at depth 1, and the epilogue reduces the
//     column sums of y and y^2 from the accumulator fragments (rows past
//     M masked) over the warp by a halving shuffle exchange in a fixed
//     order into the warp's own row of a shared [warp][2][BN] table, the
//     block's tiles in their order, and rounds y to bf16 into swizzled
//     64-column blocks (two 8 KB buffers a warpgroup, in turns) that TMA
//     stores, clipped to M and N by the map, under the next tile.
//     The prologue, two ways (`conv_plan`'s "prologue"):
//     - "kernel", a 1x1 whose N fits one column tile (each x element
//       meets the prologue once): each consumer warpgroup applies
//       relu(x * s + b) to its 64 rows of x's slice in place in shared
//       memory, in f32, rounded to bf16, s and b staged in shared memory
//       once a block, writing 0 past M and past K (TMA's zero fill alone
//       would become relu(b)); then wgmma reads that tile (never as a
//       register A: ptxas serialised every wgmma of ln_matmul's
//       register-A design, C7513).
//     - "pass", the 3x3 and a 1x1 of several column tiles, where the
//       in-place prologue would run nine times (the taps) or once per
//       column tile on each element: `prologue_kernel` below writes
//       relu(x * s + b) once, and the GEMM reads that.  The in-place
//       prologue costs a shared-memory load and store of the tile on
//       every slice, beside TMA's write and wgmma's read: at M=3136
//       K=2048 N=512 (four column tiles) 0.0359 ms, against 0.0068 for
//       the pass and 0.0155 for the product after it
//       (tools/conv_bn_sweep.py on the H100).
//     The 3x3's A slice: x is one 2-D map over the flat [n H W, C] image
//     rows, and a tap (di, dj) of the tile's output pixels m0 .. m0 + BM
//     is the box at rows m0 + (di - 1) W + (dj - 1), channels c0 .. c0 +
//     64 (C % 64 == 0, so no slice straddles two taps).  Chosen over an
//     im2col map or 4-D boxes of whole image rows because it is one map
//     and one box shape for every tap and tiles stay any BM rows of any
//     image size (7^2 and 14^2 images are 49 and 196 rows, no multiple of
//     a tile); its cost is that a box row whose tap leaves the image row
//     or the image reads a neighbouring pixel.  Three warps of the
//     producer warpgroup (idle otherwise) take each landed stage, write
//     those rows as 0 (from the pixel's coordinates: zero padding after
//     the prologue, not relu(b)) and hand the stage to the consumers on a
//     third mbarrier, so the consumers never stop for it.  Each tap
//     re-reads x's rows from L2.
// (2) `conv3x3_mma_kernel` below, the mma.sync implicit GEMM of the first
//     port, kept for the 3x3 with C % 64 != 0 (C % 8 == 0): a block of 8
//     warps owns a 128 x 128 tile of y (128 x 64 when Co <= 64) and walks
//     the row tiles of its column tile; 32-wide K slices in two shared
//     stages, the next slice's 16-byte global loads issued before the
//     current slice's products and staged (prologue applied) after them;
//     ldmatrix / ldmatrix.trans, mma.sync.m16n8k16, y stored from the
//     registers, the same fixed-order statistics.
#include "conv_wgmma.cuh"
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

// dynamic shared memory: two stages, then s and b as f32 (C floats each)
template <int TBN>
__host__ __device__ constexpr int smem_bytes(int C) {
  return 2 * Tile<TBN>::kStageBytes + 2 * C * 4;
}

template <int TBN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ s, const float* __restrict__ b,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 int M, int K, int N, int H, int W, int C) {
  using T = Tile<TBN>;
  constexpr int LDB = T::LDB, NJ = T::NJ, kStageElems = T::kStageElems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[2][2][TBN];  // [warp row][sum, sumsq]
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int P = C;
  float* s_s = reinterpret_cast<float*>(smem + 2 * T::kStageBytes);
  float* s_b = s_s + P;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * TBN;
  const int row_tiles = (M + BM - 1) / BM;
  for (int i = tid; i < P; i += kThreads) {
    s_s[i] = s[i];
    s_b[i] = b[i];
  }
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
    int pimg[2], ph[2], pw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = row0 + sr + 64 * r;
      pimg[r] = m / (H * W);
      const int rem = m - pimg[r] * H * W;
      ph[r] = rem / W;
      pw[r] = rem - ph[r] * W;
    }
    uint4 ra[2], rb[T::kWVec];
    bool okA[2];
    auto fetch = [&](int k0) {
      const int k = k0 + sc;
      const int tap = k / C, c = k - tap * C;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int hh = ph[r] + tap / 3 - 1, ww = pw[r] + tap % 3 - 1;
        const bool ok = row0 + sr + 64 * r < M && k < K && hh >= 0 &&
                        hh < H && ww >= 0 && ww < W;
        const long long off =
            (((long long)pimg[r] * H + hh) * W + ww) * C + c;
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
        if (okA[r]) {
          const int c = k % C;
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
    {
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

  {
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

template <int TBN>
int launch_tile(const void* x, const float* s, const float* b, const void* w,
                void* y, float* part, int M, int K, int N, int H, int W,
                int C, int groups, cudaStream_t stream) {
  static int done = 0;
  const int smem = smem_bytes<TBN>(C);
  if (smem > 48 * 1024 && done < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_mma_kernel<TBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    done = smem;
  }
  const dim3 grid((N + TBN - 1) / TBN, groups);
  conv3x3_mma_kernel<TBN><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, s, b, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)y, part, M, K, N, H, W, C);
  return (int)cudaGetLastError();
}

// 64-wide tiles when N fits one, else 128-wide.
int launch_mma(const void* x, const float* s, const float* b, const void* w,
           void* y, float* part, int M, int K, int N, int H, int W, int C,
           int groups, cudaStream_t stream) {
  if (N <= 64)
    return launch_tile<64>(x, s, b, w, y, part, M, K, N, H, W, C, groups,
                           stream);
  return launch_tile<128>(x, s, b, w, y, part, M, K, N, H, W, C, groups,
                          stream);
}

// out = relu(x * s[c] + b[c]) in f32, each operation rounded, to bf16:
// the prologue of the wgmma route's pass, once a row-major [rows, C]
// element (C % 8 == 0), 16 bytes a thread.
__global__ void __launch_bounds__(256)
prologue_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ s, const float* __restrict__ b,
                __nv_bfloat16* __restrict__ out, long long n8, int C) {
  for (long long v = blockIdx.x * 256LL + threadIdx.x; v < n8;
       v += (long long)gridDim.x * 256) {
    const int c = (int)(v * 8 % C);
    float f[8], sv[8], bv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(x) + v), f);
    load16(s + c, sv);
    load16(s + c + 4, sv + 4);
    load16(b + c, bv);
    load16(b + c + 4, bv + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = fmaxf(__fadd_rn(__fmul_rn(f[e], sv[e]), bv[e]), 0.f);
    reinterpret_cast<uint4*>(out)[v] = pack8(f);
  }
}

}  // namespace

extern "C" {

// The mma.sync route: the 3x3 only.  x NHWC bf16 [n, H, W, C], K = 9 C,
// M = n H W; s, b f32 [C]; w bf16 [K, N] row-major; y bf16 [M, N]; part
// f32 [2, groups, N] (the column sums of y and y^2 of each block row).  C %
// 8 == 0, N % 8 == 0 and 16-byte aligned bases (the wrapper checks).
// groups: the blocks along M, 1 <= groups <= ceil(M / 128).  prologue,
// stats and conv3 must be 1 (the 1x1 takes the wgmma route).  Returns
// cudaGetLastError() after the launch (0 on success).
int paddle_conv_bn_gemm(const void* x, const float* s, const float* b,
                        const void* w, void* y, float* part, int M, int K,
                        int N, int H, int W, int C, int prologue, int stats,
                        int conv3, int groups, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || groups < 1 ||
      groups > (M + BM - 1) / BM || groups > 65535 || !conv3 || !prologue ||
      !stats || C <= 0 || C % 8 || K != 9 * C || (long long)H * W <= 0 ||
      M % (H * W))
    return (int)cudaErrorInvalidValue;
  return launch_mma(x, s, b, w, y, part, M, K, N, H, W, C, groups,
                    (cudaStream_t)stream);
}

// The wgmma route: x bf16 [M, K] (or NHWC [n, H, W, C] with conv3, K = 9
// C, C % 64 == 0, M = n H W); prologue 0 (none) or 1 (applied in the
// kernel, s, b f32 [K]) for the 1x1, 2 for the 3x3 (x is the prologue
// pass's output; the kernel zeroes the taps outside the image); w bf16
// [K, N] row-major; y bf16 [M, N]; part f32 [2, groups, N] when stats.
// K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (the wrapper checks);
// (bn, nwg) one of (64, 1), (64, 2), (128, 2), (256, 2); groups: blocks
// along M, 1 <= groups <= ceil(M / (64 nwg)).  Returns cudaGetLastError()
// after the launch (0 on success).
int paddle_conv_bn_wgmma(const void* x, const float* s, const float* b,
                         const void* w, void* y, float* part, int M, int K,
                         int N, int H, int W, int C, int prologue, int stats,
                         int conv3, int bn, int nwg, int groups,
                         void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || prologue < 0 ||
      prologue > 2 || (prologue == 1 && (!s || !b)) || (stats && !part) ||
      (prologue == 2 && !conv3))
    return (int)cudaErrorInvalidValue;
  if (conv3 && (prologue != 2 || C <= 0 || C % 64 || K != 9 * C ||
                (long long)H * W <= 0 || M % (H * W)))
    return (int)cudaErrorInvalidValue;
  const paddle_conv::ConvCall c{x, s, b, w, y, part, M, K, N, H, W, C,
                                prologue, stats, bn, nwg, groups,
                                (cudaStream_t)stream};
  return conv3 ? paddle_conv::conv3x3_wgmma(c)
               : paddle_conv::conv1x1_wgmma(c);
}

// out bf16 [rows, C] = relu(x * s + b) of x bf16 [rows, C], s, b f32 [C];
// C % 8 == 0, 16-byte aligned bases.  Returns cudaGetLastError().
int paddle_conv_bn_prologue(const void* x, const float* s, const float* b,
                            void* out, long long rows, int C, int blocks,
                            void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  prologue_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, s, b, (__nv_bfloat16*)out, rows * C / 8, C);
  return (int)cudaGetLastError();
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
