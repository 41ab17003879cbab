// LayerNorm fused into the projection it feeds, for Hopper (sm_90a):
// out = LN(x; g, b) @ W^T.
//
// Replaces the Pallas TPU kernel of paddle_tpu/kernels/ln_matmul.py
// (`_ln_matmul_fwd_impl` -> `_kernel`).
//
// Layout: x [N, K] rows (row stride ldx); W [M, K], the port's
// nn.Linear.weight (row stride ldw), read in place, with no transposed
// copy; out [N, M] contiguous, in x's type; g and b [K], float or bf16 (a
// flag each).  K % 8 == 0 and 16-byte aligned rows (the wrapper checks);
// the N, M and K edges are masked here, not padded.
//
// Semantics kept from the TPU kernel: f32 statistics (mean, then the mean
// of the squared deviations, rsqrt(var + eps)); the normalised row
// (x - mean) * rstd * g + b rounded to x's type before the product; f32
// accumulation; the output rounded to x's type; the projection's bias
// added outside.
//
// What bounds it on the H100: at the GPT shapes (N = 16384 rows, K = 768,
// M = 2304 or 3072) 2*N*K*M flops against N*K + M*K + N*M elements, some
// 450 flops a byte in bf16, above the card's ridge of ~295: operations
// bound it, at 989 TFLOP/s dense bf16 on the tensor cores.
//
// Design (bf16): a block of 8 warps owns 128 rows and a run of 128 x 128
// output tiles along them.  A prologue computes the mean and rstd of its
// rows once (row_stats: a warp four rows at a time, 16-byte loads) into
// shared memory and stages g and b there as f32.
// The K loop takes 32-wide slices: x's slice is normalised, rounded to bf16
// and written to shared memory as it is staged, W's slice is copied beside
// it, and each warp multiplies a 64 x 32 sub-tile: ldmatrix from shared
// memory, mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers), and
// the output written from the registers.  The next
// slice's global loads are issued into registers before the current
// slice's products and staged into the second of two shared-memory
// buffers after them, so one barrier a slice separates the stages.  The
// grid runs the column tiles of one row tile together, so x's rows and all
// of W stay in the 50 MB L2.  Not yet: wgmma, TMA loads and a deeper ring
// (later work).
//
// f32 operands take a CUDA-core path of the same structure (64 x 64 tiles,
// 16-wide slices, 4 x 4 outputs a thread, f32 FMAs): no tensor cores, so
// no TF32 rounding.
#include "ln_common.cuh"

namespace {

using namespace paddle_ln;

constexpr int kThreads = 256;

// -- bf16: tensor cores ------------------------------------------------------
// Four 8 x 8 bf16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // bf16 row pitch of the staged slices (80 B)
// one stage: the A slice [BM][LDS] then the B slice [BN][LDS], bf16
constexpr int kStageElems = (BM + BN) * LDS;
constexpr int kStageBytes = kStageElems * 2;

// dynamic shared memory: two stages, then g and b as f32 (2 * K floats)
__host__ __device__ constexpr int bf16_smem_bytes(int K) {
  return 2 * kStageBytes + 2 * K * 4;
}

// two blocks an SM: at most 128 registers a thread (one block an SM leaves
// too few warps to cover the loads); a block computes `tiles` output tiles
// of its 128 rows, side by side, after one prologue
__global__ void __launch_bounds__(kThreads, 2)
ln_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                      const void* __restrict__ g, int g_bf16,
                      const void* __restrict__ b, int b_bf16,
                      const __nv_bfloat16* __restrict__ w, long long ldw,
                      __nv_bfloat16* __restrict__ out, int N, int K, int M,
                      float eps, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mu[BM], s_rs[BM];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_g = reinterpret_cast<float*>(smem + 2 * kStageBytes);
  float* s_b = s_g + K;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * BM;
  for (int i = tid; i < K; i += kThreads) {
    s_g[i] = param_at(g, g_bf16, i);
    s_b[i] = param_at(b, b_bf16, i);
  }
  row_stats(x, ldx, row0, BM, N, K, eps, s_mu, s_rs);
  __syncthreads();

  // the block walks `tiles` column tiles of its rows after one prologue
  for (int t = 0; t < tiles; ++t) {
    const int col0 = (blockIdx.x * tiles + t) * BN;
    if (col0 >= M) break;
    // staging: 16-byte vector i = tid + 256 r (r = 0, 1) of a slice is tile
    // row i / 4, columns 8 (i % 4) .. + 8
    const int sr = tid >> 2, sc = (tid & 3) * 8;
    uint4 ra[2], rb[2];
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    auto fetch = [&](int k0) {
      const int k = k0 + sc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + sr + 64 * r;
        const int n = col0 + sr + 64 * r;
        ra[r] = row < N && k < K
                    ? __ldg(reinterpret_cast<const uint4*>(x + row * ldx + k))
                    : zero;
        rb[r] = n < M && k < K
                    ? __ldg(reinterpret_cast<const uint4*>(w + n * ldw + k))
                    : zero;
      }
    };
    auto stage = [&](int buf, int k0) {
      __nv_bfloat16* sA = stages + buf * kStageElems;
      __nv_bfloat16* sB = sA + BM * LDS;
      const int k = k0 + sc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = sr + 64 * r;
        uint4 o = zero;
        if (row0 + tr < N && k < K) {
          float f[8];
          unpack8(ra[r], f);
          const float mu = s_mu[tr], rs = s_rs[tr];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (f[e] - mu) * rs * s_g[k + e] + s_b[k + e];
          o = pack8(f);
        }
        *reinterpret_cast<uint4*>(sA + tr * LDS + sc) = o;
        *reinterpret_cast<uint4*>(sB + tr * LDS + sc) = rb[r];
      }
    };

    const int wm = warp >> 2, wn = warp & 3;  // a 64 x 32 sub-tile a warp
    // accumulators: 4 x 4 m16n8 tiles of the warp's sub-tile, f32
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // ldmatrix row addresses of this lane: A rows lane % 16, columns
    // 8 (lane / 16); B (the W slice, n-major) rows lane % 8 + 8 (lane /
    // 16), columns 8 ((lane / 8) % 2)
    const int a_off = (wm * 64 + (lane & 15)) * LDS + (lane >> 4) * 8;
    const int b_off =
        (wn * 32 + (lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;

    // two stages: while the warps multiply one slice, the next is fetched
    // into registers and staged into the other buffer; one barrier a slice
    fetch(0);
    stage(0, 0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool more = k0 + BK < K;
      if (more) fetch(k0 + BK);
      const __nv_bfloat16* sA = stages + buf * kStageElems;
      const __nv_bfloat16* sB = sA + BM * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4(af[i], sA + a_off + i * 16 * LDS + kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          unsigned r[4];
          ldsm_x4(r, sB + b_off + jj * 16 * LDS + kk);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
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
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn * 32 + j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wm * 64 + i * 16 + (lane >> 2) + 8 * h;
          if (row >= N) continue;
          __nv_bfloat16* o = out + (long long)row * M + col;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (col + 1 < M && M % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < M) o[0] = __float2bfloat16(v0);
            if (col + 1 < M) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
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

// Column tiles a bf16 block walks after its prologue: the largest divisor
// of the row's tiles that still leaves about 1.75 waves of blocks (two
// blocks an SM), so the statistics are computed fewer times without an
// idle tail.  It changes no arithmetic, only which block does a tile.
int tiles_per_block(int n_tiles, int row_tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  for (int t = n_tiles; t > 1; --t)
    if (n_tiles % t == 0 && (long long)(n_tiles / t) * row_tiles >=
                                (7LL * sms) / 2)
      return t;
  return 1;
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

}  // namespace

extern "C" {

// dtype: 0 float, 1 bfloat16 (x, W and out); g_dtype, b_dtype likewise
// for the LayerNorm parameters.  Returns cudaGetLastError() after the
// launch (0 on success).
int paddle_ln_matmul(const void* x, long long ldx, const void* g,
                     const void* b, const void* w, long long ldw, void* out,
                     int N, int K, int M, float eps, int dtype, int g_dtype,
                     int b_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || M <= 0 || K <= 0 || K % 8 || ldx % 8 || ldw % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    static int done = 0;
    const int smem = bf16_smem_bytes(K);
    const int n_tiles = (M + BN - 1) / BN;
    const int tiles = tiles_per_block(n_tiles, (N + BM - 1) / BM);
    const dim3 grid(n_tiles / tiles, (N + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const int e = opt_in_smem(ln_matmul_bf16_kernel, smem, &done);
    if (e) return e;
    ln_matmul_bf16_kernel<<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)x, ldx, g, g_dtype, b, b_dtype,
        (const __nv_bfloat16*)w, ldw, (__nv_bfloat16*)out, N, K, M, eps,
        tiles);
    return (int)cudaGetLastError();
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
