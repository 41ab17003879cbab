// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, the element types, strided
// operands and the f32 staging of a tile into shared memory (the f32
// kernels); the swizzled bf16 tile geometry and the epilogue store of the
// wgmma kernels (bf16).
//
// Every operand is addressed through element strides (batch, sequence,
// head) with a unit-stride head dimension, so q, k and v may be role
// views of one fused [B, T, nh, 3, hd] projection, and gradients may land
// in role slices of one fused buffer.  Offsets are 64-bit.  Inputs and
// outputs are float or __nv_bfloat16; everything a kernel sums is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace paddle_flash {

constexpr int kB = 64;                  // rows of a q or k/v tile
constexpr int kThreads = 256;           // 16 x 16 threads, 4 x 4 rows each
constexpr float kNegInf = -1e30f;       // the TPU kernels' mask value

// Element strides of one [B, T, H, D] operand; D is unit-stride.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly sum over the warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Base pointer of head h of batch b.
template <typename T>
__device__ __forceinline__ T* head_ptr(T* p, Strides s, int b, int h) {
  return p + (long long)b * s.b + (long long)h * s.h;
}

// Stage rows [t0, t0 + kB) of two operands of one head into shared memory
// as f32 (row pitches `pa`, `pb`; operand a times `mul_a`); rows at or
// past `T_len` read as zeros.  One loop for both: the index arithmetic is
// shared, and the loads take the read-only path (`__ldg`).
template <typename T, int D>
__device__ __forceinline__ void stage_tiles(
    float* dst_a, int pa, const T* src_a, long long stride_a, float mul_a,
    float* dst_b, int pb, const T* src_b, long long stride_b, int t0,
    int T_len) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = t0 + r;
    const bool in = t < T_len;
    dst_a[r * pa + c] =
        in ? to_f32(__ldg(src_a + (long long)t * stride_a + c)) * mul_a : 0.f;
    dst_b[r * pb + c] =
        in ? to_f32(__ldg(src_b + (long long)t * stride_b + c)) : 0.f;
  }
}

// Ask for more than the 48 KB default of dynamic shared memory once per
// kernel instantiation.
template <typename K>
__host__ int opt_in_smem(K kernel, int bytes, int* done) {
  if (bytes > 48 * 1024 && *done < bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    *done = bytes;
  }
  return 0;
}

// -- the bf16 wgmma kernels ----------------------------------------------------

constexpr int kWgThreads = 384;         // two consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A bf16 tile of R rows x D columns as TMA writes it (sm90.cuh): D / W
// column blocks of [R][W], rows of SWB bytes, 16-byte chunks XOR-swizzled
// by row: the chunk bits [4, 4 + log2(SWB / 16)) of an address XOR its
// bits [7, ...), which for rows of SWB bytes are row bits from SH up.
// D = 16 takes the 32-byte swizzle: one 16-column block, one wgmma K step
// a row.
template <int D>
struct Tile {
  static constexpr int SWB = D >= 64 ? 128 : D == 32 ? 64 : 32;  // bytes
  static constexpr int W = SWB / 2;                 // columns of a block
  static constexpr int NCB = D / W;                 // column blocks
  static constexpr int MODE = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  static constexpr int CPB = SWB / 16;              // chunks a block row
  static constexpr int SH = SWB == 128 ? 0 : SWB == 64 ? 1 : 2;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the bf16 flash tiles take head size 16, 32, 64 or 128");

  // Byte offset of 16-byte chunk c (columns 8c..8c+7) of row r.
  template <int R>
  __device__ static int chunk(int r, int c) {
    return (c / CPB) * R * SWB + r * SWB +
           (((c % CPB) ^ ((r >> SH) & (CPB - 1))) << 4);
  }
  // K-major operand: rows [row0, row0 + 64 or N), reduction columns
  // [16 kk, 16 kk + 16).
  template <int R>
  __device__ static uint64_t kmajor(uint32_t tile, int row0, int kk) {
    return paddle_sm90::make_desc(
        tile + (kk * 16 / W) * R * SWB + row0 * SWB + (kk * 16 % W) * 2, 16,
        8 * SWB, MODE);
  }
  // MN-major operand: reduction rows [16 kk, 16 kk + 16), all D columns.
  template <int R>
  __device__ static uint64_t mnmajor(uint32_t tile, int kk) {
    return paddle_sm90::make_desc(tile + kk * 16 * SWB, R * SWB, 8 * SWB,
                                  MODE);
  }
  // Issue the NCB boxes of rows [t, t + R) of one head.
  template <int R>
  __device__ static void load(uint8_t* dst, const CUtensorMap* map,
                              uint64_t* bar, paddle_sm90::MapPos p, int t,
                              int h, int b) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      paddle_sm90::tma_load(dst + cb * R * SWB, map, bar, p, cb * W, t, h, b);
  }
};

// A warpgroup's m64nD f32 accumulator (times `mul`) as bf16 rows of a
// [rows, D] destination with row pitch `pitch` elements, `n_valid` of the
// 64 rows written.  Staged through the warpgroup's own rows [row0, row0 +
// 64) of a shared tile of R rows, so the global stores are 16 bytes a
// thread along the row.  `bar_id` names the warpgroup's barrier.
template <int D, int R>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, uint8_t* tile, int row0,
                                           __nv_bfloat16* dst, long long pitch,
                                           int n_valid, int bar_id) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  paddle_sm90::fence_proxy_async();
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t v = paddle_sm90::pack_bf16(acc[4 * j + 2 * half] * mul,
                                                acc[4 * j + 2 * half + 1] * mul);
      *reinterpret_cast<uint32_t*>(
          tile + Tile<D>::template chunk<R>(row0 + r + 8 * half, j) +
          4 * (lane & 3)) = v;
    }
  paddle_sm90::warpgroup_bar(bar_id);
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int rr = i / (D / 8), c = i % (D / 8);
    if (rr < n_valid)
      *reinterpret_cast<uint4*>(dst + rr * pitch + c * 8) =
          *reinterpret_cast<const uint4*>(
              tile + Tile<D>::template chunk<R>(row0 + rr, c));
  }
}

// The map of one bf16 operand and where its coordinates go.
struct Map {
  CUtensorMap map;
  paddle_sm90::MapPos pos;
};

// A destination written by store_rows takes 16-byte rows: its base and
// its head, sequence and batch strides must be 16-byte aligned.
inline bool rows16(const void* p, const long long* st) {
  return !((uintptr_t)p & 15) && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

// -- causal rows with no live key (Tq > Tk) --------------------------------

// The reference's result on the causal rows i < Tq - Tk follows its tiles
// (`_block_sizes` in paddle_tpu/kernels/flash_attention.py: bq = min(1024,
// Tq), bk = min(1024, Tk)): every score of such a row is -1e30, so each kv
// tile its q tile visits (j * bk <= q_tile * bq + bq - 1 + Tk - Tq; every
// tile in the one-pass forward of a single kv tile) gives p = 1 on all bk
// columns, the padding past Tk included, and its lse is -1e30.
// `dead_rows` in flash_attention.py computes the same.
struct DeadRule {
  int Tq, Tk, bq, bk, nq, nk;

  __host__ __device__ DeadRule(int tq, int tk)
      : Tq(tq), Tk(tk), bq(tq < 1024 ? tq : 1024), bk(tk < 1024 ? tk : 1024),
        nq((tq + bq - 1) / bq), nk((tk + bk - 1) / bk) {}
  // columns of the kv tiles row i's q tile visits in the split kernels
  __host__ __device__ int visited(int i) const {
    const int hi = (i / bq) * bq + bq - 1 + Tk - Tq;
    if (hi < 0) return 0;
    const int n = hi / bk + 1;
    return (n < nk ? n : nk) * bk;
  }
  // the forward's columns with p = 1 (its divisor; 0: a zero row)
  __host__ __device__ int fwd_cols(int i) const {
    return nk == 1 ? bk : visited(i);
  }
  // the backward's keys with p = 1
  __host__ __device__ int bwd_keys(int i) const {
    if (nq == 1 && nk == 1) return Tk;
    const int c = visited(i);
    return c < Tk ? c : Tk;
  }
};

}  // namespace paddle_flash
