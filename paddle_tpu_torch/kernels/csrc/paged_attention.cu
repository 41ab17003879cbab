// Paged decode attention for Hopper (sm_90a): the serving decode read.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/paged_attention.py
// `paged_decode_attention` -> `_decode_kernel`.
//
// Operands: q [B, W, H, D] f32; k_pages/v_pages [NP, P, H, D] f32 or int8
// with k_scale/v_scale [NP, P] f32 (int8 only); page_table [B, n_pt] i32;
// lengths [B] i32 (row b's new positions are start .. start+W-1, already
// written to the pools).  Output [B, W, H, D] f32.
//
// What bounds it on the H100: bytes.  Each live position costs 2*H*D pool
// elements (K and V) for 4*W*D flops per head, about 0.5 flop per byte at
// W=1 f32, far under the ridge; int8 pools stream a quarter of the bytes.
// A decode step reads a few MB, so the card is filled only when every SM
// has the copies of several blocks in flight at once.
//
// Design: split over pages, then one exact merge.
//   paged_chunk_kernel: an item is (row, chunk, head): CP = S * SP
//     consecutive positions of one row (a chunk; SP positions, a segment,
//     never cross a page) for one head.  The grid has a block for every
//     item the shapes allow, so the launch never reads lengths on the host
//     and can be captured in a CUDA graph; block i counts the rows' live
//     items from lengths (a scan over the rows in one warp) and takes the
//     i-th.  Only positions below start + W can be attended by any query
//     of the row, so chunks at or past it are not items (the TPU kernel's
//     `i*P < start + W` skip) and bytes scale with resident tokens; the
//     live items are the grid's first blocks, which the card spreads over
//     all its SMs before the rest exit.  Warp 0's lane s reads segment s's
//     page id (sentinels >= NP clamp to page NP - 1, as the TPU kernel's
//     `jnp.minimum(pt, NP - 1)` does; the mask excludes them) and moves its
//     K and V boxes ([SP, 1, D] of the pools seen as [NP * P, H, D]) into
//     shared memory by TMA, one mbarrier a segment, all in flight at once.
//     Meanwhile the block loads q and, for int8, the positions' scales.
//     Scores: a thread owns one position and reads the K row from
//     shared memory in 16-byte vectors, starting at a column rotated by
//     the position so that neighbouring threads hit different banks; it
//     keeps every query's sum in registers, so the reduction over D costs
//     no shuffle (kW, W rounded up to 1, 2, 4 or 8, is a template
//     parameter: a loop over a runtime W issues all 8 iterations).  int8 K
//     is dequantized as the scale times the integer dot product.  Masked
//     (col <= start + row fails) scores are -1e30.  Per query a warp takes
//     the chunk's max m and sum l of exp(s - m) (to a workspace), and a
//     thread owning 4 columns sums exp(s - m) * V over every kSplits-th
//     position; the splits add in a fixed order into the chunk's
//     unnormalised o (to the workspace).  One head a block: head groups
//     of 2 and 4 timed no faster over the decode-step cases (PERF.md).
//   paged_merge_kernel, grid (head, row): out = sum o_c exp(m_c - M) / L
//     over the row's live chunks, M the max of m_c, L = sum l_c exp(m_c -
//     M), folded in chunk order.  It is launched as a programmatic
//     dependent of the chunk kernel, so its launch hides behind the chunks.
//     Every sum runs in a fixed order, so a call repeats bit for bit.  This
//     is the whole-row softmax regrouped: against the plain
//     gather-then-softmax read only the rounding changes (a few f32 ulps of
//     the result, far inside the 1e-4 the tests hold it to).
// Parked rows (start >= n_pt*P: idle slots whose table is all sentinel)
// read nothing and the merge writes zeros; the engine never reads them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace paddle_sm90;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 8;
constexpr float kNegInf = -1e30f;

struct PagedArgs {
  const float* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* lengths;
  float* out;
  float* part_o;    // [B][n_chunks][H][W][D] partial outputs
  float* part_ml;   // [2][B][n_chunks][H][W]: chunk max, then chunk sum
  int B, W, H, D, P, n_pt, NP;
  int SP, S, n_chunks;
  float scale;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Byte offsets of one chunk block's shared memory (each offset's comment
// names the region that ends there); `seg`: the bytes of one segment's K
// (or V) box, 128-byte aligned as TMA writes it.  A chunk holds at most
// 64 positions (`paged_plan`), so a block takes at most 87 KB (D = 128,
// W = 8, f32).
struct Smem {
  int seg, k, v, q, s, ks, vs, part, total;
};

// The query count the kernel is compiled for: W rounded up to 1, 2, 4, 8
// (a loop over a runtime W issues every iteration up to kMaxW).
__host__ __device__ inline int pow2_w(int W) {
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : 8;
}

// The V pass: a thread owns 4 columns of the row and every splits-th
// position, so D / 4 * splits = kThreads.
__host__ __device__ constexpr int v_splits(int D) { return kThreads * 4 / D; }

__host__ __device__ inline Smem smem_layout(int S, int SP, int W, int D,
                                            int esize) {
  const int CP = S * SP;
  W = pow2_w(W);
  Smem m;
  m.seg = align128(SP * D * esize);
  m.k = align128(S * 8);                         // the segments' mbarriers
  m.v = m.k + S * m.seg;                         // K [S][SP][D]
  m.q = m.v + S * m.seg;                         // V [S][SP][D]
  m.s = m.q + W * D * 4;                         // q [W][D] f32
  m.ks = m.s + align16(W * CP * 4);              // scores [W][CP]
  m.vs = m.ks + align16(CP * 4);                 // K scales [CP]
  m.part = m.vs + align16(CP * 4);               // V scales [CP]
  m.total = m.part + v_splits(D) * W * D * 4;    // V partials [splits][W][D]
  return m;
}

#ifdef PADDLE_PAGED_TRACE
// tools/paged_timeline.py builds the source with this macro: thread 0 of
// every chunk block writes %globaltimer at each phase boundary k (0-7) and
// its %smid (slot 8) to g_trace[block * 9 ...]; without it the points
// compile to nothing.
__device__ long long* g_trace = nullptr;
#define PAGED_TRACE(k)                                                   \
  if (g_trace && threadIdx.x == 0) {                                     \
    long long t_;                                                        \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
    g_trace[blockIdx.x * 9 + (k)] = t_;                                  \
    if ((k) == 0) {                                                      \
      unsigned sm_;                                                      \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                   \
      g_trace[blockIdx.x * 9 + 8] = sm_;                                 \
    }                                                                    \
  }
#else
#define PAGED_TRACE(k)
#endif

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of a row in shared memory as floats: 4 f32 or 16 int8.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = (float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xff);
}

// 4 consecutive elements as floats.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  load16(p, x);
}

__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ int page_id(const PagedArgs& a, int b, int pos) {
  return min(max(a.page_table[(long)b * a.n_pt + pos / a.P], 0), a.NP - 1);
}

template <typename T, int D, int kW>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const PagedArgs a, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kVec = 16 / sizeof(T);   // elements in a 16-byte vector
  constexpr int kNV = D / kVec;          // 16-byte vectors in a row
  constexpr int kD4 = D / 4;             // 4-column groups in a row
  constexpr int kSplits = v_splits(D);
  const int W = a.W, H = a.H, SP = a.SP;
  const int CP = a.S * SP;
  const int virt = a.n_pt * a.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long hd = (long)H * D;

  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(a.S, SP, kW, D, sizeof(T));
  const int seg_el = L.seg / (int)sizeof(T);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sKs = reinterpret_cast<float*>(smem + L.ks);
  float* sVs = reinterpret_cast<float*>(smem + L.vs);
  float* sPart = reinterpret_cast<float*>(smem + L.part);
  // the merge kernel may start now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // block i takes the i-th live item (row, chunk, head), counted row by
  // row from lengths: the live items are the grid's first blocks, which
  // the card spreads over its SMs first; the rest exit at once
  __shared__ int s_b, s_k;
  if (warp == 0) {
    if (lane == 0) s_b = -1;
    __syncwarp();
    int base = 0;
    for (int r0 = 0; r0 < a.B; r0 += 32) {
      const int r = r0 + lane;
      int n = 0;                       // live items of row r
      if (r < a.B) {
        const int st = a.lengths[r];
        if (st < virt) n = H * ((min(virt, st + W) + CP - 1) / CP);
      }
      int x = n;                       // inclusive scan over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int first = base + x - n;
      if ((int)blockIdx.x >= first && (int)blockIdx.x < first + n) {
        s_b = r;
        s_k = blockIdx.x - first;
      }
      base += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  if (s_b < 0) return;                   // past the live items
  const int b = s_b, chunk = s_k / H, h = s_k % H;
  const int start = a.lengths[b];
  const int live = min(virt, start + W);
  const int c0 = chunk * CP;
  const int n_live = min(CP, live - c0);       // live positions here
  const int n_seg = (n_live + SP - 1) / SP;
  PAGED_TRACE(0);

  // every live segment's K and V boxes in flight at once: lane s loads
  // segment s's page id and issues its two TMA loads
  if (warp == 0) {
    for (int sg = lane; sg < n_seg; sg += 32) {
      mbar_init(&bars[sg], 1);
      mbar_fence_init();
      const int pos = c0 + sg * SP;
      const int row = page_id(a, b, pos) * a.P + pos % a.P;
      mbar_expect_tx(&bars[sg], 2u * SP * D * sizeof(T));
      tma_load_3d(smem + L.k + sg * L.seg, &k_map, &bars[sg], 0, h, row);
      tma_load_3d(smem + L.v + sg * L.seg, &v_map, &bars[sg], 0, h, row);
    }
  }
  PAGED_TRACE(1);
  // q, its rows past W zero (kW rounds W up to a power of two)
  for (int i = tid; i < kW * D; i += kThreads) {
    const int w = i / D;
    sQ[i] = w < W ? a.q[((long)b * W + w) * hd + (long)h * D + i % D] : 0.f;
  }
  if (kQuant) {
    for (int i = tid; i < n_live; i += kThreads) {
      const int pos = c0 + i;
      const long at = (long)page_id(a, b, pos) * a.P + pos % a.P;
      sKs[i] = a.k_scale[at];
      sVs[i] = a.v_scale[at];
    }
  }
  __syncthreads();
  PAGED_TRACE(2);
#ifdef PADDLE_PAGED_TRACE
  if (g_trace && tid == 0)
    for (int sg = 0; sg < n_seg; ++sg) mbar_wait(&bars[sg], 0);
#endif
  PAGED_TRACE(3);

  // scores: a thread owns position i, all queries
  for (int i = tid; i < n_live; i += kThreads) {
    mbar_wait(&bars[i / SP], 0);
    const T* kr = sK + i / SP * seg_el + i % SP * D;
    float acc[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) acc[w] = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const int c = (j + i) & (kNV - 1);
      float kv[kVec];
      load16(kr + c * kVec, kv);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float* qr = sQ + w * D + c * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr + e);
          acc[w] = fmaf(x.x, kv[e], acc[w]);
          acc[w] = fmaf(x.y, kv[e + 1], acc[w]);
          acc[w] = fmaf(x.z, kv[e + 2], acc[w]);
          acc[w] = fmaf(x.w, kv[e + 3], acc[w]);
        }
      }
    }
    const float sc = (kQuant ? sKs[i] : 1.f) * a.scale;
    const int col = c0 + i;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      sS[w * CP + i] = col <= start + w ? acc[w] * sc : kNegInf;
  }
  __syncthreads();
  PAGED_TRACE(4);

  // the chunk's softmax statistics per query; s -> exp(s - m)
  const long ml = (long)a.B * a.n_chunks * H * W;
  for (int w = warp; w < W; w += kWarps) {
    float* row = sS + w * CP;
    float mx = kNegInf;
    for (int i = lane; i < n_live; i += 32) mx = fmaxf(mx, row[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n_live; i += 32) {
      const float e = expf(row[i] - mx);
      row[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const long at = (((long)b * a.n_chunks + chunk) * H + h) * W + w;
      a.part_ml[at] = mx;
      a.part_ml[ml + at] = sum;
    }
  }
  __syncthreads();
  PAGED_TRACE(5);

  // partial o: a thread owns columns 4*d4 .. and every kSplits-th
  // position; the splits are summed after in a fixed order
  {
    const int d4 = tid % kD4, sp = tid / kD4;
    float acc[kW][4];
#pragma unroll
    for (int w = 0; w < kW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][e] = 0.f;
    for (int i = sp; i < n_live; i += kSplits) {
      float v[4];
      load4(sV + i / SP * seg_el + i % SP * D + 4 * d4, v);
      const float vs = kQuant ? sVs[i] : 1.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float p = sS[w * CP + i] * vs;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][e] = fmaf(p, v[e], acc[w][e]);
      }
    }
#pragma unroll
    for (int w = 0; w < kW; ++w)
      *reinterpret_cast<float4*>(sPart + (sp * kW + w) * D + 4 * d4) =
          make_float4(acc[w][0], acc[w][1], acc[w][2], acc[w][3]);
  }
  __syncthreads();
  PAGED_TRACE(6);
  for (int i = tid; i < W * D; i += kThreads) {
    float o = 0.f;
    for (int sp = 0; sp < kSplits; ++sp) o += sPart[sp * kW * D + i];
    const int w = i / D, d = i % D;
    a.part_o[((((long)b * a.n_chunks + chunk) * H + h) * W + w) * D + d] = o;
  }
  PAGED_TRACE(7);
}

// The merge, grid (head, row): a thread owns (group, query, 4 columns)
// and folds every G-th live chunk of the row in chunk order by the
// log-sum-exp rule (the running max, sum and o rescaled to each new max),
// then the G groups fold the same way in group order: one pass over the
// workspace, in the same order every call.
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const PagedArgs a) {
  __shared__ __align__(16) float sO[kThreads * 4];
  __shared__ float sMx[kThreads], sSum[kThreads];
  const int h = blockIdx.x, b = blockIdx.y;
  const int W = a.W, H = a.H, D = a.D;
  const int tid = threadIdx.x;
  const int CP = a.S * a.SP;
  const int virt = a.n_pt * a.P;
  const int start = a.lengths[b];
  float* ob = a.out + (long)b * W * H * D + (long)h * D;
  // launched early (programmatic dependent launch): the chunk kernel's
  // partials are read only once it has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (start >= virt) {                 // parked row
    for (int i = tid; i < W * D; i += kThreads)
      ob[(long)(i / D) * H * D + i % D] = 0.f;
    return;
  }
  const int nc = (min(virt, start + W) + CP - 1) / CP;   // live chunks
  const float* m = a.part_ml;
  const float* l = a.part_ml + (long)a.B * a.n_chunks * H * W;
  const long row = (long)b * a.n_chunks * H;             // chunk 0, head 0
  auto at = [&](int c, int w) { return (row + (long)c * H + h) * W + w; };
  const int items = W * D / 4;                 // (query, 4 columns)
  const int G = items >= kThreads ? 1 : kThreads / items;
  for (int i = tid; i < G * items; i += kThreads) {
    const int grp = i / items, it = i % items;
    const int w = it / (D / 4), d = 4 * (it % (D / 4));
    float mx = kNegInf, sum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = grp; c < nc; c += G) {
      const float mc = __ldg(m + at(c, w)), lc = __ldg(l + at(c, w));
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(a.part_o + at(c, w) * D + d));
      const float nm = fmaxf(mx, mc);
      const float s0 = expf(mx - nm), s1 = expf(mc - nm);
      sum = sum * s0 + lc * s1;
      o = make_float4(o.x * s0 + x.x * s1, o.y * s0 + x.y * s1,
                      o.z * s0 + x.z * s1, o.w * s0 + x.w * s1);
      mx = nm;
    }
    if (G == 1) {
      *reinterpret_cast<float4*>(ob + (long)w * H * D + d) =
          make_float4(o.x / sum, o.y / sum, o.z / sum, o.w / sum);
    } else {
      *reinterpret_cast<float4*>(sO + 4 * i) = o;
      sMx[i] = mx;
      sSum[i] = sum;
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int i = tid; i < W * D; i += kThreads) {
      const int it = i / 4;                    // (query, 4 columns) of i
      float mx = kNegInf;
      for (int grp = 0; grp < G; ++grp) mx = fmaxf(mx, sMx[grp * items + it]);
      float o = 0.f, sum = 0.f;
      for (int grp = 0; grp < G; ++grp) {
        const float e = expf(sMx[grp * items + it] - mx);
        o += sO[grp * W * D + i] * e;
        sum += sSum[grp * items + it] * e;
      }
      ob[(long)(i / D) * H * D + i % D] = o / sum;
    }
  }
}

// The map of a pool seen as [NP * P, H, D] with [SP, 1, D] boxes.  An
// engine passes the same pools every decode step, so the maps of this
// host thread's last 64 (pool, shape, box) are kept and reused: a map
// holds only the address, the shape and the box.
int pool_map(CUtensorMap* map, int esize, const void* pool, int D, int H,
             long long rows, int SP) {
  struct Entry {
    CUtensorMap map;
    const void* pool;
    long long rows;
    int esize, D, H, SP;
  };
  static thread_local Entry cache[64];
  static thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.pool == pool && e.rows == rows && e.esize == esize && e.D == D &&
        e.H == H && e.SP == SP) {
      *map = e.map;
      return 0;
    }
  const int err = encode_3d(map,
                            esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            esize, pool, D, H, rows, D, 1, SP);
  if (err) return err;
  cache[next] = Entry{*map, pool, rows, esize, D, H, SP};
  next = (next + 1) % 64;
  return 0;
}

template <typename T, int D, int kW>
int launch_paged(const PagedArgs& a, cudaStream_t stream) {
  CUtensorMap maps[2];
  const void* pools[2] = {a.k_pages, a.v_pages};
  for (int i = 0; i < 2; ++i) {
    const int e = pool_map(&maps[i], sizeof(T), pools[i], D, a.H,
                           (long long)a.NP * a.P, a.SP);
    if (e) return e;
  }
  const int smem = smem_layout(a.S, a.SP, kW, D, sizeof(T)).total;
  static int smem_set = 0;              // opt-in above the 48 KB default
  if (smem > 48 * 1024 && smem_set < smem) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_chunk_kernel<T, D, kW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  // a block for every (row, chunk, head): the shapes bound the live
  // items, the kernel counts them
  const int blocks = a.B * a.H * a.n_chunks;
  paged_chunk_kernel<T, D, kW>
      <<<blocks, kThreads, smem, stream>>>(a, maps[0], maps[1]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the merge may launch while the chunk kernel runs and waits for it in
  // `griddepcontrol.wait`: its launch latency hides behind the chunks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_merge_kernel, a);
}

template <typename T, int D>
int dispatch_w(const PagedArgs& a, cudaStream_t s) {
  switch (pow2_w(a.W)) {
    case 1: return launch_paged<T, D, 1>(a, s);
    case 2: return launch_paged<T, D, 2>(a, s);
    case 4: return launch_paged<T, D, 4>(a, s);
    default: return launch_paged<T, D, 8>(a, s);
  }
}

template <typename T>
int dispatch_d(const PagedArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return dispatch_w<T, 32>(a, s);
    case 64: return dispatch_w<T, 64>(a, s);
    case 128: return dispatch_w<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The chunk kernel then the merge kernel on `stream`; returns
// cudaGetLastError() after the launches (0 on success).  The plan (SP, S,
// n_chunks) comes from `paged_plan` in paged_attention.py.
int paddle_paged_decode_attention(
    const float* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* page_table,
    const int* lengths, float* out, float* part_o, float* part_ml, int B,
    int W, int H, int D, int P, int n_pt, int NP, int SP, int S,
    int n_chunks, float scale, int quant, void* stream) {
  if (W < 1 || W > kMaxW || SP < 1 || P % SP != 0 || S < 1 || S > 32 ||
      S * SP > 64 || (long)n_chunks * S * SP < (long)n_pt * P ||
      (long)B * H * n_chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  PagedArgs a{q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
              out, part_o, part_ml, B, W, H, D, P, n_pt, NP, SP, S,
              n_chunks, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return quant ? dispatch_d<int8_t>(a, s) : dispatch_d<float>(a, s);
}

#ifdef PADDLE_PAGED_TRACE
// Points the trace at `p` ([blocks][9] int64, or nullptr to stop).
int paddle_paged_set_trace(long long* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
#endif

}  // extern "C"
