// The tile GEMM that kernels A (gemm.cu), D (sparse24_gemm.cu) and E
// (block24_gemm.cu) share: C (M, N) = A (M, K) @ B (K, N) with f32
// accumulation, one thread block per (BM x BN output tile, K split).
//
// A kernel supplies an "Op": how one BK-deep K step of its A and B tiles
// reaches a shared-memory stage (dense rows, packed 2:4 values and meta, or
// x's columns gathered through kept blocks), and how a stage becomes bf16
// operand tiles (in place for bf16; fp8 widened, 2:4 decompressed into a
// separate buffer). Everything else is here:
//
// * The K loop is a ring of shared-memory stages (4; 6 for kernel E's
//   prefill). One thread copies each step's tiles with the Tensor Memory
//   Accelerator (TMA: one bulk copy per
//   64-column box, described by a tensor map the host encodes, or finds
//   in its table, per call; zero-filled past the matrix edges) and arms the stage's mbarrier with the
//   bytes to expect; the block waits on it. Steps k+1 .. k+AHEAD are in
//   flight while step k is widened or decompressed and multiplied. Operands
//   whose rows are not 16-byte aligned, which TMA cannot address, take
//   element loads into the same stages instead (no serving shape does).
// * bf16 operand tiles are rows of 128 bytes in the 128-byte swizzle, as TMA
//   writes them and wgmma reads them: every warp-wide access, TMA's own
//   included, touches whole 128-byte lines and all 32 banks. (Measured on
//   the H100 before this layout: 16-byte cp.async copies into wgmma's
//   unswizzled core matrices, and TMA boxes 16 bytes wide, each moved half a
//   line per request and ran at half the bytes per second.)
// * Three tiles (the planner in kernels/gemm_plan.py picks one and mirrors
//   this table): Small, M <= 16 (decode), 16 x 64 x 64, four warps each
//   multiplying 16 columns with mma.sync m16n8k16 fed by ldmatrix -- wgmma's
//   64-row minimum would waste 15/16 of every product on these bytes-bound
//   shapes; Wide, M > 16 (prefill), 128 x 128 x 64, two warpgroups each
//   issuing bf16 wgmma.mma_async m64n128k16 for 64 rows (A K-major, B N-major
//   through the transpose bit or K-major), the f32 sums in registers; Deep,
//   kernel E's Wide with a ring of 6 stages. Wide keeps one step's wgmma
//   running while the next step's copies are issued.
// * Split-K: the planner cuts K into `splits` ranges of whole BK steps so
//   that the grid (m tiles, n tiles, splits) fills the card. With one split a
//   block writes C itself. Otherwise each block writes its f32 partial sums
//   to its split's slice of a workspace (splits, M, N); the last block of a
//   tile to arrive (a per-tile counter, which that block resets to 0) sums
//   the slices in split order 0 .. splits-1 and rounds once into C. No float
//   atomics: the same plan gives the same bits on every run. Each stream
//   has a workspace and counters of its own (gemm_plan.StreamScratch), so
//   launches on two streams never mix their partial sums.
// * Batches: a launch may carry `batch` independent products of one shape
//   (kernel A's expert stacks, A (E, M, K) @ B (E, K, N) -> C (E, M, N)).
//   The grid's z axis is batch x splits, each batch index with its own
//   slices of C, the workspace and the counters; its operands are
//   addressed through 3-D tensor maps, so TMA zero-fills at each member's
//   own edges and never reads a neighbour's rows.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <mutex>

#include "warp_ops.cuh"

namespace tile_gemm {

enum { IN_BF16 = 0, IN_E4M3 = 1, IN_E5M2 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1 };
enum { TILE_SMALL = 0, TILE_WIDE = 1, TILE_DEEP = 2 };
// What an Op's operands() wrote into shared memory: nothing, only what its
// own warp reads, or what the whole block reads.
enum { WROTE_NONE = 0, WROTE_WARP = 1, WROTE_BLOCK = 2 };

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int round1024(int n) {
  return (n + 1023) / 1024 * 1024;
}

// Operand types: their raw bits, the bf16 bits of one value (e4m3 and e5m2
// widen to bf16 exactly) and its f32 value.
template <int IT> struct In;
template <> struct In<IN_BF16> {
  typedef uint16_t bits;
  static __device__ __forceinline__ uint32_t bf16_bits(uint32_t b) {
    return b & 0xffffu;
  }
  static __device__ __forceinline__ float f32(uint32_t b) {
    return __uint_as_float(b << 16);
  }
};
template <> struct In<IN_E4M3> {
  typedef uint8_t bits;
  static __device__ __forceinline__ float f32(uint32_t b) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  }
  static __device__ __forceinline__ uint32_t bf16_bits(uint32_t b) {
    return __bfloat16_as_ushort(__float2bfloat16(f32(b)));
  }
};
template <> struct In<IN_E5M2> {
  typedef uint8_t bits;
  static __device__ __forceinline__ float f32(uint32_t b) {
    __nv_fp8_e5m2 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  }
  static __device__ __forceinline__ uint32_t bf16_bits(uint32_t b) {
    return __bfloat16_as_ushort(__float2bfloat16(f32(b)));
  }
};

// ---------------------------------------------------------------------------
// Tensor maps (host)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda).
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      return static_cast<EncodeTiledFn>(nullptr);
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// The (rows, cols) row-major matrix of `esize`-byte elements at `base` as
// box_rows x box_cols tiles. Needs a 16-byte aligned base, cols * esize %
// 16 == 0 and box_cols * esize % 16 == 0. With `swizzle` (box rows of
// exactly 128 bytes) a tile lands in the 128-byte swizzle of sw128 below,
// else row-major. Past the edges: zeros. With `depth` >= 1 the map is 3-D,
// `depth` such matrices one after another (boxes one matrix deep, copied
// by tma_3d); with 0 it is 2-D (tma_2d).
//
// A map is a pure function of these arguments, so the last map of each
// argument set is kept in a small table (a decode step encodes the same
// weights' maps 225 times; the activations' addresses recur too). The
// table is locked: callers may come from more than one host thread.
inline bool encode_tiles(CUtensorMap* m, const void* base, int esize,
                         int rows, int cols, int box_rows, int box_cols,
                         bool swizzle, int depth = 0) {
  struct Key {
    const void* base;
    int esize, rows, cols, box_rows, box_cols, swizzle, depth;
    bool operator==(const Key& o) const {
      return base == o.base && esize == o.esize && rows == o.rows &&
             cols == o.cols && box_rows == o.box_rows &&
             box_cols == o.box_cols && swizzle == o.swizzle &&
             depth == o.depth;
    }
  };
  constexpr int SLOTS = 4096;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static bool used[SLOTS];
  static std::mutex lock;
  const Key key{base, esize, rows, cols, box_rows, box_cols, swizzle, depth};
  size_t h = reinterpret_cast<uintptr_t>(base) >> 4;
  for (int v : {esize, rows, cols, box_rows, box_cols, int(swizzle), depth})
    h = h * 1000003u ^ static_cast<size_t>(v);
  const int slot = static_cast<int>(h % SLOTS);
  std::lock_guard<std::mutex> guard(lock);
  if (used[slot] && keys[slot] == key) {
    *m = maps[slot];
    return true;
  }
  const EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(depth > 0 ? depth : 1)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * esize,
                                 cuuint64_t(rows) * cols * esize};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (fn(m, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
         depth > 0 ? 3 : 2, const_cast<void*>(base), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[slot] = key;
  maps[slot] = *m;
  used[slot] = true;
  return true;
}

// ---------------------------------------------------------------------------
// Shared memory, mbarriers and TMA (device)
// ---------------------------------------------------------------------------

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival a stage's barrier waits for, with the bytes its copies
// will deliver.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The box at (c0, c1) of matrix c2 of a 3-D map (encode_tiles' depth).
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// One 16-byte chunk by element loads: `valid` elements of T from p, zeros
// after them.
template <class T>
__device__ __forceinline__ void load_chunk(void* dst, const T* p, int valid) {
  constexpr int PW = 4 / sizeof(T);  // elements per 32-bit word
  uint32_t w[4] = {0, 0, 0, 0};
  for (int j = 0; j < valid; ++j)
    w[j / PW] |= uint32_t(p[j]) << (8 * sizeof(T) * (j % PW));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The element-load path for an operand TMA cannot address: the ROWS x COLS
// tile at (r0, c0) of a row-major (n_rows, n_cols) array of T, chunk (r, c)
// (c a multiple of 16 / sizeof(T)) to dst(r, c), zeros past the edges.
template <class T, int ROWS, int COLS, int NT, class Dst>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int n_rows, int n_cols, int r0,
                                          int c0, Dst dst, int tid) {
  constexpr int V = 16 / sizeof(T), CPR = COLS / V, CHUNKS = ROWS * CPR;
  for (int c = tid; c < CHUNKS; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * V;
    const int gr = r0 + r, gc = c0 + cc;
    const int valid = (gr < n_rows && gc < n_cols) ? min(V, n_cols - gc) : 0;
    load_chunk<T>(dst(r, cc), src + (size_t)gr * n_cols + gc, valid);
  }
}

// Widen 16 fp8 bytes to 16 bf16 values, as two 16-byte chunks.
template <int IT>
__device__ __forceinline__ void widen16(uint4 v, void* lo, void* hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = In<IT>::bf16_bits(w[i] & 0xffu) |
               (In<IT>::bf16_bits((w[i] >> 8) & 0xffu) << 16);
    o[2 * i + 1] = In<IT>::bf16_bits((w[i] >> 16) & 0xffu) |
                   (In<IT>::bf16_bits(w[i] >> 24) << 16);
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(o[4], o[5], o[6], o[7]);
}

// ---------------------------------------------------------------------------
// Output: C directly, or a split's slice of the workspace
// ---------------------------------------------------------------------------

struct Out {
  void* c;
  float* ws;       // (splits, M, N) f32 partial sums; unused with one split
  int* counters;   // one per output tile, 0 between launches
  int M, N, out_type, splits;

  // Batch member e's C, workspace and counters (`tiles` per member).
  __device__ __forceinline__ Out member(int e, int tiles) const {
    Out o = *this;
    const size_t mn = (size_t)M * N;
    o.c = static_cast<unsigned char*>(c) +
          e * mn * (out_type == OUT_F32 ? 4 : 2);
    if (splits > 1) {
      o.ws = ws + (size_t)e * splits * mn;
      o.counters = counters + (size_t)e * tiles;
    }
    return o;
  }

  __device__ __forceinline__ void store(size_t o, float v) const {
    if (out_type == OUT_F32)
      static_cast<float*>(c)[o] = v;
    else
      static_cast<bf16*>(c)[o] = __float2bfloat16(v);
  }
  __device__ __forceinline__ void store4(size_t o, float4 v) const {
    if (out_type == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(c) + o) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(c) + o) = w;
    }
  }
  // Columns gn .. gn + 3 of row gm.
  __device__ __forceinline__ void put4(int split, int gm, int gn,
                                       float4 v) const {
    if (gm >= M || gn >= N) return;
    if (N % 4 == 0) {
      const size_t o = (size_t)gm * N + gn;
      if (splits == 1)
        store4(o, v);
      else
        *reinterpret_cast<float4*>(ws + (size_t)split * M * N + o) = v;
      return;
    }
    put(split, gm, gn, v.x);
    put(split, gm, gn + 1, v.y);
    put(split, gm, gn + 2, v.z);
    put(split, gm, gn + 3, v.w);
  }
  __device__ __forceinline__ void put(int split, int gm, int gn,
                                      float v) const {
    if (gm >= M || gn >= N) return;
    const size_t o = (size_t)gm * N + gn;
    if (splits == 1)
      store(o, v);
    else
      ws[(size_t)split * M * N + o] = v;
  }
};

// ---------------------------------------------------------------------------
// Operand layouts: rows of 128 bytes (64 bf16) in the 128-byte swizzle
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk `chunk` of row `row`: within each 1024-byte
// group of eight rows, chunk j of row r sits at j ^ (r % 8). TMA writes it,
// wgmma reads it (layout type 1), and ldmatrix and the element paths
// address it here; every 8 x 16-byte piece they touch spans all banks.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return (row << 7) + ((chunk ^ (row & 7)) << 4);
}
// A (BM x 64, K-major): row m, k.
__device__ __forceinline__ int a_off(int m, int k) {
  return sw128(m, k >> 3) + ((k & 7) << 1);
}
// B (BK x BN, N-major, element (k, n)): 64-column halves of BK rows each.
template <int BK>
__device__ __forceinline__ int b_off(int k, int n) {
  return (n >> 6) * BK * 128 + sw128(k, (n & 63) >> 3) + ((n & 7) << 1);
}
// B stored K-major (BN x 64): element (k, n) in row n.
__device__ __forceinline__ int bt_off(int n, int k) {
  return sw128(n, k >> 3) + ((k & 7) << 1);
}

// ---------------------------------------------------------------------------
// The two tiles
// ---------------------------------------------------------------------------

// Small (M <= 16): warp w multiplies columns 16w .. 16w + 15 as two 16 x 8
// blocks; ldmatrix reads each 8 x 8 piece of A and B as eight swizzled
// 16-byte rows.
struct Small {
  static constexpr bool WIDE = false;
  static constexpr int BM = 16, BN = 64, BK = 64, NT = 128, STAGES = 4;
  static constexpr int WN = BN / 4, NB = WN / 8;  // columns, blocks a warp
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  struct Acc {
    float d[NB][4];
  };
  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.d[j][i] = 0.0f;
  }
  template <bool B_KMAJOR>
  static __device__ __forceinline__ void mma(Acc& acc, const unsigned char* A,
                                             const unsigned char* B, int tid) {
    const int lane = tid % 32, n0 = (tid / 32) * WN;
    const int i = lane & 7, j = lane >> 3;  // row of piece j of an x4 load
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      // A pieces: rows 0-7 / 8-15 by k 0-7, then by k 8-15
      ldmatrix_x4(a, A + a_off(i + 8 * (j & 1), kk + 8 * (j >> 1)));
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        const int n = n0 + 16 * p;
        uint32_t b[4];
        if constexpr (B_KMAJOR)  // n 0-7 by k 0-7 / 8-15, then n 8-15
          ldmatrix_x4(b, B + bt_off(n + i + 8 * (j >> 1), kk + 8 * (j & 1)));
        else  // k 0-7 / 8-15 by n 0-7, then by n 8-15 (transposed)
          ldmatrix_x4_trans(b, B + b_off<BK>(kk + i + 8 * (j & 1),
                                             n + 8 * (j >> 1)));
        mma_16816(acc.d[2 * p], a, b[0], b[1]);
        mma_16816(acc.d[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  static __device__ __forceinline__ void drain(Acc&) {}
  // Thread t holds rows t % 32 / 4 (+ 8), columns 2 * (t % 4) (+ 1) of
  // each 16 x 8 block.
  static __device__ __forceinline__ void epilogue(Acc& acc, unsigned char*,
                                                  const Out& out, int m0,
                                                  int n0, int split, int tid) {
    const int lane = tid % 32;
    const int r = m0 + lane / 4;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = n0 + (tid / 32) * WN + 8 * j + 2 * (lane % 4);
      out.put(split, r, c, acc.d[j][0]);
      out.put(split, r, c + 1, acc.d[j][1]);
      out.put(split, r + 8, c, acc.d[j][2]);
      out.put(split, r + 8, c + 1, acc.d[j][3]);
    }
  }
};

// A shared-memory matrix descriptor: address, leading and stride byte
// offsets, 128-byte swizzle (layout type 1; the tiles are 1024-byte
// aligned, so the base offset is 0).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32) += A (64 x 16, K-major) @ B (16 x 128): scale-d 1, A and
// B unscaled, A not transposed, B N-major (TRANS_B = 1) or K-major (0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Wide (M > 16): two warpgroups, each issuing wgmma m64n128k16 for 64 rows
// of the 128 x 128 tile, the f32 sums in registers (64 a thread). Kernels A
// and D run a ring of 4 stages (Wide). Kernel E's prefill runs 6 (Deep): its
// 112 tiles fill one partial wave with no split (kernels/gemm_plan.py), and
// 4 steps in flight where Wide has 2 keep its short K loop of 32 steps
// reading at the rate of the whole card.
template <int STAGES_>
struct WideT {
  static constexpr bool WIDE = true;
  static constexpr int BM = 128, BN = 128, BK = 64, NT = 256,
                       STAGES = STAGES_;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  struct Acc {
    float d[BN / 2];
  };
  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0.0f;
  }

  // K-major operands (A, D's B): eight-row groups 1024 bytes apart, a k16
  // step 32 bytes on inside the swizzled row. N-major B: eight-row groups
  // 1024 bytes apart, a k16 step 16 rows on, the 64-column halves BK * 128
  // bytes apart.
  template <bool B_KMAJOR>
  static __device__ __forceinline__ void mma(Acc& acc, const unsigned char* A,
                                             const unsigned char* B, int tid) {
    const unsigned char* Aw = A + 64 * 128 * (tid / 128);  // this group's rows
    fence_operands(acc.d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const uint64_t da = smem_desc(Aw + 2 * kk, 16, 1024);
      if constexpr (B_KMAJOR) {
        wgmma_m64n128k16<0>(acc.d, da, smem_desc(B + 2 * kk, 16, 1024));
      } else {
        wgmma_m64n128k16<1>(acc.d, da,
                            smem_desc(B + 128 * kk, BK * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done
    fence_operands(acc.d);
  }
  static __device__ __forceinline__ void drain(Acc& acc) {
    wgmma_wait<0>();
    fence_operands(acc.d);
  }
  // Thread t holds, for each 8-column block j, rows 16 * (t / 32) +
  // t % 32 / 4 (+ 8) and columns 8j + 2 * (t % 4) (+ 1). The tile goes
  // through shared memory (the drained ring) so that rows leave in 16-byte
  // pieces.
  static constexpr int LDC = BN + 4;
  static constexpr int C_BYTES = BM * LDC * 4;
  static __device__ __forceinline__ void epilogue(Acc& acc, unsigned char* smem,
                                                  const Out& out, int m0,
                                                  int n0, int split, int tid) {
    float* cs = reinterpret_cast<float*>(smem);
    const int lane = tid % 32;
    const int r = 16 * (tid / 32) + lane / 4;
    __syncthreads();  // every warpgroup is done with the ring
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(cs + r * LDC + c) =
          make_float2(acc.d[4 * j], acc.d[4 * j + 1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * LDC + c) =
          make_float2(acc.d[4 * j + 2], acc.d[4 * j + 3]);
    }
    __syncthreads();
    for (int e = tid; e < BM * BN / 4; e += NT) {
      const int rr = e / (BN / 4), cc = (e % (BN / 4)) * 4;
      out.put4(split, m0 + rr, n0 + cc,
               *reinterpret_cast<const float4*>(cs + rr * LDC + cc));
    }
  }
};
typedef WideT<4> Wide;
typedef WideT<6> Deep;

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// With more than one split: once every block of this output tile has
// written its slice, the last to arrive sums the slices in split order and
// writes C, and resets the tile's counter for the next launch.
template <class C>
__device__ __forceinline__ void finish_split(const Out& out, int m0, int n0,
                                             int tid) {
  if (out.splits == 1) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = out.counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(ctr, 1) == out.splits - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = (size_t)out.M * out.N;
  if (out.N % 4 == 0) {  // four columns at a time, 16-byte aligned
    for (int e = tid; e < C::BM * C::BN / 4; e += C::NT) {
      const int gm = m0 + e / (C::BN / 4), gn = n0 + (e % (C::BN / 4)) * 4;
      if (gm >= out.M || gn >= out.N) continue;
      const size_t o = (size_t)gm * out.N + gn;
      const float4* p = reinterpret_cast<const float4*>(out.ws + o);
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int z = 0; z < out.splits; ++z) {
        const float4 v = __ldcg(p + z * (mn / 4));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      out.store4(o, s);
    }
    return;
  }
  for (int e = tid; e < C::BM * C::BN; e += C::NT) {
    const int gm = m0 + e / C::BN, gn = n0 + e % C::BN;
    if (gm >= out.M || gn >= out.N) continue;
    const size_t o = (size_t)gm * out.N + gn;
    float s = 0.0f;
    for (int z = 0; z < out.splits; ++z) s += __ldcg(out.ws + z * mn + o);
    out.store(o, s);
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) computes output tile (m0, n0)
// of batch member e = blockIdx.z / splits over K steps [split * per,
// (split + 1) * per) of the k_extent-deep product, split = blockIdx.z %
// splits.
template <class C, class Op>
__global__ void __launch_bounds__(C::NT)
tile_kernel(const __grid_constant__ Op op, const Out batch_out, int k_extent,
            int per) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ __align__(8) uint64_t full[C::STAGES];
  const int tid = threadIdx.x;
  const int split = blockIdx.z % batch_out.splits;
  const int e = blockIdx.z / batch_out.splits;
  const Out out = batch_out.member(e, gridDim.x * gridDim.y);
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int k_begin = split * per * C::BK;
  const int k_end = min(k_extent, k_begin + per * C::BK);
  const int nsteps = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK
                                     : 0;
  unsigned char* buf = smem + C::STAGES * Op::STAGE_BYTES;
  auto stage = [&](int i) { return smem + (i % C::STAGES) * Op::STAGE_BYTES; };
  // Steps in flight ahead of the one multiplied. Small's mma.sync is done
  // when the step ends, so its stage is free at once; Wide leaves one step's
  // wgmma running into the next, so a stage (and the converted operands,
  // two buffers) is reused two steps later.
  constexpr int AHEAD = C::WIDE ? C::STAGES - 2 : C::STAGES - 1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    fence_proxy_async();
  }
  __syncthreads();

  typename C::Acc acc;
  C::init(acc);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s)
    if (s < nsteps)
      op.load(k_begin + s * C::BK, stage(s), m0, n0, e, tid, &full[s]);
  for (int i = 0; i < nsteps; ++i) {
    mbar_wait(&full[i % C::STAGES], (i / C::STAGES) & 1);  // step i landed
    if constexpr (C::WIDE) fence_proxy_async();
    __syncthreads();  // element loads of step i are in too, and the stage
                      // refilled next has no reader left
    const int nx = i + AHEAD;
    if (nx < nsteps)
      op.load(k_begin + nx * C::BK, stage(nx), m0, n0, e, tid,
              &full[nx % C::STAGES]);
    const unsigned char *A, *B;
    const int wrote = op.operands(
        stage(i), buf + (C::WIDE ? (i & 1) * Op::BUF_BYTES : 0), A, B, tid);
    if (wrote == WROTE_BLOCK) {
      if constexpr (C::WIDE) fence_proxy_async();
      __syncthreads();
    } else if (wrote == WROTE_WARP) {
      __syncwarp();
    }
    C::template mma<Op::B_KMAJOR>(acc, A, B, tid);
  }
  C::drain(acc);
  C::epilogue(acc, smem, out, m0, n0, split, tid);
  finish_split<C>(out, m0, n0, tid);
}

// Launches Op's kernel with the plan (splits ranges of `per` BK steps,
// every one non-empty) for `batch` members. Sets the dynamic shared-memory
// limit of each instantiation once (the port drives one card). Returns the
// CUDA status.
template <class C, class Op>
int launch(const Op& op, void* c, void* ws, void* counters, int M, int N,
           int k_extent, int out_type, int splits, int per,
           cudaStream_t stream, int batch = 1) {
  const bool plan_ok =
      batch >= 1 && (long long)batch * splits <= 65535 &&
      splits >= 1 && per >= 1 &&
      (long long)splits * per * C::BK >= k_extent &&
      ((long long)(splits - 1) * per * C::BK < k_extent || splits == 1) &&
      (splits == 1 || (ws != nullptr && counters != nullptr));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int RING =
      C::STAGES * Op::STAGE_BYTES + Op::BUF_BYTES * (C::WIDE ? 2 : 1);
  static_assert(!C::WIDE || RING >= Wide::C_BYTES, "epilogue fits the ring");
  constexpr int SMEM = RING + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_kernel<C, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Out out{c, static_cast<float*>(ws), static_cast<int*>(counters),
                M, N, out_type, splits};
  // M tiles fastest: blocks that share a weight tile run together, so the
  // second reads it from L2
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN,
                  batch * splits);
  tile_kernel<C, Op><<<grid, C::NT, SMEM, stream>>>(op, out, k_extent, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile_gemm
