// The tile GEMM that kernels A (gemm.cu), D (sparse24_gemm.cu) and E
// (block24_gemm.cu) share: one thread block per BM x BN output tile of
// C (M, N), the K loop inside the block, bf16 operand tiles in shared memory
// multiplied with WMMA 16x16x16 fragments into f32 accumulators, and a
// masked f32 or bf16 epilogue. A kernel supplies only how a K step's A and B
// tiles are staged (dense rows, a decompressed 2:4 tile, or x's columns
// gathered through kept blocks) and its table of tile shapes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <stdint.h>

namespace wmma_tile {

enum { IN_BF16 = 0, IN_E4M3 = 1, IN_E5M2 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1 };
constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

// Operand types: their raw bits and the bf16 bits of one value (e4m3 and
// e5m2 widen to bf16 exactly).
template <int IT> struct In;
template <> struct In<IN_BF16> {
  typedef uint16_t bits;
  static __device__ __forceinline__ uint16_t bf16_bits(uint32_t b) {
    return static_cast<uint16_t>(b);
  }
};
template <> struct In<IN_E4M3> {
  typedef uint8_t bits;
  static __device__ __forceinline__ uint16_t bf16_bits(uint32_t b) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(v)));
  }
};
template <> struct In<IN_E5M2> {
  typedef uint8_t bits;
  static __device__ __forceinline__ uint16_t bf16_bits(uint32_t b) {
    __nv_fp8_e5m2 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(v)));
  }
};

// Store one 16-byte chunk of raw operand bits into shared memory as bf16.
template <int IT>
__device__ __forceinline__ void store_chunk(uint4 raw, __nv_bfloat16* dst) {
  if constexpr (IT == IN_BF16) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = In<IT>::bf16_bits(w[i] & 0xffu) |
                 (uint32_t(In<IT>::bf16_bits((w[i] >> 8) & 0xffu)) << 16);
      o[2 * i + 1] = In<IT>::bf16_bits((w[i] >> 16) & 0xffu) |
                     (uint32_t(In<IT>::bf16_bits(w[i] >> 24)) << 16);
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// Stage a ROWS x COLS tile of a row-major (n_rows, n_cols) operand whose
// top-left corner is (r0, c0) into shared memory as bf16 (leading dim LD).
// A thread takes 16-byte chunks of a row: a chunk wholly inside the matrix
// is one vector load when ``vec`` holds (16-byte aligned base and rows),
// else element loads; what lies outside is +0. All loads are issued before
// the first store, so a block keeps a whole tile in flight.
template <int IT, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(
    const typename In<IT>::bits* __restrict__ src, int n_rows, int n_cols,
    int r0, int c0, bool vec, __nv_bfloat16* dst, int tid) {
  typedef typename In<IT>::bits T;
  constexpr int VEC = 16 / sizeof(T);           // elements per chunk
  constexpr int PW = 4 / sizeof(T);             // elements per 32-bit word
  constexpr int CPR = COLS / VEC;               // chunks per row
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % NT == 0, "tile must split evenly over threads");
  constexpr int PER = CHUNKS / NT;
  uint4 raw[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * NT;
    const int gr = r0 + c / CPR, gc = c0 + (c % CPR) * VEC;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (gr >= n_rows || gc >= n_cols) continue;
    const T* p = src + (size_t)gr * n_cols + gc;
    if (vec && gc + VEC <= n_cols) {
      raw[i] = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; j < VEC && gc + j < n_cols; ++j)
        w[j / PW] |= uint32_t(p[j]) << (8 * sizeof(T) * (j % PW));
      raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * NT;
    store_chunk<IT>(raw[i], dst + (c / CPR) * LD + (c % CPR) * VEC);
  }
}

// Shapes of a BM x BN output tile, BK-deep K steps and WM x WN warp tiles.
template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = (BM / WM) * WARPS_N * 32;  // threads per block
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int LDA = BK + PAD, LDB = BN + PAD, LDC = BN + 4;
  static constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static dim3 grid(int M, int N) {
    return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
  }
};

// The block's output tile, rows blockIdx.y * BM and columns blockIdx.x * BN
// of C (M, N). For each k0 in [0, k_extent) in steps of BK, stage(k0, As, Bs)
// fills As (BM x BK, leading dim LDA) and Bs (BK x BN, leading dim LDB) with
// bf16, zeros past the operands' edges; the warps then multiply them. The
// f32 sums are written where they lie inside C, as f32 or bf16.
template <int BM, int BN, int BK, int WM, int WN, class Stage>
__device__ __forceinline__ void tile_gemm(int k_extent, void* __restrict__ c_,
                                          int M, int N, int out_type,
                                          Stage stage) {
  using namespace nvcuda;
  typedef Tile<BM, BN, BK, WM, WN> T;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * T::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k_extent; k0 += BK) {
    stage(k0, As, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * T::LDA + kk,
                               T::LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * T::LDB + wn * WN + j * 16,
                               T::LDB);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * WM + i * 16) * T::LDC + wn * WN + j * 16, acc[i][j],
          T::LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += T::NT) {
    const int r = e / BN, cc = e % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      const float v = Cs[r * T::LDC + cc];
      const size_t o = (size_t)gm * N + gn;
      if (out_type == OUT_F32)
        static_cast<float*>(c_)[o] = v;
      else
        static_cast<__nv_bfloat16*>(c_)[o] = __float2bfloat16(v);
    }
  }
}

}  // namespace wmma_tile
