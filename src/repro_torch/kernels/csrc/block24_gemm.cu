// Kernel E: block-2:4 tile-skipping GEMM
//   C (M, N) = X[:, kept columns] (M, K/2) @ W_packed (K/2, N),
// f32 accumulation, M * N * K/2 multiply-adds.
//
// Replaces src/repro/kernels/sparse24_matmul.py::block24_matmul_pallas (its
// inner ``kernel``). The weight was pruned offline to keep 2 of every 4
// consecutive K-blocks of ``block`` rows (core/sparsity.py prune_block24);
// W_packed holds the kept blocks back to back, and kept[kb] names the dense
// K-block that packed block kb came from. X, W_packed are bf16; the output is
// f32 or bf16.
//
// What bounds it on the H100: at decode (M = 4) the time is the W_packed
// read, K/2 * N bf16 values, over 3.35 TB/s; at large M it would be the
// tensor cores, with half the dense product's work.
//
// Design: the TPU kernel walked the kept blocks along a sequential grid axis
// whose BlockSpec index map looked kept_idx up at compile time. Here kept is
// a device int32 array and one thread block per BM x BN output tile runs the
// K loop over the packed K/2 rows. Each K step stages a BK x BN tile of
// W_packed and the matching BM x BK tile of X, whose 8-column chunks each
// find their dense column through kept (block % 8 == 0 keeps a chunk inside
// one block), in shared memory with 16-byte loads, and multiplies them with
// WMMA 16x16x16 bf16 fragments into f32 accumulators: the tile GEMM of
// kernel A (wmma_tile.cuh), which stages W_packed as kernel A stages B.
// Ragged M, N and K/2 are masked (the TPU kernel asserted divisibility).
#include "wmma_tile.cuh"

namespace {

using namespace wmma_tile;

// The dense column of packed column kg.
__device__ __forceinline__ int dense_col(const int* __restrict__ kept,
                                         int block, int kg) {
  return kept[kg / block] * block + kg % block;
}

// Stage a ROWS x COLS tile of packed columns [c0, c0 + COLS) of X's gathered
// view (n_rows, n_cols = K/2) in shared memory (leading dim LD). With ``vec``
// (16-byte aligned base, K % 8 == 0 and block % 8 == 0) an 8-column chunk is
// one 16-byte load; otherwise each element is loaded on its own.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_x_gathered(
    const uint16_t* __restrict__ x, int n_rows, int K, int n_cols,
    const int* __restrict__ kept, int block, int r0, int c0, bool vec,
    __nv_bfloat16* dst, int tid) {
  constexpr int CPR = COLS / 8;
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % NT == 0, "tile must split evenly over threads");
  constexpr int PER = CHUNKS / NT;
  uint4 raw[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * NT;
    const int gr = r0 + c / CPR, gc = c0 + (c % CPR) * 8;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (gr >= n_rows || gc >= n_cols) continue;
    const uint16_t* row = x + (size_t)gr * K;
    if (vec && gc + 8 <= n_cols) {
      raw[i] = *reinterpret_cast<const uint4*>(row + dense_col(kept, block, gc));
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; j < 8 && gc + j < n_cols; ++j)
        w[j >> 1] |= uint32_t(row[dense_col(kept, block, gc + j)])
                     << (16 * (j & 1));
      raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * NT;
    *reinterpret_cast<uint4*>(dst + (c / CPR) * LD + (c % CPR) * 8) = raw[i];
  }
}

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
block24_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
               const int* __restrict__ kept, void* __restrict__ c_, int M,
               int N, int K, int block, int out_type, int vec_x, int vec_w) {
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  const int Kh = K / 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  tile_gemm<BM, BN, BK, WM, WN>(
      Kh, c_, M, N, out_type,
      [=](int k0, __nv_bfloat16* As, __nv_bfloat16* Bs) {
        load_x_gathered<BM, BK, Tl::LDA, Tl::NT>(x, M, K, Kh, kept, block, m0,
                                                 k0, vec_x, As, tid);
        load_tile<IN_BF16, BK, BN, Tl::LDB, Tl::NT>(w, Kh, N, k0, n0, vec_w,
                                                    Bs, tid);
      });
}

template <int BM, int BN, int BK, int WM, int WN>
void launch(const void* x, const void* w, const int* kept, void* c, int M,
            int N, int K, int block, int out_type, int vec_x, int vec_w,
            cudaStream_t stream) {
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  block24_kernel<BM, BN, BK, WM, WN><<<Tl::grid(M, N), Tl::NT, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), kept,
      c, M, N, K, block, out_type, vec_x, vec_w);
}

}  // namespace

// x (M, K) bf16; w (K/2, N) bf16; kept (K/2/block,) int32 dense block
// indices; c (M, N) of out_type (0 f32, 1 bf16). K % 2 == 0, block > 0.
// vec_x: x's base is 16-byte aligned, K % 8 == 0 and block % 8 == 0.
// vec_w: w's base is 16-byte aligned and N % 8 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_block24_gemm(const void* x, const void* w,
                                  const void* kept, void* c, int M, int N,
                                  int K, int block, int out_type, int vec_x,
                                  int vec_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 2 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* k = static_cast<const int*>(kept);
  if (M <= 16)
    launch<16, 64, 128, 16, 16>(x, w, k, c, M, N, K, block, out_type, vec_x,
                                vec_w, s);
  else
    launch<64, 128, 64, 32, 32>(x, w, k, c, M, N, K, block, out_type, vec_x,
                                vec_w, s);
  return static_cast<int>(cudaGetLastError());
}
