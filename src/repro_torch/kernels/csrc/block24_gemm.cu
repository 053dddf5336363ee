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
// a device int32 array, and the tile GEMM of tile_gemm.cuh (shared with
// kernels A and D) runs the K loop over the packed K/2 rows through its TMA
// ring: W_packed's tile is copied as kernel A copies B, and X's tile is an
// address map -- with block % 64 == 0 a K step's 64 packed columns are 64
// dense columns of one kept block, one TMA copy from the column kept names
// (other blocks take element loads through kept). Ragged M, N and K/2 are
// zero-filled (the TPU kernel asserted divisibility).
//
// E's schedule is its own (kernels/gemm_plan.py). Decode (M <= 16): the
// Small tile, mma.sync m16n8k16, one block per 64 output columns and no
// split of K (224 blocks at N = 14336): E's K/2 is half of A's K, and a
// split's fix-up cost more than its blocks gained. Prefill: the Deep tile,
// wgmma m64n128k16 over a 6-stage ring. Its 112 tiles at N = 14336 leave 20
// of 132 SMs idle, and K/2 = 2048 is only 32 steps; with 4 steps in flight
// per block, where A's ring keeps 2, the busy SMs read the weight at the
// card's rate. (Timed against it: a stream-K schedule over 132 persistent
// blocks and a 128 x 64 tile at two blocks per SM, both slower: PERF.md.)
#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

template <class C>
struct Block24Op {
  static constexpr int STAGE_BYTES = round1024(C::A_BYTES) + C::B_BYTES;
  static constexpr int BUF_BYTES = 0;
  static constexpr bool B_KMAJOR = false;

  CUtensorMap mx, mw;  // used where tma_x / tma_w
  const uint16_t* x;
  const uint16_t* w;
  const int* kept;
  int M, N, K, block;
  bool tma_x, tma_w;

  // The dense column of packed column kg.
  __device__ __forceinline__ int dense_col(int kg) const {
    return kept[kg / block] * block + kg % block;
  }

  // X's tile is an address map: with block % 64 == 0 the BK = 64 packed
  // columns of a step come from 64 dense columns of one kept block, one
  // copy (past K/2 the copy starts past K, which TMA fills with zeros).
  __device__ __forceinline__ void load(int k0, unsigned char* st, int m0,
                                       int n0, int /* one member */, int tid,
                                       uint64_t* bar) const {
    unsigned char* bs = st + round1024(C::A_BYTES);
    const int Kh = K / 2;
    if (tid == 0) {
      mbar_expect(bar, (tma_x ? C::A_BYTES : 0) + (tma_w ? C::B_BYTES : 0));
      if (tma_x) tma_2d(st, &mx, k0 < Kh ? dense_col(k0) : K, m0, bar);
      if (tma_w)
#pragma unroll
        for (int h = 0; h < C::BN / 64; ++h)
          tma_2d(bs + h * C::BK * 128, &mw, n0 + 64 * h, k0, bar);
    }
    if (!tma_x) {
      for (int c = tid; c < C::BM * C::BK / 8; c += C::NT) {
        const int r = c % C::BM, cc = (c / C::BM) * 8;
        const int gr = m0 + r, gk = k0 + cc;
        const int valid = (gr < M && gk < Kh) ? min(8, Kh - gk) : 0;
        const uint16_t* row = x + (size_t)gr * K;
        uint32_t v[4] = {0, 0, 0, 0};
        for (int j = 0; j < valid; ++j)
          v[j >> 1] |= uint32_t(row[dense_col(gk + j)]) << (16 * (j & 1));
        *reinterpret_cast<uint4*>(st + a_off(r, cc)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (!tma_w)
      load_tile<uint16_t, C::BK, C::BN, C::NT>(
          w, Kh, N, k0, n0,
          [=](int r, int c) { return bs + b_off<C::BK>(r, c); }, tid);
  }

  __device__ __forceinline__ int operands(unsigned char* st, unsigned char*,
                                           const unsigned char*& A,
                                           const unsigned char*& B,
                                           int) const {
    A = st;
    B = st + round1024(C::A_BYTES);
    return WROTE_NONE;
  }
};

template <class C>
int run(const void* x, const void* w, const int* kept, void* c, int M, int N,
        int K, int block, int out_type, int vec_x, int vec_w, int splits,
        int per, void* ws, void* counters, cudaStream_t s) {
  Block24Op<C> op{};
  op.x = static_cast<const uint16_t*>(x);
  op.w = static_cast<const uint16_t*>(w);
  op.kept = kept;
  op.M = M;
  op.N = N;
  op.K = K;
  op.block = block;
  op.tma_x = vec_x && encode_tiles(&op.mx, x, 2, M, K, C::BM, 64, true);
  op.tma_w = vec_w && encode_tiles(&op.mw, w, 2, K / 2, N, C::BK, 64, true);
  if ((vec_x && !op.tma_x) || (vec_w && !op.tma_w))
    return static_cast<int>(cudaErrorNotSupported);
  return launch<C>(op, c, ws, counters, M, N, K / 2, out_type, splits, per,
                   s);
}

}  // namespace

// x (M, K) bf16; w (K/2, N) bf16; kept (K/2/block,) int32 dense block
// indices; c (M, N) of out_type (0 f32, 1 bf16). K % 2 == 0, block > 0.
// vec_x: x's base is 16-byte aligned, K % 8 == 0 and block % 64 == 0.
// vec_w: w's base is 16-byte aligned and N % 8 == 0. The plan as for
// repro_gemm, over the K/2 packed rows (kernels/gemm_plan.py): tile Small
// or Deep. Returns the CUDA status.
extern "C" int repro_block24_gemm(const void* x, const void* w,
                                  const void* kept, void* c, int M, int N,
                                  int K, int block, int out_type, int vec_x,
                                  int vec_w, int tile, int splits, int per,
                                  void* ws, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 2 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* kp = static_cast<const int*>(kept);
  if (tile == TILE_SMALL)
    return run<Small>(x, w, kp, c, M, N, K, block, out_type, vec_x, vec_w,
                      splits, per, ws, counters, s);
  if (tile == TILE_DEEP)
    return run<Deep>(x, w, kp, c, M, N, K, block, out_type, vec_x, vec_w,
                     splits, per, ws, counters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
