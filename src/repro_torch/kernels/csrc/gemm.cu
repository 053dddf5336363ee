// Kernel A: tiled GEMM  C (M, N) = A (M, K) @ B (K, N), f32 accumulation.
//
// Replaces src/repro/kernels/fp8_matmul.py::fp8_matmul_pallas (kernel body
// _fp8_matmul_kernel). The JAX registry routes bf16 through that kernel too
// (registry._pallas_dense), so this one kernel carries every linear layer of
// the dense serving path: operands bf16 x bf16, e4m3 x e4m3 or e5m2 x e5m2,
// output f32 or bf16, undescaled (per-tensor scales stay in the wrapper).
//
// What bounds it on the H100: at decode, M is the slot count (4), so every
// weight byte is read once for 2*M operations -- far under the ~295 op/byte
// ridge of bf16 (~590 for fp8). The time is the K*N weight read over
// 3.35 TB/s, and what matters is keeping enough weight bytes in flight.
// Prefill at M = 128 stays under the ridge as well.
//
// Design: one thread block per BM x BN output tile with the K loop inside
// the block -- the TPU kernel carried its accumulator across a sequential K
// grid axis, which GPU blocks (run in no order) cannot do. Each K step
// stages an A and a B tile in shared memory as bf16 (every e4m3 and e5m2
// value is exact in bf16, so products stay exact) and multiplies them with
// WMMA 16x16x16 bf16 fragments into f32 accumulators (the tile GEMM of
// wmma_tile.cuh, shared with kernels D and E). A 16-byte chunk of a row that
// lies inside the matrix is one vector load when the rows are 16-byte
// aligned, and all of a tile's loads are issued before the first store so
// that a block keeps a whole B tile (16 KB at decode) in flight; chunks
// across an edge take masked element loads, so every M, N and K runs (the
// JAX backend instead fell back to XLA whenever a block was not a multiple
// of 8). Small M (decode) uses a 16 x 64 tile with a 128-deep K step to put
// more blocks and bytes in flight. Later work: TMA, wgmma, a multi-stage
// pipeline, split-K for narrow N.
#include "wmma_tile.cuh"

namespace {

using namespace wmma_tile;

template <int IT, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
            void* __restrict__ c_, int M, int N, int K, int out_type,
            int vec_a, int vec_b) {
  typedef typename In<IT>::bits T;
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  const T* A = static_cast<const T*>(a_);
  const T* B = static_cast<const T*>(b_);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  tile_gemm<BM, BN, BK, WM, WN>(
      K, c_, M, N, out_type,
      [=](int k0, __nv_bfloat16* As, __nv_bfloat16* Bs) {
        load_tile<IT, BM, BK, Tl::LDA, Tl::NT>(A, M, K, m0, k0, vec_a, As,
                                               tid);
        load_tile<IT, BK, BN, Tl::LDB, Tl::NT>(B, K, N, k0, n0, vec_b, Bs,
                                               tid);
      });
}

template <int IT, int BM, int BN, int BK, int WM, int WN>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            int out_type, int vec_a, int vec_b, cudaStream_t stream) {
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  gemm_kernel<IT, BM, BN, BK, WM, WN><<<Tl::grid(M, N), Tl::NT, 0, stream>>>(
      a, b, c, M, N, K, out_type, vec_a, vec_b);
}

template <int IT>
void dispatch(const void* a, const void* b, void* c, int M, int N, int K,
              int out_type, int vec_a, int vec_b, cudaStream_t stream) {
  if (M <= 16)
    launch<IT, 16, 64, 128, 16, 16>(a, b, c, M, N, K, out_type, vec_a, vec_b,
                                    stream);
  else
    launch<IT, 64, 128, 64, 32, 32>(a, b, c, M, N, K, out_type, vec_a, vec_b,
                                    stream);
}

}  // namespace

// in_type: 0 bf16, 1 e4m3, 2 e5m2 (both operands). out_type: 0 f32, 1 bf16.
// vec_a / vec_b: the operand's base is 16-byte aligned and so is each row.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int M, int N,
                          int K, int in_type, int out_type, int vec_a,
                          int vec_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case IN_BF16:
      dispatch<IN_BF16>(a, b, c, M, N, K, out_type, vec_a, vec_b, s);
      break;
    case IN_E4M3:
      dispatch<IN_E4M3>(a, b, c, M, N, K, out_type, vec_a, vec_b, s);
      break;
    case IN_E5M2:
      dispatch<IN_E5M2>(a, b, c, M, N, K, out_type, vec_a, vec_b, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
