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
// WMMA 16x16x16 bf16 fragments into f32 accumulators. Tiles that lie wholly
// inside the matrix and whose rows are 16-byte aligned load with 16-byte
// vector loads, all issued before the first store so that a block keeps a
// whole B tile (16 KB at decode) in flight; edge tiles take masked scalar
// loads, so every M, N and K runs (the JAX backend instead fell back to XLA
// whenever a block was not a multiple of 8). Small M (decode) uses a
// 16 x 64 tile with a 128-deep K step to put more blocks and bytes in
// flight. Later work: TMA, wgmma, a multi-stage pipeline, split-K for narrow N.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum { IN_BF16 = 0, IN_E4M3 = 1, IN_E5M2 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1 };
constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

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
// top-left corner is (r0, c0) into shared memory (leading dim LD, bf16).
template <int IT, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(
    const typename In<IT>::bits* __restrict__ src, int n_rows, int n_cols,
    int r0, int c0, bool vec, __nv_bfloat16* dst, int tid) {
  typedef typename In<IT>::bits T;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = COLS / VEC;               // chunks per row
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % NT == 0, "tile must split evenly over threads");
  constexpr int PER = CHUNKS / NT;
  if (vec && r0 + ROWS <= n_rows && c0 + COLS <= n_cols) {
    uint4 raw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * NT;
      const int r = c / CPR, cc = (c % CPR) * VEC;
      raw[i] = *reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * n_cols + c0 + cc);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * NT;
      const int r = c / CPR, cc = (c % CPR) * VEC;
      store_chunk<IT>(raw[i], dst + r * LD + cc);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, cc = e % COLS;
      const int gr = r0 + r, gc = c0 + cc;
      uint16_t b = 0;  // bf16 +0
      if (gr < n_rows && gc < n_cols)
        b = In<IT>::bf16_bits(src[(size_t)gr * n_cols + gc]);
      dst[r * LD + cc] = __ushort_as_bfloat16(b);
    }
  }
}

template <int IT, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
            void* __restrict__ c_, int M, int N, int K, int out_type,
            int vec_a, int vec_b) {
  typedef typename In<IT>::bits T;
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDA = BK + PAD, LDB = BN + PAD, LDC = BN + 4;
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const T* A = static_cast<const T*>(a_);
  const T* B = static_cast<const T*>(b_);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<IT, BM, BK, LDA, NT>(A, M, K, m0, k0, vec_a, As, tid);
    load_tile<IT, BK, BN, LDB, NT>(B, K, N, k0, n0, vec_b, Bs, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, cc = e % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      const float v = Cs[r * LDC + cc];
      const size_t o = (size_t)gm * N + gn;
      if (out_type == OUT_F32)
        static_cast<float*>(c_)[o] = v;
      else
        static_cast<__nv_bfloat16*>(c_)[o] = __float2bfloat16(v);
    }
  }
}

template <int IT, int BM, int BN, int BK, int WM, int WN>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            int out_type, int vec_a, int vec_b, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / WM) * (BN / WN) * 32);
  gemm_kernel<IT, BM, BN, BK, WM, WN><<<grid, block, 0, stream>>>(
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
