// Kernel D: packed 2:4 GEMM  C (M, N) = X (M, K) @ unpack(values, meta),
// f32 accumulation.
//
// Replaces src/repro/kernels/sparse24_matmul.py::sparse24_matmul_pallas
// (kernel body _sparse24_kernel, tile decompression _decompress_block). The
// weight arrives in the repository's packed 2:4 form (core/sparsity.py):
// values (K/2, N) in bf16, e4m3 or e5m2, and meta (K/8, N) uint8 holding
// four 2-bit in-group positions per byte, p0 | p1<<2 | p2<<4 | p3<<6, for
// the groups of four rows 2g (p0, p1) and 2g+1 (p2, p3). X is bf16; the
// output is f32 or bf16. Under a sparse24 serving policy this kernel carries
// every packed linear layer (q, k, v, o, gate, up, down).
//
// What bounds it on the H100: at decode M is the slot count (4), so the time
// is the packed weight read -- K/2 * N values plus K/8 * N meta bytes, 0.5625x
// the dense bf16 weight -- over 3.35 TB/s; the multiplies are few. The point
// of the packed form is to move fewer bytes from device memory, so each K
// step reads only packed bytes and widens them on chip.
//
// Design: one thread block per BM x BN output tile with the K loop inside the
// block, the tile GEMM of kernel A (wmma_tile.cuh), since GPU blocks cannot
// carry the TPU kernel's accumulator across a sequential K grid axis. Each K
// step stages a BM x BK tile of X in shared memory with 16-byte loads, and
// decompresses the packed (BK/2, BN) values and (BK/8, BN) meta into a
// dense bf16 (BK, BN) tile: a thread takes one meta byte row for four
// adjacent columns (one 32-bit meta load, four 8-byte or 4-byte value loads,
// all issued before any store), and writes the eight dense rows those bytes
// cover, two values per group of four and zeros elsewhere. e4m3 and e5m2
// widen exactly to bf16.
// The dense tile then goes through WMMA 16x16x16 bf16 fragments into f32
// accumulators. Ragged M and N, and a K that is a multiple of 8 but not of
// BK, are masked in the loads and the epilogue (the JAX registry fell back to
// XLA for any block that was not a multiple of 8, i.e. at every decode step).
// Later work: Hopper's sparse tensor cores (mma.sp, with their own meta
// layout), wgmma, TMA and a pipelined K loop.
#include "wmma_tile.cuh"

namespace {

using namespace wmma_tile;

// Value types: the raw bits of four adjacent columns fit in two 32-bit words
// (bf16) or one (fp8).
template <int VT> struct Val;
template <> struct Val<IN_BF16> {
  typedef uint16_t bits;
  static __device__ __forceinline__ float f32(uint32_t b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ uint32_t col(const uint32_t* w, int i) {
    return (w[i >> 1] >> (16 * (i & 1))) & 0xffffu;
  }
  static __device__ __forceinline__ void load4(const uint16_t* p,
                                               uint32_t* w) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  }
  static __device__ __forceinline__ void put(uint32_t* w, int i, uint32_t b) {
    w[i >> 1] |= b << (16 * (i & 1));
  }
};
struct Fp8Val {
  typedef uint8_t bits;
  static __device__ __forceinline__ uint32_t col(const uint32_t* w, int i) {
    return (w[0] >> (8 * i)) & 0xffu;
  }
  static __device__ __forceinline__ void load4(const uint8_t* p, uint32_t* w) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
    w[1] = 0;
  }
  static __device__ __forceinline__ void put(uint32_t* w, int i, uint32_t b) {
    w[0] |= b << (8 * i);
  }
};
template <> struct Val<IN_E4M3> : Fp8Val {
  static __device__ __forceinline__ float f32(uint32_t b) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  }
};
template <> struct Val<IN_E5M2> : Fp8Val {
  static __device__ __forceinline__ float f32(uint32_t b) {
    __nv_fp8_e5m2 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  }
};

// Decompress the packed weight rows for dense rows [k0, k0 + BK) and columns
// [n0, n0 + BN) into a dense bf16 (BK, BN) shared-memory tile (leading dim
// LD). A unit is one meta row (eight dense rows) by four columns.
template <int VT, int BK, int BN, int LD, int NT>
__device__ __forceinline__ void decompress_tile(
    const typename Val<VT>::bits* __restrict__ vals,
    const uint8_t* __restrict__ meta, int K, int N, int k0, int n0, bool vec,
    __nv_bfloat16* dst, int tid) {
  typedef Val<VT> V;
  constexpr int UPR = BN / 4;                    // units per meta row
  constexpr int UNITS = (BK / 8) * UPR;
  static_assert(UNITS % NT == 0, "tile must split evenly over threads");
  constexpr int PER = UNITS / NT;
  const int K8 = K / 8;
  uint32_t mw[PER], vw[PER][4][2];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int unit = tid + u * NT;
    const int gr8 = k0 / 8 + unit / UPR, gc = n0 + (unit % UPR) * 4;
    mw[u] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) vw[u][j][0] = vw[u][j][1] = 0;
    if (gr8 >= K8) continue;
    if (vec && gc + 4 <= N) {
      mw[u] = *reinterpret_cast<const uint32_t*>(meta + (size_t)gr8 * N + gc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        V::load4(vals + (size_t)(4 * gr8 + j) * N + gc, vw[u][j]);
    } else {
      for (int i = 0; i < 4 && gc + i < N; ++i) {
        mw[u] |= uint32_t(meta[(size_t)gr8 * N + gc + i]) << (8 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          V::put(vw[u][j], i, vals[(size_t)(4 * gr8 + j) * N + gc + i]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int unit = tid + u * NT;
    const int r8 = unit / UPR, c4 = (unit % UPR) * 4;
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int grp = rr >> 2, slot = rr & 3;
      uint32_t o[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t m = (mw[u] >> (8 * i)) & 0xffu;
        const uint32_t pa = (m >> (4 * grp)) & 3u, pb = (m >> (4 * grp + 2)) & 3u;
        // the reference's one-hot sum: each slot takes the values whose
        // position names it (one of them for a well-formed pack)
        float s = 0.0f;
        if (pa == uint32_t(slot)) s += V::f32(V::col(vw[u][2 * grp], i));
        if (pb == uint32_t(slot)) s += V::f32(V::col(vw[u][2 * grp + 1], i));
        o[i >> 1] |= uint32_t(__bfloat16_as_ushort(__float2bfloat16(s)))
                     << (16 * (i & 1));
      }
      *reinterpret_cast<uint2*>(dst + (8 * r8 + rr) * LD + c4) =
          make_uint2(o[0], o[1]);
    }
  }
}

template <int VT, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
sparse24_kernel(const uint16_t* __restrict__ x,
                const typename Val<VT>::bits* __restrict__ vals,
                const uint8_t* __restrict__ meta, void* __restrict__ c_,
                int M, int N, int K, int out_type, int vec_x, int vec_w) {
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  tile_gemm<BM, BN, BK, WM, WN>(
      K, c_, M, N, out_type,
      [=](int k0, __nv_bfloat16* As, __nv_bfloat16* Bs) {
        load_tile<IN_BF16, BM, BK, Tl::LDA, Tl::NT>(x, M, K, m0, k0, vec_x,
                                                    As, tid);
        decompress_tile<VT, BK, BN, Tl::LDB, Tl::NT>(vals, meta, K, N, k0,
                                                     n0, vec_w, Bs, tid);
      });
}

template <int VT, int BM, int BN, int BK, int WM, int WN>
void launch(const void* x, const void* vals, const void* meta, void* c, int M,
            int N, int K, int out_type, int vec_x, int vec_w,
            cudaStream_t stream) {
  typedef Tile<BM, BN, BK, WM, WN> Tl;
  sparse24_kernel<VT, BM, BN, BK, WM, WN>
      <<<Tl::grid(M, N), Tl::NT, 0, stream>>>(
      static_cast<const uint16_t*>(x),
      static_cast<const typename Val<VT>::bits*>(vals),
      static_cast<const uint8_t*>(meta), c, M, N, K, out_type, vec_x, vec_w);
}

template <int VT>
void dispatch(const void* x, const void* vals, const void* meta, void* c,
              int M, int N, int K, int out_type, int vec_x, int vec_w,
              cudaStream_t stream) {
  if (M <= 16)
    launch<VT, 16, 64, 128, 16, 16>(x, vals, meta, c, M, N, K, out_type,
                                    vec_x, vec_w, stream);
  else
    launch<VT, 64, 128, 64, 32, 32>(x, vals, meta, c, M, N, K, out_type,
                                    vec_x, vec_w, stream);
}

}  // namespace

// x (M, K) bf16; vals (K/2, N) of val_type (0 bf16, 1 e4m3, 2 e5m2); meta
// (K/8, N) uint8; c (M, N) of out_type (0 f32, 1 bf16). K % 8 == 0.
// vec_x: x's base is 16-byte aligned. vec_w: vals' and meta's bases are
// 16-byte aligned and N % 4 == 0. Returns cudaGetLastError() after the launch.
extern "C" int repro_sparse24_gemm(const void* x, const void* vals,
                                   const void* meta, void* c, int M, int N,
                                   int K, int val_type, int out_type,
                                   int vec_x, int vec_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (val_type) {
    case IN_BF16:
      dispatch<IN_BF16>(x, vals, meta, c, M, N, K, out_type, vec_x, vec_w, s);
      break;
    case IN_E4M3:
      dispatch<IN_E4M3>(x, vals, meta, c, M, N, K, out_type, vec_x, vec_w, s);
      break;
    case IN_E5M2:
      dispatch<IN_E5M2>(x, vals, meta, c, M, N, K, out_type, vec_x, vec_w, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
