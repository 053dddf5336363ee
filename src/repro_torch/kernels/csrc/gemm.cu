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
// 3.35 TB/s, and what matters is keeping enough weight bytes in flight on
// every SM. Prefill at M = 128 stays under the ridge as well, but there the
// multiplies must run at the tensor cores' wgmma rate to keep up.
//
// Design (the tile GEMM of tile_gemm.cuh, shared with kernels D and E):
// the TPU kernel carried its accumulator across a sequential K grid axis;
// here the planner (kernels/gemm_plan.py) splits K over enough blocks to
// fill the card -- the narrow projections (N = 1024 or 4096) had 16 to 64
// blocks on 132 SMs before -- and sums the splits in a fixed order. Each
// block streams its K range through a 4-stage TMA ring, so three K steps of
// A and B (two at prefill) are in flight while one is multiplied. bf16 tiles
// land in the swizzled layout the tensor cores read; e4m3 and e5m2 bytes are
// copied raw (half the bytes) and widened to bf16 in shared memory, exactly,
// so products stay exact. Decode (M <= 16) multiplies with mma.sync
// m16n8k16; prefill with wgmma m64n128k16 on a 128 x 128 tile, which reads
// each weight tile once for all 128 rows. Every M, N and K runs: TMA
// zero-fills past the edges, rows that are not 16-byte aligned take element
// loads (the JAX backend instead fell back to XLA whenever a block was not a
// multiple of 8).
// Expert stacks (the reference vmaps its GEMM over a MoE layer's experts,
// one pallas_call with an extra grid axis): repro_gemm_batched takes E
// products of one shape, A (E, M, K) @ B (E, K, N) -> C (E, M, N), in one
// launch, the member on the grid's z axis beside the K splits and both
// operands addressed through 3-D tensor maps. Each member's plan and sums
// are those of its own (M, N, K) product.
// Later work: native fp8 wgmma (needs a K-major copy of the weight and f32
// promotion of the partial sums), a persistent grid with the split-K
// fix-up overlapped, TMA multicast of the activation tile across a cluster.
#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

template <int IT, class C>
struct DenseOp {
  typedef typename In<IT>::bits T;
  static constexpr int ES = sizeof(T);
  // A (BM x BK) then B (BK x BN): bf16 in the swizzled layouts the tensor
  // cores read; fp8 raw and row-major, widened into `buf`
  static constexpr bool RAW = IT != IN_BF16;
  static constexpr int RA_BYTES = C::BM * C::BK * ES;
  static constexpr int RB_BYTES = C::BK * C::BN * ES;
  static constexpr int B_OFF = round1024(RA_BYTES);
  static constexpr int STAGE_BYTES = B_OFF + round1024(RB_BYTES);
  static constexpr int BUF_BYTES = RAW ? C::A_BYTES + C::B_BYTES : 0;
  static constexpr bool B_KMAJOR = false;

  CUtensorMap ma, mb;  // used where tma_a / tma_b
  const T* a;
  const T* b;
  int M, N, K;
  bool tma_a, tma_b;

  // k0 .. k0 + BK of batch member e
  __device__ __forceinline__ void load(int k0, unsigned char* st, int m0,
                                       int n0, int e, int tid,
                                       uint64_t* bar) const {
    unsigned char* sb = st + B_OFF;
    if (tid == 0) {
      mbar_expect(bar, (tma_a ? RA_BYTES : 0) + (tma_b ? RB_BYTES : 0));
      if (tma_a) tma_3d(st, &ma, k0, m0, e, bar);
      if (tma_b) {
        if constexpr (RAW)
          tma_3d(sb, &mb, n0, k0, e, bar);
        else
#pragma unroll
          for (int h = 0; h < C::BN / 64; ++h)
            tma_3d(sb + h * C::BK * 128, &mb, n0 + 64 * h, k0, e, bar);
      }
    }
    if (!tma_a)
      load_tile<T, C::BM, C::BK, C::NT>(
          a + (size_t)e * M * K, M, K, m0, k0,
          [=](int r, int c) {
            return RAW ? st + r * C::BK + c : st + a_off(r, c);
          },
          tid);
    if (!tma_b)
      load_tile<T, C::BK, C::BN, C::NT>(
          b + (size_t)e * K * N, K, N, k0, n0,
          [=](int r, int c) {
            return RAW ? sb + r * C::BN + c : sb + b_off<C::BK>(r, c);
          },
          tid);
  }

  __device__ __forceinline__ int operands(unsigned char* st,
                                           unsigned char* buf,
                                           const unsigned char*& A,
                                           const unsigned char*& B,
                                           int tid) const {
    if constexpr (RAW) {
      unsigned char* as = buf;
      unsigned char* bs = buf + C::A_BYTES;
      constexpr int CA = RA_BYTES / 16, CB = RB_BYTES / 16;
      static_assert(CB % C::NT == 0, "B chunks split evenly over threads");
      // raw row r of A holds k = 16j .. 16j + 15 in its chunk j
#pragma unroll
      for (int i = 0; i < (CA + C::NT - 1) / C::NT; ++i) {
        const int c = tid + i * C::NT;
        if (CA % C::NT && c >= CA) break;
        const int r = c / (C::BK / 16), k = (c % (C::BK / 16)) * 16;
        widen16<IT>(reinterpret_cast<const uint4*>(st)[c], as + a_off(r, k),
                    as + a_off(r, k + 8));
      }
#pragma unroll
      for (int i = 0; i < CB / C::NT; ++i) {
        const int c = tid + i * C::NT;
        const int k = c / (C::BN / 16), n = (c % (C::BN / 16)) * 16;
        widen16<IT>(reinterpret_cast<const uint4*>(st + B_OFF)[c],
                    bs + b_off<C::BK>(k, n), bs + b_off<C::BK>(k, n + 8));
      }
      A = as;
      B = bs;
      return WROTE_BLOCK;
    } else {
      A = st;
      B = st + B_OFF;
      return WROTE_NONE;
    }
  }
};

// The operands' tensor maps (3-D, `batch` matrices deep) where their rows
// are 16-byte aligned, then the launch.
template <int IT, class C>
int run(const void* a, const void* b, void* c, int batch, int M, int N,
        int K, int out_type, int vec_a, int vec_b, int splits, int per,
        void* ws, void* counters, cudaStream_t s) {
  typedef DenseOp<IT, C> Op;
  Op op{};
  op.a = static_cast<const typename Op::T*>(a);
  op.b = static_cast<const typename Op::T*>(b);
  op.M = M;
  op.N = N;
  op.K = K;
  // bf16: 64-column boxes in the 128-byte swizzle; fp8: whole raw tiles
  op.tma_a = vec_a && encode_tiles(&op.ma, a, Op::ES, M, K, C::BM,
                                   Op::RAW ? C::BK : 64, !Op::RAW, batch);
  op.tma_b = vec_b && encode_tiles(&op.mb, b, Op::ES, K, N, C::BK,
                                   Op::RAW ? C::BN : 64, !Op::RAW, batch);
  if ((vec_a && !op.tma_a) || (vec_b && !op.tma_b))
    return static_cast<int>(cudaErrorNotSupported);
  return launch<C>(op, c, ws, counters, M, N, K, out_type, splits, per, s,
                   batch);
}

template <int IT>
int dispatch(const void* a, const void* b, void* c, int batch, int M, int N,
             int K, int out_type, int vec_a, int vec_b, int tile, int splits,
             int per, void* ws, void* counters, cudaStream_t s) {
  if (tile == TILE_SMALL)
    return run<IT, Small>(a, b, c, batch, M, N, K, out_type, vec_a, vec_b,
                          splits, per, ws, counters, s);
  if (tile == TILE_WIDE)
    return run<IT, Wide>(a, b, c, batch, M, N, K, out_type, vec_a, vec_b,
                         splits, per, ws, counters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int by_type(const void* a, const void* b, void* c, int batch, int M, int N,
            int K, int in_type, int out_type, int vec_a, int vec_b, int tile,
            int splits, int per, void* ws, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case IN_BF16:
      return dispatch<IN_BF16>(a, b, c, batch, M, N, K, out_type, vec_a,
                               vec_b, tile, splits, per, ws, counters, s);
    case IN_E4M3:
      return dispatch<IN_E4M3>(a, b, c, batch, M, N, K, out_type, vec_a,
                               vec_b, tile, splits, per, ws, counters, s);
    case IN_E5M2:
      return dispatch<IN_E5M2>(a, b, c, batch, M, N, K, out_type, vec_a,
                               vec_b, tile, splits, per, ws, counters, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// in_type: 0 bf16, 1 e4m3, 2 e5m2 (both operands). out_type: 0 f32, 1 bf16.
// vec_a / vec_b: the operand's base is 16-byte aligned and so is each row.
// The plan (kernels/gemm_plan.py): tile 0 small / 1 wide, `splits` K ranges
// of `per` BK steps each; with splits > 1, ws holds splits * M * N floats
// and counters one int per output tile, all 0. Returns the CUDA status.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int M, int N,
                          int K, int in_type, int out_type, int vec_a,
                          int vec_b, int tile, int splits, int per, void* ws,
                          void* counters, void* stream) {
  return by_type(a, b, c, 1, M, N, K, in_type, out_type, vec_a, vec_b, tile,
                 splits, per, ws, counters, stream);
}

// repro_gemm over `batch` members of one shape, contiguous one after
// another in a (batch, M, K), b (batch, K, N) and c (batch, M, N), in one
// launch. The plan is the members' own; with splits > 1, ws holds batch *
// splits * M * N floats and counters batch ints per output tile, all 0.
extern "C" int repro_gemm_batched(const void* a, const void* b, void* c,
                                  int batch, int M, int N, int K, int in_type,
                                  int out_type, int vec_a, int vec_b,
                                  int tile, int splits, int per, void* ws,
                                  void* counters, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_type(a, b, c, batch, M, N, K, in_type, out_type, vec_a, vec_b,
                 tile, splits, per, ws, counters, stream);
}
