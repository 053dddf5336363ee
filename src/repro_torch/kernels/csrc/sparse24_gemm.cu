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
// of the packed form is to move fewer bytes from device memory, so only
// packed bytes cross it and the dense tile exists only in shared memory.
// Before this design the decompression (an f32 one-hot sum per dense
// element) cost more than the bytes it saved, and w_down (K = 14336) ran 64
// blocks each walking all of K.
//
// Design: the tile GEMM of tile_gemm.cuh (shared with kernels A and E): K
// split over enough blocks to fill the card (kernels/gemm_plan.py), a
// 4-stage TMA ring that holds a BM x BK tile of X and the raw packed
// (BK/2, BN) values and (BK/8, BN) meta of the steps ahead while one step
// is decompressed and multiplied. Decompression runs from shared memory with
// integer bit moves: a thread takes one meta byte (two groups of four dense
// rows of one column) and shifts each value's bf16 bits (e4m3 and e5m2 widen
// exactly) to the 16-bit slot its position names in a 64-bit word per group,
// zeros elsewhere; the two words are one 16-byte row of the dense tile, which
// is therefore stored K-major (wgmma without the transpose bit). At decode
// each warp decompresses only the 16 columns it multiplies, so it waits for
// no other warp. A malformed pack whose two positions name one slot keeps
// the reference's sum of both values (pack_24 never makes one: its positions
// come from a sort of distinct keys, tests/test_torch_sparsity.py). A bit
// move keeps a stored -0.0 where the reference's one-hot f32 sum gave +0.0;
// a signed zero changes no product sum. Decode (M <= 16) multiplies the
// dense tile with mma.sync m16n8k16, prefill with wgmma m64n128k16. Ragged M
// and N, and a K that is a multiple of 8 but not of BK, are zero-filled (the
// JAX registry fell back to XLA for any block that was not a multiple of 8,
// i.e. at every decode step).
// Still short of the unpacked weight's library GEMM at decode gate/up and
// down (measured, PERF.md): the decompression and its barrier add to every
// K step, and a deeper step (BK = 128) or a wider tile did not help.
// Later work: Hopper's sparse tensor cores (mma.sp, with their own meta
// layout), which would skip the dense tile and half the multiplies.
#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

template <int VT, class C>
struct Sparse24Op {
  typedef typename In<VT>::bits V;
  static constexpr int VB = sizeof(V);
  // stage: X's tile (C's A layout), then the raw values (BK/2 x BN) and
  // meta (BK/8 x BN), row-major
  static constexpr int V_OFF = round1024(C::A_BYTES);
  static constexpr int V_BYTES = (C::BK / 2) * C::BN * VB;
  static constexpr int M_OFF = V_OFF + round1024(V_BYTES);
  static constexpr int M_BYTES = (C::BK / 8) * C::BN;
  static constexpr int STAGE_BYTES = M_OFF + round1024(M_BYTES);
  static constexpr int BUF_BYTES = C::B_BYTES;  // the dense bf16 B tile
  static constexpr bool B_KMAJOR = true;

  CUtensorMap mx, mv, mm;  // used where tma_x / tma_w
  const uint16_t* x;
  const V* vals;
  const uint8_t* meta;
  int M, N, K;
  bool tma_x, tma_w;

  __device__ __forceinline__ void load(int k0, unsigned char* st, int m0,
                                       int n0, int /* one member */, int tid,
                                       uint64_t* bar) const {
    unsigned char* vs = st + V_OFF;
    unsigned char* ms = st + M_OFF;
    if (tid == 0) {
      mbar_expect(bar, (tma_x ? C::A_BYTES : 0) +
                           (tma_w ? V_BYTES + M_BYTES : 0));
      if (tma_x) tma_2d(st, &mx, k0, m0, bar);
      if (tma_w) {
        tma_2d(vs, &mv, n0, k0 / 2, bar);
        tma_2d(ms, &mm, n0, k0 / 8, bar);
      }
    }
    if (!tma_x)
      load_tile<uint16_t, C::BM, C::BK, C::NT>(
          x, M, K, m0, k0,
          [=](int r, int c) { return st + a_off(r, c); }, tid);
    if (!tma_w) {
      load_tile<V, C::BK / 2, C::BN, C::NT>(
          vals, K / 2, N, k0 / 2, n0,
          [=](int r, int c) { return vs + (r * C::BN + c) * VB; }, tid);
      load_tile<uint8_t, C::BK / 8, C::BN, C::NT>(
          meta, K / 8, N, k0 / 8, n0,
          [=](int r, int c) { return ms + r * C::BN + c; }, tid);
    }
  }

  // The dense B tile, K-major: unit (r8, n) is one meta byte, the eight
  // dense rows 8 * r8 .. 8 * r8 + 7 of column n, one 16-byte row of it.
  __device__ __forceinline__ int operands(unsigned char* st,
                                           unsigned char* buf,
                                           const unsigned char*& A,
                                           const unsigned char*& B,
                                           int tid) const {
    const V* vs = reinterpret_cast<const V*>(st + V_OFF);
    // Small: each warp decompresses the 16 columns it multiplies, so only
    // the warp waits for them; Wide: the block shares every column.
    constexpr int COLS = C::WIDE ? C::BN : C::BN / 4;
    constexpr int WORKERS = C::WIDE ? C::NT : 32;
    constexpr int UNITS = (C::BK / 8) * COLS;
    static_assert(UNITS % WORKERS == 0, "units split evenly over threads");
    const int col0 = C::WIDE ? 0 : (tid / 32) * COLS;
    const int me = C::WIDE ? tid : tid % 32;
#pragma unroll
    for (int i = 0; i < UNITS / WORKERS; ++i) {
      const int u = me + i * WORKERS;
      const int r8 = u / COLS, n = col0 + u % COLS;
      const uint32_t m = st[M_OFF + r8 * C::BN + n];
      uint32_t o[4];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int pa = (m >> (4 * grp)) & 3, pb = (m >> (4 * grp + 2)) & 3;
        const int row = 4 * r8 + 2 * grp;
        const uint32_t a = vs[row * C::BN + n];
        const uint32_t b = vs[(row + 1) * C::BN + n];
        // the four slots of the group, 16 bits each: each value moves to
        // the slot its position names
        uint64_t g = (uint64_t(In<VT>::bf16_bits(a)) << (16 * pa)) |
                     (uint64_t(In<VT>::bf16_bits(b)) << (16 * pb));
        if (pa == pb)
          g = uint64_t(__bfloat16_as_ushort(__float2bfloat16(
                  In<VT>::f32(a) + In<VT>::f32(b))))
              << (16 * pa);
        o[2 * grp] = static_cast<uint32_t>(g);
        o[2 * grp + 1] = static_cast<uint32_t>(g >> 32);
      }
      *reinterpret_cast<uint4*>(buf + bt_off(n, 8 * r8)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    A = st;
    B = buf;
    return C::WIDE ? WROTE_BLOCK : WROTE_WARP;
  }
};

template <int VT, class C>
int run(const void* x, const void* vals, const void* meta, void* c, int M,
        int N, int K, int out_type, int vec_x, int vec_w, int splits, int per,
        void* ws, void* counters, cudaStream_t s) {
  typedef Sparse24Op<VT, C> Op;
  Op op{};
  op.x = static_cast<const uint16_t*>(x);
  op.vals = static_cast<const typename Op::V*>(vals);
  op.meta = static_cast<const uint8_t*>(meta);
  op.M = M;
  op.N = N;
  op.K = K;
  op.tma_x = vec_x && encode_tiles(&op.mx, x, 2, M, K, C::BM, 64, true);
  op.tma_w = vec_w &&
             encode_tiles(&op.mv, vals, Op::VB, K / 2, N, C::BK / 2, C::BN,
                          false) &&
             encode_tiles(&op.mm, meta, 1, K / 8, N, C::BK / 8, C::BN, false);
  if ((vec_x && !op.tma_x) || (vec_w && !op.tma_w))
    return static_cast<int>(cudaErrorNotSupported);
  return launch<C>(op, c, ws, counters, M, N, K, out_type, splits, per, s);
}

template <int VT>
int dispatch(const void* x, const void* vals, const void* meta, void* c,
             int M, int N, int K, int out_type, int vec_x, int vec_w,
             int tile, int splits, int per, void* ws, void* counters,
             cudaStream_t s) {
  if (tile == TILE_SMALL)
    return run<VT, Small>(x, vals, meta, c, M, N, K, out_type, vec_x, vec_w,
                          splits, per, ws, counters, s);
  if (tile == TILE_WIDE)
    return run<VT, Wide>(x, vals, meta, c, M, N, K, out_type, vec_x, vec_w,
                         splits, per, ws, counters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) bf16; vals (K/2, N) of val_type (0 bf16, 1 e4m3, 2 e5m2); meta
// (K/8, N) uint8; c (M, N) of out_type (0 f32, 1 bf16). K % 8 == 0.
// vec_x: x's base is 16-byte aligned. vec_w: vals' and meta's bases are
// 16-byte aligned and so are their rows (N % 16 == 0). The plan as for
// repro_gemm (kernels/gemm_plan.py). Returns the CUDA status.
extern "C" int repro_sparse24_gemm(const void* x, const void* vals,
                                   const void* meta, void* c, int M, int N,
                                   int K, int val_type, int out_type,
                                   int vec_x, int vec_w, int tile, int splits,
                                   int per, void* ws, void* counters,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (val_type) {
    case IN_BF16:
      return dispatch<IN_BF16>(x, vals, meta, c, M, N, K, out_type, vec_x,
                               vec_w, tile, splits, per, ws, counters, s);
    case IN_E4M3:
      return dispatch<IN_E4M3>(x, vals, meta, c, M, N, K, out_type, vec_x,
                               vec_w, tile, splits, per, ws, counters, s);
    case IN_E5M2:
      return dispatch<IN_E5M2>(x, vals, meta, c, M, N, K, out_type, vec_x,
                               vec_w, tile, splits, per, ws, counters, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
