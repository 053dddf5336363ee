// Kernel B: forward flash attention on the tensor cores, online softmax in
// f32.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel body _flash_kernel): q (B, h, Sq, hd), k/v (B, kvh, Skv, hd) bf16,
// query head h reads kv head h / (h / kvh), causal mask top-left
// (query i sees key j when i >= j), output bf16 like q.
//
// What bounds it on the H100: at the serving prefill (h = 32, kvh = 8,
// hd = 128, S = 77 or 128) it moves ~2.6 MB and multiplies ~0.14 GFLOP, a
// bound under a microsecond either way. What costs time is latency: the
// first loads from device memory (~2 us), one warp's chain of products and
// softmax for a tile (~1.4 us for 16 x 32), folding the warps' partials and
// storing (~1.2 us), and the launch (~0.9 us for an empty kernel).
//
// Design (FlashAttention-2 on mma.sync):
// - Both products on the tensor cores: mma.sync.m16n8k16, bf16 in, f32
//   sums. Each warp owns 16 query rows; Q's fragments stay in registers for
//   the whole walk. S = Q K^T comes out as a register fragment, the row max
//   and sum are taken by shuffles within each quad of lanes, and P is
//   rounded to bf16 in registers, where the score fragment's layout is
//   already the A operand of P V: P never goes through shared memory. The
//   scores are exact products summed in f32; rounding P to bf16 adds a few
//   1e-3 on outputs of order 1, under the 2e-2 tolerance.
// - Why mma.sync and not wgmma: wgmma multiplies a 64-row tile per
//   warpgroup, so a block would own 64 query rows. The prompts of the main
//   path are 77 and 128 tokens: 64 blocks or fewer for 32 heads, half the
//   SMs idle. Tiles of 16 rows per warp and 32 per block give 128 blocks at
//   S = 128. wgmma is for longer prompts, where 64-row tiles fill the card.
// - Kv tiles shared out inside the block: 8 warps, two row groups of 16 x
//   KVG = 4 kv groups; kv group g takes tiles g, g + 4, ... of 32 rows, so
//   the heaviest causal block at S = 128 runs its four tiles at once. At
//   the end every warp leaves its (m, l, acc) in shared memory and each
//   warp folds the four partials of its rows, in group order, for a quarter
//   of the columns, and stores them. No split of K / V across blocks and
//   no atomics: each output is summed in one fixed order, so a call gives
//   the same bits every time (and the paged and dense prefills agree
//   exactly).
// - Copies in flight: K and V tiles are copied as bf16 with 16-byte cp.async
//   into a ring that holds this step's tiles and the next step's, K and V
//   in separate groups so that Q K^T starts while V is still arriving; rows
//   are XOR-swizzled by 16-byte piece so that ldmatrix (.trans for V) reads
//   eight rows without a bank conflict. Rows past Sq or Skv are zero-filled
//   and masked; only tiles on the diagonal or past Skv are masked at all.
// - Order: the grid is (h, B, q tiles) with the q tile slowest and, under
//   the causal mask, the heaviest (last) tiles first. Kv tiles wholly above
//   a warp's diagonal are skipped.
// - Longer prompts: one block per SM (136 KB of shared memory), four tiles
//   per step; at S = 512 this is ~3x cuDNN's wgmma kernel (PERF.md).
// - Head dim 256 (gemma3): the ring of eight K/V stages would need 278 KB
//   of shared memory, and Q's fragments (64 registers) beside the f32
//   output accumulator (128) would spill. So at HD 256 a block has two kv
//   groups (4 warps, 4 stages, 144 KB) and each warp reads its Q fragments
//   from shared memory at every k step instead of keeping them; the tiles,
//   the masks and the fixed fold order are those of the smaller heads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_ops.cuh"

namespace {

constexpr int BQ = 32;            // query rows per block: 16 per row group
constexpr int BKV = 32;           // kv rows per tile
constexpr float NEG_INF = -1e30f;

// Per head dim: kv groups (warps that share out kv tiles; 2 x KVG warps,
// two row groups), the ring (this step's tiles and the next's) and whether
// Q's fragments stay in registers for the whole walk.
template <int HD>
struct Shape {
  static constexpr int KVG = HD > 128 ? 2 : 4;
  static constexpr int NW = 2 * KVG;
  static constexpr int NT = 32 * NW;
  static constexpr int STAGES = 2 * KVG;
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr size_t SMEM = (size_t)(BQ + STAGES * 2 * BKV) * HD * 2;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::NT)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int H, int KVH, int Sq, int Skv,
             int causal, float scale_log2) {
  constexpr int CH = HD / 8;      // 16-byte pieces per row
  constexpr int RB = HD * 2;      // bytes per row
  constexpr int KS = HD / 16;     // k steps of Q K^T
  constexpr int NS = BKV / 8;     // 8-column blocks of a score tile
  constexpr int NO = HD / 8;      // 8-column blocks of the output
  constexpr int KVG = Shape<HD>::KVG, NT = Shape<HD>::NT;
  constexpr int STAGES = Shape<HD>::STAGES;
  constexpr bool Q_IN_REGS = Shape<HD>::Q_IN_REGS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;                   // BQ rows; later the output
  unsigned char* ring = smem + BQ * RB;       // STAGES x (K, V) tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane & 7, lj = lane >> 3;    // row, piece of an x4 load
  const int rg = warp & 1, g = warp >> 1;     // row group, kv group
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (H / KVH);
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * Sq * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * KVH + kvh) * Skv * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * KVH + kvh) * Skv * HD;
  __nv_bfloat16* ob = o + ((size_t)b * H + h) * Sq * HD;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1) / BKV + 1);
  const int n_steps = (n_tiles + KVG - 1) / KVG;  // KVG tiles per step

  // rows [s0, s0 + rows) of a (S, HD) matrix into a swizzled tile
  auto load_rows = [&](unsigned char* dst, const __nv_bfloat16* src, int S,
                       int s0, int rows) {
    for (int e = tid; e < rows * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      const bool ok = s0 + r < S;
      cp_async16(dst + piece_off<CH>(r, c),
                 ok ? src + (size_t)(s0 + r) * HD + c * 8 : src, ok ? 16 : 0);
    }
  };
  // step i: tiles i * KVG .. + KVG - 1, tile t into stage t % STAGES; its
  // K tiles (half 0) and V tiles (half 1) are two commit groups, so that
  // Q K^T can start while V is still on its way
  auto issue = [&](int i, int half) {
    for (int t = i * KVG; t < min(n_tiles, (i + 1) * KVG); ++t)
      load_rows(ring + ((t % STAGES) * 2 + half) * BKV * RB,
                half ? vb : kb, Skv, t * BKV, BKV);
    cp_async_commit();
  };
  load_rows(Qs, qb, Sq, q0, BQ);
  issue(0, 0);                    // the first group holds Q too
  issue(0, 1);

  const int row0 = 16 * rg;                   // this warp's rows in the tile
  const int qfirst = q0 + row0, qlast = qfirst + 15;
  const int qlo = qfirst + lane / 4;          // its rows qlo and qlo + 8
  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // running max (raw score units) and this lane's part of the row sums
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_steps; ++i) {
    issue(i + 1, 0);              // (empty groups past the last step)
    issue(i + 1, 1);
    cp_async_wait<3>();           // step i's K tiles (and Q) have landed
    __syncthreads();
    if (Q_IN_REGS && i == 0) {
#pragma unroll
      for (int ks = 0; ks < (Q_IN_REGS ? KS : 0); ++ks)
        ldmatrix_x4(qf[ks], Qs + piece_off<CH>(row0 + li + 8 * (lj & 1),
                                               2 * ks + (lj >> 1)));
    }
    const int t = i * KVG + g, k0 = t * BKV;
    const bool live = t < n_tiles && qfirst < Sq && !(causal && k0 > qlast);
    const unsigned char* Ks = ring + (t % STAGES) * 2 * BKV * RB;
    const unsigned char* Vs = Ks + BKV * RB;
    uint32_t pf[NS / 2][4];                   // P in bf16: A of P V
    if (live) {
      // S = Q K^T: K's rows are B's columns (ldmatrix without .trans)
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t(&a)[4] = qf[Q_IN_REGS ? ks : 0];
        if (!Q_IN_REGS)
          ldmatrix_x4(a, Qs + piece_off<CH>(row0 + li + 8 * (lj & 1),
                                            2 * ks + (lj >> 1)));
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Ks + piece_off<CH>(16 * p + li + 8 * (lj >> 1),
                                             2 * ks + (lj & 1)));
          mma_16816(s[2 * p], a, bk[0], bk[1]);
          mma_16816(s[2 * p + 1], a, bk[2], bk[3]);
        }
      }
      // lane holds rows qlo (e < 2) and qlo + 8, columns 8n + 2 (lane % 4)
      // + e % 2; only a tile on the diagonal or past Skv needs the mask
      if ((causal && k0 + BKV - 1 > qfirst) || k0 + BKV > Skv) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
            const int qi = qlo + 8 * (e >> 1);
            if (kj >= Skv || (causal && qi < kj)) s[n][e] = NEG_INF;
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float alpha[2], mb[2];                    // mb: the max, base 2
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        mb[r] = m_new > NEG_INF / 2 ? m_new * scale_log2 : 0.0f;
      }
      // P = exp2(S scale - m) in f32 for the row sums, in bf16 for P V
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[n][e] = s[n][e] > NEG_INF / 2
                        ? exp2f(fmaf(s[n][e], scale_log2, -mb[r]))
                        : 0.0f;
          psum[r] += s[n][e];
        }
        // 8-column block n is the k-half n % 2 of A's 16-deep step n / 2
        pf[n / 2][2 * (n & 1)] = pack_bf16(s[n][0], s[n][1]);
        pf[n / 2][2 * (n & 1) + 1] = pack_bf16(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      }
    }
    cp_async_wait<2>();           // step i's V tiles have landed
    __syncthreads();
    if (live) {
      // O += P V: V's rows are B's k (ldmatrix .trans)
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
        for (int p = 0; p < NO / 2; ++p) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vs + piece_off<CH>(16 * kk + li + 8 * (lj & 1),
                                                   2 * p + (lj >> 1)));
          mma_16816(acc[2 * p], pf[kk], bv[0], bv[1]);
          mma_16816(acc[2 * p + 1], pf[kk], bv[2], bv[3]);
        }
    }
    __syncthreads();  // every warp is done with this step's stages
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed (none is left with no tile)

  // Every warp leaves its partial (acc, m, l per lane) in the ring; then
  // warp (rows, g) folds the KVG partials of its rows in group order 0 ..
  // KVG-1 for its share of the columns, 8-column blocks g * NOG .. + NOG.
  constexpr int NOG = NO / KVG;               // 8-column blocks per warp
  constexpr int PART = NO * 4 + 4;            // floats per lane
  static_assert(NO % KVG == 0 && KVG * 2 * PART * 32 * 4 <=
                    STAGES * 2 * BKV * RB, "the partials fit in the ring");
  float* xs = reinterpret_cast<float*>(ring);
  if (KVG > 1) {
    float* mine = xs + (g * 2 + rg) * PART * 32 + lane;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(4 * NO + r) * 32] = m[r];
      mine[(4 * NO + 2 + r) * 32] = l[r];
    }
    __syncthreads();
  }
  float out[NOG][4];
  float inv[2];
  {
    float mt[2] = {NEG_INF, NEG_INF}, lt[2] = {0.0f, 0.0f}, w[KVG][2];
#pragma unroll
    for (int gg = 0; gg < KVG; ++gg)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mt[r] = fmaxf(mt[r], KVG > 1 ? xs[((gg * 2 + rg) * PART + 4 * NO + r)
                                          * 32 + lane] : m[r]);
#pragma unroll
    for (int gg = 0; gg < KVG; ++gg)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* part = xs + (gg * 2 + rg) * PART * 32 + lane;
        const float mg = KVG > 1 ? part[(4 * NO + r) * 32] : m[r];
        const float lg = KVG > 1 ? part[(4 * NO + 2 + r) * 32] : l[r];
        w[gg][r] = exp2f((mg - mt[r]) * scale_log2);
        lt[r] += lg * w[gg][r];
      }
#pragma unroll
    for (int j = 0; j < NOG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = g * NOG + j;
        float sum = 0.0f;
#pragma unroll
        for (int gg = 0; gg < KVG; ++gg)
          sum += (KVG > 1 ? xs[((gg * 2 + rg) * PART + 4 * n + e) * 32 + lane]
                          : acc[j][e]) * w[gg][e >> 1];
        out[j][e] = sum;
      }
    // 1 / l per row: the quad's partial sums added
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 1);
      lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 2);
      inv[r] = 1.0f / fmaxf(lt[r], 1e-30f);
    }
  }

  // This warp's output block rounded to bf16 into its rows and columns of
  // Qs (no other warp touches them), then 16-byte stores of valid rows
  const int rl = row0 + lane / 4;
#pragma unroll
  for (int j = 0; j < NOG; ++j) {
    const int n = g * NOG + j, byte = 2 * (2 * (lane & 3));
    *reinterpret_cast<uint32_t*>(Qs + piece_off<CH>(rl, n) + byte) =
        pack_bf16(out[j][0] * inv[0], out[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Qs + piece_off<CH>(rl + 8, n) + byte) =
        pack_bf16(out[j][2] * inv[1], out[j][3] * inv[1]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * NOG; e += 32) {
    const int r = row0 + e / NOG, c = g * NOG + e % NOG;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + piece_off<CH>(r, c));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int Sq, int Skv, int causal, cudaStream_t stream) {
  const size_t smem = Shape<HD>::SMEM;
  static size_t granted = 48 * 1024;  // this instantiation's smem limit
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(HD)));
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_kernel<HD><<<grid, Shape<HD>::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      KVH, Sq, Skv, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, HD), k/v (B, KVH, Skv, HD), o (B, H, Sq, HD); all bf16,
// contiguous and 16-byte aligned; HD in {32, 64, 128, 256}. Returns
// cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KVH, int Sq, int Skv, int HD,
                                     int causal, void* stream) {
  if (KVH <= 0 || H % KVH || Sq <= 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return launch<32>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    case 64: return launch<64>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    case 128: return launch<128>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    case 256: return launch<256>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
