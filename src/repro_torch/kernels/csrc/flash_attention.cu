// Kernel B: forward flash attention, online softmax in f32.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel body _flash_kernel): q (B, h, Sq, hd), k/v (B, kvh, Skv, hd) bf16,
// query head h reads kv head h / (h / kvh), causal mask top-left
// (query i sees key j when i >= j), output bf16 like q.
//
// What bounds it on the H100: prefill at the serving shapes (S of a few
// hundred, hd 128) moves a few MB and does well under a GFLOP, so a launch
// costs more than either bound; at long S the QK^T and PV products make it
// operation-bound. This first version aims at the exact arithmetic of the
// reference kernel rather than at the tensor cores.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch),
// with a loop over kv tiles of 64 inside the block -- the TPU kernel kept
// m / l / acc in VMEM scratch across a sequential kv grid axis, which GPU
// blocks cannot share, so they live in registers here. Four threads own one
// query row: each computes 16 of the row's 64 scores, the row max and sum
// are combined with warp shuffles, and each thread keeps 1/4 of the output
// row (interleaved columns, so shared-memory reads do not collide). Q, K, V
// and the probabilities sit in shared memory as f32 (padded rows); scores,
// probabilities and both products are f32 as in the TPU kernel. Kv tiles
// wholly above the diagonal are never loaded; ragged Sq / Skv are masked
// (the TPU kernel required both to be multiples of its block). Later work:
// wgmma for QK^T and PV, bf16 probabilities, TMA double-buffering.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NT = 256;           // 4 threads per query row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Copy rows [s0, s0 + ROWS) of a (S, HD) bf16 matrix into f32 shared
// memory with leading dim LD; rows past S are zero.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src,
                                          int S, int s0, float* dst, int tid) {
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  for (int c = tid; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, d = (c % CPR) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + r) * HD + d);
    float* o = dst + r * LD + d;
    o[0] = bf16_lo(raw.x); o[1] = bf16_hi(raw.x);
    o[2] = bf16_lo(raw.y); o[3] = bf16_hi(raw.y);
    o[4] = bf16_lo(raw.z); o[5] = bf16_hi(raw.z);
    o[6] = bf16_lo(raw.w); o[7] = bf16_hi(raw.w);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int H, int KVH, int Sq, int Skv,
             int causal, float scale) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = BKV + 1;
  constexpr int CPT = HD / 4;     // output columns per thread
  constexpr int SPT = BKV / 4;    // scores per thread per kv tile
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BKV * LDK;
  float* Ps = Vs + BKV * LDV;

  const int tid = threadIdx.x, r = tid / 4, sub = tid % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * Sq * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * KVH + kvh) * Skv * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * KVH + kvh) * Skv * HD;
  __nv_bfloat16* ob = o + ((size_t)b * H + h) * Sq * HD;

  load_rows<HD, BQ, LDQ>(qb, Sq, q0, Qs, tid);

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;
  float m = NEG_INF, l = 0.0f;
  const int qi = q0 + r;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's K/V/P reads are done
    load_rows<HD, BKV, LDK>(kb, Skv, k0, Ks, tid);
    load_rows<HD, BKV, LDV>(vb, Skv, k0, Vs, tid);
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LDQ + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[j] += qd * Ks[(sub + 4 * j) * LDK + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + sub + 4 * j;
      const bool ok = kj < Skv && (!causal || qi >= kj);
      s[j] = ok ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const bool live = m_new > NEG_INF / 2;
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = live ? expf(s[j] - m_new) : 0.0f;
      Ps[r * LDP + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    __syncwarp();     // the row's four threads share its Ps row
    for (int j = 0; j < BKV; ++j) {
      const float p = Ps[r * LDP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += p * Vs[j * LDV + c * 4 + sub];
    }
  }

  if (qi < Sq) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[(size_t)qi * HD + c * 4 + sub] = __float2bfloat16(acc[c] * inv_l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int Sq, int Skv, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD +
                       BQ * (BKV + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      KVH, Sq, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, HD), k/v (B, KVH, Skv, HD), o (B, H, Sq, HD); all bf16 and
// contiguous; HD in {32, 64, 128}. Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KVH, int Sq, int Skv, int HD,
                                     int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return launch<32>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    case 64: return launch<64>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    case 128: return launch<128>(q, k, v, o, B, H, KVH, Sq, Skv, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
