// Kernel C: paged flash decode, one query row per (slot, head), online
// softmax in f32 over the slot's pages read through its page table.
//
// Replaces src/repro/kernels/paged_attention.py::paged_flash_decode_pallas
// (kernel body _paged_kernel): q (B, H, HD); pools (P, PS, KVH, HD) in bf16
// or f32 (q in the pools' type); page_map (B, MP) int32, -1 = unallocated;
// lengths (B,) int32 = written positions per slot. Query head h reads kv
// head h / (H / KVH); scale 1/sqrt(HD); output (B, H, HD) f32 as
// acc / max(l, 1e-30), so a slot with no valid position gets 0. Page ids
// are not checked against P (that would cost a device sync); the serving
// session's tables never name the trash page or an id out of range.
//
// What bounds it on the H100: the bytes of the valid K/V rows (each read
// once), plus q and the output. At the serving shape (4 slots, 8 kv heads,
// a few hundred positions) that is ~2 MB, under a microsecond at 3.35 TB/s,
// and 32 blocks on 132 SMs: the launch, not the bytes, sets its time.
//
// Design. The TPU grid (B, H, MP) carried m / l / acc in VMEM scratch across
// a sequential page axis and took the table by scalar prefetch; GPU blocks
// run in no order, so here one block per (slot, kv head) loads its own
// table row and length and walks the slot's positions itself, with m / l /
// acc in registers. The block serves all G = H / KVH query heads of its
// kv head, one warp each, so each K/V row is read once for the group where
// the TPU grid read it once per query head. Positions go in chunks of 32:
// each row of a chunk is looked up in the page table (so an entry of -1 or
// a position past the length is masked, never loaded: the row is zero-
// filled) and copied into shared memory as f32 with 16-byte vector loads
// (a row of one kv head is HD contiguous values in the pool). Lane r of a
// warp scores row r of the chunk; the warp takes the chunk's max and sum by
// shuffles, rescales as online softmax does, and each lane accumulates
// HD / 32 columns of P V. Splitting a long page walk over several blocks
// with a combine pass (flash decoding) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;          // positions per chunk: one per lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T -> f32 values written to dst[0 .. 16 / sizeof(T)).
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* dst);

template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw,
                                                       float* dst) {
  dst[0] = bf16_lo(raw.x); dst[1] = bf16_hi(raw.x);
  dst[2] = bf16_lo(raw.y); dst[3] = bf16_hi(raw.y);
  dst[4] = bf16_lo(raw.z); dst[5] = bf16_hi(raw.z);
  dst[6] = bf16_lo(raw.w); dst[7] = bf16_hi(raw.w);
}

template <>
__device__ __forceinline__ void widen16<float>(const uint4& raw, float* dst) {
  dst[0] = __uint_as_float(raw.x); dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z); dst[3] = __uint_as_float(raw.w);
}

template <typename T, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ page_map,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out, int H, int KVH,
                                    int PS, int MP, float scale) {
  constexpr int VEC = 16 / sizeof(T);    // values per 16-byte load
  constexpr int VPR = HD / VEC;          // 16-byte loads per row
  constexpr int LDK = HD + 1;            // lanes read K by row: pad
  constexpr int CPL = (HD + 31) / 32;    // output columns per lane
  const int G = H / KVH;
  extern __shared__ float smem[];
  float* Ks = smem;                      // ROWS x LDK
  float* Vs = Ks + ROWS * LDK;           // ROWS x HD
  float* Qs = Vs + ROWS * HD;            // G x HD
  float* Ps = Qs + G * HD;               // G x ROWS

  const int b = blockIdx.y, kh = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hq = kh * G + warp;          // this warp's query head
  const int* pm = page_map + (size_t)b * MP;
  const int n_pos = min(lengths[b], MP * PS);

  for (int i = tid; i < G * HD; i += nt) {
    const int g = i / HD, d = i % HD;
    Qs[i] = to_f32(q[((size_t)b * H + kh * G + g) * HD + d]);
  }

  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  for (int c0 = 0; c0 < n_pos; c0 += ROWS) {
    __syncthreads();  // the previous chunk's K/V/P reads are done
    for (int i = tid; i < ROWS * VPR; i += nt) {
      const int r = i / VPR, d = (i % VPR) * VEC;
      const int t = c0 + r;
      const int phys = t < n_pos ? pm[t / PS] : -1;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (phys >= 0) {
        const size_t off =
            (((size_t)phys * PS + t % PS) * KVH + kh) * HD + d;
        kr = *reinterpret_cast<const uint4*>(kp + off);
        vr = *reinterpret_cast<const uint4*>(vp + off);
      }
      float kf[VEC], vf[VEC];
      widen16<T>(kr, kf);
      widen16<T>(vr, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * LDK + d + e] = kf[e];
        Vs[r * HD + d + e] = vf[e];
      }
    }
    __syncthreads();

    // lane r scores row r of the chunk for this warp's query head
    const int t = c0 + lane;
    const bool valid = t < n_pos && pm[t / PS] >= 0;
    float s = 0.0f;
    const float* qh = Qs + warp * HD;
    const float* kr = Ks + lane * LDK;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s += qh[d] * kr[d];
    s = valid ? s * scale : NEG_INF;
    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const bool live = m_new > NEG_INF / 2;
    const float p = (live && valid) ? expf(s - m_new) : 0.0f;
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    Ps[warp * ROWS + lane] = p;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        float a = acc[c] * alpha;
        for (int r = 0; r < ROWS; ++r)
          a += Ps[warp * ROWS + r] * Vs[r * HD + d];
        acc[c] = a;
      }
    }
  }

  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
  float* ob = out + ((size_t)b * H + hq) * HD;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int d = lane + 32 * c;
    if (d < HD) ob[d] = acc[c] * inv_l;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* pm,
           const int* len, float* out, int B, int H, int KVH, int PS, int MP,
           cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * (ROWS * (HD + 1) + ROWS * HD + G * HD + G * ROWS);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  dim3 grid(KVH, B);
  paged_decode_kernel<T, HD><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pm, len, out, H, KVH, PS, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* pm,
             const int* len, float* out, int B, int H, int KVH, int HD,
             int PS, int MP, cudaStream_t s) {
  switch (HD) {
    case 16: return launch<T, 16>(q, kp, vp, pm, len, out, B, H, KVH, PS, MP, s);
    case 32: return launch<T, 32>(q, kp, vp, pm, len, out, B, H, KVH, PS, MP, s);
    case 64: return launch<T, 64>(q, kp, vp, pm, len, out, B, H, KVH, PS, MP, s);
    case 128: return launch<T, 128>(q, kp, vp, pm, len, out, B, H, KVH, PS, MP, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, HD); k_pages / v_pages (P, PS, KVH, HD); all bf16 (is_bf16 = 1)
// or all f32, contiguous, 16-byte aligned. page_map (B, MP) and lengths (B,)
// int32; out (B, H, HD) f32. HD in {16, 32, 64, 128}; H % KVH == 0 and
// H / KVH <= 16 (one warp per query head of a group). Returns
// cudaGetLastError().
extern "C" int repro_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* page_map,
                                        const void* lengths, void* out, int B,
                                        int H, int KVH, int HD, int PS, int MP,
                                        int is_bf16, void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > 16 || PS <= 0 || MP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pm = static_cast<const int*>(page_map);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, pm, len, o, B, H, KVH,
                                   HD, PS, MP, s);
  return dispatch<float>(q, k_pages, v_pages, pm, len, o, B, H, KVH, HD, PS,
                         MP, s);
}
