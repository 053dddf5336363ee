// Kernel C: paged flash decode, one query row per (slot, head), online
// softmax in f32 over the slot's pages read through its page table, with
// each slot's walk split over several blocks (flash decoding).
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
// once), plus q and the output: 8.4 MB on full tables of 4 slots x 512
// positions x 8 kv heads of 128, 2.5 us at 3.35 TB/s. Decode attention does
// one multiply-add per byte or so, far below the tensor cores' line, and a
// handful of slots x kv heads is far fewer than the 132 SMs: what costs time
// is latency, a serial walk and too few blocks, not arithmetic. Measured by
// per-block timer stamps on full tables: ~2 us until the table slice has
// arrived, ~4 us more until the first chunk is scored (its rows arrive
// while every block streams its own), ~1.6 us per further chunk, ~1 us to
// publish a partial and take the counter, ~1 us for the last block's fold.
//
// Design.
// - Split walk. The TPU grid (B, H, MP) carried m / l / acc in VMEM scratch
//   across a sequential page axis. Here the grid is (KVH, B, splits): each
//   block walks one contiguous range of whole 32-row chunks of one slot for
//   one kv head, and serves all G = H / KVH query heads of it (one warp
//   each), so a K/V row is read once for the group. The number of splits is
//   a function of the shape alone (kernels/paged_attention.py split_plan:
//   about two blocks per SM), never of the lengths, which live on the card.
//   A split that starts at or past its slot's length loads nothing and
//   leaves m = -1e30, l = 0.
// - Deterministic combine. With more than one split, each block writes its
//   partial (m, l, acc) per query head in f32 to a workspace; the last block
//   of a (slot, kv head) to arrive (a per-(slot, kv head) counter, which that
//   block resets to 0) copies the partials into shared memory in one round
//   trip (16-byte cp.async) and folds them in the order 0 .. S-1. No float
//   atomics: every call gives the same bits. Each stream has a workspace
//   and counters of its own (kernels/paged_attention.py SCRATCH), so calls
//   on two streams never mix their partials.
// - Copies in flight. The block loads its slice of the page table into
//   shared memory once, then streams K and V rows, in the pool's own type,
//   through a ring of STAGES chunks with 16-byte cp.async: the next chunks
//   load while the current one is scored. A row whose page entry is -1, or
//   whose position is at or past the length, is never read: cp.async
//   zero-fills it. Rows sit in shared memory with their 16-byte pieces
//   XOR-swizzled by row, so lanes reading one piece of eight rows at once
//   hit eight different banks.
// - Arithmetic in f32. Lane r of a warp scores row r of the chunk (q in
//   shared memory as f32, the row widened in registers); the warp takes the
//   chunk's max and sum by shuffles and rescales as online softmax does.
//   P V keeps p in f32: lane r's p is broadcast by shuffle, and each lane
//   accumulates HD / 32 contiguous columns from one vector load per row.
//   Rounding p to bf16 or tf32 for the tensor cores would break the 1e-4
//   tolerance against the f32 plain version, and would save nothing where
//   bytes bound the kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_ops.cuh"

namespace {

constexpr int ROWS = 32;          // positions per chunk: one per lane
constexpr int STAGES = 3;         // chunks in the cp.async ring
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

// N values of T (N * sizeof(T) in {2, 4, 8, 16} bytes, aligned) -> f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* dst) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 16) {
    widen16<T>(*reinterpret_cast<const uint4*>(p), dst);
  } else if constexpr (BYTES == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    widen16<T>(make_uint4(w.x, w.y, 0u, 0u), dst);
  } else if constexpr (BYTES == 4) {
    widen16<T>(make_uint4(*reinterpret_cast<const uint32_t*>(p), 0u, 0u, 0u),
               dst);
  } else {
    static_assert(BYTES == 2, "a lane's columns span 2 to 16 bytes");
    dst[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

template <typename T, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ page_map,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out,
                                    float* __restrict__ ws,
                                    int* __restrict__ counters, int H,
                                    int KVH, int PS, int MP, int span,
                                    float scale) {
  constexpr int VEC = 16 / sizeof(T);    // values per 16-byte piece
  constexpr int CH = HD / VEC;           // pieces per row
  constexpr int RB = CH * 16;            // bytes per row
  constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // output columns per lane
  constexpr int LANES = HD / CPL;        // lanes that own columns
  const int G = H / KVH;
  const int S = gridDim.z;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                // K, V stages
  float* Qs = reinterpret_cast<float*>(smem + STAGES * 2 * ROWS * RB);
  int* tab = reinterpret_cast<int*>(Qs + G * HD);           // table slice

  const int kh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p0 = z * span;                      // this split's positions
  const int pg0 = p0 / PS;
  const int* pm = page_map + (size_t)b * MP;

  // The table slice of the whole split and q, read while the length is
  // read (none of them waits for another)
  const int n_tab = min(MP, (p0 + span + PS - 1) / PS) - pg0;
  for (int i = tid; i < n_tab; i += nt) tab[i] = pm[pg0 + i];
  for (int i = tid; i < G * HD; i += nt)
    Qs[i] = to_f32(q[((size_t)b * H + kh * G) * HD + i]);
  const int n_pos = max(0, min(lengths[b], MP * PS));
  const int p_end = min(p0 + span, n_pos);      // [p0, p_end) are walked
  const int n_chunks = p_end > p0 ? (p_end - p0 + ROWS - 1) / ROWS : 0;
  __syncthreads();

  // Chunk i of the walk into stage i % STAGES; one commit group per chunk.
  auto issue = [&](int i) {
    unsigned char* Ks = ring + (i % STAGES) * 2 * ROWS * RB;
    unsigned char* Vs = Ks + ROWS * RB;
    const int c0 = p0 + i * ROWS;
    for (int e = tid; e < ROWS * CH; e += nt) {
      const int r = e / CH, c = e % CH, t = c0 + r;
      const int phys = t < p_end ? tab[t / PS - pg0] : -1;
      size_t off = 0;
      if (phys >= 0)
        off = (((size_t)phys * PS + t % PS) * KVH + kh) * HD + c * VEC;
      const int bytes = phys >= 0 ? 16 : 0;
      cp_async16(Ks + piece_off<CH>(r, c), kp + off, bytes);
      cp_async16(Vs + piece_off<CH>(r, c), vp + off, bytes);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_chunks) issue(i);
    cp_async_commit();
  }

  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  float m = NEG_INF, l = 0.0f;
  const float* qh = Qs + warp * HD;

  for (int i = 0; i < n_chunks; ++i) {
    if (i + STAGES - 1 < n_chunks) issue(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // chunk i has landed
    __syncthreads();
    const unsigned char* Ks = ring + (i % STAGES) * 2 * ROWS * RB;
    const unsigned char* Vs = Ks + ROWS * RB;

    // lane r scores row r of the chunk for this warp's query head
    const int t = p0 + i * ROWS + lane;
    const bool valid = t < p_end && tab[t / PS - pg0] >= 0;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float kf[VEC];
      widen16<T>(*reinterpret_cast<const uint4*>(Ks + piece_off<CH>(lane, c)),
                 kf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += qh[c * VEC + e] * kf[e];
    }
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
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] *= alpha;
    // lane owns columns lane * CPL .. + CPL, inside one 16-byte piece
    const int col = lane * CPL;
    const int piece = col / VEC, within = (col % VEC) * sizeof(T);
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) {
      const float pr = __shfl_sync(0xffffffffu, p, r);
      if (lane < LANES) {
        float vf[CPL > VEC ? CPL : VEC];
        load_f32<T, CPL>(Vs + piece_off<CH>(r, piece) + within, vf);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] += pr * vf[c];
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();

  const int hq = kh * G + warp;          // this warp's query head
  const int col = lane * CPL;
  if (S == 1) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    float* ob = out + ((size_t)b * H + hq) * HD;
    if (lane < LANES)
#pragma unroll
      for (int c = 0; c < CPL; ++c) ob[col + c] = acc[c] * inv_l;
    return;
  }

  // Partial of split z for (b, kh): acc[G][HD], then m[G], then l[G],
  // padded to whole 16-byte pieces.
  const int PART = G * HD + (2 * G + 3) / 4 * 4;
  float* base = ws + ((size_t)(b * KVH + kh) * S) * PART;
  float* mine = base + (size_t)z * PART;
  if (lane < LANES)
#pragma unroll
    for (int c = 0; c < CPL; ++c) mine[warp * HD + col + c] = acc[c];
  if (lane == 0) {
    mine[G * HD + warp] = m;
    mine[G * HD + G + warp] = l;
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + b * KVH + kh;
    last = atomicAdd(ctr, 1) == S - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Fold the splits in order 0 .. S-1. The block copies the partials into
  // the (idle) ring with 16-byte cp.async, as many splits at a time as fit,
  // while each warp reads the splits' m in parallel for their max. A split
  // with nothing valid has m = -1e30, l = 0 and acc = 0, so its weight
  // exp(m - max) is 0 (or 1 with l = 0 where no split saw a valid row,
  // which leaves the row 0).
  const float* mls = base + G * HD + warp;          // m of split z at z * PART
  const int per = (STAGES * 2 * ROWS * RB) / (PART * 4);  // splits per fill
  float* xs = reinterpret_cast<float*>(ring);
  auto fill = [&](int z0) {
    const int n = min(per, S - z0) * PART / 4;
    const float* src = base + (size_t)z0 * PART;
    for (int e = tid; e < n; e += nt) cp_async16(xs + 4 * e, src + 4 * e, 16);
    cp_async_commit();
  };
  fill(0);
  float mt = NEG_INF;
  for (int zz = lane; zz < S; zz += 32)
    mt = fmaxf(mt, __ldcg(mls + (size_t)zz * PART));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
  float lt = 0.0f, o[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) o[c] = 0.0f;
  for (int z0 = 0; z0 < S; z0 += per) {
    cp_async_wait<0>();
    __syncthreads();
    const int n = min(per, S - z0);
    for (int j = 0; j < n; ++j) {
      const float* part = xs + j * PART;
      const float w = expf(part[G * HD + warp] - mt);
      lt += part[G * HD + G + warp] * w;
      if (lane < LANES) {
        float a[CPL > VEC ? CPL : VEC];
        load_f32<float, CPL>(reinterpret_cast<const unsigned char*>(
                                 part + warp * HD + col), a);
#pragma unroll
        for (int c = 0; c < CPL; ++c) o[c] += a[c] * w;
      }
    }
    __syncthreads();  // every warp is done with these splits
    if (z0 + per < S) fill(z0 + per);
  }
  const float inv_l = 1.0f / fmaxf(lt, 1e-30f);
  float* ob = out + ((size_t)b * H + hq) * HD;
  if (lane < LANES)
#pragma unroll
    for (int c = 0; c < CPL; ++c) ob[col + c] = o[c] * inv_l;
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* pm,
           const int* len, float* out, float* ws, int* counters, int B,
           int H, int KVH, int PS, int MP, int splits, int span,
           cudaStream_t stream) {
  const int G = H / KVH;
  const int rb = HD * static_cast<int>(sizeof(T));
  const int n_tab = span / PS + 2;
  const size_t smem = STAGES * 2 * ROWS * rb + sizeof(float) * G * HD +
                      sizeof(int) * n_tab;
  static size_t granted = 48 * 1024;  // this instantiation's smem limit
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  dim3 grid(KVH, B, splits);
  paged_decode_kernel<T, HD><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pm, len, out, ws, counters, H, KVH, PS, MP,
      span, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* pm,
             const int* len, float* out, float* ws, int* ctr, int B, int H,
             int KVH, int HD, int PS, int MP, int splits, int span,
             cudaStream_t s) {
  switch (HD) {
    case 16: return launch<T, 16>(q, kp, vp, pm, len, out, ws, ctr, B, H, KVH, PS, MP, splits, span, s);
    case 32: return launch<T, 32>(q, kp, vp, pm, len, out, ws, ctr, B, H, KVH, PS, MP, splits, span, s);
    case 64: return launch<T, 64>(q, kp, vp, pm, len, out, ws, ctr, B, H, KVH, PS, MP, splits, span, s);
    case 128: return launch<T, 128>(q, kp, vp, pm, len, out, ws, ctr, B, H, KVH, PS, MP, splits, span, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, HD); k_pages / v_pages (P, PS, KVH, HD); all bf16 (is_bf16 = 1)
// or all f32, contiguous, 16-byte aligned. page_map (B, MP) and lengths (B,)
// int32; out (B, H, HD) f32. HD in {16, 32, 64, 128}; H % KVH == 0 and
// H / KVH <= 16 (one warp per query head of a group). The plan: `splits`
// ranges of `span` positions (a multiple of 32) cover 0 .. MP * PS; with
// splits > 1, `ws` holds B * KVH * splits * (G * HD + 2 * G rounded up to a
// multiple of 4) floats and
// `counters` B * KVH ints, all 0 (the kernel leaves them 0). Returns
// cudaGetLastError().
extern "C" int repro_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* page_map,
                                        const void* lengths, void* out,
                                        void* ws, void* counters, int B,
                                        int H, int KVH, int HD, int PS,
                                        int MP, int splits, int span,
                                        int is_bf16, void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > 16 || PS <= 0 || MP <= 0 ||
      splits <= 0 || span <= 0 || span % ROWS ||
      (long long)splits * span < (long long)MP * PS ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pm = static_cast<const int*>(page_map);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, pm, len, o, w, c, B,
                                   H, KVH, HD, PS, MP, splits, span, s);
  return dispatch<float>(q, k_pages, v_pages, pm, len, o, w, c, B, H, KVH,
                         HD, PS, MP, splits, span, s);
}
