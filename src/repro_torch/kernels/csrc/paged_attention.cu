// Paged-attention decode partials for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention_partial, body _paged_decode_kernel): one query token per
// sequence attends to a KV cache kept as fixed-size physical pages, reached
// through a per-sequence page table. It returns the normalized output and the
// softmax partials (m, l), so the caller can merge the current token's K/V
// online, outside the kernel.
//
// What bounds it: memory. Each layer reads B * ctx * KV * hd * 2 elements of
// K and V (ctx = attended positions) and does about 4 flops per element read,
// far below the ~295 flops per byte at which an H100's tensor cores, and not
// its HBM, become the limit. The design therefore spends its effort on reading
// each K/V element exactly once:
//   * one block per (sequence, KV head) holds the whole G x hd query group of
//     that KV head (GQA is native: K/V rows are loaded once per KV head, not
//     once per query head);
//   * a loop inside the block takes the place of the TPU's sequential grid
//     dimension over pages: it walks only the positions in
//     [limit - window, limit), never the unmapped tail of the page table, and
//     reads each position's physical page id from the page table itself;
//   * K and V rows are staged in shared memory in tiles of 32 positions. The
//     tile's page ids are read first, so its loads are independent of each
//     other and in flight together; each thread moves 16 bytes at a time,
//     neighbouring threads on neighbouring addresses. Values are converted
//     to float32 once; the running (m, l, acc) of the online softmax stay in
//     float32 shared memory.
// Any page size and any head dimension up to 256 work: a tile row is one
// logical position, looked up page by page, so page sizes below a tile (the
// smoke shapes use 4 or 8) and above it are handled alike.
// A simple kernel first: no wgmma, no TMA, no split over the context.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;       // positions staged per iteration (= warp size)
constexpr int kThreads = 128;   // four warps
constexpr float kNeg = -1e30f;  // masked score; an all-masked row ends m=NEG, l=0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_partial_kernel(const T* __restrict__ q,        // [B, KV, G, hd]
                               const T* __restrict__ k_pages,  // [NP, PS, KV, hd]
                               const T* __restrict__ v_pages,  // [NP, PS, KV, hd]
                               const int* __restrict__ page_table,  // [B, P]
                               const int* __restrict__ limit,       // [B]
                               T* __restrict__ out,            // [B, KV, G, hd]
                               float* __restrict__ m_out,      // [B, KV, G]
                               float* __restrict__ l_out,      // [B, KV, G]
                               int KV, int G, int hd, int PS, int P,
                               int window, float scale, int vec) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int ld = hd + 1;  // padded row stride: no bank conflicts on column reads

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [G][ld]
  float* k_s = q_s + G * ld;             // [kTile][ld]
  float* v_s = k_s + kTile * ld;         // [kTile][ld]
  float* p_s = v_s + kTile * ld;         // [G][kTile] scores, then weights
  float* acc_s = p_s + G * kTile;        // [G][hd]
  float* m_s = acc_s + G * hd;           // [G]
  float* l_s = m_s + G;                  // [G]
  float* a_s = l_s + G;                  // [G] rescale factor of this tile
  // [kTile] row offsets, 8-byte aligned (one float of padding reserved)
  long long* row_s = reinterpret_cast<long long*>(
      smem + (((a_s + G) - smem + 1) & ~1L));

  const long qbase = ((long)b * KV + kvh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[(i / hd) * ld + i % hd] = to_f32(q[qbase + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }

  const int lim = limit[b];
  const int hi = min(lim, P * PS);
  const int lo = window > 0 ? max(lim - window, 0) : 0;
  const int* row_pages = page_table + (long)b * P;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and q/acc initialised)
    // ---- element offsets of this tile's rows (-1 past hi): one page-table
    //      read per row, so the K/V loads below are independent of each other
    if (tid < kTile) {
      const int pos = t0 + tid;
      row_s[tid] = pos < hi
          ? (((long long)row_pages[pos / PS] * PS + pos % PS) * KV + kvh) * hd
          : -1;
    }
    __syncthreads();
    // ---- stage K and V rows of positions t0 .. t0+kTile-1 (float32)
    if (vec) {  // 16-byte loads: hd * sizeof(T) is a multiple of 16
      constexpr int kVec = 16 / sizeof(T);
      const int nvec = hd / kVec;
      for (int i = tid; i < kTile * nvec; i += kThreads) {
        const int r = i / nvec, c = (i % nvec) * kVec;
        const long long off = row_s[r];
        uint4 ku = make_uint4(0, 0, 0, 0), vu = ku;
        if (off >= 0) {
          ku = *reinterpret_cast<const uint4*>(k_pages + off + c);
          vu = *reinterpret_cast<const uint4*>(v_pages + off + c);
        }
        const T* kh = reinterpret_cast<const T*>(&ku);
        const T* vh = reinterpret_cast<const T*>(&vu);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          k_s[r * ld + c + j] = to_f32(kh[j]);
          v_s[r * ld + c + j] = to_f32(vh[j]);
        }
      }
    } else {
      for (int i = tid; i < kTile * hd; i += kThreads) {
        const int r = i / hd, d = i % hd;
        const long long off = row_s[r];
        k_s[r * ld + d] = off >= 0 ? to_f32(k_pages[off + d]) : 0.f;
        v_s[r * ld + d] = off >= 0 ? to_f32(v_pages[off + d]) : 0.f;
      }
    }
    __syncthreads();
    // ---- scores s[g][r] = scale * q[g] . k[r], masked past hi
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile;
      float s = kNeg;
      if (t0 + r < hi) {
        const float* qr = q_s + g * ld;
        const float* kr = k_s + r * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      p_s[g * kTile + r] = s;
    }
    __syncthreads();
    // ---- online softmax: one warp per query row, one lane per position
    for (int g = warp; g < G; g += nwarps) {
      const bool valid = t0 + lane < hi;
      const float s = p_s[g * kTile + lane];
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, tmax);
      // explicit re-mask: with every position so far masked, m_new == NEG and
      // exp(s - m_new) would be 1 for the masked ones
      const float p = valid ? expf(s - m_new) : 0.f;
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // ---- acc[g][d] = acc[g][d] * alpha[g] + sum_r p[g][r] * v[r][d]
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* pr = p_s + g * kTile;
      float sum = 0.f;
      for (int r = 0; r < kTile; ++r) sum += pr[r] * v_s[r * ld + d];
      acc_s[i] = acc_s[i] * a_s[g] + sum;
    }
  }
  __syncthreads();
  const long obase = ((long)b * KV + kvh) * G;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    store(out + obase * hd + i, acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
  for (int g = tid; g < G; g += kThreads) {
    m_out[obase + g] = m_s[g];
    l_out[obase + g] = l_s[g];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* limit, void* out, float* m, float* l, int B, int KV,
           int G, int hd, int PS, int P, int window, float scale,
           cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) *
      ((size_t)G * ld + 2 * (size_t)kTile * ld + (size_t)G * kTile +
       (size_t)G * hd + 3 * (size_t)G + 1) + sizeof(long long) * kTile;
  auto kernel = paged_attention_partial_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte loads need 16-byte-aligned rows: torch allocations are aligned,
  // and every row starts at a multiple of hd elements
  const int vec = (hd * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, limit, static_cast<T*>(out), m, l, KV, G,
      hd, PS, P, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" int paged_attention_partial_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* limit, void* out, float* m, float* l,
    int B, int KV, int G, int hd, int PS, int P, int window, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, limit, out, m, l, B,
                         KV, G, hd, PS, P, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, limit, out,
                                 m, l, B, KV, G, hd, PS, P, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
