// Paged-attention decode partials for Hopper (sm_90a), split across the
// context (flash-decoding).
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
// its HBM, become the limit. At serving shapes (8 sequences, 4 KV heads,
// contexts of a few hundred) the bytes are a few megabytes, so what sets the
// time is how many loads are in flight at once, over how many SMs. The TPU
// kernel walks the pages of a sequence in order on one core; here the context
// is cut into partitions that run on blocks of their own, in two passes that
// one launcher call enqueues:
//   * pass 1, grid (split, KV head, sequence): each block takes the
//     positions of one partition of `part` consecutive positions (aligned to
//     position 0) that lie in [limit - window, limit), and writes the float32
//     partials (m_i, l_i, acc_i) of the G query rows of its KV head (GQA is
//     native: each K/V row is read once per KV head). A block whose partition
//     misses that range exits at once. Each block reads its rows' physical
//     offsets from the page table once, then streams K and V in tiles of 32
//     positions through two shared-memory stages with 16-byte cp.async, so
//     tile t+1 is in flight while tile t is scored. K and V stay in their own
//     dtype in shared memory (rows padded to an odd multiple of 16 bytes, so
//     the 16-byte reads of a row per lane meet no bank conflict) and are
//     converted as they are read. One warp owns a query row at a time: a lane
//     scores one position, the warp reduces the tile's max and sum by
//     shuffles, and each lane accumulates its head-dim columns of p . V;
//   * pass 2, grid (KV head, sequence): merges the partitions that meet the
//     row's range in partition order, with no atomics: M = max m_i,
//     l = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / l, rounded once
//     to q's dtype. An all-masked row (M = NEG) gives zeros, m = NEG, l = 0.
//     It is a programmatic dependent launch: its blocks start while pass 1
//     drains and wait (griddepcontrol.wait) before they read the partials.
// Pass 1's page-table and query loads do not wait for the limit, and the
// merge stages its weights in shared memory, so that neither pass chains
// dependent loads (at the serving shape that took the kernel from 0.036 to
// 0.022 ms on an H100, PERF.md).
// The partitions of a row depend on its own limit and window only, never on
// the batch, the other rows or the SM count, so a row's result is the same
// bit for bit whatever batch it is launched in. The split dimension of the
// grid is ceil(P * PS / part), which the host knows from the page table's
// width; limits are read on the card only.
// Any page size and any head dimension up to 256 work: a tile row is one
// logical position, looked up page by page. Head dims whose rows are no
// multiple of 16 bytes take element loads instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;       // positions per pipeline stage (= warp size)
constexpr int kThreads = 256;   // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // partitions merged per step of pass 2
constexpr float kNeg = -1e30f;  // masked score; an all-masked row ends m=NEG, l=0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// attended positions of a row: [lo, hi)
__device__ __forceinline__ void row_range(int lim, int window, int P, int PS,
                                          int& lo, int& hi) {
  hi = min(lim, P * PS);
  lo = window > 0 ? max(lim - window, 0) : 0;
}

// bytes of one K or V row in shared memory: an odd multiple of 16
__host__ __device__ __forceinline__ int row_bytes(int hd, int elem) {
  const int n16 = (hd * elem + 15) / 16;
  return 16 * (n16 | 1);
}

// Pass 1. kCols = head-dim columns per lane (hd <= 32 * kCols).
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const T* __restrict__ q,            // [B, KV, G, hd]
                      const T* __restrict__ k_pages,      // [NP, PS, KV, hd]
                      const T* __restrict__ v_pages,      // [NP, PS, KV, hd]
                      const int* __restrict__ page_table,  // [B, P]
                      const int* __restrict__ limit,       // [B]
                      float* __restrict__ acc_out,  // [B, KV, NS, G, hd]
                      float* __restrict__ m_out,    // [B, KV, NS, G]
                      float* __restrict__ l_out,    // [B, KV, NS, G]
                      int KV, int G, int hd, int PS, int P, int window,
                      float scale, int part, int vec) {
  // let pass 2 launch now: it waits for this grid's end before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rowb = row_bytes(hd, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem;                            // [2][K, V][kTile][rowb]
  long long* off_s = reinterpret_cast<long long*>(kv_s + 4 * kTile * rowb);  // [part]
  // 16-byte aligned (part is a multiple of 32) for float4 reads of p and q
  float* p_s = reinterpret_cast<float*>(off_s + part);   // [kWarps][kTile]
  float* q_s = p_s + kWarps * kTile;                     // [G][hd]
  float* acc_s = q_s + G * hd;                           // [G][hd]
  float* m_s = acc_s + G * hd;                           // [G]
  float* l_s = m_s + G;                                  // [G]

  // element offsets of the partition's rows (one page-table read each) and
  // the query group: loads that do not wait for the limit, all in flight
  // together with it
  const int lim = limit[b];
  const int base = split * part;
  const int* row_pages = page_table + (long)b * P;
  for (int i = tid; i < part; i += kThreads) {
    const int pos = base + i;
    if (pos < P * PS)
      off_s[i] = (((long long)row_pages[pos / PS] * PS + pos % PS) * KV + kvh) * hd;
  }
  const long qbase = ((long)b * KV + kvh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[qbase + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  int lo, hi;
  row_range(lim, window, P, PS, lo, hi);
  const int p0 = max(base, lo), p1 = min(base + part, hi);
  if (p0 >= p1) return;  // the combine never reads this partition
  __syncthreads();

  // K and V rows of positions t0 .. t0 + kTile - 1 into stage `st`; rows
  // past p1 are zero (their scores are masked, and 0 * garbage could be NaN)
  auto issue = [&](int t0, int st) {
    unsigned char* kb = kv_s + st * 2 * kTile * rowb;
    unsigned char* vb = kb + kTile * rowb;
    const int rows = min(kTile, p1 - t0);
    if (vec) {
      constexpr int kVec = 16 / sizeof(T);
      const int nvec = hd / kVec;
      for (int i = tid; i < kTile * nvec; i += kThreads) {
        const int r = i / nvec, c = i % nvec;
        const bool ok = r < rows;
        const long long off = ok ? off_s[t0 - base + r] + c * kVec : 0;
        cp_async16(kb + r * rowb + c * 16, k_pages + off, ok ? 16 : 0);
        cp_async16(vb + r * rowb + c * 16, v_pages + off, ok ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < kTile * hd; i += kThreads) {
        const int r = i / hd, d = i % hd;
        T* kd = reinterpret_cast<T*>(kb + r * rowb) + d;
        T* vd = reinterpret_cast<T*>(vb + r * rowb) + d;
        if (r < rows) {
          const long long off = off_s[t0 - base + r] + d;
          *kd = k_pages[off];
          *vd = v_pages[off];
        } else {
          store(kd, 0.f);
          store(vd, 0.f);
        }
      }
    }
  };

  float* p_w = p_s + warp * kTile;
  const int ntiles = (p1 - p0 + kTile - 1) / kTile;
  issue(p0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = p0 + t * kTile;
    if (vec) cp_async_wait_all();
    // tile t visible to every warp; every warp done with tile t - 1, whose
    // stage the next issue overwrites
    __syncthreads();
    if (t + 1 < ntiles) issue(t0 + kTile, (t + 1) & 1);
    const unsigned char* kb = kv_s + (t & 1) * 2 * kTile * rowb;
    const unsigned char* vb = kb + kTile * rowb;
    const bool valid = t0 + lane < p1;
    const T* krow = reinterpret_cast<const T*>(kb + lane * rowb);
    for (int g = warp; g < G; g += kWarps) {
      const float m_prev = m_s[g], l_prev = l_s[g];
      const float* qg = q_s + g * hd;
      // ---- score of this lane's position (four partial sums for ILP)
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      if (vec) {
        constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
        for (int c = 0; c < 32 * kCols; c += kVec) {
          if (c >= hd) break;
          const uint4 u = *reinterpret_cast<const uint4*>(krow + c);
          const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {  // q row: broadcast float4 reads
            const float4 qv = *reinterpret_cast<const float4*>(qg + c + j);
            d4[0] = fmaf(qv.x, to_f32(e[j]), d4[0]);
            d4[1] = fmaf(qv.y, to_f32(e[j + 1]), d4[1]);
            d4[2] = fmaf(qv.z, to_f32(e[j + 2]), d4[2]);
            d4[3] = fmaf(qv.w, to_f32(e[j + 3]), d4[3]);
          }
        }
      } else {
        for (int d = 0; d < hd; ++d) d4[0] = fmaf(qg[d], to_f32(krow[d]), d4[0]);
      }
      const float s = valid ? ((d4[0] + d4[1]) + (d4[2] + d4[3])) * scale : kNeg;
      // ---- online softmax over the tile
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_prev, tmax);
      // explicit re-mask: exp(s - m_new) is 1 for a masked s when m_new == NEG
      const float p = valid ? expf(s - m_new) : 0.f;
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m_prev - m_new);
      p_w[lane] = p;
      __syncwarp();
      // ---- acc[g][d] = acc[g][d] * alpha + sum_r p_r v[r][d], d = lane + 32 k
      float a[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) a[k] = 0.f;
#pragma unroll
      for (int r = 0; r < kTile; r += 4) {
        const float4 pr = *reinterpret_cast<const float4*>(p_w + r);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* vrow = reinterpret_cast<const T*>(vb + (r + j) * rowb);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int d = lane + 32 * k;
            if (d < hd) a[k] = fmaf(pv[j], to_f32(vrow[d]), a[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int d = lane + 32 * k;
        if (d < hd) acc_s[g * hd + d] = acc_s[g * hd + d] * alpha + a[k];
      }
      __syncwarp();  // p_w and m_s / l_s of this row: read by every lane
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_prev * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const long pbase = ((long)b * KV + kvh) * NS + split;
  for (int i = tid; i < G * hd; i += kThreads) acc_out[pbase * G * hd + i] = acc_s[i];
  for (int g = tid; g < G; g += kThreads) {
    m_out[pbase * G + g] = m_s[g];
    l_out[pbase * G + g] = l_s[g];
  }
}

// Pass 2: merge the partitions of one (sequence, KV head), kChunk at a time,
// in partition order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ acc_in,  // [B, KV, NS, G, hd]
                     const float* __restrict__ m_in,    // [B, KV, NS, G]
                     const float* __restrict__ l_in,    // [B, KV, NS, G]
                     const int* __restrict__ limit,     // [B]
                     T* __restrict__ out,               // [B, KV, G, hd]
                     float* __restrict__ m_out,         // [B, KV, G]
                     float* __restrict__ l_out,         // [B, KV, G]
                     int KV, int G, int hd, int PS, int P, int window,
                     int part, int NS) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float cs[];
  float* w_s = cs;                  // [kChunk][G] weights e^(m_i - M)
  float* lw_s = w_s + kChunk * G;   // [kChunk][G] l_i e^(m_i - M)
  float* o_s = lw_s + kChunk * G;   // [G][hd] running sums
  float* M_s = o_s + G * hd;        // [G]
  float* l_s = M_s + G;             // [G]
  int lo, hi;
  row_range(limit[b], window, P, PS, lo, hi);
  // exactly the partitions that pass 1 wrote for this row
  const int s_lo = lo < hi ? lo / part : 0;
  const int s_hi = lo < hi ? (hi - 1) / part + 1 : 0;
  const long row = (long)b * KV + kvh;
  const float* mr = m_in + row * NS * G;
  const float* lr = l_in + row * NS * G;
  const float* ar = acc_in + row * NS * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) o_s[i] = 0.f;
  // pass 1 complete and its writes visible (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // M of each query row: one lane per partition
  for (int g = warp; g < G; g += kWarps) {
    float M = kNeg;
    for (int s = s_lo + lane; s < s_hi; s += 32) M = fmaxf(M, mr[s * G + g]);
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    if (lane == 0) {
      M_s[g] = M;
      l_s[g] = 0.f;
    }
  }
  __syncthreads();
  for (int c0 = s_lo; c0 < s_hi; c0 += kChunk) {
    const int n = min(kChunk, s_hi - c0);
    for (int j = tid; j < n * G; j += kThreads) {
      const int g = j % G;
      const float M = M_s[g];
      // an all-masked row: e^0 times an empty partial must not leak
      const float w = M > kNeg ? expf(mr[c0 * G + j] - M) : 0.f;
      w_s[j] = w;
      lw_s[j] = lr[c0 * G + j] * w;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float l = l_s[g];
      for (int j = 0; j < n; ++j) l += lw_s[j * G + g];
      l_s[g] = l;
    }
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const float* a = ar + (long)c0 * G * hd + i;
      float acc = o_s[i];
#pragma unroll 8
      for (int j = 0; j < n; ++j) acc += a[(long)j * G * hd] * w_s[j * G + g];
      o_s[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    store(out + row * G * hd + i, o_s[i] / fmaxf(l_s[g], 1e-30f));
  }
  for (int g = tid; g < G; g += kThreads) {
    m_out[row * G + g] = M_s[g];
    l_out[row * G + g] = l_s[g];
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int kCols>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* limit, void* out, float* m, float* l, float* scratch,
           int B, int KV, int G, int hd, int PS, int P, int window,
           float scale, int part, int NS, cudaStream_t stream) {
  const size_t smem1 = 4 * (size_t)kTile * row_bytes(hd, sizeof(T)) +
                       sizeof(long long) * part +
                       sizeof(float) * (2 * (size_t)G * hd + kWarps * kTile + 2 * (size_t)G);
  const size_t smem2 = sizeof(float) * (2 * (size_t)kChunk * G + (size_t)G * hd + 2 * (size_t)G);
  auto partials = paged_partials_kernel<T, kCols>;
  auto combine = paged_combine_kernel<T>;
  int e = allow_smem(partials, smem1);
  if (e == 0) e = allow_smem(combine, smem2);
  if (e != 0) return e;
  // 16-byte copies need 16-byte-aligned rows: torch allocations are aligned,
  // and every row starts at a multiple of hd elements
  const int vec = (hd * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // scratch: acc [B, KV, NS, G, hd], then m and l [B, KV, NS, G] each
  const size_t n_acc = (size_t)B * KV * NS * G * hd, n_ml = (size_t)B * KV * NS * G;
  float* acc_p = scratch;
  float* m_p = acc_p + n_acc;
  float* l_p = m_p + n_ml;
  partials<<<dim3(NS, KV, B), kThreads, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, limit, acc_p, m_p, l_p, KV, G, hd, PS, P,
      window, scale, part, vec);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  // pass 2 may start while pass 1 drains; griddepcontrol.wait orders its reads
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, combine, (const float*)acc_p, (const float*)m_p,
                              (const float*)l_p, limit, static_cast<T*>(out), m, l,
                              KV, G, hd, PS, P, window, part, NS);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cols(const void* q, const void* k, const void* v, const int* pt,
                const int* limit, void* out, float* m, float* l, float* scratch,
                int B, int KV, int G, int hd, int PS, int P, int window,
                float scale, int part, int NS, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, pt, limit, out, m, l, scratch, B, KV, G, hd, PS, P,
                        window, scale, part, NS, s);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, pt, limit, out, m, l, scratch, B, KV, G, hd, PS, P,
                        window, scale, part, NS, s);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, pt, limit, out, m, l, scratch, B, KV, G, hd, PS, P,
                        window, scale, part, NS, s);
  return launch<T, 8>(q, k, v, pt, limit, out, m, l, scratch, B, KV, G, hd, PS, P,
                      window, scale, part, NS, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Enqueues both passes on `stream`:
// partials into `scratch` (B * KV * splits * G * (hd + 2) floats), then their
// merge into out, m, l. `splits` must be ceil(P * PS / partition) and
// `partition` a positive multiple of 32. Returns the CUDA error of the
// launches (0 = launched); the caller raises on anything else.
extern "C" int paged_attention_partial_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* limit, void* out, float* m, float* l,
    float* scratch, int B, int KV, int G, int hd, int PS, int P, int window,
    float scale, int partition, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partition <= 0 || partition % kTile != 0 ||
      splits != (P * PS + partition - 1) / partition || hd > 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (dtype == 0)
    return launch_cols<float>(q, k_pages, v_pages, page_table, limit, out, m, l,
                              scratch, B, KV, G, hd, PS, P, window, scale,
                              partition, splits, s);
  if (dtype == 1)
    return launch_cols<__nv_bfloat16>(q, k_pages, v_pages, page_table, limit, out,
                                      m, l, scratch, B, KV, G, hd, PS, P, window,
                                      scale, partition, splits, s);
  return (int)cudaErrorInvalidValue;
}
