// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel): q/k/v [B, S, H, hd] with equal head
// counts, scale 1/sqrt(hd), causal or not. The online softmax keeps the
// running (m, l, acc) in float32; a masked score is NEG = -1e30, as there, and
// the output is acc / max(l, 1e-30) in q's dtype. One addition to the TPU
// kernel: a window W > 0 keeps only the keys kpos > qpos - W, the sliding
// window of the model's attention layers (layers.attention_full), and the kv
// loop starts at the first tile that window reaches.
//
// The TPU kernel walks the kv blocks as a sequential grid dimension with the
// accumulators in VMEM scratch. Here one block owns one (batch*head, 64-row q
// tile) and loops over the 64-row kv tiles itself; under a causal mask the
// loop stops at the tile that holds the diagonal, so no fully masked tile is
// read at all.
//
// What bounds it: operations. A causal prefill does about 2*S*S*H*hd
// multiply-adds against 4*S*H*hd elements moved, so at S in the hundreds it
// sits far above the ~295 flops per byte where an H100's tensor cores, not its
// memory, set the limit. Two kernels, one per dtype; the launcher takes the
// route the wrapper chose and refuses one whose dtype does not match:
//
// * route 0 ("fma"), float32: all arithmetic in float32 on the CUDA cores.
//   Each thread computes a 4 x 8 block of the 64 x 64 score tile and 4 rows x
//   ceil(hd/8) columns of the output, from tiles staged in shared memory as
//   float32 (rows padded by one float, so column walks do not conflict on
//   banks). The probabilities go through shared memory from the score layout
//   to the output layout. Tensor-core arithmetic (TF32, bf16) would not meet
//   the float32 tolerance.
// * route 1 ("mma"), bfloat16: warp-level tensor cores, FA2-style. Four warps
//   own 16 query rows each; Q's fragments are loaded once with ldmatrix and
//   stay in registers. K and V tiles are double-buffered in shared memory
//   with 16-byte cp.async, rows padded by 16 bytes (an odd multiple of 16
//   bytes per row) so ldmatrix meets no bank conflict. S = Q K^T and O += P V
//   run on mma.sync.m16n8k16 (bf16 in, float32 accumulate). Masks and the
//   online softmax act on the S accumulators in registers (a row's four lanes
//   reduce by shuffles), and P is rebuilt in registers as the A operand: the
//   m16n8 accumulator layout pairs into the m16n8k16 A layout, so P never
//   goes through shared memory. P is split into two bf16 terms, hi = bf16(p)
//   and lo = bf16(p - hi), each multiplied with V: one rounding of p to bf16
//   (as the TPU kernel does before its P V) leaves about a tenth of the
//   outputs more than one bf16 ulp from the float32 plain version, the split
//   none; l sums the unrounded float32 p. V's fragments come from
//   ldmatrix.trans. A head dim that is not a multiple of 16 is zero-filled up
//   to the next one in shared memory and the columns past hd are never
//   stored. The last q tiles (the most kv tiles under a causal mask) are
//   launched first, so the causal imbalance leaves no tail.
//
// Rows and keys past S are masked too, so any S works; the wrapper keeps the
// TPU kernel's divisibility refusals (S % bq, S % bk). Any hd up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 128;    // 16 row groups (4 rows each) x 8 column lanes
constexpr int kMaxHeadDim = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// max / sum over the 8 lanes that share a row group (lanes 8g .. 8g+7)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + 64) of one (b, h) slice of a [B, S, H, hd] tensor into a
// float32 tile with row stride ld; rows past S and columns past hd are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int S, int H, int hd) {
  for (int idx = threadIdx.x; idx < kBK * ld; idx += kThreads) {
    const int r = idx / ld, d = idx % ld;
    float v = 0.f;
    if (r0 + r < S && d < hd) v = to_f32(src[(long long)(r0 + r) * H * hd + d]);
    dst[idx] = v;
  }
}

template <typename T, int HDV>   // HDV: output columns per thread, ceil(hd / 8)
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int H,
                       int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                    // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;           // [kBK][ld]
  float* Vs = Ks + kBK * ld;           // [kBK][ld]
  float* Ps = Vs + kBK * ld;           // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const long long base = (long long)b * S * H * hd + (long long)h * hd;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  const int tx = threadIdx.x % 8;      // column lane
  const int ty = threadIdx.x / 8;      // row group: rows ty*4 .. ty*4+3

  float acc[4][HDV];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HDV; ++j) acc[i][j] = 0.f;
  }

  load_tile(Qs, ld, qb, q0, S, H, hd);
  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  // a tile left of every row's window holds no key any row keeps; a tile
  // that some rows of this block keep and others do not is masked per row
  // (a row's first tiles may then be all NEG: the tile holding its own
  // position follows, and its alpha = exp(NEG - m) = 0 clears them)
  const int first = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int it = first; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    __syncthreads();                   // the previous tile's Ks/Vs/Ps are consumed
    load_tile(Ks, ld, kb, k0, S, H, hd);
    load_tile(Vs, ld, vb, k0, S, H, hd);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) x = kNeg;
        s[i][j] = x;
        if (kpos < S) mt = fmaxf(mt, x);
      }
      mt = group_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const float p = kpos < S ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 8 * j] = p;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HDV; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < HDV; ++j) {
        // columns past hd read the padding or the next row: those sums
        // are never stored
        const float vv = Vs[c * ld + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + base + (long long)r * H * hd;
#pragma unroll
    for (int j = 0; j < HDV; ++j) {
      const int d = tx + 8 * j;
      if (d < hd) store(o + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int HDV>
int launch_t(const void* q, const void* k, const void* v, void* out, int B, int S,
             int H, int hd, float scale, int causal, int window, cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1));
  auto kernel = flash_attention_kernel<T, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, hd, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S,
             int H, int hd, float scale, int causal, int window, cudaStream_t st) {
  const int hdv = (hd + 7) / 8;
  if (hdv <= 4) return launch_t<T, 4>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  if (hdv <= 8) return launch_t<T, 8>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  if (hdv <= 10)
    return launch_t<T, 10>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  if (hdv <= 12)
    return launch_t<T, 12>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  return launch_t<T, 16>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
}

// ------------------------------------------ bfloat16 on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;     // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 as bf16x2 (x in the low half), and the remainders x - bf16(x)
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// rows [r0, r0 + 64) of one (b, h) slice (row stride rs elements) into a bf16
// tile [64][HDP + 8]; rows past S and columns past hd are zero. vec: hd % 8 ==
// 0 and 16-byte aligned rows, so each 8-column chunk is one cp.async.
template <int HDP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int r0, int S, long long rs, int hd,
                                               bool vec) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  for (int c = threadIdx.x; c < kBK * CH; c += kMmaThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    bf16* d = dst + r * LD + col;
    const bf16* g = src + (long long)(r0 + r) * rs + col;
    if (vec) {
      const bool ok = r0 + r < S && col < hd;
      cp_async16(d, ok ? g : src, ok ? 16 : 0);
    } else {
      union { uint4 v; unsigned short h[8]; } u;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        u.h[e] = (r0 + r < S && col + e < hd) ? __bfloat16_as_ushort(g[e]) : 0;
      *reinterpret_cast<uint4*>(d) = u.v;
    }
  }
}

template <int HDP>   // head dim rounded up to a multiple of 16
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                           int H, int hd, float scale_log2, int causal, int window,
                           int vec) {
  constexpr int LD = HDP + 8;          // row stride: an odd multiple of 16 bytes
  constexpr int KS = HDP / 16;         // k16 steps of Q K^T
  constexpr int NT = HDP / 8;          // n8 tiles of the output
  constexpr int TILE = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* Ks = Qs + TILE;                           // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;         // fragment row, column pair
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // last q tiles first
  const long long rs = (long long)H * hd;
  const long long base = (long long)b * S * rs + (long long)h * hd;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  // a tile left of every row's window holds no key any row keeps; a row's
  // first tiles may still be all NEG (its window starts later in the block):
  // then m = NEG and p = exp(0) = 1 there, until the tile holding its own
  // position, whose alpha = exp(NEG - m) = 0 clears them
  const int first = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const bool use_vec = vec != 0;

  load_tile_bf16<HDP>(Qs, qb, q0, S, rs, hd, use_vec);
  load_tile_bf16<HDP>(Ks, kb, first * kBK, S, rs, hd, use_vec);
  load_tile_bf16<HDP>(Vs, vb, first * kBK, S, rs, hd, use_vec);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 units), partial sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  for (int it = first; it < n_tiles; ++it) {
    const int stage = (it - first) & 1;
    if (it + 1 < n_tiles) {            // prefetch the next kv tile
      load_tile_bf16<HDP>(Ks + (stage ^ 1) * TILE, kb, (it + 1) * kBK, S, rs, hd, use_vec);
      load_tile_bf16<HDP>(Vs + (stage ^ 1) * TILE, vb, (it + 1) * kBK, S, rs, hd, use_vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + stage * TILE;
    const bf16* Vt = Vs + stage * TILE;

    // S = Q K^T: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // masks and the online softmax, in registers. A tile that no mask
    // touches (every key below S, on or left of every row's diagonal, inside
    // every row's window) skips the masks; a key past S scores -inf, so it
    // is in no max and its p is 0.
    const int k0 = it * kBK;
    const bool unmasked = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= q0) &&
                          (window <= 0 || k0 + window > q0 + kBQ - 1);
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[j][e] * scale_log2, x1 = s[j][2 + e] * scale_log2;
        if (!unmasked) {
          const int kpos = k0 + 8 * j + 2 * t + e;
          if ((causal && kpos > row0) || (window > 0 && kpos <= row0 - window)) x0 = kNeg;
          if ((causal && kpos > row1) || (window > 0 && kpos <= row1 - window)) x1 = kNeg;
          if (kpos >= S) x0 = x1 = -INFINITY;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mt0 = fmaxf(mt0, x0);
        mt1 = fmaxf(mt1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(s[j][e] - mn0);
        const float p1 = exp2f(s[j][2 + e] - mn1);
        s[j][e] = p0;
        s[j][2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    l0 = l0 * alpha0 + sum0;           // this lane's part; reduced at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V, P = hi + lo: the accumulators of key tiles 2kk and 2kk + 1
    // are the A fragment of the k16 step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pack(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pack(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], ph, vf[0], vf[1]);
        mma_bf16(o[2 * np], pl, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                   // this stage is consumed: it is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row1 : row0;
    if (r >= S) continue;
    const float inv = half ? inv1 : inv0;
    bf16* orow = out + base + (long long)r * rs;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      const float x = o[n][2 * half] * inv, y = o[n][2 * half + 1] * inv;
      if (use_vec) {                   // hd % 8 == 0: both columns or neither
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < hd) orow[col] = __float2bfloat16(x);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S,
               int H, int hd, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * kBK * (HDP + 8);   // Q, 2 x K, 2 x V
  auto kernel = flash_attention_mma_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, hd, scale * 1.4426950408889634f, causal, window, vec);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* out, int B, int S,
                 int H, int hd, float scale, int causal, int window, cudaStream_t st) {
  switch ((hd + 15) / 16) {
    case 1: return launch_mma<16>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 2: return launch_mma<32>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 3: return launch_mma<48>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 4: return launch_mma<64>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 5: return launch_mma<80>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 6: return launch_mma<96>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    case 7: return launch_mma<112>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
    default: return launch_mma<128>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  }
}

}  // namespace

// q, k, v, out: [B, S, H, hd] row-major, all of one dtype (0 = float32,
// 1 = bfloat16); hd <= 128; window 0 = none. route: 0 the CUDA-core kernel
// (float32 only), 1 the tensor-core kernel (bfloat16 only); a route whose
// dtype does not match is refused. Returns the CUDA error of the launch
// (0 = none).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int hd,
                                      float scale, int causal, int window, int dtype,
                                      int route, void* stream) {
  if (hd <= 0 || hd > kMaxHeadDim || window < 0) return (int)cudaErrorInvalidValue;
  if (!((route == 0 && dtype == 0) || (route == 1 && dtype == 1)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) return dispatch<float>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  return dispatch_mma(q, k, v, out, B, S, H, hd, scale, causal, window, st);
}
