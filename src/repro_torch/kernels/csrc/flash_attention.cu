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
// memory, set the limit. This first version does all arithmetic in float32 on
// the CUDA cores (no mma.sync, no wgmma, no TMA): each thread computes a 4 x 8
// block of the 64 x 64 score tile and 4 rows x ceil(hd/8) columns of the
// output, from tiles staged in shared memory as float32 (rows padded by one
// float, so column walks do not conflict on banks). The probabilities go
// through shared memory from the score layout to the output layout. Any head
// dimension up to 128 works (80 for zamba2): the columns past hd are masked.
//
// Rows and keys past S are masked too, so any S works; the wrapper keeps the
// TPU kernel's divisibility refusals (S % bq, S % bk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 128;    // 16 row groups (4 rows each) x 8 column lanes
constexpr int kMaxHeadDim = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// q, k, v, out: [B, S, H, hd] row-major, all of one dtype (0 = float32,
// 1 = bfloat16); hd <= 128; window 0 = none. Returns the CUDA error of the
// launch (0 = none).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int hd,
                                      float scale, int causal, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd <= 0 || hd > kMaxHeadDim || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, hd, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
