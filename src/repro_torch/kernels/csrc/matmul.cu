// Matrix product C = A @ B for Hopper (sm_90a), float32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py (matmul, body
// _mm_kernel), the paper's MM benchmark: there (bm x bk) @ (bk x bn) tiles
// stream through VMEM into an f32 scratch carried over a sequential k grid;
// here each block owns one 128 x 128 tile of C, keeps its sums in registers
// and loops over K itself, staging A and B tiles in shared memory.
//
// What bounds it: operations. A square product of side 8192 does 2*8192^3
// flops on 3*8192^2 values, about 2700 flops per byte in bfloat16, far above
// the ~295 at which the tensor cores and not the memory are the limit.
// * bfloat16 runs on the tensor cores with warp-level mma.sync (m16n8k16,
//   f32 accumulators). Eight warps each compute a 64 x 32 piece of the tile as
//   4 x 4 MMA tiles; fragments come from shared memory through ldmatrix (B
//   transposed on the way), and rows are padded by 16 bytes so those reads
//   meet no bank conflict.
// * float32 runs on the CUDA cores (fmaf), never in TF32, whose 10-bit
//   mantissa would not meet the reference's float32 tolerance. Each of 256
//   threads computes an 8 x 8 block of the tile from registers, fed by
//   16-byte reads of a k-major copy of A and of B in shared memory.
// Edges of any shape are masked: loads outside A or B read zeros, stores
// outside C are skipped. 16-byte global loads are used where the row length
// and alignment allow them, else element loads.
// A simple kernel first: single-buffered shared memory, no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------ float32 on the CUDA cores

constexpr int kFM = 128, kFN = 128, kFK = 8, kFT = 8;  // tile, k step, per-thread
constexpr int kFThreads = 256;

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kFThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[kFK][kFM];   // k-major: As[k][m]
  __shared__ __align__(16) float Bs[kFK][kFN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tr = tid / 16, tc = tid % 16;        // 16 x 16 threads of 8 x 8
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;      // 128 rows x 2 quads
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;     // 8 rows x 32 quads
  float acc[kFT][kFT];
#pragma unroll
  for (int i = 0; i < kFT; ++i)
#pragma unroll
    for (int j = 0; j < kFT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    float av[4], bv[4];
    const int gm = m0 + a_row, ga = k0 + a_k;
    if (kVecA && gm < M && ga + 3 < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(A + (size_t)gm * K + ga));
      av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        av[e] = (gm < M && ga + e < K) ? A[(size_t)gm * K + ga + e] : 0.f;
    }
    const int gk = k0 + b_k, gn = n0 + b_col;
    if (kVecB && gk < K && gn + 3 < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(B + (size_t)gk * N + gn));
      bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = (gk < K && gn + e < N) ? B[(size_t)gk * N + gn + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) As[a_k + e][a_row] = av[e];
    *reinterpret_cast<float4*>(&Bs[b_k][b_col]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float ra[kFT], rb[kFT];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tr * kFT]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][tr * kFT + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tc * kFT]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tc * kFT + 4]);
      ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
      ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
      rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
      rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kFT; ++i)
#pragma unroll
        for (int j = 0; j < kFT; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFT; ++i) {
    const int gm = m0 + tr * kFT + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kFT; ++j) {
      const int gn = n0 + tc * kFT + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// ------------------------------------------- bfloat16 on the tensor cores

constexpr int kHM = 128, kHN = 128, kHK = 32;
constexpr int kHThreads = 256;                 // 8 warps: 2 (M) x 4 (N)
constexpr int kLdA = kHK + 8;                  // 80-byte rows
constexpr int kLdB = kHN + 8;                  // 272-byte rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 consecutive bfloat16 from global memory (zeros outside [0, limit))
template <bool kVec>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p,
                                       int valid) {
  if (kVec && valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  union { uint4 v; unsigned short h[8]; } u;
#pragma unroll
  for (int e = 0; e < 8; ++e) u.h[e] = e < valid ? __bfloat16_as_ushort(p[e]) : 0;
  return u.v;
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kHThreads)
hgemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
             __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[kHM * kLdA];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kHK * kLdB];   // [k][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kHM, n0 = blockIdx.x * kHN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kHK) {
    // A tile 128 x 32: 512 chunks of 8, 4 per row; B tile 32 x 128: 16 per row
#pragma unroll
    for (int c = tid; c < kHM * kHK / 8; c += kHThreads) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const int valid = gm < M ? min(8, K - gk) : 0;
      *reinterpret_cast<uint4*>(&As[r * kLdA + kc]) =
          load8<kVecA>(A + (size_t)(gm < M ? gm : 0) * K + gk, valid);
    }
#pragma unroll
    for (int c = tid; c < kHK * kHN / 8; c += kHThreads) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const int valid = gk < K ? min(8, N - gn) : 0;
      *reinterpret_cast<uint4*>(&Bs[r * kLdB + nc]) =
          load8<kVecB>(B + (size_t)(gk < K ? gk : 0) * N + gn, valid);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kHK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[(wm + mi * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ldmatrix_x2_trans(bf[ni], &Bs[(kk + (lane & 15)) * kLdB + wn + ni * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  // C fragment of m16n8: (row g, cols 2t, 2t+1) and (row g + 8, same cols)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + mi * 16 + (lane >> 2) + h * 8;
        const int gn = n0 + wn + ni * 8 + (lane & 3) * 2;
        if (gm >= M) continue;
        if (gn < N) C[(size_t)gm * N + gn] = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        if (gn + 1 < N) C[(size_t)gm * N + gn + 1] = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
      }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 float32, 1 bfloat16; A [M, K], B [K, N], C [M, N], row-major.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M,
                             int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    float* C = static_cast<float*>(c);
    const bool va = K % 4 == 0 && aligned16(a), vb = N % 4 == 0 && aligned16(b);
    if (va && vb) sgemm_kernel<true, true><<<grid, kFThreads, 0, s>>>(A, B, C, M, N, K);
    else if (va) sgemm_kernel<true, false><<<grid, kFThreads, 0, s>>>(A, B, C, M, N, K);
    else if (vb) sgemm_kernel<false, true><<<grid, kFThreads, 0, s>>>(A, B, C, M, N, K);
    else sgemm_kernel<false, false><<<grid, kFThreads, 0, s>>>(A, B, C, M, N, K);
  } else if (dtype == 1) {
    const dim3 grid((N + kHN - 1) / kHN, (M + kHM - 1) / kHM);
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
    const bool va = K % 8 == 0 && aligned16(a), vb = N % 8 == 0 && aligned16(b);
    if (va && vb) hgemm_kernel<true, true><<<grid, kHThreads, 0, s>>>(A, B, C, M, N, K);
    else if (va) hgemm_kernel<true, false><<<grid, kHThreads, 0, s>>>(A, B, C, M, N, K);
    else if (vb) hgemm_kernel<false, true><<<grid, kHThreads, 0, s>>>(A, B, C, M, N, K);
    else hgemm_kernel<false, false><<<grid, kHThreads, 0, s>>>(A, B, C, M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
