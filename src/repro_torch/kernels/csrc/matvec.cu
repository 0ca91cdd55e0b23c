// Matrix-vector product y = A @ x for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/matvec.py (matvec, body
// _mv_kernel), the paper's MV benchmark: there (bm x bk) tiles of A stream
// through VMEM with an f32 accumulator carried over a sequential k grid; here
// one warp owns one row and loops over K itself.
//
// What bounds it: memory. Every element of A is read once and used for one
// multiply-add (0.5 flop per byte in float32), so the design only streams A
// well: each lane loads 16 bytes of its row at a time (4 floats or 8
// bfloat16), the 32 lanes of a warp cover 512 contiguous bytes, and the loop
// is unrolled so that several loads of each lane are in flight together. x is
// small and is served from L1/L2. The lanes' float32 partial sums meet in a
// warp-shuffle reduction; the sum is rounded once to the output dtype.
// A scalar loop takes rows whose length or alignment does not allow 16-byte
// loads. Summation order differs from the plain version's (cuBLAS), so float32
// results agree to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // 8 warps: 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ a, const T* __restrict__ x,
              T* __restrict__ y, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* arow = a + (long long)row * K;
  float acc = 0.f;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* av = reinterpret_cast<const uint4*>(arow);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int nvec = K / kPer;
#pragma unroll 4
    for (int j = lane; j < nvec; j += 32) {
      uint4 as = __ldg(av + j), xs = __ldg(xv + j);
      const T* ae = reinterpret_cast<const T*>(&as);
      const T* xe = reinterpret_cast<const T*>(&xs);
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc = fmaf(to_f32(ae[e]), to_f32(xe[e]), acc);
    }
  } else {
    for (int k = lane; k < K; k += 32) acc = fmaf(to_f32(arow[k]), to_f32(x[k]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) store(y + row, acc);
}

template <typename T>
cudaError_t run(const void* a, const void* x, void* y, int M, int K,
                cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  constexpr int kPer = 16 / sizeof(T);
  const bool vec = K % kPer == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    matvec_kernel<T, true><<<blocks, kThreads, 0, stream>>>(at, xt, yt, M, K);
  else
    matvec_kernel<T, false><<<blocks, kThreads, 0, stream>>>(at, xt, yt, M, K);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; a [M, K] row-major, x [K], y [M].
extern "C" int matvec_launch(const void* a, const void* x, void* y, int M,
                             int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? run<float>(a, x, y, M, K, s)
                  : dtype == 1 ? run<__nv_bfloat16>(a, x, y, M, K, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
