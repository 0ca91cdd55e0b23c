// AXPY out = a * x + y for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/axpy.py (axpy, body _axpy_kernel),
// the paper's Fig. 8 kernel: there a 1-D Pallas grid of VMEM blocks; here a
// grid-stride loop of threads.
//
// What bounds it: memory. Each element reads 2 values and writes 1 and does 2
// flops, far below the H100's ~20 flops per byte (float32 CUDA cores), so the
// design only moves bytes well: each thread loads and stores 16 bytes at a time
// (4 floats or 8 bfloat16), neighbouring threads on neighbouring addresses, and
// a grid of a few blocks per SM strides over the array. A scalar loop takes the
// tail, and the whole array when a pointer is not 16-byte aligned.
//
// Rounding: the product rounds before the sum (__fmul_rn, __fadd_rn), so no
// fused multiply-add changes the result: float32 equals the plain PyTorch
// version (two separate ops) bit for bit. bfloat16 computes each op in float32
// and rounds it to bfloat16, as PyTorch's own bfloat16 ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ __nv_bfloat16 axpy1(float a, __nv_bfloat16 x,
                                               __nv_bfloat16 y) {
  const __nv_bfloat16 ax = __float2bfloat16_rn(__fmul_rn(a, __bfloat162float(x)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(ax), __bfloat162float(y)));
}

// 16 bytes of T as one vector load / store
template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_vec_kernel(const T* __restrict__ x, const T* __restrict__ y,
                T* __restrict__ out, float a, long long n) {
  constexpr int kPer = 16 / sizeof(T);
  const long long nvec = n / kPer;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    uint4 xs = xv[i], ys = yv[i], os;
    const T* xe = reinterpret_cast<const T*>(&xs);
    const T* ye = reinterpret_cast<const T*>(&ys);
    T* oe = reinterpret_cast<T*>(&os);
#pragma unroll
    for (int j = 0; j < kPer; ++j) oe[j] = axpy1(a, xe[j], ye[j]);
    ov[i] = os;
  }
  // the tail that does not fill a vector
  for (long long i = nvec * kPer + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = axpy1(a, x[i], y[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_scalar_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, float a, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = axpy1(a, x[i], y[i]);
}

template <typename T>
cudaError_t run(const void* x, const void* y, void* out, float a, long long n,
                cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int kPer = 16 / sizeof(T);
  const long long work = (n + kPer - 1) / kPer;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // 8 blocks of 256 fill an SM
  if (blocks > cap) blocks = cap;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (aligned)
    axpy_vec_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(xt, yt, ot, a, n);
  else
    axpy_scalar_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(xt, yt, ot, a, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. `a` is already rounded to that dtype.
extern "C" int axpy_launch(const void* x, const void* y, void* out, float a,
                           long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? run<float>(x, y, out, a, n, s)
                  : dtype == 1 ? run<__nv_bfloat16>(x, y, out, a, n, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
