// 5-point 2-D stencil with a zero boundary for Hopper (sm_90a):
//   out[i,j] = w_c*u[i,j] + w_s*(((u[i-1,j] + u[i+1,j]) + u[i,j-1]) + u[i,j+1])
//
// Replaces the TPU kernel src/repro/kernels/stencil2d.py (stencil2d, body
// _stencil_kernel), the paper's stencil benchmark. The TPU kernel pads the
// whole input with zeros in HBM and reads haloed windows from the padded copy;
// here each block stages its (32+2) x (32+2) haloed tile in shared memory and
// writes the zeros of the boundary itself, so no padded copy is made.
//
// What bounds it: memory. Each output reads one input and writes one value
// for 6 flops (0.75 flop per byte), so the kernel aims at reading each input
// once from device memory: neighbouring threads load neighbouring addresses,
// and the halo rows and columns that two tiles share are served from L2.
// Each thread computes 4 outputs of the tile from shared memory.
//
// Rounding: the sums are taken in the plain version's order, in float32, and
// no fused multiply-add is formed (__fadd_rn, __fmul_rn), so float32 results
// equal the plain PyTorch version bit for bit. A bfloat16 input computes in
// bfloat16, as the TPU kernel and the plain version do: each product and sum
// is taken in float32 and rounded to bfloat16 at once, which gives the
// correctly rounded bfloat16 result (float32 holds more than twice
// bfloat16's 8 significant bits), so bfloat16 results equal the plain
// version bit for bit too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;            // columns per tile (one warp across)
constexpr int kTileY = 32;            // rows per tile
constexpr int kRowsPerPass = 8;       // thread rows: each thread makes 4 outputs
constexpr int kThreads = kTileX * kRowsPerPass;
constexpr int kHaloX = kTileX + 2;
constexpr int kHaloY = kTileY + 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to T's precision (and kept in float32)
__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ u, T* __restrict__ out, int M,
                 int N, float w_center, float w_side) {
  __shared__ float s[kHaloY][kHaloX + 1];   // +1: no bank conflicts down a column
  const int i0 = blockIdx.y * kTileY, j0 = blockIdx.x * kTileX;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int idx = ty * kTileX + tx; idx < kHaloY * kHaloX; idx += kThreads) {
    const int r = idx / kHaloX, c = idx % kHaloX;
    const int gi = i0 + r - 1, gj = j0 + c - 1;
    s[r][c] = (gi >= 0 && gi < M && gj >= 0 && gj < N)
                  ? to_f32(u[(long long)gi * N + gj]) : 0.f;
  }
  __syncthreads();
  const int j = j0 + tx;
#pragma unroll
  for (int p = 0; p < kTileY / kRowsPerPass; ++p) {
    const int r = ty + p * kRowsPerPass;
    const int i = i0 + r;
    if (i < M && j < N) {
      const T t{};
      const float side = rnd(
          __fadd_rn(rnd(__fadd_rn(rnd(__fadd_rn(s[r][tx + 1], s[r + 2][tx + 1]), t),
                                  s[r + 1][tx]), t),
                    s[r + 1][tx + 2]), t);
      store(out + (long long)i * N + j,
            __fadd_rn(rnd(__fmul_rn(w_center, s[r + 1][tx + 1]), t),
                      rnd(__fmul_rn(w_side, side), t)));
    }
  }
}

}  // namespace

// u, out: [M, N] row-major, float32 (dtype 0) or bfloat16 (dtype 1).
extern "C" int stencil2d_launch(const void* u, void* out, int M, int N,
                                float w_center, float w_side, int dtype,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kTileX - 1) / kTileX, (M + kTileY - 1) / kTileY);
  const dim3 block(kTileX, kRowsPerPass);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    stencil2d_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(u), static_cast<float*>(out), M, N, w_center, w_side);
  else if (dtype == 1)
    stencil2d_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(out), M, N,
        w_center, w_side);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
