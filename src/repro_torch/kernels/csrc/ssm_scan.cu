// Mamba2 SSD chunk scan (G = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan, body
// _ssd_kernel), the per-(batch, head) slice of models/mamba2.ssd_chunked. For
// one (b, h) row, with a = dt * A and cum its running sum inside a chunk:
//
//   intra: y_t  = sum_{s <= t} (C_t . B_s) * exp(cum_t - cum_s) * dt_s * x_s
//   inter: y_t += exp(cum_t) * C_t . h
//   state: h    = exp(cum_Q) * h + sum_s exp(cum_Q - cum_s) * dt_s * x_s B_s^T
//
// The TPU kernel carries h [P, N] in VMEM scratch across a sequential grid
// dimension of chunks. Blocks on Hopper run in no order, so one block owns one
// (b, h) row and walks its chunks in order itself, with h in shared memory.
// Two additions to the TPU kernel: an optional initial state h0, and the final
// state written out at the end (ssd_chunked hands it to decode).
//
// The TPU kernel takes exp(cum_t - cum_s) for every (t, s) and masks after:
// for s > t the exponent is positive and may overflow to inf, and inf * 0 is
// NaN on this card. Here only s <= t is ever exponentiated.
//
// What bounds it: at zamba2's shapes (P = N = 64) the chunked algorithm does
// about 8 * Q * P float32 operations per token and head against 2 * P bytes
// of x in and y out, far above float32's balance point, so operations. This
// first version is simple: float32 on the CUDA cores, one block of 256
// threads per (b, h) row, the chunk's x, B, C, dt staged in shared memory as
// float32 (rows padded by one float, so the column walks do not conflict on
// banks) together with h and the chunk's masked decay matrix M. The kernel
// walks chunks of kQ = 64 steps whatever chunk the caller names: chunking is
// an order of evaluation, not a different recurrence, and 64 keeps the
// staging at 81 KB for P = N = 64. Steps past S are padded as ssd_chunked pads
// them (dt = 0 leaves the state unchanged).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;           // steps per chunk
constexpr int kThreads = 256;
constexpr int kMaxDim = 128;     // P and N

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x,        // [B, S, H, P]
                const float* __restrict__ dt,   // [B, S, H]
                const float* __restrict__ A,    // [H]
                const T* __restrict__ Bm,       // [B, S, N]
                const T* __restrict__ Cm,       // [B, S, N]
                const float* __restrict__ h0,   // [B, H, P, N] or null
                T* __restrict__ y,              // [B, S, H, P]
                float* __restrict__ h_out,      // [B, H, P, N]
                int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ldp = P + 1, ldn = N + 1;
  float* xs = smem;                 // [kQ][ldp]
  float* bs = xs + kQ * ldp;        // [kQ][ldn]
  float* cs = bs + kQ * ldn;        // [kQ][ldn]
  float* hs = cs + kQ * ldn;        // [P][ldn]
  float* ms = hs + P * ldn;         // [kQ][kQ + 1]
  float* dts = ms + kQ * (kQ + 1);  // [kQ]
  float* cum = dts + kQ;            // [kQ]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const float a_h = A[h];

  const long long hbase = (long long)bh * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads)
    hs[(idx / N) * ldn + idx % N] = h0 ? h0[hbase + idx] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    __syncthreads();                // the previous chunk's tiles are consumed
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      xs[t * ldp + p] = t0 + t < S
          ? to_f32(x[(((long long)b * S + t0 + t) * H + h) * P + p]) : 0.f;
    }
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const long long off = ((long long)b * S + t0 + t) * N + n;
      bs[t * ldn + n] = t0 + t < S ? to_f32(Bm[off]) : 0.f;
      cs[t * ldn + n] = t0 + t < S ? to_f32(Cm[off]) : 0.f;
    }
    if (tid < kQ)
      dts[tid] = t0 + tid < S ? dt[((long long)b * S + t0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {                 // cum = cumsum(dt * A), in step order
      float c = 0.f;
      for (int t = 0; t < kQ; ++t) {
        c += dts[t] * a_h;
        cum[t] = c;
      }
    }
    __syncthreads();

    // M[t][s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s for s <= t, else 0
    for (int idx = tid; idx < kQ * kQ; idx += kThreads) {
      const int t = idx / kQ, s = idx % kQ;
      float v = 0.f;
      if (s <= t) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[t * ldn + n], bs[s * ldn + n], cb);
        v = cb * expf(cum[t] - cum[s]) * dts[s];
      }
      ms[t * (kQ + 1) + s] = v;
    }
    __syncthreads();

    // y[t][p] = sum_{s <= t} M[t][s] x[s][p] + exp(cum_t) * sum_n C[t][n] h[p][n]
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      if (t0 + t >= S) continue;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(ms[t * (kQ + 1) + s], xs[s * ldp + p], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cs[t * ldn + n], hs[p * ldn + n], inter);
      store(y + (((long long)b * S + t0 + t) * H + h) * P + p,
            intra + expf(cum[t]) * inter);
    }
    __syncthreads();                // every y read h before it moves on

    // h[p][n] = exp(cum_Q) h[p][n] + sum_s exp(cum_Q - cum_s) dt_s x[s][p] B[s][n]
    const float cq = cum[kQ - 1];
    if (tid < kQ) ms[tid] = expf(cq - cum[tid]) * dts[tid];   // w_s, M is consumed
    __syncthreads();
    const float decay = expf(cq);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float d = 0.f;
      for (int s = 0; s < kQ; ++s) d = fmaf(xs[s * ldp + p] * ms[s], bs[s * ldn + n], d);
      hs[p * ldn + n] = decay * hs[p * ldn + n] + d;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads)
    h_out[hbase + idx] = hs[(idx / N) * ldn + idx % N];
}

template <typename T>
int launch_t(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* h0, void* y, float* h_out, int B, int S,
             int H, int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kQ * (P + 1) + 2 * kQ * (N + 1) +
                                       (size_t)P * (N + 1) + kQ * (kQ + 1) + 2 * kQ);
  auto kernel = ssm_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), h_out, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [B, S, H, P] and Bm, Cm: [B, S, N] of one dtype (0 = float32,
// 1 = bfloat16); dt [B, S, H], A [H], h0 (may be null) and h_out [B, H, P, N]
// float32; P, N <= 128. Returns the CUDA error of the launch (0 = none).
extern "C" int ssm_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm, const float* h0,
                               void* y, float* h_out, int B, int S, int H, int P,
                               int N, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (P <= 0 || N <= 0 || P > kMaxDim || N > kMaxDim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, dt, A, Bm, Cm, h0, y, h_out, B, S, H, P, N, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}
