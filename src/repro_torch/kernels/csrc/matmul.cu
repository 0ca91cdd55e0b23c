// Matrix product C = A @ B for Hopper (sm_90a), float32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py (matmul, body
// _mm_kernel), the paper's MM benchmark: there (bm x bk) @ (bk x bn) tiles
// stream through VMEM into an f32 scratch carried over a sequential k grid;
// here each block owns one tile of C, keeps its sums in registers and loops
// over K itself, staging A and B tiles in shared memory.
//
// What bounds it: operations. A square product of side 8192 does 2*8192^3
// flops on 3*8192^2 values, about 2700 flops per byte in bfloat16, far above
// the ~295 at which the tensor cores and not the memory are the limit. Three
// kernels; the wrapper picks the route before the launch (never after a
// failure) and the launcher refuses a route whose preconditions fail:
// * route 2 ("wgmma"), bfloat16, both operands 16-byte aligned and K, N
//   multiples of 8 (TMA's 16-byte stride rule): warp-specialised blocks of
//   three warpgroups own a 128 x 256 tile of C. One producer thread
//   (setmaxnreg.dec) issues TMA loads (cp.async.bulk.tensor.2d) of an A tile
//   [128 x 64] and a B tile [64 x 256] (four 64-column boxes) per stage into a
//   ring of 4 stages (192 KB) with full and empty mbarriers. Two consumer
//   warpgroups (setmaxnreg.inc) each run wgmma.mma_async m64n256k16 on 64 rows,
//   reading both operands from shared memory in the 128-byte swizzled layout
//   the TMA wrote: A K-major, B [K, N] row-major, so MN-major (the transpose
//   flag set). Accumulators stay float32 in registers; C is rounded to bf16
//   once in a masked epilogue. TMA zero-fills rows and columns outside A and
//   B, so ragged M, N and K need no masked loads. Blocks walk the tiles in
//   groups of 16 m tiles, so the blocks in flight share their A and B panels
//   in L2 (at 8192^3 that took the kernel from 2.2 to 1.5 ms on an H100,
//   PERF.md). The tensor maps are encoded on the host per launch with
//   cuTensorMapEncodeTiled, reached through the runtime's driver entry
//   point, so the library links no -lcuda.
// * route 1 ("mma"), bfloat16, any shape and alignment: warp-level mma.sync
//   (m16n8k16, f32 accumulators). Eight warps each compute a 64 x 32 piece of
//   a 128 x 128 tile as 4 x 4 MMA tiles; fragments come from shared memory
//   through ldmatrix (B transposed on the way), and rows are padded by 16
//   bytes so those reads meet no bank conflict. Single-buffered, synchronous
//   tile loads.
// * route 0 ("fma"), float32: the CUDA cores (fmaf), never TF32, whose 10-bit
//   mantissa would not meet the reference's float32 tolerance. Each of 128
//   threads computes an 8 x 16 block of a 128 x 128 tile from registers, fed
//   by 16-byte reads of a k-major copy of A and of B in two shared-memory
//   stages: the next k tile's loads (A through registers, B by cp.async) are
//   in flight during the current tile's FMAs, with one barrier per k step of
//   16 (8192^3 from 30.4 to 23.7 ms on an H100, PERF.md).
// On routes 0 and 1, edges of any shape are masked: loads outside A or B read
// zeros, stores outside C are skipped; 16-byte global loads are used where
// the row length and alignment allow them, else element loads.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------ float32 on the CUDA cores

constexpr int kFM = 128, kFN = 128, kFK = 16;  // tile and k step
constexpr int kFThreads = 128;                 // 16 x 8 threads of 8 x 16 outputs
constexpr int kFPad = 4;                       // As row padding (floats)
constexpr int kFQuads = kFK / 4;               // float4s per A row of a k tile
constexpr int kFLoads = kFM * kFK / 4 / kFThreads;  // float4s a thread loads per operand
// two stages of As [kFK][kFM + kFPad] and Bs [kFK][kFN], 33 KB; dynamic:
// the same kernel with static arrays ran slower on an H100
constexpr int kFSmem = 2 * kFK * (kFM + kFPad + kFN) * 4;

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

// Two shared-memory stages, one __syncthreads per k step: the loads of k
// tile t+1 are issued before the FMAs of tile t (A into registers, stored
// k-major after the FMAs; B by cp.async straight into the other stage), so
// their latency hides behind the FMAs. Thread (tr, tc) owns rows
// tr*4 + {0..3} and 64 + tr*4 + {0..3}, and columns tc*4 + {0..3} + 32 q for
// q < 4: 128 independent FMAs per k for 6 fragment reads. A warp covers 4 tr
// x 8 tc, so a quarter-warp reads one A float4 (a broadcast) and eight
// consecutive B float4s (128 bytes): fragment reads meet no bank conflict.
// As rows are padded by 4 floats so that the transposing stores of A meet
// few.
template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kFThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float fsmem[];
  auto As = reinterpret_cast<float (*)[kFK][kFM + kFPad]>(fsmem);   // k-major: As[k][m]
  auto Bs = reinterpret_cast<float (*)[kFK][kFN]>(fsmem + 2 * kFK * (kFM + kFPad));
  constexpr int kQ = 4, kQStride = kFN / kQ;   // column quads of a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tr = warp * 4 + (lane >> 3), tc = lane & 7;
  float acc[8][4 * kQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kQ; ++j) acc[i][j] = 0.f;

  float av[kFLoads][4], bv[kFLoads][4];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kFLoads; ++l) {
      const int e4 = tid + l * kFThreads;
      const int gm = m0 + e4 / kFQuads, ga = k0 + (e4 % kFQuads) * 4;
      if (kVecA && gm < M && ga < K) {   // K % 4 == 0: the quad is whole
        const float4 v = __ldg(reinterpret_cast<const float4*>(A + (size_t)gm * K + ga));
        av[l][0] = v.x; av[l][1] = v.y; av[l][2] = v.z; av[l][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          av[l][e] = (gm < M && ga + e < K) ? A[(size_t)gm * K + ga + e] : 0.f;
      }
    }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int l = 0; l < kFLoads; ++l) {
      const int e4 = tid + l * kFThreads;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[st][(e4 % kFQuads) * 4 + e][e4 / kFQuads] = av[l][e];
    }
  };
  auto load_b = [&](int k0, int st) {
#pragma unroll
    for (int l = 0; l < kFLoads; ++l) {
      const int e4 = tid + l * kFThreads;
      const int bk = e4 / (kFN / 4), bc = (e4 % (kFN / 4)) * 4;
      const int gk = k0 + bk, gn = n0 + bc;
      if (kVecB) {   // N % 4 == 0: a quad is whole or wholly outside (zero-fill)
        const bool ok = gk < K && gn < N;
        cp_async16(&Bs[st][bk][bc], ok ? B + (size_t)gk * N + gn : B, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[l][e] = (gk < K && gn + e < N) ? B[(size_t)gk * N + gn + e] : 0.f;
      }
    }
  };
  auto store_b = [&](int st) {
    if (kVecB) return;
#pragma unroll
    for (int l = 0; l < kFLoads; ++l) {
      const int e4 = tid + l * kFThreads;
      const int bk = e4 / (kFN / 4), bc = (e4 % (kFN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[st][bk][bc]) =
          make_float4(bv[l][0], bv[l][1], bv[l][2], bv[l][3]);
    }
  };

  const int nk = (K + kFK - 1) / kFK;
  if (nk > 0) {
    load_a(0);
    load_b(0, 0);
    cp_async_commit();
    store_a(0);
    store_b(0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a((kt + 1) * kFK);
      load_b((kt + 1) * kFK, cur ^ 1);
      cp_async_commit();
    }
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float ra[8], rb[4 * kQ];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + tr * 4]);
      ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
      ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][k][q * kQStride + tc * 4]);
        rb[4 * q] = b.x; rb[4 * q + 1] = b.y; rb[4 * q + 2] = b.z; rb[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kQ; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (more) {
      // the other stage was last read before the previous step's barrier
      store_a(cur ^ 1);
      store_b(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  // rows (i / 4) * 64 + tr * 4 + i % 4, columns q * kQStride + tc * 4 + j % 4
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i >> 2) * 64 + tr * 4 + (i & 3);
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int gn = n0 + q * kQStride + tc * 4;
      float* c = C + (size_t)gm * N + gn;
      if (kVecB && gn < N) {   // N % 4 == 0 and C aligned: the quad is whole
        *reinterpret_cast<float4*>(c) = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                    acc[i][4 * q + 2], acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) c[e] = acc[i][4 * q + e];
      }
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

// ------------------------------- bfloat16 on wgmma, fed by TMA (route 2)

constexpr int kWM = 128, kWN = 256, kWK = 64, kStages = 4;
constexpr int kWThreads = 384;                 // warpgroup 0 producer, 1-2 consumers
constexpr int kABytes = kWM * kWK * 2;         // 16 KB: [128 m][64 k], 128-byte rows
constexpr int kBBoxBytes = kWK * 64 * 2;       // 8 KB: [64 k][64 n], 128-byte rows
constexpr int kStageBytes = kABytes + kWN / 64 * kBBoxBytes;   // 48 KB
constexpr int kWSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kEncodeFailed = 10000;          // beside the cudaError codes
constexpr int kGroupM = 16;                    // m tiles per raster group

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed; a ring that never
// fills traps (the launch then fails) after about ten seconds instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// one box of a 2-D tensor map into shared memory; x is the contiguous coordinate
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence_operands(float d[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] (K-major) . B[16 x 256] (MN-major: transpose flag 1)
__device__ __forceinline__ void wgmma_m64n256k16(float d[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kWThreads, 1)
hgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmB, __nv_bfloat16* __restrict__ C,
                   int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  // grouped raster order: the blocks in flight at once cover about 16 m
  // tiles by 8 n tiles, so their A and B panels are read from memory about
  // once and then from L2, instead of all of B once per row of tiles
  const int tiles_m = (M + kWM - 1) / kWM, tiles_n = (N + kWN - 1) / kWN;
  const int group = blockIdx.x / (kGroupM * tiles_n);
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % (kGroupM * tiles_n);
  const int m0 = (first_m + in_group % group_m) * kWM;
  const int n0 = (in_group / group_m) * kWN;
  const int k_tiles = (K + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], 2 * 128);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages, phase = (kt / kStages) & 1;
        mbar_wait(&empty[s], phase ^ 1);        // round 0 passes at once
        unsigned char* st = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);  // out-of-range boxes count in full
        tma_load_2d(st, &tmA, &full[s], kt * kWK, m0);
#pragma unroll
        for (int c = 0; c < kWN / 64; ++c)
          tma_load_2d(st + kABytes + c * kBBoxBytes, &tmB, &full[s], n0 + 64 * c, kt * kWK);
      }
    }
  } else {
    // consumers: warpgroup 1 rows [0, 64) of the tile, warpgroup 2 rows [64, 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages, phase = (kt / kStages) & 1;
      mbar_wait(&full[s], phase);
      const unsigned char* st = ring + s * kStageBytes;
      fence_operands(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
        // step is 32 bytes into the swizzle atom. B: MN-major, 64-column
        // boxes 8 KB apart (leading offset), 8-row groups of k 1024 bytes
        // apart (stride offset); a k16 step is 16 rows, 2048 bytes.
        const uint64_t da = sw128_desc(st + cw * (kABytes / 2) + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(st + kABytes + kk * 2048, kBBoxBytes, 1024);
        wgmma_m64n256k16(d, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(d);
      mbar_arrive(&empty[s]);                   // this stage may be refilled
    }
    // accumulator layout: warp w of the warpgroup holds rows 16w + g and
    // 16w + g + 8; d[4i .. 4i+3] are columns 8i + 2t, 8i + 2t + 1 of both
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = m0 + cw * 64 + w * 16 + (lane >> 2);
    const int cbase = n0 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = cbase + 8 * i;            // N % 8 == 0: col + 1 < N too
      if (col >= N) continue;
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r0 * N + col) =
            __floats2bfloat162_rn(d[4 * i], d[4 * i + 1]);
      if (r0 + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(r0 + 8) * N + col) =
            __floats2bfloat162_rn(d[4 * i + 2], d[4 * i + 3]);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (null if
// the driver has none)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64 columns],
// 128-byte swizzle, zeros outside
int encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                 strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                 cudaStream_t s) {
  CUtensorMap ta, tb;
  int res = encode(&ta, a, M, K, kWM);
  if (res == 0) res = encode(&tb, b, K, N, kWK);
  if (res != 0) return kEncodeFailed;
  cudaError_t err = cudaFuncSetAttribute(
      hgemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + kWM - 1) / kWM) * ((N + kWN - 1) / kWN);
  hgemm_wgmma_kernel<<<tiles, kWThreads, kWSmem, s>>>(ta, tb, static_cast<__nv_bfloat16*>(c),
                                                      M, N, K);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// A [M, K], B [K, N], C [M, N], row-major. dtype: 0 float32, 1 bfloat16.
// route: 0 fma (float32), 1 mma (bfloat16), 2 wgmma (bfloat16, a and b
// 16-byte aligned, K % 8 == 0, N % 8 == 0); a route whose preconditions fail
// returns cudaErrorInvalidValue, a failed tensor-map encode kEncodeFailed.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M, int N, int K,
                             int dtype, int route, void* stream) {
  const bool fits = (route == 0 && dtype == 0) || (route == 1 && dtype == 1) ||
                    (route == 2 && dtype == 1 && aligned16(a) && aligned16(b) &&
                     K % 8 == 0 && N % 8 == 0);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    float* C = static_cast<float*>(c);
    const bool va = K % 4 == 0 && aligned16(a);
    const bool vb = N % 4 == 0 && aligned16(b) && aligned16(c);
    if (va && vb) sgemm_kernel<true, true><<<grid, kFThreads, kFSmem, s>>>(A, B, C, M, N, K);
    else if (va) sgemm_kernel<true, false><<<grid, kFThreads, kFSmem, s>>>(A, B, C, M, N, K);
    else if (vb) sgemm_kernel<false, true><<<grid, kFThreads, kFSmem, s>>>(A, B, C, M, N, K);
    else sgemm_kernel<false, false><<<grid, kFThreads, kFSmem, s>>>(A, B, C, M, N, K);
  } else if (route == 1) {
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
    return launch_wgmma(a, b, c, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
