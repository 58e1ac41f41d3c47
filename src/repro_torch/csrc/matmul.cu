// Tiled matrix product for Hopper (sm_90a), fp32 accumulation on the CUDA
// cores.
//
// Replaces: src/repro/kernels/matmul/kernel.py, `matmul_tiled` (line 46; the
// pl.pallas_call at line 57) with its body `_matmul_kernel` (line 28).
//
// What it computes, as the TPU kernel does: c = a @ b for a (M, K) and
// b (K, N), row-major and contiguous, fp32 or bf16 (both the same), with an
// fp32 accumulator and the result cast to the output type (fp32 or bf16,
// round to nearest even).  Any M, N, K >= 1: the ragged edges are masked.
//
// What bounds it on an H100: operations.  At the validation suite's largest
// case (8192^3, fp32) it does 1.1 TFLOP against 0.8 GB of inputs and output,
// far right of the fp32 ridge point (67 TFLOP/s over 3.35 TB/s, ~20 flop a
// byte).
//
// What this design does about it: the classic shared-memory SGEMM.  A block
// of 256 threads owns a BM x BN output tile and walks K in BK-deep slices:
// each slice of A (stored transposed) and of B is staged in shared memory,
// and every thread keeps a TM x TN micro-tile of the output in registers,
// fed by 16-byte shared-memory loads (thread (tx, ty) of the 16 x 16 grid
// owns rows ty*4 + 64q + {0..3} and columns tx*4 + 64q + {0..3}, so a
// quarter-warp reads 128 consecutive bytes and no bank is hit twice).  All
// arithmetic is fp32 FMA (67 TFLOP/s peak); bf16 inputs are widened when
// they are staged.  Two tiles are instantiated, 64 x 64 (BK 16, 4 x 4 a
// thread) and 128 x 128 (BK 8, 8 x 8 a thread); the wrapper maps the
// reference's bm/bn onto them.
//
// Exactness: each output element is summed by one thread, one fmaf per k,
// in increasing k, from 0 (the last slice runs only its live depth, so no
// padded zero is ever added).  Every tile therefore gives the same bits,
// which is stronger than the reference's block-invariance test.
//
// It does not use the tensor cores (TF32 or bf16 mma / wgmma), does not
// double-buffer its slices and does not use TMA: all later work
// (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;           // a 16 x 16 grid of threads
constexpr int GRID_T = 16;
constexpr int QUAD = 4;                // a thread's rows / columns come in 4s
constexpr int PAD = 4;                 // keeps 16-byte rows, spreads banks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);          // round to nearest even, as .to() does
}

template <int BM, int BN, int BK, typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              TOut* __restrict__ c, int m, int n, int k) {
  constexpr int TM = BM / GRID_T;
  constexpr int TN = BN / GRID_T;
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int B_LOADS = BK * BN / THREADS;
  static_assert(TM % QUAD == 0 && TN % QUAD == 0, "micro-tile in quads");
  static_assert(A_LOADS * THREADS == BM * BK, "A slice split evenly");
  static_assert(B_LOADS * THREADS == BK * BN, "B slice split evenly");

  __shared__ __align__(16) float as[BK][BM + PAD];   // as[kk][row]: A^T
  __shared__ __align__(16) float bs[BK][BN + PAD];   // bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % GRID_T;
  const int ty = tid / GRID_T;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // One k of the slice: 16-byte loads of the thread's rows of A^T and
  // columns of B, then TM x TN fmaf.
  auto step = [&](int kk) {
    float ar[TM], br[TN];
#pragma unroll
    for (int q = 0; q < TM / QUAD; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&as[kk][ty * QUAD + 64 * q]);
      ar[QUAD * q] = v.x; ar[QUAD * q + 1] = v.y;
      ar[QUAD * q + 2] = v.z; ar[QUAD * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < TN / QUAD; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&bs[kk][tx * QUAD + 64 * q]);
      br[QUAD * q] = v.x; br[QUAD * q + 1] = v.y;
      br[QUAD * q + 2] = v.z; br[QUAD * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  };

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage the (BM, BK) slice of A, transposed, and the (BK, BN) slice of
    // B; entries past an edge are 0 (never summed: see `depth`).
#pragma unroll
    for (int l = 0; l < A_LOADS; ++l) {
      const int e = tid + THREADS * l;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
                      ? to_float(a[static_cast<size_t>(gr) * k + gk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < B_LOADS; ++l) {
      const int e = tid + THREADS * l;
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? to_float(b[static_cast<size_t>(gk) * n + gc]) : 0.f;
    }
    __syncthreads();
    const int depth = min(BK, k - k0);
    if (depth == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < depth; ++kk) step(kk);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / QUAD) * 64 + ty * QUAD + i % QUAD;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + (j / QUAD) * 64 + tx * QUAD + j % QUAD;
      if (cc < n) {
        c[static_cast<size_t>(r) * n + cc] = from_float<TOut>(acc[i][j]);
      }
    }
  }
}

template <int BM, int BN, int BK, typename TIn, typename TOut>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<BM, BN, BK, TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_types(const void* a, const void* b, void* c, int m, int n, int k,
                 int in_dtype, int out_dtype, cudaStream_t stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<BM, BN, BK, float, float>(a, b, c, m, n, k, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<BM, BN, BK, float, __nv_bfloat16>(a, b, c, m, n, k, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<BM, BN, BK, __nv_bfloat16, float>(a, b, c, m, n, k, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<BM, BN, BK, __nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k,
                                                             stream);
  return -2;
}

}  // namespace

// Plain C entry point for ctypes.  dtypes: 0 = float32, 1 = bfloat16.
// tile: 64 (64 x 64 output tile) or 128 (128 x 128).  Returns the launch's
// cudaError_t, or a negative code for arguments it does not take.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int m, int n,
                          int k, int in_dtype, int out_dtype, int tile,
                          void* stream) {
  if (m < 1 || n < 1 || k < 1) return -3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    return launch_types<64, 64, 16>(a, b, c, m, n, k, in_dtype, out_dtype, st);
  if (tile == 128)
    return launch_types<128, 128, 8>(a, b, c, m, n, k, in_dtype, out_dtype,
                                     st);
  return -1;
}
