// Fused RMSNorm * weight for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, `rmsnorm_2d` (line 31; the
// pl.pallas_call at line 38) with its body `_rmsnorm_kernel` (line 22).
//
// What it computes, as the TPU kernel does, for each row of x (R, D):
//   y = x * rsqrt(mean(x^2) + eps) * w
// in fp32, with x fp32 or bf16, w (D,) fp32 or bf16, and y in x's type
// (bf16 rounded to nearest even).  D % 8 == 0 (the op's dispatch sends
// anything else to the plain version), any R, eps at run time.
//
// What bounds it on an H100: bytes.  It does ~4 flop an element against 8
// bytes (fp32) moved, far left of the ridge point; at the validation
// suite's case (65536 x 2560 fp32) the 1.34 GB of x and y take 0.40 ms at
// 3.35 TB/s.
//
// What this design does about it: x is read from device memory once and y
// written once; the normalised intermediate never exists, which is the
// fusion the TPU kernel is for.  Loads and stores are 16-byte vectors (4
// fp32 or 8 bf16 values; neighbouring threads on neighbouring vectors).
// Two shapes of work:
//   * rows of 33 to 8 x 256 vectors (D from 136 to 8192 fp32, to 16384
//     bf16): one block of 256 threads a row, the row held in registers (up
//     to 8 vectors a thread) between the sum of squares and the scaling,
//     the sum reduced by warp shuffles and then across the 8 warps through
//     shared memory.  Giving such a row one warp and reading it twice
//     instead counts on L1/L2 for the second read; at 65536 x 2560 fp32
//     that ran at 1.96 TB/s on an H100, likely because the rows in flight
//     outgrow the 50 MB L2.
//   * narrow rows (at most 32 vectors, D <= 128 fp32, 256 bf16) and rows
//     wider than the register path: one warp a row, eight rows a block,
//     the row read twice.  A narrow row (<= 512 bytes) is still in L1 for
//     the second read; a row wider than 8192 fp32 values may come from
//     L2 or device memory again.
// Sums are fp32, then rsqrtf(var + eps), then (x * r) * w in the
// reference's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WARP = 32;
constexpr int ROWS_PER_BLOCK = 8;        // rows of the one-warp-a-row path
constexpr int THREADS = WARP * ROWS_PER_BLOCK;

// 16 bytes of x or y as fp32 values.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&f)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&f)[N]) {
    uint4 v;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One block of THREADS a row; thread t holds the row's vectors t + THREADS*i,
// i < VPT, in registers.
template <typename TX, typename TW, int VPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_in_registers(const TX* __restrict__ x, const TW* __restrict__ w,
                         TX* __restrict__ y, int d, float eps) {
  using V = Vec16<TX>;
  constexpr int N = V::N;
  __shared__ float partial[THREADS / WARP];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  const int nvec = d / N;

  float f[VPT][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + THREADS * i;
    if (v < nvec) {
      V::load(xr + v * N, f[i]);
#pragma unroll
      for (int e = 0; e < N; ++e) ss = fmaf(f[i][e], f[i][e], ss);
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % WARP == 0) partial[threadIdx.x / WARP] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < THREADS / WARP; ++k) total += partial[k];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + THREADS * i;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        f[i][e] = f[i][e] * r * to_float(w[v * N + e]);
      }
      V::store(yr + v * N, f[i]);
    }
  }
}

// One warp a row, ROWS_PER_BLOCK rows a block, the row read twice.
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_per_warp(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ y, long long rows, int d, float eps) {
  using V = Vec16<TX>;
  constexpr int N = V::N;
  const int lane = threadIdx.x % WARP;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / WARP;
  if (row >= rows) return;                 // the whole warp leaves together
  const TX* xr = x + static_cast<size_t>(row) * d;
  TX* yr = y + static_cast<size_t>(row) * d;
  const int nvec = d / N;

  float ss = 0.f;
  for (int v = lane; v < nvec; v += WARP) {
    float f[N];
    V::load(xr + v * N, f);
#pragma unroll
    for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int v = lane; v < nvec; v += WARP) {
    float f[N];
    V::load(xr + v * N, f);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = f[e] * r * to_float(w[v * N + e]);
    V::store(yr + v * N, f);
  }
}

template <typename TX, typename TW, int VPT>
int launch_rows(const void* x, const void* w, void* y, long long rows, int d,
                float eps, cudaStream_t stream) {
  rmsnorm_row_in_registers<TX, TW, VPT>
      <<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<TX*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, cudaStream_t stream) {
  const int nvec = d / Vec16<TX>::N;
  if (nvec > WARP && rows <= 0x7fffffffLL) {     // rows ride grid.x
    if (nvec <= THREADS)
      return launch_rows<TX, TW, 1>(x, w, y, rows, d, eps, stream);
    if (nvec <= 2 * THREADS)
      return launch_rows<TX, TW, 2>(x, w, y, rows, d, eps, stream);
    if (nvec <= 4 * THREADS)
      return launch_rows<TX, TW, 4>(x, w, y, rows, d, eps, stream);
    if (nvec <= 8 * THREADS)
      return launch_rows<TX, TW, 8>(x, w, y, rows, d, eps, stream);
  }
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  rmsnorm_row_per_warp<TX, TW><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  dtypes: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t, or a negative code for arguments it
// does not take.  x, w and y must be 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0) return -3;
  if ((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 0x7fffffffLL) return -4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, rows, d, eps, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, st);
  return -2;
}
