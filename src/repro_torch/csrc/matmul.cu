// Tiled matrix product for Hopper (sm_90a) on the tensor cores: mma.sync
// fed by a cp.async ring in shared memory, fp32 accumulation.
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
// case (8192^3) it does 1.1 TFLOP against 0.8 GB (fp32) of inputs and
// output.  On the CUDA cores (fp32 FMA, 67 TFLOP/s) that is 16.4 ms, and
// even a perfect kernel there only ties cuBLAS's fp32 product; the way
// past it is the tensor cores, 495 TFLOP/s in TF32 and 989 in bf16.
//
// What this design does about it:
//   * bf16 inputs: mma.sync.m16n8k16 bf16 products, exact in fp32;
//   * fp32 inputs: 3xTF32.  TF32 keeps 10 mantissa bits, so one TF32
//     product errs by ~sqrt(k) 2^-11 (4e-2 at k = 8192), far outside the
//     reference's 5e-5 sqrt(k).  Each element x is split once, after its
//     fragment is read, into x_hi = tf32(x) (cvt.rna) and x_lo = x - x_hi,
//     and a_lo b_hi, a_hi b_lo, a_hi b_hi are summed in that order
//     (m16n8k8): ~21 bits, at a ceiling of 495 / 3 = 165 TFLOP/s;
//   * the tensor cores' fp32 accumulation truncates instead of rounding,
//     so its bias grows with the number of mma's into one accumulator:
//     summed over all of K = 8192 it lands several times outside the
//     4.5e-3 the reference allows.  So for fp32 each 64-deep slice is summed on
//     the tensor cores into a fresh partial, which is then added to the
//     running sum with fp32 adds that round to nearest;
//   * a block owns a BM x BN output tile (128 x 128 with 8 warps of 64 x 32,
//     or 64 x 64 with 4 warps of 32 x 32) and walks K in BK = 64 slices
//     through a 3-stage ring of shared memory filled by 16-byte cp.async
//     copies, so two slices are in flight while one is multiplied (one
//     __syncthreads a slice).  Rows are padded (A by 16 bytes, B by 32
//     bytes fp32 / 16 bytes bf16) so the fragment reads hit no bank twice.
//     Where a row of A or B is not a whole number of 16-byte chunks (K or
//     N not a multiple of 4 fp32 / 8 bf16, e.g. K = 257), the same kernel
//     stages that operand with element loads; entries past an edge are
//     written as zeros either way;
//   * bf16 fits in 128 registers, so two 128 x 128 blocks (16 warps) share
//     an SM; fp32, with its two accumulators, runs one;
//   * blocks are ordered in groups of 8 row tiles so that the B slices a
//     wave of blocks reads are shared in L2.
//
// Exactness across tiles: every output element starts from 0 and takes the
// same sequence of mma instructions and adds, whatever the tile: K is
// walked in the same BK = 64 slices, the same k-steps (8 for TF32, 16 for
// bf16) in increasing k, for fp32 the same three products in the same
// order and the same add of each slice's partial; an mma computes each
// output element from that element's own row of A and column of B only,
// and the zero padding past K sits at the same k in every tile.  Every
// tile therefore gives the same bits, which is stronger than the
// reference's block-invariance test.
//
// Left for later: wgmma fed by TMA (the way to the full tensor-core rate)
// and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                 // K slice per stage, for every tile
constexpr int STAGES = 3;              // shared-memory ring
constexpr int GROUP_M = 8;             // row tiles per L2 group

template <typename T> struct Layout;
template <> struct Layout<float> {     // 4 elements a 16-byte chunk
  static constexpr int CHUNK = 4, PAD_A = 4, PAD_B = 8;
  static constexpr int MIN_BLOCKS = 1; // 2 accumulators of 64 floats a thread
};
template <> struct Layout<bf16> {      // 8 elements a 16-byte chunk
  static constexpr int CHUNK = 8, PAD_A = 8, PAD_B = 8;
  static constexpr int MIN_BLOCKS = 2; // <= 128 registers: 16 warps an SM
};

template <int BM, int BN, typename T>
constexpr int smem_bytes() {
  return STAGES *
         (BM * (BK + Layout<T>::PAD_A) + BK * (BN + Layout<T>::PAD_B)) *
         static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `valid` false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A 16-byte shared-memory read that the compiler makes where it stands
// (volatile): the fp32 loop reads B again for each row tile rather than
// keeping it live in registers.
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo: hi is x rounded to TF32 (cvt.rna), lo = x - hi exactly in
// fp32; the tensor core reads lo's top 19 bits (its low 13 are ignored), so
// lo enters the product truncated to TF32, within 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);          // round to nearest even, as .to() does
}

// Four neighbouring outputs in one store (16 bytes fp32, 8 bytes bf16).
__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(bf16* p, float x, float y, float z,
                                       float w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(z, w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// (rows, cols) matrix into shared rows of LD elements; outside is 0.
template <int ROWS, int COLS, int LD, int THREADS, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int c0,
                                      int rows, int cols, bool vec, int tid) {
  constexpr int CHUNK = Layout<T>::CHUNK;
  if (vec) {  // cols % CHUNK == 0: a chunk is all in or all out
    constexpr int CPR = COLS / CHUNK;
#pragma unroll
    for (int i = tid; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR;
      const int c = (i - r * CPR) * CHUNK;
      const bool in = r0 + r < rows && c0 + c < cols;
      const T* g = in ? src + static_cast<size_t>(r0 + r) * cols + c0 + c
                      : src;
      cp_async16(dst + r * LD + c, g, in);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS;
      const int c = i - r * COLS;
      const bool in = r0 + r < rows && c0 + c < cols;
      dst[r * LD + c] =
          in ? src[static_cast<size_t>(r0 + r) * cols + c0 + c] : zero<T>();
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, typename TIn,
          typename TOut>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32,
                                  Layout<TIn>::MIN_BLOCKS)
matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              TOut* __restrict__ c, int m, int n, int k, int vec_a,
              int vec_b) {
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int LDA = BK + Layout<TIn>::PAD_A;
  constexpr int LDB = BN + Layout<TIn>::PAD_B;
  constexpr int A_STAGE = BM * LDA;
  constexpr int B_STAGE = BK * LDB;
  constexpr int WM = BM / WARPS_M;     // warp tile
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;          // 16-row mma tiles a warp
  constexpr int NT = WN / 8;           // 8-column mma tiles a warp
  static_assert(NT == 4, "fp32 B reads and stores are 4 columns wide");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* sa = reinterpret_cast<TIn*>(smem_raw);
  TIn* sb = sa + STAGES * A_STAGE;

  // Grouped raster: GROUP_M row tiles share each column tile's B slices.
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (pid / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int tile_m = first_m + (pid % per_group) % group_m;
  const int tile_n = (pid % per_group) / group_m;
  const int row0 = tile_m * BM;
  const int col0 = tile_n * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;

  // fp32: the sum over K, in fp32 adds that round to nearest; each slice's
  // products are summed on the tensor cores in `part` and added here, since
  // the tensor cores' own accumulation truncates, and over all of K that
  // bias grows with k.  bf16: the tensor cores' sum itself.
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int slices = (k + BK - 1) / BK;
  auto load = [&](int slice, int st) {
    stage<BM, BK, LDA, THREADS>(sa + st * A_STAGE, a, row0, slice * BK, m, k,
                                vec_a, tid);
    stage<BK, BN, LDB, THREADS>(sb + st * B_STAGE, b, slice * BK, col0, k, n,
                                vec_b, tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < slices) load(st, st);
    cp_async_commit();                 // empty groups keep the count uniform
  }

  for (int slice = 0; slice < slices; ++slice) {
    cp_async_wait<STAGES - 2>();       // this slice's copies have landed
    __syncthreads();  // for every thread; and the oldest stage is free
    const int next = slice + STAGES - 1;
    if (next < slices) load(next, next % STAGES);
    cp_async_commit();

    const TIn* as = sa + (slice % STAGES) * A_STAGE;
    const TIn* bs = sb + (slice % STAGES) * B_STAGE;
    if constexpr (F32) {
      // One 16-row tile of the warp at a time through the whole slice, so
      // only its partial sums (16 floats) live beside `acc`.
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float part[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
          uint32_t a_hi[4], a_lo[4], b_hi[NT][2], b_lo[NT][2];
          uint32_t r[4];               // rows g, g + 8 at k t; then k t + 4
          ldmatrix_x4(r, as + (wm0 + 16 * i + (lane & 7) +
                               (((lane >> 3) & 1) << 3)) * LDA +
                             kk + ((lane >> 4) << 2));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(r[e]), a_hi[e], a_lo[e]);
          // Column n of tile j is the warp's column NT n + j, so a thread's
          // columns for all NT tiles are neighbours: one 16-byte read a k.
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // k t, then k t + 4
            const float4 v = lds128(bs + (kk + t + 4 * h) * LDB + wn0 + NT * g);
            split_tf32(v.x, b_hi[0][h], b_lo[0][h]);
            split_tf32(v.y, b_hi[1][h], b_lo[1][h]);
            split_tf32(v.z, b_hi[2][h], b_lo[2][h]);
            split_tf32(v.w, b_hi[3][h], b_lo[3][h]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[j], a_lo, b_hi[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[j], a_hi, b_lo[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[j], a_hi, b_hi[j]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldmatrix_x4(af[i], as + (wm0 + 16 * i + (lane & 7) +
                                   (((lane >> 3) & 1) << 3)) * LDA +
                                 kk + ((lane >> 4) << 3));
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + (kk + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * LDB +
                                 wn0 + 8 * j + ((lane >> 4) << 3));
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
      }
    }
  }
  cp_async_wait<0>();                  // nothing left in flight at exit

  // Element e of tile (i, j) is row g (+ 8 for e >= 2) and fragment column
  // 2 t + (e & 1): the warp's column NT (2 t + (e & 1)) + j for fp32 inputs
  // (NT neighbours, stored together), 8 j + 2 t + (e & 1) for bf16.
  const bool vec_c = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wm0 + 16 * i + g + ((e >> 1) << 3);
      if (r >= m) continue;
      TOut* cr = c + static_cast<size_t>(r) * n;
      if constexpr (F32) {
        const int c0 = col0 + wn0 + NT * (2 * t + (e & 1));
        if (vec_c && c0 + NT <= n) {
          store4(cr + c0, acc[i][0][e], acc[i][1][e], acc[i][2][e],
                 acc[i][3][e]);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (c0 + j < n) cr[c0 + j] = from_float<TOut>(acc[i][j][e]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cc = col0 + wn0 + 8 * j + 2 * t + (e & 1);
          if (cc < n) cr[cc] = from_float<TOut>(acc[i][j][e]);
        }
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, typename TIn,
          typename TOut>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, BN, TIn>();
  auto* kernel = matmul_kernel<BM, BN, WARPS_M, WARPS_N, TIn, TOut>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need 16-byte aligned rows: the base and the row length.
  constexpr int chunk = Layout<TIn>::CHUNK;
  const int vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && k % chunk == 0;
  const int vec_b = reinterpret_cast<uintptr_t>(b) % 16 == 0 && n % chunk == 0;
  const long long blocks =
      static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return -3;
  kernel<<<static_cast<unsigned>(blocks), WARPS_M * WARPS_N * 32, smem,
           stream>>>(static_cast<const TIn*>(a), static_cast<const TIn*>(b),
                     static_cast<TOut*>(c), m, n, k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// BM x BN output tile with WARPS_M x WARPS_N warps, for each dtype pair.
template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch_types(const void* a, const void* b, void* c, int m, int n, int k,
                 int in_dtype, int out_dtype, cudaStream_t stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<BM, BN, WARPS_M, WARPS_N, float, float>(a, b, c, m, n, k,
                                                          stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<BM, BN, WARPS_M, WARPS_N, float, bf16>(a, b, c, m, n, k,
                                                         stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<BM, BN, WARPS_M, WARPS_N, bf16, float>(a, b, c, m, n, k,
                                                         stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<BM, BN, WARPS_M, WARPS_N, bf16, bf16>(a, b, c, m, n, k,
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
    return launch_types<64, 64, 2, 2>(a, b, c, m, n, k, in_dtype, out_dtype,
                                      st);
  if (tile == 128)
    return launch_types<128, 128, 2, 4>(a, b, c, m, n, k, in_dtype,
                                        out_dtype, st);
  return -1;
}
