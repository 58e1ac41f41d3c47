// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a), fp32.
//
// Replaces: src/repro/kernels/ssd/kernel.py, `ssd` (line 78; the
// pl.pallas_call at line 91) with its body `_ssd_kernel` (line 36).
//
// What it computes, as the TPU kernel does, per (batch, head):
//   x (B, S, H, P), dt (B, S, H) > 0, a_log (H,), b and c (B, S, N), all
//   fp32 and contiguous; B and C are shared by all heads (ngroups 1).  With
//   A = -exp(a_log[h]) and, inside each chunk of L rows, g = cumsum(dt * A):
//     y_i = exp(g_i) * (C_i @ h_in)
//           + sum_{j <= i} (C_i . B_j) * exp(g_i - g_j) * dt_j * x_j
//     h_out = exp(g_L) * h_in + sum_j B_j^T exp(g_L - g_j) dt_j x_j
//   with an (N, P) fp32 state h carried from chunk to chunk, h_in = 0 for
//   the first.  y (B, S, H, P) is fp32.
//
// What bounds it on an H100: operations.  At mamba2-1.3b's prefill shape
// (B = 1, S = 8192, H = 64, P = 64, N = 128, L = 256) the live (j <= i)
// products are ~21 MFLOP per (head, chunk), ~43 GFLOP a call, against
// ~0.28 GB of inputs and output: far right of the fp32 ridge point.
//
// What this design does about it: all arithmetic is fp32 FMA on the CUDA
// cores (67 TFLOP/s peak), fed from shared memory, and the work is cut so
// that it fills the card.  The TPU kernel walks the chunks of one (b, h) in
// order with the state in VMEM; blocks on Hopper run in no order, and one
// block per (b, h) would fill 64 of 132 SMs.  So the sequential axis becomes
// a short second pass and the chunks run in parallel:
//   1. chunk_state   (b, h, chunk) blocks: g = cumsum(dt * A) by a warp scan
//                    (kept in a scratch for pass 3), and the chunk's own
//                    state contribution sum_j B_j^T exp(g_L - g_j) dt_j x_j.
//   2. state_passing (b, h, N*P / 256) blocks: one thread per state element
//                    walks the chunks in order and turns each contribution
//                    into the state entering that chunk, in place.
//   3. chunk_scan    (b, h, chunk, 64-row tile) blocks: the inter-chunk term
//                    from the state entering the chunk, then 64-key tiles of
//                    the intra-chunk term: scores C B^T on the CUDA cores,
//                    masked BEFORE the exp (keys after the row take
//                    exp(-1e30) = 0, so no inf ever reaches a product), then
//                    times dt * x.  A chunk of 256 never sits whole in shared
//                    memory (its (L, L) tile alone would be 256 KB); a block
//                    holds 64 rows of C, one 64-key tile of B, of x and of
//                    the scores, and g for the whole chunk: 103 KB, two
//                    blocks per SM.
// It does not use the tensor cores, and every head recomputes C B^T, which
// does not depend on the head: both are later work (ROADMAP.md).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHUNK = 256;
constexpr int THREADS = 256;           // a 16 x 16 grid of threads
constexpr int ROWS = 64;               // chunk rows per chunk_scan block
constexpr int KEYS = 64;               // keys per shared-memory tile
constexpr int STATE_ROWS = 32;         // rows per tile in chunk_state
constexpr int PAD = 4;                 // keeps float4 alignment, spreads banks
constexpr int RS = ROWS + PAD;         // row stride of the transposed tiles
constexpr int KS = KEYS + PAD;
constexpr float NEG_BIG = -1e30f;      // the reference's mask value

struct Dims {
  int batch, seq, heads, chunk, n_chunks;
};

// `count` consecutive floats from shared memory, as float4 where they allow.
template <int COUNT>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[COUNT]) {
  if constexpr (COUNT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < COUNT; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      dst[k] = v.x;
      dst[k + 1] = v.y;
      dst[k + 2] = v.z;
      dst[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < COUNT; ++k) dst[k] = src[k];
  }
}

// Inclusive prefix sum of v[0, len) in place, by the 32 lanes of one warp:
// each lane sums a run of consecutive entries, then the runs' totals are
// scanned across lanes.  len <= MAX_CHUNK.
__device__ void warp_inclusive_scan(float* v, int len, int lane) {
  const int per = (len + 31) / 32;
  const int lo = min(lane * per, len);
  const int hi = min(lo + per, len);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  float total = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, total, off);
    if (lane >= off) total += up;
  }
  float before = __shfl_up_sync(0xffffffffu, total, 1);
  if (lane == 0) before = 0.f;
  for (int i = lo; i < hi; ++i) v[i] += before;
}

// Pass 1.  grid (n_chunks, H, B).  Writes g (B, H, S) and each chunk's own
// state contribution to states (B, H, n_chunks, N, P).
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const float* __restrict__ bm,
            float* __restrict__ g, float* __restrict__ states, Dims d) {
  constexpr int NT = N / 16;           // state rows per thread
  constexpr int PT = P / 16;           // state columns per thread
  __shared__ float g_s[MAX_CHUNK];
  __shared__ float w_s[MAX_CHUNK];
  __shared__ __align__(16) float b_s[STATE_ROWS * N];
  __shared__ __align__(16) float x_s[STATE_ROWS * P];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int L = d.chunk;
  const long long row0 = static_cast<long long>(bi) * d.seq +
                         static_cast<long long>(c) * L;   // (b, s) row of the chunk's start
  const float a = -expf(a_log[h]);

  for (int j = tid; j < L; j += THREADS) {
    const float dtj = dt[(row0 + j) * d.heads + h];
    w_s[j] = dtj;
    g_s[j] = dtj * a;
  }
  __syncthreads();
  if (tid < 32) warp_inclusive_scan(g_s, L, tid);
  __syncthreads();
  float* g_row = g + (static_cast<long long>(bi) * d.heads + h) * d.seq +
                 static_cast<long long>(c) * L;
  const float g_last = g_s[L - 1];
  for (int j = tid; j < L; j += THREADS) {
    g_row[j] = g_s[j];
    w_s[j] = expf(g_last - g_s[j]) * w_s[j];     // exp(g_L - g_j) * dt_j
  }

  float acc[NT][PT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) acc[i][q] = 0.f;

  for (int j0 = 0; j0 < L; j0 += STATE_ROWS) {
    __syncthreads();                   // w_s is written; the last tile is used
    for (int idx = tid; idx < STATE_ROWS * N; idx += THREADS) {
      const int j = idx / N;
      const int n = idx - j * N;
      b_s[idx] = j0 + j < L ? bm[(row0 + j0 + j) * N + n] * w_s[j0 + j] : 0.f;
    }
    for (int idx = tid; idx < STATE_ROWS * P; idx += THREADS) {
      const int j = idx / P;
      const int p = idx - j * P;
      x_s[idx] = j0 + j < L ? x[((row0 + j0 + j) * d.heads + h) * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < STATE_ROWS; ++j) {
      float bv[NT];
      float xv[PT];
      load_row<NT>(b_s + j * N + ty * NT, bv);
      load_row<PT>(x_s + j * P + tx * PT, xv);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int q = 0; q < PT; ++q) acc[i][q] = fmaf(bv[i], xv[q], acc[i][q]);
    }
  }

  float* st = states + ((static_cast<long long>(bi) * d.heads + h) * d.n_chunks + c) * (N * P);
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) st[(ty * NT + i) * P + tx * PT + q] = acc[i][q];
}

// Pass 2.  grid (ceil(N*P / THREADS), H, B).  In place: the contribution of
// chunk c becomes the state entering chunk c.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
state_passing(float* __restrict__ states, const float* __restrict__ g, Dims d) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= N * P) return;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float* g_row = g + (static_cast<long long>(bi) * d.heads + h) * d.seq;
  float* st = states + (static_cast<long long>(bi) * d.heads + h) * d.n_chunks * (N * P) + e;
  float carry = 0.f;
  for (int c = 0; c < d.n_chunks; ++c) {
    const long long at = static_cast<long long>(c) * (N * P);
    const float inc = st[at];
    st[at] = carry;
    carry = expf(g_row[static_cast<long long>(c) * d.chunk + d.chunk - 1]) * carry + inc;
  }
}

template <int N, int P>
constexpr int chunk_scan_smem_floats() {
  return N * RS + N * KS + KEYS * RS + KEYS * P + 2 * MAX_CHUNK;
}

// Pass 3.  grid (n_chunks * ceil(L / ROWS), H, B); dynamic shared memory of
// chunk_scan_smem_floats<N, P>() floats.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 2)
chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ bm, const float* __restrict__ cm,
           const float* __restrict__ g, const float* __restrict__ states,
           float* __restrict__ y, Dims d) {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P must be multiples of 16");
  static_assert(P <= KEYS, "h_in shares the key tile's buffer");
  constexpr int PT = P / 16;           // output columns per thread
  extern __shared__ float4 smem4[];
  float* c_s = reinterpret_cast<float*>(smem4);   // [N][RS]    C of the rows, transposed
  float* w_s = c_s + N * RS;           // [N][P] h_in, then [N][KS] B of a key tile, transposed
  float* s_s = w_s + N * KS;           // [KEYS][RS] decayed scores, transposed
  float* x_s = s_s + KEYS * RS;        // [KEYS][P]  dt_j * x_j
  float* g_s = x_s + KEYS * P;         // [MAX_CHUNK]
  float* dt_s = g_s + MAX_CHUNK;       // [MAX_CHUNK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int L = d.chunk;
  const int tiles = (L + ROWS - 1) / ROWS;
  const int c = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - c * tiles) * ROWS;   // the block's first row in the chunk
  const int r_end = min(r0 + ROWS, L);               // rows [r0, r_end); keys [0, r_end)
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const long long row0 = static_cast<long long>(bi) * d.seq +
                         static_cast<long long>(c) * L;

  const float* g_row = g + (static_cast<long long>(bi) * d.heads + h) * d.seq +
                       static_cast<long long>(c) * L;
  for (int j = tid; j < r_end; j += THREADS) {
    g_s[j] = g_row[j];
    dt_s[j] = dt[(row0 + j) * d.heads + h];
  }
  for (int idx = tid; idx < ROWS * N; idx += THREADS) {
    const int i = idx / N;
    const int n = idx - i * N;
    c_s[n * RS + i] = r0 + i < r_end ? cm[(row0 + r0 + i) * N + n] : 0.f;
  }
  const float* st = states + ((static_cast<long long>(bi) * d.heads + h) * d.n_chunks + c) * (N * P);
  for (int idx = tid; idx < N * P; idx += THREADS) w_s[idx] = st[idx];
  __syncthreads();

  // inter-chunk term: exp(g_i) * (C_i @ h_in)
  float inter[4][PT];
  float intra[4][PT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      inter[r][q] = 0.f;
      intra[r][q] = 0.f;
    }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(c_s + n * RS + 4 * ty);
    float hv[PT];
    load_row<PT>(w_s + n * P + tx * PT, hv);
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      inter[0][q] = fmaf(cv.x, hv[q], inter[0][q]);
      inter[1][q] = fmaf(cv.y, hv[q], inter[1][q]);
      inter[2][q] = fmaf(cv.z, hv[q], inter[2][q]);
      inter[3][q] = fmaf(cv.w, hv[q], inter[3][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + 4 * ty + r;
    const float decay = i < r_end ? expf(g_s[i]) : 0.f;
#pragma unroll
    for (int q = 0; q < PT; ++q) inter[r][q] *= decay;
  }

  // intra-chunk term over the key tiles some row of the block can see
  for (int k0 = 0; k0 < r_end; k0 += KEYS) {
    __syncthreads();                   // done with w_s, s_s and x_s
    for (int idx = tid; idx < KEYS * N; idx += THREADS) {
      const int j = idx / N;
      const int n = idx - j * N;
      w_s[n * KS + j] = k0 + j < r_end ? bm[(row0 + k0 + j) * N + n] : 0.f;
    }
    for (int idx = tid; idx < KEYS * P; idx += THREADS) {
      const int j = idx / P;
      const int p = idx - j * P;
      x_s[idx] = k0 + j < r_end
                     ? dt_s[k0 + j] * x[((row0 + k0 + j) * d.heads + h) * P + p]
                     : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(c_s + n * RS + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(w_s + n * KS + 4 * tx);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(cr[r], bq[q], sc[r][q]);
    }
    // Decay and causal mask, the mask applied BEFORE the exp.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = k0 + 4 * tx + q;
      float out[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 4 * ty + r;
        const float arg = (j <= i && i < r_end) ? g_s[i] - g_s[j] : NEG_BIG;
        out[r] = sc[r][q] * expf(arg);
      }
      *reinterpret_cast<float4*>(s_s + (4 * tx + q) * RS + 4 * ty) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KEYS; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(s_s + j * RS + 4 * ty);
      float xv[PT];
      load_row<PT>(x_s + j * P + tx * PT, xv);
#pragma unroll
      for (int q = 0; q < PT; ++q) {
        intra[0][q] = fmaf(sv.x, xv[q], intra[0][q]);
        intra[1][q] = fmaf(sv.y, xv[q], intra[1][q]);
        intra[2][q] = fmaf(sv.z, xv[q], intra[2][q]);
        intra[3][q] = fmaf(sv.w, xv[q], intra[3][q]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + 4 * ty + r;
    if (i < r_end) {
      float* yp = y + ((row0 + i) * d.heads + h) * P + tx * PT;
#pragma unroll
      for (int q = 0; q < PT; ++q) yp[q] = inter[r][q] + intra[r][q];
    }
  }
}

template <int N, int P>
int launch(const float* x, const float* dt, const float* a_log,
           const float* bm, const float* cm, float* y, float* g,
           float* states, Dims d, cudaStream_t stream) {
  chunk_state<N, P><<<dim3(d.n_chunks, d.heads, d.batch), THREADS, 0, stream>>>(
      x, dt, a_log, bm, g, states, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  state_passing<N, P><<<dim3((N * P + THREADS - 1) / THREADS, d.heads, d.batch),
                        THREADS, 0, stream>>>(states, g, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = chunk_scan_smem_floats<N, P>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(chunk_scan<N, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.chunk + ROWS - 1) / ROWS;
  chunk_scan<N, P><<<dim3(d.n_chunks * tiles, d.heads, d.batch), THREADS, smem,
                     stream>>>(x, dt, bm, cm, g, states, y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  All tensors fp32 and contiguous:
// x, y (B, S, H, P); dt (B, S, H); a_log (H,); b, c (B, S, N); scratch g
// (B, H, S) and states (B, H, S / chunk, N, P), allocated by the caller.
// Returns the cudaError_t of the launches (0 = success), -1 for an (N, P)
// that was not instantiated, -3 for a chunk outside [1, 256] or one that
// does not divide S.  Launches on `stream` and does not synchronise.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, void* y, void* g,
                            void* states, int batch, int seq, int heads,
                            int head_dim, int state_dim, int chunk,
                            void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || seq % chunk != 0) return -3;
  const Dims d{batch, seq, heads, chunk, seq / chunk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(a_log);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  auto* yf = static_cast<float*>(y);
  auto* gf = static_cast<float*>(g);
  auto* sf = static_cast<float*>(states);
  if (state_dim == 128 && head_dim == 64) {
    return launch<128, 64>(xf, dtf, af, bf, cf, yf, gf, sf, d, st);
  }
  if (state_dim == 16 && head_dim == 16) {
    return launch<16, 16>(xf, dtf, af, bf, cf, yf, gf, sf, d, st);
  }
  return -1;
}
