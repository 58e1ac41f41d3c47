// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a): fp32 in
// and out, its four products on the tensor cores in 3xTF32.
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
// (B = 1, S = 8192, H = 64, P = 64, N = 128, L = 256) the function needs
// 26.1 GFLOP on the live (j <= i) entries, with C B^T once per chunk, against
// ~0.28 GB of inputs and output: 0.39 ms on the CUDA cores (fp32 FMA, 67
// TFLOP/s), 0.16 ms as 3xTF32 on the tensor cores (495 / 3 TFLOP/s).
//
// What this design does about it:
//   * Every product runs on the tensor cores, mma.sync.m16n8k8 TF32, in
//     3xTF32: each fp32 operand is split once, after its fragment is read
//     from shared memory, into hi = tf32(x) (cvt.rna) and lo = x - hi, and
//     lo.hi, hi.lo, hi.hi are summed (~21 bits; TF32 alone keeps ~11 and
//     misses the 1e-4 gate against the plain chunked version at mamba2's
//     shape, scripts/ssd_variants.py).  The tensor cores' fp32 accumulation
//     truncates, so no accumulator takes more than 64 rows of depth: each
//     product is cut into slices of at most 64, each slice summed into a
//     fresh partial, and the partial added to the fp32 sum with rounding
//     adds (the matmul's scheme, csrc/matmul.cu).
//   * C B^T does not depend on the head.  A chunk_scan block owns one 64-row
//     tile of one chunk for a group of GROUP = 16 heads: it reads its C rows
//     and the chunk's B once, computes the scores (64 rows x up to 256 keys)
//     once into shared memory, and then serves the 16 heads from them, two
//     at a time, 4 warps a head.  For each head the decay exp(g_i - g_j) and
//     dt_j are applied to a score as its fragment is read, the causal mask
//     BEFORE the exp (keys after the row take exp(-1e30) = 0, so no inf ever
//     reaches a product).  So the scores cost 1/16 of what one per head did,
//     and C and B come from memory once per 16 heads.
//   * Blocks on Hopper run in no order, so the sequential chunk axis of the
//     TPU kernel becomes three passes and the chunks run in parallel:
//     1. chunk_state   (chunk, head, batch) blocks: g = cumsum(dt * A) by a
//                      warp scan (kept in a scratch), and the chunk's own
//                      state contribution (w B)^T x, w_j = exp(g_L - g_j)
//                      dt_j: 8 warps of 32 x 32 state entries over 64-row
//                      slices that cp.async double-buffers.
//     2. state_passing (N*P / 1024, head, batch) blocks: one thread per four
//                      state elements walks the chunks in order and turns
//                      each contribution into the state entering that chunk,
//                      in place, with 16 chunks' 16-byte loads in flight.
//     3. chunk_scan    (row tile, chunk, batch, head group) blocks, heaviest
//                      row tiles (most key tiles) first: double-buffered
//                      cp.async stages walk the chunk's B key tiles
//                      (scores), then for each pair of heads the two 64-deep
//                      slices of h_in (inter-chunk term, scaled by exp(g_i))
//                      and the x tiles of the live keys (intra-chunk term).
//                      A warp skips the keys after its last row.
//   * Fragments come from shared memory in few reads: row-major A tiles (C
//     rows, scores) and the transposed B of the scores by ldmatrix (fp32 as
//     pairs of 16-bit halves); x, h_in and chunk_state's transposed B as 8-
//     or 16-byte vectors, the tiles' columns (and chunk_state's rows)
//     interleaved so a thread's columns are neighbours, and the sums stored
//     back in the same interleaved order.
//   * Shared memory sets the shape.  chunk_scan holds the score panel
//     (64 x 260 fp32, 66,560 bytes), the C rows (64 x 132, 33,792), two
//     stages of two heads' 64 x 72 tiles (73,728) and g and dt of the 16
//     heads (32,768): 206,848 of the 232,448 bytes a block may have, one
//     block of 8 warps an SM at 176 registers (ptxas).  A 32-row tile
//     would halve the panel and fit two blocks an SM, but every x and h_in
//     tile read would then serve half as many rows.  GROUP = 16 makes the
//     scores 1/17 of a block's products (8: 1/9) on 512 blocks at the main
//     shape, 3.9 waves on 132 SMs; a third stage does not fit beside the
//     16 heads' g and dt.  chunk_state (108,544 bytes, 124 registers) runs
//     two blocks an SM.  Row strides are padded (C, B and score rows by 4
//     floats, x, h_in and chunk_state's B by 8) so that each fragment read
//     of a warp hits every bank once.
//
// Left for later: wgmma with TMA (the way to the full tensor-core rate) and
// a persistent grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_CHUNK = 256;
constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;               // chunk rows per chunk_scan block
constexpr int KEYS = 64;               // chunk rows a stage holds; the depth of a partial
constexpr int GROUP = 16;              // heads per chunk_scan block, two at a time
constexpr int PASS_AHEAD = 16;         // chunks state_passing loads at once
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one block
constexpr float NEG_BIG = -1e30f;      // the reference's mask value

struct Dims {
  int batch, seq, heads, chunk, n_chunks;
};

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

// c += a b in 3xTF32, the two small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// part += A B over k in [0, depth), depth a multiple of 8 and at most KEYS,
// for a warp's MT x NT tiles of 16 x 8 outputs.  a_frag(k, a) and
// b_frag(k, b) read the fragments of the k-step at depth k.  Fragments of
// m16n8k8 (lane = 4 g + t): a[i] holds A's (row, k) (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b[j] B's (k, column) (t, g), (t + 4, g); the
// sum holds rows g, g + 8 at columns 2 t, 2 t + 1.
template <int MT, int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_product(float (&part)[MT][NT][4],
                                             int depth, FA a_frag, FB b_frag) {
#pragma unroll 4
  for (int k = 0; k < depth; k += 8) {
    float a[MT][4];
    float b[NT][2];
    a_frag(k, a);
    b_frag(k, b);
    uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[i][e], a_hi[i][e], a_lo[i][e]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) split_tf32(b[j][e], b_hi[j][e], b_lo[j][e]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_3xtf32(part[i][j], a_hi[i], a_lo[i], b_hi[j], b_lo[j]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// V (2 or 4) neighbouring floats of shared memory in one read.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  static_assert(V == 2 || V == 4, "a 64- or 128-bit read");
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

// A fragments of MT 16-row tiles of a row-major fp32 tile (rows of `ld`
// floats, 16-byte aligned), each by one ldmatrix of 16-bit pairs; `tile` is
// the warp's first row at depth k.
template <int MT>
__device__ __forceinline__ void ldsm_a(float (&a)[MT][4], const float* tile,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t r[4];
    ldmatrix_x4(r, p + 16 * i * ld);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = __uint_as_float(r[e]);
  }
}

// B fragments of two 8-column tiles from B stored transposed, [column][k]
// (rows of `ld` floats, 16-byte aligned), by one ldmatrix; `tile` is the
// warp's first column at depth k.
__device__ __forceinline__ void ldsm_bt2(float (&b)[2][2], const float* tile,
                                         int ld) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldmatrix_x4(r, tile + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 4);
  b[0][0] = __uint_as_float(r[0]);
  b[0][1] = __uint_as_float(r[1]);
  b[1][0] = __uint_as_float(r[2]);
  b[1][1] = __uint_as_float(r[3]);
}

// B fragments of NT (2 or 4) 8-column tiles from a row-major [k][column]
// tile whose tiles are interleaved: column n of tile j is the warp's column
// NT n + j, so a thread's NT columns are neighbours and each k is one
// vector read.  `tile` is the warp's first column at depth k.
template <int NT>
__device__ __forceinline__ void lds_b(float (&b)[NT][2], const float* tile,
                                      int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (lane & 3) * ld + NT * (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[NT];
    load_vec(p + 4 * h * ld, v);
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j][h] = v[j];
  }
}

// A fragments of MT (1 or 2) 16-row tiles from A stored transposed,
// [k][row], whose tiles are interleaved: row r of tile i is the warp's row
// 2 MT (r % 8) + 2 i + r / 8, so a thread's 2 MT rows are neighbours and each
// k is one vector read.  `tile` is the warp's first row at depth k.
template <int MT>
__device__ __forceinline__ void lds_at(float (&a)[MT][4], const float* tile,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (lane & 3) * ld + 2 * MT * (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[2 * MT];
    load_vec(p + 4 * h * ld, v);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i][2 * h] = v[2 * i];
      a[i][2 * h + 1] = v[2 * i + 1];
    }
  }
}

// A thread's 2 NT sums in one row of a tile with interleaved columns (the
// warp's columns 2 NT t + [0, 2 NT), lane = 4 g + t): half hf (row g or
// g + 8) of each column tile, as 16-byte stores.
template <int NT>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&sum)[NT][4], int hf) {
  float v[2 * NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    v[j] = sum[j][2 * hf];
    v[NT + j] = sum[j][2 * hf + 1];
  }
#pragma unroll
  for (int q = 0; q < 2 * NT; q += 4)
    *reinterpret_cast<float4*>(dst + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&v)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
}

// sum += part, each partial promoted with a rounding fp32 add.
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&sum)[MT][NT][4],
                                        const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] += part[i][j][e];
}

__device__ __forceinline__ int round_up8(int v) { return (v + 7) & ~7; }

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

// chunk_state's shared memory: two stages, each a 64-row slice of B
// ([KEYS][LDB], the A operand read transposed) and of x ([KEYS][LDX]), then
// g and w of the chunk.  Warps tile the (N, P) state in MT x NT fragments.
template <int N, int P>
struct StateShape {
  static constexpr int LDB = N + 8;
  static constexpr int LDX = P + 8;
  static constexpr int MT = N >= 32 ? 2 : 1;
  static constexpr int NT = P >= 32 ? 4 : 2;
  static constexpr int WN = P / (8 * NT);          // warps along P
  static constexpr int BUSY = N / (16 * MT) * WN;  // warps with a tile
  static constexpr int STAGE = KEYS * (LDB + LDX);
  static constexpr int BYTES =
      (2 * STAGE + 2 * MAX_CHUNK) * static_cast<int>(sizeof(float));
  static_assert(BUSY <= WARPS, "the state tile needs more warps");
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks an SM");
};

// Pass 1.  grid (n_chunks, H, B); dynamic shared memory
// StateShape<N, P>::BYTES.  Writes g (B, H, S) and each chunk's own state
// contribution to states (B, H, n_chunks, N, P).
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 2)
chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const float* __restrict__ bm,
            float* __restrict__ g, float* __restrict__ states, Dims d) {
  using S = StateShape<N, P>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* g_s = ring + 2 * S::STAGE;    // [MAX_CHUNK]
  float* w_s = g_s + MAX_CHUNK;        // [MAX_CHUNK] exp(g_L - g_j) dt_j

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int L = d.chunk;
  const long long row0 = static_cast<long long>(bi) * d.seq +
                         static_cast<long long>(c) * L;   // (b, s) row of the chunk's start
  const int slices = (L + KEYS - 1) / KEYS;

  auto load = [&](int s) {             // rows past the chunk are zeros
    float* bs = ring + (s & 1) * S::STAGE;
    float* xs = bs + KEYS * S::LDB;
    const int j0 = s * KEYS;
    for (int idx = tid; idx < KEYS * (N / 4); idx += THREADS) {
      const int j = idx / (N / 4);
      const int v = idx - j * (N / 4);
      const bool ok = j0 + j < L;
      cp_async16(bs + j * S::LDB + 4 * v,
                 ok ? bm + (row0 + j0 + j) * N + 4 * v : bm, ok);
    }
    for (int idx = tid; idx < KEYS * (P / 4); idx += THREADS) {
      const int j = idx / (P / 4);
      const int v = idx - j * (P / 4);
      const bool ok = j0 + j < L;
      cp_async16(xs + j * S::LDX + 4 * v,
                 ok ? x + ((row0 + j0 + j) * d.heads + h) * P + 4 * v : x, ok);
    }
  };
  load(0);
  cp_async_commit();

  const float a_h = -expf(a_log[h]);   // A
  for (int j = tid; j < MAX_CHUNK; j += THREADS) {
    const float dtj = j < L ? dt[(row0 + j) * d.heads + h] : 0.f;
    w_s[j] = dtj;
    g_s[j] = dtj * a_h;
  }
  __syncthreads();
  if (tid < 32) warp_inclusive_scan(g_s, L, tid);
  __syncthreads();
  float* g_row = g + (static_cast<long long>(bi) * d.heads + h) * d.seq +
                 static_cast<long long>(c) * L;
  const float g_last = g_s[L - 1];
  for (int j = tid; j < MAX_CHUNK; j += THREADS) {
    if (j < L) g_row[j] = g_s[j];
    w_s[j] = j < L ? expf(g_last - g_s[j]) * w_s[j] : 0.f;
  }

  const bool busy = warp < S::BUSY;
  const int m0 = (warp / S::WN) * 16 * S::MT;   // the warp's first state row n
  const int n0 = (warp % S::WN) * 8 * S::NT;    // and column p
  const int gq = lane >> 2;
  const int tq = lane & 3;
  float acc[S::MT][S::NT][4];
  zero(acc);
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<0>();
    __syncthreads();                   // slice s is in; slice s - 1's stage is free
    if (s + 1 < slices) load(s + 1);
    cp_async_commit();
    if (busy) {
      const float* bs = ring + (s & 1) * S::STAGE;
      const float* xs = bs + KEYS * S::LDB;
      const float* ws = w_s + s * KEYS;
      float part[S::MT][S::NT][4];
      zero(part);
      warp_product(part, min(KEYS, round_up8(L - s * KEYS)),
                   [&](int k, float (&a)[S::MT][4]) {
                     lds_at(a, bs + k * S::LDB + m0, S::LDB);
                   },
                   [&](int k, float (&b)[S::NT][2]) {
                     lds_b(b, xs + k * S::LDX + n0, S::LDX);
                     const float w0 = ws[k + tq];
                     const float w1 = ws[k + tq + 4];
#pragma unroll
                     for (int j = 0; j < S::NT; ++j) {
                       b[j][0] *= w0;
                       b[j][1] *= w1;
                     }
                   });
      promote(acc, part);
    }
  }

  if (busy) {                          // rows and columns interleaved as read
    float* st = states + ((static_cast<long long>(bi) * d.heads + h) *
                          d.n_chunks + c) * (N * P);
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_row(st + (m0 + 2 * S::MT * gq + 2 * i + hf) * P + n0 + 2 * S::NT * tq,
                  acc[i], hf);
  }
}

// Pass 2.  grid (ceil(N*P / (4 THREADS)), H, B), four state elements a
// thread.  In place: the contribution of chunk c becomes the state
// entering chunk c.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
state_passing(float* __restrict__ states, const float* __restrict__ g, Dims d) {
  const int e = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (e >= N * P) return;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float* g_row = g + (static_cast<long long>(bi) * d.heads + h) * d.seq;
  float4* st = reinterpret_cast<float4*>(
      states + (static_cast<long long>(bi) * d.heads + h) * d.n_chunks * (N * P) + e);
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.n_chunks; c0 += PASS_AHEAD) {
    float4 inc[PASS_AHEAD];
    float decay[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = c0 + k;
      if (c < d.n_chunks) {
        inc[k] = st[static_cast<long long>(c) * (N * P / 4)];
        decay[k] = expf(g_row[static_cast<long long>(c) * d.chunk + d.chunk - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = c0 + k;
      if (c < d.n_chunks) {
        st[static_cast<long long>(c) * (N * P / 4)] = carry;
        carry.x = decay[k] * carry.x + inc[k].x;
        carry.y = decay[k] * carry.y + inc[k].y;
        carry.z = decay[k] * carry.z + inc[k].z;
        carry.w = decay[k] * carry.w + inc[k].w;
      }
    }
  }
}

// chunk_scan's shared memory: C of the block's rows [ROWS][LDC], the scores
// [ROWS][LDS], two stages (a B key tile [KEYS][LDK], or a
// pair of heads' x tiles or h_in slices, [KEYS][LDX] each), and g and dt of
// the group's heads [GROUP][MAX_CHUNK] each.  A head's 64 x P output is
// tiled over 4 warps in MT x NT fragments.
template <int N, int P>
struct ScanShape {
  static constexpr int LDC = N + 4;
  static constexpr int LDS = MAX_CHUNK + 4;
  static constexpr int LDK = N + 4;
  static constexpr int LDX = P + 8;
  static constexpr int HDEPTH = N < KEYS ? N : KEYS;   // h_in rows a stage holds
  static constexpr int HSLICES = N / HDEPTH;
  static constexpr int MT = P >= 32 ? 2 : 1;
  static constexpr int NT = P >= 32 ? 4 : 2;
  static constexpr int WC = P / (8 * NT);              // warps along P
  static constexpr int PAIR = 2 * KEYS * LDX;
  static constexpr int STAGE = PAIR > KEYS * LDK ? PAIR : KEYS * LDK;
  static constexpr int BYTES =
      (ROWS * LDC + ROWS * LDS + 2 * STAGE + 2 * GROUP * MAX_CHUNK) *
      static_cast<int>(sizeof(float));
  static_assert(N % HDEPTH == 0 && HDEPTH % 8 == 0, "N: 16 or a multiple of 64");
  static_assert(ROWS / (16 * MT) * WC == 4, "a head takes 4 warps");
  static_assert(BYTES <= SMEM_LIMIT, "one block's shared memory");
};

// Pass 3.  grid (ceil(L / ROWS) * n_chunks * B * ceil(H / GROUP)); dynamic
// shared memory ScanShape<N, P>::BYTES.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 1)
chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ bm, const float* __restrict__ cm,
           const float* __restrict__ g, const float* __restrict__ states,
           float* __restrict__ y, Dims d) {
  using S = ScanShape<N, P>;
  extern __shared__ float4 smem4[];
  float* c_s = reinterpret_cast<float*>(smem4);
  float* s_s = c_s + ROWS * S::LDC;
  float* ring = s_s + ROWS * S::LDS;
  float* g_s = ring + 2 * S::STAGE;
  float* dt_s = g_s + GROUP * MAX_CHUNK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int L = d.chunk;
  const int tiles = (L + ROWS - 1) / ROWS;
  const int groups = (d.heads + GROUP - 1) / GROUP;
  int idx = blockIdx.x;                // row tiles slowest, the last first
  const int grp = idx % groups;
  idx /= groups;
  const int c = idx % d.n_chunks;
  idx /= d.n_chunks;
  const int bi = idx % d.batch;
  const int r0 = (tiles - 1 - idx / d.batch) * ROWS;  // the block's first row
  const int r_end = min(r0 + ROWS, L);                 // rows [r0, r_end); keys [0, r_end)
  const int key_tiles = (r_end + KEYS - 1) / KEYS;
  const int h0 = grp * GROUP;
  const int heads = min(GROUP, d.heads - h0);
  const int pairs = (heads + 1) / 2;
  const int per_pair = S::HSLICES + key_tiles;
  const int stages = key_tiles + pairs * per_pair;
  const long long row0 = static_cast<long long>(bi) * d.seq +
                         static_cast<long long>(c) * L;

  // Stage q: key tile q of B for q < key_tiles, else for pair q' / per_pair
  // (q' = q - key_tiles) its h_in slice q' % per_pair, or x tile
  // q' % per_pair - HSLICES.  Rows past the live keys are zeros.
  auto load = [&](int q) {
    float* buf = ring + (q & 1) * S::STAGE;
    if (q < key_tiles) {
      const int k0 = q * KEYS;
      for (int i = tid; i < KEYS * (N / 4); i += THREADS) {
        const int j = i / (N / 4);
        const int v = i - j * (N / 4);
        const bool ok = k0 + j < r_end;
        cp_async16(buf + j * S::LDK + 4 * v,
                   ok ? bm + (row0 + k0 + j) * N + 4 * v : bm, ok);
      }
      return;
    }
    const int pair = (q - key_tiles) / per_pair;
    const int s = (q - key_tiles) - pair * per_pair;
    for (int half = 0; half < 2 && 2 * pair + half < heads; ++half) {
      const int h = h0 + 2 * pair + half;
      float* dst = buf + half * KEYS * S::LDX;
      if (s < S::HSLICES) {
        const float* src =
            states + ((static_cast<long long>(bi) * d.heads + h) * d.n_chunks + c) *
                         (N * P) + s * S::HDEPTH * P;
        for (int i = tid; i < S::HDEPTH * (P / 4); i += THREADS) {
          const int n = i / (P / 4);
          const int v = i - n * (P / 4);
          cp_async16(dst + n * S::LDX + 4 * v, src + n * P + 4 * v, true);
        }
      } else {
        const int k0 = (s - S::HSLICES) * KEYS;
        for (int i = tid; i < KEYS * (P / 4); i += THREADS) {
          const int j = i / (P / 4);
          const int v = i - j * (P / 4);
          const bool ok = k0 + j < r_end;
          cp_async16(dst + j * S::LDX + 4 * v,
                     ok ? x + ((row0 + k0 + j) * d.heads + h) * P + 4 * v : x, ok);
        }
      }
    }
  };

  for (int i = tid; i < ROWS * (N / 4); i += THREADS) {   // C rows, with stage 0
    const int r = i / (N / 4);
    const int v = i - r * (N / 4);
    const bool ok = r0 + r < r_end;
    cp_async16(c_s + r * S::LDC + 4 * v,
               ok ? cm + (row0 + r0 + r) * N + 4 * v : cm, ok);
  }
  load(0);
  cp_async_commit();
  // g and dt of the group's heads; zeros past the live rows and heads.
  for (int i = tid; i < GROUP * MAX_CHUNK; i += THREADS) {
    const int hh = i / MAX_CHUNK;
    const int j = i - hh * MAX_CHUNK;
    const bool ok = hh < heads && j < r_end;
    g_s[i] = ok ? g[(static_cast<long long>(bi) * d.heads + h0 + hh) * d.seq +
                    static_cast<long long>(c) * L + j]
                : 0.f;
    dt_s[i] = ok ? dt[(row0 + j) * d.heads + h0 + hh] : 0.f;
  }

  // Scores: warps of 32 rows x 16 keys.  Heads: warps 0-3 take the first
  // head of a pair, 4-7 the second, each a (16 MT) x (8 NT) tile of 64 x P.
  const int sm0 = (warp & 1) * 32;
  const int sn0 = (warp >> 1) * 16;
  const int half = warp >> 2;
  const int hm0 = ((warp & 3) / S::WC) * 16 * S::MT;
  const int hn0 = ((warp & 3) % S::WC) * 8 * S::NT;
  float acc[S::MT][S::NT][4];
  zero(acc);

  for (int q = 0; q < stages; ++q) {
    cp_async_wait<0>();
    __syncthreads();                   // stage q is in; stage q - 1's buffer is free
    if (q + 1 < stages) load(q + 1);
    cp_async_commit();
    const float* buf = ring + (q & 1) * S::STAGE;

    if (q < key_tiles) {               // scores of key tile q, N deep
      const int k0 = q * KEYS;
      float sc[2][2][4];
      zero(sc);
      for (int d0 = 0; d0 < N; d0 += S::HDEPTH) {
        float part[2][2][4];
        zero(part);
        warp_product(part, S::HDEPTH,
                     [&](int k, float (&a)[2][4]) {
                       ldsm_a(a, c_s + sm0 * S::LDC + d0 + k, S::LDC);
                     },
                     [&](int k, float (&b)[2][2]) {
                       ldsm_bt2(b, buf + sn0 * S::LDK + d0 + k, S::LDK);
                     });
        promote(sc, part);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                s_s + (sm0 + 16 * i + gq + 8 * hf) * S::LDS + k0 + sn0 + 8 * j + 2 * tq) =
                make_float2(sc[i][j][2 * hf], sc[i][j][2 * hf + 1]);
      continue;
    }

    const int pair = (q - key_tiles) / per_pair;
    const int s = (q - key_tiles) - pair * per_pair;
    const int hh = 2 * pair + half;    // the warp's head within the group
    if (hh >= heads) continue;
    const float* xb = buf + half * KEYS * S::LDX;
    const float* gh = g_s + hh * MAX_CHUNK;
    const float* dth = dt_s + hh * MAX_CHUNK;
    float part[S::MT][S::NT][4];
    zero(part);
    if (s < S::HSLICES) {              // inter-chunk term, exp(g_i) C_i h_in
      const int d0 = s * S::HDEPTH;
      warp_product(part, S::HDEPTH,
                   [&](int k, float (&a)[S::MT][4]) {
                     ldsm_a(a, c_s + hm0 * S::LDC + d0 + k, S::LDC);
                   },
                   [&](int k, float (&b)[S::NT][2]) {
                     lds_b(b, xb + k * S::LDX + hn0, S::LDX);
                   });
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float decay = expf(gh[r0 + hm0 + 16 * i + gq + 8 * hf]);
#pragma unroll
          for (int j = 0; j < S::NT; ++j) {
            acc[i][j][2 * hf] += decay * part[i][j][2 * hf];
            acc[i][j][2 * hf + 1] += decay * part[i][j][2 * hf + 1];
          }
        }
    } else {                           // intra-chunk term over key tile k0
      const int k0 = (s - S::HSLICES) * KEYS;
      const int live_end = min(r0 + hm0 + 16 * S::MT, r_end);   // past the warp's last row
      const int depth = min(KEYS, round_up8(live_end - k0));
      if (depth > 0) {
        int rows[S::MT][2];            // the thread's rows and their g
        float g_rows[S::MT][2];
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            rows[i][hf] = r0 + hm0 + 16 * i + gq + 8 * hf;
            g_rows[i][hf] = gh[rows[i][hf]];
          }
        warp_product(
            part, depth,
            [&](int k, float (&a)[S::MT][4]) {
              ldsm_a(a, s_s + hm0 * S::LDS + k0 + k, S::LDS);
              // Decay and causal mask, the mask applied BEFORE the exp.
#pragma unroll
              for (int kh = 0; kh < 2; ++kh) {
                const int j = k0 + k + tq + 4 * kh;
                const float g_j = gh[j];
                const float dt_j = dth[j];
#pragma unroll
                for (int i = 0; i < S::MT; ++i)
#pragma unroll
                  for (int hf = 0; hf < 2; ++hf) {
                    const int row = rows[i][hf];
                    const float arg =
                        (j <= row && row < r_end) ? g_rows[i][hf] - g_j : NEG_BIG;
                    a[i][2 * kh + hf] *= __expf(arg) * dt_j;
                  }
              }
            },
            [&](int k, float (&b)[S::NT][2]) {
              lds_b(b, xb + k * S::LDX + hn0, S::LDX);
            });
        promote(acc, part);
      }
    }

    if (s == per_pair - 1) {           // the head is done: store its rows
      const int h = h0 + hh;
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + hm0 + 16 * i + gq + 8 * hf;
          if (r < r_end)               // columns interleaved as x was read
            store_row(y + ((row0 + r) * d.heads + h) * P + hn0 + 2 * S::NT * tq,
                      acc[i], hf);
        }
      zero(acc);
    }
  }
}

template <int N, int P>
int launch(const float* x, const float* dt, const float* a_log,
           const float* bm, const float* cm, float* y, float* g,
           float* states, Dims d, cudaStream_t stream) {
  constexpr int state_smem = StateShape<N, P>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state<N, P><<<dim3(d.n_chunks, d.heads, d.batch), THREADS, state_smem,
                      stream>>>(x, dt, a_log, bm, g, states, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  state_passing<N, P><<<dim3((N * P / 4 + THREADS - 1) / THREADS, d.heads, d.batch),
                        THREADS, 0, stream>>>(states, g, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int scan_smem = ScanShape<N, P>::BYTES;
  err = cudaFuncSetAttribute(chunk_scan<N, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((d.chunk + ROWS - 1) / ROWS) *
                           d.n_chunks * d.batch * ((d.heads + GROUP - 1) / GROUP);
  if (blocks > 0x7fffffffLL) return -3;
  chunk_scan<N, P><<<static_cast<unsigned>(blocks), THREADS, scan_smem, stream>>>(
      x, dt, bm, cm, g, states, y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  All tensors fp32, contiguous and 16-byte
// aligned: x, y (B, S, H, P); dt (B, S, H); a_log (H,); b, c (B, S, N);
// scratch g (B, H, S) and states (B, H, S / chunk, N, P), allocated by the
// caller.  Returns the cudaError_t of the launches (0 = success), -1 for an
// (N, P) that was not instantiated, -3 for a chunk outside [1, 256] or one
// that does not divide S, or a grid too large.  Launches on `stream` and
// does not synchronise.
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
