// Forward flash attention for Hopper (sm_90a): causal, sliding-window and
// GQA masks, online softmax in fp32.  Two kernels behind one entry point:
// bf16 inputs run on the tensor cores, fp32 inputs on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `mha` (the
// pl.pallas_call at line 128) with its body `_attn_kernel` (lines 33-93).
//
// What it computes, as the TPU kernel does:
//   q (B, Hq, S, D); k, v (B, Hkv, S, D), fp32 or bf16, head dim stride 1,
//   every other stride passed in (the model hands in transposed views of
//   (B, S, H, D) activations, so nothing is copied to make them contiguous).
//   Scores, running max m, running sum l and the accumulator are fp32; the
//   output o (B, Hq, S, D) is contiguous and in the inputs' type.
//   Masks: key < seq_len, causal key <= query, window key >= query - window.
//   A fully masked row outputs 0 (l == 0 -> 1).  KV head = q head / group,
//   read in place: the repeated heads are never materialised.
//   Key tiles that no query row of the block can see are never loaded, so
//   sliding-window attention costs O(S * window), not O(S^2).
//
// What bounds it on an H100: operations.  Each (query, key) pair costs 4*D
// flops against 2*D bytes of K/V that every query row of a block shares, so
// at the model's shapes (S = 8192, window 4096) the work is ~260 GFLOP per
// layer against ~0.1 GB of traffic: far right of the card's ridge point.
// The rate that matters is the tensor cores' (989 TFLOP/s bf16), fifteen
// times the CUDA cores' fp32 FMA rate (67 TFLOP/s).
//
// bf16 (`attn_fwd_tc`), FA2-style on the tensor cores:
//   * one block = one (batch, q head) and 128 query rows, 8 warps, 16 rows a
//     warp; the Q tile is loaded once into shared memory and read from
//     there (ldmatrix) as mma.sync.m16n8k16 A fragments for each key tile,
//     which leaves its registers to the accumulators;
//   * K and V tiles of 64 keys stay bf16 in dynamic shared memory, filled by
//     16-byte cp.async copies through the caller's strides and double
//     buffered, so tile j+1 is in flight while tile j is computed.  Rows are
//     padded by 16 bytes (D + 8 elements), so the eight rows an ldmatrix
//     reads start in eight different bank quads: no bank is hit twice;
//   * S = Q K^T with an fp32 accumulator (ldmatrix for K), the online
//     softmax on the S fragments in registers (sm_scale * log2 e folded in,
//     ex2.approx), then O += P V (ldmatrix.trans for V) with O rescaled by
//     alpha;
//   * for head dims up to 80 the kernel is held to 128 registers, so two
//     blocks (16 warps, 2 x 66 KB of shared memory at D = 80) share an SM
//     and one block's softmax overlaps the other's products;
//   * at D = 256 (recurrentgemma-9b) a warp's 16 x 256 O accumulator alone
//     is 128 fp32 registers a thread, so the key tiles are 16 keys (S is 8
//     registers, not 32): with 32-key tiles the kernel needs 255 registers
//     and spills 40 bytes.  The tile copy loop is left rolled there (a
//     few registers fewer, and faster on the card than unrolled:
//     scripts/kernel_variants.py).  One block of 8 warps runs an SM (Q and
//     two K/V stages: 101,376 bytes of shared memory);
//   * P is split into bf16 p_hi + p_lo and multiplies V twice.  P rounded
//     once to bf16 (8 bits) moves rows with few live keys by up to a bf16
//     unit of |v|, past the 1e-3 + 1e-2 |out| gate; the split keeps ~16
//     bits for 1.5x the tensor-core work.  l sums the same p_hi + p_lo;
//   * masks are evaluated only on tiles that straddle an edge of the warp's
//     rows (seq_len, the diagonal, the window's lower edge); a warp skips
//     the products of a tile none of its rows sees; blocks start with the
//     last query tile, the one with the most keys.
//   When a pointer or stride is not 16-byte aligned, the same kernel stages
//   the tiles with element loads instead of cp.async.
//
// fp32 (`attn_fwd_f32`) keeps the reference's 5e-5 on the CUDA cores (TF32
// would not): 64 query rows a block, two threads a row (four at D = 256),
// each holding its share of the row's q and accumulator in registers in
// 4-wide pieces, a loop over 32-key fp32 tiles (16 at D = 256, so the two
// tiles stay within 48 KB of static shared memory) in shared memory, the
// partial dot products meeting through warp shuffles.
//
// Head dims: 16 (the smoke configs of recurrentgemma-9b, qwen3-moe and
// deepseek-v3), 64, 80, 128 and 256.  At D = 16 the bf16 kernel is the same
// design with one k-step of Q K^T and two 8-wide column tiles of O (48-byte
// padded rows, 18 KB of shared memory); the fp32 kernel gives a row two
// threads of 8 dims each.  The wrapper zero-pads any other head dim up to
// 256 to the next of these.
//
// Left for later: wgmma fed by TMA (the only way to the full bf16 rate),
// and packing a GQA group's q heads into one block so each K/V tile is
// loaded once for all of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;      // the TPU kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;                   // in elements; the head dim has stride 1
};

// ------------------------------------------------------ bf16, tensor cores

constexpr int TC_BQ = 128;             // query rows per block, 16 per warp
constexpr int TC_THREADS = 256;        // 8 warps
constexpr int TC_PAD = 8;              // 16 bytes of padding per smem row

using bf16 = __nv_bfloat16;

template <int D>
__host__ __device__ constexpr int tc_bkv() {  // keys per K / V tile
  return D > 128 ? 16 : 64;
}

template <int D>
constexpr int tc_smem_bytes() {        // Q, then K and V two stages each
  return (TC_BQ + 4 * tc_bkv<D>()) * (D + TC_PAD) *
         static_cast<int>(sizeof(bf16));
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

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Rows [row0, row0 + ROWS) of a (seq, D) slab with row stride `stride`
// into shared memory rows of D + TC_PAD elements; rows past seq_len are 0.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, long long stride,
                                          int seq_len, bool vec, int tid) {
  constexpr int LD = D + TC_PAD;
  if (vec) {
    constexpr int CPR = D / 8;         // 16-byte chunks per row
#pragma unroll (D > 128 ? 1 : 8)
    for (int c = tid; c < ROWS * CPR; c += TC_THREADS) {
      const int r = c / CPR;
      const int ch = c - r * CPR;
      const int row = row0 + r;
      const bool in = row < seq_len;
      const bf16* g = in ? src + row * stride + ch * 8 : src;
      cp_async16(dst + r * LD + ch * 8, g, in);
    }
  } else {
    for (int e = tid; e < ROWS * D; e += TC_THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const int row = row0 + r;
      dst[r * LD + d] =
          row < seq_len ? src[row * stride + d] : __float2bfloat16(0.f);
    }
  }
}

// 2^x on the special-function unit (relative error ~2^-22; 0 for x below
// -126, which is all a masked score ever gives).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 80 ? 2 : 1)
attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, int seq_len,
            int group, Strides qs, Strides ks, Strides vs, float scale_log2,
            int causal, int window, int vec) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + TC_PAD;
  constexpr int KSTEPS = D / 16;       // k-steps of Q K^T
  constexpr int DT = D / 8;            // 8-wide column tiles of O
  constexpr int BKV = tc_bkv<D>();     // keys per K / V tile
  constexpr int NT = BKV / 8;          // 8-wide key tiles of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + TC_BQ * LD;
  bf16* sv = sk + 2 * BKV * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;             // fragment row within 8
  const int t = lane & 3;              // fragment column pair
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * TC_BQ;

  const bf16* qp = q + bi * qs.b + hi * qs.h;
  const bf16* kp = k + bi * ks.b + (hi / group) * ks.h;
  const bf16* vp = v + bi * vs.b + (hi / group) * vs.h;

  // The keys some row of this block may see; tiles outside are skipped.
  const int q_last = min(q_start + TC_BQ, seq_len) - 1;
  const int k_lo = window > 0 ? max(0, q_start - window) : 0;
  const int k_hi = causal ? q_last : seq_len - 1;
  const int t_first = k_lo / BKV;
  const int t_last = k_hi / BKV;

  load_rows<TC_BQ, D>(sq, qp, q_start, qs.s, seq_len, vec, tid);
  load_rows<BKV, D>(sk, kp, t_first * BKV, ks.s, seq_len, vec, tid);
  load_rows<BKV, D>(sv, vp, t_first * BKV, vs.s, seq_len, vec, tid);
  cp_async_commit();

  const int qw0 = q_start + 16 * warp; // this warp's rows: qw0 .. qw0 + 15
  const int qw1 = qw0 + 15;
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}; // rows g and g + 8
  float l_run[2] = {0.f, 0.f};         // this thread's share of the row sums

  for (int tile = t_first; tile <= t_last; ++tile) {
    const int buf = (tile - t_first) & 1;
    if (tile < t_last) {               // the next tile, into the other stage
      const int nb = buf ^ 1;
      load_rows<BKV, D>(sk + nb * BKV * LD, kp, (tile + 1) * BKV,
                           ks.s, seq_len, vec, tid);
      load_rows<BKV, D>(sv + nb * BKV * LD, vp, (tile + 1) * BKV,
                           vs.s, seq_len, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // this tile (and Q) landed for all

    const int k0 = tile * BKV;
    const bool sees = qw0 < seq_len && !(causal && k0 > qw1) &&
                      !(window > 0 && k0 + BKV - 1 < qw0 - window);
    if (sees) {
      const bf16* kt = sk + buf * BKV * LD;
      const bf16* vt = sv + buf * BKV * LD;

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qk[4];                // the warp's 16 rows of Q, dims 16 kk ..
        ldmatrix_x4(qk, sq + (16 * warp + (lane & 7) +
                              (((lane >> 3) & 1) << 3)) * LD +
                            16 * kk + ((lane >> 4) << 3));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD +
                             16 * kk + (((lane >> 3) & 1) << 3));
          mma_bf16(s[2 * np], qk, b[0], b[1]);
          mma_bf16(s[2 * np + 1], qk, b[2], b[3]);
        }
      }

      // Scale into log2 units; mask only where the tile straddles an edge.
      const bool edge = k0 + BKV - 1 >= seq_len ||
                        (causal && k0 + BKV - 1 > qw0) ||
                        (window > 0 && k0 < qw1 - window);
      uint32_t live = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = qw0 + g + ((e >> 1) << 3);
            const bool ok = key < seq_len && (!causal || key <= row) &&
                            (window <= 0 || key >= row - window);
            if (!ok) {
              s[j][e] = NEG_INF;
              live &= ~(1u << (4 * j + e));
            }
          }
        }
      }

      float m_new[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mc = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mc = fmaxf(mc, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        m_new[r] = fmaxf(m_run[r], mc);
        alpha[r] = fast_exp2(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      float p_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // A fragments of P for keys 16 kk .. 16 kk + 15: key tiles 2 kk and
        // 2 kk + 1, rows g (elements 0, 1) and g + 8 (elements 2, 3).
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * r + c;
              p[c] = (live >> (4 * j + e)) & 1u
                         ? fast_exp2(s[j][e] - m_new[r]) : 0.f;
            }
            const bf16 h0 = __float2bfloat16(p[0]);
            const bf16 h1 = __float2bfloat16(p[1]);
            const bf16 l0 = __float2bfloat16(p[0] - __bfloat162float(h0));
            const bf16 l1 = __float2bfloat16(p[1] - __bfloat162float(h1));
            p_sum[r] += (__bfloat162float(h0) + __bfloat162float(l0)) +
                        (__bfloat162float(h1) + __bfloat162float(l1));
            ph[2 * half + r] = pack_bf16(h0, h1);
            pl[2 * half + r] = pack_bf16(l0, l1);
          }
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + (16 * kk + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * LD +
                                 16 * dp + ((lane >> 4) << 3));
          mma_bf16(acc[2 * dp], pl, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);
          mma_bf16(acc[2 * dp], ph, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], ph, b[2], b[3]);
        }
      }
      l_run[0] = alpha[0] * l_run[0] + p_sum[0];
      l_run[1] = alpha[1] * l_run[1] + p_sum[1];
    }
    __syncthreads();                   // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  bf16* op = o + (static_cast<long long>(bi) * gridDim.y + hi) * seq_len * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + g + 8 * r;
    if (row >= seq_len) continue;
    const float denom = l_run[r] == 0.f ? 1.f : l_run[r];  // fully masked -> 0
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(
          op + static_cast<long long>(row) * D + 8 * j + 2 * t) = pair;
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int batch,
              int heads_q, int group, int seq_len, Strides qs, Strides ks,
              Strides vs, float sm_scale, int causal, int window,
              cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async moves 16 bytes: every row start must be 16-byte aligned.
  auto aligned = [](const void* p, Strides st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
           st.h % 8 == 0 && st.s % 8 == 0;
  };
  const int vec = aligned(q, qs) && aligned(k, ks) && aligned(v, vs);
  const dim3 grid((seq_len + TC_BQ - 1) / TC_BQ, heads_q, batch);
  attn_fwd_tc<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), seq_len, group, qs,
      ks, vs, sm_scale * LOG2E, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ fp32, CUDA cores

constexpr int BLOCK_Q = 64;            // query rows per block

// Threads a query row and keys a shared-memory tile (at most 32: the bits
// of the live mask), by head dim: a thread holds D / TPR of q and of the
// accumulator; the two tiles take 2 BKV D 4 bytes of static shared memory.
template <int D> struct F32Tile {
  static constexpr int TPR = D > 128 ? 4 : 2;
  static constexpr int BKV = D > 128 ? 16 : 32;
  static constexpr int THREADS = TPR * BLOCK_Q;
};

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::THREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int seq_len,
             int group, Strides qs, Strides ks, Strides vs, float sm_scale,
             int causal, int window) {
  constexpr int TPR = F32Tile<D>::TPR;
  constexpr int BLOCK_KV = F32Tile<D>::BKV;
  constexpr int THREADS = F32Tile<D>::THREADS;
  static_assert(D % (4 * TPR) == 0, "head dim must split into 4-wide pieces");
  constexpr int OWN = D / TPR;         // dims owned by one thread
  constexpr int PIECES = D / (4 * TPR);
  constexpr int STRIDE = 4 * TPR;      // thread `part` owns dims
                                       // [STRIDE c + 4 part, STRIDE c + 4 part + 4)

  __shared__ __align__(16) float k_tile[BLOCK_KV * D];
  __shared__ __align__(16) float v_tile[BLOCK_KV * D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q_start = blockIdx.x * BLOCK_Q;
  const int qpos = q_start + tid / TPR;

  const float* qp = q + bi * qs.b + hi * qs.h;
  const float* kp = k + bi * ks.b + (hi / group) * ks.h;
  const float* vp = v + bi * vs.b + (hi / group) * vs.h;

  float qr[OWN];
  float acc[OWN];
#pragma unroll
  for (int c = 0; c < PIECES; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = STRIDE * c + 4 * part + e;
      qr[4 * c + e] = qpos < seq_len ? qp[qpos * qs.s + d] : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = NEG_INF;
  float l = 0.f;

  // The keys some row of this block may see; tiles outside are skipped.
  const int q_last = min(q_start + BLOCK_Q, seq_len) - 1;
  const int k_lo = window > 0 ? max(0, q_start - window) : 0;
  const int k_hi = causal ? q_last : seq_len - 1;

  for (int k_start = (k_lo / BLOCK_KV) * BLOCK_KV; k_start <= k_hi;
       k_start += BLOCK_KV) {
    __syncthreads();                   // every thread is done with the last tile
    for (int idx = tid; idx < BLOCK_KV * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int key = k_start + j;
      const bool in = key < seq_len;   // the ragged tail reads as zeros
      k_tile[idx] = in ? kp[key * ks.s + d] : 0.f;
      v_tile[idx] = in ? vp[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[BLOCK_KV];
    unsigned live = 0u;
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const float* kr = k_tile + j * D + 4 * part;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < PIECES; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + STRIDE * c);
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if constexpr (TPR == 4) dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = k_start + j;
      const bool ok = key < seq_len && (!causal || key <= qpos) &&
                      (window <= 0 || key >= qpos - window);
      s[j] = ok ? dot * sm_scale : NEG_INF;
      live |= ok ? (1u << j) : 0u;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      s[j] = (live >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int i = 0; i < OWN; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const float* vr = v_tile + j * D + 4 * part;
#pragma unroll
      for (int c = 0; c < PIECES; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + STRIDE * c);
        acc[4 * c + 0] = fmaf(s[j], vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(s[j], vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(s[j], vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(s[j], vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (qpos < seq_len) {
    const float denom = l == 0.f ? 1.f : l;   // fully masked rows give 0
    float* op = o + ((static_cast<long long>(bi) * gridDim.y + hi) * seq_len +
                     qpos) * D;
#pragma unroll
    for (int c = 0; c < PIECES; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        op[STRIDE * c + 4 * part + e] = acc[4 * c + e] / denom;
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int heads_q, int group, int seq_len, Strides qs,
               Strides ks, Strides vs, float sm_scale, int causal, int window,
               cudaStream_t stream) {
  const dim3 grid((seq_len + BLOCK_Q - 1) / BLOCK_Q, heads_q, batch);
  attn_fwd_f32<D><<<grid, F32Tile<D>::THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq_len, group,
      qs, ks, vs, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int heads_q, int group, int seq_len, Strides qs,
           Strides ks, Strides vs, float sm_scale, int causal, int window,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, batch, heads_q, group, seq_len, qs, ks,
                         vs, sm_scale, causal, window, stream);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, o, batch, heads_q, group, seq_len, qs, ks,
                        vs, sm_scale, causal, window, stream);
  return -2;
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success), -1 for a head dim that
// was not instantiated, -2 for an unknown dtype.  Launches on `stream` and
// does not synchronise; `o` is allocated by the caller.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads_q, int heads_kv, int seq_len, int head_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float sm_scale, int causal, int window, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss};
  const Strides ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss};
  const int group = heads_q / heads_kv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, o, batch, heads_q, group, seq_len, qs,
                        ks, vs, sm_scale, causal, window, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, heads_q, group, seq_len, qs,
                        ks, vs, sm_scale, causal, window, st);
    case 80:
      return launch<80>(dtype, q, k, v, o, batch, heads_q, group, seq_len, qs,
                        ks, vs, sm_scale, causal, window, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, heads_q, group, seq_len,
                         qs, ks, vs, sm_scale, causal, window, st);
    case 256:
      return launch<256>(dtype, q, k, v, o, batch, heads_q, group, seq_len,
                         qs, ks, vs, sm_scale, causal, window, st);
    default:
      return -1;
  }
}
