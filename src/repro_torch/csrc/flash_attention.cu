// Forward flash attention for Hopper (sm_90a): causal, sliding-window and
// GQA masks, online softmax in fp32.  Three kernels behind one entry point:
// bf16 inputs run on the tensor cores, through wgmma fed by TMA where the
// caller asks for it (head dims 64, 80 and 128, inputs TMA can describe)
// and through mma.sync otherwise; fp32 inputs run on the CUDA cores.
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
// bf16 (`attn_fwd_wg`), warp-specialised, wgmma fed by TMA:
//   * one block = one (batch, q head) and 128 query rows, 384 threads: a
//     producer warpgroup (setmaxnreg down to 24 registers) whose one thread
//     issues TMA loads, and two consumer warpgroups of 64 rows (setmaxnreg
//     up to 240: S, O and two P buffers spill at 224);
//   * TMA copies Q once and K, V tiles of 128 keys into a ring of 3 stages
//     (2 at D = 128), each stage's K and V on their own mbarrier, a third
//     mbarrier per stage counting the consumer warps that are done with
//     it.  Tensor maps describe q, k, v as (D, S, H, B) through the
//     caller's strides (16-byte multiples), boxes of 16 columns (32 bytes,
//     the 32-byte swizzle's span: 80 is no multiple of 32 or 64) by 128
//     rows; rows past S arrive as zeros, so the ragged last tile needs no
//     masked load;
//   * S = Q K^T: D / 16 wgmma m64n128k16 from shared memory (K-major; the
//     first with scale-d 0 and write-only operands, so S is not live from
//     one tile to the next and the new P can take its registers); the
//     softmax in registers exactly as in attn_fwd_tc (fp32, sm_scale * log2
//     e folded in, ex2.approx, running m and l); O += P V: wgmma m64nDk16
//     with P from registers (p_lo then p_hi, the split kept) and V from
//     shared memory (MN-major, imm-trans-b);
//   * each step issues this tile's S and the last tile's P V together, then
//     runs this tile's exponentials and P split into the other P buffer
//     while P V is in flight; after P V only O *= alpha remains.  The two
//     consumers run unsynchronised: a ping-pong on named barriers (one
//     issuing its products while the other runs its softmax) measured
//     within 2% either way;
//   * kept from attn_fwd_tc: tiles no row of the block sees are never
//     loaded, blocks start with the last query tile, masks only on tiles
//     that straddle an edge of the warpgroup's rows, a fully masked row
//     outputs 0, rows at or past S are never stored, KV head = q head /
//     group read in place.
//   Measured at danube's shape (one H100 SXM, S 8192, window 4096): 0.85-
//   0.90 ms a call against attn_fwd_tc's 1.77.  What bounds it now is not
//   the products (a second Q K^T a tile costs its tensor time) but the
//   loads and each tile's latency: Q K^T with its loads alone takes 0.55 ms,
//   of which 0.2 ms go when V is not loaded (K and V move ~4.5 TB/s out of
//   L2 into the SMs).
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
// Left for later: fewer bytes from L2 per product, the wgmma kernel's
// limit: a GQA group's q heads sharing each K/V tile (packed into one
// block, or a cluster whose TMA multicasts the tile), and 128-byte boxes
// for 64 of D = 80's columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
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

// -------------------------------------------- bf16, wgmma fed by TMA (sm_90a)

constexpr int WG_BQ = 128;             // query rows a block, 64 a consumer
constexpr int WG_BKV = 128;            // keys a K / V tile
constexpr int WG_THREADS = 384;        // producer + two consumer warpgroups
constexpr int WG_ROW = 32;             // bytes of a box row: 16 bf16, the
                                       // 32-byte swizzle's span
constexpr int WG_CHUNK = WG_BKV * WG_ROW;  // one 16-column slice of a tile
static_assert(WG_BQ == WG_BKV, "Q, K and V tiles share one box");

template <int D>
__host__ __device__ constexpr int wg_stages() {  // K / V stages in the ring
  return D > 80 ? 2 : 3;
}

template <int D>
__host__ __device__ constexpr int wg_tile_bytes() {  // one Q, K or V tile
  return WG_BKV * D * static_cast<int>(sizeof(bf16));
}

template <int D>
constexpr int wg_smem_bytes() {        // Q, the ring, 8-byte barriers, and
  return (1 + 2 * wg_stages<D>()) * wg_tile_bytes<D>() +  // room to align
         8 * (1 + 3 * wg_stages<D>()) + 1024;            // the tiles to 1 KB
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Spins until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// One TMA box (16 head-dim columns x WG_BKV rows of one head) into shared
// memory, counted on `bar`; rows past the map's S arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(head), "r"(batch), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// Shared-memory matrix descriptor of a 32-byte-swizzled operand: start
// address, leading and stride byte offsets, all in 16-byte units; layout
// type 3 is the 32-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 3ull << 62;
}

// d (64 x 128, fp32) += A (64 x 16) * B (16 x 128), both from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, fp32) = A (64 x 16) * B (16 x 128): scale-d 0, so d is
// written and never read.
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared
// memory, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, fp32) += A (64 x 16, registers) * B (16 x 80, shared
// memory, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, shared
// memory, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for the consumer's 64 rows and one tile of keys: D / 16 k-steps,
// each one 32-byte slice of Q and of K.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[WG_BKV / 2], uint64_t dq,
                                         uint64_t dk) {
  wgmma_qk_first(s, dq, dk);           // S is not live before its product
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_qk(s, dq + kk * (WG_CHUNK >> 4), dk + kk * (WG_CHUNK >> 4));
  wgmma_commit();
}


// The online softmax's first half on one tile of scores, in place: scale
// into log2 units, mask where the tile straddles an edge of the
// warpgroup's rows, the new running max, alpha = 2^(m_old - m_new), and
// s -> 2^(s - m_new).  A row with no live key so far keeps m = -inf and
// gets p = 0 (its max is taken as 0 for the subtraction).
__device__ __forceinline__ void softmax_tile(
    float (&s)[WG_BKV / 2], float (&m_run)[2], float (&alpha)[2],
    float scale_log2, bool edge, int k0, int row0, int t, int seq_len,
    int causal, int window) {
  constexpr int NJ = WG_BKV / 8;       // 8-key column tiles of S
#pragma unroll
  for (int i = 0; i < WG_BKV / 2; ++i) s[i] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + ((e >> 1) << 3);
        const bool ok = key < seq_len && (!causal || key <= row) &&
                        (window <= 0 || key >= row - window);
        if (!ok) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mc = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mc = fmaxf(mc, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m_run[r], mc);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = fast_exp2(m_run[r] - m_use[r]);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = fast_exp2(s[4 * j + e] - m_use[e >> 1]);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// P of one tile as wgmma A fragments: bf16 p_hi + p_lo, keys 16 kk .. 16 kk
// + 15 in hi[kk] and lo[kk] (S's column tiles 2 kk and 2 kk + 1).
struct PFrag {
  uint32_t hi[WG_BKV / 16][4];
  uint32_t lo[WG_BKV / 16][4];
};

// The second half: s (the exponentials) split into p, and l = alpha l +
// the same p_hi + p_lo.  Runs while the last tile's P V is in flight, so
// it writes the other P buffer.
__device__ __forceinline__ void split_tile(const float (&s)[WG_BKV / 2],
                                           PFrag& p, float (&l_run)[2],
                                           const float (&alpha)[2]) {
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < WG_BKV / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = s[4 * j + 2 * r];
        const float p1 = s[4 * j + 2 * r + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        const float2 lf = __bfloat1622float2(lo);
        sum[r] += (hf.x + lf.x) + (hf.y + lf.y);
        p.hi[kk][2 * half + r] = bf162_bits(h);
        p.lo[kk][2 * half + r] = bf162_bits(lo);
      }
    }
  }
  l_run[0] = alpha[0] * l_run[0] + sum[0];
  l_run[1] = alpha[1] * l_run[1] + sum[1];
}

// O += P V with P = p_hi + p_lo from registers: 16 keys a k-step.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], PFrag& p,
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < WG_BKV / 16; ++kk) {
    const uint64_t d = dv + kk * ((16 * WG_ROW) >> 4);
    wgmma_pv(acc, p.lo[kk], d);
    wgmma_pv(acc, p.hi[kk], d);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_fwd_wg(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
            int seq_len, int group, float scale_log2, int causal,
            int window) {
  static_assert(D % 16 == 0 && D <= 128, "head dim: a multiple of 16, <= 128");
  constexpr int STAGES = wg_stages<D>();
  constexpr int TILE = wg_tile_bytes<D>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + TILE;
  unsigned char* sv = sk + STAGES * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * WG_BQ;

  // The keys some row of this block may see; tiles outside are never
  // loaded.
  const int q_last = min(q_start + WG_BQ, seq_len) - 1;
  const int k_lo = window > 0 ? max(0, q_start - window) : 0;
  const int k_hi = causal ? q_last : seq_len - 1;
  const int t_first = k_lo / WG_BKV;
  const int t_last = k_hi / WG_BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, 8);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int hk = hi / group;
      mbar_expect_tx(q_full, TILE);
      for (int c = 0; c < D / 16; ++c)
        tma_load(sq + c * WG_CHUNK, &qmap, q_full, 16 * c, q_start, hi, bi);
      int stage = 0, phase = 0;
      for (int tile = t_first; tile <= t_last; ++tile) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* kt = sk + stage * TILE;
        unsigned char* vt = sv + stage * TILE;
        mbar_expect_tx(k_full + stage, TILE);
        for (int c = 0; c < D / 16; ++c)
          tma_load(kt + c * WG_CHUNK, &kmap, k_full + stage, 16 * c,
                   tile * WG_BKV, hk, bi);
        mbar_expect_tx(v_full + stage, TILE);
        for (int c = 0; c < D / 16; ++c)
          tma_load(vt + c * WG_CHUNK, &vmap, v_full + stage, 16 * c,
                   tile * WG_BKV, hk, bi);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: warpgroup c takes rows 64 c .. 64 c + 63 of the block.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;           // fragment row within 8
    const int t = lane & 3;            // fragment column pair
    const int r0 = q_start + 64 * c;   // the warpgroup's rows r0 .. r0 + 63
    const int row0 = r0 + 16 * warp + g;  // this thread's: row0, row0 + 8

    // Q and K are K-major (8-row groups 256 bytes apart), V is MN-major
    // (16-column slices WG_CHUNK bytes apart, 8-key groups 256 apart).
    const uint64_t dq =
        smem_desc(smem_addr(sq) + c * 64 * WG_ROW, 16, 8 * WG_ROW);
    const uint64_t dk = smem_desc(smem_addr(sk), 16, 8 * WG_ROW);
    const uint64_t dv = smem_desc(smem_addr(sv), WG_CHUNK, 8 * WG_ROW);
    constexpr uint64_t TILE_U = TILE >> 4;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[WG_BKV / 2];
    PFrag pa, pb;                      // this tile's P and the last one's
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];

    int stage = 0, phase = 0;
    auto softmax = [&](int tile) {
      const int k0 = tile * WG_BKV;
      const bool edge = k0 + WG_BKV - 1 >= seq_len ||
                        (causal && k0 + WG_BKV - 1 > r0) ||
                        (window > 0 && k0 < r0 + 63 - window);
      softmax_tile(s, m_run, alpha, scale_log2, edge, k0, row0, t, seq_len,
                   causal, window);
    };
    // One tile: S of this tile and P V of the last one issued together,
    // then this tile's softmax and split into `next` while P V (reading
    // `last`) is in flight; after it, only O *= alpha.
    auto step = [&](int tile, PFrag& last, PFrag& next) {
      const int prev = stage;
      const int prev_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(k_full + stage, phase);
      hold(acc);
      hold(last.hi);
      hold(last.lo);
      wgmma_fence();
      issue_qk<D>(s, dq, dk + stage * TILE_U);
      mbar_wait(v_full + prev, prev_phase);
      issue_pv<D>(acc, last, dv + prev * TILE_U);
      wgmma_wait<1>();
      hold(s);
      softmax(tile);
      split_tile(s, next, l_run, alpha);
      wgmma_wait<0>();
      hold(acc);
      hold(last.hi);
      hold(last.lo);
      if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    };
    // The last tile's P V.
    auto finish = [&](PFrag& last) {
      mbar_wait(v_full + stage, phase);
      hold(acc);
      hold(last.hi);
      hold(last.lo);
      wgmma_fence();
      issue_pv<D>(acc, last, dv + stage * TILE_U);
      wgmma_wait<0>();
      hold(acc);
      hold(last.hi);
      hold(last.lo);
    };

    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<D>(s, dq, dk);
    wgmma_wait<0>();
    hold(s);
    softmax(t_first);
    split_tile(s, pa, l_run, alpha);   // O is still 0: no rescale
    // Two tiles a trip, so the pending P is in pa at the top of each.
    int tile = t_first + 1;
    for (; tile < t_last; tile += 2) {
      step(tile, pa, pb);
      step(tile + 1, pb, pa);
    }
    if (tile == t_last) {
      step(tile, pa, pb);
      finish(pb);
    } else {
      finish(pa);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    bf16* op =
        o + (static_cast<long long>(bi) * gridDim.y + hi) * seq_len * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= seq_len) continue;
      const float denom = l_run[r] == 0.f ? 1.f : l_run[r];  // masked -> 0
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(
            op + static_cast<long long>(row) * D + 8 * j + 2 * t) = pair;
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, fetched once through the
// runtime (the library links no libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// q, k or v as TMA sees it: (D, S, H, B) with the caller's strides, in
// boxes of 16 head-dim columns by WG_BKV rows of one head, 32-byte
// swizzled; rows past S read as zeros.
template <int D>
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                int seq_len, int heads, int batch, Strides st) {
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {16, WG_BKV, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* o,
              int batch, int heads_q, int group, int seq_len, Strides qs,
              Strides ks, Strides vs, float sm_scale, int causal, int window,
              cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -4;
  CUtensorMap qm, km, vm;
  const int heads_kv = heads_q / group;
  if (!encode_map<D>(encode, &qm, q, seq_len, heads_q, batch, qs) ||
      !encode_map<D>(encode, &km, k, seq_len, heads_kv, batch, ks) ||
      !encode_map<D>(encode, &vm, v, seq_len, heads_kv, batch, vs))
    return -5;
  constexpr int smem = wg_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + WG_BQ - 1) / WG_BQ, heads_q, batch);
  attn_fwd_wg<D><<<grid, WG_THREADS, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), seq_len, group, sm_scale * LOG2E,
      causal, window);
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
int launch(int dtype, int wgmma, const void* q, const void* k, const void* v,
           void* o, int batch, int heads_q, int group, int seq_len,
           Strides qs, Strides ks, Strides vs, float sm_scale, int causal,
           int window, cudaStream_t stream) {
  if (wgmma) {
    if constexpr (D == 64 || D == 80 || D == 128) {
      if (dtype == 1)
        return launch_wg<D>(q, k, v, o, batch, heads_q, group, seq_len, qs,
                            ks, vs, sm_scale, causal, window, stream);
    }
    return -3;
  }
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
// wgmma: 1 takes the bf16 wgmma + TMA kernel (the caller has checked that
// TMA can describe q, k and v: 16-byte aligned bases and strides), 0 the
// mma.sync or fp32 kernel.  Returns the cudaError_t of the launch (0 =
// success), -1 for a head dim that was not instantiated, -2 for an unknown
// dtype, -3 for wgmma at a head dim or dtype it does not take, -4 when the
// driver has no cuTensorMapEncodeTiled, -5 when it refuses a tensor map.
// Launches on `stream` and does not synchronise; `o` is allocated by the
// caller.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads_q, int heads_kv, int seq_len, int head_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float sm_scale, int causal, int window, int wgmma,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss};
  const Strides ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss};
  const int group = heads_q / heads_kv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, wgmma, q, k, v, o, batch, heads_q, group,
                        seq_len, qs, ks, vs, sm_scale, causal, window, st);
    case 64:
      return launch<64>(dtype, wgmma, q, k, v, o, batch, heads_q, group,
                        seq_len, qs, ks, vs, sm_scale, causal, window, st);
    case 80:
      return launch<80>(dtype, wgmma, q, k, v, o, batch, heads_q, group,
                        seq_len, qs, ks, vs, sm_scale, causal, window, st);
    case 128:
      return launch<128>(dtype, wgmma, q, k, v, o, batch, heads_q, group,
                         seq_len, qs, ks, vs, sm_scale, causal, window, st);
    case 256:
      return launch<256>(dtype, wgmma, q, k, v, o, batch, heads_q, group,
                         seq_len, qs, ks, vs, sm_scale, causal, window, st);
    default:
      return -1;
  }
}
