// Forward flash attention for Hopper (sm_90a): causal, sliding-window and
// GQA masks, online softmax in fp32.
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
//
// What this design does about it, and what it leaves for later: it keeps all
// arithmetic in fp32 on the CUDA cores (fp32 FMA, 67 TFLOP/s peak), which
// holds fp32 inputs to the reference's 5e-5 and gives bf16 inputs the
// reference's own upcast numerics, and it keeps the FMA units fed from
// shared memory rather than device memory:
//   * one block = 64 query rows, two threads per row; each thread keeps half
//     of its row's q and of its accumulator in registers (D/2 floats each),
//     interleaved in 4-wide pieces so that the two threads of a pair read
//     neighbouring 16-byte words of a K/V row (no bank conflict, and every
//     other lane of the warp reads the same words: shared-memory broadcast);
//   * a loop over 32-key tiles of K and V in shared memory replaces the TPU
//     grid's sequential kv axis; the tile's 32 scores stay in registers and a
//     32-bit mask records which of them are live;
//   * the two half dot products meet through one warp shuffle.
// It does not use the tensor cores.  wgmma with TMA-fed, double-buffered
// tiles (and bf16 P for the second product) is the way to the 989 TFLOP/s
// bf16 rate and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;            // query rows per block
constexpr int BLOCK_KV = 32;           // keys per shared-memory tile (= bits of the live mask)
constexpr int THREADS = 2 * BLOCK_Q;   // two threads per query row
constexpr float NEG_INF = -1e30f;      // the TPU kernel's NEG_INF

struct Strides {
  long long b, h, s;                   // in elements; the head dim has stride 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);          // round to nearest even, as astype does
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, int seq_len, int group,
         Strides qs, Strides ks, Strides vs, float sm_scale, int causal,
         int window) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int HALF = D / 2;          // dims owned by one thread
  constexpr int PIECES = D / 8;        // thread `half` owns dims [8c + 4*half, 8c + 4*half + 4)

  __shared__ __align__(16) float k_tile[BLOCK_KV * D];
  __shared__ __align__(16) float v_tile[BLOCK_KV * D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q_start = blockIdx.x * BLOCK_Q;
  const int qpos = q_start + (tid >> 1);

  const T* qp = q + bi * qs.b + hi * qs.h;
  const T* kp = k + bi * ks.b + (hi / group) * ks.h;
  const T* vp = v + bi * vs.b + (hi / group) * vs.h;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < PIECES; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * c + 4 * half + e;
      qr[4 * c + e] = qpos < seq_len ? to_float(qp[qpos * qs.s + d]) : 0.f;
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
      k_tile[idx] = in ? to_float(kp[key * ks.s + d]) : 0.f;
      v_tile[idx] = in ? to_float(vp[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[BLOCK_KV];
    unsigned live = 0u;
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const float* kr = k_tile + j * D + 4 * half;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < PIECES; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + 8 * c);
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
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
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const float* vr = v_tile + j * D + 4 * half;
#pragma unroll
      for (int c = 0; c < PIECES; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 8 * c);
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
    T* op = o + ((static_cast<long long>(bi) * gridDim.y + hi) * seq_len + qpos) * D;
#pragma unroll
    for (int c = 0; c < PIECES; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        op[8 * c + 4 * half + e] = from_float<T>(acc[4 * c + e] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads_q, int group, int seq_len, Strides qs, Strides ks,
           Strides vs, float sm_scale, int causal, int window,
           cudaStream_t stream) {
  const dim3 grid((seq_len + BLOCK_Q - 1) / BLOCK_Q, heads_q, batch);
  attn_fwd<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, group, qs, ks,
      vs, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                    void* o, int batch, int heads_q, int group, int seq_len,
                    Strides qs, Strides ks, Strides vs, float sm_scale,
                    int causal, int window, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, batch, heads_q, group, seq_len, qs, ks,
                           vs, sm_scale, causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, batch, heads_q, group, seq_len, qs, ks,
                           vs, sm_scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, heads_q, group, seq_len, qs,
                            ks, vs, sm_scale, causal, window, stream);
    default:
      return -1;
  }
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
  if (dtype == 0) {
    return launch_head_dim<float>(head_dim, q, k, v, o, batch, heads_q, group,
                                  seq_len, qs, ks, vs, sm_scale, causal,
                                  window, st);
  }
  if (dtype == 1) {
    return launch_head_dim<__nv_bfloat16>(head_dim, q, k, v, o, batch,
                                          heads_q, group, seq_len, qs, ks, vs,
                                          sm_scale, causal, window, st);
  }
  return -2;
}
