// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_kernel` (body `_kernel`)
// in src/repro/kernels/paged_attention/paged_attention.py: one decode step
// of attention for a batch of serving slots, reading the block pool
// (nb, bs, d_kv) directly through each slot's int32 block table.
//
// Semantics (held against ref.py): table entry -1 clamps to block 0;
// pool position t is live iff t < pos[b] and (window <= 0 or
// t >= pos[b] + 1 - window); the step's own K/V row is folded in iff
// pos[b] < mb*bs; int8 pools are dequantised with their per-row f32
// scales right after the load; the softmax is streamed with f32 state;
// the output is acc / max(l, 1e-30) in q's dtype.
//
// Bound: bytes. Each live K/V row is read once and used for `rep` query
// heads (2*rep*hd flops per 2*hd elements loaded), far below the card's
// ~295 flop/byte ridge, so the least time is the live K/V bytes over
// HBM bandwidth. At the main path's shapes (8 slots x ~1k tokens, 4 KV
// heads of 64) that is ~8 MB per layer, ~2.5 us. This first version is
// far from that bound: only B * n_kv blocks run (32 on 132 SMs), and each
// walks its slot's positions one tile after another, so its time follows
// the longest slot (PERF.md has the measurements). Splitting a slot's
// walk over several blocks and wider loads are the known next steps.
//
// Design: one thread block per (slot, kv_head), so each K/V row a block
// loads serves all `rep` query heads of its group (the TPU kernel's
// (n_kv, rep) head folding). The TPU walks the table as a sequential grid
// axis with (m, l, acc) carried in VMEM scratch; here the walk is a loop
// inside the block and the state lives in shared memory (m, l) and
// registers (acc). The loop covers only the live range [lo, hi) in tiles
// of 32 positions, so blocks wholly outside the window (and the tail past
// the cursor) are never read; every tile holds at least one live position,
// which keeps the running max finite. This first version loads scalars and
// does the dot products on CUDA cores in f32: right and simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // pool positions per iteration (one per lane)
// accumulators per thread: a (rep, hd) group of up to kThreads * kAcc
// outputs. Instances of 8 (rep*hd <= 1024) and 16 (<= 2048, e.g. 12 query
// heads of 128 per KV head) are built; the launch takes the smaller that fits.
// The 16-accumulator instance alone ran 1-10 % slower at tinyllama-1.1b's
// 8 x 64 group on an H100 (PERF.md), so the smaller one stays.
constexpr int kMaxAccLarge = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TKV, int kAcc>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,           // (B, H, hd)
    const TQ* __restrict__ k_new,       // (B, d_kv)
    const TQ* __restrict__ v_new,       // (B, d_kv)
    const TKV* __restrict__ k_pool,     // (nb, bs, d_kv)
    const TKV* __restrict__ v_pool,     // (nb, bs, d_kv)
    const float* __restrict__ k_scale,  // (nb, bs), int8 pools only
    const float* __restrict__ v_scale,
    const int* __restrict__ table,      // (B, mb)
    const int* __restrict__ pos,        // (B,)
    TQ* __restrict__ out,               // (B, H, hd)
    int n_kv, int rep, int hd, int bs, int mb, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d_kv = n_kv * hd;
  const int rows = rep * hd;  // this block's (rep, hd) output tile

  float* q_s = smem;                      // (rep, hd)
  float* k_s = q_s + rows;                // (kTile, hd + 1), padded: no bank conflicts
  float* v_s = k_s + kTile * (hd + 1);    // (kTile, hd)
  float* p_s = v_s + kTile * hd;          // (rep, kTile) scores, then probabilities
  float* m_s = p_s + rep * kTile;         // (rep,) running max
  float* l_s = m_s + rep;                 // (rep,) running sum
  float* a_s = l_s + rep;                 // (rep,) this tile's rescale factor

  const int pos_b = pos[b];
  const int total = mb * bs;
  int hi = min(pos_b, total);
  int lo = window > 0 ? max(0, pos_b + 1 - window) : 0;
  // No live position and no new row (window <= 1 at a full cursor): the
  // reference's softmax then sees only equal masked logits and averages
  // V over the whole view; walk the view with equal scores to match.
  const bool none_live = hi <= lo && pos_b >= total;
  if (none_live) {
    lo = 0;
    hi = total;
  }
  const size_t head0 = (static_cast<size_t>(b) * n_kv + kvh) * rows;  // q/out offset
  const size_t col0 = static_cast<size_t>(kvh) * hd;                  // pool column

  for (int i = tid; i < rows; i += kThreads) q_s[i] = to_f32(q[head0 + i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  const int* tbl = table + static_cast<size_t>(b) * mb;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    // K/V tile: each position chases its own table entry
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int tt = i / hd;
      const int d = i - tt * hd;
      const int t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < hi) {
        const int blk = max(tbl[t / bs], 0);
        const size_t row = static_cast<size_t>(blk) * bs + (t % bs);
        kv = to_f32(k_pool[row * d_kv + col0 + d]);
        vv = to_f32(v_pool[row * d_kv + col0 + d]);
        if (k_scale != nullptr) {
          kv *= k_scale[row];
          vv *= v_scale[row];
        }
      }
      k_s[tt * (hd + 1) + d] = kv;
      v_s[tt * hd + d] = vv;
    }
    __syncthreads();
    // scores s[r, tt] = q_r . k_tt * scale, length-masked past hi
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile;
      const int tt = i - r * kTile;
      float s = kNegInf;
      if (t0 + tt < hi) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + tt * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = none_live ? 0.f : dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head of the group
    for (int r = warp; r < rep; r += kWarps) {
      const float s = p_s[r * kTile + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[r * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc[r, d] = acc * alpha[r] + sum_tt p[r, tt] * v[tt, d]
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < rows) {
        const int r = i / hd;
        const int d = i - r * hd;
        const float* pr = p_s + r * kTile;
        float a = acc[j] * a_s[r];
        for (int tt = 0; tt < kTile; ++tt) a = fmaf(pr[tt], v_s[tt * hd + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  // fold in the step's own K/V row at position pos_b, only while the
  // cursor is inside the view (a full cache drops the new row); gate
  // p_new rather than rely on underflow
  if (pos_b < total) {
    const size_t new0 = static_cast<size_t>(b) * d_kv + col0;
    for (int r = warp; r < rep; r += kWarps) {
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(q_s[r * hd + d], to_f32(k_new[new0 + d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const float s_new = dot * scale;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, s_new);
        const float alpha = expf(m_prev - m_new);
        const float p_new = expf(s_new - m_new);
        a_s[r] = alpha;
        p_s[r] = p_new;
        l_s[r] = l_s[r] * alpha + p_new;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < rows) {
        const int r = i / hd;
        const int d = i - r * hd;
        acc[j] = acc[j] * a_s[r] + p_s[r] * to_f32(v_new[new0 + d]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < rows) store(out + head0 + i, acc[j] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* k_pool,
                   const void* v_pool, const void* k_scale, const void* v_scale,
                   const void* table, const void* pos, void* out, int B, int n_kv, int rep,
                   int hd, int bs, int mb, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(rep) * hd + kTile * (hd + 1) + kTile * hd + rep * kTile + 3 * rep);
  if (rep * hd > kThreads * kMaxAccLarge || smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(B, n_kv);
  auto kernel = rep * hd <= kThreads * 8 ? paged_decode_kernel<TQ, TKV, 8>
                                         : paged_decode_kernel<TQ, TKV, kMaxAccLarge>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new), static_cast<const TQ*>(v_new),
      static_cast<const TKV*>(k_pool), static_cast<const TKV*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<TQ*>(out),
      n_kv, rep, hd, bs, mb, window, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k_new, const void* v_new,
                      const void* k_pool, const void* v_pool, const void* k_scale,
                      const void* v_scale, const void* table, const void* pos, void* out,
                      int B, int n_kv, int rep, int hd, int bs, int mb, int window,
                      float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                               out, B, n_kv, rep, hd, bs, mb, window, scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                                       table, pos, out, B, n_kv, rep, hd, bs, mb, window,
                                       scale, stream);
    case 2:
      return launch<TQ, int8_t>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table,
                                pos, out, B, n_kv, rep, hd, bs, mb, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale, const void* table,
    const void* pos, void* out, int B, int n_kv, int rep, int hd, int bs, int mb,
    int window, float scale, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                              table, pos, out, B, n_kv, rep, hd, bs, mb, window, scale, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_new, v_new, k_pool, v_pool, k_scale,
                                      v_scale, table, pos, out, B, n_kv, rep, hd, bs, mb,
                                      window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
