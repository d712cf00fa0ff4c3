// Paged single-token GQA decode attention for Hopper (sm_90a), split-K
// (flash-decoding).
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
// heads (2*rep*hd flops per 2*hd elements loaded, ~2 flop per byte in
// bf16), far below the card's ~295 flop/byte ridge, so the least time is
// the live K/V bytes over HBM bandwidth: ~8 MB, ~2.5 us, per layer at
// tinyllama-1.1b's 8 slots of ~1k tokens; ~25 MB, ~7.5 us, at qwen2.5-3b's
// 2 slots of 15,000 and 9,500 tokens.
//
// Design. The kernel's first version ran one block per (slot, KV head) and
// walked the slot's whole live range in one block: 32 blocks on 132 SMs at
// tinyllama's shape and 4 at the long arm's, each a serial walk of scalar
// loads, 0.66 ms and ~10 ms a call. This one splits the walk:
//
// 1. `paged_split_kernel`, grid (n_splits, n_kv, B): split s of a
//    (slot, KV head) walks the positions [s*span, (s+1)*span) that are
//    live, in tiles of 32, and writes a partial (m, l, acc[rep, hd]) in
//    f32 (acc not yet divided by l). A split wholly outside its slot's
//    live range writes m = -inf, l = 0 and exits. `span` comes from the
//    host, from mb*bs and the batch alone (never from pos, which lives on
//    the device): the wrapper (`split_span`) picks it so that
//    B * n_kv * n_splits >= 2 * 132 blocks (two per SM), a multiple of the
//    block size, or of the 32-position tile where a block holds more
//    positions than that (the dense store's one-block-per-slot view).
//    Tried on an H100: no split (the first version, above); this split with a
//    two-stage ring and a combine of one block per (slot, KV head) looping
//    over every split (0.045 ms at tinyllama's case, 0.105 ms at the long
//    one); and the present three-stage ring with one combine block per
//    query head (0.034 and 0.049 ms; PERF.md).
// 2. `paged_combine_kernel`, grid (rep, n_kv, B): merges one query head's
//    splits by their maxima (thread d owns output column d), folds in the step's own K/V row (iff
//    pos < mb*bs, exactly as before), and divides by max(l, 1e-30). An
//    empty split weighs exactly 0 (no exp(-inf - -inf)). The combine is a
//    second launch, not the last split block found by an atomic counter:
//    it costs one more launch per layer (22 per tinyllama tick, against
//    ~1,540 there) and needs no counter to reset between calls, no
//    fence-and-count protocol and no per-slot serial tail inside the
//    split kernel.
//
// Inside a split block (128 threads): the block's pages are looked up
// once, into shared memory; each tile of 32 positions is copied with
// 16-byte `cp.async`s (8 bf16, 16 int8 or 4 f32 a thread a copy; int8
// scales as 4-byte copies) into a ring of three stages, two tiles ahead of
// the one computed; positions past the split's end are zero-filled. Dot
// products stay in f32 on CUDA cores (at ~2 flop per byte the tensor cores
// would idle): warp w takes query heads w, w+4, w+8, w+12 and lane i
// position i, reads its K row as 16-byte vectors (rows padded by 16 bytes:
// no bank conflicts) against q in f32 (a broadcast), and the online
// softmax of a head is a warp reduction. P.V: the head dim divides
// the block's 128 threads, so a thread owns one output column d of up to
// 8 or 16 heads, and one V load per position serves them all. int8 scales fold into the score (k) and into
// the probability (v). none_live (window <= 1 at a full cursor: no live
// position and no new row) walks the whole view with scores 0, so each
// split and hence the combine averages V with equal weights, as the
// reference's all-masked softmax does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // pool positions per tile (one per lane)
constexpr int kHeadsPerWarp = 4;  // query heads per warp: groups up to 16
constexpr int kMaxRep = kWarps * kHeadsPerWarp;
constexpr int kMaxAccLarge = 16;  // outputs per thread: groups up to 2048 outputs
constexpr int kStages = 3;        // tiles in flight: cp.async ring depth
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of a pool row -> 16 / sizeof(T) floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kPer = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int kPer = 16;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `ok` false zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The live range [lo, hi) of slot b, and whether it has no live position
// and no new row (then the whole view is walked with scores 0).
struct Live {
  int lo, hi;
  bool none_live;
};

__device__ __forceinline__ Live live_range(int pos_b, int total, int window) {
  Live r;
  r.hi = min(pos_b, total);
  r.lo = window > 0 ? max(0, pos_b + 1 - window) : 0;
  r.none_live = r.hi <= r.lo && pos_b >= total;
  if (r.none_live) {
    r.lo = 0;
    r.hi = total;
  }
  return r;
}

// shared memory of a split block, in bytes; the wrapper's `smem_bytes`
// mirrors it
__host__ __device__ __forceinline__ size_t row_bytes(int hd, int elt) {
  return static_cast<size_t>(hd) * elt + 16;
}

__host__ __device__ __forceinline__ size_t split_smem(int rep, int hd, int elt, int n_pages) {
  return 2 * kStages * kTile * row_bytes(hd, elt)             // stages x (K, V) tiles
         + 2 * kStages * kTile * sizeof(float)                // stages x (k, v) int8 scales
         + sizeof(float) * (static_cast<size_t>(rep) * hd + rep * kTile + rep)  // q, p, alpha
         + sizeof(int) * static_cast<size_t>(n_pages);
}

template <typename TQ, typename TKV, int kAcc>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q,           // (B, H, hd)
    const TKV* __restrict__ k_pool,     // (nb, bs, d_kv)
    const TKV* __restrict__ v_pool,     // (nb, bs, d_kv)
    const float* __restrict__ k_scale,  // (nb, bs), int8 pools only
    const float* __restrict__ v_scale,
    const int* __restrict__ table,      // (B, mb)
    const int* __restrict__ pos,        // (B,)
    float* __restrict__ part_acc,       // (B, n_kv, n_splits, rep, hd)
    float2* __restrict__ part_ml,       // (B, n_kv, n_splits, rep): (m, l)
    int n_kv, int rep, int hd, int bs, int mb, int window, float scale, int span) {
  using V = Vec<TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d_kv = n_kv * hd;
  const int rows = rep * hd;
  const int total = mb * bs;
  const size_t part = (static_cast<size_t>(b) * n_kv + kvh) * n_splits + split;

  const Live lv = live_range(pos[b], total, window);
  const int a = max(lv.lo, split * span);
  const int e = min(lv.hi, split * span + span);
  if (a >= e) {  // nothing live in this split: an empty partial
    for (int r = tid; r < rep; r += kThreads) part_ml[part * rep + r] = make_float2(-INFINITY, 0.f);
    return;
  }

  const int rb = static_cast<int>(row_bytes(hd, sizeof(TKV)));
  const int chunks = hd * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte chunks per row
  unsigned char* kv_s = smem;                                   // [stage][K|V][kTile][rb]
  float* sc_s = reinterpret_cast<float*>(kv_s + 2 * kStages * kTile * rb);  // [stage][k|v][kTile]
  float* q_s = sc_s + 2 * kStages * kTile;                        // (rep, hd)
  float* p_s = q_s + rows;                                        // (rep, kTile)
  float* a_s = p_s + rep * kTile;                                 // (rep,)
  int* pg_s = reinterpret_cast<int*>(a_s + rep);                  // the split's blocks

  const size_t head0 = (static_cast<size_t>(b) * n_kv + kvh) * rows;
  const int* tbl = table + static_cast<size_t>(b) * mb;
  const int first_page = a / bs;
  const int n_pages = (e - 1) / bs - first_page + 1;
  for (int i = tid; i < rows; i += kThreads) q_s[i] = to_f32(q[head0 + i]);
  for (int j = tid; j < n_pages; j += kThreads) pg_s[j] = max(tbl[first_page + j], 0);
  __syncthreads();

  const bool quantized = k_scale != nullptr;
  const size_t col0 = static_cast<size_t>(kvh) * hd;
  auto issue = [&](int tile) {
    const int stage = tile % kStages;
    const int t0 = a + tile * kTile;
    unsigned char* ks = kv_s + (2 * stage) * kTile * rb;
    unsigned char* vs = ks + kTile * rb;
    for (int i = tid; i < kTile * chunks; i += kThreads) {
      const int tt = i / chunks;
      const int c = i - tt * chunks;
      const int t = t0 + tt;
      const bool ok = t < e;
      const size_t row = ok ? static_cast<size_t>(pg_s[t / bs - first_page]) * bs + t % bs : 0;
      const size_t off = (row * d_kv + col0) * sizeof(TKV) + c * 16;
      cp_async16(ks + tt * rb + c * 16, reinterpret_cast<const unsigned char*>(k_pool) + off, ok);
      cp_async16(vs + tt * rb + c * 16, reinterpret_cast<const unsigned char*>(v_pool) + off, ok);
    }
    if (quantized) {
      for (int tt = tid; tt < kTile; tt += kThreads) {
        const int t = t0 + tt;
        const bool ok = t < e;
        const size_t row = ok ? static_cast<size_t>(pg_s[t / bs - first_page]) * bs + t % bs : 0;
        cp_async4(sc_s + (2 * stage) * kTile + tt, k_scale + row, ok);
        cp_async4(sc_s + (2 * stage + 1) * kTile + tt, v_scale + row, ok);
      }
    }
  };

  float m[kHeadsPerWarp], l[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
  // P.V outputs: hd divides the block, so this thread's outputs share one
  // column d and take heads r0, r0 + kThreads / hd, ...
  const int d_out = tid % hd;
  const int r_out = tid / hd;
  const int r_step = kThreads / hd;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  const int n_tiles = (e - a + kTile - 1) / kTile;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; every reader of tile it - 1 is done
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);  // into tile it - 1's stage
    cp_async_commit();
    const int stage = it % kStages;
    const unsigned char* ks = kv_s + (2 * stage) * kTile * rb;
    const unsigned char* vs = ks + kTile * rb;
    const bool valid = a + it * kTile + lane < e;

    // scores of this lane's position against the warp's query heads
    float dot[kHeadsPerWarp];
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) dot[j] = 0.f;
    const unsigned char* krow = ks + lane * rb;
    for (int c = 0; c < chunks; ++c) {
      float kf[V::kPer];
      V::unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int r = warp + kWarps * j;
        if (r < rep) {
          const float4* qr = reinterpret_cast<const float4*>(q_s + r * hd + c * V::kPer);
#pragma unroll
          for (int x = 0; x < V::kPer / 4; ++x) {
            const float4 qq = qr[x];
            dot[j] = fmaf(qq.x, kf[4 * x], dot[j]);
            dot[j] = fmaf(qq.y, kf[4 * x + 1], dot[j]);
            dot[j] = fmaf(qq.z, kf[4 * x + 2], dot[j]);
            dot[j] = fmaf(qq.w, kf[4 * x + 3], dot[j]);
          }
        }
      }
    }
    const float kscale = quantized ? sc_s[(2 * stage) * kTile + lane] : 1.f;
    const float vscale = quantized ? sc_s[(2 * stage + 1) * kTile + lane] : 1.f;
    // online softmax of each of the warp's heads over the tile's 32 lanes
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      if (r < rep) {
        const float s = valid ? (lv.none_live ? 0.f : dot[j] * kscale * scale) : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[j] - m_new);
        l[j] = l[j] * alpha + warp_sum(p);
        m[j] = m_new;
        p_s[r * kTile + lane] = p * vscale;
        if (lane == 0) a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc[r, d] = acc * alpha[r] + sum_tt p[r, tt] * v[tt, d]: one V load
    // per position serves all of this thread's heads
    const TKV* vt = reinterpret_cast<const TKV*>(vs) + d_out;
    const int vstride = rb / static_cast<int>(sizeof(TKV));
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int r = r_out + j * r_step;
      if (r < rep) acc[j] *= a_s[r];
    }
#pragma unroll
    for (int tt = 0; tt < kTile; tt += 4) {
      float v4[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) v4[x] = to_f32(vt[(tt + x) * vstride]);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int r = r_out + j * r_step;
        if (r < rep) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * kTile + tt);
          acc[j] = fmaf(p4.x, v4[0], acc[j]);
          acc[j] = fmaf(p4.y, v4[1], acc[j]);
          acc[j] = fmaf(p4.z, v4[2], acc[j]);
          acc[j] = fmaf(p4.w, v4[3], acc[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = r_out + j * r_step;
    if (r < rep) part_acc[part * rows + r * hd + d_out] = acc[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      if (r < rep) part_ml[part * rep + r] = make_float2(m[j], l[j]);
    }
  }
}

// sum over a block's 4 warps, every thread gets the result; `red` holds
// kWarps floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// One block per (query head of the group, KV head, slot): merge the
// splits of that head, fold in the new row, divide. Thread d owns output
// column d.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const TQ* __restrict__ q,        // (B, H, hd)
    const TQ* __restrict__ k_new,    // (B, d_kv)
    const TQ* __restrict__ v_new,    // (B, d_kv)
    const int* __restrict__ pos,     // (B,)
    const float* __restrict__ part_acc,
    const float2* __restrict__ part_ml,
    TQ* __restrict__ out,            // (B, H, hd)
    int n_kv, int rep, int hd, int total, float scale, int n_splits) {
  extern __shared__ float w_s[];  // (n_splits,) weights, then kWarps for reductions
  float* red = w_s + n_splits;
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int d_kv = n_kv * hd;
  const int rows = rep * hd;
  const size_t part0 = (static_cast<size_t>(b) * n_kv + kvh) * n_splits;
  const size_t qrow = (static_cast<size_t>(b) * n_kv + kvh) * rows + static_cast<size_t>(r) * hd;
  const size_t new0 = static_cast<size_t>(b) * d_kv + static_cast<size_t>(kvh) * hd;
  // the step's own row, only while the cursor is inside the view (a full
  // cache drops it); p_new is gated rather than left to underflow
  const bool fold = pos[b] < total;

  float s_new = -INFINITY;
  if (fold) {
    float dot = 0.f;
    for (int d = tid; d < hd; d += kThreads) dot = fmaf(to_f32(q[qrow + d]), to_f32(k_new[new0 + d]), dot);
    s_new = block_sum(dot, red) * scale;
  }
  float mx = s_new;
  for (int s = tid; s < n_splits; s += kThreads) mx = fmaxf(mx, part_ml[(part0 + s) * rep + r].x);
  mx = block_max(mx, red);
  float lsum = 0.f;
  for (int s = tid; s < n_splits; s += kThreads) {
    const float2 ml = part_ml[(part0 + s) * rep + r];
    const float w = ml.x == -INFINITY ? 0.f : expf(ml.x - mx);  // empty split: exactly 0
    w_s[s] = w;
    lsum += w * ml.y;
  }
  const float pn = fold ? expf(s_new - mx) : 0.f;
  const float l_tot = block_sum(lsum, red) + pn;  // its barrier also publishes w_s
  const float* pa = part_acc + part0 * rows + static_cast<size_t>(r) * hd;
  for (int d = tid; d < hd; d += kThreads) {
    float x[4] = {fold ? pn * to_f32(v_new[new0 + d]) : 0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 4 <= n_splits; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float w = w_s[s + u];
        if (w != 0.f) x[u] = fmaf(w, pa[static_cast<size_t>(s + u) * rows + d], x[u]);
      }
    }
    for (; s < n_splits; ++s) {
      const float w = w_s[s];
      if (w != 0.f) x[0] = fmaf(w, pa[static_cast<size_t>(s) * rows + d], x[0]);
    }
    store(out + qrow + d, ((x[0] + x[1]) + (x[2] + x[3])) / fmaxf(l_tot, 1e-30f));
  }
}

struct Args {
  const void *q, *k_new, *v_new, *k_pool, *v_pool, *k_scale, *v_scale, *table, *pos;
  void* out;
  float* part_acc;
  float2* part_ml;
  int B, n_kv, rep, hd, bs, mb, window, span;
  float scale;
  cudaStream_t stream;
};

// opt in above 48 KB of dynamic shared memory, once per kernel instance
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc == cudaSuccess) granted = bytes;
  return rc;
}

template <typename TQ, typename TKV, int kAcc>
cudaError_t launch_split(const Args& g, int n_splits, size_t smem) {
  static size_t granted = 48 * 1024;
  auto kernel = paged_split_kernel<TQ, TKV, kAcc>;
  const cudaError_t rc = allow_smem(kernel, smem, granted);
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3(n_splits, g.n_kv, g.B), kThreads, smem, g.stream>>>(
      static_cast<const TQ*>(g.q), static_cast<const TKV*>(g.k_pool),
      static_cast<const TKV*>(g.v_pool), static_cast<const float*>(g.k_scale),
      static_cast<const float*>(g.v_scale), static_cast<const int*>(g.table),
      static_cast<const int*>(g.pos), g.part_acc, g.part_ml, g.n_kv, g.rep, g.hd, g.bs, g.mb,
      g.window, g.scale, g.span);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const Args& g) {
  const int total = g.mb * g.bs;
  const int n_splits = (total + g.span - 1) / g.span;
  const int elt = static_cast<int>(sizeof(TKV));
  const int n_pages = (g.span + g.bs - 1) / g.bs + 1;
  const size_t smem = split_smem(g.rep, g.hd, elt, n_pages);
  if (g.rep > kMaxRep || g.rep * g.hd > kThreads * kMaxAccLarge || (g.hd * elt) % 16 != 0 ||
      kThreads % g.hd != 0 || smem > 227 * 1024 || g.span <= 0)
    return cudaErrorInvalidValue;
  const cudaError_t rc = g.rep * g.hd <= kThreads * 8
                             ? launch_split<TQ, TKV, 8>(g, n_splits, smem)
                             : launch_split<TQ, TKV, kMaxAccLarge>(g, n_splits, smem);
  if (rc != cudaSuccess) return rc;
  const size_t csmem = sizeof(float) * (static_cast<size_t>(n_splits) + kWarps);
  static size_t granted = 48 * 1024;
  const cudaError_t rc2 = allow_smem(paged_combine_kernel<TQ>, csmem, granted);
  if (rc2 != cudaSuccess) return rc2;
  paged_combine_kernel<TQ><<<dim3(g.rep, g.n_kv, g.B), kThreads, csmem, g.stream>>>(
      static_cast<const TQ*>(g.q), static_cast<const TQ*>(g.k_new),
      static_cast<const TQ*>(g.v_new), static_cast<const int*>(g.pos), g.part_acc, g.part_ml,
      static_cast<TQ*>(g.out), g.n_kv, g.rep, g.hd, total, g.scale, n_splits);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const Args& g) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(g);
    case 1: return launch<TQ, __nv_bfloat16>(g);
    case 2: return launch<TQ, int8_t>(g);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// part_acc: (B, n_kv, ceil(mb*bs / span), rep, hd) f32 scratch; part_ml:
// (B, n_kv, ceil(mb*bs / span), rep, 2) f32 scratch.
// Returns cudaGetLastError() after the two launches (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale, const void* table,
    const void* pos, void* out, void* part_acc, void* part_ml, int B, int n_kv, int rep,
    int hd, int bs, int mb, int window, int span, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (B == 0) return 0;
  Args g{q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos, out,
         static_cast<float*>(part_acc), static_cast<float2*>(part_ml),
         B, n_kv, rep, hd, bs, mb, window, span, scale, static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, g);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, g);
    default: return cudaErrorInvalidValue;
  }
}
