// Fused causal / sliding-window GQA attention for Hopper (sm_90a): the
// prefill attention of the dense LM on the card.
//
// Replaces the TPU kernel `flash_attention` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py, and computes what
// it computes: q (B, H, Sq, d), k and v (B, Kv, Sk, d); query head h reads
// KV head h / (H / Kv); positions are start-aligned, and a (q, k) pair is
// live iff q < Sq, k < Sk, q >= k when causal, and q - k < window when
// window > 0; scores are f32 dot products times `scale`; the softmax is
// streamed with f32 (m, l, acc); the output is acc / max(l, 1e-30) in q's
// dtype. Every operand is read through (batch, head, sequence) strides
// with a contiguous head dim, so the model layout (B, S, H, d) needs no
// transpose.
//
// Bound: operations. A query row of a causal prefill at position p does
// 4 * d * (p + 1) flops against 2 * d elements in and out, so at prompt
// lengths in the thousands the work is hundreds of flops per byte, above
// the card's ridge. The least time is the live pairs' flops over the
// tensor-core peak; neither body below is near it yet (PERF.md).
//
// Design: one thread block per (query tile, KV head, batch row). A tile
// is 64 consecutive rows of the flattened (query position, group head)
// index, so the `rep` query heads that share a KV head are served by one
// block and each K/V tile staged in shared memory is loaded once for the
// whole group (the TPU kernel folds the group in its KV index map and
// reloads the tile per query head). The TPU walks the KV blocks as a
// sequential grid axis with (m, l, acc) in VMEM scratch; here the walk is
// a loop inside the block over 64-key tiles with the state in registers.
// The loop covers only keys [lo, hi): from the first key the window
// reaches for the tile's first row to the causal diagonal of its last
// row, which halves causal work and bounds windowed work. Masks are still
// applied per pair inside that range, so the range changes no row below
// Sq. A row whose first visited tile is wholly masked sees p = exp(0)
// there, as the Pallas body does, and its first live tile rescales that
// by exp(-1e30 - m) = 0: the same result as skipping it. Blocks run the
// latest query tiles first, since causal work grows with position.
//
// Two bodies share that design:
// - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), four warps of 16 rows each. Q's fragments stay in
//   registers for the whole walk; each score tile's accumulator layout is
//   reused as the A operand of P.V after rounding P to bf16, as the
//   model's plain prefill rounds its probabilities; row maxima and sums
//   reduce across the 4 lanes that share a row. K is staged row-major and
//   V transposed, both padded so the fragment loads hit 32 distinct banks;
//   aligned operands move 16 bytes a load. No cp.async, TMA or wgmma yet.
// - f32: CUDA cores, exact f32 throughout, a 16 x 16 thread grid with
//   each thread owning 4 rows and a 4 x 4 slice of each score tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // flattened (position, group head) rows per block
constexpr int kKeys = 64;  // key positions per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the head dim is contiguous
};

// The tile a block owns and the key range [lo, hi) it walks.
struct Tile {
  int g0, n_rows, lo, hi;
};

__device__ __forceinline__ Tile tile_of(int rep, int sq, int sk, int causal, int window) {
  Tile t;
  t.n_rows = sq * rep;
  t.g0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // latest tiles first
  const int p_first = t.g0 / rep;
  const int p_last = (min(t.g0 + kRows, t.n_rows) - 1) / rep;
  t.hi = causal ? min(sk, p_last + 1) : sk;
  t.lo = window > 0 ? max(0, p_first - window + 1) : 0;
  return t;
}

__device__ __forceinline__ bool live(bool row_live, int pos, int t, int sk, int causal,
                                     int window) {
  const int dist = pos - t;
  return row_live && t < sk && (!causal || dist >= 0) && (window <= 0 || dist < window);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // a 16 x 16 grid
constexpr int kPerThread = 4;     // rows (and score columns) per thread: 64 / 16

// reductions over the 16 lanes of a half-warp (one row's score columns)
__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * (HD + 1) + kKeys * (HD + 1) +
                          kKeys * HD + kRows * (kKeys + 1));
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 2) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int rep, int sq,
    int sk, int causal, int window, float scale) {
  constexpr int kStride = HD + 1;  // padded rows: conflict-free column walks
  constexpr int kPStride = kKeys + 1;
  constexpr int kCols = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // (kRows, HD + 1)
  float* k_s = q_s + kRows * kStride;  // (kKeys, HD + 1)
  float* v_s = k_s + kKeys * kStride;  // (kKeys, HD)
  float* p_s = v_s + kKeys * HD;       // (kRows, kKeys + 1) probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score column / output column group
  const int ty = tid >> 4;  // row group: rows ty + 16 * i
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Tile tl = tile_of(rep, sq, sk, causal, window);

  const float* qb = q + b * qs.b;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kRows * HD; i += kF32Threads) {
    const int r = i / HD;
    const int d = i % HD;
    const int g = tl.g0 + r;
    float x = 0.f;
    if (g < tl.n_rows) {
      const int p = g / rep;
      const int h = kvh * rep + (g - p * rep);
      x = qb[h * qs.h + p * qs.s + d];
    }
    q_s[r * kStride + d] = x;
  }

  int qpos[kPerThread];
  bool qlive[kPerThread];
  float m[kPerThread], l[kPerThread], acc[kPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int g = tl.g0 + ty + 16 * i;
    qlive[i] = g < tl.n_rows;
    qpos[i] = g / rep;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t0 = tl.lo; t0 < tl.hi; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done (and q_s is in)
    for (int i = tid; i < kKeys * HD; i += kF32Threads) {
      const int c = i / HD;
      const int d = i % HD;
      const int t = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < tl.hi) {
        kx = kb[t * ks.s + d];
        vx = vb[t * vs.s + d];
      }
      k_s[c * kStride + d] = kx;
      v_s[c * HD + d] = vx;
    }
    __syncthreads();

    // scores s[i][j] = q_row(ty + 16i) . k_key(tx + 16j)
    float s[kPerThread][kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kPerThread], bk[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) a[i] = q_s[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) bk[j] = k_s[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, then the online softmax of each row across its 16 lanes
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int t = t0 + tx + 16 * j;
        s[i][j] = live(qlive[i], qpos[i], t, sk, causal, window) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][j] += sum_c p[row i][c] * v[c][tx + 16j]
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float pr[kPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) pr[i] = p_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (!qlive[i]) continue;
    const int g = tl.g0 + ty + 16 * i;
    const int h = kvh * rep + (g - qpos[i] * rep);
    float* orow = o + b * os.b + h * os.h + qpos[i] * os.s;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync.m16n8k16 with f32 accumulators
// ---------------------------------------------------------------------------
//
// Fragments (PTX ISA, m16n8k16 with .bf16): lane = 4 * group + quad.
//   A (16 x 16, row-major): a0 = (row group,     cols 2quad, 2quad+1)
//                           a1 = (row group + 8, cols 2quad, 2quad+1)
//                           a2, a3 = the same rows at cols + 8
//   B (16 x 8, k-major):    b0 = (k 2quad, 2quad+1; n group), b1 = k + 8
//   C (16 x 8, f32):        c0, c1 = (row group, cols 2quad, 2quad+1)
//                           c2, c3 = (row group + 8, the same cols)

constexpr int kBf16Threads = 128;  // four warps of 16 rows
constexpr int kVtStride = kKeys + 8;  // bf16 per row of the transposed V tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 consecutive bf16 as 16 bytes: one load when the operand is 16-byte
// aligned (`vec`), else eight.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = h[2 * j] | (static_cast<uint32_t>(h[2 * j + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// max and sum over the 4 lanes of a quad (one fragment row's columns)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kRows) * (HD + 8) + kKeys * (HD + 8) + HD * kVtStride);
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides qs,
    Strides ks, Strides vs, Strides os, int rep, int sq, int sk, int causal, int window,
    float scale, int vec) {
  constexpr int kStride = HD + 8;  // bf16 per q_s / k_s row: fragment loads hit 32 banks
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kSteps = HD / 16;  // k-steps of Q.K^T
  constexpr int kOutTiles = HD / 8;
  constexpr int kKeyTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kRows, HD + 8)
  __nv_bfloat16* k_s = q_s + kRows * kStride;                        // (kKeys, HD + 8)
  unsigned short* vt_s = reinterpret_cast<unsigned short*>(k_s + kKeys * kStride);  // (HD, kKeys + 8)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = lane >> 2;
  const int quad = lane & 3;
  const int r0 = (tid >> 5) * 16 + group;  // this lane's fragment rows: r0, r0 + 8
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Tile tl = tile_of(rep, sq, sk, causal, window);

  const __nv_bfloat16* qb = q + b * qs.b;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kRows * kChunks; i += kBf16Threads) {
    const int r = i / kChunks;
    const int dc = i % kChunks;
    const int g = tl.g0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (g < tl.n_rows) {
      const int p = g / rep;
      const int h = kvh * rep + (g - p * rep);
      x = load8(qb + h * qs.h + p * qs.s + dc * 8, vec);
    }
    *reinterpret_cast<uint4*>(q_s + r * kStride + dc * 8) = x;
  }
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* p0 = q_s + r0 * kStride + kk * 16 + 2 * quad;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    qa[kk][0] = ld32(p0);
    qa[kk][1] = ld32(p1);
    qa[kk][2] = ld32(p0 + 8);
    qa[kk][3] = ld32(p1 + 8);
  }

  int pos[2];
  bool row_live[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = tl.g0 + r0 + 8 * i;
    row_live[i] = g < tl.n_rows;
    pos[i] = g / rep;
    m[i] = -INFINITY;
    l[i] = 0.f;  // this lane's share of the row sum; the quad's sum at the end
  }
  float acc[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  for (int t0 = tl.lo; t0 < tl.hi; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * kChunks; i += kBf16Threads) {  // K, row-major
      const int c = i / kChunks;
      const int dc = i % kChunks;
      const int t = t0 + c;
      const uint4 x = t < tl.hi ? load8(kb + t * ks.s + dc * 8, vec) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(k_s + c * kStride + dc * 8) = x;
    }
    // V, transposed; consecutive lanes take consecutive keys, so the
    // 2-byte stores of a warp fall in 16 distinct words
    for (int i = tid; i < kKeys * kChunks; i += kBf16Threads) {
      const int c = i % kKeys;
      const int dc = i / kKeys;
      const int t = t0 + c;
      const uint4 x = t < tl.hi ? load8(vb + t * vs.s + dc * 8, vec) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vt_s[(dc * 8 + j) * kVtStride + c] = static_cast<unsigned short>(w[j / 2] >> (16 * (j % 2)));
    }
    __syncthreads();

    // scores: s[nt] is the 16 x 8 tile of keys t0 + 8nt ..
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        const __nv_bfloat16* kp = k_s + (nt * 8 + group) * kStride + kk * 16 + 2 * quad;
        mma_bf16(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }

    // mask, then the online softmax of the lane's two rows
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j / 2;
        const int t = t0 + nt * 8 + 2 * quad + (j % 2);
        s[nt][j] = live(row_live[i], pos[i], t, sk, causal, window) ? s[nt][j] * scale : kNegInf;
        mx[i] = fmaxf(mx[i], s[nt][j]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nt][j] = expf(s[nt][j] - m[j / 2]);
        l[j / 2] += s[nt][j];
      }
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] *= alpha[j / 2];

    // acc += P.V with P rounded to bf16: key tiles 2kk and 2kk+1 form the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < kOutTiles; ++nt) {
        const unsigned short* vp = vt_s + (nt * 8 + group) * kVtStride + kk * 16 + 2 * quad;
        mma_bf16(acc[nt], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    if (!row_live[i]) continue;
    const int g = tl.g0 + r0 + 8 * i;
    const int h = kvh * rep + (g - pos[i] * rep);
    __nv_bfloat16* orow = o + b * os.b + h * os.h + pos[i] * os.s;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      orow[nt * 8 + 2 * quad] = __float2bfloat16(acc[nt][2 * i] / denom);
      orow[nt * 8 + 2 * quad + 1] = __float2bfloat16(acc[nt][2 * i + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, n_kv, rep, sq, sk;
  Strides qs, ks, vs, os;
  int causal, window;
  float scale;
  int vec;
  cudaStream_t stream;
};

// opt in above 48 KB of dynamic shared memory, once per kernel instance
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = rc == cudaSuccess;
  return rc;
}

template <int HD>
cudaError_t launch(const Args& a, int dtype) {
  const dim3 grid((a.sq * a.rep + kRows - 1) / kRows, a.n_kv, a.B);
  if (dtype == 0) {
    static bool ready = false;
    const size_t smem = f32_smem_bytes<HD>();
    const cudaError_t rc = allow_smem(flash_f32_kernel<HD>, smem, ready);
    if (rc != cudaSuccess) return rc;
    flash_f32_kernel<HD><<<grid, kF32Threads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks, a.vs, a.os,
        a.rep, a.sq, a.sk, a.causal, a.window, a.scale);
  } else {
    static bool ready = false;
    const size_t smem = bf16_smem_bytes<HD>();
    const cudaError_t rc = allow_smem(flash_bf16_kernel<HD>, smem, ready);
    if (rc != cudaSuccess) return rc;
    flash_bf16_kernel<HD><<<grid, kBf16Threads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.qs, a.ks,
        a.vs, a.os, a.rep, a.sq, a.sk, a.causal, a.window, a.scale, a.vec);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.s % 8 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// Strides are in elements, in (batch, head, sequence) order.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int n_kv, int sq,
    int sk, int hd, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B == 0 || sq == 0 || H == 0) return 0;
  if (n_kv <= 0 || H % n_kv != 0 || sk <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, B, n_kv, H / n_kv, sq, sk,
         Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss},
         Strides{o_sb, o_sh, o_ss}, causal, window, scale, 0,
         static_cast<cudaStream_t>(stream)};
  a.vec = aligned16(q, a.qs) && aligned16(k, a.ks) && aligned16(v, a.vs);
  switch (hd) {
    case 16: return launch<16>(a, dtype);
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 128: return launch<128>(a, dtype);
    default: return cudaErrorInvalidValue;
  }
}
