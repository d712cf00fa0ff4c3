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
// tensor-core peak: 2.22 ms at qwen2.5-3b's (2, 16384), where this kernel
// takes ~3.5 ms (PERF.md has the measurements).
//
// Design: one thread block per (query tile, KV head, batch row). A tile
// is consecutive rows of the flattened (query position, group head)
// index, so the `rep` query heads that share a KV head are served by one
// block and each K/V tile staged in shared memory is loaded once for the
// whole group (the TPU kernel folds the group in its KV index map and
// reloads the tile per query head). The TPU walks the KV blocks as a
// sequential grid axis with (m, l, acc) in VMEM scratch; here the walk is
// a loop inside the block over key tiles with the state in registers.
// The loop covers only keys [lo, hi): from the first key the window
// reaches for the tile's first row to the causal diagonal of its last
// row, which halves causal work and bounds windowed work; the masks
// still decide each pair inside that range. Blocks run the latest query
// tiles first, since causal work grows with position.
//
// Three bodies share that design:
// - bf16 at head dims 64 and 128 (every served model): the Hopper body
//   below, 128-row tiles on two consumer warpgroups of 64 rows and one
//   producer warp, 128-key K/V tiles in a ring of TMA loads, S = Q K^T and
//   O += P V by wgmma (P from registers, V through the transposed-B mode,
//   so V is never transposed in memory), the softmax in exp2 with the
//   scale folded in, and the mask only on the tiles that touch the
//   diagonal, the window's edge or Sk's end. It replaced an mma.sync body
//   of 64-row tiles whose loads and MMAs never overlapped: 125 TFLOP/s,
//   17.1 ms at (2, 16384), against ~3.5 ms now.
// - bf16 at head dims 16 and 32: tensor cores through mma.sync.m16n8k16
//   (bf16 in, f32 accumulate), four warps of 16 rows each, 64-row and
//   64-key tiles. Q's fragments stay in registers for the whole walk;
//   each score tile's accumulator layout is reused as the A operand of
//   P.V after rounding P to bf16; row maxima and sums reduce across the 4
//   lanes that share a row. K is staged row-major and V transposed, both
//   padded so the fragment loads hit 32 distinct banks; aligned operands
//   move 16 bytes a load.
// - f32: CUDA cores, exact f32 throughout, a 16 x 16 thread grid with
//   each thread owning 4 rows and a 4 x 4 slice of each 64 x 64 score
//   tile.
// The two bf16 bodies round P to bf16 for the tensor cores (the plain
// prefill rounds its probabilities too); all three divide by
// max(l, 1e-30) at the end.

#include <cuda.h>
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
// bf16 at head dims 64 and 128: TMA, wgmma and a warp-specialised pipeline
// ---------------------------------------------------------------------------
//
// 384 threads: warpgroups 0 and 1 consume (64 rows of the block's 128
// each), warpgroup 2 produces (one thread issues every TMA load; the
// warpgroup gives its registers to the consumers with setmaxnreg). The
// producer walks the block's key range [lo, hi) in 128-key tiles and
// keeps them in a ring of kStages stages of shared memory (K and V, each
// HD / 64 boxes of 128 keys x 64 d, 128-byte swizzled by the TMA unit);
// a `full` mbarrier per stage counts the bytes in, an `empty` one counts
// the 256 consumer threads out. Keys past Sk come in as zeros.
//
// A consumer warpgroup per tile: S = Q K^T by wgmma.m64n128k16 with Q
// (stored once, by its own 16-byte loads, in the same swizzled layout) and
// K from shared memory; the mask only on tiles that touch the causal
// diagonal, the window's edge or Sk's end (interior tiles skip it); the
// online softmax with exp2 and scale * log2(e) folded into the scores; P
// rounded to bf16 straight from the score accumulator into wgmma's A
// fragments; O += P V by wgmma with A from registers and V (keys x d,
// d contiguous) read through the transposed-B mode, so V is never
// transposed in memory. Inside a warpgroup, P V of one tile and S of the
// next are in flight together.

constexpr int kWgRows = 128;   // rows per block: two consumer warpgroups of 64
constexpr int kWgKeys = 128;   // keys per tile
constexpr int kWgThreads = 384;
constexpr int kSwizzleBytes = 1024;  // one 128-byte swizzle atom: 8 rows of 128 bytes

template <int HD>
struct WgCfg {
  static constexpr int kHalves = HD / 64;               // 64-wide boxes per row
  static constexpr int kHalfQ = kWgRows * 128;          // bytes of one Q box
  static constexpr int kHalfKV = kWgKeys * 128;         // bytes of one K or V box
  static constexpr int kQBytes = kHalves * kHalfQ;
  static constexpr int kKVBytes = kHalves * kHalfKV;    // one K (or V) tile
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr size_t kSmem = kSwizzleBytes + kQBytes + 2ull * kStages * kKVBytes +
                                  2ull * kStages * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x, the SFU's approximation (2 ulp); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared, K-major);
// scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The coordinate order of a tensor map: which of dims 1..3 is the KV head,
// the sequence and the batch (dim 0 is the head dim). Packed 2 bits each.
struct MapOrder {
  int head, seq, batch;
};

__device__ __forceinline__ MapOrder unpack_order(int packed) {
  return MapOrder{packed & 3, (packed >> 2) & 3, (packed >> 4) & 3};
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    int k_order, int v_order, const __nv_bfloat16* __restrict__ q,
    __nv_bfloat16* __restrict__ o, Strides qs, Strides os, int rep, int sq, int sk, int causal,
    int window, float scale_log2, int q_vec) {
  using C = WgCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1024-byte boundary: the swizzle atom wgmma and TMA share
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((kSwizzleBytes - raw % kSwizzleBytes) % kSwizzleBytes);
  unsigned char* q_s = base;                  // kHalves x (128 rows x 128 B)
  unsigned char* kv_s = q_s + C::kQBytes;     // kStages x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + 2 * C::kStages * C::kKVBytes);
  uint64_t* empty = full + C::kStages;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = sq * rep;
  const int g0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // latest tiles first
  const int p_first = g0 / rep;
  const int p_last = (min(g0 + kWgRows, n_rows) - 1) / rep;
  const int hi = causal ? min(sk, p_last + 1) : sk;
  const int lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int n_tiles = (hi - lo + kWgKeys - 1) / kWgKeys;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ===== producer warpgroup: one thread keeps the ring full =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const MapOrder ko = unpack_order(k_order), vo = unpack_order(v_order);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(smem_u32(empty + s), ((i / C::kStages) - 1) & 1);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, 2 * C::kKVBytes);
        const int t0 = lo + i * kWgKeys;
        unsigned char* kt = kv_s + (2 * s) * C::kKVBytes;
        unsigned char* vt = kt + C::kKVBytes;
#pragma unroll
        for (int hh = 0; hh < C::kHalves; ++hh) {
          int kc[4] = {hh * 64, 0, 0, 0}, vc[4] = {hh * 64, 0, 0, 0};
          kc[ko.head] = kvh;
          kc[ko.seq] = t0;
          kc[ko.batch] = b;
          vc[vo.head] = kvh;
          vc[vo.seq] = t0;
          vc[vo.batch] = b;
          tma_load_4d(smem_u32(kt + hh * C::kHalfKV), &k_map, bar, kc[0], kc[1], kc[2], kc[3]);
          tma_load_4d(smem_u32(vt + hh * C::kHalfKV), &v_map, bar, vc[0], vc[1], vc[2], vc[3]);
        }
      }
    }
  } else {
    // ===== consumer warpgroups =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7;
    const int t = tid & 127;
    const int lane = t & 31;
    const int group = lane >> 2;
    const int quad = lane & 3;
    const int rb0 = wg * 64;                          // this warpgroup's first row
    const int r0 = rb0 + (t >> 5) * 16 + group;       // this thread's rows: r0, r0 + 8
    const int wg_first = g0 + rb0;
    const int pa = wg_first / rep;                    // the warpgroup's positions
    const int pb = (min(wg_first + 63, n_rows - 1)) / rep;

    // Q: 64 rows x HD, 16-byte loads into the swizzled layout
    constexpr int kChunks = HD / 8;
    const __nv_bfloat16* qb = q + b * qs.b;
    for (int i = t; i < 64 * kChunks; i += 128) {
      const int r = rb0 + i / kChunks;
      const int c = i % kChunks;
      const int g = g0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (g < n_rows) {
        const int p = g / rep;
        const int h = kvh * rep + (g - p * rep);
        x = load8(qb + h * qs.h + p * qs.s + c * 8, q_vec);
      }
      const int half = c / 8;
      const int cc = c % 8;
      *reinterpret_cast<uint4*>(q_s + half * C::kHalfQ + r * 128 + ((cc ^ (r & 7)) * 16)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    int pos[2];
    float m[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pos[i] = (g0 + r0 + 8 * i) / rep;
      m[i] = -INFINITY;
      l[i] = 0.f;  // this lane's share of the row sum; the quad's sum at the end
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(q_s) + rb0 * 128;
    float sc[64];             // S of a tile: sc[4j + e] is row r0 + 8 (e / 2),
                              // key t0 + 8j + 2 quad + e % 2
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa_frag[8][4];   // P of a tile, bf16 A fragments

    // S = Q K^T: HD / 16 k-steps, 4 per 64-wide box, 32 bytes apart
    auto issue_s = [&](int it) {
      const uint32_t k_addr = smem_u32(kv_s + (2 * (it % C::kStages)) * C::kKVBytes);
      fence_regs(sc);  // pins the last writes of sc before the fence
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = wg_desc(q_addr + (kk / 4) * C::kHalfQ + off, 16, kSwizzleBytes);
        const uint64_t db = wg_desc(k_addr + (kk / 4) * C::kHalfKV + off, 16, kSwizzleBytes);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wg_commit();
    };

    // The pipeline inside a warpgroup: P.V of tile i runs on the tensor
    // cores with S of tile i + 1 issued behind it, and one wait retires
    // both before the iteration ends, so no accumulator is in flight across
    // the loop's back edge and nothing but a wgmma writes an accumulator
    // while one is in flight (else ptxas serialises every wgmma, C7515).
    // For the same reason no wgmma sits under a branch: every tile is
    // computed (a warpgroup past the rows, in the grid's last block, works
    // on zero rows and stores nothing), and the last iteration issues one
    // spare S on the last tile, whose result goes unused.
    fence_regs(acc);
    mbar_wait(smem_u32(full), 0);
    issue_s(0);
    wg_wait();
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = lo + it * kWgKeys;
      fence_regs(sc);
      // mask (edge tiles only; a masked score is -inf), then the online
      // softmax of the two rows, the max kept in raw score units:
      // p = 2^(s * scale * log2(e) - m * scale * log2(e)). A row with no
      // live key yet (m = -inf) subtracts 0 instead, so every masked p is
      // 2^-inf = 0 and no inf - inf arises.
      const bool edge = (causal && t0 + kWgKeys - 1 > pa) || t0 + kWgKeys > sk ||
                        (window > 0 && pb - t0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + 8 * j + 2 * quad + (e & 1);
            const int dist = pos[e >> 1] - key;
            const bool ok = (key < sk) & (!causal | (dist >= 0)) & ((window <= 0) | (dist < window));
            sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      float alpha[2], mneg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        mneg[i] = m_new == -INFINITY ? 0.f : -m_new * scale_log2;
        alpha[i] = ex2(fmaf(m[i], scale_log2, mneg[i]));
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(sc[4 * j + e], scale_log2, mneg[e >> 1]));
          l[e >> 1] += p[e];
        }
        pa_frag[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
        pa_frag[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: 8 k-steps of 16 keys, 2048 bytes apart in V's tile;
      // the two 64-wide d boxes of HD 128 are one box (16 KB) apart
      const uint32_t v_addr = smem_u32(kv_s + (2 * (it % C::kStages) + 1) * C::kKVBytes);
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa_frag[kk][x])::"memory");
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        const uint64_t db = wg_desc(v_addr + kk * 16 * 128, C::kHalfKV, kSwizzleBytes);
        if constexpr (HD == 128) {
          wgmma_rs_n128(acc, pa_frag[kk], db);
        } else {
          wgmma_rs_n64(acc, pa_frag[kk], db);
        }
      }
      wg_commit();
      if (it + 1 < n_tiles)
        mbar_wait(smem_u32(full + (it + 1) % C::kStages), ((it + 1) / C::kStages) & 1);
      issue_s(min(it + 1, n_tiles - 1));
      wg_wait();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa_frag[kk][x])::"memory");
      mbar_arrive(smem_u32(empty + it % C::kStages));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
      const int g = g0 + r0 + 8 * i;
      if (g >= n_rows) continue;
      const int h = kvh * rep + (g - pos[i] * rep);
      __nv_bfloat16* orow = o + b * os.b + h * os.h + pos[i] * os.s;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
            pack_bf16(acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
      }
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

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry point
// lookup: the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a bf16 K or V (B, Kv, Sk, hd) read through its
// element strides: dim 0 is the head dim (contiguous), dims 1..3 are the
// KV head, the sequence and the batch in ascending order of stride (dims
// of size 1 last, with the extent below them as their stride), boxes of
// 64 d x 128 keys, 128-byte swizzle, zeros past Sk. `order` gets the map
// position of the head, sequence and batch coordinates (2 bits each).
// False when TMA cannot read the tensor (a base or a stride that is not a
// multiple of 16 bytes): the wrapper copies such an operand first.
bool kv_map(CUtensorMap* map, int* order, const void* ptr, int hd, int n_kv, int sk, int B,
            Strides st) {
  struct Dim {
    long long size, stride;
    int role;  // 0 head, 1 sequence, 2 batch
  };
  Dim d[3] = {{n_kv, st.h, 0}, {sk, st.s, 1}, {B, st.b, 2}};
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (const Dim& x : d)
    if (x.size > 1 && (x.stride <= 0 || (x.stride * 2) % 16 != 0 || x.stride * 2 >= (1ll << 40)))
      return false;
  auto before = [](const Dim& x, const Dim& y) {
    if ((x.size > 1) != (y.size > 1)) return x.size > 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  long long extent = hd;
  for (Dim& x : d) {
    if (x.size == 1) x.stride = extent;
    extent = x.stride * x.size;
  }
  *order = 0;
  for (int i = 0; i < 3; ++i) *order |= (i + 1) << (2 * d[i].role);
  const cuuint64_t gdim[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(d[0].size),
                              static_cast<cuuint64_t>(d[1].size),
                              static_cast<cuuint64_t>(d[2].size)};
  const cuuint64_t gstride[3] = {static_cast<cuuint64_t>(d[0].stride * 2),
                                 static_cast<cuuint64_t>(d[1].stride * 2),
                                 static_cast<cuuint64_t>(d[2].stride * 2)};
  const cuuint32_t box[4] = {64, d[0].role == 1 ? 128u : 1u, d[1].role == 1 ? 128u : 1u,
                             d[2].role == 1 ? 128u : 1u};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim, gstride,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, Strides s);

template <int HD>
cudaError_t launch_wgmma(const Args& a) {
  CUtensorMap k_map, v_map;
  int k_order = 0, v_order = 0;
  if (!kv_map(&k_map, &k_order, a.k, HD, a.n_kv, a.sk, a.B, a.ks) ||
      !kv_map(&v_map, &v_order, a.v, HD, a.n_kv, a.sk, a.B, a.vs))
    return cudaErrorInvalidValue;
  static bool ready = false;
  const size_t smem = WgCfg<HD>::kSmem;
  const cudaError_t rc = allow_smem(flash_wgmma_kernel<HD>, smem, ready);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((a.sq * a.rep + kWgRows - 1) / kWgRows, a.n_kv, a.B);
  flash_wgmma_kernel<HD><<<grid, kWgThreads, smem, a.stream>>>(
      k_map, v_map, k_order, v_order, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<__nv_bfloat16*>(a.o), a.qs, a.os, a.rep, a.sq, a.sk, a.causal, a.window,
      a.scale * 1.4426950408889634f, aligned16(a.q, a.qs));
  return cudaGetLastError();
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
  } else if constexpr (HD >= 64) {
    return launch_wgmma<HD>(a);
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
