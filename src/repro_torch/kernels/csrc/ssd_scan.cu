// Mamba-2 SSD chunked scan for Hopper (sm_90a): the prefill scan of the
// SSM family on the card.
//
// Replaces the TPU kernel `ssd_scan` (body `_kernel`) in
// src/repro/kernels/ssd_scan/ssd_scan.py, and computes what the
// reference's `models/ssm.ssd_chunked` computes from a zero initial state:
// x (B, S, H, P) and Bm, Cm (B, S, N) in f32 or bf16, dt (B, S, H) and
// A (H,) in f32, chunk Q. The sequence is cut into chunks of Q positions,
// the last one zero-padded (dt = 0 there, so a padded position neither
// decays nor adds to the state). Within a chunk, with cum the inclusive
// prefix sum of dt * A:
//   y[s] = sum_{t <= s} exp(cum[s] - cum[t]) (C_s . B_t) dt_t x_t
//        + exp(cum[s]) C_s . state_in
// and state_out = exp(cum[Q-1]) state_in + sum_t exp(cum[Q-1] - cum[t]) dt_t x_t B_t^T.
// Outputs: y (B, S, H, P) in x's dtype and the state after the last
// position, final_state (B, H, P, N) in f32 (the Pallas kernel keeps the
// state in VMEM and returns only y; prefill needs the state as well).
// The exponent is masked before exp: pairs with t > s are never
// exponentiated (their difference is positive and reaches thousands,
// where exp overflows to inf).
//
// Bound: bytes. One mamba2-130m layer-call at S = 8192 (H = 24, P = 64,
// N = 128, Q = 256, bf16) moves ~56 MB (x and y dominate): 17 us at
// 3.35 TB/s. Its chunked-form work (C B^T once per chunk, 2 Q^2 P +
// 4 Q P N per head and chunk) is 13.4 GFLOP: 14 us at the tensor cores'
// 989 TFLOP/s. The bf16 body below runs ~20 GFLOP of bf16 tensor-core
// products (the split operands below count twice, C B^T is computed once
// per 64-row tile and group of heads): 20 us at that peak, ~40-70 us at
// what `mma.sync` reaches, beside ~100 MB of f32 chunk states that the
// three launches pass through L2. f32 on CUDA cores, where the f32 body
// below runs, is 67 TFLOP/s. Measured (PERF.md: 0.19-0.20 ms at S =
// 8192), the bf16 body is ~12x its byte bound and held by neither bound:
// its blocks take 168-222 KB of shared memory, so an SM runs one block of
// 8 warps, whose dependent chains (shared loads, operand splits, the
// gate's exp, mma) and per-block set-up (tiles, prefix sums, scores) stay
// exposed. A design with more warps per SM (a smaller shared footprint,
// or wgmma with its asynchronous issue) is the next step (ROADMAP B6).
//
// Design. The TPU walks the chunks of one (batch, head) in order with the
// state in VMEM. Here the chunk loop is split into three launches, so
// that all but a cheap elementwise pass run every chunk in parallel:
//   1. chunk_state: the chunk's own state contribution
//      sum_t w_t x_t B_t^T (P x N, w_t = dt_t exp(cum[Q-1] - cum[t])) and
//      its total decay exp(cum[Q-1]) into f32 scratch.
//   2. state_pass: one thread per state element of each (head, batch)
//      walks the chunks in order, replacing each chunk's contribution by
//      the state entering it and writing the final state. It reads 8
//      chunks' contributions ahead of the dependent updates, so the walk
//      does not wait on one load per chunk.
//   3. chunk_out: y for a 64-row tile of a chunk and a group of heads:
//      the intra-chunk quadratic form over the causal keys, then the
//      read-out of the entering state.
//
// bf16 inputs (the model's path) run on the tensor cores:
// mma.sync.m16n8k16, bf16 operands, f32 accumulators. B, C and x are
// exact bf16 operands. An f32 operand v enters as two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), whose two products are summed in
// f32: 2^-17 relative, where one bf16 term would give 2^-9 (enough, at
// state elements of ~1, to break the final state's 1e-4 check). Split
// operands: the chunk-state product's w_t x_t, the entering state in the
// C . state read-out (split once, by state_pass, into {hi, lo} words in
// place) and the gate G = exp(cum[s] - cum[t]) (C_s . B_t) dt_t in G x;
// the pass over chunks and the final state stay f32. (G in one bf16
// term, as the TPU's default-precision f32 dot would take it, held y's
// rows within their check but moved the mamba arm's 24-layer logits
// 40 % further from the plain route's, to 0.118 of their 0.125 budget.)
//   chunk_state_mma: grid (nc, head groups, B), 8 warps. The chunk's B
//     tile is loaded once and serves every head of the group; each
//     head's x tile arrives by cp.async while the previous head
//     computes (two stages). Warp w owns a 16 x 64 (P 64) or 16 x 32
//     (P 32) block of the P x N state; the K loop runs over positions.
//   chunk_out_mma: grid (nc * row tiles, head groups, B), 8 warps, the
//     chunks' last row tiles (the most keys) first. Warp w owns rows
//     16 (w % 4) .. + 16 of the tile and every other 16-key subtile
//     (w / 4 picks which), so each pair of warps splits its strip's
//     causal keys evenly. The block computes its rows' C B^T scores once
//     (head-independent: one B/C group) into shared memory, while its
//     first heads' x tiles and state arrive, then walks its heads: per
//     head, the state read-out (half the N steps per warp), the gate
//     applied to the stored scores in registers (causal mask and decay
//     exponent masked before ex2), G x against the x tile (two cp.async
//     stages across heads; the next head's state arrives during G x),
//     and the pair's halves of y summed through shared memory.
//   Heads per block (up to 8): the count that minimises waves of blocks
//   over the SMs times a block's work (head_group below): on 132 SMs,
//   chunk_out takes 6 at S = 2,048 (128 blocks) and 8 at S = 8,192;
//   chunk_state 2 and 6.
//   N is zero-padded to a multiple of 16, ragged tiles are zero-filled.
// f32 inputs keep an exact body on CUDA cores: chunk_state_kernel (one
// block per chunk, head and batch) and chunk_out_kernel (one block per
// 64-row tile, 4 heads and batch; C B^T once per 64 x 64 tile and group).
// Thread layout in their 64 x 64 tiles: a 16 x 16 grid, thread (ty, tx)
// owns rows ty + 16 i and columns tx + 16 j, so every shared-memory read
// in the inner loops is a broadcast or 16 consecutive words, and the
// transposed tiles' row stride (66, 2 mod 32) makes their stores
// conflict-free.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;         // rows s and keys t per tile (chunk_out)
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;
constexpr int kStateRows = 32;    // positions staged at once (chunk_state)
constexpr int kHeads = 4;         // heads per chunk_out block
constexpr int kPad = 66;          // row stride of the transposed tiles


struct Strides {  // elements; x/y (b, s, h) with p contiguous, dt (b, s, h), Bm/Cm (b, s) with n contiguous
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, C_b, C_s, y_b, y_s, y_h;
};

// Inclusive prefix sums of dt * a over a chunk's Q (<= 256) positions, of
// which the first L (>= 1) are real, by one warp: each lane sums its run
// of ceil(L/32) real positions, then the lanes' totals are scanned across
// the warp. The padded positions [L, Q) copy cum[L-1] exactly: they add
// nothing, and a sum that reassociated them would move cum[Q-1] away from
// cum[L-1] by an ulp of |cum| (thousands at the model's decay rates),
// which exp turns into a relative error of the ragged chunk's state.
__device__ void warp_cumsum(const float* dts, float a, float* cum, int Q, int L, int lane) {
  const int per = (L + 31) / 32;
  const int lo = lane * per;
  float local[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunk / 32; ++i) {
    if (i < per && lo + i < L) run += dts[lo + i] * a;
    local[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunk / 32; ++i)
    if (i < per && lo + i < L) cum[lo + i] = excl + local[i];
  __syncwarp();
  const float last = cum[L - 1];
  for (int t = L + lane; t < Q; t += 32) cum[t] = last;
}

// ---------------------------------------------------------------------------
// 1. chunk_state: grid (nc, H, B)
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decay,
    int S, int H, int N, int Q, int nc, Strides st) {
  __shared__ float dts[kMaxChunk], cum[kMaxChunk];
  __shared__ float xs[kStateRows][P];       // x_t * dt_t * exp(cum[Q-1] - cum[t])
  __shared__ float bs[kStateRows][kMaxN];   // B_t
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int t = tid; t < Q; t += kThreads)
    dts[t] = t0 + t < S ? dt[b * st.dt_b + (long long)(t0 + t) * st.dt_s + h * st.dt_h] : 0.f;
  __syncthreads();
  if (tid < 32) warp_cumsum(dts, A[h], cum, Q, min(Q, S - t0), tid);
  __syncthreads();
  const float cum_end = cum[Q - 1];

  constexpr int kI = P / 16;       // p = ty + 16 i
  constexpr int kJ = kMaxN / 16;   // n = tx + 16 j (n < N written)
  float acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  for (int ts = 0; ts < Q; ts += kStateRows) {
    for (int e = tid; e < kStateRows * P; e += kThreads) {
      const int r = e / P, p = e % P, t = ts + r;
      float v = 0.f;
      if (t < Q && t0 + t < S)
        v = x[b * st.x_b + (long long)(t0 + t) * st.x_s + h * st.x_h + p] * dts[t] *
            expf(cum_end - cum[t]);
      xs[r][p] = v;
    }
    for (int e = tid; e < kStateRows * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN, t = ts + r;
      bs[r][n] = (n < N && t < Q && t0 + t < S)
                     ? Bm[b * st.B_b + (long long)(t0 + t) * st.B_s + n]
                     : 0.f;
    }
    __syncthreads();
    const int rows = min(kStateRows, Q - ts);
    for (int r = 0; r < rows; ++r) {
      float xv[kI], bv[kJ];
#pragma unroll
      for (int i = 0; i < kI; ++i) xv[i] = xs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) bv[j] = bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] += xv[i] * bv[j];
    }
    __syncthreads();
  }

  float* out = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int n = tx + 16 * j;
      if (n < N) out[(ty + 16 * i) * N + n] = acc[i][j];
    }
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(cum_end);
}

// ---------------------------------------------------------------------------
// 2. state_pass: grid (ceil(P*ns / 256), H, B); in place over `states`
// (rows of ns >= N floats; columns >= N are zero and not written out).
// kSplit (the bf16 body): each entering state goes out as the 32-bit word
// of its two bf16 terms, hi = bf16(v) in the low half and lo = bf16(v - hi)
// in the high half, in the slot of its f32 contribution.
// ---------------------------------------------------------------------------

constexpr int kPassBatch = 8;  // chunks whose contributions are read at once

__device__ __forceinline__ uint32_t split_word(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay, float* __restrict__ final_state,
    int H, int P, int N, int ns, int nc) {
  const int PN = P * ns;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const long long row0 = (long long)b * nc * H + h;  // chunk c's row: row0 + c * H
  float cur[kPassBatch], dcur[kPassBatch];
  auto read = [&](int c0, float (&v)[kPassBatch], float (&d)[kPassBatch]) {
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i)
      if (c0 + i < nc) {
        v[i] = states[(row0 + (long long)(c0 + i) * H) * PN + e];
        d[i] = decay[row0 + (long long)(c0 + i) * H];
      }
  };
  read(0, cur, dcur);
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float nxt[kPassBatch], dnxt[kPassBatch];
    read(c0 + kPassBatch, nxt, dnxt);  // the next batch's loads fly during this one's
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i)
      if (c0 + i < nc) {
        float* slot = states + (row0 + (long long)(c0 + i) * H) * PN + e;
        if (kSplit)  // the state entering chunk c0 + i
          *reinterpret_cast<uint32_t*>(slot) = split_word(carry);
        else
          *slot = carry;
        carry = cur[i] + dcur[i] * carry;
      }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      cur[i] = nxt[i];
      dcur[i] = dnxt[i];
    }
  }
  const int p = e / ns, n = e % ns;
  if (n < N) final_state[((long long)b * H + h) * P * N + p * N + n] = carry;
}

// ---------------------------------------------------------------------------
// 3. chunk_out: grid (nc * row_tiles, ceil(H / 4), B)
// ---------------------------------------------------------------------------

template <int P>
constexpr size_t out_smem_bytes() {
  return sizeof(float) *
         (2 * kMaxN * kPad + kTile * kPad + kTile * P + 2 * kHeads * kMaxChunk);
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ states_in,
    float* __restrict__ y, int S, int H, int N, int Q, int nc, int row_tiles, Strides st) {
  extern __shared__ float smem[];
  float* c_t = smem;                      // [N][kPad]  C rows of the tile, transposed
  float* b_t = c_t + kMaxN * kPad;        // [N][kPad]  B rows of a key tile; later a state
  float* g_t = b_t + kMaxN * kPad;        // [kTile][kPad]  G of one head, key-major
  float* xs = g_t + kTile * kPad;         // [kTile][P]  x rows of a key tile, one head
  float* dts = xs + kTile * P;            // [kHeads][kMaxChunk]
  float* cum = dts + kHeads * kMaxChunk;  // [kHeads][kMaxChunk]

  const int c = blockIdx.x / row_tiles, r = blockIdx.x % row_tiles;
  const int h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int t0 = c * Q, s_lo = r * kTile;
  if (t0 + s_lo >= S) return;  // rows wholly in the padded tail
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < nh * Q; e += kThreads) {
    const int hg = e / Q, t = e % Q;
    dts[hg * kMaxChunk + t] =
        t0 + t < S ? dt[b * st.dt_b + (long long)(t0 + t) * st.dt_s + (h0 + hg) * st.dt_h] : 0.f;
  }
  for (int e = tid; e < kTile * N; e += kThreads) {
    const int s = e / N, n = e % N, q = s_lo + s;
    c_t[n * kPad + s] =
        q < Q && t0 + q < S ? Cm[b * st.C_b + (long long)(t0 + q) * st.C_s + n] : 0.f;
  }
  __syncthreads();
  if (warp < nh)
    warp_cumsum(dts + warp * kMaxChunk, A[h0 + warp], cum + warp * kMaxChunk, Q,
                min(Q, S - t0), lane);

  constexpr int kJ = P / 16;  // p = tx + 16 j
  float acc[kHeads][4][kJ];   // rows s = s_lo + ty + 16 i
#pragma unroll
  for (int hg = 0; hg < kHeads; ++hg)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[hg][i][j] = 0.f;

  // intra-chunk term over the key tiles at or before this row tile
  for (int kt = 0; kt <= r; ++kt) {
    const int t_lo = kt * kTile;
    __syncthreads();  // the previous tile's readers of b_t, g_t, xs are done
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int t = e / N, n = e % N, q = t_lo + t;
      b_t[n * kPad + t] =
          q < Q && t0 + q < S ? Bm[b * st.B_b + (long long)(t0 + q) * st.B_s + n] : 0.f;
    }
    __syncthreads();
    float sc[4][4];  // (C B^T)[s][t], s = ty + 16 i, t = tx + 16 j (tile-local)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_t[n * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_t[n * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
    }
    const int t_hi = min(kTile, Q - t_lo);
#pragma unroll
    for (int hg = 0; hg < kHeads; ++hg) {
      if (hg >= nh) continue;  // block-uniform
      const float* cm = cum + hg * kMaxChunk;
      const float* dv = dts + hg * kMaxChunk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s_lo + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t_lo + tx + 16 * j;
          // masked before exp: t > s would overflow
          const float g = (t <= s && s < Q) ? expf(cm[s] - cm[t]) * sc[i][j] * dv[t] : 0.f;
          g_t[(tx + 16 * j) * kPad + ty + 16 * i] = g;
        }
      }
      for (int e = tid; e < kTile * P; e += kThreads) {
        const int t = e / P, p = e % P, q = t_lo + t;
        xs[e] = q < Q && t0 + q < S
                    ? x[b * st.x_b + (long long)(t0 + q) * st.x_s + (h0 + hg) * st.x_h + p]
                    : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < t_hi; ++t) {
        float gv[4], xv[kJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = g_t[t * kPad + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kJ; ++j) xv[j] = xs[t * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kJ; ++j) acc[hg][i][j] += gv[i] * xv[j];
      }
      __syncthreads();  // before the next head rewrites g_t and xs
    }
  }

  // read-out of the state entering the chunk, then y
#pragma unroll
  for (int hg = 0; hg < kHeads; ++hg) {
    if (hg >= nh) continue;  // block-uniform
    __syncthreads();  // b_t is free
    const float* st_in = states_in + (((long long)b * nc + c) * H + h0 + hg) * P * N;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      b_t[n * kPad + p] = st_in[e];
    }
    __syncthreads();
    float off[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) off[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], sv[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_t[n * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) sv[j] = b_t[n * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) off[i][j] += cv[i] * sv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s_lo + ty + 16 * i;
      if (s >= Q || t0 + s >= S) continue;
      const float e = expf(cum[hg * kMaxChunk + s]);
      float* row = y + b * st.y_b + (long long)(t0 + s) * st.y_s + (h0 + hg) * st.y_h;
#pragma unroll
      for (int j = 0; j < kJ; ++j) row[tx + 16 * j] = acc[hg][i][j] + off[i][j] * e;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------
// mma.sync.m16n8k16 fragments (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major): a0 = (row g, k 2q, 2q+1), a1 = row g + 8,
//                           a2, a3 = the same rows at k + 8
//   B (16 x 8, k-major):    b0 = (k 2q, 2q+1; column g), b1 = k + 8
//   C (16 x 8, f32):        c0, c1 = (row g, columns 2q, 2q+1)
//                           c2, c3 = (row g + 8, the same columns)
// Shared tiles keep a row pitch of an odd number of 16-byte units, so the
// 8 rows an ldmatrix reads fall in 8 different bank groups.

typedef __nv_bfloat16 bf16;

constexpr int kWarps = kThreads / 32;  // 8 in both bf16 kernels
constexpr int kRows = 64;              // rows s of a chunk_out block
constexpr int kMaxGroup = 8;           // heads a block walks, at most
constexpr int kMaxSub = 8;             // 16-key subtiles a chunk_out warp owns, at most
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// (v0, v1) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi). v - hi is
// exact in f32, so hi + lo is v to 2^-17 of it.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [0, rows) of a bf16 matrix (row i at src + i * stride, columns
// [0, cols) real) into shared memory at row pitch `pitch`: zero at rows
// >= valid and at columns [cols, cols_pad) (cols_pad a multiple of 8).
// 16-byte cp.async where the source allows it (`vec`: base and stride
// 16-byte aligned), else plain loads and a 16-byte store.
__device__ void load_tile(bf16* dst, int pitch, const bf16* src, long long stride, int rows,
                          int valid, int cols, int cols_pad, bool vec) {
  const int per_row = cols_pad / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, k = (e % per_row) * 8;
    bf16* d = dst + r * pitch + k;
    const bf16* src_r = src + r * stride + k;
    if (vec && r < valid && k + 8 <= cols) {
      cp_async16(d, src_r);
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(src_r);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (r < valid && k + 2 * j < cols) ? h[2 * j] : 0u;
        const uint32_t hi = (r < valid && k + 2 * j + 1 < cols) ? h[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// dt of `nh` heads over the chunk's positions (0 past the L real ones),
// rows of kMaxChunk floats; Q here is the chunk rounded up to 16, so that
// every 16-key subtile reads finite values
__device__ void load_dt(float* dts, const float* dt, int b, int t0, int h0, int nh, int Q, int L,
                        const Strides& st) {
  for (int e = threadIdx.x; e < nh * Q; e += kThreads) {
    const int hh = e / Q, t = e % Q;
    dts[hh * kMaxChunk + t] =
        t < L ? dt[b * st.dt_b + (long long)(t0 + t) * st.dt_s + (h0 + hh) * st.dt_h] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1'. chunk_state_mma: grid (nc, ceil(H / group), B)
// ---------------------------------------------------------------------------

template <int P>
constexpr size_t state_mma_smem_bytes() {
  return sizeof(bf16) * (kMaxChunk * (kMaxN + 8) + 2 * kMaxChunk * (P + 8)) +
         sizeof(float) * 3 * kMaxGroup * kMaxChunk;
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) chunk_state_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decay, int S,
    int H, int N, int ns, int Q, int nc, int group, Strides st, int vec) {
  constexpr int kXP = P + 8;               // pitch of an x tile
  constexpr int kMT = P / 16;              // 16-row blocks of the P x N state
  constexpr int kNW = kMaxN * kMT / kWarps;  // state columns per warp: 64 (P 64), 32 (P 32)
  constexpr int kNT = kNW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);       // [Q][ns + 8]  B rows
  bf16* xs = bt + kMaxChunk * (kMaxN + 8);            // [2][Q][P + 8]  x rows, two heads
  float* dts = reinterpret_cast<float*>(xs + 2 * kMaxChunk * kXP);  // [group][kMaxChunk]
  float* cum = dts + kMaxGroup * kMaxChunk;
  float* w = cum + kMaxGroup * kMaxChunk;  // dt_t exp(cum[Q-1] - cum[t]), 0 past L

  const int bp = ns + 8;
  const int c = blockIdx.x, h0 = blockIdx.y * group, b = blockIdx.z;
  const int nh = min(group, H - h0);
  const int t0 = c * Q, L = min(Q, S - t0), kp = (L + 15) & ~15, q16 = (Q + 15) & ~15;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int mw = warp % kMT, n_base = (warp / kMT) * kNW;

  load_tile(bt, bp, Bm + b * st.B_b + (long long)t0 * st.B_s, st.B_s, kp, L, N, ns, vec & 2);
  auto load_x = [&](int hh) {  // one commit group per head, empty past the last
    if (hh < nh)
      load_tile(xs + (hh & 1) * kMaxChunk * kXP, kXP,
                x + b * st.x_b + (long long)t0 * st.x_s + (long long)(h0 + hh) * st.x_h, st.x_s,
                kp, L, P, P, vec & 1);
    cp_commit();
  };
  load_x(0);
  load_x(1);
  load_dt(dts, dt, b, t0, h0, nh, q16, L, st);
  __syncthreads();
  if (warp < nh) {
    float* cm = cum + warp * kMaxChunk;
    warp_cumsum(dts + warp * kMaxChunk, A[h0 + warp], cm, q16, L, lane);
    __syncwarp();
    const float end = cm[q16 - 1];  // = cum[L - 1]: padded positions copy it
    for (int t = lane; t < kp; t += 32)
      w[warp * kMaxChunk + t] = t < L ? dts[warp * kMaxChunk + t] * expf(end - cm[t]) : 0.f;
    if (lane == 0) decay[((long long)b * nc + c) * H + h0 + warp] = expf(end);
  }

  for (int hh = 0; hh < nh; ++hh) {
    cp_wait<1>();  // this head's x tile (and the B tile) have landed
    __syncthreads();
    const bf16* xt = xs + (hh & 1) * kMaxChunk * kXP;
    const float* wh = w + hh * kMaxChunk;
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (n_base < ns) {  // warp-uniform: columns past the padded N are idle
      for (int ks = 0; ks < kp / 16; ++ks) {
        // A[p][t] = w_t x[t][p]: x^T by a transposing ldmatrix, scaled in f32, split
        uint32_t a[4], hi[4], lo[4];
        const int i = lane >> 3;
        ldsm_x4_t(a, xt + (16 * ks + (lane & 7) + ((i >> 1) << 3)) * kXP + 16 * mw +
                          ((i & 1) << 3));
        const float2 w0 = *reinterpret_cast<const float2*>(wh + 16 * ks + 2 * q);
        const float2 w8 = *reinterpret_cast<const float2*>(wh + 16 * ks + 8 + 2 * q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack_bf16(a[r]);
          const float2 wv = r < 2 ? w0 : w8;
          split2(v.x * wv.x, v.y * wv.y, hi[r], lo[r]);
        }
        uint32_t bb[kNT / 2][4];  // B[t][n], n-tiles n0 and n0 + 8
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          const int n0 = n_base + 16 * np;
          if (n0 < ns)  // warp-uniform
            ldsm_x4_t(bb[np], bt + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * bp + n0 +
                                  ((lane >> 4) << 3));
        }
        // all hi products, then all lo (never a pair on one accumulator
        // back to back)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
          if (n_base + 16 * np < ns) {
            mma_bf16(acc[2 * np], hi, bb[np][0], bb[np][1]);
            mma_bf16(acc[2 * np + 1], hi, bb[np][2], bb[np][3]);
          }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
          if (n_base + 16 * np < ns) {
            mma_bf16(acc[2 * np], lo, bb[np][0], bb[np][1]);
            mma_bf16(acc[2 * np + 1], lo, bb[np][2], bb[np][3]);
          }
      }
      float* out = states + (((long long)b * nc + c) * H + h0 + hh) * P * ns;
      const int p = 16 * mw + g;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n_base + 8 * j + 2 * q;
        if (n < ns) {
          *reinterpret_cast<float2*>(out + p * ns + n) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(out + (p + 8) * ns + n) = make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this head's x stage
    load_x(hh + 2);
  }
}

// ---------------------------------------------------------------------------
// 3'. chunk_out_mma: grid (nc * row_tiles, ceil(H / group), B)
// ---------------------------------------------------------------------------

template <int P>
constexpr size_t out_mma_smem_bytes() {
  return sizeof(float) * (kWarps * kMaxSub * 32 * 8           // scores
                          + 2 * kMaxGroup * kMaxChunk           // dt, cum
                          + kWarps * (P / 16) * 32 * 4          // y halves of a warp pair
                          + P * (kMaxN + 8)) +                  // the entering state
         sizeof(bf16) * (kRows * (kMaxN + 8) + 2 * kMaxChunk * (P + 8));  // C rows; x stages
}

// P rows of ns 32-bit words (a chunk's entering state) into shared memory
// at row pitch ns + 8, by 16-byte cp.async
__device__ void load_state(uint32_t* dst, const float* src, int P, int ns) {
  const int per_row = ns / 4;
  for (int e = threadIdx.x; e < P * per_row; e += kThreads) {
    const int r = e / per_row, k = (e % per_row) * 4;
    cp_async16(dst + r * (ns + 8) + k, src + r * ns + k);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) chunk_out_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ states_in,
    bf16* __restrict__ y, int S, int H, int N, int ns, int Q, int nc, int row_tiles, int group,
    Strides st, int vec) {
  constexpr int kXP = P + 8;
  constexpr int kPT = P / 8;  // n-tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);  // [warp][subtile][2][32][4] scores
  float* xch = sc + kWarps * kMaxSub * 32 * 8;     // [warp][kPT / 2][32][4]
  bf16* bt = reinterpret_cast<bf16*>(sc);          // [keys][ns + 8] B rows, before both
  float* dts = xch + kWarps * (kPT / 2) * 32 * 4;  // [group][kMaxChunk]
  float* cum = dts + kMaxGroup * kMaxChunk;
  uint32_t* sst = reinterpret_cast<uint32_t*>(cum + kMaxGroup * kMaxChunk);  // [P][ns + 8]
  bf16* ct = reinterpret_cast<bf16*>(sst + P * (kMaxN + 8));  // [kRows][ns + 8]
  bf16* stage = ct + kRows * (kMaxN + 8);  // x [2][keys][P + 8]
  static_assert(sizeof(float) * (kWarps * kMaxSub * 256 + kWarps * (P / 16) * 128) >=
                    sizeof(bf16) * kMaxChunk * (kMaxN + 8),
                "the B tile fits where the scores and the exchange go later");

  const int cp = ns + 8;
  const int r = row_tiles - 1 - blockIdx.x / nc, c = blockIdx.x % nc;  // last row tiles first
  const int h0 = blockIdx.y * group, b = blockIdx.z;
  const int t0 = c * Q, L = min(Q, S - t0), s_lo = r * kRows, q16 = (Q + 15) & ~15;
  if (s_lo >= L) return;  // rows wholly in the padded tail (block-uniform)
  const int nh = min(group, H - h0);
  const int keys = min(L, s_lo + kRows);  // the keys any row of the tile sees
  const int kp = (keys + 15) & ~15;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int m = warp & 3, par = warp >> 2;  // row strip; which 16-key subtiles
  const int s0 = s_lo + 16 * m;
  const bool live = s0 < L;                // warp-uniform
  const int last_ks = s0 / 16;             // the strip's diagonal subtile

  // commit groups: the C and B tiles; then per head, its state (issued
  // while the head before it runs G x) and the x tile of the head after next
  auto load_x = [&](int hh) {
    if (hh < nh)
      load_tile(stage + (hh & 1) * kMaxChunk * kXP, kXP,
                x + b * st.x_b + (long long)t0 * st.x_s + (long long)(h0 + hh) * st.x_h, st.x_s,
                kp, keys, P, P, vec & 1);
    cp_commit();
  };
  auto state_of = [&](int hh) {
    return states_in + (((long long)b * nc + c) * H + h0 + hh) * P * ns;
  };
  load_tile(ct, cp, Cm + b * st.C_b + (long long)(t0 + s_lo) * st.C_s, st.C_s, kRows, L - s_lo,
            N, ns, vec & 4);
  load_tile(bt, cp, Bm + b * st.B_b + (long long)t0 * st.B_s, st.B_s, kp, keys, N, ns, vec & 2);
  cp_commit();
  load_state(sst, state_of(0), P, ns);
  load_x(0);  // the first heads' tiles fly during the scores
  load_x(1);
  load_dt(dts, dt, b, t0, h0, nh, q16, L, st);
  __syncthreads();
  if (warp < nh)
    warp_cumsum(dts + warp * kMaxChunk, A[h0 + warp], cum + warp * kMaxChunk, q16, L, lane);
  cp_wait<2>();  // the C and B tiles
  __syncthreads();

  // C B^T of the strip's rows and this warp's subtiles (ks = par + 2 i),
  // once for every head: in registers while the B tile is read, then into
  // the B tile's place
  float d[kMaxSub][2][4] = {};
  if (live) {
    for (int kk = 0; kk < ns / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ct + (16 * m + (lane & 15)) * cp + 16 * kk + ((lane >> 4) << 3));
#pragma unroll
      for (int i = 0; i < kMaxSub; ++i) {
        const int ks = par + 2 * i;
        if (ks <= last_ks) {  // warp-uniform
          uint32_t bb[4];
          ldsm_x4(bb, bt + (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * cp + 16 * kk +
                          (((lane >> 3) & 1) << 3));
          mma_bf16(d[i][0], a, bb[0], bb[1]);
          mma_bf16(d[i][1], a, bb[2], bb[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the B tile
  float* my_sc = sc + warp * kMaxSub * 256;
#pragma unroll
  for (int i = 0; i < kMaxSub; ++i)
    if (par + 2 * i <= last_ks) {
      *reinterpret_cast<float4*>(my_sc + (2 * i) * 128 + lane * 4) =
          make_float4(d[i][0][0], d[i][0][1], d[i][0][2], d[i][0][3]);
      *reinterpret_cast<float4*>(my_sc + (2 * i + 1) * 128 + lane * 4) =
          make_float4(d[i][1][0], d[i][1][1], d[i][1][2], d[i][1][3]);
    }
  __syncwarp();

  for (int hh = 0; hh < nh; ++hh) {
    cp_wait<1>();
    __syncthreads();
    const bf16* xt = stage + (hh & 1) * kMaxChunk * kXP;
    const float* cm = cum + hh * kMaxChunk;
    const float* dv = dts + hh * kMaxChunk;
    float acc[kPT][4];
#pragma unroll
    for (int j = 0; j < kPT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (live) {
      // read-out C_s . state_in, this warp's half of the N steps; the state
      // arrives as {hi, lo} words (state_pass), regrouped into bf16 pairs
      for (int kk = par; kk < ns / 16; kk += 2) {
        uint32_t a[4];
        ldsm_x4(a, ct + (16 * m + (lane & 15)) * cp + 16 * kk + ((lane >> 4) << 3));
        uint32_t hi[kPT][2], lo[kPT][2];
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const uint32_t* row = sst + (8 * j + g) * (ns + 8) + 16 * kk + 2 * q;
          const uint2 w0 = *reinterpret_cast<const uint2*>(row);
          const uint2 w8 = *reinterpret_cast<const uint2*>(row + 8);
          hi[j][0] = __byte_perm(w0.x, w0.y, 0x5410);
          lo[j][0] = __byte_perm(w0.x, w0.y, 0x7632);
          hi[j][1] = __byte_perm(w8.x, w8.y, 0x5410);
          lo[j][1] = __byte_perm(w8.x, w8.y, 0x7632);
        }
        // all hi products, then all lo: a pair on one accumulator is never
        // issued back to back
#pragma unroll
        for (int j = 0; j < kPT; ++j) mma_bf16(acc[j], a, hi[j][0], hi[j][1]);
#pragma unroll
        for (int j = 0; j < kPT; ++j) mma_bf16(acc[j], a, lo[j][0], lo[j][1]);
      }
      const float e0 = expf(cm[s0 + g]), e8 = expf(cm[s0 + g + 8]);
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e8;
        acc[j][3] *= e8;
      }
    }
    __syncthreads();  // every warp is done with this head's state
    if (hh + 1 < nh) load_state(sst, state_of(hh + 1), P, ns);
    cp_commit();
    if (live) {
      const float cs0 = cm[s0 + g], cs8 = cm[s0 + g + 8];
      // intra-chunk term: G = exp(cum[s] - cum[t]) (C_s . B_t) dt_t, t <= s
      const int sa = s0 + g, sb = sa + 8;
      for (int ks = par, i = 0; ks <= last_ks; ks += 2, ++i) {
        const float4 d0 = *reinterpret_cast<const float4*>(my_sc + (2 * i) * 128 + lane * 4);
        const float4 d1 = *reinterpret_cast<const float4*>(my_sc + (2 * i + 1) * 128 + lane * 4);
        const int ta = 16 * ks + 2 * q, tb = ta + 8;
        const float2 ca = *reinterpret_cast<const float2*>(cm + ta);
        const float2 cb = *reinterpret_cast<const float2*>(cm + tb);
        const float2 da = *reinterpret_cast<const float2*>(dv + ta);
        const float2 db = *reinterpret_cast<const float2*>(dv + tb);
        // masked before ex2: t > s would overflow
        auto gate = [](int s, int t, float cs, float ctv, float score, float d) {
          return score * d * ex2((t <= s ? cs - ctv : -INFINITY) * kLog2e);
        };
        uint32_t hi[4], lo[4];  // G's A fragment, two bf16 terms
        split2(gate(sa, ta, cs0, ca.x, d0.x, da.x), gate(sa, ta + 1, cs0, ca.y, d0.y, da.y),
               hi[0], lo[0]);
        split2(gate(sb, ta, cs8, ca.x, d0.z, da.x), gate(sb, ta + 1, cs8, ca.y, d0.w, da.y),
               hi[1], lo[1]);
        split2(gate(sa, tb, cs0, cb.x, d1.x, db.x), gate(sa, tb + 1, cs0, cb.y, d1.y, db.y),
               hi[2], lo[2]);
        split2(gate(sb, tb, cs8, cb.x, d1.z, db.x), gate(sb, tb + 1, cs8, cb.y, d1.w, db.y),
               hi[3], lo[3]);
        uint32_t bb[kPT / 2][4];  // x[t][p], p-tiles 16 np and 16 np + 8
#pragma unroll
        for (int np = 0; np < kPT / 2; ++np)
          ldsm_x4_t(bb[np], xt + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * kXP +
                                16 * np + ((lane >> 4) << 3));
#pragma unroll
        for (int np = 0; np < kPT / 2; ++np) {
          mma_bf16(acc[2 * np], hi, bb[np][0], bb[np][1]);
          mma_bf16(acc[2 * np + 1], hi, bb[np][2], bb[np][3]);
        }
#pragma unroll
        for (int np = 0; np < kPT / 2; ++np) {
          mma_bf16(acc[2 * np], lo, bb[np][0], bb[np][1]);
          mma_bf16(acc[2 * np + 1], lo, bb[np][2], bb[np][3]);
        }
      }
    }
    // the pair (m, 0), (m, 1) sums its halves: warp `par` keeps y's
    // p-tiles [par, par + 1) * kPT / 2 and hands the others to its
    // partner (selects, so that acc stays in registers)
    constexpr int kHalf = kPT / 2;
    float* mine = xch + warp * kHalf * 128;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float(&lo)[4] = acc[j];
      const float(&hi)[4] = acc[j + kHalf];
      *reinterpret_cast<float4*>(mine + j * 128 + lane * 4) =
          par ? make_float4(lo[0], lo[1], lo[2], lo[3]) : make_float4(hi[0], hi[1], hi[2], hi[3]);
    }
    __syncthreads();  // also: every warp is done with this head's x stage
    if (live) {
      const float* theirs = xch + (warp ^ 4) * kHalf * 128;
      bf16* yh = y + b * st.y_b + (long long)(h0 + hh) * st.y_h;
      const int sa = s0 + g, sb = sa + 8;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float4 o = *reinterpret_cast<const float4*>(theirs + j * 128 + lane * 4);
        const float k0 = par ? acc[j + kHalf][0] : acc[j][0];
        const float k1 = par ? acc[j + kHalf][1] : acc[j][1];
        const float k2 = par ? acc[j + kHalf][2] : acc[j][2];
        const float k3 = par ? acc[j + kHalf][3] : acc[j][3];
        const int p = 8 * (par * kHalf + j) + 2 * q;
        if (sa < L)
          *reinterpret_cast<uint32_t*>(yh + (long long)(t0 + sa) * st.y_s + p) =
              pack_bf16(k0 + o.x, k1 + o.y);
        if (sb < L)
          *reinterpret_cast<uint32_t*>(yh + (long long)(t0 + sb) * st.y_s + p) =
              pack_bf16(k2 + o.z, k3 + o.w);
      }
    }
    load_x(hh + 2);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// opt a kernel in above 48 KB of dynamic shared memory, once
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  ready = rc == cudaSuccess;
  return rc;
}

template <bool kSplit>
cudaError_t pass(float* states, const float* decay, float* final_state, int B, int H, int P,
                 int N, int ns, int nc, cudaStream_t stream) {
  state_pass_kernel<kSplit>
      <<<dim3((P * ns + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
          states, decay, final_state, H, P, N, ns, nc);
  return cudaGetLastError();
}

// f32: the exact body on CUDA cores; states rows of N floats
template <int P>
cudaError_t launch_f32(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, float* y, float* final_state, float* states, float* decay,
                       int B, int S, int H, int N, int Q, const Strides& st, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  chunk_state_kernel<P><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      x, dt, A, Bm, states, decay, S, H, N, Q, nc, st);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  rc = pass<false>(states, decay, final_state, B, H, P, N, N, nc, stream);
  if (rc != cudaSuccess) return rc;
  static bool ready = false;
  constexpr size_t smem = out_smem_bytes<P>();
  rc = allow_smem(chunk_out_kernel<P>, smem, ready);
  if (rc != cudaSuccess) return rc;
  const int row_tiles = (Q + kTile - 1) / kTile;
  chunk_out_kernel<P><<<dim3(nc * row_tiles, (H + kHeads - 1) / kHeads, B), kThreads,
                               smem, stream>>>(x, dt, A, Bm, Cm, states, y, S, H, N, Q, nc,
                                               row_tiles, st);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Heads per block, for `units` blocks per group of heads (one block per
// SM at a time): the count, at most kMaxGroup, that minimises the waves
// of blocks over the SMs times the work of a block (its heads, plus one
// for its own set-up: tiles, prefix sums, the scores); the larger on a tie.
int head_group(long long units, int H) {
  const long long sms = sm_count();
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= H && g <= kMaxGroup; ++g) {
    const long long waves = (units * ((H + g - 1) / g) + sms - 1) / sms;
    const long long cost = waves * (g + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

bool aligned16(const void* p, long long a, long long b, long long c) {  // bf16 strides
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && a % 8 == 0 && b % 8 == 0 && c % 8 == 0;
}

// bf16: the tensor-core body; states rows of ns = N rounded up to 16 floats
template <int P>
cudaError_t launch_bf16(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                        const bf16* Cm, bf16* y, float* final_state, float* states, float* decay,
                        int B, int S, int H, int N, int Q, const Strides& st,
                        cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int ns = (N + 15) & ~15;
  const int vec = (aligned16(x, st.x_b, st.x_s, st.x_h) ? 1 : 0) |
                  (aligned16(Bm, st.B_b, st.B_s, 0) ? 2 : 0) |
                  (aligned16(Cm, st.C_b, st.C_s, 0) ? 4 : 0);
  static bool state_ready = false, out_ready = false;
  constexpr size_t state_smem = state_mma_smem_bytes<P>();
  constexpr size_t out_smem = out_mma_smem_bytes<P>();
  cudaError_t rc = allow_smem(chunk_state_mma_kernel<P>, state_smem, state_ready);
  if (rc != cudaSuccess) return rc;
  rc = allow_smem(chunk_out_mma_kernel<P>, out_smem, out_ready);
  if (rc != cudaSuccess) return rc;

  const int gs = head_group((long long)B * nc, H);
  chunk_state_mma_kernel<P><<<dim3(nc, (H + gs - 1) / gs, B), kThreads, state_smem, stream>>>(
      x, dt, A, Bm, states, decay, S, H, N, ns, Q, nc, gs, st, vec);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  rc = pass<true>(states, decay, final_state, B, H, P, N, ns, nc, stream);
  if (rc != cudaSuccess) return rc;
  const int row_tiles = (Q + kRows - 1) / kRows;
  const int go = head_group((long long)B * nc * row_tiles, H);
  chunk_out_mma_kernel<P><<<dim3(nc * row_tiles, (H + go - 1) / go, B), kThreads, out_smem,
                            stream>>>(x, dt, A, Bm, Cm, states, y, S, H, N, ns, Q, nc, row_tiles,
                                      go, st, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it; dt and
// A are float32). Strides are in elements. `states` (B, nc, H, P, ns) and
// `decay` (B, nc, H) are float32 scratch with nc = ceil(S / Q), ns = N for
// float32 and N rounded up to a multiple of 16 for bfloat16. Takes P in
// {32, 64}, 1 <= N <= 128, 1 <= Q <= 256. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* final_state, void* states, void* decay,
                        int B, int S, int H, int P, int N, int Q, long long x_b, long long x_s,
                        long long x_h, long long dt_b, long long dt_s, long long dt_h,
                        long long B_b, long long B_s, long long C_b, long long C_s,
                        long long y_b, long long y_s, long long y_h, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk || (dtype != 0 && dtype != 1) ||
      (P != 32 && P != 64))
    return cudaErrorInvalidValue;
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, C_b, C_s, y_b, y_s, y_h};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* fin = static_cast<float*>(final_state);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float *xf = static_cast<const float*>(x), *bf = static_cast<const float*>(Bm),
                *cf = static_cast<const float*>(Cm);
    float* yf = static_cast<float*>(y);
    return P == 64 ? launch_f32<64>(xf, dtf, Af, bf, cf, yf, fin, sts, dec, B, S, H, N, Q, st, s)
                   : launch_f32<32>(xf, dtf, Af, bf, cf, yf, fin, sts, dec, B, S, H, N, Q, st, s);
  }
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(Bm),
             *cb = static_cast<const bf16*>(Cm);
  bf16* yb = static_cast<bf16*>(y);
  return P == 64 ? launch_bf16<64>(xb, dtf, Af, bb, cb, yb, fin, sts, dec, B, S, H, N, Q, st, s)
                 : launch_bf16<32>(xb, dtf, Af, bb, cb, yb, fin, sts, dec, B, S, H, N, Q, st, s);
}
