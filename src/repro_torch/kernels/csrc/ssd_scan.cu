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
// All arithmetic is f32 on CUDA cores. The exponent is masked before
// exp: pairs with t > s are never exponentiated (their difference is
// positive and reaches thousands, where exp overflows to inf).
//
// Bound: bytes. One mamba2-130m layer-call at S = 8192 (H = 24, P = 64,
// N = 128, Q = 256, bf16) moves ~56 MB (x and y dominate): 17 us at
// 3.35 TB/s. Its chunked-form work (C B^T once per chunk, 2 Q^2 P +
// 4 Q P N per head and chunk) is 13.4 GFLOP: 14 us at the tensor cores'
// 989 TFLOP/s, but 0.2 ms at the 67 TFLOP/s of f32 on CUDA cores, which
// is where this kernel's arithmetic runs (PERF.md has its distance).
//
// Design. The TPU walks the chunks of one (batch, head) in order with the
// state in VMEM. Here the chunk loop is split into three launches, so
// that all but a cheap elementwise pass run every chunk in parallel:
//   1. chunk_state: one block per (chunk, head, batch) computes the
//      chunk's own state contribution sum_t w_t x_t B_t^T (P x N) and its
//      total decay exp(cum[Q-1]) into scratch.
//   2. state_pass: one thread per state element of each (head, batch)
//      walks the chunks in order, replacing each chunk's contribution by
//      the state entering it and writing the final state.
//   3. chunk_out: one block per (64-row tile of a chunk, 4 heads, batch)
//      computes y for its rows: the intra-chunk quadratic form over the
//      causal key tiles, then the read-out of the entering state. C B^T
//      does not depend on the head (one B/C group), so a block computes
//      each 64 x 64 score tile once and applies it to its 4 heads. Rows
//      are tiled by 64 because a Q x Q f32 tile at Q = 256 (256 KB) does
//      not fit a block's 227 KB of shared memory.
// Thread layout in the 64 x 64 tiles: a 16 x 16 grid, thread (ty, tx)
// owns rows ty + 16 i and columns tx + 16 j, so every shared-memory read
// in the inner loops is a broadcast or 16 consecutive words, and the
// transposed tiles' row stride (66, 2 mod 32) makes their stores
// conflict-free. No tensor cores yet (ROADMAP B6-speed).

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decay,
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
        v = to_f32(x[b * st.x_b + (long long)(t0 + t) * st.x_s + h * st.x_h + p]) * dts[t] *
            expf(cum_end - cum[t]);
      xs[r][p] = v;
    }
    for (int e = tid; e < kStateRows * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN, t = ts + r;
      bs[r][n] = (n < N && t < Q && t0 + t < S)
                     ? to_f32(Bm[b * st.B_b + (long long)(t0 + t) * st.B_s + n])
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
// 2. state_pass: grid (ceil(P*N / 256), H, B); in place over `states`
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay, float* __restrict__ final_state,
    int H, int PN, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float carry = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long row = ((long long)b * nc + c) * H + h;
    const float contrib = states[row * PN + e];
    states[row * PN + e] = carry;  // the state entering chunk c
    carry = contrib + decay[row] * carry;
  }
  final_state[((long long)b * H + h) * PN + e] = carry;
}

// ---------------------------------------------------------------------------
// 3. chunk_out: grid (nc * row_tiles, ceil(H / 4), B)
// ---------------------------------------------------------------------------

template <int P>
constexpr size_t out_smem_bytes() {
  return sizeof(float) *
         (2 * kMaxN * kPad + kTile * kPad + kTile * P + 2 * kHeads * kMaxChunk);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states_in,
    T* __restrict__ y, int S, int H, int N, int Q, int nc, int row_tiles, Strides st) {
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
        q < Q && t0 + q < S ? to_f32(Cm[b * st.C_b + (long long)(t0 + q) * st.C_s + n]) : 0.f;
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
          q < Q && t0 + q < S ? to_f32(Bm[b * st.B_b + (long long)(t0 + q) * st.B_s + n]) : 0.f;
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
                    ? to_f32(x[b * st.x_b + (long long)(t0 + q) * st.x_s + (h0 + hg) * st.x_h + p])
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
      T* row = y + b * st.y_b + (long long)(t0 + s) * st.y_s + (h0 + hg) * st.y_h;
#pragma unroll
      for (int j = 0; j < kJ; ++j) store(row + tx + 16 * j, acc[hg][i][j] + off[i][j] * e);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, void* y, float* final_state, float* states, float* decay,
                   int B, int S, int H, int N, int Q, const Strides& st, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  chunk_state_kernel<T, P><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      xt, dt, A, bt, states, decay, S, H, N, Q, nc, st);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  state_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
      states, decay, final_state, H, P * N, nc);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  // opt in above 48 KB of dynamic shared memory, once per instance
  static bool ready = false;
  constexpr size_t smem = out_smem_bytes<P>();
  if (!ready) {
    rc = cudaFuncSetAttribute(chunk_out_kernel<T, P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
    ready = true;
  }
  const int row_tiles = (Q + kTile - 1) / kTile;
  chunk_out_kernel<T, P><<<dim3(nc * row_tiles, (H + kHeads - 1) / kHeads, B), kThreads, smem,
                           stream>>>(xt, dt, A, bt, static_cast<const T*>(Cm), states,
                                     static_cast<T*>(y), S, H, N, Q, nc, row_tiles, st);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it; dt and
// A are float32). Strides are in elements. `states` (B, nc, H, P, N) and
// `decay` (B, nc, H) are float32 scratch with nc = ceil(S / Q). Takes
// P in {32, 64}, 1 <= N <= 128, 1 <= Q <= 256. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* final_state, void* states, void* decay,
                        int B, int S, int H, int P, int N, int Q, long long x_b, long long x_s,
                        long long x_h, long long dt_b, long long dt_s, long long dt_h,
                        long long B_b, long long B_s, long long C_b, long long C_s,
                        long long y_b, long long y_s, long long y_h, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, C_b, C_s, y_b, y_s, y_h};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* fin = static_cast<float*>(final_state);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64)
    return dtype == 0 ? launch<float, 64>(x, dtf, Af, Bm, Cm, y, fin, sts, dec, B, S, H, N, Q, st, s)
                      : launch<__nv_bfloat16, 64>(x, dtf, Af, Bm, Cm, y, fin, sts, dec, B, S, H,
                                                  N, Q, st, s);
  if (P == 32)
    return dtype == 0 ? launch<float, 32>(x, dtf, Af, Bm, Cm, y, fin, sts, dec, B, S, H, N, Q, st, s)
                      : launch<__nv_bfloat16, 32>(x, dtf, Af, Bm, Cm, y, fin, sts, dec, B, S, H,
                                                  N, Q, st, s);
  return cudaErrorInvalidValue;
}
