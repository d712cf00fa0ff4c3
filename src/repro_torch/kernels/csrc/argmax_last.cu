// Last-token argmax over the vocabulary for Hopper (sm_90a).
//
// Replaces the TPU kernel `argmax_last_kernel` (body `_kernel`) in
// src/repro/kernels/sample/sample.py: (B, V) logits -> (B,) int32, ties to
// the first maximal index, as jnp.argmax (and torch.argmax) break them.
// NaN counts as the largest value, as in both libraries.
//
// Bound: bytes. One compare per element read (B*V*2 bytes in bf16), so the
// least time is the row bytes over HBM bandwidth: ~0.15 us for 8 x 32000
// bf16 logits, well under the launch latency, which dominates.
//
// Design: the TPU kernel streams vocab chunks through a sequential grid
// axis, carrying (max, first index) in scratch. Here the grid is (splits,
// B): the wrapper cuts each row into spans (`argmax_split` in
// kernels/sample/sample.py, from shapes alone) so that B x splits blocks
// cover the SMs even when B is 1 or 2. A block reads its span in 16-byte
// vectors (8 bf16 or 4 f32 a load, kUnroll loads in flight per thread),
// with a scalar head and tail where the span does not start or end on a
// 16-byte boundary (odd V, the last position of (B, S, V) logits); each
// thread keeps its (value, first index), and warp shuffles and shared
// memory merge them by `better`. The block writes its pair to the row's
// partials; the row's last block to finish (a __threadfence() and an
// atomic ticket per row) merges all of them, ties to the lower index
// whatever the split, and writes the row's result. One launch per call and
// no host synchronisation, so the call can be captured in a CUDA graph.
//
// The tickets live in a scratch that the wrapper keeps for each (device,
// stream), zeroed once when it is allocated; the last block of a row
// resets the row's ticket to 0 before the kernel ends. Kernels on one
// stream run one after another, so no call can see a ticket of another
// call in flight, and calls on different streams hold different scratch
// (the wrapper keys it on the stream's handle, which stays one stream's
// while that stream lives; see `sample._SCRATCH`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// true if candidate (v, i) beats the current best (bv, bi)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

struct Best {
  float v;
  int i;
  __device__ void take(float ov, int oi) {
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
};

// 16-byte vector of T: 4 f32 or 8 bf16 elements
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ static void unpack(const float4& r, float* out) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ static void unpack(const uint4& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

// the block's best pair, valid in thread 0; every thread calls it
__device__ Best block_best(Best b) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    b.take(__shfl_down_sync(0xffffffffu, b.v, o), __shfl_down_sync(0xffffffffu, b.i, o));
  }
  if (lane == 0) {
    sv[warp] = b.v;
    si[warp] = b.i;
  }
  __syncthreads();
  if (warp == 0) {
    b.v = lane < kWarps ? sv[lane] : -INFINITY;
    b.i = lane < kWarps ? si[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      b.take(__shfl_down_sync(0xffffffffu, b.v, o), __shfl_down_sync(0xffffffffu, b.i, o));
    }
  }
  return b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) argmax_last_kernel(
    const T* __restrict__ x, long long row_stride, int vocab, int span,
    int2* __restrict__ partials, unsigned* __restrict__ tickets, int* __restrict__ out) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  __shared__ bool last_block;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int r = blockIdx.y;
  const T* row = x + static_cast<long long>(r) * row_stride;
  const int s0 = split * span;
  const int s1 = min(s0 + span, vocab);
  // elements before the first 16-byte boundary of the span, then whole
  // vectors, then the tail
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row + s0) % 16) / sizeof(T);
  const int v0 = s0 + min(mis ? kN - mis : 0, s1 - s0);
  const int n_vec = (s1 - v0) / kN;
  const int t0 = v0 + n_vec * kN;

  Best b{-INFINITY, INT_MAX};
  if (threadIdx.x < v0 - s0) b.take(to_f32(row[s0 + threadIdx.x]), s0 + threadIdx.x);
  if (threadIdx.x < s1 - t0) b.take(to_f32(row[t0 + threadIdx.x]), t0 + threadIdx.x);
  const typename V::Raw* vp = reinterpret_cast<const typename V::Raw*>(row + v0);
  for (int j0 = threadIdx.x; j0 < n_vec; j0 += kThreads * kUnroll) {
    typename V::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * kThreads < n_vec) raw[u] = __ldg(vp + j0 + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n_vec) {
        float f[kN];
        V::unpack(raw[u], f);
#pragma unroll
        for (int e = 0; e < kN; ++e) b.take(f[e], v0 + j * kN + e);
      }
    }
  }
  b = block_best(b);
  if (splits == 1) {
    if (threadIdx.x == 0) out[r] = b.i;
    return;
  }
  int2* row_partials = partials + static_cast<long long>(r) * splits;
  if (threadIdx.x == 0) {
    row_partials[split] = make_int2(__float_as_int(b.v), b.i);
    __threadfence();  // the pair is visible before the ticket counts it
    last_block = atomicAdd(&tickets[r], 1u) == static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  Best m{-INFINITY, INT_MAX};
  for (int j = threadIdx.x; j < splits; j += kThreads) {
    const int2 p = __ldcg(row_partials + j);  // from L2: written by other SMs
    m.take(__int_as_float(p.x), p.y);
  }
  m = block_best(m);
  if (threadIdx.x == 0) {
    out[r] = m.i;
    tickets[r] = 0;  // ready for the next call on this stream
  }
}

template <typename T>
void launch(const void* x, long long row_stride, int B, int vocab, int span, int splits,
            void* partials, void* tickets, void* out, cudaStream_t s) {
  argmax_last_kernel<T><<<dim3(splits, B), kThreads, 0, s>>>(
      static_cast<const T*>(x), row_stride, vocab, span, static_cast<int2*>(partials),
      static_cast<unsigned*>(tickets), static_cast<int*>(out));
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. (span, splits) is the wrapper's
// `argmax_split`; partials hold B x splits (value, index) pairs and
// tickets B zeroed counters (see above). Returns cudaGetLastError().
extern "C" int argmax_last(const void* x, long long row_stride, int B, int vocab, int dtype,
                           int span, int splits, void* partials, void* tickets, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (vocab <= 0 || B > 65535 || span <= 0 || span % 64 || splits != (vocab + span - 1) / span) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      launch<float>(x, row_stride, B, vocab, span, splits, partials, tickets, out, s);
      break;
    case 1:
      launch<__nv_bfloat16>(x, row_stride, B, vocab, span, splits, partials, tickets, out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
