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
// axis, carrying (max, first index) in scratch. Here one thread block owns
// one row: each thread keeps its own (max, index) over a strided walk,
// then a warp-shuffle and shared-memory reduction merges the candidates,
// preferring the lower index on ties. Rows may be strided (the last
// position of a (B, S, V) logits tensor), so nothing is copied first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// true if candidate (v, i) beats the current best (bv, bi)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) argmax_last_kernel(
    const T* __restrict__ x, long long row_stride, int vocab, int* __restrict__ out) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const T* row = x + static_cast<long long>(blockIdx.x) * row_stride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float best = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    const float v = to_f32(row[i]);
    if (better(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (better(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? sv[lane] : -INFINITY;
    bi = lane < kWarps ? si[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (better(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[blockIdx.x] = bi;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int argmax_last(const void* x, long long row_stride, int B, int vocab, int dtype,
                           void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (vocab <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      argmax_last_kernel<float><<<B, kThreads, 0, s>>>(static_cast<const float*>(x), row_stride,
                                                      vocab, static_cast<int*>(out));
      break;
    case 1:
      argmax_last_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), row_stride, vocab, static_cast<int*>(out));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
