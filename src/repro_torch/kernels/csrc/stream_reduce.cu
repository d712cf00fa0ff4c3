// Stream-reduce kernels for Hopper (sm_90a): the reducer group's chunk
// fold and the keyed histogram.
//
// chunk_accumulate replaces the TPU kernel `chunk_accumulate` (body
// `_acc_kernel`) in src/repro/kernels/stream_reduce/stream_reduce.py:
// (n, S) f32 or bf16 -> (S,) f32, out[j] = sum_k x[k, j], the sum starting
// at 0 and adding rows k = 0..n-1 in order, as the TPU kernel's grid walks
// them. With n = 2, as the stream channel calls it (accumulator stacked on
// the wave's staged chunks), the result is bit for bit acc + staged.
//
// Bound: bytes. One add per element read: (n + 1) * S * 4 bytes for f32
// input, ~1.67 ms at (2, 465,567,744) and 3.35 TB/s. The TPU kernel walks
// a sequential grid of (tile, chunk) with the sum in VMEM scratch. Here
// nothing carries over between blocks: each thread owns whole columns and
// keeps their sums in registers over the loop on k, so the columns need no
// cross-block reduction. A grid-stride loop over groups of columns feeds
// 16-byte loads (float4 for f32, 8 bf16) when S and the base pointer allow
// it; a scalar pass takes the ragged tail and the unaligned case.
//
// histogram replaces the TPU kernel `histogram` (body `_hist_kernel`) in
// the same file: keys (N,) int32, counts (N,) f32 or bf16 -> (n_bins,) f32,
// out[b] = sum of counts[i] over keys[i] == b. Negative keys are padding;
// keys >= n_bins are dropped, as the TPU kernel's one-hot drops them.
// The TPU has no scatter atomics and contracts a one-hot on the MXU; on
// Hopper the natural form is atomics. Bound: bytes, N * 8 read and
// n_bins * 4 written. With n_bins that fit a block's shared memory each
// block builds a private histogram with shared-memory atomics and merges
// it into the output with one global atomic per nonzero bin; past that
// (151,936 bins is 594 KB) every element goes to a global atomic. The
// output must be zeroed by the caller (the wrapper allocates it so).
// Atomics reorder the sums, so the result matches a sequential sum to
// f32 rounding only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16-byte vector of T: 4 f32 or 8 bf16 columns per load
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// vectorised columns [0, n_vec * kN): each thread sums its columns over k
template <typename T>
__global__ void __launch_bounds__(kThreads) accumulate_vec_kernel(
    const T* __restrict__ x, long long S, int n, long long n_vec, float* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < n_vec;
       v += stride) {
    const long long col = v * kN;
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
    for (int k = 0; k < n; ++k) {
      float row[kN];
      Vec<T>::load(x + static_cast<long long>(k) * S + col, row);
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] += row[i];
    }
    float4* o = reinterpret_cast<float4*>(out + col);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) o[i] = make_float4(acc[4 * i], acc[4 * i + 1],
                                                      acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// scalar columns [col0, S)
template <typename T>
__global__ void __launch_bounds__(kThreads) accumulate_scalar_kernel(
    const T* __restrict__ x, long long S, int n, long long col0, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = col0 + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       col < S; col += stride) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc += to_f32(x[static_cast<long long>(k) * S + col]);
    out[col] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) histogram_shared_kernel(
    const int* __restrict__ keys, const T* __restrict__ counts, long long N, int n_bins,
    float* __restrict__ out) {
  extern __shared__ float hist[];
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0.0f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < N;
       i += stride) {
    const int key = keys[i];
    if (key >= 0 && key < n_bins) atomicAdd(&hist[key], to_f32(counts[i]));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    const float h = hist[b];
    if (h != 0.0f) atomicAdd(&out[b], h);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) histogram_global_kernel(
    const int* __restrict__ keys, const T* __restrict__ counts, long long N, int n_bins,
    float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < N;
       i += stride) {
    const int key = keys[i];
    if (key >= 0 && key < n_bins) atomicAdd(&out[key], to_f32(counts[i]));
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// enough blocks to fill the card several times over, no more than the work
int grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int accumulate_launch(const void* x, long long S, int n, void* out, cudaStream_t s) {
  constexpr int kN = Vec<T>::kN;
  const T* xp = static_cast<const T*>(x);
  float* op = static_cast<float*>(out);
  // rows stay 16-byte aligned when S is a multiple of the vector width
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (S % kN == 0);
  long long n_vec = aligned ? S / kN : 0;
  if (n_vec > 0) {
    accumulate_vec_kernel<T><<<grid_for(n_vec), kThreads, 0, s>>>(xp, S, n, n_vec, op);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long col0 = n_vec * kN;
  if (col0 < S) {
    accumulate_scalar_kernel<T><<<grid_for(S - col0), kThreads, 0, s>>>(xp, S, n, col0, op);
  }
  return cudaGetLastError();
}

constexpr int kMaxSharedBins = 48 * 1024 / 4;  // static limit, no opt-in needed

template <typename T>
int histogram_launch(const int* keys, const void* counts, long long N, int n_bins, void* out,
                     cudaStream_t s) {
  const T* cp = static_cast<const T*>(counts);
  float* op = static_cast<float*>(out);
  if (N == 0) return 0;
  if (n_bins <= kMaxSharedBins) {
    histogram_shared_kernel<T><<<grid_for(N), kThreads, n_bins * sizeof(float), s>>>(
        keys, cp, N, n_bins, op);
  } else {
    histogram_global_kernel<T><<<grid_for(N), kThreads, 0, s>>>(keys, cp, N, n_bins, op);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError().
extern "C" int chunk_accumulate(const void* x, long long S, int n, int dtype, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) return 0;
  if (n <= 0 || S < 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return accumulate_launch<float>(x, S, n, out, s);
    case 1: return accumulate_launch<__nv_bfloat16>(x, S, n, out, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int keyed_histogram(const void* keys, const void* counts, long long N, int n_bins,
                               int dtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0 || N < 0) return cudaErrorInvalidValue;
  const int* kp = static_cast<const int*>(keys);
  switch (dtype) {
    case 0: return histogram_launch<float>(kp, counts, N, n_bins, out, s);
    case 1: return histogram_launch<__nv_bfloat16>(kp, counts, N, n_bins, out, s);
    default: return cudaErrorInvalidValue;
  }
}
