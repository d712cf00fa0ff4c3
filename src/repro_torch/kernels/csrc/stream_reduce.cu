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
// Hopper the natural form is atomics. Bound: bytes, N * (4 + 4 or 2) read
// and n_bins * 4 written (~0.16 ms for 2^26 keys and f32 counts). What
// stands in its way is contention: Zipf-distributed word ids send a
// quarter of all keys to one bin, whose atomics serialise. So:
//   * a persistent grid walks the keys in groups of 8 per thread (16-byte
//     loads of keys and counts; a scalar pass takes the unaligned head
//     and the tail);
//   * before any atomic, `__match_any_sync` groups a warp's equal keys, the
//     group's counts are summed by pointer jumping over its lanes, and its
//     lowest lane issues one atomic. The match costs more than an atomic
//     that meets no contention, so a warp keeps matching only while its
//     keys repeat (it checks again at the first key of every group of 8);
//   * where the bins live comes from n_bins alone (`histogram_plan` in
//     kernels/stream_reduce/stream_reduce.py). "block": all of them in one
//     block's dynamic shared memory (opt-in up to 227 KB, 58,112 bins),
//     merged into the output after a block barrier with one global atomic
//     per nonzero bin. Past that, "global": adds go to the output, behind
//     a per-block cache of keys in shared memory (8,192 hashed slots,
//     claimed by the first key to reach them, flushed at the end), so that
//     the hottest bins sum inside the SM whatever their ids are.
// Bins spread over a thread block cluster's distributed shared memory are
// no middle path here: float atomics on shared memory are compare-and-swap
// loops on this card (ATOMS.CAST.SPIN, and ATOM.E.CAST.SPIN into another
// CTA), so remote adds spin on hot bins and trail L2's native float
// atomics on cold ones (PERF.md).
// Every path only adds into the output (atomics, the cache flush too): the
// caller passes zeros for a fresh histogram, or an accumulator to fold into
// (the wrapper's `out=`, one launch per arriving stream element).
// Atomics reorder the sums, so the result matches a sequential sum to f32
// rounding only; counts of 1 sum exactly while a bin stays under 2^24.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// -- histogram ----------------------------------------------------------------

constexpr int kHistThreads = 512;
constexpr int kGroup = 8;         // keys a thread loads at once: two 16-byte loads
constexpr int kSmemMax = 232448;  // 227 KB, the most one block may opt in to
constexpr int kCacheLog2 = 13;    // the global path's cache: 8,192 slots of (key, sum)
constexpr int kCacheSlots = 1 << kCacheLog2;
enum HistPath { kBlock = 0, kGlobal = 1 };  // the plan's paths

// Where a warp's counts go: add() takes the sum of a key's lanes after
// aggregation, add_one() one lane's count from a warp whose keys did not
// repeat (no lane of the warp holds that key but this one).
// Block: this block's shared bins, all of them.
struct BlockBins {
  float* bins;
  __device__ void add(int key, float v) const { atomicAdd(bins + key, v); }
  __device__ void add_one(int key, float v) const { add(key, v); }
};
// Global: the output, behind a cache of the block's keys in shared memory.
// A key hashes to one slot; the first key to reach a free slot claims it
// (an integer CAS, native in shared memory), and from then on that key's
// counts sum in the slot. Any other key adds to the output. Frequent keys
// claim their slots early, so their atomics stay inside the SM; a claimed
// slot costs one global atomic at the end, as its key's add would have.
// (Letting only keys that repeat within a warp claim slots sends warm keys,
// which mostly come one to a warp, to L2 atomics on a few hot lines.) Keys
// from a warp in which none repeats are spread thin: they skip the cache.
struct GlobalBins {
  float* out;
  int* slot_key;  // -1: free
  float* slot_sum;
  __device__ void add(int key, float v) const {
    const unsigned slot = (static_cast<unsigned>(key) * 2654435761u) >> (32 - kCacheLog2);
    int owner = *static_cast<volatile int*>(slot_key + slot);
    if (owner < 0) {
      owner = atomicCAS(slot_key + slot, -1, key);
      if (owner < 0) owner = key;
    }
    if (owner == key) {
      atomicAdd(slot_sum + slot, v);
    } else {
      atomicAdd(out + key, v);
    }
  }
  __device__ void add_one(int key, float v) const { atomicAdd(out + key, v); }
};

// Adds each lane's v to bin `key` (-1: nothing). Lanes holding one key are
// summed first, by pointer jumping down the list of those lanes in lane
// order (afterwards each lane holds its own count plus those of every later
// lane of its key), and the lowest of them issues the key's one atomic.
// Every lane of the warp calls it; it returns, to every lane, whether any
// key repeated within the warp.
template <class Bins>
__device__ __forceinline__ bool warp_add(const Bins& bins, int key, float v) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  // the next lane of this key, or -1 (always -1 for lanes that add nothing)
  int next = key >= 0 ? __ffs(peers & (0xfffffffeu << lane)) - 1 : -1;
  while (__any_sync(0xffffffffu, next >= 0)) {
    const int src = next >= 0 ? next : static_cast<int>(lane);
    const float ov = __shfl_sync(0xffffffffu, v, src);
    const int on = __shfl_sync(0xffffffffu, next, src);
    if (next >= 0) {
      v += ov;
      next = on;
    }
  }
  if (key >= 0 && (peers & ((1u << lane) - 1)) == 0) bins.add(key, v);
  return __any_sync(0xffffffffu, key >= 0 && peers != (1u << lane));
}

// Every key of the grid's share: groups of 8 from element `head` on, by
// 16-byte loads, then the scalar rest (elements [0, head) and past the last
// group). Every lane of a warp runs the same iterations; a lane past the end
// adds nothing. Keys outside [0, n_bins) add nothing. The match that
// aggregates costs far more than an atomic that meets no contention, so a
// warp matches the first key of each group, and the others only while its
// last match found a repeated key: always under skewed keys, rarely where
// keys are spread thin. The choice is the warp's own (a vote), never a
// lane's, and changes only how the same sums are grouped.
template <typename T, class Bins>
__device__ void walk_keys(const Bins& bins, const int* __restrict__ keys,
                          const T* __restrict__ counts, long long N, int head,
                          long long n_groups, int n_bins) {
  const auto valid = [n_bins](int key) {
    return static_cast<unsigned>(key) < static_cast<unsigned>(n_bins) ? key : -1;
  };
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kHistThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kHistThreads / 32);
  const int4* kv = reinterpret_cast<const int4*>(keys + head);
  const T* cp = counts + head;
  // one group per lane: its 8 keys and counts, or nothing past the end
  const auto load = [&](long long g, int* k, float* c) {
    if (g < n_groups) {
      const int4 a = kv[2 * g];
      const int4 b = kv[2 * g + 1];
      k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
      k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
#pragma unroll
      for (int h = 0; h < kGroup / Vec<T>::kN; ++h) {
        Vec<T>::load(cp + g * kGroup + h * Vec<T>::kN, c + h * Vec<T>::kN);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        k[e] = -1;
        c[e] = 0.0f;
      }
    }
  };
  // the next group's loads are in flight while this one is aggregated
  int k[kGroup], nk[kGroup];
  float c[kGroup], nc[kGroup];
  bool repeats = true;  // whether the warp's last match found a repeated key
  load(warp * 32 + lane, k, c);
  for (long long g0 = warp * 32; g0 < n_groups; g0 += warps * 32) {
    load(g0 + warps * 32 + lane, nk, nc);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const int key = valid(k[e]);
      if (e == 0 || repeats) {
        repeats = warp_add(bins, key, c[e]);
      } else if (key >= 0) {
        bins.add_one(key, c[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      k[e] = nk[e];
      c[e] = nc[e];
    }
  }
  const long long tail = head + n_groups * kGroup;
  const long long n_rest = head + (N - tail);
  for (long long j0 = warp * 32; j0 < n_rest; j0 += warps * 32) {
    const long long j = j0 + lane;
    int key = -1;
    float count = 0.0f;
    if (j < n_rest) {
      const long long i = j < head ? j : tail + (j - head);
      key = keys[i];
      count = to_f32(counts[i]);
    }
    warp_add(bins, valid(key), count);
  }
}

template <typename T, int kPath>
__global__ void __launch_bounds__(kHistThreads) histogram_kernel(
    const int* __restrict__ keys, const T* __restrict__ counts, long long N, int head,
    long long n_groups, int n_bins, int block_bins, float* __restrict__ out) {
  extern __shared__ float4 priv[];
  float* shared = reinterpret_cast<float*>(priv);
  if constexpr (kPath == kGlobal) {
    int* slot_key = reinterpret_cast<int*>(priv);
    float* slot_sum = shared + kCacheSlots;
    for (int i = threadIdx.x; i < kCacheSlots; i += kHistThreads) {
      slot_key[i] = -1;
      slot_sum[i] = 0.0f;
    }
    __syncthreads();
    walk_keys(GlobalBins{out, slot_key, slot_sum}, keys, counts, N, head, n_groups, n_bins);
    __syncthreads();
    for (int i = threadIdx.x; i < kCacheSlots; i += kHistThreads) {
      const int key = slot_key[i];
      const float sum = slot_sum[i];
      if (key >= 0 && sum != 0.0f) atomicAdd(out + key, sum);
    }
  } else {
    // this block's bins: zeroed, filled, then merged once into the output
    for (int i = threadIdx.x; i < block_bins / 4; i += kHistThreads) {
      priv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    walk_keys(BlockBins{shared}, keys, counts, N, head, n_groups, n_bins);
    __syncthreads();
    for (int i = threadIdx.x; i < block_bins / 4; i += kHistThreads) {
      const float4 h4 = priv[i];
      const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 4 * i + e;
        if (h[e] != 0.0f && b < n_bins) atomicAdd(out + b, h[e]);
      }
    }
  }
}

template <typename T, int kPath>
int histogram_path_launch(const int* keys, const T* counts, long long N, int n_bins,
                          int block_bins, float* out, cudaStream_t s) {
  auto kernel = histogram_kernel<T, kPath>;
  // the first element at which keys and counts are both 16-byte aligned;
  // none within a group (views at an odd offset from each other): all scalar
  int head = -1;
  for (int h = 0; h < kGroup && h < N && head < 0; ++h) {
    if (reinterpret_cast<uintptr_t>(keys + h) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(counts + h) % 16 == 0) {
      head = h;
    }
  }
  const long long n_groups = head < 0 ? 0 : (N - head) / kGroup;
  head = std::max(head, 0);
  // shared memory a block holds, and the bins (or cache slots) it merges once
  const int held = kPath == kGlobal ? kCacheSlots : block_bins;
  const int smem = kPath == kGlobal ? 2 * 4 * kCacheSlots : 4 * block_bins;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: as many blocks as the card runs at once, and no more
  // than one per its own bins' worth of keys (twice that on the block path,
  // which merges every bin it holds), since each block merges what it holds
  // once
  int units = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&units, kernel, kHistThreads, smem);
  if (err != cudaSuccess) return err;
  if (units == 0) return cudaErrorLaunchOutOfResources;
  units *= sm_count();
  const long long per_unit =
      std::max<long long>(kHistThreads * kGroup, (kPath == kBlock ? 2LL : 1LL) * held);
  const long long by_work = std::max<long long>(1, (N + per_unit - 1) / per_unit);
  const unsigned grid = static_cast<unsigned>(std::min<long long>(units, by_work));
  kernel<<<grid, kHistThreads, smem, s>>>(keys, counts, N, head, n_groups, n_bins, block_bins,
                                          out);
  return cudaGetLastError();
}

template <typename T>
int histogram_launch(const int* keys, const T* counts, long long N, int n_bins, int path,
                     int block_bins, float* out, cudaStream_t s) {
  return path == kBlock
             ? histogram_path_launch<T, kBlock>(keys, counts, N, n_bins, block_bins, out, s)
             : histogram_path_launch<T, kGlobal>(keys, counts, N, n_bins, 0, out, s);
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

// (path, block_bins) is the wrapper's `histogram_plan`: path 0 = block, 1 =
// global; block_bins the bins the block path holds (0 on the global path).
// The plan is checked, never replaced.
extern "C" int keyed_histogram(const void* keys, const void* counts, long long N, int n_bins,
                               int dtype, int path, int block_bins, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0 || N < 0) return cudaErrorInvalidValue;
  const bool ok = path == kBlock ? block_bins % 4 == 0 && block_bins >= n_bins &&
                                       block_bins - 4 < n_bins &&
                                       static_cast<long long>(block_bins) * 4 <= kSmemMax
                                 : path == kGlobal && block_bins == 0;
  if (!ok) return cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int* kp = static_cast<const int*>(keys);
  float* op = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return histogram_launch<float>(kp, static_cast<const float*>(counts), N, n_bins, path,
                                     block_bins, op, s);
    case 1:
      return histogram_launch<__nv_bfloat16>(kp, static_cast<const __nv_bfloat16*>(counts), N,
                                             n_bins, path, block_bins, op, s);
    default:
      return cudaErrorInvalidValue;
  }
}
