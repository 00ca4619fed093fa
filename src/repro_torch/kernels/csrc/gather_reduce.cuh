// gather_reduce.cuh — the gather-reduce kernel body shared by K4
// (spmm/csrc/spmm_ell.cu) and K5 (embed_bag/csrc/embedding_bag.cu):
//
//   out[i, f] = agg over live slots k of src[clamp(idx[i,k], 0, S-1), f]
//
// A slot is live where mask[i,k] is set (MASKED, K4: a dead slot's index is
// never read) or where idx[i,k] >= 0 (!MASKED, K5: -1 marks padding).  A
// live index past [0, S) is clamped into it, as the plain versions clamp.
// agg sum / mean / max over src in f32 or bf16, accumulated in f32 over k
// in index order 0..K-1 with round-to-nearest adds and rounded once at the
// store (__float2bfloat16_rn, round to nearest even); mean = sum /
// max(count, 1) in f32; max starts from -FLT_MAX (finfo(f32).min), keeps a
// NaN once it meets one, and a row with no live slot stores 0.  So each
// kernel is bit-identical to its plain version.
//
// Design: one group of LANES = min(32, next_pow2(ceil(F / kFpt))) threads
// per (row, chunk of LANES * kFpt features).  Lane j of the group loads slot
// k0 + j (mask and index, coalesced, once) and the group broadcasts each
// slot's clamped index, or -1 for a dead slot, with one shuffle; for a live
// slot every lane loads kFpt features strided by LANES, so neighbouring
// threads read neighbouring features of the same gathered row.  No shared
// memory, no atomics; any R, K, F.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace gather_reduce {

constexpr int kThreads = 256;
constexpr int kFpt = 4;  // features per thread per chunk
enum Agg { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int AGG, int LANES, bool MASKED>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ src, const int* __restrict__ idx,
       const unsigned char* __restrict__ mask, T* __restrict__ out,
       long long rows, int k, int f, int s, int chunks) {
  const long long group =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  const long long row = group / chunks;
  const int f0 = static_cast<int>(group % chunks) * (LANES * kFpt) + lane;
  const bool in = row < rows;
  const long long base = row * k;
  float acc[kFpt];
#pragma unroll
  for (int t = 0; t < kFpt; ++t) acc[t] = AGG == kMax ? -FLT_MAX : 0.0f;
  int count = 0;
  // every thread of the warp runs the same trip counts (k is uniform and
  // rows past the end take part with no live slot), so the full mask is
  // exact for the shuffles
  for (int k0 = 0; k0 < k; k0 += LANES) {
    int my_nb = -1;  // this lane's slot: its clamped index, -1 if dead
    if (in && k0 + lane < k) {
      const long long c = base + k0 + lane;
      if (MASKED) {
        if (__ldg(mask + c)) my_nb = min(max(__ldg(idx + c), 0), s - 1);
      } else {
        const int nb = __ldg(idx + c);
        if (nb >= 0) my_nb = min(nb, s - 1);
      }
    }
    const int n = min(LANES, k - k0);
    for (int j = 0; j < n; ++j) {
      const int nb = __shfl_sync(0xffffffffu, my_nb, j, LANES);
      if (nb < 0) continue;
      ++count;
      const T* row_src = src + static_cast<long long>(nb) * f;
#pragma unroll
      for (int t = 0; t < kFpt; ++t) {
        const int fi = f0 + t * LANES;
        if (fi >= f) break;
        const float v = load(row_src + fi);
        if (AGG == kMax) {
          if (!isnan(acc[t]) && (isnan(v) || acc[t] < v)) acc[t] = v;
        } else {
          acc[t] = __fadd_rn(acc[t], v);
        }
      }
    }
  }
  if (!in) return;
  T* dst = out + row * f;
#pragma unroll
  for (int t = 0; t < kFpt; ++t) {
    const int fi = f0 + t * LANES;
    if (fi >= f) break;
    float v = acc[t];
    if (AGG == kMean) v = __fdiv_rn(v, static_cast<float>(max(count, 1)));
    if (AGG == kMax && count == 0) v = 0.0f;
    store(dst + fi, v);
  }
}

template <typename T, int AGG, bool MASKED>
cudaError_t by_lanes(const void* src, const int* idx,
                     const unsigned char* mask, void* out, long long rows,
                     int k, int f, int s, cudaStream_t stream) {
  const int need = (f + kFpt - 1) / kFpt;  // threads that cover F at once
  const int lanes = need <= 4 ? 4 : need <= 8 ? 8 : need <= 16 ? 16 : 32;
  const int chunks = (f + lanes * kFpt - 1) / (lanes * kFpt);
  const long long blocks = (rows * chunks * lanes + kThreads - 1) / kThreads;
  void (*body)(const T*, const int*, const unsigned char*, T*, long long, int,
               int, int, int) =
      lanes == 4   ? kernel<T, AGG, 4, MASKED>
      : lanes == 8 ? kernel<T, AGG, 8, MASKED>
      : lanes == 16 ? kernel<T, AGG, 16, MASKED>
                    : kernel<T, AGG, 32, MASKED>;
  body<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(src), idx, mask, static_cast<T*>(out), rows, k, f,
      s, chunks);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t by_agg(int agg, const void* src, const int* idx,
                   const unsigned char* mask, void* out, long long rows,
                   int k, int f, int s, cudaStream_t st) {
  switch (agg) {
    case kSum:
      return by_lanes<T, kSum, MASKED>(src, idx, mask, out, rows, k, f, s, st);
    case kMean:
      return by_lanes<T, kMean, MASKED>(src, idx, mask, out, rows, k, f, s, st);
    case kMax:
      return by_lanes<T, kMax, MASKED>(src, idx, mask, out, rows, k, f, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// One launch on `stream`; dtype 0 = f32, 1 = bf16 (src and out); agg 0 sum,
// 1 mean, 2 max.  Returns cudaGetLastError() (0 = launched).
template <bool MASKED>
int launch(const void* src, const int* idx, const unsigned char* mask,
           void* out, long long rows, int k, int f, int s, int agg, int dtype,
           void* stream) {
  if (rows <= 0 || k < 0 || f <= 0 || (s <= 0 && k > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = by_agg<float, MASKED>(agg, src, idx, mask, out, rows, k, f, s, st);
  else if (dtype == 1)
    err = by_agg<__nv_bfloat16, MASKED>(agg, src, idx, mask, out, rows, k, f,
                                        s, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace gather_reduce
