// gather_reduce.cuh — the gather-reduce kernel body shared by K4
// (spmm/csrc/spmm_ell.cu) and K5 (embed_bag/csrc/embedding_bag.cu):
//
//   out[i, f] = agg over live slots k of src[clamp(idx[i,k], 0, S-1), f]
//
// A slot is live where mask[i,k] is set (MASKED, K4: a dead slot's index is
// never used) or where idx[i,k] >= 0 (!MASKED, K5: -1 marks padding).  A
// live index past [0, S) is clamped into it, as the plain versions clamp.
// agg sum / mean / max over src in f32 or bf16, accumulated in f32 over k
// in index order 0..K-1 with round-to-nearest adds and rounded once at the
// store (__float2bfloat16_rn, round to nearest even); mean = sum /
// max(count, 1) in f32; max starts from -FLT_MAX (finfo(f32).min), keeps a
// NaN once it meets one, and a row with no live slot stores 0.  So each
// kernel is bit-identical to its plain version.
//
// Design: one group of LANES threads per (row, chunk of LANES * FPT
// features); lane j loads features f0 + j + t * LANES, so neighbouring
// threads read neighbouring features of the same gathered row.  Narrow
// rows (F <= 32) take LANES = max(4, next_pow2(F)) lanes of one feature
// each, wider ones FPT = 4 features a lane on 16 or 32 lanes.  A row's
// slots are walked by one group, in index order (splitting them over
// groups would change the f32 summation order), so the design keeps many
// loads in flight inside the group:
//  * indices ahead of rows: the group loads a window of W = max(LANES, U)
//    slots' mask and index at once (coalesced, W / LANES per lane), and the
//    next window's while it works on this one; a dead slot is decided from
//    them, and U slots dead in every group of the warp cost no row load;
//  * U rows in flight: the clamped indices of the next U slots are
//    shuffled out, all their row loads are issued into registers (without
//    branches: a dead slot reads row 0, never added), and only then are
//    they added, in index order (U * FPT values a thread: U = 32 rows for
//    narrow rows, so a 100-slot DIN bag takes 4 steps of one load latency,
//    and U = 8 for wide ones);
//  * a grid that covers the card: the block size falls from 256 to 32
//    threads until the launch has two blocks per SM, so DIN's serve_p99
//    (512 bags of one warp) spreads over all 132 SMs.
// One launch on the caller's stream, no shared memory, no atomics, no
// allocation; any R, K, F.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace gather_reduce {

constexpr int kMaxThreads = 256;
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

// This lane's IPL slots of the window at k0 (slots k0 + lane + i * LANES):
// the clamped row index of a live slot, -1 for a dead one or one past k.
template <int LANES, int IPL, bool MASKED>
__device__ __forceinline__ void window(const int* __restrict__ idx,
                                       const unsigned char* __restrict__ mask,
                                       bool in, long long base, int k0,
                                       int lane, int k, int s,
                                       int (&nb)[IPL]) {
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const int j = k0 + lane + i * LANES;
    nb[i] = -1;
    if (in && j < k) {
      const int x = __ldg(idx + base + j);
      const bool live = MASKED ? __ldg(mask + base + j) != 0 : x >= 0;
      if (live) nb[i] = min(max(x, 0), s - 1);
    }
  }
}

template <typename T, int AGG, int LANES, int FPT, int U, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
kernel(const T* __restrict__ src, const int* __restrict__ idx,
       const unsigned char* __restrict__ mask, T* __restrict__ out,
       long long rows, int k, int f, int s, int chunks) {
  constexpr int W = LANES > U ? LANES : U;  // slots per index window
  constexpr int IPL = W / LANES;            // of them per lane
  const long long group =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      LANES;
  const int lane = threadIdx.x % LANES;
  const long long row = group / chunks;
  const int f0 = static_cast<int>(group % chunks) * (LANES * FPT) + lane;
  const bool in = row < rows;
  const long long base = row * k;
  bool fok[FPT];
  float acc[FPT];
#pragma unroll
  for (int t = 0; t < FPT; ++t) {
    fok[t] = f0 + t * LANES < f;
    acc[t] = AGG == kMax ? -FLT_MAX : 0.0f;
  }
  int count = 0;
  int cur[IPL], nxt[IPL];
  window<LANES, IPL, MASKED>(idx, mask, in, base, 0, lane, k, s, cur);
  // every thread of the warp runs the same trip counts (k is uniform and
  // rows past the end take part with no live slot), so the full mask is
  // exact for the shuffles
  for (int k0 = 0; k0 < k; k0 += W) {
    window<LANES, IPL, MASKED>(idx, mask, in, base, k0 + W, lane, k, s, nxt);
#pragma unroll
    for (int j0 = 0; j0 < W; j0 += U) {
      if (k0 + j0 >= k) break;
      int nb[U];
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        nb[u] = __shfl_sync(0xffffffffu, cur[(j0 + u) / LANES],
                            (j0 + u) % LANES, LANES);
        any |= nb[u] >= 0;
      }
      if (!__any_sync(0xffffffffu, any)) continue;  // e.g. a padding tail
      // unconditional loads, so all U * FPT issue before the first add:
      // a dead slot reads row 0 and a feature past F the row's last one
      // (cached lines), and neither is added
      float v[U][FPT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* row_src = src + static_cast<long long>(max(nb[u], 0)) * f;
#pragma unroll
        for (int t = 0; t < FPT; ++t)
          v[u][t] = load(row_src + min(f0 + t * LANES, f - 1));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (nb[u] < 0) continue;
        ++count;
#pragma unroll
        for (int t = 0; t < FPT; ++t) {
          if (!fok[t]) continue;
          if (AGG == kMax) {
            if (!isnan(acc[t]) && (isnan(v[u][t]) || acc[t] < v[u][t]))
              acc[t] = v[u][t];
          } else {
            acc[t] = __fadd_rn(acc[t], v[u][t]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IPL; ++i) cur[i] = nxt[i];
  }
  if (!in) return;
  T* dst = out + row * f;
#pragma unroll
  for (int t = 0; t < FPT; ++t) {
    if (!fok[t]) continue;
    float v = acc[t];
    if (AGG == kMean) v = __fdiv_rn(v, static_cast<float>(max(count, 1)));
    if (AGG == kMax && count == 0) v = 0.0f;
    store(dst + f0 + t * LANES, v);
  }
}

// Threads per block: the largest of 256, 128, 64, 32 that still gives the
// launch two blocks per SM (32 when even that does not).
inline int block_threads(long long threads) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  int block = kMaxThreads;
  while (block > 32 && (threads + block - 1) / block < 2LL * sms) block >>= 1;
  return block;
}

// A group of LANES lanes, FPT features a lane, U rows in flight.
template <typename T, int AGG, int LANES, int FPT, int U, bool MASKED>
cudaError_t launch_lanes(const void* src, const int* idx,
                         const unsigned char* mask, void* out,
                         long long rows, int k, int f, int s,
                         cudaStream_t stream) {
  const int chunks = (f + LANES * FPT - 1) / (LANES * FPT);
  const long long threads = rows * chunks * LANES;
  const int block = block_threads(threads);
  const long long blocks = (threads + block - 1) / block;
  kernel<T, AGG, LANES, FPT, U, MASKED>
      <<<static_cast<unsigned>(blocks), block, 0, stream>>>(
          static_cast<const T*>(src), idx, mask, static_cast<T*>(out), rows,
          k, f, s, chunks);
  return cudaGetLastError();
}

// Narrow rows (F <= 32, DIN's D = 18) take one feature a lane and 32 rows
// in flight; wider ones four features a lane and 8 rows.
template <typename T, int AGG, bool MASKED>
cudaError_t by_lanes(const void* src, const int* idx,
                     const unsigned char* mask, void* out, long long rows,
                     int k, int f, int s, cudaStream_t st) {
  if (f <= 4)
    return launch_lanes<T, AGG, 4, 1, 32, MASKED>(src, idx, mask, out, rows,
                                                  k, f, s, st);
  if (f <= 8)
    return launch_lanes<T, AGG, 8, 1, 32, MASKED>(src, idx, mask, out, rows,
                                                  k, f, s, st);
  if (f <= 16)
    return launch_lanes<T, AGG, 16, 1, 32, MASKED>(src, idx, mask, out, rows,
                                                   k, f, s, st);
  if (f <= 32)
    return launch_lanes<T, AGG, 32, 1, 32, MASKED>(src, idx, mask, out, rows,
                                                   k, f, s, st);
  if (f <= 64)
    return launch_lanes<T, AGG, 16, 4, 8, MASKED>(src, idx, mask, out, rows,
                                                  k, f, s, st);
  return launch_lanes<T, AGG, 32, 4, 8, MASKED>(src, idx, mask, out, rows, k,
                                                f, s, st);
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
