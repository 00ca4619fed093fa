// lane_minor.cuh — S trees' offers interleaved lane-minor, and the
// segmented min of W keys per thread; shared by the lane forms of K1
// (ellpack_relax.cu) and K2 (fused_sliced_relax.cu).
//
// The layout: S trees over one shared layout gather the same vertex
// ids, so their offers are stored tree-minor,
//
//   offers_t[g][v][j] = offer of tree g·W + j at vertex v   (+inf past S)
//
// with W = group(S) in {1, 2, 4, 8} lanes a group and groups(S) =
// ceil(S / W) groups.  One 8-, 16- or 32-byte load at v then fetches the
// offers of every tree of a group: one gather request per live cell,
// where a tree-major (S, N) vector needs S.  interleave() makes the copy
// (reading 4·S·N bytes, writing 4·W·N per group), folding K2's active
// mask into it where one is given: offers_t = active ? dist : +inf.
// relax.py::lane_minor is the wrapper and ref.py::lane_minor_ref its
// plain version.
//
// reduce(): each thread holds W keys (one per lane of its group) and a
// segment of `width` threads (a row) needs each lane's min.  Instead of W
// butterflies of log2(width) steps, each step first halves the keys a
// thread holds (it keeps one half, its partner the other, and each takes
// the min with what the partner gave): W - 1 + log2(width / W) shuffled
// keys where W·log2(width) would do, 6 against 20 at W = 4 and a 32-wide
// row.  Afterwards a thread holds `count` lanes from `first` on, the same
// as every thread of its sub-segment of `rest` threads.

#pragma once

#include <cuda_runtime.h>

#include "minkey.cuh"

namespace lanes {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;   // the most lanes one gather serves

// Lanes a group: the smallest power of two >= S, at most kMaxGroup.
__host__ __device__ constexpr int group(int s) {
  return s <= 1 ? 1 : s <= 2 ? 2 : s <= 4 ? 4 : kMaxGroup;
}

__host__ __device__ constexpr int groups(int s) {
  return (s + group(s) - 1) / group(s);
}

// W consecutive floats at p (aligned to min(4W, 16) bytes).
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&o)[1]) {
  o[0] = __ldg(p);
}

__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&o)[2]) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(p));
  o[0] = x.x; o[1] = x.y;
}

__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&o)[8]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  o[4] = y.x; o[5] = y.y; o[6] = y.z; o[7] = y.w;
}

__device__ __forceinline__ void store(float* p, const float (&o)[1]) {
  p[0] = o[0];
}

__device__ __forceinline__ void store(float* p, const float (&o)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}

__device__ __forceinline__ void store(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// One thread per (vertex, group): W coalesced reads of the tree-major
// rows, one W-float store.
template <int W>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const float* __restrict__ src,
                  const unsigned char* __restrict__ active,
                  float* __restrict__ out, long long n, int s) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (v >= n) return;
  const int g = blockIdx.y;
  float o[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const long long t = static_cast<long long>(g) * W + j;
    float x = minkey::inf();
    if (t < s) {
      x = __ldg(src + t * n + v);
      if (active != nullptr && !__ldg(active + t * n + v)) x = minkey::inf();
    }
    o[j] = x;
  }
  store(out + (static_cast<long long>(g) * n + v) * W, o);
}

// Enqueue the interleave of s trees of n offers (tree-major, `active`
// null or of the same shape) into out[groups(s)][n][group(s)].
inline cudaError_t interleave(const float* src, const unsigned char* active,
                              float* out, long long n, int s,
                              cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups(s)));
  switch (group(s)) {
    case 1:
      interleave_kernel<1><<<grid, kThreads, 0, stream>>>(src, active, out,
                                                          n, s);
      break;
    case 2:
      interleave_kernel<2><<<grid, kThreads, 0, stream>>>(src, active, out,
                                                          n, s);
      break;
    case 4:
      interleave_kernel<4><<<grid, kThreads, 0, stream>>>(src, active, out,
                                                          n, s);
      break;
    default:
      interleave_kernel<8><<<grid, kThreads, 0, stream>>>(src, active, out,
                                                          n, s);
  }
  return cudaGetLastError();
}

// Which lanes a thread holds after reduce(): kv[0 .. count) are lanes
// first .. first + count - 1, equal on each `rest`-thread sub-segment.
struct Slot {
  int first, count, rest;
};

// Segmented min over `width` threads (a power of two <= 32, the same for
// every thread of the warp, so the full mask is exact) of each of the W
// keys a thread holds; `pos` is the thread's place in its segment.
template <int W>
__device__ __forceinline__ Slot reduce(unsigned long long (&kv)[W], int width,
                                       int pos) {
  Slot sl{0, W, width};
  int off = width >> 1;
#pragma unroll
  for (int h = W / 2; h >= 1; h >>= 1) {
    if (off > 0) {
      const bool upper = (pos & off) != 0;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const unsigned long long give = upper ? kv[j] : kv[j + h];
        const unsigned long long keep = upper ? kv[j + h] : kv[j];
        kv[j] = min(keep, __shfl_xor_sync(0xffffffffu, give, off, width));
      }
      if (upper) sl.first += h;
      sl.count = h;
      sl.rest = off;
      off >>= 1;
    }
  }
  for (; off > 0; off >>= 1)
    kv[0] = min(kv[0], __shfl_xor_sync(0xffffffffu, kv[0], off, width));
  return sl;
}

}  // namespace lanes
