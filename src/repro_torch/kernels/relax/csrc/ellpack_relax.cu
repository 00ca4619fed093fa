// ellpack_relax.cu — ELLPACK min-plus relaxation wave (kernel K1) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/relax/relax.py::ellpack_relax
// (kernel body _relax_kernel).  Per ELL row r:
//
//   best[r] = min_k offers[idx[r,k]] + w[r,k]
//   arg[r]  = smallest idx[r,k] attaining best[r];  -1 where best[r] == +inf
//
// Bound: device-memory bandwidth.  Each input read once and each output
// written once is the offers vector (4N), every weight (4RK), the index of
// each finite-weight cell (4 live) and best + arg (8R): relax.wave_bytes.
// At the ER path's final block (R = N = 2^20, K = 32, 6.6M of 33.5M cells
// live) that is 173.3 MB, 0.0517 ms at 3.35 TB/s.  The gathers of offers
// hit L2, which holds the vector whole (4 MB of 50 MB).  The arithmetic
// (one add and one compare per live cell) is negligible.
//
// Design:
//  - Weight first.  A lane owns V consecutive cells of a row: V = 4 (one
//    float4 of w, one int4 of idx) where K % 4 == 0 and idx and w start
//    on a 16-byte boundary, else V = 1 (the scalar variant: a view at any
//    cell offset, as sliced_gather_min passes one run of slices).  The
//    lane loads its weights, loads the matching indices only if one of
//    them is finite, and gathers offers[idx] only for finite cells.  A
//    +inf weight gives a +inf candidate whatever the index and offer are,
//    and a row with no finite candidate reports (+inf, -1) either way, so
//    the skip is exact.  On the ER block 80 % of the cells are +inf
//    (the never-written tail past a row's fill, and tombstones), so most
//    idx sectors past a row's head are never read.
//  - Bytes in flight.  G = min(32, next_pow2(K / V)) lanes per row, so a
//    warp holds 32 / G rows (4 at K = 32), and kSteps row groups per
//    thread: every weight load of a thread is issued before any dependent
//    load, then its index loads, then its gathers.  Rows wider than G·V
//    cells loop inside the warp.
//  - One 64-bit min.  Each candidate is packed with its index as
//    minkey::pack(value, idx); values are >= 0 or +inf and ids lie in
//    [0, N), so the unsigned order of the key is the repository's tie
//    rule.  A lane takes the min of its cells' keys and a segmented
//    shuffle of width G reduces each row.  The key starts at
//    minkey::kNoCandidate = (+inf, INT_MAX); a row whose key decodes to
//    +inf reports arg = -1.  Rows past R carry that key through the
//    shuffles, so every thread reaches them.
//  - The add is __fadd_rn (round-to-nearest, never contracted), so values
//    are bit-identical to the plain version's f32 add.
// The TPU kernel's (256, K) row blocks and its whole-vector VMEM copy of
// the offers are not carried over: L2 plays the VMEM role here.
//
// Lane form (S trees over the one block; the reference vmaps the TPU
// kernel): offers is (S, N) and best/arg (S, R), lane t at the 64-bit
// offsets t·N and t·R.  One launch, the single-lane grid: each thread
// runs the whole body once per lane, lane after lane, so its block's
// weights and indices come from HBM once and from L1/L2 for the next
// lanes; the offers gathers and the outputs are per lane.  A lane's body
// is the single-lane body on its own offers, so each lane is bit-identical
// to a single-lane call.  Bound: relax.wave_bytes(lanes=S), the block
// once and 4N + 8R per lane.
//
// C interface: ellpack_relax_launch(...) picks the variant from the
// pointers and k (relax.variant mirrors the rule), enqueues one launch on
// `stream` and returns cudaGetLastError() (0 = launched);
// ellpack_relax_lanes_launch(...) is the same for `lanes` lanes of
// `n_offers` offers each.

#include <cuda_runtime.h>

#include <cstdint>

#include "minkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 2;   // row groups per thread, loads issued together

// V consecutive cells at `p` (16-byte aligned when V == 4).
__device__ __forceinline__ void load_cells(const float* __restrict__ p,
                                           float (&out)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load_cells(const int* __restrict__ p,
                                           int (&out)[4]) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load_cells(const float* __restrict__ p,
                                           float (&out)[1]) {
  out[0] = __ldg(p);
}

__device__ __forceinline__ void load_cells(const int* __restrict__ p,
                                           int (&out)[1]) {
  out[0] = __ldg(p);
}

template <int G, int V, bool kLanes>
__global__ void __launch_bounds__(kThreads)
ellpack_relax_kernel(const float* __restrict__ offers_all,
                     const int* __restrict__ idx,
                     const float* __restrict__ w,
                     float* __restrict__ best_all, int* __restrict__ arg_all,
                     long long rows, int k, long long n_offers, int lanes) {
  constexpr int kRowsPerStep = kThreads / G;
  const int lane = threadIdx.x % G;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * (kRowsPerStep * kSteps) +
      threadIdx.x / G;
  const int units = k / V;   // V-cell units per row
  // one tree (lane of the (S, N) offers) after another; every thread runs
  // every tree, so the shuffles below stay exact.  The single-lane
  // instantiation (kLanes false) runs the body once, as compiled before
  // the lane form existed.
  const int trees = kLanes ? lanes : 1;
  for (int tree = 0; tree < trees; ++tree) {
    const float* __restrict__ offers = offers_all + tree * n_offers;
    float* __restrict__ best = best_all + tree * rows;
    int* __restrict__ arg = arg_all + tree * rows;
    unsigned long long key[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) key[s] = minkey::kNoCandidate;
    // one pass unless a row holds more than G units; `units` is the same for
    // the whole block, so every thread runs every pass
    for (int u0 = 0; u0 < units; u0 += G) {
      const int u = u0 + lane;
      float cw[kSteps][V];
      int ci[kSteps][V];
      bool live[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const long long row = row0 + s * kRowsPerStep;
        if (row < rows && u < units) {
          load_cells(w + row * k + static_cast<long long>(u) * V, cw[s]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) cw[s][c] = minkey::inf();
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        live[s] = false;
#pragma unroll
        for (int c = 0; c < V; ++c) live[s] |= cw[s][c] < minkey::inf();
        if (live[s])
          load_cells(idx + (row0 + s * kRowsPerStep) * k +
                         static_cast<long long>(u) * V,
                     ci[s]);
      }
      // a finite weight implies live[s], so its index was loaded
      float co[kSteps][V];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int c = 0; c < V; ++c)
          co[s][c] = cw[s][c] < minkey::inf() ? __ldg(offers + ci[s][c])
                                              : minkey::inf();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (cw[s][c] < minkey::inf())
            key[s] = min(key[s],
                         minkey::pack(__fadd_rn(co[s][c], cw[s][c]), ci[s][c]));
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        key[s] = min(key[s], __shfl_xor_sync(0xffffffffu, key[s], off, G));
      const long long row = row0 + s * kRowsPerStep;
      if (row < rows && lane == 0) {
        const float v = minkey::value(key[s]);
        best[row] = v;
        arg[row] = v < minkey::inf() ? minkey::id(key[s]) : -1;
      }
    }
  }
}

template <int G, int V, bool kLanes>
cudaError_t launch(const float* offers, const int* idx, const float* w,
                   float* best, int* arg, long long rows, int k,
                   long long n_offers, int lanes, cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / G * kSteps;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ellpack_relax_kernel<G, V, kLanes>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          offers, idx, w, best, arg, rows, k, n_offers, lanes);
  return cudaGetLastError();
}

// G = min(32, next_pow2(units)) lanes per row.
template <int V, bool L>
cudaError_t dispatch(const float* offers, const int* idx, const float* w,
                     float* best, int* arg, long long rows, int k,
                     long long n, int lanes, cudaStream_t s) {
  const int units = k / V;
  if (units <= 1)
    return launch<1, V, L>(offers, idx, w, best, arg, rows, k, n, lanes, s);
  if (units <= 2)
    return launch<2, V, L>(offers, idx, w, best, arg, rows, k, n, lanes, s);
  if (units <= 4)
    return launch<4, V, L>(offers, idx, w, best, arg, rows, k, n, lanes, s);
  if (units <= 8)
    return launch<8, V, L>(offers, idx, w, best, arg, rows, k, n, lanes, s);
  if (units <= 16)
    return launch<16, V, L>(offers, idx, w, best, arg, rows, k, n, lanes,
                            s);
  return launch<32, V, L>(offers, idx, w, best, arg, rows, k, n, lanes, s);
}

template <bool L>
int launch_any(const float* offers, const int* idx, const float* w,
               float* best, int* arg, long long rows, int k, long long n,
               int lanes, void* stream) {
  if (rows <= 0 || k <= 0 || lanes <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector =
      k % 4 == 0 && ((reinterpret_cast<std::uintptr_t>(idx) |
                      reinterpret_cast<std::uintptr_t>(w)) & 15u) == 0;
  return static_cast<int>(
      vector
          ? dispatch<4, L>(offers, idx, w, best, arg, rows, k, n, lanes, s)
          : dispatch<1, L>(offers, idx, w, best, arg, rows, k, n, lanes, s));
}

}  // namespace

extern "C" int ellpack_relax_launch(const float* offers, const int* idx,
                                    const float* w, float* best, int* arg,
                                    long long rows, int k, void* stream) {
  return launch_any<false>(offers, idx, w, best, arg, rows, k, 0, 1,
                           stream);
}

extern "C" int ellpack_relax_lanes_launch(const float* offers,
                                          const int* idx, const float* w,
                                          float* best, int* arg,
                                          long long rows, int k,
                                          long long n_offers, int lanes,
                                          void* stream) {
  return launch_any<true>(offers, idx, w, best, arg, rows, k, n_offers,
                          lanes, stream);
}
