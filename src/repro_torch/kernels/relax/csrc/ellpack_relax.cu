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
// kernel over them: src/repro/core/backends/ellpack.py:295-312, 409 and
// the sharded wave, :633-652): offers come lane-minor (lane_minor.cuh),
// offers_t[g][v][j] for lane g·W + j, W = lanes::group(S) <= 8, and best
// and arg are (S, R), lane t at the 64-bit offset t·R.
//  - What bounds it.  A lane-major body (PR 16: the single-lane body
//    once per lane) made S dependent gathers per live cell and ran at the
//    single-lane gather rate (~69-82 G gathers/s), 0.86-0.98x of S
//    single-lane calls: the number of gather requests set its time, not
//    the block's bytes (read once from HBM either way).  The floor is
//    relax.wave_bytes(lanes=S): the block once, 4N + 8R per lane.
//  - Design.  A thread loads its unit's weights and indices once; each
//    live cell then makes ONE W-wide gather (8, 16 or 32 bytes, one
//    sector) for all the lanes of a group, so a wave makes the gather
//    requests of one single-lane call.  The row's W keys stay in
//    registers (key[W]); W is a template parameter, so every lane's
//    gather is issued before any lane's min.  lanes::reduce() reduces a
//    row's W keys over its G threads with W - 1 + log2(G / W) shuffles,
//    and the thread left holding a lane writes it.  Lanes past 8 go in
//    groups of 8 over the same loaded weights and indices.  Registers
//    set the occupancy here: the gathered offers are V·W floats a
//    thread, so a thread holds one row group, and rows wider than G·V
//    cells (which reload their units, from L1, per group) and S > 8 take
//    kernels of their own.  The first form (two row groups a thread, the
//    walk and the group loop in one kernel: 98 registers, 2 blocks an
//    SM) took 1.39x this one's time at the ER path's block, S = 4
//    (H100).  One lane (S = 1) takes the single-lane kernel: its
//    lane-minor copy is the offers vector itself.
//  - Each lane's candidates, keys and tie rule are a single-lane call's
//    on its own offers, so each lane is bit-identical to it.
//
// C interface: ellpack_relax_launch(...) picks the variant from the
// pointers and k (relax.variant mirrors the rule), enqueues one launch on
// `stream` and returns cudaGetLastError() (0 = launched);
// ellpack_relax_lanes_launch(...) is the same for `lanes` lanes of
// `n_offers` offers each, given lane-minor; lane_minor_launch(...)
// enqueues the interleave that makes that copy.

#include <cuda_runtime.h>

#include <cstdint>

#include "lane_minor.cuh"
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

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
ellpack_relax_kernel(const float* __restrict__ offers,
                     const int* __restrict__ idx,
                     const float* __restrict__ w,
                     float* __restrict__ best, int* __restrict__ arg,
                     long long rows, int k) {
  constexpr int kRowsPerStep = kThreads / G;
  const int lane = threadIdx.x % G;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * (kRowsPerStep * kSteps) +
      threadIdx.x / G;
  const int units = k / V;   // V-cell units per row
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

// ---- the lane form ------------------------------------------------------

// The weights of a thread's unit u of `row`, and their indices where one
// of them is finite (else +inf weights).
template <int V>
__device__ __forceinline__ void load_unit(const int* __restrict__ idx,
                                          const float* __restrict__ w,
                                          long long row, long long rows,
                                          int k, int u, int units,
                                          float (&cw)[V], int (&ci)[V]) {
  if (row < rows && u < units) {
    load_cells(w + row * k + static_cast<long long>(u) * V, cw);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) cw[c] = minkey::inf();
  }
  bool live = false;
#pragma unroll
  for (int c = 0; c < V; ++c) live |= cw[c] < minkey::inf();
  if (live) load_cells(idx + row * k + static_cast<long long>(u) * V, ci);
}

// One W-wide gather per finite-weight cell (every gather issued before
// any min), folded into each lane's key.
template <int V, int W>
__device__ __forceinline__ void gather_min(const float* __restrict__ og,
                                           const float (&cw)[V],
                                           const int (&ci)[V],
                                           unsigned long long (&key)[W]) {
  float co[V][W];
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (cw[c] < minkey::inf())
      lanes::load(og + static_cast<long long>(ci[c]) * W, co[c]);
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (cw[c] < minkey::inf())
#pragma unroll
      for (int j = 0; j < W; ++j)
        key[j] = min(key[j],
                     minkey::pack(__fadd_rn(co[c][j], cw[c]), ci[c]));
}

// Reduce a row's keys over its G threads and store group g's lanes.
template <int G, int W>
__device__ __forceinline__ void store_row(unsigned long long (&key)[W],
                                          float* __restrict__ best,
                                          int* __restrict__ arg,
                                          long long row, long long rows,
                                          int g, int lanes_n, int pos) {
  const lanes::Slot sl = lanes::reduce<W>(key, G, pos);
  if (row < rows && (pos & (sl.rest - 1)) == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long t = static_cast<long long>(g) * W + sl.first + j;
      if (j < sl.count && t < lanes_n) {
        const float v = minkey::value(key[j]);
        best[t * rows + row] = v;
        arg[t * rows + row] = v < minkey::inf() ? minkey::id(key[j]) : -1;
      }
    }
  }
}

// kOnePass: a row holds at most G units (every row of K <= 32·V cells),
// loaded once for every group; else the units are walked once a group.
// kOneGroup: S <= 8, one group of lanes.  Each case is its own kernel so
// that the general ones' live registers (the walk, the group loop) do not
// set the common one's occupancy (40 registers at G = 8, V = W = 4).
template <int G, int V, int W, bool kOnePass, bool kOneGroup>
__global__ void __launch_bounds__(kThreads)
ellpack_relax_lanes_kernel(const float* __restrict__ offers_t,
                           const int* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ best, int* __restrict__ arg,
                           long long rows, int k, long long n_offers,
                           int lanes_n) {
  const int pos = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const int units = k / V;
  const int n_groups = kOneGroup ? 1 : (lanes_n + W - 1) / W;
  float cw[V];
  int ci[V];
  unsigned long long key[W];
  // `units` and the group count are the same for the whole block, so
  // every thread runs every pass and every shuffle
  if (kOnePass) load_unit<V>(idx, w, row, rows, k, pos, units, cw, ci);
  for (int g = 0; g < n_groups; ++g) {
#pragma unroll
    for (int j = 0; j < W; ++j) key[j] = minkey::kNoCandidate;
    const float* __restrict__ og = offers_t + g * n_offers * W;
    if (kOnePass) {
      gather_min<V, W>(og, cw, ci, key);
    } else {
      for (int u0 = 0; u0 < units; u0 += G) {
        load_unit<V>(idx, w, row, rows, k, u0 + pos, units, cw, ci);
        gather_min<V, W>(og, cw, ci, key);
      }
    }
    store_row<G, W>(key, best, arg, row, rows, g, lanes_n, pos);
  }
}

template <int G, int V>
cudaError_t launch(const float* offers, const int* idx, const float* w,
                   float* best, int* arg, long long rows, int k,
                   long long n_offers, int lanes_n, cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / G * kSteps;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ellpack_relax_kernel<G, V>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          offers, idx, w, best, arg, rows, k);
  return cudaGetLastError();
}

template <int G, int V, int W>
cudaError_t launch_lanes(const float* offers_t, const int* idx,
                         const float* w, float* best, int* arg,
                         long long rows, int k, long long n_offers,
                         int lanes_n, cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / G;
  const unsigned blocks =
      static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  const bool one_pass = k / V <= G, one_group = lanes_n <= W;
  // more units than G only at G = 32; more than one group only at W = 8
  if (one_pass && one_group) {
    ellpack_relax_lanes_kernel<G, V, W, true, true>
        <<<blocks, kThreads, 0, stream>>>(offers_t, idx, w, best, arg, rows,
                                          k, n_offers, lanes_n);
  } else if (one_pass) {
    if constexpr (W == lanes::kMaxGroup)
      ellpack_relax_lanes_kernel<G, V, W, true, false>
          <<<blocks, kThreads, 0, stream>>>(offers_t, idx, w, best, arg,
                                            rows, k, n_offers, lanes_n);
    else
      return cudaErrorInvalidValue;
  } else if constexpr (G == 32) {
    if (one_group)
      ellpack_relax_lanes_kernel<G, V, W, false, true>
          <<<blocks, kThreads, 0, stream>>>(offers_t, idx, w, best, arg,
                                            rows, k, n_offers, lanes_n);
    else if constexpr (W == lanes::kMaxGroup)
      ellpack_relax_lanes_kernel<G, V, W, false, false>
          <<<blocks, kThreads, 0, stream>>>(offers_t, idx, w, best, arg,
                                            rows, k, n_offers, lanes_n);
    else
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Lanes a group: 0 = one lane, the single-lane kernel.
template <int W>
struct Form {
  template <int G, int V>
  static cudaError_t run(const float* o, const int* i, const float* w,
                         float* b, int* a, long long r, int k, long long n,
                         int l, cudaStream_t s) {
    return launch_lanes<G, V, W>(o, i, w, b, a, r, k, n, l, s);
  }
};

template <>
struct Form<0> {
  template <int G, int V>
  static cudaError_t run(const float* o, const int* i, const float* w,
                         float* b, int* a, long long r, int k, long long n,
                         int l, cudaStream_t s) {
    return launch<G, V>(o, i, w, b, a, r, k, n, l, s);
  }
};

// G = min(32, next_pow2(units)) threads per row.
template <int V, int W>
cudaError_t dispatch(const float* offers, const int* idx, const float* w,
                     float* best, int* arg, long long rows, int k,
                     long long n, int lanes_n, cudaStream_t s) {
  using F = Form<W>;
  const int units = k / V;
  if (units <= 1)
    return F::template run<1, V>(offers, idx, w, best, arg, rows, k, n,
                                 lanes_n, s);
  if (units <= 2)
    return F::template run<2, V>(offers, idx, w, best, arg, rows, k, n,
                                 lanes_n, s);
  if (units <= 4)
    return F::template run<4, V>(offers, idx, w, best, arg, rows, k, n,
                                 lanes_n, s);
  if (units <= 8)
    return F::template run<8, V>(offers, idx, w, best, arg, rows, k, n,
                                 lanes_n, s);
  if (units <= 16)
    return F::template run<16, V>(offers, idx, w, best, arg, rows, k, n,
                                  lanes_n, s);
  return F::template run<32, V>(offers, idx, w, best, arg, rows, k, n,
                                lanes_n, s);
}

template <int W>
cudaError_t by_variant(bool vector, const float* offers, const int* idx,
                       const float* w, float* best, int* arg, long long rows,
                       int k, long long n, int lanes_n, cudaStream_t s) {
  return vector
             ? dispatch<4, W>(offers, idx, w, best, arg, rows, k, n, lanes_n,
                              s)
             : dispatch<1, W>(offers, idx, w, best, arg, rows, k, n, lanes_n,
                              s);
}

int launch_any(const float* offers, const int* idx, const float* w,
               float* best, int* arg, long long rows, int k, long long n,
               int lanes_n, void* stream) {
  if (rows <= 0 || k <= 0 || lanes_n <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector =
      k % 4 == 0 && ((reinterpret_cast<std::uintptr_t>(idx) |
                      reinterpret_cast<std::uintptr_t>(w)) & 15u) == 0;
  cudaError_t err;
  switch (lanes_n == 1 ? 0 : lanes::group(lanes_n)) {
    case 0:
      err = by_variant<0>(vector, offers, idx, w, best, arg, rows, k, n,
                          lanes_n, s);
      break;
    case 2:
      err = by_variant<2>(vector, offers, idx, w, best, arg, rows, k, n,
                          lanes_n, s);
      break;
    case 4:
      err = by_variant<4>(vector, offers, idx, w, best, arg, rows, k, n,
                          lanes_n, s);
      break;
    default:
      err = by_variant<8>(vector, offers, idx, w, best, arg, rows, k, n,
                          lanes_n, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int ellpack_relax_launch(const float* offers, const int* idx,
                                    const float* w, float* best, int* arg,
                                    long long rows, int k, void* stream) {
  return launch_any(offers, idx, w, best, arg, rows, k, 0, 1, stream);
}

// offers_t: lanes::groups(lanes) x n_offers x lanes::group(lanes) floats,
// 16-byte aligned (the offers vector itself when lanes == 1).
extern "C" int ellpack_relax_lanes_launch(const float* offers_t,
                                          const int* idx, const float* w,
                                          float* best, int* arg,
                                          long long rows, int k,
                                          long long n_offers, int lanes_n,
                                          void* stream) {
  if ((reinterpret_cast<std::uintptr_t>(offers_t) & 15u) != 0 && lanes_n > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(offers_t, idx, w, best, arg, rows, k, n_offers, lanes_n,
                    stream);
}

// out = offers (lanes x n, tree-major) lane-minor, +inf past the last lane
// (and where `active`, if not null, is false).
extern "C" int lane_minor_launch(const float* offers,
                                 const unsigned char* active, float* out,
                                 long long n, int lanes_n, void* stream) {
  if (n < 0 || lanes_n <= 0 ||
      (reinterpret_cast<std::uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lanes::interleave(
      offers, active, out, n, lanes_n, static_cast<cudaStream_t>(stream)));
}
