// fused_sliced_relax.cu — one whole hybrid sliced-ELL + overflow-COO
// relaxation wave (kernel K2) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/relax/fused.py::fused_sliced_relax (kernel body
// _mk_kernel).  For every row r of the flat sliced-ELL layout:
//
//   offers[v] = active[v] ? dist[v] : +inf
//   ELL lane  : row r's cells of (flat_idx, flat_w)
//   COO lane  : overflow entries i with odst[i] == r
//   best[r]   = min over both lanes of offers[src] + w
//   arg[r]    = smallest src attaining best[r]; INT_MAX where best is +inf
//
// which is combine_lanes(sliced_gather_min, overflow_min) of the sliced
// backend, bit for bit.
//
// Bound: device-memory bandwidth.  Each input read once and each output
// written once is 5N (dist f32 + active bool) + 4L (every ELL weight) +
// 4 live_L (the index of each finite-weight cell) + 4C + 8 live_C (every
// overflow weight; source and row of the finite ones) + 8R (best/arg):
// fused.wave_bytes.  At the RMAT(20) main path's final layout (N = R =
// 2^20, L ~ 26.4M cells of which ~11 % live, C = 2^23) ~193 MB, ~58 us at
// 3.35 TB/s.  The arithmetic (one add and one compare per candidate) is
// negligible.
//
// Design, the key reset and two launches on one stream:
//  (a) the COO lane: one thread per overflow entry.  A live entry (finite
//      w) whose source is active scatters its (value, src) key into the
//      row's u64 key with atomicMin (minkey.cuh); a warp whose keys all
//      target one row (most of a hub's contiguous surplus) first takes
//      their min and makes one atomic.  The TPU kernel rescans the whole
//      COO segment once per distinct-width run (1,418 runs at the RMAT(20)
//      layout); here it is read once per wave.
//  (b) the ELL lane, streamed by the layout's own geometry.  The flat
//      buffer is a series of row-major (rows, k) blocks, one per run of
//      equal-width slices, k a power of two.  A device table made once per
//      layout (fused.py::block_table) cuts each run into chunks of
//      kChunk = 1,024 cells (whole rows) and gives each thread block one
//      chunk: (first cell, first row, log2 k, cells); a chunk that would
//      reach past the flat buffer or the rows is skipped whole, so a table
//      made for another layout cannot read or write out of bounds (the
//      wrapper refuses a table of the wrong size).  For k <= 32, thread
//      t takes cells t, t + 256, t + 512, t + 768 of its chunk: each warp
//      step holds 32 / k whole rows, every load is coalesced, a row of a
//      width-1 slice costs one lane, and a segmented shuffle of width k
//      reduces each row.  Wider slices (hub_k > 32)
//      take one warp per row.  All four steps' weights are loaded first;
//      the index, active flag and dist of a cell are read only where its
//      weight is finite (89 % of the RMAT(20) cells are +inf padding,
//      whose candidate is +inf whatever the index says), active and dist
//      in parallel.  Each row's leader loads the row's COO key with the
//      weights, folds it in and writes best/arg.
// The lexicographic (value, smallest id) minimum is a total order, so any
// reduction order gives the plain version's result; each lane already
// yields its smallest minimising id, so the union of the two lanes is
// exactly combine_lanes.  Adds are __fadd_rn (never contracted), as in the
// plain version.
//
// Lane form (S trees over the one layout; the reference vmaps the TPU
// kernel over them: src/repro/core/backends/sliced.py:393-395).
//  - What bounds it.  A lane-major body (PR 16) made 2S dependent
//    requests per live candidate (active[t·N + src], then dist[t·N +
//    src], per tree), re-read wide rows per tree and repeated the COO
//    ballot per tree: 0.86-0.98x of S single-lane calls, 9-10 % of its
//    bound.  The gather requests set its time, not the layout's bytes
//    (read once either way).  The floor is fused.wave_bytes(lanes=S): the
//    layout once and 5N + 8R per tree.
//  - Design.  One more launch first folds the mask into the offers and
//    interleaves them lane-minor (lane_minor.cuh): offers_t[g][v][j] =
//    active[t, v] ? dist[t, v] : +inf for tree t = g·W + j, W =
//    lanes::group(S) <= 8, into caller-allocated scratch, so each live
//    candidate makes ONE W-wide request for all the trees of a group
//    where it made 2S.  The COO pass loads an entry once, makes that one
//    gather and takes the warp's same-row test once (from the entry
//    alone: every tree's key of an entry targets its row), then a
//    warp-wide min of each tree's key (lanes::reduce) and one atomicMin
//    a tree.  The ELL pass keeps a chunk's weights and indices in
//    registers over the groups; each row's W keys reduce over its k
//    threads with lanes::reduce, and the thread left holding a tree
//    folds in that tree's COO key and writes it.  Registers set its
//    occupancy: a step's W-wide gather is issued just before that step's
//    reduction, the pass is capped to 8 blocks an SM (32 registers at
//    W <= 4), one group of trees (S <= 8) is its own kernel, and so are
//    rows wider than a warp (k > 32, off the main path's hub_k = 32,
//    launched only for a layout that has them; such a row is read once
//    for all the trees of a group).  The first form of the pass (every
//    step's gather first, the group loop and the wide rows in one
//    kernel: 64 registers, 4 blocks an SM) took 1.37x this one's time
//    at the RMAT(20) path's layout, S = 4 (H100).  Keys are lane-minor,
//    [groups][R][W] u64, reset by the one cudaMemsetAsync.  One tree
//    (S = 1) takes the single-lane kernels.
//  - A tree's candidates and keys are exactly a single-lane call's on its
//    dist/active, so each tree is bit-identical to it.
//
// C interface: fused_sliced_relax_launch(...) enqueues the key reset and
// both launches on `stream` and returns the first CUDA error (0 =
// launched); `key` is caller-allocated scratch of R u64 words.
// fused_sliced_relax_lanes_launch(...) is the same for `lanes` trees of
// `n` vertices each, with the interleave first: `key` holds `key_words`
// u64 words (at least groups·R·W) and `offers_t` `offer_words` floats (at
// least groups·n·W, 16-byte aligned); `wide` (any slice wider than 32
// cells) launches the wide rows' pass.  `blocks` is the int4 chunk table
// of `n_blocks` entries made for `chunk` cells over a flat buffer of
// `cells` cells and `rows` rows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lane_minor.cuh"
#include "minkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;                 // cells per chunk (k <= 32)
constexpr int kSteps = kChunk / kThreads;    // cells per thread

// The candidate of a cell or entry with weight w and source nb: its
// active flag and dist are loaded in parallel.
__device__ __forceinline__ float candidate(const float* __restrict__ dist,
                                           const unsigned char* __restrict__
                                               active,
                                           int nb, float w) {
  const unsigned char a = __ldg(active + nb);
  const float d = __ldg(dist + nb);
  return a ? __fadd_rn(d, w) : minkey::inf();
}

__global__ void __launch_bounds__(kThreads)
k2_coo_pass(const float* __restrict__ dist,
            const unsigned char* __restrict__ active,
            const int* __restrict__ osrc, const int* __restrict__ odst,
            const float* __restrict__ ow, unsigned long long* __restrict__ key,
            long long c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  float w = minkey::inf();
  int s = 0, r = -1;
  if (i < c) {
    w = __ldg(ow + i);
    if (w < minkey::inf()) {  // not an empty or tombstoned entry
      s = __ldg(osrc + i);
      r = __ldg(odst + i);
    }
  }
  unsigned long long kv = minkey::kEmpty;  // this entry's key, if any
  int row = -1;
  if (w < minkey::inf()) {
    const float v = candidate(dist, active, s, w);
    if (v < minkey::inf()) {
      kv = minkey::pack(v, s);
      row = r;
    }
  }
  // A hub's surplus is stored contiguously, so a warp's keys mostly
  // share one row: then the warp takes their min and lane 0 makes the
  // one atomicMin (a row of 17,891 entries at RMAT(20) otherwise
  // serialises as many atomics on one word); else every key makes its
  // own.  The ballot is warp-uniform, so is the skip.
  const unsigned live = __ballot_sync(0xffffffffu, kv != minkey::kEmpty);
  if (live == 0) return;
  const int row0 = __shfl_sync(0xffffffffu, row, __ffs(live) - 1);
  if (__all_sync(0xffffffffu, kv == minkey::kEmpty || row == row0)) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      kv = min(kv, __shfl_xor_sync(0xffffffffu, kv, off));
    if ((threadIdx.x & 31) == 0) atomicMin(key + row0, kv);
  } else if (kv != minkey::kEmpty) {
    atomicMin(key + row, kv);
  }
}

// Fold a row's COO key kv into its ELL (v, id) and store best/arg.
__device__ __forceinline__ void finish_row(unsigned long long kv,
                                           float* __restrict__ best,
                                           int* __restrict__ arg, int row,
                                           float v, int id) {
  if (kv != minkey::kEmpty)
    minkey::take_min(v, id, minkey::value(kv), minkey::id(kv));
  best[row] = v;
  arg[row] = v < minkey::inf() ? id : INT_MAX;
}

// The chunk `blk` fits the flat buffer and the rows.  Unsigned, a
// negative field is past every end.  A chunk larger than kChunk is only
// cut short, never read past.
__device__ __forceinline__ bool chunk_fits(int4 blk,
                                           unsigned long long n_cells,
                                           unsigned long long n_rows) {
  const int cell0 = blk.x, row0 = blk.y, log2k = blk.z, cells = blk.w;
  return !(static_cast<unsigned>(log2k) > 30u ||
           static_cast<unsigned long long>(static_cast<unsigned>(cell0)) +
                   static_cast<unsigned>(cells) > n_cells ||
           static_cast<unsigned long long>(static_cast<unsigned>(row0)) +
                   ((static_cast<unsigned>(cells) + (1u << log2k) - 1) >>
                    log2k) >
               n_rows);
}

__global__ void __launch_bounds__(kThreads)
k2_ell_pass(const float* __restrict__ dist,
            const unsigned char* __restrict__ active,
            const int* __restrict__ flat_idx,
            const float* __restrict__ flat_w, const int4* __restrict__ blocks,
            const unsigned long long* __restrict__ key,
            float* __restrict__ best, int* __restrict__ arg,
            unsigned long long n_cells, unsigned long long n_rows) {
  const int4 blk = __ldg(blocks + blockIdx.x);
  const int cell0 = blk.x, row0 = blk.y, log2k = blk.z, cells = blk.w;
  // a chunk past the flat buffer or the rows leaves whole (so the
  // shuffles below stay exact)
  if (!chunk_fits(blk, n_cells, n_rows)) return;
  const int t = threadIdx.x;
  if (log2k <= 5) {
    // k <= 32: cell t + s * kThreads of the chunk, whole rows per warp step
    const int k = 1 << log2k;
    float w[kSteps];
    int nb[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = t + s * kThreads;
      w[s] = c < cells ? __ldg(flat_w + cell0 + c) : minkey::inf();
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      nb[s] = w[s] < minkey::inf() ? __ldg(flat_idx + cell0 + t + s * kThreads)
                                   : INT_MAX;
    unsigned long long kv[kSteps];  // the row's COO key, at its leader
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = t + s * kThreads;
      kv[s] = c < cells && (c & (k - 1)) == 0 ? key[row0 + (c >> log2k)]
                                              : minkey::kEmpty;
    }
    float v[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      v[s] = w[s] < minkey::inf() ? candidate(dist, active, nb[s], w[s])
                                  : minkey::inf();
    // every thread of the block runs every step (cells past the chunk
    // carry +inf), so the full mask is exact for the shuffles
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float sv = v[s];
      int sid = nb[s];
      for (int off = k >> 1; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, sv, off, k);
        const int oid = __shfl_xor_sync(0xffffffffu, sid, off, k);
        minkey::take_min(sv, sid, ov, oid);
      }
      const int c = t + s * kThreads;
      if (c < cells && (c & (k - 1)) == 0)
        finish_row(kv[s], best, arg, row0 + (c >> log2k), sv, sid);
    }
  } else {
    // k > 32 (hub_k above a warp): one warp per row, lanes stride the row
    const int k = 1 << log2k;
    const int lane = t & 31;
    const int nrows = cells >> log2k;
    for (int r = t >> 5; r < nrows; r += kThreads / 32) {
      const int b = cell0 + r * k;
      float sv = minkey::inf();
      int sid = INT_MAX;
      for (int j = lane; j < k; j += 32) {
        const float wj = __ldg(flat_w + b + j);
        if (wj < minkey::inf()) {
          const int nj = __ldg(flat_idx + b + j);
          minkey::take_min(sv, sid, candidate(dist, active, nj, wj), nj);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, sv, off);
        const int oid = __shfl_xor_sync(0xffffffffu, sid, off);
        minkey::take_min(sv, sid, ov, oid);
      }
      if (lane == 0) finish_row(key[row0 + r], best, arg, row0 + r, sv, sid);
    }
  }
}

// ---- the lane form ------------------------------------------------------

// A live entry or cell's key for each of W trees: (offer + w, src) where
// that is finite, else kEmpty.
template <int W>
__device__ __forceinline__ void lane_keys(const float (&o)[W], float w,
                                          int src,
                                          unsigned long long (&kv)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float v = __fadd_rn(o[j], w);
    kv[j] = v < minkey::inf() ? minkey::pack(v, src) : minkey::kEmpty;
  }
}

// Tree `lane`'s row: its ELL key `ell` min its COO key, stored as
// best/arg (+inf and INT_MAX where neither is finite).
__device__ __forceinline__ void finish_lane(unsigned long long ell,
                                            unsigned long long coo,
                                            float* __restrict__ best,
                                            int* __restrict__ arg,
                                            long long at) {
  const unsigned long long k = min(ell, coo);
  const bool finite = (k >> 32) < 0x7f800000ull;
  best[at] = finite ? minkey::value(k) : minkey::inf();
  arg[at] = finite ? minkey::id(k) : INT_MAX;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
k2_coo_lanes(const float* __restrict__ offers_t,
             const int* __restrict__ osrc, const int* __restrict__ odst,
             const float* __restrict__ ow,
             unsigned long long* __restrict__ key, long long c, long long n,
             long long rows, int n_groups) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  float w = minkey::inf();   // this entry, loaded once for every tree
  int s = 0, r = -1;
  if (i < c) {
    w = __ldg(ow + i);
    if (w < minkey::inf()) {  // not an empty or tombstoned entry
      s = __ldg(osrc + i);
      r = __ldg(odst + i);
    }
  }
  // the same-row test of the single-lane pass, on the live entries: every
  // tree's key of an entry targets its row, so it holds for every tree
  const bool live = w < minkey::inf();
  const unsigned any = __ballot_sync(0xffffffffu, live);
  if (any == 0) return;
  const int row0 = __shfl_sync(0xffffffffu, r, __ffs(any) - 1);
  const bool one_row = __all_sync(0xffffffffu, !live || r == row0);
  const int pos = threadIdx.x & 31;
  for (int g = 0; g < n_groups; ++g) {
    unsigned long long kv[W];
    if (live) {
      float o[W];
      lanes::load(offers_t + (g * n + s) * W, o);
      lane_keys<W>(o, w, s, kv);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) kv[j] = minkey::kEmpty;
    }
    unsigned long long* __restrict__ gkey = key + g * rows * W;
    if (one_row) {
      const lanes::Slot sl = lanes::reduce<W>(kv, 32, pos);
      if ((pos & (sl.rest - 1)) == 0) {
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (j < sl.count && kv[j] != minkey::kEmpty)
            atomicMin(gkey + static_cast<long long>(row0) * W + sl.first + j,
                      kv[j]);
      }
    } else if (live) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (kv[j] != minkey::kEmpty)
          atomicMin(gkey + static_cast<long long>(r) * W + j, kv[j]);
    }
  }
}

// Blocks an SM must hold: the register cap that sets the ELL lane pass's
// occupancy; at W <= 4 the pass fits 32 registers, 8 blocks.
template <int W>
__host__ __device__ constexpr int ell_lane_blocks() { return W <= 4 ? 8 : 4; }

// The ELL lane pass over the chunks of k <= 32 (every chunk of a layout
// whose widths stay within hub_k = 32; k2_ell_wide_lanes takes the
// rest).  kOneGroup: S <= 8.
template <int W, bool kOneGroup>
__global__ void __launch_bounds__(kThreads, ell_lane_blocks<W>())
k2_ell_lanes(const float* __restrict__ offers_t,
             const int* __restrict__ flat_idx,
             const float* __restrict__ flat_w, const int4* __restrict__ blocks,
             const unsigned long long* __restrict__ key,
             float* __restrict__ best, int* __restrict__ arg,
             unsigned long long n_cells, unsigned long long n_rows,
             long long n, int lanes_n) {
  const int4 blk = __ldg(blocks + blockIdx.x);
  const int cell0 = blk.x, row0 = blk.y, log2k = blk.z, cells = blk.w;
  if (!chunk_fits(blk, n_cells, n_rows) || log2k > 5) return;
  const long long rows = static_cast<long long>(n_rows);
  const int n_groups = kOneGroup ? 1 : (lanes_n + W - 1) / W;
  // cell t + s * kThreads of the chunk, whole rows per warp step; the
  // weights and indices are loaded once for every group
  const int t = threadIdx.x;
  const int k = 1 << log2k;
  const int pos = t & (k - 1);
  float w[kSteps];
  int nb[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = t + s * kThreads;
    w[s] = c < cells ? __ldg(flat_w + cell0 + c) : minkey::inf();
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    nb[s] = w[s] < minkey::inf() ? __ldg(flat_idx + cell0 + t + s * kThreads)
                                 : 0;
  for (int g = 0; g < n_groups; ++g) {
    const float* __restrict__ og = offers_t + g * n * W;
    // every thread of the block runs every step (cells past the chunk
    // carry +inf), so the full mask is exact for the shuffles.  A step's
    // gather is issued just before its reduction: W floats a step in
    // registers, not kSteps·W, hence the occupancy.
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      unsigned long long kv[W];
      if (w[s] < minkey::inf()) {
        float o[W];
        lanes::load(og + static_cast<long long>(nb[s]) * W, o);
        lane_keys<W>(o, w[s], nb[s], kv);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) kv[j] = minkey::kEmpty;
      }
      const lanes::Slot sl = lanes::reduce<W>(kv, k, pos);
      const int c = t + s * kThreads;
      if (c < cells && (pos & (sl.rest - 1)) == 0) {
        const long long row = row0 + (c >> log2k);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int lane = g * W + sl.first + j;
          if (j < sl.count && lane < lanes_n)
            finish_lane(kv[j], key[(g * rows + row) * W + sl.first + j],
                        best, arg, lane * rows + row);
        }
      }
    }
  }
}

// The ELL lane pass over the chunks of k > 32 (hub_k above a warp): one
// warp per row, lanes stride the row, read once for every tree of a
// group (again per group past 8 trees).
template <int W>
__global__ void __launch_bounds__(kThreads)
k2_ell_wide_lanes(const float* __restrict__ offers_t,
                  const int* __restrict__ flat_idx,
                  const float* __restrict__ flat_w,
                  const int4* __restrict__ blocks,
                  const unsigned long long* __restrict__ key,
                  float* __restrict__ best, int* __restrict__ arg,
                  unsigned long long n_cells, unsigned long long n_rows,
                  long long n, int lanes_n) {
  const int4 blk = __ldg(blocks + blockIdx.x);
  const int cell0 = blk.x, row0 = blk.y, log2k = blk.z, cells = blk.w;
  if (!chunk_fits(blk, n_cells, n_rows) || log2k <= 5) return;
  const long long rows = static_cast<long long>(n_rows);
  const int n_groups = (lanes_n + W - 1) / W;
  const int t = threadIdx.x;
  const int k = 1 << log2k;
  const int pos = t & 31;
  const int nrows = cells >> log2k;
  for (int r = t >> 5; r < nrows; r += kThreads / 32) {
    const int b = cell0 + r * k;
    const long long row = row0 + r;
    for (int g = 0; g < n_groups; ++g) {
      const float* __restrict__ og = offers_t + g * n * W;
      unsigned long long kv[W];
#pragma unroll
      for (int j = 0; j < W; ++j) kv[j] = minkey::kEmpty;
      for (int j = pos; j < k; j += 32) {
        const float wj = __ldg(flat_w + b + j);
        if (wj < minkey::inf()) {
          const int nj = __ldg(flat_idx + b + j);
          float o[W];
          unsigned long long cand[W];
          lanes::load(og + static_cast<long long>(nj) * W, o);
          lane_keys<W>(o, wj, nj, cand);
#pragma unroll
          for (int l = 0; l < W; ++l) kv[l] = min(kv[l], cand[l]);
        }
      }
      const lanes::Slot sl = lanes::reduce<W>(kv, 32, pos);
      if ((pos & (sl.rest - 1)) == 0) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int lane = g * W + sl.first + j;
          if (j < sl.count && lane < lanes_n)
            finish_lane(kv[j], key[(g * rows + row) * W + sl.first + j],
                        best, arg, lane * rows + row);
        }
      }
    }
  }
}

bool bad_sizes(long long rows, long long cells, long long c, long long n,
               int n_blocks, int chunk, int lanes_n) {
  return rows <= 0 || cells <= 0 || c < 0 || n < 0 || n_blocks <= 0 ||
         chunk != kChunk || lanes_n <= 0;
}

int launch_one(const float* dist, const unsigned char* active,
               const int* flat_idx, const float* flat_w, const int* blocks,
               const int* osrc, const int* odst, const float* ow,
               unsigned long long* key, float* best, int* arg,
               long long rows, long long cells, long long c, int n_blocks,
               cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(key, 0xff, rows * sizeof(*key), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c > 0) {
    const long long nb = (c + kThreads - 1) / kThreads;
    k2_coo_pass<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        dist, active, osrc, odst, ow, key, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k2_ell_pass<<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
      dist, active, flat_idx, flat_w, reinterpret_cast<const int4*>(blocks),
      key, best, arg, cells, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_lanes(const float* offers_t, const int* flat_idx,
                 const float* flat_w, const int* blocks, const int* osrc,
                 const int* odst, const float* ow, unsigned long long* key,
                 float* best, int* arg, long long rows, long long cells,
                 long long c, long long n, int n_blocks, int lanes_n,
                 bool wide, cudaStream_t s) {
  const int n_groups = lanes::groups(lanes_n);
  const int4* table = reinterpret_cast<const int4*>(blocks);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if (c > 0) {
    const long long nb = (c + kThreads - 1) / kThreads;
    k2_coo_lanes<W><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        offers_t, osrc, odst, ow, key, c, n, rows, n_groups);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_groups == 1) {
    k2_ell_lanes<W, true><<<grid, kThreads, 0, s>>>(
        offers_t, flat_idx, flat_w, table, key, best, arg, cells, rows, n,
        lanes_n);
  } else if constexpr (W == lanes::kMaxGroup) {
    k2_ell_lanes<W, false><<<grid, kThreads, 0, s>>>(
        offers_t, flat_idx, flat_w, table, key, best, arg, cells, rows, n,
        lanes_n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !wide) return static_cast<int>(err);
  k2_ell_wide_lanes<W><<<grid, kThreads, 0, s>>>(
      offers_t, flat_idx, flat_w, table, key, best, arg, cells, rows, n,
      lanes_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_sliced_relax_launch(
    const float* dist, const unsigned char* active, const int* flat_idx,
    const float* flat_w, const int* blocks, const int* osrc, const int* odst,
    const float* ow, unsigned long long* key, float* best, int* arg,
    long long rows, long long cells, long long c, int n_blocks, int chunk,
    void* stream) {
  if (bad_sizes(rows, cells, c, 0, n_blocks, chunk, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_one(dist, active, flat_idx, flat_w, blocks, osrc, odst, ow,
                    key, best, arg, rows, cells, c, n_blocks,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int fused_sliced_relax_lanes_launch(
    const float* dist, const unsigned char* active, const int* flat_idx,
    const float* flat_w, const int* blocks, const int* osrc, const int* odst,
    const float* ow, unsigned long long* key, float* offers_t, float* best,
    int* arg, long long rows, long long cells, long long c, long long n,
    int n_blocks, int chunk, int lanes_n, int wide, long long key_words,
    long long offer_words, void* stream) {
  if (bad_sizes(rows, cells, c, n, n_blocks, chunk, lanes_n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes_n == 1)   // one tree: the single-lane kernels
    return key_words < rows
               ? static_cast<int>(cudaErrorInvalidValue)
               : launch_one(dist, active, flat_idx, flat_w, blocks, osrc,
                            odst, ow, key, best, arg, rows, cells, c,
                            n_blocks, s);
  const int w = lanes::group(lanes_n);
  const long long g = lanes::groups(lanes_n);
  if (key_words < g * rows * w || offer_words < g * n * w ||
      (reinterpret_cast<std::uintptr_t>(offers_t) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(key, 0xff, g * rows * w * sizeof(*key), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lanes::interleave(dist, active, offers_t, n, lanes_n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (w) {
    case 2:
      return launch_lanes<2>(offers_t, flat_idx, flat_w, blocks, osrc, odst,
                             ow, key, best, arg, rows, cells, c, n, n_blocks,
                             lanes_n, wide != 0, s);
    case 4:
      return launch_lanes<4>(offers_t, flat_idx, flat_w, blocks, osrc, odst,
                             ow, key, best, arg, rows, cells, c, n, n_blocks,
                             lanes_n, wide != 0, s);
    default:
      return launch_lanes<8>(offers_t, flat_idx, flat_w, blocks, osrc, odst,
                             ow, key, best, arg, rows, cells, c, n, n_blocks,
                             lanes_n, wide != 0, s);
  }
}
