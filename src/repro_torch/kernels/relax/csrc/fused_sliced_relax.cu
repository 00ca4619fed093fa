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
// kernel): dist/active are (S, N), the key scratch and best/arg (S, R),
// tree t at the 64-bit offsets t·N and t·R; the key reset covers all S·R
// keys.  The same grids: a COO thread loads its entry once and scatters
// one key per tree into that tree's row key (the warp's same-row test
// depends on the entry only, its min and atomic are per tree); an ELL
// thread loads its chunk's weights and indices once and runs the
// reduction once per tree (wide rows re-read a row per tree, from L1).
// A tree's candidates and keys are exactly a single-lane call's on its
// dist/active, so each tree is bit-identical to it.  Bound:
// fused.wave_bytes(lanes=S), the layout once and 5N + 8R per tree.
//
// C interface: fused_sliced_relax_launch(...) enqueues the key reset and
// both launches on `stream` and returns the first CUDA error (0 =
// launched); fused_sliced_relax_lanes_launch(...) is the same for `lanes`
// trees of `n` vertices each.  `key` is caller-allocated scratch of
// lanes·R u64 words; `blocks` the int4 chunk table of `n_blocks` entries
// made for `chunk` cells over a flat buffer of `cells` cells and `rows`
// rows.

#include <cuda_runtime.h>

#include <climits>

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

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
k2_coo_pass(const float* __restrict__ dist,
            const unsigned char* __restrict__ active,
            const int* __restrict__ osrc, const int* __restrict__ odst,
            const float* __restrict__ ow, unsigned long long* __restrict__ key,
            long long c, long long n, long long rows, int lanes) {
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
  // the single-lane instantiation (kLanes false) runs the body once
  const int trees = kLanes ? lanes : 1;
  for (int tree = 0; tree < trees; ++tree) {
    unsigned long long kv = minkey::kEmpty;  // this entry's key, if any
    int row = -1;
    if (w < minkey::inf()) {
      const float v = candidate(dist + tree * n, active + tree * n, s, w);
      if (v < minkey::inf()) {
        kv = minkey::pack(v, s);
        row = r;
      }
    }
    unsigned long long* __restrict__ tkey = key + tree * rows;
    // A hub's surplus is stored contiguously, so a warp's keys mostly
    // share one row: then the warp takes their min and lane 0 makes the
    // one atomicMin (a row of 17,891 entries at RMAT(20) otherwise
    // serialises as many atomics on one word); else every key makes its
    // own.  The ballot is warp-uniform, so is the skip.
    const unsigned live = __ballot_sync(0xffffffffu, kv != minkey::kEmpty);
    if (live == 0) continue;
    const int row0 = __shfl_sync(0xffffffffu, row, __ffs(live) - 1);
    if (__all_sync(0xffffffffu, kv == minkey::kEmpty || row == row0)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        kv = min(kv, __shfl_xor_sync(0xffffffffu, kv, off));
      if ((threadIdx.x & 31) == 0) atomicMin(tkey + row0, kv);
    } else if (kv != minkey::kEmpty) {
      atomicMin(tkey + row, kv);
    }
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

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
k2_ell_pass(const float* __restrict__ dist_all,
            const unsigned char* __restrict__ active_all,
            const int* __restrict__ flat_idx,
            const float* __restrict__ flat_w, const int4* __restrict__ blocks,
            const unsigned long long* __restrict__ key_all,
            float* __restrict__ best_all, int* __restrict__ arg_all,
            unsigned long long n_cells, unsigned long long n_rows,
            long long n, int lanes) {
  const int4 blk = __ldg(blocks + blockIdx.x);
  const int cell0 = blk.x, row0 = blk.y, log2k = blk.z, cells = blk.w;
  // A chunk past the flat buffer or the rows leaves whole (so the shuffles
  // below stay exact): unsigned, a negative field is past every end.  A
  // chunk larger than kChunk is only cut short, never read past.
  if (static_cast<unsigned>(log2k) > 30u ||
      static_cast<unsigned long long>(static_cast<unsigned>(cell0)) +
              static_cast<unsigned>(cells) > n_cells ||
      static_cast<unsigned long long>(static_cast<unsigned>(row0)) +
              ((static_cast<unsigned>(cells) + (1u << log2k) - 1) >> log2k) >
          n_rows)
    return;
  const long long rows = static_cast<long long>(n_rows);
  const int trees = kLanes ? lanes : 1;   // one pass when kLanes is false
  const int t = threadIdx.x;
  if (log2k <= 5) {
    // k <= 32: cell t + s * kThreads of the chunk, whole rows per warp
    // step; the weights and indices are loaded once for every tree
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
    for (int tree = 0; tree < trees; ++tree) {
      const float* __restrict__ dist = dist_all + tree * n;
      const unsigned char* __restrict__ active = active_all + tree * n;
      const unsigned long long* __restrict__ key = key_all + tree * rows;
      float* __restrict__ best = best_all + tree * rows;
      int* __restrict__ arg = arg_all + tree * rows;
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
    }
  } else {
    // k > 32 (hub_k above a warp): one warp per row, lanes stride the row;
    // the row is re-read (from L1) for each tree
    const int k = 1 << log2k;
    const int lane = t & 31;
    const int nrows = cells >> log2k;
    for (int r = t >> 5; r < nrows; r += kThreads / 32) {
      const int b = cell0 + r * k;
      for (int tree = 0; tree < trees; ++tree) {
        const float* __restrict__ dist = dist_all + tree * n;
        const unsigned char* __restrict__ active = active_all + tree * n;
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
        if (lane == 0)
          finish_row(key_all[tree * rows + row0 + r], best_all + tree * rows,
                     arg_all + tree * rows, row0 + r, sv, sid);
      }
    }
  }
}

template <bool L>
int launch_any(const float* dist, const unsigned char* active,
               const int* flat_idx, const float* flat_w, const int* blocks,
               const int* osrc, const int* odst, const float* ow,
               unsigned long long* key, float* best, int* arg,
               long long rows, long long cells, long long c, long long n,
               int n_blocks, int chunk, int lanes, void* stream) {
  if (rows <= 0 || cells <= 0 || c < 0 || n < 0 || n_blocks <= 0 ||
      chunk != kChunk || lanes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(key, 0xff, lanes * rows * sizeof(*key), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c > 0) {
    const long long nb = (c + kThreads - 1) / kThreads;
    k2_coo_pass<L><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        dist, active, osrc, odst, ow, key, c, n, rows, lanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k2_ell_pass<L><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
      dist, active, flat_idx, flat_w, reinterpret_cast<const int4*>(blocks),
      key, best, arg, cells, rows, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_sliced_relax_launch(
    const float* dist, const unsigned char* active, const int* flat_idx,
    const float* flat_w, const int* blocks, const int* osrc, const int* odst,
    const float* ow, unsigned long long* key, float* best, int* arg,
    long long rows, long long cells, long long c, int n_blocks, int chunk,
    void* stream) {
  return launch_any<false>(dist, active, flat_idx, flat_w, blocks, osrc,
                           odst, ow, key, best, arg, rows, cells, c, 0,
                           n_blocks, chunk, 1, stream);
}

extern "C" int fused_sliced_relax_lanes_launch(
    const float* dist, const unsigned char* active, const int* flat_idx,
    const float* flat_w, const int* blocks, const int* osrc, const int* odst,
    const float* ow, unsigned long long* key, float* best, int* arg,
    long long rows, long long cells, long long c, long long n, int n_blocks,
    int chunk, int lanes, void* stream) {
  return launch_any<true>(dist, active, flat_idx, flat_w, blocks, osrc,
                          odst, ow, key, best, arg, rows, cells, c, n,
                          n_blocks, chunk, lanes, stream);
}
