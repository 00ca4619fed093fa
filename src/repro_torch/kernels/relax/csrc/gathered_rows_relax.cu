// gathered_rows_relax.cu — relaxation over a compacted edge list (kernel K3)
// for Hopper, and its lane form.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/relax/gather.py::gathered_rows_relax (kernel body
// _gather_kernel), the wave of the sparse frontier path.  Over E edge slots:
//
//   cand[i]  = src_dist[i] + w[i]          for mask[i], else dropped
//   best[r]  = min of cand[i] over slots with nbr[i] == r   (+inf if none)
//   arg[r]   = smallest src_ids[i] attaining best[r]; INT_MAX where no
//              slot gives a finite candidate
//
// Bound: device-memory bandwidth.  Each input read once and each output
// written once is E mask bytes, 16 bytes per masked-in slot (src_dist,
// src_ids, nbr, w) and 8R (best, arg): gather.wave_bytes.  On the sparse
// path E is the capacity-ladder rung's edge + overflow budget (16,384 at
// the low rung) and R the vertex count (2^20), so the 8R bytes of the
// outputs are almost all of it: 8.41 MB, 0.0025 ms at 3.35 TB/s.  The
// arithmetic is negligible.
//
// Design: the R-sized work is only the output fill, written once.  Three
// launches on one stream:
//  1. best = +inf and arg = INT_MAX over R (16-byte stores), and, in the
//     same launch, key[nbr[i]] = minkey::kNoCandidate for every masked-in
//     slot i.  `key` is R words of uninitialised scratch: only the rows a
//     slot touches are ever read, so no [R] reset is needed.
//  2. each masked-in slot with a finite candidate scatters its (value,
//     source id) key into its row with one 64-bit atomicMin (minkey.cuh):
//     the min value and the smallest source id in one pass, in any order.
//  3. each masked-in slot reads its row's key and, where it holds a
//     candidate, writes the row's best and arg; all writers of a row write
//     the same words.  It is its own launch so that it sees every atomic
//     of launch 2.
// kNoCandidate = pack(+inf, INT_MAX) is greater than every finite key and
// decodes to the contract's (+inf, INT_MAX), so no row needs a "was it
// hit" branch.  The TPU kernel needs two scatter passes (values, then ids
// gated on the row minimum) because the TPU has no atomics; it routes
// masked slots to an out-of-range row and drops them, which here is a
// branch.  The wrapper makes no host sync, so a call can be captured in a
// CUDA graph.
//
// The lane form replaces the same TPU kernel under the reference's
// jax.vmap over S trees (src/repro/core/frontier.py's sparse_*_batched),
// where the lane axis becomes a grid axis of one pallas_call.  Inputs are
// [S, E], outputs [S, R]: the same three launches over the S * E slots,
// slot i of lane s = i / E keyed at row s * R + nbr[i] of an [S, R] key
// scratch (64-bit row indices, so S * R is bounded by the card's memory
// and not by 2^31), and the fill over all S * R outputs as one flat
// array.  Bound:
// S * E + 16 * (masked-in slots of all lanes) + 8 * S * R bytes
// (gather.wave_bytes with lanes=S); at S = 4, E = 16,384, R = 2^20 the
// [S, R] outputs are 33.6 of at most 34.7 MB, 0.010 ms at 3.35 TB/s.  Each
// lane compacts its own frontier, so the lanes' edge lists share no source
// gathers and the lane-minor interleave of K1's and K2's lane forms
// (lane_minor.cuh) has nothing to share here: the lane form saves the
// launches and host submissions of S single-lane calls, not bytes.
//
// C interface: gathered_rows_relax_launch(...) enqueues the three launches
// on `stream` and returns the first CUDA error (0 = launched);
// gathered_rows_relax_lanes_launch(...) the same for `lanes` lanes of `e`
// slots and `rows` rows each.  `key` is caller-allocated scratch of
// lanes * rows u64 words; `best` and `arg` must be 16-byte aligned.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "minkey.cuh"

namespace {

constexpr int kThreads = 256;

// The key / output row of slot i: nbr[i], in the lane form offset by the
// rows of the lanes before slot i's (`e` slots and `rows` rows a lane).
template <bool kLanes>
__device__ __forceinline__ long long row_of(const int* __restrict__ nbr,
                                            long long i, long long e,
                                            long long rows) {
  const long long r = __ldg(nbr + i);
  return kLanes ? (i / e) * rows + r : r;
}

// `total` slots and `out` outputs (all lanes); `e` slots and `rows` rows a
// lane for row_of
template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
k3_fill(const int* __restrict__ nbr, const unsigned char* __restrict__ mask,
        unsigned long long* __restrict__ key, float* __restrict__ best,
        int* __restrict__ arg, long long total, long long out, long long e,
        long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long r = 4 * i;   // this thread's four output rows
  if (r + 4 <= out) {
    reinterpret_cast<float4*>(best)[i] =
        make_float4(minkey::inf(), minkey::inf(), minkey::inf(),
                    minkey::inf());
    reinterpret_cast<int4*>(arg)[i] =
        make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  } else {
    for (long long j = r; j < r + 4 && j < out; ++j) {
      best[j] = minkey::inf();
      arg[j] = INT_MAX;
    }
  }
  if (i < total && __ldg(mask + i))
    key[row_of<kLanes>(nbr, i, e, rows)] = minkey::kNoCandidate;
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
k3_scatter(const float* __restrict__ src_dist,
           const int* __restrict__ src_ids, const int* __restrict__ nbr,
           const float* __restrict__ w, const unsigned char* __restrict__ mask,
           unsigned long long* __restrict__ key, long long total, long long e,
           long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total || !__ldg(mask + i)) return;
  const float v = __fadd_rn(__ldg(src_dist + i), __ldg(w + i));
  if (v < minkey::inf())
    atomicMin(key + row_of<kLanes>(nbr, i, e, rows),
              minkey::pack(v, __ldg(src_ids + i)));
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
k3_write(const int* __restrict__ nbr, const unsigned char* __restrict__ mask,
         const unsigned long long* __restrict__ key, float* __restrict__ best,
         int* __restrict__ arg, long long total, long long e, long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total || !__ldg(mask + i)) return;
  const long long r = row_of<kLanes>(nbr, i, e, rows);
  const unsigned long long kv = key[r];   // written by launches 1 and 2
  if (kv != minkey::kNoCandidate) {
    best[r] = minkey::value(kv);
    arg[r] = minkey::id(kv);
  }
}

unsigned grid(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <bool kLanes>
int launch_all(const float* src_dist, const int* src_ids, const int* nbr,
               const float* w, const unsigned char* mask,
               unsigned long long* key, float* best, int* arg, long long e,
               long long rows, long long lanes, cudaStream_t s) {
  const long long total = lanes * e, out = lanes * rows;
  const long long fill_threads = (out + 3) / 4 > total ? (out + 3) / 4
                                                       : total;
  k3_fill<kLanes><<<grid(fill_threads), kThreads, 0, s>>>(
      nbr, mask, key, best, arg, total, out, e, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || total == 0) return static_cast<int>(err);
  k3_scatter<kLanes><<<grid(total), kThreads, 0, s>>>(
      src_dist, src_ids, nbr, w, mask, key, total, e, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_write<kLanes><<<grid(total), kThreads, 0, s>>>(nbr, mask, key, best,
                                                    arg, total, e, rows);
  return static_cast<int>(cudaGetLastError());
}

// the fill's 16-byte stores need 16-byte aligned outputs (the wrapper
// allocates them)
bool bad_args(const float* best, const int* arg, long long e, long long rows,
              long long lanes) {
  return rows <= 0 || e < 0 || lanes <= 0 ||
         ((reinterpret_cast<std::uintptr_t>(best) |
           reinterpret_cast<std::uintptr_t>(arg)) & 15u) != 0;
}

}  // namespace

extern "C" int gathered_rows_relax_launch(
    const float* src_dist, const int* src_ids, const int* nbr, const float* w,
    const unsigned char* mask, unsigned long long* key, float* best, int* arg,
    long long e, long long rows, void* stream) {
  if (bad_args(best, arg, e, rows, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_all<false>(src_dist, src_ids, nbr, w, mask, key, best, arg,
                           e, rows, 1, static_cast<cudaStream_t>(stream));
}

extern "C" int gathered_rows_relax_lanes_launch(
    const float* src_dist, const int* src_ids, const int* nbr, const float* w,
    const unsigned char* mask, unsigned long long* key, float* best, int* arg,
    long long e, long long rows, long long lanes, void* stream) {
  if (bad_args(best, arg, e, rows, lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_all<true>(src_dist, src_ids, nbr, w, mask, key, best, arg, e,
                          rows, lanes, static_cast<cudaStream_t>(stream));
}
