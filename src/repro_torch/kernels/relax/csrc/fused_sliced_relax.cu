// fused_sliced_relax.cu — one whole hybrid sliced-ELL + overflow-COO
// relaxation wave (kernel K2) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/relax/fused.py::fused_sliced_relax (kernel body
// _mk_kernel).  For every row r of the flat sliced-ELL layout:
//
//   offers[v] = active[v] ? dist[v] : +inf
//   ELL lane  : cells [base[r], base[r] + rowk[r]) of (flat_idx, flat_w)
//   COO lane  : overflow entries i with odst[i] == r
//   best[r]   = min over both lanes of offers[src] + w
//   arg[r]    = smallest src attaining best[r]; INT_MAX where best is +inf
//
// which is combine_lanes(sliced_gather_min, overflow_min) of the sliced
// backend, bit for bit.
//
// Bound: device-memory bandwidth.  Each input read once and each output
// written once is 5N (dist f32 + active bool) + 8L (flat idx/w) + 12C
// (overflow src/dst/w) + 8R (best/arg) bytes; at the RMAT(20) main path's
// final shapes (N = R = 2^20, L ~ 26.4M, C = 2^23) that is ~326 MB, ~97 us
// at 3.35 TB/s.  The arithmetic (one add and one compare per candidate) is
// negligible.
//
// Design, two launches on one stream:
//  (a) the COO lane: one thread per overflow entry.  A live entry (finite
//      w) whose source is active scatters its (value, src) key into the
//      row's u64 key with one atomicMin (minkey.cuh).  The TPU kernel
//      rescans the whole COO segment once per distinct-width run (2,356
//      runs at the RMAT(20) window); here it is read once per wave.
//  (b) the ELL lane over all R rows at once: a power-of-two group of
//      LANES = min(32, next_pow2(max width)) threads per row (K1's mapping)
//      strides over the row's rowk[r] cells, keeps a running (value, id)
//      pair under the lexicographic rule, reduces it by shuffles, and lane 0
//      folds in the row's COO key and writes best/arg.  The active mask is
//      applied in the gather, so the masked offers vector never exists.
// The lexicographic min over the union of the two lanes is exactly
// combine_lanes, because each lane already yields its smallest minimising
// id.  Adds are __fadd_rn (never contracted), as in the plain version.
//
// C interface: fused_sliced_relax_launch(...) enqueues the key reset and
// both launches on `stream` and returns the first CUDA error (0 = launched).
// `key` is caller-allocated scratch of R u64 words.

#include <cuda_runtime.h>

#include <climits>

#include "minkey.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
overflow_lane_kernel(const float* __restrict__ dist,
                     const unsigned char* __restrict__ active,
                     const int* __restrict__ osrc,
                     const int* __restrict__ odst,
                     const float* __restrict__ ow,
                     unsigned long long* __restrict__ key, long long c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= c) return;
  const float w = __ldg(ow + i);
  if (!(w < minkey::inf())) return;  // empty or tombstoned entry
  const int s = __ldg(osrc + i);
  if (!__ldg(active + s)) return;
  const float v = __fadd_rn(__ldg(dist + s), w);
  if (v < minkey::inf()) minkey::scatter_min(key, __ldg(odst + i), v, s);
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
ell_lane_kernel(const float* __restrict__ dist,
                const unsigned char* __restrict__ active,
                const int* __restrict__ flat_idx,
                const float* __restrict__ flat_w,
                const int* __restrict__ base, const int* __restrict__ rowk,
                const unsigned long long* __restrict__ key,
                float* __restrict__ best, int* __restrict__ arg,
                long long rows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  float v = minkey::inf();
  int id = INT_MAX;
  if (row < rows) {
    const long long b = __ldg(base + row);
    const int k = __ldg(rowk + row);
    for (int j = lane; j < k; j += LANES) {
      const int nb = __ldg(flat_idx + b + j);
      const float off = __ldg(active + nb) ? __ldg(dist + nb) : minkey::inf();
      minkey::take_min(v, id, __fadd_rn(off, __ldg(flat_w + b + j)), nb);
    }
  }
  // every thread of the warp reaches the shuffles (rows past the end carry
  // +inf), so the full mask is exact
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off, LANES);
    const int oid = __shfl_xor_sync(0xffffffffu, id, off, LANES);
    minkey::take_min(v, id, ov, oid);
  }
  if (row < rows && lane == 0) {
    const unsigned long long kv = key[row];
    if (kv != minkey::kEmpty)
      minkey::take_min(v, id, minkey::value(kv), minkey::id(kv));
    best[row] = v;
    arg[row] = v < minkey::inf() ? id : INT_MAX;
  }
}

template <int LANES>
cudaError_t launch_ell(const float* dist, const unsigned char* active,
                       const int* flat_idx, const float* flat_w,
                       const int* base, const int* rowk,
                       const unsigned long long* key, float* best, int* arg,
                       long long rows, cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / LANES;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ell_lane_kernel<LANES><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(dist, active, flat_idx, flat_w, base,
                                     rowk, key, best, arg, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_sliced_relax_launch(
    const float* dist, const unsigned char* active, const int* flat_idx,
    const float* flat_w, const int* base, const int* rowk, const int* osrc,
    const int* odst, const float* ow, unsigned long long* key, float* best,
    int* arg, long long rows, long long c, int max_width, void* stream) {
  if (rows <= 0 || c < 0 || max_width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(key, 0xff, rows * sizeof(*key), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c > 0) {
    const long long blocks = (c + kThreads - 1) / kThreads;
    overflow_lane_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        dist, active, osrc, odst, ow, key, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (max_width <= 1)
    err = launch_ell<1>(dist, active, flat_idx, flat_w, base, rowk, key, best,
                        arg, rows, s);
  else if (max_width <= 2)
    err = launch_ell<2>(dist, active, flat_idx, flat_w, base, rowk, key, best,
                        arg, rows, s);
  else if (max_width <= 4)
    err = launch_ell<4>(dist, active, flat_idx, flat_w, base, rowk, key, best,
                        arg, rows, s);
  else if (max_width <= 8)
    err = launch_ell<8>(dist, active, flat_idx, flat_w, base, rowk, key, best,
                        arg, rows, s);
  else if (max_width <= 16)
    err = launch_ell<16>(dist, active, flat_idx, flat_w, base, rowk, key,
                         best, arg, rows, s);
  else
    err = launch_ell<32>(dist, active, flat_idx, flat_w, base, rowk, key,
                         best, arg, rows, s);
  return static_cast<int>(err);
}
