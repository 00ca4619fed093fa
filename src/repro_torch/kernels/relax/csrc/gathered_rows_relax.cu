// gathered_rows_relax.cu — relaxation over a compacted edge list (kernel K3)
// for Hopper.
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
// written once is 17E (src_dist, src_ids, nbr, w: 4 B each; mask 1 B) +
// 8R (best, arg) bytes.  On the sparse path E is the capacity-ladder rung's
// edge + overflow budget, R the vertex count; the arithmetic is negligible.
//
// Design, two launches on one stream: one thread per edge slot scatters a
// masked-in finite candidate's (value, source id) key into its row with one
// 64-bit atomicMin (minkey.cuh), which yields the min value and the smallest
// source id in one pass, whatever order the atomics land in; then one
// thread per row splits the key into best and arg.  The TPU kernel needs
// two scatter passes (values, then ids gated on the row minimum) because
// the TPU has no atomics; it routes masked slots to an out-of-range row and
// drops them, which here is a branch.
//
// C interface: gathered_rows_relax_launch(...) enqueues the key reset and
// both launches on `stream` and returns the first CUDA error (0 = launched).
// `key` is caller-allocated scratch of `rows` u64 words.

#include <cuda_runtime.h>

#include <climits>

#include "minkey.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
edge_scatter_kernel(const float* __restrict__ src_dist,
                    const int* __restrict__ src_ids,
                    const int* __restrict__ nbr, const float* __restrict__ w,
                    const unsigned char* __restrict__ mask,
                    unsigned long long* __restrict__ key, long long e) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= e || !__ldg(mask + i)) return;
  const float v = __fadd_rn(__ldg(src_dist + i), __ldg(w + i));
  if (v < minkey::inf())
    minkey::scatter_min(key, __ldg(nbr + i), v, __ldg(src_ids + i));
}

__global__ void __launch_bounds__(kThreads)
split_keys_kernel(const unsigned long long* __restrict__ key,
                  float* __restrict__ best, int* __restrict__ arg,
                  long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (r >= rows) return;
  const unsigned long long kv = key[r];
  const bool hit = kv != minkey::kEmpty;
  best[r] = hit ? minkey::value(kv) : minkey::inf();
  arg[r] = hit ? minkey::id(kv) : INT_MAX;
}

}  // namespace

extern "C" int gathered_rows_relax_launch(
    const float* src_dist, const int* src_ids, const int* nbr, const float* w,
    const unsigned char* mask, unsigned long long* key, float* best, int* arg,
    long long e, long long rows, void* stream) {
  if (rows <= 0 || e < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(key, 0xff, rows * sizeof(*key), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e > 0) {
    const long long blocks = (e + kThreads - 1) / kThreads;
    edge_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src_dist, src_ids, nbr, w, mask, key, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + kThreads - 1) / kThreads;
  split_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      key, best, arg, rows);
  return static_cast<int>(cudaGetLastError());
}
