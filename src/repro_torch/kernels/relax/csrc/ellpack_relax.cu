// ellpack_relax.cu — ELLPACK min-plus relaxation wave (kernel K1) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/relax/relax.py::ellpack_relax
// (kernel body _relax_kernel).  Per ELL row r:
//
//   best[r] = min_k offers[idx[r,k]] + w[r,k]
//   arg[r]  = smallest idx[r,k] attaining best[r];  -1 where best[r] == +inf
//
// Bound: device-memory bandwidth.  A wave streams idx and w once
// (R*K*8 bytes), reads the offers vector (N*4 bytes; the gathers hit L2,
// which holds it whole at N = 2^20: 4 MB of the 50 MB) and writes R*8 bytes.
// At R = N = 2^20 and K = 32 that is ~281 MB, ~84 us at 3.35 TB/s.  The
// arithmetic (one add and one compare per cell) is negligible.
//
// Design: one group of LANES = min(32, next_pow2(K)) threads per row (a warp
// for K >= 32, a power-of-two sub-warp below).  Lanes stride over the row so
// neighbouring threads load neighbouring idx/w words (coalesced), then gather
// offers[idx] through the read-only path.  Each lane keeps a running
// (value, id) pair under the lexicographic rule — smaller value wins, among
// equal values the smaller id — and a shuffle-xor reduction within the group
// applies the same rule, so the result is exactly the plain version's
// min-then-smallest-id.  No shared memory, no atomics.  The add is
// __fadd_rn (round-to-nearest, never contracted), so values are bit-identical
// to the plain version's f32 add.
//
// The TPU kernel's (256, K) row blocks and its whole-vector VMEM copy of the
// offers are not carried over: L2 plays the VMEM role here.
//
// C interface: ellpack_relax_launch(...) enqueues one launch on `stream`
// and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void take_min(float& v, int& id, float ov, int oid) {
  if (ov < v || (ov == v && oid < id)) {
    v = ov;
    id = oid;
  }
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
ellpack_relax_kernel(const float* __restrict__ offers,
                     const int* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ best,
                     int* __restrict__ arg, long long rows, int k) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  float v = __int_as_float(0x7f800000);  // +inf
  int id = INT_MAX;
  if (row < rows) {
    const long long base = row * k;
    for (int j = lane; j < k; j += LANES) {
      const int nb = __ldg(idx + base + j);
      take_min(v, id, __fadd_rn(__ldg(offers + nb), __ldg(w + base + j)), nb);
    }
  }
  // every thread of the warp reaches the shuffles (rows past the end carry
  // +inf), so the full mask is exact
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off, LANES);
    const int oid = __shfl_xor_sync(0xffffffffu, id, off, LANES);
    take_min(v, id, ov, oid);
  }
  if (row < rows && lane == 0) {
    best[row] = v;
    arg[row] = isfinite(v) ? id : -1;
  }
}

template <int LANES>
cudaError_t launch(const float* offers, const int* idx, const float* w,
                   float* best, int* arg, long long rows, int k,
                   cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / LANES;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ellpack_relax_kernel<LANES><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(offers, idx, w, best, arg, rows, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ellpack_relax_launch(const float* offers, const int* idx,
                                    const float* w, float* best, int* arg,
                                    long long rows, int k, void* stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 1)
    err = launch<1>(offers, idx, w, best, arg, rows, k, s);
  else if (k <= 2)
    err = launch<2>(offers, idx, w, best, arg, rows, k, s);
  else if (k <= 4)
    err = launch<4>(offers, idx, w, best, arg, rows, k, s);
  else if (k <= 8)
    err = launch<8>(offers, idx, w, best, arg, rows, k, s);
  else if (k <= 16)
    err = launch<16>(offers, idx, w, best, arg, rows, k, s);
  else
    err = launch<32>(offers, idx, w, best, arg, rows, k, s);
  return static_cast<int>(err);
}
