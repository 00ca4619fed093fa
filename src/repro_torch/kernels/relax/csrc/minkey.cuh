// minkey.cuh — the (value, source id) min key shared by kernels K1
// (ellpack_relax.cu), K2 (fused_sliced_relax.cu) and K3
// (gathered_rows_relax.cu).
//
// Every relaxation candidate is dist + w with dist >= 0 or +inf and w > 0 or
// +inf, so it is a non-negative float or +inf, and the IEEE bit patterns of
// such floats order exactly like their values.  Packing
//
//   key = (float_bits(value) << 32) | uint32(source id)
//
// makes one unsigned 64-bit min compute the repository's tie rule — the
// smallest value, and among equal values the smallest source id — so a
// scatter-min over rows is one atomicMin per candidate, in any order, with a
// result independent of that order.  Source ids are vertex ids in
// [0, 2^31), so their unsigned order is their signed order.  A row whose key
// stays kEmpty (K2's reset value, all ones) received no finite candidate;
// kNoCandidate = pack(+inf, INT_MAX) is greater than the key of every
// finite candidate as well, and decodes to (+inf, INT_MAX) itself.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace minkey {

constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned long long kNoCandidate =
    (0x7f800000ull << 32) | 0x7fffffffull;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ unsigned long long pack(float v, int id) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned int>(id);
}

__device__ __forceinline__ float value(unsigned long long k) {
  return __uint_as_float(static_cast<unsigned int>(k >> 32));
}

__device__ __forceinline__ int id(unsigned long long k) {
  return static_cast<int>(k & 0xffffffffull);
}

// Scatter one finite candidate into row `row`'s key.
__device__ __forceinline__ void scatter_min(unsigned long long* key, int row,
                                            float v, int src) {
  atomicMin(key + row, pack(v, src));
}

// The same rule on an unpacked running (value, id) pair.
__device__ __forceinline__ void take_min(float& v, int& id, float ov,
                                         int oid) {
  if (ov < v || (ov == v && oid < id)) {
    v = ov;
    id = oid;
  }
}

}  // namespace minkey
