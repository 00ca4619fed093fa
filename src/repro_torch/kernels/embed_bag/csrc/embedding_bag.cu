// embedding_bag.cu — embedding-bag lookup (kernel K5) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/embed_bag/embed_bag.py::embedding_bag (kernel body
// _make_kernel), the recsys table lookup:
//
//   out[b, :] = agg over l with idx[b,l] >= 0 of table[idx[b,l], :]
//
// agg sum / mean over a table in f32 or bf16.  The body, its numerics and
// its design are ../../csrc/gather_reduce.cuh's, with a slot live where its
// index is >= 0: a -1 padding slot is never added (its load reads row 0, a
// cached line), a live index past the table is clamped to its last row as
// the plain version (ref.py) clamps it, and the result is bit-identical to
// that plain version.  At DIN's D = 18 a bag is one warp, one feature a
// lane, with 32 rows in flight, so a 100-slot bag takes 4 steps of one load
// latency each.  The TPU
// kernel's per-slot row DMA, its B % bb constraint and the lane padding of
// D are not carried over.
//
// Bound: device-memory bandwidth.  The function reads each distinct live
// row once (U rows of D elements) and every index (4BL bytes: a padding
// slot is found by reading it), and writes BD elements; one add per live
// slot and feature.  At DIN's train_batch (V = 10,485,760, D = 18, B =
// 65,536, L = 100, history lengths U[25,100]) ~3.4M distinct rows: ~0.08
// ms at 3.35 TB/s in f32.  A row is 72 B in f32 and 36 B in bf16, under one
// 128-B line, so most of each line fetched for a row is other rows' data.
//
// C interface: embedding_bag_launch(...) enqueues one launch on `stream`
// and returns cudaGetLastError() (0 = launched).

#include "../../csrc/gather_reduce.cuh"

// table (v, d); idx (bags, l); dtype: 0 = f32, 1 = bf16 (table and out);
// agg: 0 sum, 1 mean.
extern "C" int embedding_bag_launch(const void* table, const int* idx,
                                    void* out, long long bags, int l, int d,
                                    int v, int agg, int dtype, void* stream) {
  if (agg != gather_reduce::kSum && agg != gather_reduce::kMean)
    return static_cast<int>(cudaErrorInvalidValue);
  return gather_reduce::launch<false>(table, idx, nullptr, out, bags, l, d, v,
                                      agg, dtype, stream);
}
