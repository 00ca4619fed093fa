// spmm_ell.cu — ELL gather-reduce SpMM (kernel K4) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmm/spmm.py::spmm_ell
// (kernel body _make_kernel), GNN neighbour aggregation:
//
//   out[i, f] = agg over k with mask[i,k] of feats[idx[i,k], f]
//
// agg sum / mean / max over feats in f32 or bf16.  The body, its numerics
// and its design are ../../csrc/gather_reduce.cuh's, with the mask read
// from `mask`: a masked cell's index is never used (the sampler writes -1
// there), a live one is clamped into [0, S) as the plain version (ref.py)
// clamps it, and the result is bit-identical to that plain version.  The
// TPU kernel's (S, bf) VMEM feature panel and its R % bm and F % bf
// constraints are not carried over.
//
// Bound: device-memory bandwidth.  The function reads each distinct
// gathered row once (U rows of F elements), the mask (RK bytes) and the
// live cells' indices (4 bytes each), and writes RF elements; the
// arithmetic is one add or compare per live cell and feature.  At
// GraphSAGE-Reddit's minibatch_lg (R = 16,384, K = 15, F = 602, 168,960
// distinct rows, f32) that is ~447 MB, ~0.1335 ms at 3.35 TB/s.
//
// C interface: spmm_ell_launch(...) enqueues one launch on `stream` and
// returns cudaGetLastError() (0 = launched).

#include "../../csrc/gather_reduce.cuh"

// feats (s, f); idx, mask (rows, k); dtype: 0 = f32, 1 = bf16 (feats and
// out); agg: 0 sum, 1 mean, 2 max.
extern "C" int spmm_ell_launch(const void* feats, const int* idx,
                               const unsigned char* mask, void* out,
                               long long rows, int k, int f, int s, int agg,
                               int dtype, void* stream) {
  return gather_reduce::launch<true>(feats, idx, mask, out, rows, k, f, s,
                                     agg, dtype, stream);
}
