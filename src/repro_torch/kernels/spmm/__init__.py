"""Kernel K4, the ELL gather-reduce SpMM: ``spmm_ell`` (CUDA wrapper),
``spmm_ell_ref`` (plain torch) and ``neighbor_reduce`` (differentiable)."""
