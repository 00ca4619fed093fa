"""Hand-written Hopper kernels of the port (CUDA C++ under ``*/csrc/``,
built at first use by ``kernels/build.py``), each beside its plain torch
version."""
