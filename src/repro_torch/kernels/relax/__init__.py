"""Kernel K1, the ELLPACK min-plus relaxation wave: ``ellpack_relax``
(CUDA wrapper), ``ellpack_relax_ref`` (plain torch) and ``relax_wave``."""
