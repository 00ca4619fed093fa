"""Relaxation backends for the port's engine.  Importing this package
populates ``BACKENDS`` with the ported backends:

  * ``segment`` — portable COO scatter-min (backends/segment.py);
  * ``ellpack`` — dense by-destination ELL block, incrementally maintained,
    every wave on kernel K1 (backends/ellpack.py).
"""
from repro_torch.core.backends.base import (BACKENDS, ELL_BLOWUP_RATIO,
                                            RelaxBackend, make_backend,
                                            rank_within_rows, register,
                                            validate_backend_config)
from repro_torch.core.backends.segment import SegmentBackend
from repro_torch.core.backends.ellpack import (EllPlanner, EllState,
                                               EllpackBackend, ell_append,
                                               ell_delete, ell_update_min)

__all__ = [
    "BACKENDS", "ELL_BLOWUP_RATIO", "RelaxBackend", "make_backend",
    "rank_within_rows", "register", "validate_backend_config",
    "SegmentBackend", "EllpackBackend", "EllPlanner", "EllState",
    "ell_append", "ell_delete", "ell_update_min",
]
