"""Relaxation backends for the port's engine.  Importing this package
populates ``BACKENDS`` with the ported backends:

  * ``segment`` — portable COO scatter-min (backends/segment.py);
  * ``ellpack`` — dense by-destination ELL block, incrementally maintained,
    every wave on kernel K1 (backends/ellpack.py);
  * ``sliced`` — hub-aware hybrid: per-slice-width ELL + overflow COO lane,
    waves on K1 per run of slices or on kernel K2 (backends/sliced.py).

``relax_backend="auto"`` (``AUTO_BACKEND``) is the engine's: dense ELL that
falls back to sliced when a rebuild reports hub blowup.
"""
from repro_torch.core.backends.base import (AUTO_BACKEND, BACKENDS,
                                            ELL_BLOWUP_RATIO, RelaxBackend,
                                            make_backend, rank_within_rows,
                                            register, validate_backend_config)
from repro_torch.core.backends.segment import SegmentBackend
from repro_torch.core.backends.ellpack import (EllPlanner, EllState,
                                               EllpackBackend, ell_append,
                                               ell_delete, ell_update_min)
from repro_torch.core.backends.sliced import (SlicedBackend, SlicedEllPlanner,
                                              SlicedEllState, SlicedPlan,
                                              sliced_append, sliced_delete,
                                              sliced_spill, sliced_update_min)

__all__ = [
    "AUTO_BACKEND", "BACKENDS", "ELL_BLOWUP_RATIO", "RelaxBackend",
    "make_backend", "rank_within_rows", "register", "validate_backend_config",
    "SegmentBackend", "EllpackBackend", "EllPlanner", "EllState",
    "ell_append", "ell_delete", "ell_update_min",
    "SlicedBackend", "SlicedEllPlanner", "SlicedEllState", "SlicedPlan",
    "sliced_append", "sliced_delete", "sliced_spill", "sliced_update_min",
]
