"""Relaxation backends for the port's engine.  Importing this package
populates ``BACKENDS`` with the ported backends:

  * ``segment`` — portable COO scatter-min (backends/segment.py);
  * ``ellpack`` — dense by-destination ELL block, incrementally maintained,
    every wave on kernel K1 (backends/ellpack.py);
  * ``sliced`` — hub-aware hybrid: per-slice-width ELL + overflow COO lane,
    waves on K1 per run of slices or on kernel K2 (backends/sliced.py).

``relax_backend="auto"`` (``AUTO_BACKEND``) is the engine's: dense ELL that
falls back to sliced when a rebuild reports hub blowup.

``SHARDED_BACKENDS`` holds their sharded coordinators (``ShardedSegment``,
``ShardedEllpack``, ``ShardedSliced``), which the sharded engine builds
through ``make_sharded_backend``.
"""
from repro_torch.core.backends.base import (AUTO_BACKEND, BACKENDS,
                                            ELL_BLOWUP_RATIO,
                                            SHARDED_BACKENDS, WAVE_SCHEDULES,
                                            RelaxBackend, ShardedBackend,
                                            make_backend,
                                            make_sharded_backend,
                                            rank_within_rows, register,
                                            register_sharded,
                                            validate_backend_config)
from repro_torch.core.backends.segment import (SegmentBackend, ShardedSegment,
                                               shard_segment_wave)
from repro_torch.core.backends.ellpack import (EllPlanner, EllState,
                                               EllpackBackend, ShardedEllpack,
                                               ell_append, ell_delete,
                                               ell_invariants, ell_update_min)
from repro_torch.core.backends.sliced import (ShardedSliced, SlicedBackend,
                                              SlicedEllPlanner,
                                              SlicedEllState, SlicedPlan,
                                              sliced_append, sliced_delete,
                                              sliced_invariants, sliced_spill,
                                              sliced_update_min)

RELAX_BACKENDS = tuple(sorted(BACKENDS))

__all__ = [
    "AUTO_BACKEND", "BACKENDS", "ELL_BLOWUP_RATIO", "RELAX_BACKENDS",
    "WAVE_SCHEDULES", "RelaxBackend",
    "make_backend", "rank_within_rows", "register", "validate_backend_config",
    "SHARDED_BACKENDS", "ShardedBackend", "make_sharded_backend",
    "register_sharded",
    "SegmentBackend", "ShardedSegment", "shard_segment_wave",
    "EllpackBackend", "ShardedEllpack", "EllPlanner", "EllState",
    "ell_append", "ell_delete", "ell_invariants", "ell_update_min",
    "SlicedBackend", "ShardedSliced", "SlicedEllPlanner", "SlicedEllState",
    "SlicedPlan", "sliced_append", "sliced_delete", "sliced_invariants",
    "sliced_spill", "sliced_update_min",
]
