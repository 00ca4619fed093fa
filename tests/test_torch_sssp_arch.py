"""The paper's arch config in the port (``repro_torch.configs.sssp_del``)
against the JAX package's: the dataclass and its ``CONFIG`` / ``REDUCED``
field by field, ``_backend_kw`` for every backend, the registry entry and
its shapes; twins of tests/test_backend_equiv.py's bridge tests
(``make_engine`` on one device and with ``partitions=``, the deprecated
``engine_config`` / ``sharded_engine_config`` shims warning but working);
and engines built from one arch config in both packages, fed the same
sliding-window stream: ``(dist, parent)`` and the epoch stats equal at
every query, rounds and messages equal at the end (tolerance 0), for the
three backends on one device and the segment backend sharded at P = 1.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs import sssp_del as jc_sssp
from repro.core.dist_engine import ShardedSSSPDelEngine as JaxSharded
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro_torch import EngineConfig, ShardedEngineConfig, SSSPDelEngine
from repro_torch.configs import registry as reg
from repro_torch.configs import sssp_del as c_sssp
from repro_torch.core import events as ev
from repro_torch.core.backends.ellpack import EllpackBackend
from repro_torch.core.dist_engine import ShardedSSSPDelEngine
from repro_torch.core.oracle import check_tree


def test_config_equals_reference():
    assert (c_sssp.ARCH_ID, c_sssp.FAMILY) == (jc_sssp.ARCH_ID,
                                               jc_sssp.FAMILY)
    for which in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(c_sssp, which)) == \
            dataclasses.asdict(getattr(jc_sssp, which))
    for backend in ("segment", "ellpack", "sliced"):
        a = dataclasses.replace(c_sssp.REDUCED, relax_backend=backend)
        b = dataclasses.replace(jc_sssp.REDUCED, relax_backend=backend)
        assert a._backend_kw() == b._backend_kw()
    assert reg.arch("sssp-del") is c_sssp
    assert reg.SSSP_SHAPES == jreg.SSSP_SHAPES
    assert reg.FAMILY_SHAPES["sssp"] is reg.SSSP_SHAPES


def test_arch_config_bridges_backend_selection():
    arch = dataclasses.replace(c_sssp.REDUCED, relax_backend="ellpack",
                               num_vertices=64, ell_init_k=2)
    eng = arch.make_engine(edge_capacity=256, source=0, device="cpu")
    assert isinstance(eng, SSSPDelEngine)
    assert isinstance(eng.backend, EllpackBackend)
    eng.ingest_log(ev.adds([0, 1, 2], [1, 2, 3], [1.0, 1.0, 1.0]))
    q = eng.query()
    check_tree(64, *eng.alloc.active_coo(), 0, q.dist, q.parent)
    sh = dataclasses.replace(arch, edges_per_part=256) \
        .make_engine(partitions=1, source=0, device="cpu")
    assert isinstance(sh, ShardedSSSPDelEngine)
    assert sh.cfg.relax_backend == "ellpack" and sh.cfg.ell_init_k == 2
    assert sh.cfg.edges_per_part == 256 and sh.P == 1
    with pytest.raises(ValueError, match="edge_capacity is required"):
        arch.make_engine(source=0, device="cpu")


def test_arch_config_deprecated_bridges_warn_but_work():
    arch = dataclasses.replace(c_sssp.REDUCED, num_vertices=64,
                               edges_per_part=256)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = arch.engine_config(edge_capacity=256, source=0, device="cpu")
        sh_cfg = arch.sharded_engine_config(source=0, device="cpu")
    assert len([w for w in rec
                if issubclass(w.category, DeprecationWarning)]) == 2
    assert isinstance(cfg, EngineConfig)
    assert isinstance(sh_cfg, ShardedEngineConfig)
    assert cfg.num_vertices == 64 and sh_cfg.edges_per_part == 256
    assert sh_cfg.exchange == "allgather" and sh_cfg.delta_cap == 4096


def _stream(seed=5, n=80, m=420):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3, delta=0.6,
                                       seed=seed, query_every=m // 4)
    return n, len(src) + 64, log


@pytest.mark.parametrize("backend,sharded", [
    ("segment", False), ("ellpack", False), ("sliced", False),
    ("segment", True), ("ellpack", True)],
    ids=["segment", "ellpack", "sliced", "segment-P1", "ellpack-P1"])
def test_engines_from_one_arch_config_are_bit_identical(backend, sharded):
    n, cap, log = _stream()
    kw = dict(num_vertices=n, relax_backend=backend, ell_init_k=2,
              sliced_slice_rows=16, sliced_hub_k=4, edges_per_part=cap)
    ours = dataclasses.replace(c_sssp.REDUCED, **kw)
    ref = dataclasses.replace(jc_sssp.REDUCED, **kw)
    if sharded:
        eng = ours.make_engine(partitions=1, source=3, device="cpu")
        jeng = ref.make_engine(partitions=1, source=3)
        assert isinstance(jeng, JaxSharded)
    else:
        eng = ours.make_engine(edge_capacity=cap, source=3, device="cpu")
        jeng = ref.make_engine(edge_capacity=cap, source=3)
        assert isinstance(jeng, JaxEngine)
    got, want = eng.ingest_log(log), jeng.ingest_log(log)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)
        assert g.epoch_stats == w.epoch_stats
    assert (eng.n_rounds, int(eng.n_messages)) == (jeng.n_rounds,
                                                   int(jeng.n_messages))
    if not sharded:   # (the sharded engine is held to the reference's)
        q = eng.query()
        check_tree(n, *eng.alloc.active_coo(), 3, q.dist, q.parent)
