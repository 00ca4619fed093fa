"""Property-based tests of the port's engine (``repro_torch.testing``:
hypothesis, or its seeded fallback): for *any* valid event stream, after
any prefix ending at an epoch boundary the port's distances equal
Dijkstra on the snapshot and the parent pointers form a tight
shortest-path tree — the three properties of ``tests/test_sssp_property.py``
on ``repro_torch.core.engine`` (N = 24, the reference's ``max_examples``).
A fourth property holds the port to the JAX engine on the same stream, on
the segment and dense-ELL backends: ``dist`` and ``parent`` bit for bit.
Every engine takes one ``edge_capacity`` (4·60 + 8, enough for the longest
stream), so the JAX engine compiles once per backend.
"""
import numpy as np

from repro.core import events as jev
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SSSPDelEngine as JEngine
from repro_torch.core import events as ev
from repro_torch.core.engine import EngineConfig, SSSPDelEngine
from repro_torch.core.oracle import check_tree, edges_of_pool
from repro_torch.testing import given, settings, st

N = 24  # small vertex universe keeps shrinking effective
CAPACITY = 4 * 60 + 8


@st.composite
def event_streams(draw):
    n_ev = draw(st.integers(min_value=1, max_value=60))
    kinds, srcs, dsts, ws = [], [], [], []
    live: set[tuple[int, int]] = set()
    for _ in range(n_ev):
        u = draw(st.integers(0, N - 1))
        v = draw(st.integers(0, N - 1))
        if u == v:
            continue
        if (u, v) in live and draw(st.booleans()):
            kinds.append(ev.DEL); srcs.append(u); dsts.append(v); ws.append(0.0)
            live.discard((u, v))
        else:
            w = draw(st.floats(min_value=0.1, max_value=8.0,
                               allow_nan=False, allow_infinity=False))
            kinds.append(ev.ADD); srcs.append(u); dsts.append(v); ws.append(w)
            live.add((u, v))
    if not kinds:
        kinds, srcs, dsts, ws = [ev.ADD], [0], [1], [1.0]
    return ev.EventLog(np.asarray(kinds, np.uint8), np.asarray(srcs, np.int64),
                       np.asarray(dsts, np.int64), np.asarray(ws, np.float32))


def _engine(source, **kw):
    return SSSPDelEngine(EngineConfig(N, CAPACITY, source, device="cpu",
                                      **kw))


def _check(eng, source):
    res = eng.query()
    e = eng.state.edges
    es, ed, ew = edges_of_pool(*(t.numpy() for t in (e.src, e.dst, e.w,
                                                     e.active)))
    check_tree(N, es, ed, ew, source, res.dist, res.parent)
    return res


@settings(max_examples=25, deadline=None)
@given(log=event_streams(), source=st.integers(0, N - 1),
       batch_dels=st.booleans(), doubling=st.booleans())
def test_engine_matches_oracle_on_any_stream(log, source, batch_dels, doubling):
    eng = _engine(source, batch_deletions=batch_dels, use_doubling=doubling)
    eng.ingest_log(log)
    _check(eng, source)


@settings(max_examples=15, deadline=None)
@given(log=event_streams(), source=st.integers(0, N - 1),
       cut=st.integers(1, 50))
def test_oracle_holds_at_every_prefix(log, source, cut):
    eng = _engine(source)
    eng.ingest_log(log[:min(cut, len(log))])
    _check(eng, source)


@settings(max_examples=10, deadline=None)
@given(log=event_streams(), source=st.integers(0, N - 1))
def test_dist_never_negative_and_source_zero(log, source):
    eng = _engine(source)
    eng.ingest_log(log)
    res = eng.query()
    assert res.dist[source] == 0.0
    finite = res.dist[np.isfinite(res.dist)]
    assert (finite >= 0).all()


@settings(max_examples=10, deadline=None)
@given(log=event_streams(), source=st.integers(0, N - 1),
       backend=st.sampled_from(["segment", "ellpack"]))
def test_engine_matches_jax_engine_on_any_stream(log, source, backend):
    eng = _engine(source, relax_backend=backend)
    eng.ingest_log(log)
    res = _check(eng, source)
    jeng = JEngine(JEngineConfig(N, CAPACITY, source, relax_backend=backend))
    jeng.ingest_log(jev.EventLog(log.kind, log.src, log.dst, log.w))
    jres = jeng.query()
    np.testing.assert_array_equal(res.dist, jres.dist)
    np.testing.assert_array_equal(res.parent, jres.parent)
