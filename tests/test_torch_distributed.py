"""The port's partition layer and static sharded solve
(``repro_torch.graphs.partition``, ``repro_torch.launch.mesh``,
``repro_torch.core.distributed``) against ``repro.graphs.partition`` and
``repro.core.distributed``.

``partition.py`` equals the reference's on seeded degree data; the mesh
and the collectives behave as the reference's ``shard_map`` primitives
(partitions sharing a device share one gathered tensor); the static
relaxation and deletion epochs and the deletion seeds equal the JAX
``DistributedSSSP``'s at P = 1 in process (its one CPU device), for both
exchanges, and the port at P = 2 and 8 (meshes of the CPU device repeated)
equals its own P = 1.

The delta exchange in the sharded engine: equal to the JAX
``ShardedSSSPDelEngine`` at P = 1 in process in all four (dist, parent,
rounds, messages), and at P = 8 against the JAX sharded engine run in a
subprocess with 8 forced host devices — this file is its worker
(``python tests/test_torch_distributed.py OUT.npz``); (dist, parent) equal
to the single-device engine at every P.  The stream helpers are
test_torch_dist_engine.py's.

Inputs are made from seeds with numpy.  Tolerance: 0 — every array and
counter equal.
"""
import os
import subprocess
import sys

if __name__ == "__main__":   # the P = 8 worker: 8 host devices for jax
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dist_engine as jax_dist_engine  # noqa: E402
from repro.core.distributed import DistConfig as JaxDistConfig  # noqa: E402
from repro.core.distributed import DistributedSSSP as JaxDS  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import SSSPDelEngine as JaxEngine  # noqa: E402
from repro.graphs import generators  # noqa: E402
from repro.graphs import partition as jpart  # noqa: E402
from repro.launch.mesh import _mk  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.distributed import (DistConfig,  # noqa: E402
                                          DistributedSSSP)
from repro_torch.graphs import partition as part  # noqa: E402
from repro_torch.launch.mesh import graph_axes, make_mesh  # noqa: E402
from test_torch_dist_engine import (BACKEND_KW, P8_MESH, SOURCE,  # noqa: E402
                                    STREAM, _ingest, _jax_sharded,
                                    _jax_single, _port, _same, _stream)

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
P8_KNOBS = dict(exchange="delta", delta_cap=16, relax_backend="sliced",
                **BACKEND_KW["sliced"])
P8_STREAM = _stream(seed=29, n=120, m=700)


def _graph(seed=5, n=96, m=600):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    return n, src, dst, w


# ------------------------------------------------------------- partition --
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_matches_reference(parts, seed):
    rng = np.random.default_rng(seed)
    n = 200
    dst = rng.integers(0, n, 900) if seed else np.minimum(
        rng.zipf(1.6, 900) - 1, n - 1)
    got = part.edge_balanced_ranges(n, dst, parts)
    np.testing.assert_array_equal(got, jpart.edge_balanced_ranges(n, dst,
                                                                  parts))
    np.testing.assert_array_equal(part.uniform_ranges(n, parts),
                                  jpart.uniform_ranges(n, parts))
    v = rng.integers(0, n, 50)
    np.testing.assert_array_equal(part.owner_of(v, got),
                                  jpart.owner_of(v, got))
    assert part.pad_ranges_to_equal(got) == jpart.pad_ranges_to_equal(got)
    for mine, theirs in zip(part.edge_balanced_relabeling(n, dst, parts),
                            jpart.edge_balanced_relabeling(n, dst, parts)):
        np.testing.assert_array_equal(mine, theirs)


# ----------------------------------------------------------------- mesh --
def test_mesh_shape_devices_and_errors():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[CPU] * 8)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.size == 8 and graph_axes(mesh) == ("pod", "data", "model")
    assert all(d == CPU for d in mesh.devices)
    with pytest.raises(ValueError, match="8 partitions"):
        make_mesh((8,), ("graph",), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="distinct"):
        make_mesh((2, 2), ("a", "a"), devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible CUDA"):
            make_mesh((2,), ("graph",))


def test_collectives_share_one_gather_per_device():
    """``all_gather`` concatenates in partition order and hands the one
    gathered tensor to every partition on the same device; ``psum`` sums
    on the controller's device; ``shard`` / ``to_host`` round-trip."""
    ds = DistributedSSSP(make_mesh((4,), ("graph",), devices=[CPU] * 4),
                         DistConfig(16, 8, ("graph",)))
    a = np.arange(16, dtype=np.float32)
    parts = ds.shard(a)
    assert [t.tolist() for t in parts] == [a[i:i + 4].tolist()
                                           for i in range(0, 16, 4)]
    full = ds.all_gather(parts)
    assert all(f is full[0] for f in full)
    assert full[0].tolist() == a.tolist()
    assert int(ds.psum([t.sum() for t in parts])) == int(a.sum())
    np.testing.assert_array_equal(ds.to_host(parts), a)
    np.testing.assert_array_equal(dist_mod.inactive_dst_layout(3, 5, 2),
                                  [0, 0, 5, 5, 10, 10])
    occ = dist_mod.per_partition_occupancy([t > 5 for t in parts], CPU)
    assert occ.tolist() == [0, 2, 4, 4] and occ.dtype == torch.int32


@pytest.mark.parametrize("P", [1, 2, 8])
def test_place_edges_matches_loop_and_reference(P):
    """Vectorized placement equals a per-partition loop (and the JAX
    placement at P = 1, its one device); overflow raises."""
    n, src, dst, w = _graph()
    n_pad = P * (-(-n // P))
    epp = 2 * (-(-len(src) // P)) + 8
    ds = DistributedSSSP(make_mesh((P,), ("graph",), devices=[CPU] * P),
                         DistConfig(n_pad, epp, ("graph",)))
    got = ds.place_edges(src, dst, w)
    npp = n_pad // P
    want_dst = dist_mod.inactive_dst_layout(P, npp, epp)
    want = [np.zeros(P * epp, np.int32), want_dst,
            np.zeros(P * epp, np.float32), np.zeros(P * epp, np.bool_)]
    for p in range(P):
        sel = np.nonzero(dst // npp == p)[0]
        at = p * epp + np.arange(len(sel))
        want[0][at], want[1][at], want[2][at] = src[sel], dst[sel], w[sel]
        want[3][at] = True
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    if P == 1:
        jds = JaxDS(_mk((1,), ("graph",)),
                    JaxDistConfig(n_pad, epp, ("graph",)))
        for g, x in zip(got, jds.place_edges(src, dst, w)):
            np.testing.assert_array_equal(g, x)
    with pytest.raises(ValueError, match="partition overflow"):
        DistributedSSSP(ds.mesh, DistConfig(n_pad, 2, ("graph",))
                        ).place_edges(src, dst, w)


# ---------------------------------------------------- static solve epochs --
def _port_solve(P, exchange, n, src, dst, w, source, dels, delta_cap=8):
    """The port's static relax epoch from the source, then a delete epoch
    for ``dels`` (edge indices): (dist, parent, relax rounds, seed,
    delete rounds) on the host."""
    n_pad = P * (-(-n // P))
    epp = -(-len(src) // P) + 64
    ds = DistributedSSSP(make_mesh((P,), ("graph",), devices=[CPU] * P),
                         DistConfig(n_pad, epp, ("graph",), exchange=exchange,
                                    delta_cap=delta_cap))
    es, ed, ew, ea = ds.place_edges(src, dst, w)
    d, p = ds.init_vertex_arrays(source)
    d, p, r = ds.make_relax_epoch()(d, p, ds.frontier_of(np.array([source])),
                                    ds.put_edges(es, ed, ew, ea))
    out = [ds.to_host(d), ds.to_host(p), r]
    seed = ds.make_seed_from_deletions()(p, src[dels], dst[dels])
    keep = np.ones(len(src), bool)
    keep[dels] = False
    es, ed, ew, ea = ds.place_edges(src[keep], dst[keep], w[keep])
    d, p, r2 = ds.make_delete_epoch()(d, p, seed,
                                      ds.put_edges(es, ed, ew, ea))
    return out + [ds.to_host(seed), ds.to_host(d), ds.to_host(p), r2]


def _jax_solve(exchange, n, src, dst, w, source, dels, delta_cap=8):
    epp = len(src) + 64
    ds = JaxDS(_mk((1,), ("graph",)),
               JaxDistConfig(n, epp, ("graph",), exchange=exchange,
                             delta_cap=delta_cap))
    es, ed, ew, ea = ds.place_edges(src, dst, w)
    d, p = ds.init_vertex_arrays(source)
    d, p, r = ds.make_relax_epoch()(d, p, ds.frontier_of(np.array([source])),
                                    *ds.put_edges(es, ed, ew, ea))
    out = [np.asarray(d), np.asarray(p), int(r)]
    pad = jnp.asarray(src[dels], jnp.int32), jnp.asarray(dst[dels], jnp.int32)
    seed = ds.make_seed_from_deletions()(p, *pad)
    keep = np.ones(len(src), bool)
    keep[dels] = False
    es, ed, ew, ea = ds.place_edges(src[keep], dst[keep], w[keep])
    d, p, r2 = ds.make_delete_epoch()(d, p, seed,
                                      *ds.put_edges(es, ed, ew, ea))
    return out + [np.asarray(seed), np.asarray(d), np.asarray(p), int(r2)]


def _tree_deletions(n, src, dst, w, source, k=6):
    """``k`` tree edges of the converged tree plus two non-tree edges."""
    got = _port_solve(1, "allgather", n, src, dst, w, source,
                      np.array([0]))
    parent = got[1]
    tree = np.nonzero(parent[dst] == src)[0]
    other = np.nonzero(parent[dst] != src)[0]
    return np.concatenate([tree[::max(1, len(tree) // k)][:k], other[:2]])


@pytest.mark.parametrize("exchange", ["allgather", "delta"])
def test_static_epochs_match_jax_at_p1(exchange):
    n, src, dst, w = _graph()
    dels = _tree_deletions(n, src, dst, w, 0)
    got = _port_solve(1, exchange, n, src, dst, w, 0, dels)
    want = _jax_solve(exchange, n, src, dst, w, 0, dels)
    assert got[3].any(), "the deletions must seed"
    for i, (g, x) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, x, err_msg=f"field {i}")


@pytest.mark.parametrize("exchange,P", [("allgather", 2), ("allgather", 8),
                                        ("delta", 2), ("delta", 8)])
def test_static_epochs_match_own_p1(exchange, P):
    """More partitions, same answers: (dist, parent) of both epochs and
    the seeds equal P = 1's; under allgather the rounds too (a delta round
    may fall back dense at one P and not another)."""
    n, src, dst, w = _graph(seed=9)
    dels = _tree_deletions(n, src, dst, w, 0)
    one = _port_solve(1, exchange, n, src, dst, w, 0, dels, delta_cap=4)
    got = _port_solve(P, exchange, n, src, dst, w, 0, dels, delta_cap=4)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(got[i][:n], one[i][:n],
                                      err_msg=f"field {i}")
    if exchange == "allgather":
        assert (got[2], got[6]) == (one[2], one[6])


@pytest.mark.parametrize("P", [1, 4])
def test_max_rounds_bounds_the_relax_epoch(P):
    """``DistConfig.max_rounds`` (the straggler bound) stops the static
    relaxation after that many rounds, with the JAX solve's partial tree
    at P = 1."""
    n, src, dst, w = _graph(seed=11)
    ds = DistributedSSSP(make_mesh((P,), ("graph",), devices=[CPU] * P),
                         DistConfig(n, len(src) + 64, ("graph",),
                                    max_rounds=2))
    d, p = ds.init_vertex_arrays(0)
    d, p, r = ds.make_relax_epoch()(d, p, ds.frontier_of(np.array([0])),
                                    ds.put_edges(*ds.place_edges(src, dst,
                                                                 w)))
    jds = JaxDS(_mk((1,), ("graph",)),
                JaxDistConfig(n, len(src) + 64, ("graph",), max_rounds=2))
    jd, jp = jds.init_vertex_arrays(0)
    jd, jp, jr = jds.make_relax_epoch()(
        jd, jp, jds.frontier_of(np.array([0])),
        *jds.put_edges(*jds.place_edges(src, dst, w)))
    assert r == int(jr) == 2
    np.testing.assert_array_equal(ds.to_host(d), np.asarray(jd))
    np.testing.assert_array_equal(ds.to_host(p), np.asarray(jp))


def test_delta_rounds_overflow_and_sparse_both_run():
    """A small delta buffer makes some rounds fall back to dense offers and
    leaves others sparse: count both through the exchange's own flags."""
    n, src, dst, w = _graph(seed=3)
    ds = DistributedSSSP(make_mesh((4,), ("graph",), devices=[CPU] * 4),
                         DistConfig(n, len(src) + 64, ("graph",),
                                    exchange="delta", delta_cap=3))
    seen = []
    real = ds._offers_delta

    def spy(dist, frontier, overflow):
        seen.append(overflow)
        return real(dist, frontier, overflow)

    ds._offers_delta = spy
    d, p = ds.init_vertex_arrays(0)
    ds.make_relax_epoch()(d, p, ds.frontier_of(np.array([0])),
                          ds.put_edges(*ds.place_edges(src, dst, w)))
    assert True in seen and False in seen, seen


# ---------------------------------------------------------- delta exchange --
@pytest.mark.parametrize("backend,use_doubling", [
    ("segment", True), ("segment", False), ("ellpack", True),
    ("sliced", False)])
def test_delta_matches_jax_sharded_p1(backend, use_doubling):
    """The delta exchange at P = 1 equals the JAX sharded engine in all
    four (a buffer of 8 makes rounds overflow); at P = 2 and 8 (dist,
    parent) equal the single-device engine's."""
    knobs = dict(exchange="delta", delta_cap=8, relax_backend=backend,
                 use_doubling=use_doubling, **BACKEND_KW[backend])
    want, _ = _jax_sharded(tuple(sorted(knobs.items())))
    _same(_ingest(_port(1, **knobs), STREAM[2]), want)
    single = _jax_single(backend, use_doubling=use_doubling)
    for P in (2, 8):
        _same(_ingest(_port(P, **knobs), STREAM[2]), single, stats=False)


def _p8_worker(out: str) -> None:
    """Subprocess body: the JAX sharded engine at P = 8 on a (2, 2, 2)
    mesh of forced host devices, P8_KNOBS over P8_STREAM; writes every
    query's dist, parent and stats."""
    assert len(jax.devices()) == 8, jax.devices()
    n, cap, log, _ = P8_STREAM
    eng = jax_dist_engine.ShardedSSSPDelEngine(
        jax_dist_engine.ShardedEngineConfig(n, cap, SOURCE, **P8_KNOBS),
        mesh=_mk(*P8_MESH))
    res = _ingest(eng, log)
    np.savez(out, dist=np.stack([r.dist for r in res]),
             parent=np.stack([r.parent for r in res]),
             rounds=[r.epoch_stats["rounds"] for r in res],
             messages=[r.epoch_stats["messages"] for r in res])


def test_delta_p8_matches_jax_sharded_p8_subprocess(tmp_path):
    """P = 8, delta exchange on the sliced layout: the port on a (2, 2, 2)
    mesh equals the JAX sharded engine on 8 forced host devices in all
    four at every query, and the single-device engine in (dist, parent)."""
    out = tmp_path / "p8.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "..", "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    n, cap, log, _ = P8_STREAM
    eng = _port("2x2x2", log_stream=P8_STREAM, **P8_KNOBS)
    got = _ingest(eng, log)
    assert len(got) == len(want["dist"]) > 2
    np.testing.assert_array_equal(np.stack([r.dist for r in got]),
                                  want["dist"])
    np.testing.assert_array_equal(np.stack([r.parent for r in got]),
                                  want["parent"])
    assert [r.epoch_stats["rounds"] for r in got] == want["rounds"].tolist()
    assert [r.epoch_stats["messages"] for r in got] == \
        want["messages"].tolist()
    single = JaxEngine(JaxConfig(n, cap, SOURCE))
    _same(got, _ingest(single, log), stats=False)


if __name__ == "__main__":
    _p8_worker(sys.argv[1])
