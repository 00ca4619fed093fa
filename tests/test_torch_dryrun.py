"""The port's dry run (``repro_torch.roofline.trace_analysis``,
``repro_torch.launch.dryrun``): the trace's counts against hand counts on
small programs (a bf16 and an f32 matmul, an element-wise chain, the
view / gather / scatter / overwrite floors, a known live peak, host reads
answered per loop), a two-partition SSSP relax and delete epoch on
``meta`` running ``default_trip`` rounds with their collectives counted
and a real run's reads replayed, the LM depth parabola against a whole
trace, and ``run_cell`` / ``main`` on cheap cells giving ``ok`` records
with the reference's keys less its departures (``compile_s``;
``xla_cost_analysis`` -> ``trace_cost``, ``hlo_bytes`` -> ``trace_ops``).
All counts exact."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.core.distributed import DistConfig, DistributedSSSP
from repro_torch.core.state import EdgePool
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.roofline import trace_analysis as ta

ROOT = Path(__file__).resolve().parents[1]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,cls", [(torch.bfloat16, "bf16"),
                                       (torch.float16, "bf16"),
                                       (torch.float32, "f32")])
def test_matmul_flops_and_bytes(dtype, cls):
    M, K, N = 64, 128, 32
    a, b = _meta(M, K, dtype=dtype), _meta(K, N, dtype=dtype)
    cost, out = ta.trace(lambda x, y: x @ y, (a, b))
    assert dict(cost.flops_by_dtype) == {cls: 2 * M * K * N}
    size = a.element_size()
    assert cost.hbm_bytes == (M * K + K * N + M * N) * size
    assert tuple(out.shape) == (M, N) and cost.ops == 1


def test_batched_matmul_and_einsum_flops():
    x, w = _meta(4, 8, 16), _meta(4, 16, 32)
    cost, _ = ta.trace(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       (x, w))
    assert cost.flops == 2 * 4 * 8 * 16 * 32
    assert cost.flops_by_dtype["f32"] == cost.flops


def test_elementwise_chain_bytes_and_live_peak():
    n = 1000
    x = _meta(n)

    def chain(x):
        y = x * 2          # x, y live
        z = y + 1          # x, y, z live: the peak, 3n floats
        del y
        return z.exp()     # x, z, w live
    cost, _ = ta.trace(chain, (x,))
    assert cost.flops == 0 and cost.ops == 3
    assert cost.hbm_bytes == 3 * (4 * n + 4 * n)
    assert cost.arg_bytes == 4 * n
    assert cost.peak_live_bytes == 3 * 4 * n


def test_byte_floors():
    """Views move nothing, an expanded view is read once, a gather reads
    at most the bytes it writes, an in-place scatter touches at most its
    source's bytes, and copy_ does not read its destination."""
    big, idx = _meta(100_000, 8), _meta(50, dtype=torch.int64)
    cost, _ = ta.trace(lambda t: t.view(-1)[:10].unsqueeze(0).T, (big,))
    assert cost.hbm_bytes == 0
    row = _meta(8)
    cost, _ = ta.trace(lambda r: r.expand(1000, 8) * 2, (row,))
    assert cost.hbm_bytes == 8 * 4 + 1000 * 8 * 4
    cost, _ = ta.trace(lambda t, i: t[i], (big, idx))
    assert cost.hbm_bytes == 50 * 8 + 2 * 50 * 8 * 4
    dst, src = _meta(100_000), _meta(50)
    cost, _ = ta.trace(lambda d, i, s: d.scatter_reduce_(0, i, s, "amin"),
                       (dst, idx, src))
    assert cost.hbm_bytes == 2 * 50 * 4 + 50 * 8 + 50 * 4
    a, b = _meta(1000), _meta(1000)
    cost, _ = ta.trace(lambda d, s: d.copy_(s), (a, b))
    assert cost.hbm_bytes == 2 * 4000
    cost, _ = ta.trace(lambda d, s: d.add_(s), (a, b))
    assert cost.hbm_bytes == 3 * 4000


@pytest.mark.parametrize("trip,rounds", [(1.0, 1), (2.5, 3), (4, 4),
                                         (0.2, 1)])
def test_host_reads_run_default_trip_rounds(trip, rounds):
    """A while loop reads its condition first; ``_mark_loop`` (DO_WHILE)
    runs a round first — both run ``ceil(trip)`` rounds, at least one."""
    def _go(flag):            # a read helper, skipped to find the loop
        return bool(flag)

    def loop(x):
        n = 0
        while _go(x.sum() > 0):
            x = x - 1
            n += 1
        return n

    def _mark_loop(x):
        n, live = 0, True
        while live:
            x = x - 1
            n += 1
            live = bool(x.sum() > 0)
        return n

    def both(x):
        return loop(x), _mark_loop(x), loop(x)
    cost, out = ta.trace(both, (_meta(5),), default_trip=trip)
    assert out == (rounds, rounds, rounds)
    assert cost.dynamic_loops == 3
    assert cost.host_reads == 2 * (rounds + 1) + rounds


def _epoch_program(kind, P=2, n=64, epp=48, device="meta"):
    mesh = make_mesh((P,), ("graph",), devices=[device] * P)
    eng = DistributedSSSP(mesh, DistConfig(num_vertices=n,
                                           edges_per_part=epp,
                                           mesh_axes=("graph",)))
    return eng, (eng.make_relax_epoch() if kind == "relax"
                 else eng.make_delete_epoch())


def _meta_args(eng, epp):
    npp = eng.npp

    def parts(dt):
        return [_meta(npp, dtype=dt) for _ in range(eng.P)]
    return (parts(torch.float32), parts(torch.int32), parts(torch.bool),
            [EdgePool(_meta(epp, dtype=torch.int32),
                      _meta(epp, dtype=torch.int32), _meta(epp),
                      _meta(epp, dtype=torch.bool)) for _ in range(eng.P)])


@pytest.mark.parametrize("trip", [1, 3])
@pytest.mark.parametrize("kind", ["relax", "delete"])
def test_sssp_epoch_on_meta_runs_default_trip(kind, trip):
    """Two partitions on meta: the relax epoch reports ``trip`` rounds,
    the delete epoch ``trip`` marking rounds, the pull and ``trip`` push
    rounds; each round all-gathers the dist vector (ring: half of it
    crosses to each partition) and psums the improvement counts."""
    n, epp = 64, 48
    eng, epoch = _epoch_program(kind, n=n, epp=epp)
    cost, out = ta.trace(epoch, _meta_args(eng, epp), default_trip=trip,
                         exchange=eng)
    dist, parent, rounds = out
    assert rounds == (trip if kind == "relax" else 2 * trip + 1)
    assert [tuple(d.shape) for d in dist] == [(n // 2,)] * 2
    if kind == "relax":
        want = trip * 4 * n                  # dist, once a round
    else:   # marking: (aff bool, ptr i32) a round; pull and push: dist
        want = trip * (n + 4 * n) + 4 * n + trip * 4 * n
    assert cost.coll_by_type["all-gather"] == want / 2
    if kind == "relax":   # psums of i64 counts: go (trip + 1), messages
        assert cost.coll_by_type["all-reduce"] == (2 * trip + 1) * 8
    assert cost.coll_by_type["all-reduce"] > 0
    # one shared copy on the one meta device: the second partition's own
    # copy is added to the bytes
    assert cost.bytes_by_op["all_gather(per-partition copies)"] == want


def test_replayed_reads_repeat_a_real_run():
    """The reads of a real CPU run, replayed on meta, run the real run's
    rounds; the trace then equals a default_trip trace of those rounds."""
    n, epp, P = 64, 48, 2
    eng, epoch = _epoch_program("relax", n=n, epp=epp, device="cpu")
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, 80), rng.integers(0, n, 80)
    w = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    pools = eng.put_edges(*eng.place_edges(src, dst, w))
    dist, parent = eng.init_vertex_arrays(int(src[0]))
    front = eng.frontier_of(np.array([src[0]]))
    (_, _, rounds), reads = ta.record_reads(epoch, dist, parent, front,
                                            pools)
    assert rounds >= 2 and len(reads) == rounds + 1
    meng, mepoch = _epoch_program("relax", n=n, epp=epp)
    c1, out = ta.trace(mepoch, _meta_args(meng, epp), answers=reads,
                       exchange=meng)
    assert out[2] == rounds
    c2, _ = ta.trace(mepoch, _meta_args(meng, epp), default_trip=rounds,
                     exchange=meng)
    assert (c1.hbm_bytes, c1.coll_wire_bytes, c1.ops) == \
        (c2.hbm_bytes, c2.coll_wire_bytes, c2.ops)


@pytest.mark.parametrize("arch,shape,ov,depths", [
    ("qwen3-14b", "decode_32k", {"n_layers": 6}, [2, 3, 4]),
    ("minicpm3-4b", "train_4k", {"n_layers": 6}, [2, 3, 4]),
    # sqrt remat: depths a remat group apart, the peak a max over groups
    ("mistral-large-123b", "train_4k",
     {"n_layers": 8, "remat_group": 2, "grad_accum": 2}, [2, 4, 6])],
    ids=["decode", "train", "train-sqrt-remat"])
def test_layer_parabola_equals_a_whole_trace(arch, shape, ov, depths):
    """An LM cell traced at three depths and carried to n_layers equals
    the trace at n_layers, count for count (train: bytes grow as L**2)."""
    prog, cost, mem, at, _ = dryrun.cell_cost(arch, shape, "single",
                                              overrides=ov)
    assert at["depths"] == depths and len(at["hbm_bytes"]) == 3
    whole = dryrun.trace_program(prog)
    assert mem == dryrun.memory_record(prog, whole)
    for f in ("flops_by_dtype", "hbm_bytes", "peak_live_bytes", "ops",
              "arg_bytes", "host_reads"):
        assert getattr(cost, f) == getattr(whole.cost, f), f


def _reference_record_keys() -> tuple[set, set]:
    """The keys the reference's ``run_cell`` writes (parsed from its
    source: importing it would force 512 host devices on jax)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys, memory = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            got = {k.value for k in node.keys
                   if isinstance(k, ast.Constant)}
            if "argument_bytes" in got:
                memory = got
            elif "ok" in got or "lower_s" in got:
                keys |= got
    return keys, memory


CHEAP = [("qwen3-14b", "train_4k", {"n_layers": 2}),
         ("olmoe-1b-7b", "decode_32k", None),
         ("sssp-del", "relax_rmat24", None),
         ("din", "serve_p99", None),
         ("graphsage-reddit", "molecule", None)]


@pytest.mark.parametrize("arch,shape,ov", CHEAP,
                         ids=[f"{a}/{s}" for a, s, _ in CHEAP])
def test_run_cell_records(arch, shape, ov):
    rec = dryrun.run_cell(arch, shape, "single", overrides=ov)
    assert rec["ok"] and rec["chips"] == 256 and rec["overrides"] == ov
    keys, memory = _reference_record_keys()
    departed = {"compile_s", "xla_cost_analysis", "hlo_bytes"}
    assert keys - departed <= set(rec)
    assert {"trace_cost", "trace_ops"} <= set(rec)
    assert set(rec["memory"]) == memory
    m = rec["memory"]
    assert m["peak_per_device_gb"] == pytest.approx(
        (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
         - m["alias_bytes"]) / 2**30)
    assert rec["estimated"] == ["memory.temp_bytes",
                                "memory.peak_per_device_gb"]
    r = rec["roofline"]
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"]) > 0
    assert rec["meta"] == reg.build_program(
        arch, shape, make_production_mesh(), overrides=ov).meta
    json.dumps(rec)
    if arch == "sssp-del":
        assert r["dynamic_whiles"] == 1 and r["dominant"] == "collective"
        assert m["argument_bytes"] == (2 ** 24 // 256) * (4 + 4 + 1) + \
            2 ** 20 * (4 + 4 + 4 + 1)
    if reg.ARCHES[arch].FAMILY in ("lm", "gnn") and shape != "decode_32k":
        assert r["collective_s"] == 0.0
        assert m["alias_bytes"] > 0          # params and moments in place


@pytest.mark.parametrize("jobs", [1, 2])
def test_main_writes_records_and_skips(tmp_path, capsys, jobs):
    """One process, or a pool of two (each trace once, in a worker): the
    same records."""
    out = tmp_path / "dr"
    argv = ["--mesh", "both", "--out", str(out), "--jobs", str(jobs)]
    assert dryrun.main(["--arch", "din", "--shape", "serve_p99", *argv]) \
        == 0
    assert dryrun.main(["--arch", "sssp-del", "--shape", "relax_rmat24",
                        *argv]) == 0
    for mesh in ("single", "multi"):
        rec = json.loads((out / mesh / "din__serve_p99.json").read_text())
        assert rec["ok"] and rec["mesh"] == mesh
        want = dryrun.run_cell("din", "serve_p99", mesh)
        assert rec["memory"] == want["memory"]
        assert rec["trace_cost"] == want["trace_cost"]
        rec = json.loads((out / mesh / "sssp-del__relax_rmat24.json")
                         .read_text())
        want = dryrun.run_cell("sssp-del", "relax_rmat24", mesh)
        assert rec["ok"] and rec["roofline"] == json.loads(
            json.dumps(want["roofline"]))
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                        "--out", str(out), "--jobs", str(jobs)]) == 0
    rec = json.loads((out / "single" / "qwen3-14b__long_500k.json")
                     .read_text())
    assert not rec["ok"] and "skipped" in rec
    text = capsys.readouterr().out
    assert "[multi] din__serve_p99: ok" in text and "SKIP" in text
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "single"])
