"""The port's roofline report and tables (``repro_torch.roofline.report``
and ``tables``) against the JAX package's: the ``Roofline`` properties on
the same terms (the dominant term, the bound and the model-FLOPs ratio
equal; ``roofline_fraction`` the reference's scaled by its peak over the
H100's, the one constant that differs), ``report_dict``'s keys, the H100
terms of a hand-counted trace, and both packages' ``tables.table``
rendering the same text from one directory of the port's dry-run
records.  Exact but for the float scaling (rel 1e-12)."""
import dataclasses
import json
from collections import Counter

import pytest

from repro.roofline import report as jrep
from repro.roofline import tables as jtab
from repro_torch.launch import dryrun
from repro_torch.roofline import report as rep
from repro_torch.roofline import tables as tab
from repro_torch.roofline.trace_analysis import TraceCost

TERMS = [dict(compute_s=3.0, memory_s=1.0, collective_s=2.0),
         dict(compute_s=1e-6, memory_s=4e-3, collective_s=0.0),
         dict(compute_s=0.0, memory_s=1e-4, collective_s=3e-4)]


@pytest.mark.parametrize("terms", TERMS)
def test_roofline_properties_equal_reference(terms):
    common = dict(flops=5e12, hbm_bytes=2e9, coll_operand_bytes=1e6,
                  coll_wire_bytes=2e6, coll_by_type={"all-gather": 2e6},
                  dynamic_whiles=1, **terms)
    ours, ref = rep.Roofline(**common), jrep.Roofline(**common)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert ours.dominant == ref.dominant
    assert ours.bound_s == ref.bound_s
    mf, chips = 7e15, 256
    assert ours.mfu_ratio(mf, chips) == ref.mfu_ratio(mf, chips)
    assert ours.roofline_fraction(mf, chips) == pytest.approx(
        ref.roofline_fraction(mf, chips) * jrep.PEAK_FLOPS / rep.PEAK_FLOPS,
        rel=1e-12)
    meta = {"model_flops": mf}
    got, want = rep.report_dict(ours, meta, chips), \
        jrep.report_dict(ref, meta, chips)
    assert list(got) == list(want)
    assert {k: got[k] for k in got if k != "roofline_fraction"} == \
        {k: want[k] for k in want if k != "roofline_fraction"}
    assert rep.report_dict(ours, {}, chips)["model_flops_ratio"] is None


def test_h100_terms_of_a_trace():
    cost = TraceCost(flops_by_dtype=Counter(bf16=989e12 * 4, f32=67e12),
                     hbm_bytes=3.35e12 * 8, coll_wire_bytes=450e9 * 0.5,
                     coll_by_type=Counter({"all-gather": 450e9 * 0.5}),
                     dynamic_loops=2)
    rf = rep.roofline_from_trace(cost, num_partitions=4)
    assert rf.compute_s == pytest.approx(1.0 + 0.25, rel=1e-12)
    assert rf.memory_s == pytest.approx(2.0, rel=1e-12)
    assert rf.collective_s == pytest.approx(0.5, rel=1e-12)
    assert rf.dominant == "memory" and rf.dynamic_whiles == 2
    assert rf.flops == pytest.approx((989e12 * 4 + 67e12) / 4, rel=1e-12)
    assert (rep.PEAK_FLOPS, rep.PEAK_FLOPS_F32, rep.HBM_BW, rep.LINK_BW) \
        == (989e12, 67e12, 3.35e12, 450e9)


def test_tables_render_the_same_text(tmp_path):
    base = tmp_path / "dr"
    cells = [("din", "serve_p99", None), ("graphsage-reddit", "molecule",
                                          None),
             ("sssp-del", "relax_rmat24", None)]
    for mesh in ("single", "multi"):
        (base / mesh).mkdir(parents=True)
        for arch, shape, ov in cells:
            rec = dryrun.run_cell(arch, shape, mesh, overrides=ov)
            (base / mesh / f"{arch}__{shape}.json").write_text(
                json.dumps(rec))
    # a variant file and a failed record: both packages treat them alike
    rec["overrides"] = {"attn_impl": "scan"}
    (base / "multi" / "sssp-del__relax_rmat24.scan.json").write_text(
        json.dumps(rec))
    (base / "single" / "x__y.json").write_text(json.dumps({"ok": False}))
    assert tab.load_dir(str(base)).keys() == jtab.load_dir(str(base)).keys()
    for mesh in ("single", "multi"):
        got = tab.table(str(base), mesh)
        assert got == jtab.table(str(base), mesh)
        assert got.count("\n") == 1 + len(cells) + (mesh == "multi")
    assert [tab.fmt(x) for x in (None, 1.5e-3)] == \
        [jtab.fmt(x) for x in (None, 1.5e-3)]
