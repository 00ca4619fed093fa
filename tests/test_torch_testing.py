"""The port's hypothesis fallback (``repro_torch.testing``) against the
JAX package's (``repro.testing``): with ``hypothesis`` blocked, both
modules, loaded fresh, draw the same examples for the same test, for
every strategy of the fallback (``integers``, ``floats``, ``booleans``,
``sampled_from``, ``composite``), honour ``settings(max_examples=)`` and
report the falsifying draw the same way.  Exact."""
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


_MISSING = object()


def _fresh(path: Path, name: str):
    """The module loaded anew with ``hypothesis`` blocked while it loads
    (only then: pytest's hypothesis plugin imports it around each test)."""
    saved = sys.modules.get("hypothesis", _MISSING)
    sys.modules["hypothesis"] = None
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is _MISSING:
            del sys.modules["hypothesis"]
        else:
            sys.modules["hypothesis"] = saved
    assert not mod.HAVE_HYPOTHESIS
    return mod


@pytest.fixture
def both():
    return (_fresh(ROOT / "src/repro_torch/testing.py", "_port_testing"),
            _fresh(ROOT / "src/repro/testing.py", "_ref_testing"))


def _draws(mod, n):
    st = mod.st
    seen = []

    @st.composite
    def pair(draw, hi):
        a = draw(st.integers(0, hi))
        return a, draw(st.integers(a, hi + 5))

    @mod.settings(max_examples=n)
    @mod.given(st.integers(-3, 9), st.floats(0.5, 2.0), st.booleans(),
               choice=st.sampled_from(["x", "y", "z"]), p=pair(7))
    def prop(i, f, b, choice, p):
        seen.append((i, f, b, choice, p))

    prop()
    return seen


@pytest.mark.parametrize("n", [1, 10, 25])
def test_same_examples_as_the_reference(both, n):
    ours, ref = both
    got, want = _draws(ours, n), _draws(ref, n)
    assert len(got) == n and got == want
    assert len(set(got)) > n // 2       # they vary


def test_falsified_property_reports_the_draw(both):
    msgs = []
    for mod in both:
        @mod.given(mod.st.integers(0, 100))
        def prop(x):
            assert x < 0

        with pytest.raises(AssertionError) as e:
            prop()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "example 0" in msgs[0]
