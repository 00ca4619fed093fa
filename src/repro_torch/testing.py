"""Hypothesis compatibility layer for the port's tests (torch rendering of
``repro.testing``: the port keeps its own copy, as it imports nothing of
the JAX package).

An image without ``hypothesis`` would make the property-test modules fail
at *collection* — taking every non-property test in them down too.  Tests
import ``given``/``settings``/``st`` from here instead:

  * when hypothesis is installed, this module re-exports the real thing
    (full shrinking, database, health checks);
  * otherwise a minimal deterministic random-sampling fallback runs each
    property test ``max_examples`` times with values drawn from a seeded PRNG.
    No shrinking, but the properties are still exercised — strictly better
    than ``pytest.importorskip`` which would skip whole modules.

Only the strategy surface the suite actually uses is implemented:
``integers``, ``floats``, ``booleans``, ``sampled_from``, ``composite``.
Adding a new strategy to a test?  Extend the fallback below (or just install
hypothesis — see requirements.txt).
"""
from __future__ import annotations

HAVE_HYPOTHESIS = True
try:
    from hypothesis import given, settings  # noqa: F401
    from hypothesis import strategies as st  # noqa: F401
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    import functools
    import inspect
    import random
    import zlib

    class _Strategy:
        """A strategy is just ``example(rng) -> value`` here."""

        def __init__(self, draw_fn):
            self._draw = draw_fn

        def example(self, rng: random.Random):
            return self._draw(rng)

    class _St:
        """Fallback for ``hypothesis.strategies`` (the used subset)."""

        @staticmethod
        def integers(min_value=None, max_value=None):
            lo = -(2**31) if min_value is None else min_value
            hi = 2**31 - 1 if max_value is None else max_value
            return _Strategy(lambda rng: rng.randint(lo, hi))

        @staticmethod
        def floats(min_value=0.0, max_value=1.0, **_ignored):
            return _Strategy(lambda rng: rng.uniform(min_value, max_value))

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: rng.random() < 0.5)

        @staticmethod
        def sampled_from(seq):
            items = list(seq)
            return _Strategy(lambda rng: items[rng.randrange(len(items))])

        @staticmethod
        def composite(fn):
            def build(*args, **kwargs):
                def draw_value(rng):
                    return fn(lambda strat: strat.example(rng), *args, **kwargs)
                return _Strategy(draw_value)
            return build

    st = _St()

    def settings(max_examples: int = 10, **_ignored):
        """Records ``max_examples`` on the function; order-independent with
        ``given`` (functools.wraps copies the attribute through)."""

        def deco(fn):
            fn._compat_max_examples = max_examples
            return fn

        return deco

    def given(*gargs, **gkwargs):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_compat_max_examples", 10)
                base = zlib.crc32(fn.__qualname__.encode())
                for i in range(n):
                    rng = random.Random(base * 1_000_003 + i)
                    drawn = [s.example(rng) for s in gargs]
                    kdrawn = {k: s.example(rng) for k, s in gkwargs.items()}
                    try:
                        fn(*args, *drawn, **kwargs, **kdrawn)
                    except Exception as e:  # no shrinking: report the draw
                        raise AssertionError(
                            f"property falsified on example {i}: "
                            f"args={drawn} kwargs={kdrawn}") from e
            # hide the drawn parameters from pytest's fixture resolution
            # (functools.wraps leaks the inner signature via __wrapped__)
            wrapper.__signature__ = inspect.Signature()
            del wrapper.__wrapped__
            return wrapper

        return deco
