"""The slot allocator's host time (the program's ``plan_adds`` and
``plan_dels`` phase spans) in the window, per batch."""
from portbench import phases


def read(run):
    if run.phases is None:
        return None
    return phases.figures(run.phases, run.batches)["plan_ms_per_batch"]
