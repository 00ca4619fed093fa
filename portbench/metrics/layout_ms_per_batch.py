"""Pool writes and layout patches (the program's ``apply_adds`` and
``apply_dels`` phase spans, the layout planner and its device patches
inside them) in the window, per batch."""
from portbench import phases


def read(run):
    if run.phases is None:
        return None
    return phases.figures(run.phases, run.batches)["layout_ms_per_batch"]
