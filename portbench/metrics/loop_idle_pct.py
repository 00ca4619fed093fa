"""The card's idle share inside the program's ``waves`` and ``mark``
spans: the device trace's idle time mapped onto them, over their length."""
from portbench import phases


def read(run):
    if run.phases is None:
        return None
    return phases.figures(run.phases, run.batches)["loop_idle_pct"]
