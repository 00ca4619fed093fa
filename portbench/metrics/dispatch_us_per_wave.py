"""Host time a pass of the epochs' wave and marking loops (the program's
``waves`` and ``mark`` spans) less the time blocked in their host reads,
over their passes (the spans' ``iterations`` counter)."""
from portbench import phases


def read(run):
    if run.phases is None:
        return None
    return phases.figures(run.phases, run.batches)["dispatch_us_per_wave"]
