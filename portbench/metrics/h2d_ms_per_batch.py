"""Profiled host-to-device copy time (``Memcpy HtoD`` records: the
rebuilds' layouts and each epoch's planned slots), per batch."""
from portbench.devtrace import H2D


def read(run):
    if run.device is None or not run.batches:
        return None
    return run.device.seconds(H2D) * 1e3 / run.batches
