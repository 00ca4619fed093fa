"""95th percentile, over all queries of the window, of ``query(source=...)``
until ``(dist, parent)`` are numpy arrays on the host."""
import numpy as np


def read(run):
    return np.percentile(run.query_s, 95) * 1e3 if len(run.query_s) else None
