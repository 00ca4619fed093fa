"""95th percentile, over all micro-batches of the window, of the time from
handing the batch to ``ingest_log`` to its return with every maintained
tree converged (the device synchronised)."""
import numpy as np


def read(run):
    return np.percentile(run.batch_s, 95) * 1e3 if len(run.batch_s) else None
