"""Layout rebuilds in the window (the program's ``rebuilds`` counter), per
1,000 batches."""


def read(run):
    if run.rebuilds is None or not run.batches:
        return None
    return run.rebuilds * 1e3 / run.batches
