"""Executed relaxation waves per batch: each epoch's rounds as the engine
folds them, the largest lane's on a lane engine (its batched loop runs
until the last lane settles)."""


def read(run):
    if run.waves is None or not run.batches:
        return None
    return run.waves / run.batches
