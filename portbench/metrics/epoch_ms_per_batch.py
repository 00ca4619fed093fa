"""The program's ``add_epoch`` and ``del_epoch`` spans (layout planner and
waves), summed over the window, per batch."""


def read(run):
    if run.epoch_s is None or not run.batches:
        return None
    return run.epoch_s * 1e3 / run.batches
