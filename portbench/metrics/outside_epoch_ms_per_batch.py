"""Host time of a batch outside the program's epochs: the harness's span
around each ``ingest_log`` call less the program's ``add_epoch`` and
``del_epoch`` spans inside it (the slot allocator's plans and the stream
driver), per batch."""


def read(run):
    if run.epoch_s is None or not run.batches:
        return None
    return (run.ingest_s - run.epoch_s) * 1e3 / run.batches
