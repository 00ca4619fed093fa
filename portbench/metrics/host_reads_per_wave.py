"""Device-to-host reads outside ``query`` (the harness's counter over the
tensor read methods) per executed wave."""


def read(run):
    if run.host_reads is None or not run.waves:
        return None
    return run.host_reads / run.waves
