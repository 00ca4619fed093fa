"""Process start to the first timed batch: CUDA start-up, the graph and
stream made from the seed, the kernel libraries loaded (built in a
checkout's first run), the base graph loaded and the warm-up batches."""


def read(run):
    return run.setup_s
