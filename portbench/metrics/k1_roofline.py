"""K1 (``ellpack_relax``, one source): the least time of its waves' work
(``work.wave_bytes`` at S = 1 over 3.35 TB/s) over its device time.  A
wave is one launch."""
from portbench import work

KERNELS = ("ellpack_relax_kernel",)


def read(run):
    if run.device is None:
        return None
    return work.roofline_pct(run.device.count(*KERNELS), run.e_live, run.n,
                             1, run.device.seconds(*KERNELS))
