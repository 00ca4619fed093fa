"""K2 (``fused_sliced_relax``, one source): the least time of its waves'
work (``work.wave_bytes`` at S = 1 over 3.35 TB/s) over the device time
of its two passes.  A wave is one ``k2_ell_pass`` launch; the key reset
(a memset) is not in the time."""
from portbench import work

WAVE = "k2_ell_pass"
KERNELS = ("k2_ell_pass", "k2_coo_pass")


def read(run):
    if run.device is None:
        return None
    return work.roofline_pct(run.device.count(WAVE), run.e_live, run.n, 1,
                             run.device.seconds(*KERNELS))
