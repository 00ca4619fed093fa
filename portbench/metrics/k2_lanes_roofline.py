"""K2's lane form (``fused_sliced_relax_lanes``, S trees): the least time
of its waves' work (``work.wave_bytes`` at S lanes over 3.35 TB/s) over
the device time of its launches: the lane-minor interleave, the COO pass,
the ELL pass and the wide rows' pass.  A wave is one ``k2_ell_lanes``
launch; the key reset (a memset) is not in the time."""
from portbench import work

WAVE = "k2_ell_lanes<"
KERNELS = ("interleave_kernel", "k2_coo_lanes", "k2_ell_lanes",
           "k2_ell_wide_lanes")


def read(run):
    if run.device is None:
        return None
    return work.roofline_pct(run.device.count(WAVE), run.e_live, run.n,
                             run.lanes, run.device.seconds(*KERNELS))
