"""The vision kernel (``ops/vision.py`` -> ``warp_ncc_score_map``): the
least time the card could take for the matcher's work at the cell's M (the
bound of ``peaks.warp_ncc_bound``, its bytes and operations whatever
implements them) over the median device time of the data-association
kernel in the trace, in %. Nothing where that kernel did not run."""

from slambench import peaks, trace

KERNEL = "warp_ncc_score_map_kernel"


def read(t, cell):
    times = t.kernel_us(lambda n: KERNEL in n)
    if not times:
        return None
    med_ms = trace.median(times) / 1e3
    return 100.0 * peaks.warp_ncc_bound(t.M)["bound_ms"] / med_ms
