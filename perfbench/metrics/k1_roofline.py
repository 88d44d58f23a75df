"""K1's share of its roofline over the profiled slice, in %: the least
time of the slice's K1 launches (their bytes, ``trace.k1_bytes``, over
the card's 3,350 GB/s) over K1's device time in the profiler. Nothing
where the profiler recorded another number of K1 kernels than were
launched, since the bytes and the time would then be of different
launches."""
import sys

from perfbench.trace import HBM_BYTES_PER_S


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.k1_events or not sl.k1_time_s:
        return None
    if sl.k1_events != sl.k1_launches:
        print(f"k1_roofline: {sl.k1_events} K1 kernels recorded, "
              f"{sl.k1_launches} launched", file=sys.stderr)
        return None
    return 100.0 * sl.k1_bytes / HBM_BYTES_PER_S / sl.k1_time_s
