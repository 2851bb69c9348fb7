"""K2_roofline: K2's primary closest hit (csrc/closest.cu): its least time for
the cell's frozen work (counts/<workload>.json, roofline.py's peaks) over
its device time a frame in the profiled stretch, in %."""

import roofline


def read(run):
    return roofline.share(run, "K2", "closest_kernel")
