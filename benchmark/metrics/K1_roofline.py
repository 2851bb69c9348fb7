"""K1_roofline: K1's shadow any-hit (csrc/anyhit.cu): its least time for the
cell's frozen work (counts/<workload>.json, roofline.py's peaks) over its
device time a frame in the profiled stretch, in %."""

import roofline


def read(run):
    return roofline.share(run, "K1", "anyhit_kernel")
