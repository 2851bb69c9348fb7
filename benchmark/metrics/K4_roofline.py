"""K4_roofline: K4's fused shading with shadow-ray slots
(csrc/fused_shading.cu): its least time for the cell's frozen work
(counts/<workload>.json, roofline.py's peaks) over its device time a frame
in the profiled stretch, in %."""

import roofline


def read(run):
    return roofline.share(run, "K4", "fused_shading_kernel")
