"""K5_roofline: K5's resolved shading without shadows
(csrc/fused_resolved.cu): its least time for the cell's frozen work
(counts/<workload>.json, roofline.py's peaks) over its device time a frame
in the profiled stretch, in %."""

import roofline


def read(run):
    return roofline.share(run, "K5", "fused_resolved_kernel")
