"""glue.device_ms: device ms a frame in operations other than the port's
hand-written kernels K1-K5 (the PyTorch glue: preamble, texture gathers,
noise, megabatch, resolve), summed per operation over the profiled
stretch."""

HAND_WRITTEN = ("anyhit_kernel", "closest_kernel", "attrs_kernel",
                "fused_shading_kernel", "fused_resolved_kernel")


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    seconds = sum(hi - lo for name, lo, hi in run.trace.device
                  if not any(k in name for k in HAND_WRITTEN))
    return 1e3 * seconds / run.trace.frames
