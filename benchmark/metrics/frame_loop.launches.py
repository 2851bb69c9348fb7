"""frame_loop.launches: device operations (kernels, copies, fills) a frame
in the profiled stretch."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.frames
