"""device.idle_pct: 100 less the union of the device's operation intervals
over the profiled stretch's wall time (tools/profile_frame.py's
arithmetic). The profiler slows the host, so this reads higher than an
unprofiled window would."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
