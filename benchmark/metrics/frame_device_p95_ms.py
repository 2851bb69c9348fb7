"""frame_device_p95_ms: the 95th percentile of the intervals between
successive frames' ends on the device (the harness's own CUDA events,
recorded after each dispatch of the window), over every frame of the
window."""

import timing


def read(run):
    return timing.frame_device_p95_ms(run.device_intervals) \
        if run.device_intervals else None
