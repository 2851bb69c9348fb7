"""frame_p95_ms: the 95th percentile of the intervals between successive
frame retirements, over every frame of the window (host clock)."""

import timing


def read(run):
    return timing.frame_p95_ms(run.t0, run.stamps) if run.stamps else None
