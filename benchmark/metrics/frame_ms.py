"""frame_ms: the whole measured window over the frames retired in it."""

import timing


def read(run):
    return timing.frame_ms(run.t0, run.stamps) if run.stamps else None
