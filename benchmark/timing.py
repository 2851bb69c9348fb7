"""The benchmark's arithmetic on times: the window's frame time, the tail of
its frames' device intervals, the device's busy time from a trace, and the
spread of repeated runs.

busy_intervals is the interval union of the port's
tools/profile_frame.py::summarize (commit b4b0e8b), frozen here so that
the yardstick does not move with the program.
"""

from __future__ import annotations

import statistics

import numpy as np


def frame_intervals(t0: float, stamps) -> np.ndarray:
    """Seconds between successive frame retirements, the first from the
    window's start t0."""
    return np.diff(np.asarray([t0, *stamps], np.float64))


def frame_ms(t0: float, stamps) -> float:
    """The whole window (t0 to the last retirement) over the frames retired
    in it, in ms: a stall anywhere in the window counts in full."""
    return (stamps[-1] - t0) * 1e3 / len(stamps)


def frame_device_p95_ms(intervals) -> float:
    """The 95th percentile of the intervals, in ms, between successive
    frames' ends on the device, over every frame of the window."""
    return float(np.percentile(np.asarray(intervals, np.float64), 95))


def busy_intervals(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals
    (profile_frame.summarize's arithmetic)."""
    merged: list[list[float]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def busy_time(spans) -> float:
    """The length of the union of the intervals (profile_frame.summarize's
    loop)."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def idle_gaps(spans) -> list[tuple[float, float]]:
    """The (start, end) gaps between successive busy intervals."""
    merged = busy_intervals(spans)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (statistics.quantiles, n=4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
