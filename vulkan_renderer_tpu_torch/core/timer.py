"""Frame timing with the reference's measurement protocol.

The port's own copy of vulkan_renderer_tpu/core/timer.py. Reference:
src/frame_timer.c — ring buffer of 100 timestamps, frame time = median of
consecutive differences; experiments warm up >= 1 s AND >= 110 frames
before measuring (main.c:1955-1961). The caller stamps a frame once its
output is ready (core/app.py waits on a CUDA event first).
"""

from __future__ import annotations

import time

import numpy as np

FRAME_RING_SIZE = 100  # frame_timer.c:24


class FrameTimer:
    def __init__(self):
        self._stamps: list[float] = []
        self.frame_index = 0

    def record(self, now: float | None = None) -> None:
        if now is None:
            now = time.perf_counter()
        self._stamps.append(now)
        if len(self._stamps) > FRAME_RING_SIZE:
            self._stamps.pop(0)
        self.frame_index += 1

    def deltas(self) -> np.ndarray:
        """The consecutive frame-to-frame deltas in seconds."""
        return np.diff(np.asarray(self._stamps, dtype=np.float64))

    def median_frame_time(self) -> float:
        """Median of consecutive frame-to-frame deltas (frame_timer.c:47-72);
        returns 0.0 with fewer than 2 samples."""
        if len(self._stamps) < 2:
            return 0.0
        return float(np.median(self.deltas()))

    def reset(self) -> None:
        self._stamps.clear()
        self.frame_index = 0


class WarmupProtocol:
    """Experiment warmup: measure only after >= min_seconds AND
    >= min_frames frames (main.c:1955-1961 semantics)."""

    def __init__(self, min_seconds: float = 1.0, min_frames: int = 110):
        self.min_seconds = min_seconds
        self.min_frames = min_frames
        self._start = time.perf_counter()
        self._frames = 0

    def frame(self) -> None:
        self._frames += 1

    @property
    def ready(self) -> bool:
        return (self._frames >= self.min_frames
                and time.perf_counter() - self._start >= self.min_seconds)
