"""The port's spans and counters: where a frame's host and device time
goes, stage by stage, and how often each hand-written kernel ran.

Spans. A span is one stretch of the frame loop's work: its name, its
start and end on the host clock (time.perf_counter), the span it lies in
and the index of the frame it belongs to, which every span of one frame
shares (core/app.py numbers the frames it dispatches). The spans are
placed where the work happens:

    frame.dispatch         core/app.py::Application._dispatch
      frame.constants      the noise advance and the frame constants
      rays, trace, noise, preamble, shade, shadowrays, shadow
                           the stages of render/pipeline.py::STAGES that
                           the frame passes
        preamble.texture   the texture fetch (render/shading.py) and
        preamble.ltc       ops/ltc.py::get_ltc_coefficients, both in K6's
                           plain version only (render/preamble.py)
        preamble.display   the light-display loop
        shade.pack         the fused path's light records
      resolve              the output color (the shadow combine is in K1's
                           slot entry, inside "shadow")
    frame.retire           the wait on the oldest frame, with its index

Tracing is off until enable(). Off, span() returns one shared context
that does nothing: no allocation, no CUDA call, no profiler call. On:
- a span of a frame dispatched on a CUDA device records a pair of timing
  CUDA events on the frame's stream, taken from a pool that stops growing
  once it holds the frames in flight; the device ms between them is read
  when the frame retires (frame_retired), by which time the frame's end
  event has completed, so reading adds no host wait;
- under torch.profiler it opens record_function(PREFIX + name), so that
  the span lies in the profiler's clock beside the device operations it
  launched; every span name there begins with PREFIX;
- the frame loop's end-of-frame event is a timing event (frame_end_event)
  and each retired frame's device interval since the end of the frame
  before it is recorded (Recorder.intervals).
The records stay in memory, at most `capacity` of each kind, the oldest
dropped first and counted in `dropped`. Nothing is written out: a reader
takes them from the recorder.

Counters. count(name) adds to an integer and is always on: the kernel
wrappers count their launches ("K1.launches" ... "K6.launches",
launch_counts()). frame_count(name, value) counts only while tracing is
on, as the spans record: render/pipeline.py counts the shadow rays of a
frame ("shadow.rays", slots x pixels, known on the host), those of them
that are live ("shadow.live_rays", t_max >= 0) and the packets of K1's
slot entry that hold a live ray ("shadow.packets"), the last two counted
on the device by K1's slot entry, one atomic per warp each.
A device count is read when its frame retires, as the spans' device ms
are: on a CUDA device it is copied to pinned host memory in stream order
inside the frame, so reading it adds no host wait.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

# The prefix of every span's profiler range.
PREFIX = "vr."
# Records of each kind kept: a 15 s window of ~40 frames a second at ~20
# spans a frame is 12,000 spans.
CAPACITY = 1 << 14
# The hand-written kernels whose launches the wrappers count.
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


@dataclasses.dataclass(slots=True)
class Span:
    """One span: `parent` is the id of the span it lies in (None at the
    top); start and end are time.perf_counter seconds; device_ms is the
    time between its events on the frame's stream, None until the frame
    retires and without a CUDA frame."""
    id: int
    name: str
    frame: int | None
    parent: int | None
    start: float
    end: float = 0.0
    device_ms: float | None = None


class _Off:
    """The context of every span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


OFF = _Off()


class _On:
    """The context of one span while tracing is on."""
    __slots__ = ("recorder", "name", "frame", "device", "record", "stream",
                 "events", "range")

    def __init__(self, recorder, name, frame, device):
        self.recorder, self.name = recorder, name
        self.frame, self.device = frame, device

    def __enter__(self):
        rec = self.recorder
        parent = rec._stack[-1] if rec._stack else None
        frame = self.frame
        if frame is None and parent is not None:
            frame = parent.record.frame
        if self.device is not None:
            device = torch.device(self.device)
            self.stream = torch.cuda.current_stream(device) \
                if device.type == "cuda" else None
        else:
            self.stream = parent.stream if parent is not None else None
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.events = None
        if self.stream is not None and frame is not None:
            self.events = (rec._event(), rec._event())
            self.events[0].record(self.stream)
        self.record = Span(rec._next_id, self.name, frame,
                           None if parent is None else parent.record.id,
                           time.perf_counter())
        rec._next_id += 1
        rec._stack.append(self)
        return self.record

    def __exit__(self, *exc):
        rec = self.recorder
        record = self.record
        record.end = time.perf_counter()
        if self.events is not None:
            self.events[1].record(self.stream)
            rec._pending.setdefault(record.frame, []).append(
                (record, *self.events))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec._stack.pop()
        rec._keep(rec.spans, record)
        return None


class Recorder:
    """Spans, frame intervals and counters of one process (RECORDER)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self.counters: dict[str, int] = {}
        self._free: list = []  # timing CUDA events to reuse
        self._free_host: list = []  # pinned host scalars to reuse
        self.clear()

    def clear(self) -> None:
        """Drop every span and interval record (counters stay)."""
        self.spans: collections.deque = collections.deque(
            maxlen=self.capacity)
        # (frame, device ms since the end of the frame before it)
        self.intervals: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dropped = 0
        self._next_id = 0
        self._stack: list[_On] = []
        self._pending: dict = {}  # frame -> [(Span, start, end event)]
        self._counts: dict = {}   # frame -> [(counter, count tensor)]
        self._ends: dict = {}     # frame -> its timing end event
        self._last_end = None     # (frame, end event) of the last retired

    def _keep(self, records, item) -> None:
        if len(records) == self.capacity:
            self.dropped += 1
        records.append(item)

    def _event(self):
        return self._free.pop() if self._free \
            else torch.cuda.Event(enable_timing=True)

    def span(self, name: str, frame: int | None = None, device=None):
        """A context around one span. `frame` gives the frame index (else
        the enclosing span's); `device`, the frame's device, whose current
        stream takes the span's events and its children's (else the
        enclosing span's stream)."""
        if not self.enabled:
            return OFF
        return _On(self, name, frame, device)

    def frame_end_event(self, frame: int):
        """The CUDA event the frame loop records at the end of `frame`: a
        timing event from the pool while tracing is on, else a plain one."""
        if not self.enabled:
            return torch.cuda.Event()
        event = self._event()
        self._ends[frame] = event
        return event

    def frame_retired(self, frame: int) -> None:
        """`frame`'s end event has completed: read its spans' device ms and
        its device interval since the frame before it, and give their
        events back to the pool."""
        if not self._pending and not self._ends and not self._counts:
            return
        for record, start, end in self._pending.pop(frame, ()):
            record.device_ms = start.elapsed_time(end)
            self._free += (start, end)
        for name, value in self._counts.pop(frame, ()):
            self.count(name, int(value))
            if value.is_pinned():
                self._free_host.append(value)
        end = self._ends.pop(frame, None)
        if end is None:
            return
        if self._last_end is not None:
            last_frame, last = self._last_end
            if last_frame == frame - 1:
                self._keep(self.intervals, (frame, last.elapsed_time(end)))
            self._free.append(last)
        self._last_end = (frame, end)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def frame_count(self, name: str, value) -> None:
        """While tracing is on, add `value` to counter `name`: an int at
        once; a tensor (a count made on the device, 0-dim) when the frame
        of the enclosing span retires, or at once outside a frame."""
        if not self.enabled:
            return
        frame = self._stack[-1].record.frame if self._stack else None
        if not isinstance(value, torch.Tensor) or frame is None:
            self.count(name, int(value))
            return
        if value.device.type == "cuda":
            host = self._free_host.pop() if self._free_host else \
                torch.empty((), dtype=torch.int64, pin_memory=True)
            value = host.copy_(value, non_blocking=True)
        self._counts.setdefault(frame, []).append((name, value))


RECORDER = Recorder()


def enable() -> None:
    RECORDER.enabled = True


def disable() -> None:
    RECORDER.enabled = False


def enabled() -> bool:
    return RECORDER.enabled


def span(name: str, frame: int | None = None, device=None):
    return RECORDER.span(name, frame, device)


def frame_end_event(frame: int):
    return RECORDER.frame_end_event(frame)


def frame_retired(frame: int) -> None:
    RECORDER.frame_retired(frame)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def frame_count(name: str, value) -> None:
    RECORDER.frame_count(name, value)


def launch_counts() -> dict[str, int]:
    """Launches of each hand-written kernel since the counters were
    reset."""
    return {k: RECORDER.counters.get(f"{k}.launches", 0) for k in KERNELS}


def reset_counters() -> None:
    RECORDER.counters.clear()
