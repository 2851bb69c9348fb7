#!/usr/bin/env python3
"""Where a frame's time goes, read from the port's own spans
(core/trace.py), for harness experiments on one GPU:

    python3 -m vulkan_renderer_tpu_torch.tools.frame_spans \
        --experiment INDEX [INDEX ...] [--seeds N [N ...]] [--seconds S]
        [--data DIR] [--profile-frames F]

Each experiment's Application (as the harness builds it from the assets
or stand-ins in --data) runs closed-loop with its frames in flight, as a
frame loop's user runs it. For each seed, after warm-up frames, it runs
a window of S seconds with tracing off and one with tracing on, in turns
(the noise sequence starts at the seed both times), and after the last seed
F frames under torch.profiler with tracing on and F with it off. It
prints one JSON line an experiment:

- the card (nvidia-smi name and power limit);
- per window: the frames retired, the host-clock frame time (first
  dispatch to last retirement over the frames) and the 95th percentile
  of the intervals between retirements, and the host ms a frame inside
  render_frame_constants (wrapped as a measuring harness wraps it);
- per traced window: the mean, 50th and 95th percentiles of the frames'
  device intervals (each frame's end event since the one before it), how far
  the stage spans' device ms of a frame part from its interval (the
  median, least and largest ratio), the records dropped, the spans
  table: per span name, host ms, host self ms (less its children) and
  device ms, each a frame, and the frame counters (COUNTERS) a frame
  dispatched, with the live share of the shadow rays (None without
  shadow rays);
- from the profiled frames with tracing on: device operations a frame
  launched under each span (the innermost program span open on the host
  at the operation's launch, joined by the profiler's correlation id),
  and the ten longest device idle gaps, each named by the innermost span
  open on the host at the gap's middle; with tracing on and off: device
  operations a frame (the program's own ranges, which the profiler also
  shows on the device, are no operation) and the device ms a frame
  outside the hand-written kernels K1-K5;
- the synchronizing calls in one dispatch (tools/host_waits.py).

It exits non-zero without a CUDA device. It imports no JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

# The CUDA kernel names of the hand-written kernels K1-K5. K6, the pixel
# preamble (preamble_kernel), counts as glue, as in the benchmark's
# glue.device_ms.
HAND_WRITTEN = ("anyhit_kernel", "closest_kernel", "attrs_kernel",
                "fused_shading_kernel", "fused_resolved_kernel")
WARMUP = 10
TOP = 10
NO_SPAN = "(none)"
# The counters render/pipeline.py keeps while tracing is on.
COUNTERS = ("shadow.rays", "shadow.live_rays", "shadow.packets")


# -- the spans' arithmetic (records of core/trace.py) ----------------------

def span_table(spans, frames: int) -> dict:
    """{name: [host ms, host self ms, device ms]} a frame over `frames`
    frames: self time is the span's less its children's; device ms sums
    the spans whose device time was read."""
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.end - s.start
    table: dict = {}
    for s in spans:
        row = table.setdefault(s.name, [0.0, 0.0, 0.0])
        host = s.end - s.start
        row[0] += host
        row[1] += host - children.get(s.id, 0.0)
        row[2] += (s.device_ms or 0.0) * 1e-3
    return {name: [1e3 * v / frames for v in row]
            for name, row in table.items()}


def stage_interval_ratios(spans, intervals) -> list[float]:
    """Per frame with a device interval: the device ms of the spans
    directly inside its frame.dispatch (its stages and frame.constants)
    over the interval."""
    roots = {s.id: s.frame for s in spans if s.name == "frame.dispatch"}
    sums: dict = {}
    for s in spans:
        if s.parent in roots and s.device_ms is not None:
            sums[s.frame] = sums.get(s.frame, 0.0) + s.device_ms
    return [sums[frame] / ms for frame, ms in intervals
            if frame in sums and ms > 0]


# -- the profiler's events -------------------------------------------------

def profiler_events(prof):
    """torch.profiler events as (name, on the device, start s, end s,
    correlation id, linked correlation id)."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA,
             e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.id,
             getattr(e, "linked_correlation_id", 0) or 0)
            for e in prof.events()]


def split_events(events, prefix: str):
    """(device operations as (name, start, end, host time of their
    launch or None), the program's spans on the host as (name less the
    prefix, start, end)). A program span also shows on the device as an
    annotation: that is no operation. An operation's launch is the runtime
    call ("cu...") of its correlation id, else the operator its linked
    correlation id names."""
    ops, ranges, launched, frontend = [], [], {}, {}
    for name, device, lo, hi, cid, linked in events:
        if name.startswith(prefix):
            if not device:
                ranges.append((name[len(prefix):], lo, hi))
        elif device:
            ops.append((name, lo, hi, cid, linked))
        elif name.startswith("cu"):
            launched[cid] = lo
        else:
            frontend.setdefault(cid, lo)
    starts = [launched.get(cid, frontend.get(linked)) for _, _, _, cid, linked
              in ops]
    return ([(name, lo, hi, t) for (name, lo, hi, _, _), t
             in zip(ops, starts)], ranges)


def innermost(ranges, t) -> str:
    """The name of the innermost range open at t (ranges nest: the one that
    started last)."""
    best = None
    if t is not None:
        for name, lo, hi in ranges:
            if lo <= t <= hi and (best is None or lo >= best[1]):
                best = (name, lo)
    return NO_SPAN if best is None else best[0]


def launches_by_span(ops, ranges, frames: int) -> dict:
    counts: dict = {}
    for _, _, _, launched in ops:
        name = innermost(ranges, launched)
        counts[name] = counts.get(name, 0) + 1
    return {name: n / frames for name, n in counts.items()}


def busy_intervals(spans):
    merged: list = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def idle_gaps_by_span(ops, ranges, top: int = TOP) -> list:
    """The `top` longest gaps between the device's busy intervals, longest
    first, as [innermost host span at the gap's middle, seconds]."""
    merged = busy_intervals([(lo, hi) for _, lo, hi, _ in ops])
    gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0]))
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    return [[innermost(ranges, mid), seconds] for seconds, mid in gaps]


def device_summary(ops, frames: int) -> dict:
    """Device operations a frame, the device ms a frame outside K1-K5, and
    the busy seconds (the union of the operations' intervals)."""
    glue = sum(hi - lo for name, lo, hi, _ in ops
               if not any(k in name for k in HAND_WRITTEN))
    busy = sum(hi - lo for lo, hi in busy_intervals(
        [(lo, hi) for _, lo, hi, _ in ops]))
    return {"launches": len(ops) / frames, "glue_ms": 1e3 * glue / frames,
            "busy_s": busy}


# -- the runs on the card --------------------------------------------------

class DispatchClock:
    """Host seconds of each call core/app.py makes into
    render_frame_constants, through the module name it calls."""

    def __init__(self, app_module):
        self.module, self.original = app_module, \
            app_module.render_frame_constants
        self.seconds: list = []

    def __enter__(self):
        def timed(*args, **kwargs):
            start = time.perf_counter()
            out = self.original(*args, **kwargs)
            self.seconds.append(time.perf_counter() - start)
            return out
        self.module.render_frame_constants = timed
        return self

    def __exit__(self, *exc):
        self.module.render_frame_constants = self.original


def percentile(values, q):
    return float(np.percentile(values, q)) if len(values) else None


def window(torch, app, app_module, seconds: float) -> dict:
    """Closed-loop frames for `seconds` from a drained queue, the queue
    drained after: the host-clock numbers of the window."""
    torch.cuda.synchronize()
    gc.collect()
    stamps = []
    with DispatchClock(app_module) as clock:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if app.render_frame_async() is not None:
                stamps.append(time.perf_counter())
        app.render_frame_sync()
    if not stamps:
        return {"frames": 0}
    return {"frames": len(stamps),
            "frame_ms": 1e3 * (stamps[-1] - t0) / len(stamps),
            "frame_p95_ms": 1e3 * percentile(np.diff([t0, *stamps]), 95),
            "dispatch_ms": 1e3 * float(np.mean(clock.seconds[:len(stamps)]))}


def frame_counters(before: dict, after: dict, frames: int) -> dict:
    """Each of COUNTERS a frame between two readings of the recorder's
    counters, and the live share of the shadow rays."""
    out = {name: (after.get(name, 0) - before.get(name, 0)) / max(frames, 1)
           for name in COUNTERS}
    rays = out["shadow.rays"]
    out["shadow.live_share"] = out["shadow.live_rays"] / rays if rays \
        else None
    return out


def traced_window(torch, app, app_module, trace, seconds: float) -> dict:
    """window() with tracing on, and what its frames' spans and counters
    say (the counters over every frame it dispatched, each read when the
    frame retired)."""
    rec = trace.RECORDER
    rec.clear()
    first = app.frame_index
    before = dict(rec.counters)
    trace.enable()
    try:
        out = window(torch, app, app_module, seconds)
    finally:
        trace.disable()
    frames = set(range(first, first + out["frames"]))
    spans = [s for s in rec.spans if s.frame in frames]
    intervals = [(f, ms) for f, ms in rec.intervals if f in frames]
    ms = [v for _, v in intervals]
    ratios = stage_interval_ratios(spans, intervals)
    return {**out, "dropped": rec.dropped, "intervals": len(ms),
            "device_frame_mean_ms": float(np.mean(ms)) if ms else None,
            "device_frame_p50_ms": percentile(ms, 50),
            "device_frame_p95_ms": percentile(ms, 95),
            "stages_over_interval": [percentile(ratios, 50),
                                     min(ratios, default=None),
                                     max(ratios, default=None)],
            "spans": {name: [round(v, 4) for v in row] for name, row
                      in span_table(spans, max(out["frames"], 1)).items()},
            "counters": frame_counters(before, rec.counters,
                                       app.frame_index - first)}


def profiled(torch, app, trace, frames: int, traced: bool):
    """`frames` frames under torch.profiler from a drained queue to a
    drained queue: (device operations, program ranges)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if traced:
        trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                app.render_frame_async()
            app.render_frame_sync()
    finally:
        trace.disable()
    return split_events(profiler_events(prof), trace.PREFIX)


def measure(torch, exp, data: str, seeds, seconds: float,
            profile_frames: int) -> dict:
    from vulkan_renderer_tpu_torch.core import app as app_module
    from vulkan_renderer_tpu_torch.core import trace
    from vulkan_renderer_tpu_torch.experiments import setups
    from vulkan_renderer_tpu_torch.tools import host_waits
    app = setups.build_default_application(exp, data, device="cuda")
    runs = []
    for i, seed in enumerate(seeds):
        row = {"seed": seed}
        # Which window goes first alternates from seed to seed.
        for traced in (False, True)[::1 - 2 * (i % 2)]:
            app.noise_seed = seed % 2**32
            for _ in range(WARMUP):
                app.render_frame_async()
            if traced:
                row["on"] = traced_window(torch, app, app_module, trace,
                                          seconds)
            else:
                row["off"] = window(torch, app, app_module, seconds)
        runs.append(row)
    for _ in range(WARMUP):
        app.render_frame_async()
    ops_on, ranges = profiled(torch, app, trace, profile_frames, True)
    ops_off, ranges_off = profiled(torch, app, trace, profile_frames, False)
    n = profile_frames + 1  # and the frame of the drain
    return {"size": [exp.width, exp.height], "runs": runs,
            "profiled_frames": n,
            "launches_by_span": {k: round(v, 2) for k, v in sorted(
                launches_by_span(ops_on, ranges, n).items())},
            "idle_gaps_by_span": idle_gaps_by_span(ops_on, ranges),
            "device_on": device_summary(ops_on, n),
            "device_off": device_summary(ops_off, n),
            "ranges_off": len(ranges_off),
            "sync_calls_per_dispatch": host_waits.count_host_waits(app)}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiment", type=int, nargs="+", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--profile-frames", type=int, default=5)
    parser.add_argument("--data", default=os.path.join(root, "data"))
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("frame_spans: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from vulkan_renderer_tpu_torch.experiments import harness
    from vulkan_renderer_tpu_torch.tools import bench_frame
    card = bench_frame.card_name()
    experiments = harness.create_experiment_list()
    for index in args.experiment:
        out = measure(torch, experiments[index], os.path.abspath(args.data),
                      args.seeds, args.seconds, args.profile_frames)
        print(json.dumps({"card": card, "experiment": index, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
