"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window produced.

The cell's frame loop is the port's own: vulkan_renderer_tpu_torch.core.
app.Application.render_frame_async, with the configuration's frames in
flight (3, as the reference's fence ring, main.c:2208-2225). The loop is
closed: each call dispatches a frame and retires the oldest once more than
that many are in flight, so the next frame goes out as soon as the queue
has room and no rate is set. The seed sets the start of the frame-noise
sequence (Application.noise_seed); the noise moves every frame. Scene,
camera and lights are the configuration's and the traffic's.

Everything cell-specific is found by name: configs/<config>.json (its
scene generator in scenes/), traffic/<traffic>.json (its light layout in
layouts/), counts/<workload>.json (the frozen work of each kernel's
roofline), checks/<workload>.json (the limits of the check) and
metrics/<metric>.py (one reader per metric, end-to-end or per-layer).
With --trace 1 a short stretch of frames is profiled after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gc
import os
import sys
import time

import numpy as np
import torch

import inputs
import timing

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package. The port's name begins with the JAX package's, so names are
# compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "vulkan_renderer_tpu")
# Host spans of the traced stretch (torch.profiler.record_function).
FRAME_SPAN, DISPATCH_SPAN = "bench.frame", "bench.dispatch"
TOP = 10


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def noise_start(seed: int) -> int:
    """Application.noise_seed is a uint32 (noise_table.c:160-167)."""
    return seed % 2**32


@dataclasses.dataclass
class Trace:
    """The profiled stretch: `frames` frames dispatched back to back after
    a synchronize, and synchronized again; device operations and host
    spans as (name, start s, end s) in the profiler's clock."""
    frames: int
    window_s: float
    device: list
    host: list

    @property
    def busy_s(self) -> float:
        return timing.busy_time([(lo, hi) for _, lo, hi in self.device])


@dataclasses.dataclass
class Run:
    """What the metric readers read (metrics/<name>.py, read(run))."""
    workload: str
    config: dict
    traffic: dict
    counts: dict
    setup_s: float
    t0: float
    stamps: list
    window_peak_bytes: int
    dispatch_s: list | None = None
    trace: Trace | None = None
    # ms between successive frames' ends on the device, one per frame
    # dispatched in the window, the first from the window's start (None
    # without a card).
    device_intervals: list | None = None


class FrameSample:
    """A uniform sample of `k` retired frames, drawn from the seed
    (reservoir sampling): a constant number of frames is held, whatever
    the window's length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.kept, self.seen = k, rng, [], 0

    def offer(self, index: int, frame) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, frame))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = (index, frame)


def make_settings(module, fields: dict):
    """module.RenderSettings from field values, enums by member name."""
    cls = module.RenderSettings
    known = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - set(known))
    if unknown:
        raise ValueError(f"no RenderSettings fields {unknown}")
    kwargs = {}
    for name, value in fields.items():
        default = known[name].default
        kwargs[name] = type(default)[value] \
            if isinstance(default, enum.Enum) else value
    return cls(**kwargs)


def load_reader(name: str):
    """metrics/<name>.py's read function."""
    return inputs.load_module("metrics", name).read


def cell_metrics(workload: str, trace: bool) -> list[dict]:
    """The manifest's metrics this cell reports in a run of this kind."""
    group = "per_layer" if trace else "end_to_end"
    return [m for m in inputs.manifest()[group]
            if "workloads" not in m or workload in m["workloads"]]


def build_application(workload: str, config: dict, traffic: dict, device):
    """The port's Application for the cell, its inputs written first."""
    vks, textures = inputs.write_scene(config["scene"])
    fields = inputs.settings_fields(config, traffic)
    inputs.write_noise(fields["noise_type"])
    from vulkan_renderer_tpu_torch.core import app as app_module
    from vulkan_renderer_tpu_torch.core import settings as settings_module
    from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
    from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
    spec = app_module.SceneSpecification(
        name=workload, vks_path=vks, texture_dir=textures,
        camera=FirstPersonCamera(**inputs.camera(config)),
        lights=[PolygonalLightSpec(**light)
                for light in inputs.lights(traffic)])
    return app_module.Application(
        spec, make_settings(settings_module, fields), *config["resolution"],
        frames_in_flight=config["frames_in_flight"],
        data_directory=inputs.DATA_DIR, device=device)


class DispatchSpans:
    """Host-clock spans around each call the frame loop makes into
    render/pipeline.py::render_frame_constants (as core/app.py makes it),
    with no synchronize, each also a profiler range. Calls made while
    `profiling` is set (the profiled stretch, whose host the profiler
    slows) are left out of `seconds`."""

    def __init__(self):
        from vulkan_renderer_tpu_torch.core import app as app_module
        self.module = app_module
        self.original = app_module.render_frame_constants
        self.seconds: list[float] = []
        self.profiling = False

    def __enter__(self):
        original = self.original

        def spanned(*args, **kwargs):
            with torch.profiler.record_function(DISPATCH_SPAN):
                start = time.perf_counter()
                out = original(*args, **kwargs)
                if not self.profiling:
                    self.seconds.append(time.perf_counter() - start)
            return out
        self.module.render_frame_constants = spanned
        return self

    def __exit__(self, *exc):
        self.module.render_frame_constants = self.original


def device_stamp(device):
    """A timing event recorded on the device's current stream: it completes
    once everything enqueued on the stream before it has run."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def device_intervals(start, ends) -> list[float]:
    """ms between successive completed events, the first from `start`."""
    return [a.elapsed_time(b) for a, b in zip([start, *ends], ends)]


def profile_stretch(step, frames: int):
    """`frames` frames under torch.profiler, from a drained queue to a
    drained queue: (the profiler, the stretch's wall seconds). Its events
    are read after the window (read_trace), not inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(frames):
            with record_function(FRAME_SPAN):
                step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    return prof, window_s


def read_trace(prof, window_s: float, frames: int) -> Trace:
    """The profiled stretch's device operations and host spans."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name in (FRAME_SPAN, DISPATCH_SPAN):
            # A range also shows on the device as an annotation: host only.
            if e.device_type == DeviceType.CPU:
                host.append(span)
        elif e.device_type == DeviceType.CUDA:
            device.append(span)
    return Trace(frames, window_s, device, host)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time over the stretch
    (seconds), and its longest idle gaps, each named by the host span it
    fell in: dispatch (inside render_frame_constants), retire (the rest
    of a frame call: frame constants, waiting on the oldest frame), or
    other."""
    totals: dict[str, float] = {}
    for name, lo, hi in trace.device:
        totals[name[:120]] = totals.get(name[:120], 0.0) + (hi - lo)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]

    def label(t):
        for name, tag in ((DISPATCH_SPAN, "dispatch"), (FRAME_SPAN, "retire")):
            if any(lo <= t <= hi for n, lo, hi in trace.host if n == name):
                return tag
        return "other"
    gaps = sorted(timing.idle_gaps([(lo, hi) for _, lo, hi in trace.device]),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[label(0.5 * (lo + hi)), hi - lo]
                          for lo, hi in gaps]}


def check_frames(workload, config, traffic, kept, seed: int,
                 device) -> list[dict]:
    """The numbers of each sampled frame against the plain reference: the
    reference renders a sample of the frame's pixels, drawn from the seed,
    from the same files and numbers. A frame given as None stands for the
    control: the reference in bfloat16 put in the program's place."""
    from reference import render as ref_render
    from reference import scene as ref_scene
    fields = inputs.settings_fields(config, traffic)
    settings = ref_render.settings_from_fields(fields)
    vks, textures = inputs.write_scene(config["scene"])
    scene = ref_scene.build(vks, textures, inputs.lights(traffic),
                            settings.noise_type, inputs.DATA_DIR, device)
    camera = inputs.camera(config)
    width, height = config["resolution"]
    rng = np.random.default_rng([seed, 1])
    rows = []
    for index, frame in sorted(kept, key=lambda kv: kv[0]):
        randoms = ref_render.random_numbers(settings,
                                            noise_start(seed) + index)
        pixels = torch.from_numpy(rng.choice(
            width * height, traffic["check"]["pixels"], replace=False))

        def reference(precision):
            with torch.no_grad():
                return ref_render.render_pixels(
                    scene, settings, camera, width, height, randoms,
                    pixels, precision).cpu()
        program = reference("bfloat16") if frame is None \
            else frame.reshape(-1, 3)[pixels]
        rows.append({"frame": index,
                     **ref_render.compare(program, reference("float32"))})
    return rows


def run(workload: str, entry: dict, config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, device="cuda",
        started: float | None = None) -> tuple[dict, list[str]]:
    """One run: (the result line's object, the check's lines)."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    cuda = device.type == "cuda"
    counts_path = os.path.join(inputs.HERE, "counts", f"{workload}.json")
    counts = inputs.read_json("counts", f"{workload}.json") \
        if os.path.exists(counts_path) else {}
    limits = inputs.read_json("checks", f"{workload}.json")["limits"]

    app = build_application(workload, config, traffic, device)
    app.noise_seed = noise_start(seed)
    spans = DispatchSpans() if trace else None
    sample = None  # set-up's frames are not checked
    retired = 0  # frames retired since the Application was built

    def step():
        nonlocal retired
        frame = app.render_frame_async()
        if frame is not None:
            if sample is not None:
                sample.offer(retired, frame)
            retired += 1
        return frame is not None

    for _ in range(traffic["warmup_frames"]):
        step()
    gc.collect()
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    window_sample = sample = FrameSample(traffic["check"]["frames"],
                                         np.random.default_rng([seed, 0]))
    stamps, ends, profiled = [], [], None
    with spans or contextlib.nullcontext():
        t0 = time.perf_counter()
        setup_s = t0 - started
        # The device's own stamps: an event after each dispatch completes
        # with that frame's work, and none is waited on in the window.
        start = device_stamp(device) if cuda else None
        while True:
            if step():
                stamps.append(time.perf_counter())
            if cuda:
                ends.append(device_stamp(device))
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(device)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        sample = None  # the window's frames alone are checked
        if trace:
            # The profiled stretch follows the window, so that the profiler
            # slows none of the window's frames; its events are read once
            # it has ended.
            spans.profiling = True
            profiled = read_trace(*profile_stretch(
                step, traffic["profile_frames"]), traffic["profile_frames"])
    attempted = len(stamps)
    record = Run(workload, config, traffic, counts, setup_s, t0, stamps,
                 window_peak, spans.seconds if spans else None, profiled,
                 device_intervals(start, ends) if cuda else None)

    kept = [(i, f.cpu()) for i, f in window_sample.kept]
    del app, window_sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rows = check_frames(workload, config, traffic, kept, seed, device)

    metrics = {}
    for m in cell_metrics(workload, trace):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checked, lines = {}, []
    for name, limit in limits.items():
        worst = max((r[name] for r in rows), default=None)
        checked[name] = {"value": worst, "limit": limit}
        lines.append(f"check {name} {worst!r} limit {limit!r} "
                     f"({len(rows)} frames, {traffic['check']['pixels']} "
                     "pixels each)")
    failed = sum(any(r[name] > limits[name] for name in limits) for r in rows)
    result = {
        "correct": bool(rows) and failed == 0,
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": entry["chips"],
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if profiled is not None:
        result["device"].update(busy_s=profiled.busy_s,
                                window_s=profiled.window_s)
        result["breakdown"] = breakdown(profiled)
    result["check"] = checked
    return result, lines
