"""The port's spans and counters (core/trace.py) on the CPU.

- The recorder: off, every span is one shared context and nothing is
  recorded; on, spans nest, link to their parent, carry their frame's
  index and give self times; the oldest records go first past the
  capacity, counted; counters count.
- Whole frames through the Application on the fused path (the kernels'
  plain versions) and the per-pixel path, with and without shadow rays,
  on the cornell box and the tiny city: a frame is torch.equal with
  tracing on and off, and its span tree is the one core/trace.py names,
  in stage order.
- A measuring harness that wraps core/app.py's render_frame_constants
  (benchmark/harness.py::DispatchSpans) still sees every call while the
  program traces.
- tools/frame_spans.py's arithmetic on synthetic records and profiler
  events: the spans table, the stage sums over the device interval,
  launches by span through the correlation ids, idle gaps by span, and
  device operations that the program's ranges on the device leave as
  they are; tools/host_waits.py, which the tool reads, counts
  synchronizing calls and not sync debug mode's notice.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.core import trace
from vulkan_renderer_tpu_torch.core.app import (Application,
                                                SceneSpecification)
from vulkan_renderer_tpu_torch.core.settings import RenderSettings
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.tools import frame_spans, host_waits
from vulkan_renderer_tpu_torch.tools.city import write_city_scene
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene

WIDTH, HEIGHT = 32, 16
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")


@pytest.fixture
def tracing():
    """The process's recorder, emptied, on for the test and off after."""
    trace.RECORDER.clear()
    trace.enable()
    yield trace.RECORDER
    trace.disable()
    trace.RECORDER.clear()


class Clock:
    """time.perf_counter for the recorder: each reading 1 s after the
    last."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1.0
        return self.now


def _tree(spans):
    """(depth, name, frame) of each span in the order they started."""
    by_id = {s.id: s for s in spans}

    def depth(s):
        return 0 if s.parent is None else 1 + depth(by_id[s.parent])
    return [(depth(s), s.name, s.frame)
            for s in sorted(spans, key=lambda s: s.start)]


def test_off_spans_share_one_context_and_record_nothing():
    rec = trace.Recorder()
    assert rec.span("a") is rec.span("b", frame=3, device="cpu") is trace.OFF
    assert trace.span("rays") is trace.OFF
    with rec.span("a") as opened:
        assert opened is None
    rec.frame_retired(0)
    assert not rec.spans and not rec.intervals and rec.dropped == 0


def test_on_spans_nest_link_and_carry_their_frame(monkeypatch):
    monkeypatch.setattr(trace.time, "perf_counter", Clock())
    rec = trace.Recorder()
    rec.enabled = True
    with rec.span("frame.dispatch", frame=7, device="cpu") as root:
        with rec.span("preamble") as preamble:
            with rec.span("preamble.texture") as texture:
                pass
        with rec.span("shade") as shade:
            pass
    with rec.span("frame.retire", frame=4) as retire:
        pass
    with rec.span("rays") as loose:
        pass
    assert [s.name for s in rec.spans] == [
        "preamble.texture", "preamble", "shade", "frame.dispatch",
        "frame.retire", "rays"]
    assert (root.parent, preamble.parent, texture.parent, shade.parent) \
        == (None, root.id, preamble.id, root.id)
    assert (root.frame, preamble.frame, texture.frame, shade.frame,
            retire.frame, loose.frame) == (7, 7, 7, 7, 4, None)
    assert retire.parent is None and loose.parent is None
    assert all(s.device_ms is None for s in rec.spans)
    # Host seconds 1-8: dispatch 1-8 holds preamble 2-5 (texture 3-4)
    # and shade 6-7.
    table = frame_spans.span_table(list(rec.spans), frames=1)
    assert table["frame.dispatch"] == [7e3, 3e3, 0.0]
    assert table["preamble"] == [3e3, 2e3, 0.0]
    assert table["preamble.texture"] == [1e3, 1e3, 0.0]
    assert table["shade"] == [1e3, 1e3, 0.0]


def test_capacity_drops_the_oldest_and_counts_them():
    rec = trace.Recorder(capacity=3)
    rec.enabled = True
    for i in range(5):
        with rec.span(f"s{i}", frame=i):
            pass
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"]
    assert rec.dropped == 2
    rec.clear()
    assert not rec.spans and rec.dropped == 0


def test_counters_count_whether_tracing_is_on_or_off():
    trace.reset_counters()
    trace.count("K2.launches")
    trace.count("K5.launches", 3)
    trace.enable()
    trace.count("K5.launches")
    trace.disable()
    assert trace.launch_counts() == {"K1": 0, "K2": 1, "K3": 0, "K4": 0,
                                     "K5": 4, "K6": 0}
    trace.reset_counters()
    assert set(trace.launch_counts().values()) == {0}


def _cornell(d):
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    camera = FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=np.pi / 2, rotation_z=np.pi)
    return SceneSpecification("cornell_box", vks, d + "/cornell_box_textures",
                              camera=camera, lights=[light])


def _city(d):
    """make_city(20, detail=3), two street lights, the bench camera."""
    vks = write_city_scene(d, "city", n_buildings=20, detail=3,
                           texture_resolution=16)
    lights = [PolygonalLightSpec(
        translation=np.array([-10.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(2)]
    camera = FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    return SceneSpecification("city", vks, d + "/city_textures",
                              camera=camera, lights=lights)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spans"))
    return {"cornell": (_cornell(d), d), "city": (_city(d), d)}


def _application(specs, scene, fused, shadows):
    spec, d = specs[scene]
    app = Application(spec, RenderSettings(trace_shadow_rays=shadows),
                      WIDTH, HEIGHT, frames_in_flight=1, data_directory=d,
                      device="cpu")
    if not fused:
        app.static = dataclasses.replace(app.static, fused="off")
    return app


def _expected_tree(fused, shadows, frame):
    stages = [(1, "frame.constants"), (1, "rays"), (1, "trace"),
              (1, "noise"), (1, "preamble"), (2, "preamble.texture"),
              (2, "preamble.ltc"), (2, "preamble.display"), (1, "shade")]
    stages += [(2, "shade.pack")] if fused else []
    # With shadows, K1's slot entry reads the rays from K4's planes and
    # does the combine: no "shadowrays" stage, and nothing inside the
    # resolve.
    stages += [(1, "shadow")] if shadows else []
    stages += [(1, "resolve")]
    return [(0, "frame.dispatch", frame)] \
        + [(depth, name, frame) for depth, name in stages] \
        + [(0, "frame.retire", frame)]


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_pixel"])
@pytest.mark.parametrize("scene", ["cornell", "city"])
def test_a_traced_frame_is_the_untraced_frame_with_its_span_tree(
        specs, scene, fused, shadows):
    app = _application(specs, scene, fused, shadows)
    seed = app.noise_seed
    untraced = app.render_frame_sync()
    app.noise_seed = seed
    trace.RECORDER.clear()
    trace.enable()
    try:
        traced = app.render_frame_sync()
    finally:
        trace.disable()
    assert torch.equal(traced, untraced)
    assert _tree(trace.RECORDER.spans) == _expected_tree(fused, shadows, 1)
    trace.RECORDER.clear()


def test_a_wrapping_harness_sees_every_call_while_the_program_traces(
        specs, tracing, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import harness
    app = _application(specs, "cornell", True, False)
    with harness.DispatchSpans() as spans:
        for _ in range(4):
            app.render_frame_async()
    app.render_frame_sync()
    assert len(spans.seconds) == 4
    dispatches = [s for s in tracing.spans if s.name == "frame.dispatch"]
    assert [s.frame for s in dispatches] == [0, 1, 2, 3, 4]
    inner = {s.parent for s in tracing.spans if s.name == "rays"}
    assert inner == {s.id for s in dispatches}


def _span(i, name, frame, parent, start, end, device_ms):
    return trace.Span(i, name, frame, parent, start, end, device_ms)


def test_stage_spans_over_the_frame_interval():
    spans = [_span(0, "frame.dispatch", 5, None, 0.0, 1.0, 10.0),
             _span(1, "rays", 5, 0, 0.1, 0.2, 2.0),
             _span(2, "preamble", 5, 0, 0.2, 0.5, 7.0),
             _span(3, "preamble.texture", 5, 2, 0.3, 0.4, 6.0),
             _span(4, "frame.dispatch", 6, None, 1.0, 2.0, 10.0),
             _span(5, "rays", 6, 4, 1.1, 1.2, None),
             _span(6, "frame.retire", 5, None, 2.0, 2.5, None)]
    assert frame_spans.stage_interval_ratios(
        spans, [(5, 10.0), (6, 9.0), (7, 4.0)]) == [0.9]
    table = frame_spans.span_table(spans, frames=2)
    assert table["preamble"] == pytest.approx([150.0, 100.0, 3.5])
    assert table["frame.retire"] == pytest.approx([250.0, 250.0, 0.0])


# Synthetic profiler events (name, on the device, start s, end s,
# correlation id, linked correlation id): a frame whose dispatch holds
# "shade", three device operations (one launched by a runtime call
# before "shade", one inside it, one found only through the operator
# that launched it) and a retire.
EVENTS = [
    ("vr.frame.dispatch", False, 0.0, 10.0, 1, 0),
    ("vr.shade", False, 2.0, 8.0, 2, 0),
    ("cudaLaunchKernel", False, 1.0, 1.1, 100, 50),
    ("cudaLaunchKernel", False, 4.0, 4.1, 101, 51),
    ("aten::cat", False, 7.5, 7.6, 52, 0),
    ("vectorized_gather_kernel", True, 2.0, 3.0, 100, 50),
    ("fused_resolved_kernel_7", True, 5.0, 9.0, 101, 51),
    ("CatArrayBatchedCopy", True, 9.5, 9.7, 0, 52),
    ("vr.frame.retire", False, 10.0, 12.0, 3, 0),
    ("cudaEventSynchronize", False, 10.0, 12.0, 102, 0),
]
# The same ranges as the profiler also shows them on the device.
ANNOTATIONS = [("vr.frame.dispatch", True, 2.0, 9.7, 4, 0),
               ("vr.shade", True, 5.0, 9.7, 5, 0)]


@pytest.mark.parametrize("annotated", [False, True])
def test_profiler_events_by_span(annotated):
    events = EVENTS + (ANNOTATIONS if annotated else [])
    ops, ranges = frame_spans.split_events(events, trace.PREFIX)
    assert [(name, t) for name, _, _, t in ops] == [
        ("vectorized_gather_kernel", 1.0), ("fused_resolved_kernel_7", 4.0),
        ("CatArrayBatchedCopy", 7.5)]
    assert ranges == [("frame.dispatch", 0.0, 10.0), ("shade", 2.0, 8.0),
                      ("frame.retire", 10.0, 12.0)]
    assert frame_spans.launches_by_span(ops, ranges, frames=1) == {
        "frame.dispatch": 1, "shade": 2}
    summary = frame_spans.device_summary(ops, frames=1)
    assert summary["launches"] == 3
    assert summary["glue_ms"] == pytest.approx(1.2e3)
    assert summary["busy_s"] == pytest.approx(5.2)
    # Gaps 3-5 (middle 4: inside "shade") and 9-9.5 (9.25: the dispatch).
    gaps = frame_spans.idle_gaps_by_span(ops, ranges)
    assert [name for name, _ in gaps] == ["shade", "frame.dispatch"]
    assert [s for _, s in gaps] == pytest.approx([2.0, 0.5])
    assert frame_spans.innermost(ranges, 11.0) == "frame.retire"
    assert frame_spans.innermost(ranges, 13.0) == frame_spans.NO_SPAN
    assert frame_spans.innermost(ranges, None) == frame_spans.NO_SPAN


class WarningApp:
    """An Application whose dispatch warns as sync debug mode "warn" does
    at one synchronizing call."""

    def __init__(self):
        self._in_flight = []

    def render_frame_sync(self):
        pass

    def _dispatch(self):
        warnings.warn("called a synchronizing CUDA operation")


def test_host_waits_counts_synchronizing_calls_not_the_modes_notice(
        monkeypatch):
    """The mode's notice on first use ("... does not yet detect all
    synchronizing operations") is no synchronizing call."""
    def set_mode(mode):
        warnings.warn("Synchronization debug mode is a prototype feature "
                      "and does not yet detect all synchronizing operations")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    assert host_waits.count_host_waits(WarningApp()) == 1


def test_the_tool_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert frame_spans.main(["--experiment", "282"]) == 1
    assert "CUDA" in capsys.readouterr().err
