"""The arcade reference frame (experiment 316: one heptagon, diffuse and
specular under clamped optimal MIS, shadow rays) through the port's frame
loop on the CPU, on the cornell stand-in at 32x32 and 4 spp.

- The frame (Application, the fused path: the plain versions of K4 and
  of K1's slot entry, which are the shadow megabatch, the ray-list K1 and
  the combine) agrees at every pixel with the
  benchmark's plain reference (benchmark/reference/), on seeded noise,
  and the reference with its records in bfloat16 does not.
- The frame counters: shadow.rays is 2 x spp x P a frame (two samples a
  sample_count under MIS, each with a slot); shadow.live_rays is the
  count of t_max >= 0 in the megabatch of the frame's slot planes, and
  shadow.packets that of the packets of K1's slot entry holding one.
- With tracing off the counters stay untouched, and the frame is
  bit-equal to the frame with tracing on; on, the shadow rays and their
  combine are one span, "shadow", with no "shadowrays" stage and nothing
  inside the resolve.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from vulkan_renderer_tpu_torch.core import trace
from vulkan_renderer_tpu_torch.core.app import (Application,
                                                SceneSpecification)
from vulkan_renderer_tpu_torch.experiments import harness as experiments
from vulkan_renderer_tpu_torch.experiments import setups
from vulkan_renderer_tpu_torch.render import trace_kernel
from vulkan_renderer_tpu_torch.tools import frame_spans
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
SIZE = 32
SPP = 4
SEED = 2**31 + 316
# Tolerances of the port's frame against the float32 reference, in output
# color (sRGB in [0, 1], exposure 8). The two compute the same float32
# formulas in other orders (K4's plain version is the SoA formulation,
# the reference the JAX per-pixel path), so most pixels part by rounding
# alone, which the exposure and sRGB's slope near black amplify to
# ~1e-4 at most. A sample whose noise lies at the end of its range
# (65534/65535) is ill-conditioned in float32: on frame 2 of this seed
# the reference's specular sample of pixel (8, 21) leaves its float64
# direction by 1.6e-3 (the port's by 1.6e-4), hits a box that the float64
# ray misses, and the pixel parts by 0.019. So MEAN bounds the mean over
# every pixel and channel at ~4x the largest sound reading (2.2e-5 on
# frame 2, ~4e-6 on the others), and at most FAR_PIXELS pixels may part
# by more than FAR in a channel (the benchmark's far pixel). The reference
# with its per-pixel records in bfloat16 reads a mean of ~0.14 and ~270
# far pixels.
MEAN = 1e-4
FAR = 1e-2
FAR_PIXELS = 2


@pytest.fixture(scope="module")
def bench_modules():
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        import inputs
        from reference import render as ref_render
        from reference import scene as ref_scene
        yield inputs, ref_render, ref_scene


@pytest.fixture(scope="module")
def arcade(tmp_path_factory, bench_modules):
    """The port's Application of experiment 316 at 32x32 and 4 spp with
    animated noise, the reference's scene and settings, and the data
    directory both read."""
    inputs, ref_render, ref_scene = bench_modules
    d = str(tmp_path_factory.mktemp("arcade"))
    experiment = experiments.create_experiment_list()[316]
    assert experiment.light_layout == "heptagon"
    settings = dataclasses.replace(experiment.settings, sample_count=SPP,
                                   animate_noise=True)
    inputs.write_noise(settings.noise_type, d)
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    lights = setups.experiment_lights(experiment, d)
    spec = SceneSpecification(
        "arcade", vks, os.path.join(d, "cornell_box_textures"),
        camera=setups._scene_default_camera("arcade"), lights=lights)
    app = Application(spec, settings, SIZE, SIZE, frames_in_flight=1,
                      data_directory=d, device="cpu")
    fields = {f.name: getattr(settings, f.name)
              for f in dataclasses.fields(settings)}
    ref_settings = ref_render.settings_from_fields({
        k: v.name if isinstance(v, enum.Enum) else v
        for k, v in fields.items()})
    scene = ref_scene.build(
        vks, spec.texture_dir,
        [{k: getattr(light, k) for k in (
            "translation", "rotation_angles", "scaling_x", "scaling_y",
            "radiant_flux", "vertices_plane_space")} for light in lights],
        settings.noise_type, d, "cpu")
    camera = {"position_world_space": spec.camera.position_world_space,
              "rotation_x": spec.camera.rotation_x,
              "rotation_z": spec.camera.rotation_z}
    return app, ref_settings, scene, camera


def _reference(bench_modules, arcade, noise_seed, precision):
    _, ref_render, _ = bench_modules
    _, settings, scene, camera = arcade
    with torch.no_grad():
        return ref_render.render_pixels(
            scene, settings, camera, SIZE, SIZE,
            ref_render.random_numbers(settings, noise_seed),
            torch.arange(SIZE * SIZE), precision)


def _frame(app, noise_seed):
    app.noise_seed = noise_seed
    return app.render_frame_sync().reshape(-1, 3)


def _parting(image, reference):
    """(mean absolute difference, pixels off by more than FAR)."""
    diff = (image.double() - reference.double()).abs()
    return float(diff.mean()), int((diff.amax(dim=1) > FAR).sum())


@pytest.mark.parametrize("frame", [0, 1, 2, 3])
def test_the_frame_is_the_plain_reference_at_every_pixel(
        bench_modules, arcade, frame):
    app = arcade[0]
    seed = SEED + frame
    image = _frame(app, seed)
    assert torch.isfinite(image).all()
    # The frame is lit: the light, the walls it lights, shadows.
    assert float(image.amax()) > 0.9 and float(image.mean()) > 0.1
    mean, far = _parting(image, _reference(bench_modules, arcade, seed,
                                           "float32"))
    assert mean <= MEAN and far <= FAR_PIXELS, (mean, far)
    mean, far = _parting(image, _reference(bench_modules, arcade, seed,
                                           "bfloat16"))
    assert mean > MEAN and far > FAR_PIXELS, (mean, far)


def _megabatch_spy(monkeypatch):
    """The t_max of every megabatch that K1's slot entry's plain version
    builds from the frames' slot planes."""
    seen = []
    original = trace_kernel.shadow_megabatch

    def spy(*args):
        rays = original(*args)
        seen.append(rays[2].clone())
        return rays
    monkeypatch.setattr(trace_kernel, "shadow_megabatch", spy)
    return seen


def test_the_counters_count_the_megabatch(arcade, monkeypatch):
    app = arcade[0]
    seen = _megabatch_spy(monkeypatch)
    trace.RECORDER.clear()
    trace.reset_counters()
    trace.enable()
    try:
        for i in range(3):
            _frame(app, SEED + i)
    finally:
        trace.disable()
    counters = trace.RECORDER.counters
    p = SIZE * SIZE
    assert len(seen) == 3
    assert counters["shadow.rays"] == 3 * 2 * SPP * p
    live = sum(int((t_max >= 0).sum()) for t_max in seen)
    assert counters["shadow.live_rays"] == live
    assert 0 < live < 3 * 2 * SPP * p
    slots = 2 * SPP
    width = trace_kernel.packet_width(slots)
    packets = sum(int(trace_kernel.slot_packets(t_max >= 0, slots, width))
                  for t_max in seen)
    assert counters["shadow.packets"] == packets
    assert live / width <= packets <= live
    # tools/frame_spans.py's reading of them.
    read = frame_spans.frame_counters({}, counters, 3)
    assert read["shadow.rays"] == 2 * SPP * p
    assert read["shadow.live_share"] == pytest.approx(live / (6 * SPP * p))
    trace.reset_counters()


def test_off_the_counters_stay_and_the_frame_is_the_traced_frame(arcade):
    app = arcade[0]
    trace.RECORDER.clear()
    trace.reset_counters()
    untraced = _frame(app, SEED)
    assert "shadow.rays" not in trace.RECORDER.counters
    assert "shadow.live_rays" not in trace.RECORDER.counters
    assert "shadow.packets" not in trace.RECORDER.counters
    assert not trace.RECORDER.spans
    trace.enable()
    try:
        traced = _frame(app, SEED)
    finally:
        trace.disable()
    assert torch.equal(traced, untraced)
    spans = {s.id: s for s in trace.RECORDER.spans}
    names = [s.name for s in spans.values()]
    assert names.count("shadow") == 1 and "shadowrays" not in names
    resolve = next(s for s in spans.values() if s.name == "resolve")
    assert not [s for s in spans.values() if s.parent == resolve.id]
    assert trace.RECORDER.counters["shadow.rays"] == 2 * SPP * SIZE * SIZE
    trace.RECORDER.clear()
    trace.reset_counters()


def test_frame_counts_wait_for_tracing_and_for_their_frame_to_retire():
    rec = trace.Recorder()
    rec.frame_count("n", torch.tensor(5))
    assert rec.counters == {}
    rec.enabled = True
    rec.frame_count("n", torch.tensor(5))
    rec.frame_count("n", 2)
    assert rec.counters == {"n": 7}
    with rec.span("frame.dispatch", frame=4, device="cpu"):
        rec.frame_count("n", torch.tensor(np.int64(3)))
    assert rec.counters == {"n": 7}
    rec.frame_retired(4)
    assert rec.counters == {"n": 10}
