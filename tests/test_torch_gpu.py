"""The port's CUDA kernels against their plain PyTorch versions on the card
(K1-K6 and a whole frame), on a tiny city, the roughness-planes stand-in,
the 1920x1080 sweep frame and K2 on a floor built to provoke its prune; the per-pixel shading path
on the card against the same frame on the CPU, one configuration of each
class (tools/per_pixel_check.py, which states that tolerance); the
shading-path dispatch by the launch counters (core/trace.py); and the
program's spans: their device time against the frame's, and no device
operation of their own; the shadow counters, read at retire with no host
wait; K1's slot entry against its plain version. Marked gpu: they skip where
torch.cuda.is_available() is False. This file imports only the port (no
JAX, nothing of the JAX package), so on a machine with a card and no JAX
it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The kernels are built with --fmad=false and run the plain versions'
operations in the same order, so the tolerances are tight: exact
occlusion, primitive ids and hit distances (the tracers walk the
cluster BVH in another order than the plain versions scan, and still
return the same lexicographic minimum of (t, primitive id)), and float
differences only from the card's transcendental and rsqrt instructions."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_slot_inputs import occluded_slot, slot_inputs
from vulkan_renderer_tpu_torch.assets.noise import white_noise_table
from vulkan_renderer_tpu_torch.core import trace
from vulkan_renderer_tpu_torch.core.settings import (
    MisHeuristic, PolygonSamplingTechnique as Tech, RenderSettings,
    SamplingStrategy)
from vulkan_renderer_tpu_torch.experiments.setups import (
    _regular_polygon, _scene_default_camera)
from vulkan_renderer_tpu_torch.render import fused, pipeline, preamble
from vulkan_renderer_tpu_torch.render import trace_kernel as tk
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools import (bench_frame, kernel_check,
                                             per_pixel_check)
from vulkan_renderer_tpu_torch.tools.city import write_city_scene
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    d = str(tmp_path_factory.mktemp("gpu_city"))
    vks = write_city_scene(d, "city", n_buildings=20, detail=3,
                           texture_resolution=16)
    lights = [PolygonalLightSpec(
        translation=np.array([-10.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(2)]
    scene = load_scene(vks, d + "/city_textures", lights, "cuda",
                       noise=white_noise_table(64, 64, 8))
    camera = FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    return scene, camera


def _rays(seed, n, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    origins = torch.rand((n, 3), generator=g) * torch.tensor([120., 60., 9.])
    origins -= torch.tensor([60., 30., -0.5])
    dirs = torch.randn((n, 3), generator=g)
    t_max = torch.rand(n, generator=g) * 60.0
    t_max[::5] = -1.0
    return origins.to(device), dirs.to(device), t_max.to(device)


def test_anyhit_kernel_matches_plain(city):
    scene, _ = city
    o, d, t = _rays(1, 20000, "cuda")
    got = tk.trace_anyhit(scene.clusters, o, d, t)
    want = tk.trace_anyhit_plain(scene.clusters, o, d, t)
    assert 0.01 < float(want.float().mean()) < 0.99
    assert torch.equal(got, want)


def test_closest_and_attrs_kernels_match_plain(city):
    scene, _ = city
    o, d, _ = _rays(2, 8000, "cuda")
    inf = torch.full((d.shape[0],), float("inf"), device="cuda")
    prim, t = tk.trace_closest(scene.clusters, o, d, inf)
    prim_p, t_p = tk.trace_closest_plain(scene.clusters, o, d, inf)
    assert torch.equal(prim, prim_p)
    assert torch.equal(t, t_p)
    dcam = torch.randn((2, 3), device="cuda") * 1e-3
    got = tk.closest_attrs(scene.clusters, prim, o, d, dcam)
    want = tk.closest_attrs_plain(scene.clusters, prim, o, d, dcam)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heuristic", ["balance", "power", "weighted",
                                       "optimal_clamped", "optimal"])
def test_fused_kernel_matches_plain(city, heuristic):
    """K4 under DIFFUSE_SPECULAR_MIS against its plain version: bit for
    bit, miss pixels' dead slots included."""
    scene, camera = city
    # Shadows on: the frame exports K4's ray slots (with them off it
    # takes K5).
    settings = RenderSettings(mis_heuristic=MisHeuristic(heuristic),
                              sample_count=2, trace_shadow_rays=True)
    captured = {}

    def record(*args):
        captured["args"] = args
        return fused.fused_light_shading_plain(*args)

    kernels = dataclasses.replace(pipeline.KERNELS, fused_shading=record)
    pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                          settings, 64, 32, kernels=kernels)
    got = fused.fused_light_shading(*captured["args"])
    want = fused.fused_light_shading_plain(*captured["args"])
    r = kernel_check.compare(got, want)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r


def test_frame_kernels_match_plain_versions(city):
    scene, camera = city
    static = SceneStatic.for_scene(scene)
    settings = RenderSettings(trace_shadow_rays=True)
    got = pipeline.render_frame(scene, static, camera, settings, 64, 32)
    want = pipeline.render_frame(scene, static, camera, settings, 64, 32,
                                 kernels=pipeline.PLAIN_VERSIONS)
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    assert float(diff.mean()) <= 1e-4
    assert float((diff.amax(dim=-1) <= 1e-3).float().mean()) >= 0.999


# --- K4 DIFFUSE_ONLY and K5, every technique -------------------------------


PLANES_VERTEX_COUNTS = (3, 4, 5, 6, 7)


@pytest.fixture(scope="module")
def planes_scene(tmp_path_factory):
    """The roughness-planes stand-in lit by five lights of 3, 4, 5, 6 and 7
    vertices, every count the timing sweep and the arcade figures render
    (mixed vertex counts: one launch per group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    d = str(tmp_path_factory.mktemp("gpu_planes"))
    vks = write_test_scene(d, "roughness_planes", texture_resolution=16)
    lights = [PolygonalLightSpec(
        translation=np.array([-3.0 + 2.0 * i, 1.0 - i, 2.0 + 0.5 * i],
                             np.float32),
        rotation_angles=np.array([np.pi - 0.2 * i, 0.1 * i, 0.0],
                                 np.float32),
        scaling_x=1.0, scaling_y=1.0,
        radiant_flux=np.array([20.0, 18.0, 16.0], np.float32) / 4,
        **({} if nv == 4 else {"vertices_plane_space": _regular_polygon(nv)}))
        for i, nv in enumerate(PLANES_VERTEX_COUNTS)]
    scene = load_scene(vks, d + "/roughness_planes_textures", lights, "cuda",
                       noise=white_noise_table(64, 64, 8))
    return scene, _scene_default_camera("roughness_planes")


def _capture_resolved(scene, camera, settings):
    """K5's inputs from a 64x32 frame with shadows off."""
    captured = {}

    def record(*args):
        captured["args"] = args
        return fused.fused_light_shading_resolved_plain(*args)

    kernels = dataclasses.replace(pipeline.KERNELS, fused_resolved=record)
    pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                          settings, 64, 32, kernels=kernels)
    return captured["args"]


@pytest.mark.parametrize("tech", list(Tech), ids=lambda t: t.value)
def test_diffuse_only_kernels_match_plain(planes_scene, tech):
    """K4 under DIFFUSE_ONLY and K5 against their plain versions, and K4's
    slots resolved with visibility 1 against K5. Tolerance: bit for bit,
    the same float32 operations in the same order; the Arvo techniques,
    whose azimuth sectors can flip where an ulp differs, up to 0.5% of
    their values (ROADMAP Queue 3). K4 resolved equals K5 bit for bit."""
    scene, camera = planes_scene
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
        polygon_sampling_technique=tech, sample_count=2,
        trace_shadow_rays=False)
    args = _capture_resolved(scene, camera, settings)
    static, s = args[3], args[4]
    limit = 5e-3 if tech in (Tech.SOLID_ANGLE_ARVO,
                             Tech.PROJECTED_SOLID_ANGLE_ARVO) else 0.0
    got5 = fused.fused_light_shading_resolved(*args)
    want5 = fused.fused_light_shading_resolved_plain(*args)
    r5 = kernel_check.compare(got5.T, want5.T)
    assert 1.0 - r5["exact"] <= limit and r5["nonfinite_mismatch"] == 0, r5
    # K4 takes K5's arguments (the same planes and noise).
    got4 = fused.fused_light_shading(*args)
    want4 = fused.fused_light_shading_plain(*args)
    r4 = kernel_check.compare(got4, want4)
    assert 1.0 - r4["exact"] <= limit and r4["nonfinite_mismatch"] == 0, r4
    r45 = kernel_check.compare(kernel_check.k4_resolved(got4, static, s).T,
                               got5.T)
    assert r45["exact"] == 1.0 and r45["nonfinite_mismatch"] == 0, r45
    assert float(want5.abs().max()) > 0


@pytest.mark.parametrize("tech", [Tech.PROJECTED_SOLID_ANGLE,
                                  Tech.PROJECTED_SOLID_ANGLE_BIASED],
                         ids=lambda t: t.value)
@pytest.mark.parametrize("heuristic", list(MisHeuristic),
                         ids=lambda h: h.value)
def test_resolved_mis_kernel_matches_plain(planes_scene, tech, heuristic):
    """K5 under DIFFUSE_SPECULAR_MIS (the default settings with shadows
    off) against its plain version: bit for bit, the same float32
    operations in the same order."""
    scene, camera = planes_scene
    settings = RenderSettings(polygon_sampling_technique=tech,
                              mis_heuristic=heuristic, sample_count=2,
                              trace_shadow_rays=False)
    args = _capture_resolved(scene, camera, settings)
    got = fused.fused_light_shading_resolved(*args)
    want = fused.fused_light_shading_resolved_plain(*args)
    r = kernel_check.compare(got.T, want.T)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("tech", [Tech.PROJECTED_SOLID_ANGLE,
                                  Tech.PROJECTED_SOLID_ANGLE_BIASED],
                         ids=lambda t: t.value)
def test_fused_mis_kernel_matches_plain_at_every_vertex_count(planes_scene,
                                                              tech):
    """K4 under DIFFUSE_SPECULAR_MIS with clamped-optimal MIS (the arcade's
    experiments 314 and 316 light a heptagon so) against its plain
    version on the five lights of 3-7 vertices, one launch per vertex
    count: bit for bit, miss pixels' dead slots included."""
    scene, camera = planes_scene
    settings = RenderSettings(polygon_sampling_technique=tech,
                              mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED,
                              sample_count=1, trace_shadow_rays=True)
    captured = {}

    def record(*args):
        captured["args"] = args
        return fused.fused_light_shading_plain(*args)

    kernels = dataclasses.replace(pipeline.KERNELS, fused_shading=record)
    pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                          settings, 64, 32, kernels=kernels)
    static = captured["args"][3]
    assert [nv for nv, _ in fused.vertex_groups(static)] == \
        list(PLANES_VERTEX_COUNTS)
    got = fused.fused_light_shading(*captured["args"])
    want = fused.fused_light_shading_plain(*captured["args"])
    r = kernel_check.compare(got, want)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r
    assert float(want[3:].abs().max()) > 0


# --- K6, the pixel preamble ------------------------------------------------


def _sweep_frame(tmp_path):
    """The 1-light 1920x1080 sweep cell's Application (experiment 282) and
    a function rendering its first frame through given kernels."""
    from vulkan_renderer_tpu_torch.assets.noise import \
        advance_noise_random_numbers
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    exp = harness.create_experiment_list()[282]
    app = setups.build_default_application(exp, str(tmp_path), device="cuda")
    _, randoms = advance_noise_random_numbers(app.noise_seed,
                                              app.settings.animate_noise)
    constants = pipeline.make_frame_constants(
        app.scene_spec.camera, exp.width, exp.height, app.settings, randoms,
        "cuda")

    def render(kernels):
        with torch.no_grad():
            return pipeline.render_frame_constants(
                app.scene, app.static, app.settings, constants, exp.width,
                exp.height, kernels)
    return render


def _scene_frame(scene_camera, settings, width, height):
    scene, camera = scene_camera
    static = SceneStatic.for_scene(scene)

    def render(kernels):
        return pipeline.render_frame(scene, static, camera, settings, width,
                                     height, kernels=kernels)
    return render


@pytest.mark.parametrize("case", ["sweep_1920x1080", "city_960x540",
                                  "planes_light_display"])
def test_preamble_kernel_matches_plain(request, tmp_path, case):
    """K6 against its plain version on the 1-light 1920x1080 sweep frame
    (roughness planes, central heptagon), the city at 960x540 (several
    materials and mips, uv outside [0, 1] and negative, the lights shown)
    and the planes lit by five lights with show_polygonal_lights on: NaN
    exactly where the plain version is NaN (miss pixels), every other
    value bit for bit. A frame launches K6 once, K4 or K5 take the plain
    version's planes, and the frame equals the one whose preamble is the
    plain version, bit for bit."""
    if case == "sweep_1920x1080":
        render = _sweep_frame(tmp_path)
    elif case == "city_960x540":
        render = _scene_frame(request.getfixturevalue("city"),
                              RenderSettings(trace_shadow_rays=True), 960,
                              540)
    else:
        render = _scene_frame(
            request.getfixturevalue("planes_scene"),
            RenderSettings(show_polygonal_lights=True,
                           trace_shadow_rays=False), 256, 128)
    captured = {}
    trace.reset_counters()
    image = render(bench_frame.recording_kernels(captured))
    torch.cuda.synchronize()
    assert trace.launch_counts()["K6"] == 1
    args = captured["shading_planes"]
    got = preamble.shading_planes(*args)
    want = preamble.shading_planes_plain(*args)
    r = kernel_check.compare_planes(got, want)
    assert r["nan_mismatch"] == 0 and r["bit_mismatch"] == 0, r
    hit = args[3] >= 0
    assert 0 < float(hit.float().mean()) < 1
    assert bool(torch.isfinite(want[:, hit]).all())
    shaded = (captured.get("fused_shading")
              or captured["fused_resolved"])[0]
    r = kernel_check.compare_planes(shaded, want)
    assert r["nan_mismatch"] == 0 and r["bit_mismatch"] == 0, r
    plain_preamble = dataclasses.replace(
        pipeline.KERNELS, shading_planes=preamble.shading_planes_plain)
    assert torch.equal(image, render(plain_preamble))


def test_per_pixel_shading_of_the_views_is_that_of_the_records(city):
    """On the card the per-pixel path shades K6's views (render/fused.py
    plane_views, copied contiguous by render/pipeline.py _rows) as it
    shaded the contiguous records the frame computed before K6, bit for
    bit: a sum over a vector's components adds in an order its layout
    sets there."""
    from vulkan_renderer_tpu_torch.ops.ltc import get_ltc_coefficients
    from vulkan_renderer_tpu_torch.render.shading import finish_shading_data
    scene, camera = city
    settings = RenderSettings(trace_shadow_rays=True)
    static = SceneStatic.for_scene(scene)
    captured = {}
    pipeline.render_frame(scene, static, camera, settings, 128, 64,
                          kernels=bench_frame.recording_kernels(captured))
    args = captured["shading_planes"]
    _, constants, attrs, prim, t_hit, ray_dirs = args
    hit = prim != -1
    t_safe = torch.where(hit & torch.isfinite(t_hit), t_hit, 0.0)
    data = finish_shading_data(scene, constants, attrs, constants.
                               camera_position + t_safe[:, None] * ray_dirs)
    f0 = data.fresnel_0
    ltc = get_ltc_coefficients(
        scene.ltc, f0[:, 0] * 0.2126 + f0[:, 1] * 0.7152 + f0[:, 2] * 0.0722,
        data.roughness, data.position, data.normal, data.outgoing)
    p = hit.shape[0]
    pairs = torch.rand((p, pipeline.pairs_per_light(settings)
                        * static.light_count, 2), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(7))
    views = fused.plane_views(preamble.shading_planes(*args))
    got = pipeline.shade_pixels(scene, static, settings, constants, hit,
                                *(pipeline._rows(r, 0, p) for r in views),
                                pairs)
    want = pipeline.shade_pixels(scene, static, settings, constants, hit,
                                 data, ltc, pairs)
    for g, w in zip(got, want):
        assert torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))


# --- the per-pixel path ------------------------------------------------------


@pytest.fixture(scope="module")
def per_pixel_scenes(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    files = per_pixel_check.write_scene_files(
        str(tmp_path_factory.mktemp("per_pixel")))
    return (per_pixel_check.load_scenes(files, "cuda"),
            per_pixel_check.load_scenes(files, "cpu"))


@pytest.mark.parametrize("name", list(per_pixel_check.CLASSES))
def test_per_pixel_frame_matches_cpu(per_pixel_scenes, name):
    card, cpu = per_pixel_scenes
    got = per_pixel_check.render_class(card, name).cpu().numpy()
    want = per_pixel_check.render_class(cpu, name).numpy()
    ok, stats = per_pixel_check.compare_class(name, got, want)
    assert ok, stats


def _launches(scene, static, settings, camera, w=32, h=16):
    trace.reset_counters()
    pipeline.render_frame(scene, static, camera, settings, w, h)
    torch.cuda.synchronize()
    return trace.launch_counts()


@pytest.mark.parametrize("shadows", [False, True])
def test_dispatch_launches_fused_kernels_where_supported(planes_scene,
                                                         shadows):
    """fused "auto" on CUDA tensors launches K5 (no shadows) or K4
    (shadows) for every configuration fused_supported accepts (all 13
    techniques under DIFFUSE_ONLY, the PSA pair under
    DIFFUSE_SPECULAR_MIS), and neither for a per-pixel configuration or
    under "off", where K2 and K3 (and K1 with shadows) still run; "on"
    raises where the kernels do not cover the settings. K6 runs once a
    frame on either path."""
    scene, camera = planes_scene
    supported = [RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
        polygon_sampling_technique=tech, trace_shadow_rays=shadows)
        for tech in Tech] + [RenderSettings(
            polygon_sampling_technique=tech, trace_shadow_rays=shadows)
        for tech in (Tech.PROJECTED_SOLID_ANGLE,
                     Tech.PROJECTED_SOLID_ANGLE_BIASED)]
    fused_kernel, other = ("K4", "K5") if shadows else ("K5", "K4")
    for settings in supported:
        static = SceneStatic.for_scene(scene)
        assert fused.fused_supported(static, settings)
        n = _launches(scene, static, settings, camera)
        assert n[fused_kernel] > 0 and n[other] == 0, (settings, n)
        assert n["K6"] == 1, n
        n = _launches(scene, SceneStatic.for_scene(scene, fused="off"),
                      settings, camera)
        assert n["K4"] == n["K5"] == 0 and n["K2"] == n["K3"] == n["K6"] \
            == 1
        assert (n["K1"] > 0) == shadows, n
    per_pixel = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY,
        trace_shadow_rays=shadows)
    n = _launches(scene, SceneStatic.for_scene(scene), per_pixel, camera)
    assert n["K4"] == n["K5"] == 0 and (n["K1"] > 0) == shadows, n
    with pytest.raises(ValueError, match="fused='on'"):
        _launches(scene, SceneStatic.for_scene(scene, fused="on"),
                  per_pixel, camera)


def _sweep_application(tmp_path, shadows):
    """The central 4-gon 128-light PSA sweep experiment (113) at 64x32 on
    the card, with shadows on (K4 + K1) or off (K5)."""
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    exp = harness.create_experiment_list()[113]
    assert exp.settings.polygon_sampling_technique == \
        Tech.PROJECTED_SOLID_ANGLE
    exp = dataclasses.replace(exp, width=64, height=32, settings=(
        dataclasses.replace(exp.settings, trace_shadow_rays=shadows)))
    return setups.build_default_application(exp, str(tmp_path), device="cuda")


@pytest.mark.parametrize("shadows", [False, True])
def test_dispatch_has_no_host_wait(tmp_path, shadows):
    """Two dispatches of a K5 frame and of a K4 + K1 frame make no
    synchronizing call (sync debug mode "error"), so frames in flight
    overlap; the kernels did run."""
    from vulkan_renderer_tpu_torch.tools import host_waits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    app = _sweep_application(tmp_path, shadows)
    kernel = "K4" if shadows else "K5"
    trace.reset_counters()
    host_waits.dispatch_without_host_wait(app, 2)
    assert trace.launch_counts()[kernel] >= 3


def test_shadow_counters_on_the_card(tmp_path, monkeypatch):
    """With tracing on, K4 + K1 frames count their shadow rays (slots x
    pixels) and the live ones among them (t_max >= 0, counted by K1's
    slot entry) with no synchronizing call in the dispatch: the live count
    reaches the host through pinned memory and is read when its frame
    retires. The expected counts are the plain megabatch's of the slot
    planes each frame handed K1."""
    from vulkan_renderer_tpu_torch.core import app as app_module
    from vulkan_renderer_tpu_torch.tools import host_waits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    app = _sweep_application(tmp_path, True)
    seen = []

    def record(*args):
        seen.append(args[:7])
        return pipeline.KERNELS.trace_anyhit_slots(*args)
    kernels = dataclasses.replace(pipeline.KERNELS, trace_anyhit_slots=record)
    render = app_module.render_frame_constants
    monkeypatch.setattr(app_module, "render_frame_constants",
                        lambda *args: render(*args, kernels=kernels))
    trace.RECORDER.clear()
    trace.reset_counters()
    trace.enable()
    try:
        host_waits.dispatch_without_host_wait(app, 3)
    finally:
        trace.disable()
    counters = trace.RECORDER.counters
    assert len(seen) == 4
    t_max = [tk.shadow_megabatch(*args[1:6])[2] for args in seen]
    assert counters["shadow.rays"] == sum(t.numel() for t in t_max)
    assert counters["shadow.live_rays"] == sum(int((t >= 0).sum())
                                               for t in t_max)
    assert 0 < counters["shadow.live_rays"] < counters["shadow.rays"]
    trace.RECORDER.clear()
    trace.reset_counters()


@pytest.mark.parametrize("slots", [1, 13, 128])
def test_anyhit_slots_entry_matches_plain(city, slots):
    """K1's slot entry against its plain version (the ray list, the plain
    tracer, the grouped combine) on slot planes drawn from a seed over the
    city (P not a multiple of 32, miss pixels, dead slots, a NaN weight in
    an occluded slot): colors bit for bit, NaN where the plain version is
    NaN, and the live-ray count equal to the megabatch's t_max >= 0."""
    scene, _ = city
    clusters = scene.clusters
    pixels = 1000 if slots < 128 else 250
    args = slot_inputs(clusters, slots, pixels, 2**31 + slots)
    out, _, hit, position, cam, base0 = args
    s, p = occluded_slot(clusters, out, slots, hit, position, cam)
    out[3 + 7 * s, p] = float("nan")
    live = torch.zeros((), dtype=torch.int32, device="cuda")
    got = tk.trace_anyhit_slots(clusters, *args, live)
    want = tk.trace_anyhit_slots_plain(clusters, *args)
    assert kernel_check.bit_mismatches(got, want) == 0
    assert torch.isnan(got[p, 0])
    t_max = tk.shadow_megabatch(out, slots, hit, position, cam)[2]
    assert int(live) == int((t_max >= 0).sum())
    assert 0 < int(live) < t_max.numel()


def test_anyhit_slots_entry_matches_plain_on_a_frame(city):
    """The slot planes a whole city frame (K4, shadows on) hands K1's slot
    entry: the entry bit for bit as its plain version, and the ray-list
    K1 on the frame's megabatch as trace_anyhit_plain."""
    scene, camera = city
    settings = RenderSettings(trace_shadow_rays=True)
    captured = {}
    pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                          settings, 64, 32,
                          kernels=bench_frame.recording_kernels(captured))
    args = captured["trace_anyhit_slots"][:7]
    got = tk.trace_anyhit_slots(*args)
    want = tk.trace_anyhit_slots_plain(*args)
    assert kernel_check.bit_mismatches(got, want) == 0
    rays = bench_frame.anyhit_args(captured)
    assert torch.equal(tk.trace_anyhit(*rays), tk.trace_anyhit_plain(*rays))


def test_stage_spans_sum_to_the_frame_device_interval(tmp_path):
    """With tracing on (core/trace.py), the 1-light 1920x1080 sweep frame
    (experiment 282, whose device paces the frame loop) is bit-equal to
    the untraced frame, and the device ms of the spans directly inside
    each frame's frame.dispatch (frame.constants and the stages) sum to
    the frame's device interval, its end event since the frame before's,
    within 5%."""
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.tools import frame_spans
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    exp = harness.create_experiment_list()[282]
    app = setups.build_default_application(exp, str(tmp_path), device="cuda")
    seed = app.noise_seed
    untraced = app.render_frame_sync()
    trace.RECORDER.clear()
    trace.enable()
    try:
        app.noise_seed = seed
        traced = app.render_frame_sync()
        for _ in range(16):
            app.render_frame_async()
        app.render_frame_sync()
    finally:
        trace.disable()
    assert torch.equal(traced, untraced)
    intervals = list(trace.RECORDER.intervals)[4:]
    ratios = frame_spans.stage_interval_ratios(list(trace.RECORDER.spans),
                                               intervals)
    trace.RECORDER.clear()
    assert len(ratios) == len(intervals) >= 10
    assert all(0.95 <= r <= 1.05 for r in ratios), ratios


def test_tracing_adds_no_device_operation(tmp_path):
    """Under torch.profiler, frames make as many device operations with
    tracing on as off (the program's ranges, which the profiler also shows
    on the device, are no operation), and off, none of the program's
    ranges shows."""
    from vulkan_renderer_tpu_torch.tools import frame_spans
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    app = _sweep_application(tmp_path, False)
    app.render_frame_sync()
    ops, ranges = {}, {}
    for traced in (False, True):
        ops[traced], ranges[traced] = frame_spans.profiled(
            torch, app, trace, 2, traced)
    assert len(ops[True]) == len(ops[False]) > 0
    assert not ranges[False] and ranges[True]


@pytest.mark.parametrize("case", ["k4", "k5", "per_pixel"])
def test_frame_bits_recombine_on_card(planes_scene, case):
    """frame_bits 1 and 2 recombine to the direct linear frame rounded to
    float16, bit for bit, on each shading path."""
    from vulkan_renderer_tpu_torch.render.screenshot import \
        combine_ldr_screenshots_into_hdr
    from vulkan_renderer_tpu_torch.tools import hdr_capture
    scene, camera = planes_scene
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY
        if case == "per_pixel" else SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        trace_shadow_rays=case != "k5", output_linear_rgb=True)
    static = SceneStatic.for_scene(scene)

    def render(bits):
        return pipeline.render_frame(
            scene, static, camera,
            dataclasses.replace(settings, frame_bits=bits), 64, 32)

    low, high, direct = hdr_capture.bit_frames(render)
    combined = combine_ldr_screenshots_into_hdr(low, high)
    assert hdr_capture.half_mismatches(combined, direct) == 0
    assert float(direct.max()) > 0.0


def test_bands_on_card(planes_scene):
    """The frame as 4 bands of 8 rows on one card equals the whole frame
    bit for bit; each band launches K1, K2, K3 and K6 once and K4 once per
    vertex-count group."""
    from vulkan_renderer_tpu_torch.parallel.tiles import render_frame_bands
    scene, camera = planes_scene
    settings = RenderSettings(trace_shadow_rays=True)
    static = SceneStatic.for_scene(scene)
    whole = pipeline.render_frame(scene, static, camera, settings, 64, 32)
    trace.reset_counters()
    banded = render_frame_bands(["cuda:0"] * 4, scene, static, camera,
                                settings, 64, 32)
    torch.cuda.synchronize()
    assert torch.equal(banded, whole)
    groups = len(fused.vertex_groups(static))
    launches = trace.launch_counts()
    assert {n: launches[n] for n in ("K1", "K2", "K3", "K4", "K6")} == \
        {"K1": 4, "K2": 4, "K3": 4, "K4": 4 * groups, "K6": 4}


def test_closest_kernel_exact_where_pruning_decides():
    """K2 against its plain version on tools/prune_check.py's layered
    floor, 65,536 rays at shared tile edges: prim and t exact, ties
    included (the prune's margin at work; chip_smoke.py phase 19 runs
    1024 x 1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from vulkan_renderer_tpu_torch.tools import prune_check
    row = prune_check.measure("cuda", 65536)
    assert row["rays_at_risk"] > 0
    assert row["prim_mismatches"] == row["t_bit_mismatches"] == 0, row
