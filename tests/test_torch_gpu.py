"""The port's CUDA kernels against their plain PyTorch versions on the card
(K1-K6 and a whole frame), on a tiny city, the bench frame (the
300-building city at 960x540, tools/bench_frame.py, also built with
clusters of 32 and 128 triangles), the roughness-planes stand-in, the
1920x1080 sweep frames and K2 on floors built to provoke its prune; the
per-pixel shading path on the card against the same frame on the CPU,
one configuration of each class (tools/per_pixel_check.py, which states
that tolerance); the shading-path dispatch by the launch counters
(core/trace.py); the frame bits, bands and host waits at the bench and
sweep frames' sizes; and the program's spans: their device time against
the frame's, and no device operation of their own; the shadow counters,
read at retire with no host wait; K1's slot entry against its plain
version, at every packet width. tests/test_torch_gpu_frames.py holds the
harness's sweep and arcade frames, tests/test_torch_gpu_tools.py the
tools. Marked gpu: they skip where torch.cuda.is_available() is False.
These files import only the port (no JAX, nothing of the JAX package),
so on a machine with a card and no JAX they run without the repository's
conftest, as the one on-card check of the port:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu*.py

(chip_smoke.py runs that, then tools/bench_frame.py --kernels). Their
shared fixtures are in tests/_torch_gpu_fixtures.py.

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

from _torch_gpu_fixtures import built, data_dir, jax_free  # noqa: F401
from _torch_slot_inputs import (PACKET_CASES, occluded_slot, packet_case,
                                slot_inputs)
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
                                             per_pixel_check, prune_check)
from vulkan_renderer_tpu_torch.tools.city import write_city_scene
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene

pytestmark = pytest.mark.gpu

# The bench frame's cases: (its cluster size, the rays of the frame's
# shadow-ray list K1 is held on, the primary rays K2 is held on; None:
# all of them).
BENCH_CASES = {"bench_960x540": (64, kernel_check.RAY_SUBSET, None),
               "bench_clusters_32": (32, 65536, 65536),
               "bench_clusters_128": (128, 65536, 65536)}


@pytest.fixture(scope="module")
def bench_frames(data_dir):
    """frames(cluster_size): (scene, static, each kernel's arguments in
    one bench frame) of the bench city built with clusters of that many
    triangles, loaded at first use."""
    frames = {}

    def get(cluster_size=64):
        if cluster_size not in frames:
            scene, static = bench_frame.load_city(data_dir, "cuda",
                                                  cluster_size=cluster_size)
            with torch.no_grad():
                frames[cluster_size] = (scene, static, bench_frame.
                                        capture_inputs(scene, static,
                                                       bench_frame.settings()))
        return frames[cluster_size]
    return get


@pytest.fixture(scope="module")
def city(tmp_path_factory):
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


@pytest.mark.parametrize("case", ["city_20x3", "bench_clusters_32",
                                  "bench_clusters_128"])
def test_anyhit_kernel_matches_plain(request, case):
    """K1's ray list against its plain version, exact: 20,000 random rays
    over the tiny city, and the bench frame's shadow rays (its megabatch)
    with the city built in clusters of 32 and 128 triangles."""
    if case == "city_20x3":
        scene, _ = request.getfixturevalue("city")
        clusters, (o, d, t) = scene.clusters, _rays(1, 20000, "cuda")
    else:
        size, count, _ = BENCH_CASES[case]
        clusters, *rays = bench_frame.anyhit_args(
            request.getfixturevalue("bench_frames")(size)[2])
        o, d, t = kernel_check.ray_subset(*rays, count)
    got = tk.trace_anyhit(clusters, o, d, t)
    want = tk.trace_anyhit_plain(clusters, o, d, t)
    assert 0.01 < float(want.float().mean()) < 0.99
    assert torch.equal(got, want)


# K3 against its plain version: |d| <= tol x (1 + |plain|), assert_close's
# atol and rtol; the bench frame's rays have been held at 1e-4.
K3_TOLERANCE = {"city_20x3": 1e-5, "bench_960x540": 1e-4,
                "bench_clusters_32": 1e-4, "bench_clusters_128": 1e-4}


@pytest.mark.parametrize("case", list(K3_TOLERANCE))
def test_closest_and_attrs_kernels_match_plain(request, case):
    """K2 against its plain version, prim and t exact, and K3 on K2's hits
    within K3_TOLERANCE: 8,000 random rays over the tiny city, and the
    bench frame's primary rays (all 518,400; 65,536 with the city built
    in clusters of 32 and 128 triangles)."""
    if case == "city_20x3":
        scene, _ = request.getfixturevalue("city")
        clusters, (o, d, _) = scene.clusters, _rays(2, 8000, "cuda")
        t_max = torch.full((d.shape[0],), float("inf"), device="cuda")
        dcam = torch.randn((2, 3), device="cuda") * 1e-3
    else:
        size, _, count = BENCH_CASES[case]
        captured = request.getfixturevalue("bench_frames")(size)[2]
        clusters, o, d, t_max = captured["trace_closest"]
        idx = kernel_check.subset_indices(count or d.shape[0], d.shape[0],
                                          "cuda")
        o, d, t_max = (a[idx].contiguous() for a in (o, d, t_max))
        dcam = captured["closest_attrs"][4]
    prim, t = tk.trace_closest(clusters, o, d, t_max)
    prim_p, t_p = tk.trace_closest_plain(clusters, o, d, t_max)
    assert torch.equal(prim, prim_p)
    assert torch.equal(t, t_p)
    got = tk.closest_attrs(clusters, prim, o, d, dcam)
    want = tk.closest_attrs_plain(clusters, prim, o, d, dcam)
    tol = K3_TOLERANCE[case]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["city_64x32", "bench_960x540"])
@pytest.mark.parametrize("heuristic", ["balance", "power", "weighted",
                                       "optimal_clamped", "optimal"])
def test_fused_kernel_matches_plain(request, case, heuristic):
    """K4 under DIFFUSE_SPECULAR_MIS against its plain version, on the
    tiny city at 64x32 (2 spp) and on every pixel of the bench frame: bit
    for bit, miss pixels' dead slots included."""
    # Shadows on: the frame exports K4's ray slots (with them off it
    # takes K5).
    if case == "city_64x32":
        scene, camera = request.getfixturevalue("city")
        settings = RenderSettings(mis_heuristic=MisHeuristic(heuristic),
                                  sample_count=2, trace_shadow_rays=True)
        captured = {}
        pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                              settings, 64, 32,
                              kernels=bench_frame.recording_kernels(captured))
    else:
        scene, static, _ = request.getfixturevalue("bench_frames")()
        with torch.no_grad():
            captured = bench_frame.capture_inputs(
                scene, static, dataclasses.replace(
                    bench_frame.settings(),
                    mis_heuristic=MisHeuristic(heuristic)))
    args = captured["fused_shading"]
    got = fused.fused_light_shading(*args)
    want = fused.fused_light_shading_plain(*args)
    r = kernel_check.compare(got, want)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r


# (mean |d| limit, least share of pixels within 1e-3); the bench frame's
# cut to 128x64 has been held at the looser pair.
FRAME_TOLERANCE = {"city_64x32": (1e-4, 0.999), "bench_128x64": (5e-4, 0.995)}


@pytest.mark.parametrize("case", list(FRAME_TOLERANCE))
def test_frame_kernels_match_plain_versions(request, case):
    """A whole frame, shadows on, through the kernels against the frame
    through their plain versions within FRAME_TOLERANCE: the tiny city at
    64x32 and the bench frame's city, camera and settings at 128x64."""
    if case == "city_64x32":
        scene, camera = request.getfixturevalue("city")
        static = SceneStatic.for_scene(scene)
        settings = RenderSettings(trace_shadow_rays=True)

        def render(kernels):
            return pipeline.render_frame(scene, static, camera, settings, 64,
                                         32, kernels=kernels)
    else:
        scene, static, _ = request.getfixturevalue("bench_frames")()

        def render(kernels):
            return bench_frame.render(scene, static, bench_frame.settings(),
                                      kernels, 128, 64)
    with torch.no_grad():
        got = render(pipeline.KERNELS)
        want = render(pipeline.PLAIN_VERSIONS)
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    mean_limit, close_share = FRAME_TOLERANCE[case]
    assert float(diff.mean()) <= mean_limit
    assert float((diff.amax(dim=-1) <= 1e-3).float().mean()) >= close_share


# --- K4 DIFFUSE_ONLY and K5, every technique -------------------------------


PLANES_VERTEX_COUNTS = (3, 4, 5, 6, 7)


@pytest.fixture(scope="module")
def planes_scene(tmp_path_factory):
    """The roughness-planes stand-in lit by five lights of 3, 4, 5, 6 and 7
    vertices, every count the timing sweep and the arcade figures render
    (mixed vertex counts: one launch per group)."""
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
    faults = kernel_check.diffuse_only_faults(_capture_resolved(
        scene, camera, settings))
    assert not faults, faults


@pytest.mark.parametrize("tech", [Tech.PROJECTED_SOLID_ANGLE,
                                  Tech.PROJECTED_SOLID_ANGLE_BIASED],
                         ids=lambda t: t.value)
@pytest.mark.parametrize("heuristic", list(MisHeuristic),
                         ids=lambda h: h.value)
@pytest.mark.parametrize("case", ["planes_64x32", "bench_960x540"])
def test_resolved_mis_kernel_matches_plain(request, case, tech, heuristic):
    """K5 under DIFFUSE_SPECULAR_MIS (the default settings with shadows
    off) against its plain version, and K4 on K5's arguments against its
    own: bit for bit, the same float32 operations in the same order; on
    the planes at 64x32 (2 spp) and on 4,096 pixels of the bench frame."""
    if case == "planes_64x32":
        scene, camera = request.getfixturevalue("planes_scene")
        args = _capture_resolved(scene, camera, RenderSettings(
            polygon_sampling_technique=tech, mis_heuristic=heuristic,
            sample_count=2, trace_shadow_rays=False))
    else:
        scene, static, _ = request.getfixturevalue("bench_frames")()
        with torch.no_grad():
            args = kernel_check.pixel_subset(bench_frame.capture_inputs(
                scene, static, dataclasses.replace(
                    bench_frame.settings(), polygon_sampling_technique=tech,
                    mis_heuristic=heuristic, trace_shadow_rays=False))[
                        "fused_resolved"])
    got = fused.fused_light_shading_resolved(*args)
    want = fused.fused_light_shading_resolved_plain(*args)
    r = kernel_check.compare(got.T, want.T)
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r
    assert float(want.abs().max()) > 0
    r = kernel_check.compare(fused.fused_light_shading(*args),
                             fused.fused_light_shading_plain(*args))
    assert r["exact"] == 1.0 and r["nonfinite_mismatch"] == 0, r


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
                                  "bench_960x540", "planes_light_display"])
def test_preamble_kernel_matches_plain(request, tmp_path, case):
    """K6 against its plain version on the 1-light 1920x1080 sweep frame
    (roughness planes, central heptagon), the tiny city at 960x540
    (several materials and mips, uv outside [0, 1] and negative, the
    lights shown), the bench frame and the planes lit by five lights with
    show_polygonal_lights on: NaN exactly where the plain version is NaN
    (miss pixels), every other value bit for bit. A frame launches K6
    once, K4 or K5 take the plain version's planes, and the frame equals
    the one whose preamble is the plain version, bit for bit."""
    if case == "sweep_1920x1080":
        render = _sweep_frame(tmp_path)
    elif case == "city_960x540":
        render = _scene_frame(request.getfixturevalue("city"),
                              RenderSettings(trace_shadow_rays=True), 960,
                              540)
    elif case == "bench_960x540":
        scene = request.getfixturevalue("bench_frames")()[0]
        render = _scene_frame((scene, bench_frame.camera()),
                              bench_frame.settings(), 960, 540)
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


def _sweep_application(tmp_path, shadows, size=(64, 32)):
    """The central 4-gon 128-light PSA sweep experiment (113) on the card
    at `size` (None: its own, 1920x1080), with shadows on (K4 + K1) or off
    (K5)."""
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    exp = harness.create_experiment_list()[113]
    assert exp.settings.polygon_sampling_technique == \
        Tech.PROJECTED_SOLID_ANGLE
    width, height = size or (exp.width, exp.height)
    exp = dataclasses.replace(exp, width=width, height=height, settings=(
        dataclasses.replace(exp.settings, trace_shadow_rays=shadows)))
    return setups.build_default_application(exp, str(tmp_path), device="cuda")


@pytest.mark.parametrize("case", ["k5_64x32", "k4_64x32", "k5_1920x1080",
                                  "bench_960x540"])
def test_dispatch_has_no_host_wait(request, tmp_path, case):
    """Two dispatches of a K5 frame and of a K4 + K1 frame (experiment
    113 at 64x32 and, K5, at its own size; the bench frame) make no
    synchronizing call (sync debug mode "error"), so frames in flight
    overlap; the kernels did run."""
    from vulkan_renderer_tpu_torch.tools import host_waits
    if case == "bench_960x540":
        app = bench_frame.application(request.getfixturevalue("data_dir"),
                                      "cuda")
    else:
        app = _sweep_application(tmp_path, case.startswith("k4"),
                                 None if case.endswith("1080") else (64, 32))
    kernel = "K5" if case.startswith("k5") else "K4"
    trace.reset_counters()
    host_waits.dispatch_without_host_wait(app, 2)
    assert trace.launch_counts()[kernel] >= 3


def test_shadow_counters_on_the_card(tmp_path, monkeypatch):
    """With tracing on, K4 + K1 frames count their shadow rays (slots x
    pixels), the live ones among them (t_max >= 0) and the packets that
    hold one (both counted by K1's slot entry) with no synchronizing call
    in the dispatch: the device counts reach the host through pinned
    memory and are read when their frame retires. The expected counts are
    the plain version's, from the megabatch of the slot planes each frame
    handed K1."""
    from vulkan_renderer_tpu_torch.core import app as app_module
    from vulkan_renderer_tpu_torch.tools import host_waits
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
    plain = torch.zeros(2, dtype=torch.int32, device="cuda")
    for args in seen:
        tk.trace_anyhit_slots_plain(*args, *plain)
    assert counters["shadow.live_rays"] == int(plain[0])
    assert counters["shadow.packets"] == int(plain[1]) > 0
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


@pytest.mark.parametrize("packet", tk.PACKET_WIDTHS)
@pytest.mark.parametrize("case", PACKET_CASES)
def test_anyhit_slot_packets_match_plain(city, case, packet):
    """K1's slot entry at each packet width against its plain version on
    the packet cases over the city (tests/_torch_slot_inputs.py
    packet_case: S = 1, 7, 13 and 130, whose slot groups are no multiple
    of the wider packets; whole packets dead; rays of one packet occluded
    by the triangle under the pixel beside rays that never are; rays of
    one packet toward both sides of the scene): colors bit for bit, and
    the live rays and the packets that hold one as the plain version
    counts them."""
    scene, _ = city
    clusters = scene.clusters
    args = packet_case(clusters, case, 2**31 + 23)
    got_counts, want_counts = (torch.zeros(2, dtype=torch.int32,
                                           device="cuda") for _ in range(2))
    got = tk.trace_anyhit_slots(clusters, *args, *got_counts, packet=packet)
    want = tk.trace_anyhit_slots_plain(clusters, *args, *want_counts,
                                       packet=packet)
    assert kernel_check.bit_mismatches(got, want) == 0
    assert got_counts.tolist() == want_counts.tolist()
    assert int(got_counts[0]) > 0


@pytest.mark.parametrize("case", ["city_64x32", "bench_960x540"])
def test_anyhit_slots_entry_matches_plain_on_a_frame(request, case):
    """The slot planes a whole frame (K4, shadows on) hands K1's slot
    entry, on the tiny city at 64x32 and in the bench frame: the entry bit
    for bit as its plain version (on at most 4,096 evenly spaced
    pixels), and the ray-list K1 on the frame's megabatch as
    trace_anyhit_plain (on at most 131,072 rays: evenly spaced live ones
    where there are more)."""
    if case == "city_64x32":
        scene, camera = request.getfixturevalue("city")
        captured = {}
        pipeline.render_frame(scene, SceneStatic.for_scene(scene), camera,
                              RenderSettings(trace_shadow_rays=True), 64, 32,
                              kernels=bench_frame.recording_kernels(captured))
    else:
        captured = request.getfixturevalue("bench_frames")()[2]
    row, _ = kernel_check.hold_slot_entry(captured)
    assert row["bit_mismatches"] == 0, row
    clusters, *rays = bench_frame.anyhit_args(captured)
    assert bool((rays[2] >= 0.0).any()), "no live shadow ray"
    rays = kernel_check.ray_subset(*rays)
    assert torch.equal(tk.trace_anyhit(clusters, *rays),
                       tk.trace_anyhit_plain(clusters, *rays))


def test_stage_spans_sum_to_the_frame_device_interval(tmp_path):
    """With tracing on (core/trace.py), the 1-light 1920x1080 sweep frame
    (experiment 282, whose device paces the frame loop) is bit-equal to
    the untraced frame, and the device ms of the spans directly inside
    each frame's frame.dispatch (frame.constants and the stages) sum to
    the frame's device interval, its end event since the frame before's,
    within 5%."""
    from vulkan_renderer_tpu_torch.experiments import harness, setups
    from vulkan_renderer_tpu_torch.tools import frame_spans
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
    app = _sweep_application(tmp_path, False)
    app.render_frame_sync()
    ops, ranges = {}, {}
    for traced in (False, True):
        ops[traced], ranges[traced] = frame_spans.profiled(
            torch, app, trace, 2, traced)
    assert len(ops[True]) == len(ops[False]) > 0
    assert not ranges[False] and ranges[True]


def _bits_render(request, case):
    """render(bits): a case's linear frame with frame_bits = bits, noise
    frozen: the planes at 64x32 on each shading path (k4, k5, per_pixel),
    the bench frame, and experiments 113 (K5) and 46 (per-pixel, an IES
    light) at their own sizes through their Applications."""
    if case == "bench_960x540":
        scene, static, _ = request.getfixturevalue("bench_frames")()
        settings = dataclasses.replace(bench_frame.settings(),
                                       output_linear_rgb=True)
        return lambda bits: bench_frame.render(scene, static, dataclasses.
                                               replace(settings,
                                                       frame_bits=bits))
    if case.startswith("experiment_"):
        from vulkan_renderer_tpu_torch.experiments import harness, setups
        exp = harness.create_experiment_list()[int(case.split("_")[1])]
        app = setups.build_default_application(
            exp, request.getfixturevalue("data_dir"), device="cuda")

        def render(bits):
            app.settings = dataclasses.replace(
                exp.settings, frame_bits=bits, animate_noise=False,
                output_linear_rgb=True)
            return app.render_frame_sync()
        return render
    scene, camera = request.getfixturevalue("planes_scene")
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY
        if case == "per_pixel" else SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        trace_shadow_rays=case != "k5", output_linear_rgb=True)
    static = SceneStatic.for_scene(scene)
    return lambda bits: pipeline.render_frame(
        scene, static, camera, dataclasses.replace(settings, frame_bits=bits),
        64, 32)


@pytest.mark.parametrize("case", ["k4", "k5", "per_pixel", "bench_960x540",
                                  "experiment_113", "experiment_46"])
def test_frame_bits_recombine_on_card(request, case):
    """frame_bits 1 and 2 recombine to the direct linear frame rounded to
    float16, bit for bit, on each shading path; the direct frame is finite
    and not black."""
    from vulkan_renderer_tpu_torch.render.screenshot import \
        combine_ldr_screenshots_into_hdr
    from vulkan_renderer_tpu_torch.tools import hdr_capture
    with torch.no_grad():
        low, high, direct = hdr_capture.bit_frames(_bits_render(request,
                                                                case))
    combined = combine_ldr_screenshots_into_hdr(low, high)
    assert hdr_capture.half_mismatches(combined, direct) == 0
    assert np.isfinite(direct).all() and float(direct.mean()) > 0.0


@pytest.mark.parametrize("case", ["planes_64x32", "bench_960x540"])
def test_bands_on_card(request, case):
    """The frame as 4 bands on one card (of 8 rows of the planes' 64x32
    frame, of 135 of the bench frame) equals the whole frame bit for bit;
    each band launches K1, K2, K3 and K6 once and K4 once per vertex-count
    group."""
    from vulkan_renderer_tpu_torch.parallel.tiles import render_frame_bands
    if case == "planes_64x32":
        scene, camera = request.getfixturevalue("planes_scene")
        static = SceneStatic.for_scene(scene)
        settings, size, noise = RenderSettings(trace_shadow_rays=True), \
            (64, 32), None
    else:
        scene, static, _ = request.getfixturevalue("bench_frames")()
        camera, settings = bench_frame.camera(), bench_frame.settings()
        size = (bench_frame.WIDTH, bench_frame.HEIGHT)
        noise = bench_frame.noise_numbers()
    with torch.no_grad():
        whole = pipeline.render_frame(scene, static, camera, settings, *size,
                                      noise)
        trace.reset_counters()
        banded = render_frame_bands(["cuda:0"] * 4, scene, static, camera,
                                    settings, *size, noise)
    torch.cuda.synchronize()
    assert torch.equal(banded, whole)
    groups = len(fused.vertex_groups(static))
    launches = trace.launch_counts()
    assert {n: launches[n] for n in ("K1", "K2", "K3", "K4", "K6")} == \
        {"K1": 4, "K2": 4, "K3": 4, "K4": 4 * groups, "K6": 4}


@pytest.mark.parametrize("scene, rays", [("layered_floor", 65536)] + [
    (name, 1024 * 1024) for name in prune_check.SCENES])
def test_closest_kernel_exact_where_pruning_decides(scene, rays):
    """K2 against its plain version on tools/prune_check.py's scenes of 64
    clusters or more: the layered floor's rays at shared tile edges, many
    grazing, and rays from one eye at thin_edge_scene, whose edge-on
    triangles and slivers give computed hits short of their own boxes:
    prim and t exact, ties included (the prune's margin at work)."""
    row = prune_check.measure("cuda", rays, scene)
    assert row["clusters"] >= 64, row
    assert row["rays_at_risk"] > 0, row
    assert row["prim_mismatches"] == row["t_bit_mismatches"] == 0, row
