"""The per-pixel path as a whole: the port's render_frame with
SceneStatic.fused = "off" (CPU: plain K1-K3, per-pixel shading) against
the JAX package's render_frame with fused="off" and traversal=
"bruteforce" (vmapped _shade_pixel), on the cornell box at 64x32, under
DIFFUSE_SPECULAR_SEPARATELY (shadows on), DIFFUSE_SPECULAR_RANDOM,
DIFFUSE_GGX_MIS (shadows on) and an error display; both packages get the
same scene arrays through scene_from_numpy. Also: the shading-path
dispatch (fused "auto", "on", "off") and the pixel chunk size.

Tolerance: mean |sRGB difference| <= 1e-3 and >= 99% of pixels within
1e-2, the fused frame tests' (test_torch_frame.py). The error display's
colors are log-binned rounding residuals (test_torch_per_pixel_texturing.
py states that tolerance); its frame is compared bin by bin in linear
RGB."""

import dataclasses

import numpy as np
import pytest

from _torch_shading_inputs import to_port
from test_torch_per_pixel_texturing import assert_error_bins_agree
from vulkan_renderer_tpu.assets.noise import NoiseType
from vulkan_renderer_tpu.core.settings import (ErrorDisplay, MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene
from vulkan_renderer_tpu.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.render import pipeline
from vulkan_renderer_tpu_torch.render.pipeline import render_frame
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)
from vulkan_renderer_tpu_torch.tools import per_pixel_check

WIDTH, HEIGHT = 64, 32
Strategy = SamplingStrategy
Tech = PolygonSamplingTechnique
CAMERA = FirstPersonCamera(
    position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
    rotation_x=np.pi / 2, rotation_z=np.pi)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cornell"))
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    jscene = load_scene(vks, d + "/cornell_box_textures", [light],
                        noise_type=NoiseType.WHITE, data_directory=d)
    return jscene, scene_from_numpy(tree_leaves(jscene), "cpu")


def compare_frames(jscene, scene, settings, camera=CAMERA,
                   linear_light_count=0):
    """Render with both packages on the per-pixel path; returns (port
    frame, JAX frame)."""
    texturing = tuple(int(t) for t in
                      np.asarray(jscene.lights.texturing_technique))
    jstatic = JSceneStatic(light_count=len(texturing),
                           light_texturing=texturing,
                           linear_light_count=linear_light_count,
                           traversal="bruteforce", fused="off")
    want = np.asarray(j_render(jscene, jstatic, camera, settings, WIDTH,
                               HEIGHT))
    static = SceneStatic.for_scene(scene, fused="off")
    assert static.linear_light_count == linear_light_count
    got = render_frame(scene, static, to_port(camera), to_port(settings),
                       WIDTH, HEIGHT).numpy()
    assert got.shape == want.shape == (HEIGHT, WIDTH, 3)
    return got, want


def assert_frames_agree(got, want):
    ok, stats = per_pixel_check.frames_agree(got, want)
    assert ok, stats


@pytest.mark.parametrize("settings", [
    pytest.param(RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_SEPARATELY,
        trace_shadow_rays=True), id="separately-shadows"),
    pytest.param(RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_RANDOM,
        polygon_sampling_technique=Tech.PROJECTED_SOLID_ANGLE_BIASED,
        sample_count=2), id="random"),
    pytest.param(RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_GGX_MIS,
        polygon_sampling_technique=Tech.SOLID_ANGLE,
        mis_heuristic=MisHeuristic.BALANCE, trace_shadow_rays=True),
        id="ggx-mis-shadows")])
def test_per_pixel_frame_matches_reference(cornell, settings):
    got, want = compare_frames(*cornell, settings)
    assert_frames_agree(got, want)
    assert 0.05 < got.mean() < 0.95


def test_error_display_frame_matches_reference(cornell):
    settings = RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_ONLY,
        error_display=ErrorDisplay.DIFFUSE_FORWARD, output_linear_rgb=True)
    got, want = compare_frames(*cornell, settings)
    assert_error_bins_agree(got.reshape(-1, 3), want.reshape(-1, 3))


def test_pixel_chunk_size_changes_no_result(cornell, monkeypatch):
    """The per-pixel path shades PIXEL_CHUNK pixels at a time; two chunk
    sizes (the whole frame, and 320 pixels: chunks that split rows) give
    bit-equal frames, with the shadow megabatch."""
    _, scene = cornell
    static = SceneStatic.for_scene(scene, fused="off")
    settings = to_port(RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_MIS,
        trace_shadow_rays=True))
    frames = []
    for chunk in (WIDTH * HEIGHT, 320):
        monkeypatch.setattr(pipeline, "PIXEL_CHUNK", chunk)
        frames.append(render_frame(scene, static, to_port(CAMERA), settings,
                                   WIDTH, HEIGHT).numpy())
    np.testing.assert_array_equal(frames[0], frames[1])


def _recording_kernels(calls):
    """The plain kernels, recording which shading kernel each frame
    calls."""
    def record(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped
    k = pipeline.PLAIN_VERSIONS
    return dataclasses.replace(
        k, fused_shading=record("K4", k.fused_shading),
        fused_resolved=record("K5", k.fused_resolved))


def test_dispatch_follows_fused_supported(cornell):
    """fused "auto" takes K4 (shadows) or K5 exactly where fused_supported
    holds and the per-pixel path elsewhere; "off" never takes them; "on"
    raises where they do not cover the settings. (On the card the launch
    counters show the same: tests/test_torch_gpu.py.)"""
    from vulkan_renderer_tpu_torch.render.fused import fused_supported
    _, scene = cornell
    w, h = 16, 8
    cases = [(RenderSettings(trace_shadow_rays=True), "K4"),
             (RenderSettings(sampling_strategy=Strategy.DIFFUSE_ONLY,
                             polygon_sampling_technique=Tech.AREA_TURK),
              "K5"),
             (RenderSettings(
                 sampling_strategy=Strategy.DIFFUSE_SPECULAR_SEPARATELY,
                 trace_shadow_rays=True), None),
             (RenderSettings(sampling_strategy=Strategy.DIFFUSE_ONLY,
                             error_display=ErrorDisplay.DIFFUSE_BACKWARD),
              None)]
    for settings, kernel in cases:
        settings = to_port(settings)
        for mode in ("auto", "on", "off"):
            static = SceneStatic.for_scene(scene, fused=mode)
            assert fused_supported(static, settings) == (kernel is not None)
            calls = []
            kernels = _recording_kernels(calls)
            if mode == "on" and kernel is None:
                with pytest.raises(ValueError, match="fused='on'"):
                    render_frame(scene, static, to_port(CAMERA), settings,
                                 w, h, kernels=kernels)
                continue
            render_frame(scene, static, to_port(CAMERA), settings, w, h,
                         kernels=kernels)
            want = [kernel] if kernel and mode != "off" else []
            assert calls == want, (settings, mode, calls)


@pytest.fixture(scope="module")
def error_display_frames(tmp_path_factory):
    """tools/per_pixel_check.py's error-display class on the CPU: its frame
    and the frame whose estimate error_to_color shows doubled."""
    import torch

    from vulkan_renderer_tpu_torch.render import shading
    files = per_pixel_check.write_scene_files(
        str(tmp_path_factory.mktemp("per_pixel")))
    scenes = per_pixel_check.load_scenes(files, "cpu")
    with torch.no_grad():
        frame = per_pixel_check.render_class(scenes, "error_display")
    patch = pytest.MonkeyPatch()
    to_color = shading.error_to_color
    patch.setattr(shading, "error_to_color",
                  lambda error, factor: to_color(error, 2.0 * factor))
    try:
        with torch.no_grad():
            doubled = per_pixel_check.render_class(scenes, "error_display")
    finally:
        patch.undo()
    return frame.numpy(), doubled.numpy()


def test_error_bins_agree_rejects_a_doubled_estimate(error_display_frames):
    frame, doubled = error_display_frames
    ok, stats = per_pixel_check.error_bins_agree(doubled, frame)
    assert not ok, stats
    # The statistics the check had before pass the doubled frame: only
    # the one-way share over the pixels above the clamp floor sees it.
    assert stats["mean_abs_bin_diff"] <= 0.75 and stats["above_floor"] > 100
    assert stats["one_way_share"] > 0.95
    ok, stats = per_pixel_check.error_bins_agree(frame, frame)
    assert ok and stats["one_way_share"] == 0.0, stats
