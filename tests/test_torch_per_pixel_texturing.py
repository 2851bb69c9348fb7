"""The per-pixel path's textured lights and error displays against the
JAX package's evaluate_polygonal_light_shading, vmapped over pixels.

Texturing 1-3 (area texture, light probe, IES profile) read a float32
light atlas through atan2/acos (probe, IES) or the plane intersection
(area); IES divides by |cos| of the emission angle, so it is infinite at
grazing angles in both packages. Tolerance: test_torch_per_pixel.py's
(finite pattern exact, >= 99.5% within 1e-4 of scale + 1e-3 relative).

Error displays color each pixel by the log10 of the PSA inversion's
error: 4 tab20b colors per decade above 10^error_min_exponent. In the
decentral case that error is a float32 rounding residual of the sampled
area (test_torch_sampling_ops.py), so the two formulations give residuals
of the same size but not the same value, and a pixel's color may differ
by a few bins. Tolerance: the lit/unlit pattern (black where the light is
clipped away) agrees for >= 99.5% of pixels, every ray slot is empty in
both, >= 98% of pixels are within 4 bins (one decade of error) and the
mean bin agrees within 0.75."""

import numpy as np
import pytest
import torch

from _torch_shading_inputs import (compare_light_shading,
                                   jax_frame_constants, light_specs,
                                   per_pixel_inputs, per_pixel_scenes,
                                   port_frame_constants, quantized_noise,
                                   shading_inputs, to_port)
from vulkan_renderer_tpu.core.settings import (ErrorDisplay,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu_torch.render import shading
from vulkan_renderer_tpu_torch.tools import per_pixel_check

Tech = PolygonSamplingTechnique
Strategy = SamplingStrategy


def light_textures(seed=3):
    """White (index 0), an RGB probe-like texture and an RGBA one."""
    rng = np.random.default_rng(seed)
    return [[np.ones((4, 4, 4), np.float32)],
            [rng.uniform(0.2, 2.0, (8, 16, 3)).astype(np.float32)],
            [rng.uniform(0.0, 1.5, (16, 16, 4)).astype(np.float32)]]


def textured_specs(texturing):
    specs = light_specs((4, 5))
    for i, spec in enumerate(specs):
        spec.texturing_technique = texturing
        spec.texture_index = 1 + i
    return specs


@pytest.mark.parametrize("texturing", [1, 2, 3])
def test_textured_lights_match_reference(texturing):
    settings = RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_MIS)
    results = compare_light_shading(settings, textured_specs(texturing),
                                    seed=41, light_textures=light_textures(),
                                    threshold=0.995)
    assert max(float(r.b[torch.isfinite(r.b)].abs().max())
               for r in results) > 0


def test_textured_radiance_matches_reference():
    """get_polygon_radiance itself, every texturing mode, from per-pixel
    shading positions along random directions."""
    import jax
    specs = textured_specs(0)
    jscene, scene = per_pixel_scenes(specs, light_textures())
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = rng.normal(size=(400, 3)).astype(np.float32)
    for texturing in (0, 1, 2, 3):
        scene.lights.texture_index[:] = torch.tensor([1, 2])
        jlights = jscene.lights._replace(
            texture_index=np.array([1, 2], np.int32))
        jsc = type(jscene)(**{**vars(jscene), "lights": jlights})
        for i in range(2):
            want = np.asarray(jax.vmap(
                lambda d, x: j_shading.get_polygon_radiance(
                    jsc, i, texturing, d, x))(dirs, pos))
            got = shading.get_polygon_radiance(
                scene, i, texturing, torch.from_numpy(dirs),
                torch.from_numpy(pos))
            got = got.expand(400, 3).numpy()
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            # atan2/acos are other float32 formulas, and IES divides by
            # |cos| of the emission angle, which amplifies a rounding
            # difference near grazing: 99% within 2e-4 relative.
            close = np.isclose(got[fin], want[fin], rtol=2e-4, atol=1e-6)
            assert close.mean() >= 0.99, (texturing, close.mean())


def error_cases():
    cases = []
    for strategy, tech, displays in (
            (Strategy.DIFFUSE_ONLY, Tech.PROJECTED_SOLID_ANGLE,
             ("DIFFUSE_BACKWARD", "DIFFUSE_BACKWARD_SCALED",
              "DIFFUSE_FORWARD")),
            (Strategy.DIFFUSE_ONLY, Tech.PROJECTED_SOLID_ANGLE_BIASED,
             ("DIFFUSE_FORWARD",)),
            (Strategy.DIFFUSE_ONLY, Tech.PROJECTED_SOLID_ANGLE_ARVO,
             ("DIFFUSE_BACKWARD", "DIFFUSE_BACKWARD_SCALED")),
            (Strategy.DIFFUSE_SPECULAR_SEPARATELY,
             Tech.PROJECTED_SOLID_ANGLE,
             ("SPECULAR_BACKWARD", "SPECULAR_BACKWARD_SCALED",
              "SPECULAR_FORWARD")),
            (Strategy.DIFFUSE_SPECULAR_MIS, Tech.PROJECTED_SOLID_ANGLE_BIASED,
             ("DIFFUSE_BACKWARD",)),
            (Strategy.DIFFUSE_SPECULAR_RANDOM, Tech.PROJECTED_SOLID_ANGLE,
             ("SPECULAR_FORWARD",))):
        for display in displays:
            cases.append(pytest.param(
                RenderSettings(sampling_strategy=strategy,
                               polygon_sampling_technique=tech,
                               error_display=ErrorDisplay[display]),
                id=f"{strategy.value}-{tech.value}-{display.lower()}"))
    return cases


def assert_error_bins_agree(got, want):
    """The error-display tolerance (module docstring), as
    tools/per_pixel_check.py states and checks it."""
    ok, stats = per_pixel_check.error_bins_agree(got, want)
    assert ok, stats


@pytest.mark.parametrize("settings", error_cases())
def test_error_displays_match_reference(settings):
    import jax
    p = 480
    specs = light_specs((4, 6))
    data, ltc, _ = shading_inputs(43, p)
    jdata, jltc, tdata, tltc = per_pixel_inputs(data, ltc)
    jscene, scene = per_pixel_scenes(specs)
    counts = tuple(s.vertex_count for s in specs)
    jstatic = j_shading.SceneStatic(light_count=2, light_texturing=(0, 0),
                                    light_vertex_counts=counts)
    static = shading.SceneStatic(light_count=2, light_texturing=(0, 0),
                                 light_vertex_counts=counts)
    ppl = j_shading.pairs_per_light(settings)
    for i in range(2):
        noise = quantized_noise((p, ppl, 2), 44 + i)
        want = jax.vmap(lambda d, l, nz: j_shading
                        .evaluate_polygonal_light_shading(
                            jscene, jstatic, settings,
                            jax_frame_constants(settings), i, d, l, nz))(
            jdata, jltc, noise)
        got = shading.evaluate_polygonal_light_shading(
            scene, static, to_port(settings), port_frame_constants(settings),
            i, tdata, tltc, torch.from_numpy(noise))
        for name in ("b", "ray_dirs", "t_max"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert_error_bins_agree(got.base.numpy(), np.asarray(want.base))
