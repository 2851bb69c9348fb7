"""Parity of the port's no-shadow resolved shading (render/fused.py
fused_light_shading_resolved_plain, the plain version of kernel K5) with
the JAX package: base + sum over ray slots of b from the plain-XLA
fused_light_shading_xla, which is the equality tests/test_fused.py
establishes for the JAX K5. Both read one seeded noise table: the JAX
package as get_noise_image, the port as the FrameNoise that K5 reads.
Mixed vertex counts exercise the per-group launches.

Tolerance: K5 sums the same per-slot terms in another order (per light
base + (b_0 + b_1 + ...), lights grouped by vertex count) than the JAX
reference, and XLA's and torch's transcendentals differ by an ulp, which
can flip a boundary sample. A pixel's color sums all its lights' slots
(12 here), so one flipped slot moves the pixel: >= 97% of the color
values (94% for the Arvo techniques, whose per-slot flip rate is higher,
test_torch_techniques.py) agree within 1e-4 of the largest |value|
(+1e-3 relative), the mean |difference| stays under 2e-3 of that largest
value, and the finite pattern is identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_shading_inputs import (agreement, jax_reference, light_specs,
                                   noise_inputs, port_inputs, shading_inputs,
                                   to_port)
from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.ops.brdf import ShadingData as JShadingData
from vulkan_renderer_tpu.ops.ltc import LtcCoefficients as JLtc
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.lights import (stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.render import fused

Tech = PolygonSamplingTechnique
MIXED = (5, 4, 3, 4)


@pytest.fixture(scope="module")
def inputs():
    return shading_inputs(seed=17)


def _resolved(inputs, specs, settings):
    data, ltc, hit = inputs
    jax_noise, noise = noise_inputs(settings, len(specs), seed=10)
    base, b, _, _ = jax_reference(data, ltc, hit, jax_noise, specs, settings)
    want = base + b.sum(axis=1)
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    got = fused.fused_light_shading_resolved(planes, noise, light_scalars,
                                             static, to_port(settings))
    return got.numpy(), want


def _check(got, want, tech):
    need = 0.94 if tech in (Tech.SOLID_ANGLE_ARVO,
                            Tech.PROJECTED_SOLID_ANGLE_ARVO) else 0.97
    assert agreement(got, want, tech.value) >= need, \
        agreement(got, want, tech.value)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    assert np.abs(got[fin] - want[fin]).mean() <= 2e-3 * scale


@pytest.mark.parametrize("tech", list(Tech), ids=lambda t: t.value)
def test_resolved_diffuse_only_matches_reference(inputs, tech):
    counts = (4, 4) if tech == Tech.RECTANGLE_SOLID_ANGLE_URENA else MIXED
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=3, trace_shadow_rays=False)
    got, want = _resolved(inputs, light_specs(counts), settings)
    assert got.shape == want.shape == (inputs[0]["position"].shape[0], 3)
    _check(got, want, tech)
    assert np.abs(want[np.isfinite(want)]).max() > 0


@pytest.mark.parametrize("tech,heuristic", [
    (Tech.PROJECTED_SOLID_ANGLE, MisHeuristic.BALANCE),
    (Tech.PROJECTED_SOLID_ANGLE, MisHeuristic.POWER),
    (Tech.PROJECTED_SOLID_ANGLE, MisHeuristic.WEIGHTED),
    (Tech.PROJECTED_SOLID_ANGLE, MisHeuristic.OPTIMAL_CLAMPED),
    (Tech.PROJECTED_SOLID_ANGLE, MisHeuristic.OPTIMAL),
    (Tech.PROJECTED_SOLID_ANGLE_BIASED, MisHeuristic.OPTIMAL_CLAMPED)],
    ids=lambda v: v.value)
def test_resolved_mis_matches_reference(inputs, tech, heuristic):
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=tech, mis_heuristic=heuristic,
        sample_count=2, trace_shadow_rays=False)
    got, want = _resolved(inputs, light_specs(MIXED), settings)
    _check(got, want, tech)


def test_resolved_matches_jax_pallas_interpret(inputs):
    """One call of the JAX K5 itself (interpret mode, one-row tiles) on a
    small pixel subset, against the port's plain K5."""
    data, ltc, hit = inputs
    sub = slice(0, 32)
    data = {k: v[sub] for k, v in data.items()}
    ltc = {k: v[sub] for k, v in ltc.items()}
    hit = hit[sub]
    specs = light_specs((4, 3))
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=Tech.SOLID_ANGLE,
                              sample_count=2, trace_shadow_rays=False)
    jax_noise, noise = noise_inputs(settings, len(specs), seed=4, p=32,
                                    width=8)
    jstatic = JSceneStatic(light_count=2, light_texturing=(0, 0),
                           light_vertex_counts=(4, 3))
    lights = stack_lights([update_polygonal_light(s) for s in specs])
    want = np.asarray(j_fused.fused_light_shading_resolved(
        JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
        JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()}),
        jnp.asarray(hit), jnp.asarray(jax_noise),
        j_fused._pack_light_scalars(lights, 2), jnp.float32(0.5), jstatic,
        settings, interpret=True, tile_rows=1))
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    got = fused.fused_light_shading_resolved(
        planes, noise, light_scalars, static, to_port(settings)).numpy()
    _check(got, want, Tech.SOLID_ANGLE)
