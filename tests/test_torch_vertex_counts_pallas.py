"""K5's plain version (render/fused.py::fused_light_shading_resolved_plain)
against the JAX Pallas K5 itself, render/fused.py::
fused_light_shading_resolved run in interpret mode with one-row tiles (as
test_torch_resolved.py::test_resolved_matches_jax_pallas_interpret runs
it), at the vertex counts the timing sweep adds to the quad and the
pentagon: a hexagon and a heptagon (two launches of the port's K5, one
per vertex count) and a triangle; for PSA and Arvo PSA at 1 spp.

The pixels are one lane row, 128: the JAX kernel pads a smaller subset to
128 lanes and costs the same (each layout's interpreted kernel takes
6-35 s to trace and compile here). At 32 pixels of one light a pixel is
3% of the values, and the JAX package's own Pallas kernel and XLA twin
part on one of the first 32 under Arvo PSA at NV = 3.

Tolerance of test_torch_resolved.py: >= 97% of the color values (94% for
Arvo PSA, whose sector boundaries flip a sample more often) within 1e-4
of the largest |value| + 1e-3 relative, the mean |difference| under 2e-3
of that value, the finite pattern equal. Measured: PSA every value at
both layouts; Arvo PSA 97.7% at NV = 3 (the JAX package's own two
versions 98.4%) and 99.2% at (6, 7)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_shading_inputs import (light_specs, noise_inputs, port_inputs,
                                   shading_inputs, to_port)
from test_torch_resolved import _check as resolved_check
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
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
LAYOUTS = ((6, 7), (3,))
PIXELS = 128


@pytest.fixture(scope="module")
def inputs():
    """test_torch_vertex_counts.py's inputs, its first PIXELS pixels."""
    data, ltc, hit = shading_inputs(seed=23)
    return ({k: v[:PIXELS] for k, v in data.items()},
            {k: v[:PIXELS] for k, v in ltc.items()}, hit[:PIXELS])


@pytest.mark.parametrize("counts", LAYOUTS,
                         ids=lambda c: "nv" + "_".join(map(str, c)))
@pytest.mark.parametrize("tech", [Tech.PROJECTED_SOLID_ANGLE,
                                  Tech.PROJECTED_SOLID_ANGLE_ARVO],
                         ids=lambda t: t.value)
def test_k5_plain_matches_jax_pallas_interpret(inputs, tech, counts):
    data, ltc, hit = inputs
    specs = light_specs(counts)
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=1, trace_shadow_rays=False)
    jax_noise, noise = noise_inputs(settings, len(specs), seed=6, p=PIXELS,
                                    width=8)
    jstatic = JSceneStatic(light_count=len(specs),
                           light_texturing=(0,) * len(specs),
                           light_vertex_counts=counts)
    lights = stack_lights([update_polygonal_light(s) for s in specs])
    want = np.asarray(j_fused.fused_light_shading_resolved(
        JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
        JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()}),
        jnp.asarray(hit), jnp.asarray(jax_noise),
        j_fused._pack_light_scalars(lights, len(specs)), jnp.float32(0.5),
        jstatic, settings, interpret=True, tile_rows=1))
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    got = fused.fused_light_shading_resolved(
        planes, noise, light_scalars, static, to_port(settings)).numpy()
    assert got.shape == want.shape == (PIXELS, 3)
    resolved_check(got, want, tech)
    assert np.abs(want[np.isfinite(want)]).max() > 0
