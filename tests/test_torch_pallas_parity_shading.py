"""K4's plain version (render/fused.py::fused_light_shading_plain) against
the JAX Pallas K4 itself, render/fused.py::fused_light_shading run in
interpret mode (as tests/test_fused.py runs it), on the same seeded
shading data, LTC coefficients, hit mask, noise table and light records
(tests/test_torch_fused.py's inputs: 256 pixels, a quad and a pentagon
light): three techniques under DIFFUSE_ONLY at 2 spp here, and PSA under
DIFFUSE_SPECULAR_MIS with clamped-optimal MIS at the bench frame's 1 spp
in test_torch_pallas_parity_shading_mis.py (its interpreted kernel takes
about a minute to trace and compile on the CPU).

Tolerance: the twin test's (test_torch_fused.py::
test_fused_plain_matches_reference, against the XLA twin of the kernel):
the finite pattern equal, and >= 99.5% of each output's values within
1e-4 of its largest |value| + 1e-3 relative; measured: every value
within it under DIFFUSE_ONLY, and 99.9% of the MIS case's directions
(one sample moved across a sector boundary; base, b and t_max all
within). The interpreted kernel runs
the XLA twin's per-slot body (render/fused.py _shade_tile), and XLA's
rsqrt/cos/sin round an ulp apart from torch's, which can move a sample
across a sector boundary. base and b are compared at every pixel;
directions and t_max where the pixel hit something, and the dead slot
(direction 0, t_max -1) where it did not: the port does not shade a miss
pixel, whose b the JAX kernel gates to 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_shading_inputs import noise_inputs, to_port
from test_torch_fused import SPECS, STATIC, inputs  # noqa: F401 (fixture)
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
from vulkan_renderer_tpu_torch.ops.ltc import LtcCoefficients
from vulkan_renderer_tpu_torch.render import fused
from vulkan_renderer_tpu_torch.render.shading import ShadingData
from vulkan_renderer_tpu_torch.scene.scene import lights_from_specs

Tech = PolygonSamplingTechnique
DIFFUSE_ONLY = [Tech.PROJECTED_SOLID_ANGLE, Tech.SOLID_ANGLE, Tech.BASELINE]


@pytest.mark.parametrize("tech", DIFFUSE_ONLY, ids=lambda t: t.value)
def test_fused_plain_matches_pallas_interpret_diffuse_only(inputs, tech):
    check_pallas_interpret(inputs, SamplingStrategy.DIFFUSE_ONLY, tech, 2)


def check_pallas_interpret(inputs, strategy, tech, samples):
    """The interpreted Pallas K4 against the port's plain K4 under these
    settings (clamped-optimal MIS), at the module docstring's tolerance."""
    data, ltc, hit = inputs
    settings = RenderSettings(
        sampling_strategy=strategy, polygon_sampling_technique=tech,
        mis_heuristic=MisHeuristic.OPTIMAL_CLAMPED, sample_count=samples)
    jax_noise, noise = noise_inputs(settings, 2, seed=12, p=256, width=8)
    jstatic = JSceneStatic(light_count=2, light_texturing=(0, 0),
                           light_vertex_counts=(4, 5))
    lights = stack_lights([update_polygonal_light(s) for s in SPECS])
    want = j_fused.fused_light_shading(
        JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
        JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()}),
        jnp.asarray(hit), jnp.asarray(jax_noise),
        j_fused._pack_light_scalars(lights, 2),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings,
        interpret=True, tile_rows=1)
    want = [np.array(w) for w in want]
    want[2][~hit], want[3][~hit] = 0.0, -1.0

    planes = fused.pack_planes(
        ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
        LtcCoefficients(**{k: torch.from_numpy(v) for k, v in ltc.items()}),
        torch.from_numpy(hit))
    slots = want[1].shape[1]
    out = fused.fused_light_shading_plain(
        planes, noise, fused.pack_light_scalars(
            lights_from_specs(to_port(SPECS), "cpu"), 2),
        STATIC, to_port(settings))
    got = [g.numpy() for g in fused.unpack_outputs(out, slots)]
    for name, g, w in zip(("base", "b", "dirs", "t_max"), got, want):
        assert g.shape == w.shape, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        scale = np.abs(w[fin]).max()
        ok = np.abs(g[fin] - w[fin]) <= 1e-4 * scale + 1e-3 * np.abs(w[fin])
        assert ok.mean() >= 0.995, (name, ok.mean())
    assert np.abs(got[1]).max() > 0
