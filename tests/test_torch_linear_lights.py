"""Linear (segment) lights on the port's per-pixel path against the JAX
package: the stacked lights' linear radiance, the line sampling functions
and evaluate_linear_light_shading for each technique (uniform, distance,
projected RIS) under DIFFUSE_ONLY and a combined strategy, vmapped over
the same seeded shading data and UNORM16-quantized noise pairs.

Tolerance: as test_torch_per_pixel.py (finite pattern exact, >= 99.5%
of values within 1e-4 of the array's scale + 1e-3 relative): atan2 and
tan of the distance sampler are other float32 formulas in torch and
XLA, and RIS may pick the neighbouring candidate where two cumulative
weights straddle the selection number."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_shading_inputs import (agreement, per_pixel_inputs,
                                   per_pixel_scenes, quantized_noise,
                                   shading_inputs, to_port)
from vulkan_renderer_tpu.core.settings import RenderSettings, \
    SamplingStrategy
from vulkan_renderer_tpu.ops import line_sampling as j_line
from vulkan_renderer_tpu.render import line_shading as j_line_shading
from vulkan_renderer_tpu.scene.linear_lights import (LinearLightSpec,
                                                     stack_linear_lights)
from vulkan_renderer_tpu_torch.ops import line_sampling
from vulkan_renderer_tpu_torch.render import line_shading
from vulkan_renderer_tpu_torch.scene import linear_lights

SPECS = [LinearLightSpec(start=np.array([-0.8, 0.3, 1.4], np.float32),
                         end=np.array([0.9, -0.2, 1.6], np.float32),
                         radiant_flux=np.array([30.0, 27.0, 21.0],
                                               np.float32)),
         LinearLightSpec(start=np.array([1.5, 1.0, 0.2], np.float32),
                         end=np.array([1.5, -1.0, 0.4], np.float32),
                         radiant_flux=np.array([8.0, 9.0, 10.0],
                                               np.float32))]


def test_linear_light_records_match_reference():
    want = stack_linear_lights(SPECS)
    got = linear_lights.stack_linear_lights(
        [linear_lights.LinearLightSpec(**dataclasses.asdict(s))
         for s in SPECS], "cpu")
    for name in ("start", "end", "linear_radiance"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    empty = linear_lights.stack_linear_lights([], "cpu")
    assert empty.count == 0 and empty.start.shape == (0, 3)


def test_line_sampling_matches_reference():
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(400, 3)).astype(np.float32)
    u = quantized_noise((400,), 9)
    a, b = SPECS[0].start, SPECS[0].end
    jprep = jax.vmap(lambda x: j_line.prepare_line_sampling(
        jnp.asarray(a), jnp.asarray(b), x))(pos)
    prep = line_sampling.prepare_line_sampling(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pos))
    for name in ("foot_s", "h", "theta0", "theta1", "norm_1_d2"):
        np.testing.assert_allclose(getattr(prep, name).numpy(),
                                   np.asarray(getattr(jprep, name)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    jt, jdens = jax.vmap(j_line.sample_line_distance)(jprep, u)
    tt, dens = line_sampling.sample_line_distance(prep, torch.from_numpy(u))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), rtol=1e-4)
    jgeo = jax.vmap(j_line.line_geometry)(jprep, jt, pos)
    geo = line_sampling.line_geometry(prep, tt, torch.from_numpy(pos))
    for g, w in zip(geo, jgeo):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("technique", ["uniform", "distance",
                                       "projected_ris"])
@pytest.mark.parametrize("strategy", [SamplingStrategy.DIFFUSE_ONLY,
                                      SamplingStrategy.DIFFUSE_SPECULAR_MIS])
def test_linear_light_shading_matches_reference(technique, strategy):
    settings = RenderSettings(sampling_strategy=strategy,
                              linear_technique=technique, sample_count=2)
    port_settings = to_port(settings)
    lppl = j_line_shading.linear_pairs_per_light(settings)
    assert line_shading.linear_pairs_per_light(port_settings) == lppl
    assert line_shading.linear_rays_per_light(port_settings) \
        == j_line_shading.linear_rays_per_light(settings)
    p = 480
    data, ltc, _ = shading_inputs(51, p)
    jdata, jltc, tdata, tltc = per_pixel_inputs(data, ltc)
    jscene, scene = per_pixel_scenes([], linear_specs=SPECS)
    for i in range(len(SPECS)):
        noise = quantized_noise((p, lppl, 2), 52 + i)
        want = jax.vmap(lambda d, l, nz: j_line_shading
                        .evaluate_linear_light_shading(
                            jscene, settings, i, d, l, nz))(jdata, jltc,
                                                            noise)
        got = line_shading.evaluate_linear_light_shading(
            scene, port_settings, i, tdata, tltc, torch.from_numpy(noise))
        for name, g, w in zip(("base", "b", "ray_dirs", "t_max"), got,
                              want):
            ok = agreement(g.numpy(), np.asarray(w), name)
            assert ok >= 0.995, (name, i, ok)
        assert float(torch.nan_to_num(got[1]).abs().max()) > 0
