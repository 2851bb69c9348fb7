"""Parity of the port's DIFFUSE_ONLY shading (render/fused.py plain version
of K4, ops/soa_techniques.py, ops/soa_arvo_psa.py) with the JAX package's
plain-XLA fused_light_shading_xla, for all 13 sampling techniques, on the
same seeded shading data, LTC coefficients, noise table and light records
(the JAX package reads the table as get_noise_image, the port as K4's
FrameNoise).

Tolerance: the two run the same float32 operations in the same order, but
XLA may fuse multiply-adds and its rsqrt/cos/sin/exp differ from torch's by
an ulp, which can move a sample across a fan-triangle or sector boundary.
So >= 99.5% of the output values agree within 1e-4 of their array's scale
(+1e-3 relative), and the finite pattern is identical. base and b are
held to the reference at every pixel; directions and t_max where the
pixel hit something, and to the dead slot (direction 0, t_max -1) where it
did not: the port does not shade a miss pixel, whose b the reference
gates to 0. The Arvo techniques
select sectors by azimuth and Newton-solve inside them, so a boundary
sample flips more often: >= 99% for them (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

from _torch_shading_inputs import (agreement, jax_reference, light_specs,
                                   noise_inputs, port_inputs, shading_inputs,
                                   to_port)
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu_torch.ops import soa as t_soa
from vulkan_renderer_tpu_torch.render import fused

Tech = PolygonSamplingTechnique
ARVO = (Tech.SOLID_ANGLE_ARVO, Tech.PROJECTED_SOLID_ANGLE_ARVO)


@pytest.fixture(scope="module")
def inputs():
    return shading_inputs()


@pytest.mark.parametrize("tech", list(Tech), ids=lambda t: t.value)
def test_diffuse_only_plain_matches_reference(inputs, tech):
    data, ltc, hit = inputs
    # Urena samples the light's rectangle: rectangles only, as the GUI
    # allows; every other technique gets vertex counts 3, 4, 5 and 7 (the
    # largest a light may have, lights.py MAX_POLYGONAL_LIGHT_VERTEX_COUNT).
    counts = (4, 4) if tech == Tech.RECTANGLE_SOLID_ANGLE_URENA \
        else (3, 4, 5, 7)
    specs = light_specs(counts)
    settings = RenderSettings(sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                              polygon_sampling_technique=tech,
                              sample_count=2)
    jax_noise, noise = noise_inputs(settings, len(specs))
    want = jax_reference(data, ltc, hit, jax_noise, specs, settings)
    want[2][~hit], want[3][~hit] = 0.0, -1.0
    planes, light_scalars, static = port_inputs(data, ltc, hit, specs)
    out = fused.fused_light_shading(planes, noise, light_scalars, static,
                                    to_port(settings))
    slots = static.light_count * fused.rays_per_light(to_port(settings))
    got = [g.numpy() for g in fused.unpack_outputs(out, slots)]
    need = 0.99 if tech in ARVO else 0.995
    for name, g, w in zip(("base", "b", "dirs", "t_max"), got, want):
        assert agreement(g, w, name) >= need, (name, agreement(g, w, name))
    assert np.abs(got[1]).max() > 0  # the lights did contribute
    assert not got[0].any()  # DIFFUSE_ONLY has no base term


def test_atan2_and_acos_match_numpy():
    """The Cephes-based atan2/acos of the port (every azimuth of Arvo and
    the cubic solver) against float64 numpy, on axes and signed zeros."""
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.normal(size=200), [0.0, -0.0, 1.0, -1.0, 0.0,
                                               -0.0]]).astype(np.float32)
    x = np.concatenate([rng.normal(size=200), [1.0, -1.0, 0.0, 0.0, -1.0,
                                               1.0]]).astype(np.float32)
    got = t_soa.atan2_soa(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=1e-6)
    c = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_allclose(t_soa.acos_soa(torch.from_numpy(c)).numpy(),
                               np.arccos(c.astype(np.float64)), atol=2e-6)
