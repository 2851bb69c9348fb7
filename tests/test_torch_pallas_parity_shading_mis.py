"""K4's plain version against the JAX Pallas K4 in interpret mode under
DIFFUSE_SPECULAR_MIS: PSA, clamped-optimal MIS, 1 spp (the bench frame's
settings), on test_torch_fused.py's inputs, at the tolerance that
test_torch_pallas_parity_shading.py states. A file of its own: the
interpreted kernel takes about a minute to trace and compile on the CPU."""

from test_torch_fused import inputs  # noqa: F401 (fixture)
from test_torch_pallas_parity_shading import check_pallas_interpret
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               SamplingStrategy)


def test_fused_plain_matches_pallas_interpret_mis(inputs):
    check_pallas_interpret(
        inputs, SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE, 1)
