"""The port's per-pixel polygonal-light shading against the JAX
package's under the strategies other than DIFFUSE_ONLY: DIFFUSE_GGX_MIS
for its 7 techniques (balance and power), and the PSA pair under
DIFFUSE_SPECULAR_SEPARATELY, DIFFUSE_SPECULAR_MIS (every heuristic) and
DIFFUSE_SPECULAR_RANDOM. Each strategy reads its noise pairs in its own
order (separately and MIS: pairs 2 i and 2 i + 1 for sample i; GGX MIS:
n pairs for the technique, then n for the GGX loop), which only a
pixel-wise comparison checks. Inputs and tolerance as in
test_torch_per_pixel.py."""

import pytest

from _torch_shading_inputs import compare_light_shading, light_specs
from test_torch_per_pixel import (VERTEX_COUNTS, Strategy, legal_cases,
                                  tolerance)

CASES = legal_cases([Strategy.DIFFUSE_GGX_MIS,
                     Strategy.DIFFUSE_SPECULAR_SEPARATELY,
                     Strategy.DIFFUSE_SPECULAR_MIS,
                     Strategy.DIFFUSE_SPECULAR_RANDOM])


@pytest.mark.parametrize("settings", CASES)
def test_light_shading_matches_reference(settings):
    results = compare_light_shading(settings, light_specs(VERTEX_COUNTS),
                                    seed=29, **tolerance(settings))
    assert max(float(r.b.abs().max()) for r in results) > 0


@pytest.mark.parametrize("sample_count", [2])
def test_two_samples_read_their_own_pairs(sample_count):
    """Two samples under each pair-order family: the separately/MIS
    (2 i, 2 i + 1) order and GGX MIS's technique-then-GGX order."""
    from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                                   PolygonSamplingTechnique,
                                                   RenderSettings)
    for strategy, tech, heuristic in (
            (Strategy.DIFFUSE_SPECULAR_MIS,
             PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE,
             MisHeuristic.OPTIMAL_CLAMPED),
            (Strategy.DIFFUSE_GGX_MIS, PolygonSamplingTechnique.SOLID_ANGLE,
             MisHeuristic.POWER)):
        settings = RenderSettings(sampling_strategy=strategy,
                                  polygon_sampling_technique=tech,
                                  mis_heuristic=heuristic,
                                  sample_count=sample_count)
        compare_light_shading(settings, light_specs(VERTEX_COUNTS[:1]),
                              seed=31, threshold=0.995)
