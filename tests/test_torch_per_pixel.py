"""The port's per-pixel polygonal-light shading (render/shading.py
evaluate_polygonal_light_shading) against the JAX package's, vmapped over
pixels, under DIFFUSE_ONLY for all 13 techniques (the other strategies:
test_torch_per_pixel_strategies.py), on the same seeded shading data,
LTC coefficients, lights and UNORM16-quantized noise pairs.

Tolerance: for each output (base, b, ray directions, t_max) the finite
pattern matches exactly and >= 99.5% of finite values agree within 1e-4
of the array's largest magnitude + 1e-3 relative (_torch_shading_inputs.
agreement). The port's samplers run the structure-of-arrays formulation
of K4's plain version (rsqrt-based normalization, one-hot lane selection)
and XLA contracts multiply-adds into FMAs, so a sample near a sector
boundary or an ill-conditioned ellipse may land elsewhere. Arvo's PSA
sampler is held at 98%, a value finite in one package only counting as a
disagreement: its sector choice, its z > 1e-5 horizon gate and its
degenerate (NaN) Newton steps flip for about 1.5% of these samples
between the two formulations (ROADMAP Queue 3)."""

import pytest

from _torch_shading_inputs import compare_light_shading, light_specs
from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)

Tech = PolygonSamplingTechnique
Strategy = SamplingStrategy
VERTEX_COUNTS = (4, 6)
ARVO_PSA_THRESHOLD = 0.98


def tolerance(settings) -> dict:
    """compare_light_shading's threshold and finite-pattern rule."""
    if settings.polygon_sampling_technique \
            == Tech.PROJECTED_SOLID_ANGLE_ARVO:
        return dict(threshold=ARVO_PSA_THRESHOLD, exact_finite_pattern=False)
    return dict(threshold=0.995)


def legal_cases(strategies):
    """Every GUI-legal (strategy, technique) pair of `strategies`; GGX MIS
    alternates balance and power, DIFFUSE_SPECULAR_MIS takes every
    heuristic with PSA and optimal clamped with PSA-biased."""
    cases = []
    for strategy in strategies:
        for index, tech in enumerate(Tech):
            if strategy == Strategy.DIFFUSE_SPECULAR_MIS:
                heuristics = list(MisHeuristic) \
                    if tech == Tech.PROJECTED_SOLID_ANGLE \
                    else [MisHeuristic.OPTIMAL_CLAMPED]
            elif strategy == Strategy.DIFFUSE_GGX_MIS:
                heuristics = [(MisHeuristic.BALANCE,
                               MisHeuristic.POWER)[index % 2]]
            else:
                heuristics = [MisHeuristic.OPTIMAL_CLAMPED]
            for heuristic in heuristics:
                try:
                    settings = RenderSettings(
                        sampling_strategy=strategy,
                        polygon_sampling_technique=tech,
                        mis_heuristic=heuristic)
                except ValueError:  # settings_violations: not GUI-legal
                    continue
                cases.append(pytest.param(settings, id=(
                    f"{strategy.value}-{tech.value}-{heuristic.value}")))
    return cases


CASES = legal_cases([Strategy.DIFFUSE_ONLY])


@pytest.mark.parametrize("settings", CASES)
def test_light_shading_matches_reference(settings):
    results = compare_light_shading(settings, light_specs(VERTEX_COUNTS),
                                    seed=23, **tolerance(settings))
    # The shading did contribute.
    assert max(float(r.b.abs().max()) + float(r.base.abs().max())
               for r in results) > 0


def test_case_lists_cover_every_legal_pair():
    """13 DIFFUSE_ONLY techniques here; 7 GGX MIS techniques (the others
    have no sampling-independent density), the PSA pair under the three
    combined strategies, every MIS heuristic, in the strategies file."""
    all_cases = legal_cases(list(Strategy))
    pairs = {(c.values[0].sampling_strategy,
              c.values[0].polygon_sampling_technique) for c in all_cases}
    assert len(pairs) == 13 + 7 + 2 + 2 + 2
    assert len(CASES) == 13
    heuristics = {c.values[0].mis_heuristic for c in all_cases
                  if c.values[0].sampling_strategy
                  in (Strategy.DIFFUSE_SPECULAR_MIS,
                      Strategy.DIFFUSE_GGX_MIS)}
    assert heuristics == set(MisHeuristic)
