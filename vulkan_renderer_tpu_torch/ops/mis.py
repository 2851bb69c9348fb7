"""Multiple importance sampling heuristics for the per-pixel shading path.

Counterpart of vulkan_renderer_tpu/ops/mis.py (reference
shading_pass.frag.glsl:243-293), batched: densities are (P,) tensors,
weights and integrands (P, 3) or anything that broadcasts against them.
The heuristic is a static choice, as the reference's #define dispatch.
"""

from __future__ import annotations

import enum


class MisHeuristic(enum.Enum):
    BALANCE = "balance"
    POWER = "power"
    WEIGHTED = "weighted"
    OPTIMAL_CLAMPED = "optimal_clamped"
    OPTIMAL = "optimal"


def mis_weight_over_density(heuristic: MisHeuristic, sampled_density,
                            other_density):
    """Balance/power MIS weight divided by the sampled density
    (glsl:243-252)."""
    if heuristic == MisHeuristic.BALANCE:
        return 1.0 / (sampled_density + other_density)
    if heuristic == MisHeuristic.POWER:
        return sampled_density / (sampled_density * sampled_density
                                  + other_density * other_density)
    raise ValueError(f"use mis_estimate for {heuristic}")


def mis_estimate(heuristic: MisHeuristic, integrand, sampled_weight,
                 sampled_density, other_weight, other_density,
                 visibility_estimate: float):
    """The full MIS estimator (glsl:270-293). integrand: (P, 3) including
    visibility; weights (P, 3); densities (P,)."""
    sd = sampled_density[..., None]
    od = other_density[..., None]
    if heuristic == MisHeuristic.WEIGHTED:
        weighted_sum = sampled_weight * sd + other_weight * od
        return (sampled_weight * integrand) / weighted_sum
    if heuristic in (MisHeuristic.OPTIMAL_CLAMPED, MisHeuristic.OPTIMAL):
        balance = 1.0 / (sd + od)
        weighted_sum = sampled_weight * sd + other_weight * od
        if heuristic == MisHeuristic.OPTIMAL_CLAMPED:
            weighted_wod = sampled_weight / weighted_sum
            mixed = -visibility_estimate * balance + balance
            mixed = visibility_estimate * weighted_wod + mixed
            return mixed * integrand
        # OPTIMAL: unbiased, possibly negative.
        return visibility_estimate * sampled_weight \
            + balance * (integrand - visibility_estimate * weighted_sum)
    wod = mis_weight_over_density(heuristic, sampled_density, other_density)
    return wod[..., None] * integrand
