"""Render settings: the specialization axis of a frame.

The port's own copy of vulkan_renderer_tpu/core/settings.py (same field
names, enum members and values, and legality rules). The reference turns
every setting into one of 39 shader #defines and recompiles
(main.c:724-801); here a distinct RenderSettings value selects a kernel
library (render/fused.py kernel_defines).

The JAX package's RenderSettings is another class: its enum members
compare unequal to these, so the port's entry points refuse it
(render/fused.py check_supported) instead of taking a wrong branch.

Enums mirror main.h:45-118 and polygonal_light.h:30-69.
"""

from __future__ import annotations

import dataclasses
import enum


class SamplingStrategy(enum.Enum):
    """main.h:45-67."""
    DIFFUSE_ONLY = "diffuse_only"
    DIFFUSE_GGX_MIS = "diffuse_ggx_mis"
    DIFFUSE_SPECULAR_SEPARATELY = "diffuse_specular_separately"
    DIFFUSE_SPECULAR_MIS = "diffuse_specular_mis"
    DIFFUSE_SPECULAR_RANDOM = "diffuse_specular_random"


class MisHeuristic(enum.Enum):
    """main.h:71-89."""
    BALANCE = "balance"
    POWER = "power"
    WEIGHTED = "weighted"
    OPTIMAL_CLAMPED = "optimal_clamped"
    OPTIMAL = "optimal"


class PolygonSamplingTechnique(enum.Enum):
    """polygonal_light.h:30-69 — all 13 techniques of the paper."""
    BASELINE = "baseline"
    AREA_TURK = "area_turk"
    RECTANGLE_SOLID_ANGLE_URENA = "rectangle_solid_angle_urena"
    SOLID_ANGLE_ARVO = "solid_angle_arvo"
    SOLID_ANGLE = "solid_angle"
    CLIPPED_SOLID_ANGLE = "clipped_solid_angle"
    BILINEAR_COSINE_WARP_HART = "bilinear_cosine_warp_hart"
    BILINEAR_COSINE_WARP_CLIPPING_HART = "bilinear_cosine_warp_clipping_hart"
    BIQUADRATIC_COSINE_WARP_HART = "biquadratic_cosine_warp_hart"
    BIQUADRATIC_COSINE_WARP_CLIPPING_HART = \
        "biquadratic_cosine_warp_clipping_hart"
    PROJECTED_SOLID_ANGLE_ARVO = "projected_solid_angle_arvo"
    PROJECTED_SOLID_ANGLE = "projected_solid_angle"
    PROJECTED_SOLID_ANGLE_BIASED = "projected_solid_angle_biased"


class ErrorDisplay(enum.Enum):
    """main.h:93-118."""
    NONE = "none"
    DIFFUSE_BACKWARD = "diffuse_backward"
    DIFFUSE_BACKWARD_SCALED = "diffuse_backward_scaled"
    DIFFUSE_FORWARD = "diffuse_forward"
    SPECULAR_BACKWARD = "specular_backward"
    SPECULAR_BACKWARD_SCALED = "specular_backward_scaled"
    SPECULAR_FORWARD = "specular_forward"


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """render_settings_t (main.h:127-159); defaults match main.c:232-249."""
    exposure_factor: float = 1.0
    roughness_factor: float = 1.0
    sample_count: int = 1
    sampling_strategy: SamplingStrategy = \
        SamplingStrategy.DIFFUSE_SPECULAR_MIS
    mis_heuristic: MisHeuristic = MisHeuristic.OPTIMAL_CLAMPED
    mis_visibility_estimate: float = 0.5
    polygon_sampling_technique: PolygonSamplingTechnique = \
        PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE
    error_display: ErrorDisplay = ErrorDisplay.NONE
    error_min_exponent: float = -7.0
    noise_type: str = "ahmed_2d"
    animate_noise: bool = True
    trace_shadow_rays: bool = False
    show_polygonal_lights: bool = True
    # Output conversion (reference: OUTPUT_LINEAR_RGB define).
    output_linear_rgb: bool = False
    # frame_bits for 2-frame HDR capture: 0 = color, 1 = low, 2 = high.
    frame_bits: int = 0
    # Linear (segment) light sampling technique (HPG 2021 companion):
    # uniform | distance | projected_ris.
    linear_technique: str = "projected_ris"

    def __post_init__(self):
        violations = settings_violations(self)
        if violations:
            raise ValueError(
                "illegal RenderSettings combination (the reference GUI "
                "masks these choices, user_interface.cpp:88-199):\n- "
                + "\n- ".join(violations))


# Techniques that cannot report a density independent of sampling, so MIS
# against GGX sampling is impossible (user_interface.cpp:131-140).
GGX_MIS_DENYLIST = frozenset({
    PolygonSamplingTechnique.BASELINE,
    PolygonSamplingTechnique.AREA_TURK,
    PolygonSamplingTechnique.BILINEAR_COSINE_WARP_HART,
    PolygonSamplingTechnique.BILINEAR_COSINE_WARP_CLIPPING_HART,
    PolygonSamplingTechnique.BIQUADRATIC_COSINE_WARP_HART,
    PolygonSamplingTechnique.BIQUADRATIC_COSINE_WARP_CLIPPING_HART,
})

_PSA_OURS = (PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE,
             PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_BIASED)
_SPECULAR_STRATEGIES = (SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY,
                        SamplingStrategy.DIFFUSE_SPECULAR_MIS,
                        SamplingStrategy.DIFFUSE_SPECULAR_RANDOM)
_OUR_HEURISTICS = (MisHeuristic.WEIGHTED, MisHeuristic.OPTIMAL_CLAMPED,
                   MisHeuristic.OPTIMAL)
_PSA_ERROR_TECHNIQUES = _PSA_OURS + (
    PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO,)


def settings_violations(s: RenderSettings) -> list:
    """The legality rules the reference GUI enforces by masking choices
    (user_interface.cpp:88-199), as a validator. Empty list = legal."""
    v = []
    tech = s.polygon_sampling_technique
    strat = s.sampling_strategy
    if strat in _SPECULAR_STRATEGIES and tech not in _PSA_OURS:
        v.append(
            f"specular sampling strategy {strat.value} requires projected "
            f"solid angle sampling (ours/biased), got {tech.value} "
            "(user_interface.cpp:165-177)")
    if strat == SamplingStrategy.DIFFUSE_GGX_MIS \
            and tech in GGX_MIS_DENYLIST:
        v.append(
            f"MIS with GGX sampling needs a sampling-independent density; "
            f"{tech.value} has none (user_interface.cpp:131-140)")
    if s.mis_heuristic in _OUR_HEURISTICS and strat in (
            SamplingStrategy.DIFFUSE_GGX_MIS,
            SamplingStrategy.DIFFUSE_SPECULAR_MIS):
        if strat != SamplingStrategy.DIFFUSE_SPECULAR_MIS \
                or tech not in _PSA_OURS:
            v.append(
                f"MIS heuristic {s.mis_heuristic.value} requires "
                "diffuse_specular_mis with projected solid angle sampling "
                "(ours/biased) (user_interface.cpp:88-104,180-184)")
    if s.error_display != ErrorDisplay.NONE:
        if tech not in _PSA_ERROR_TECHNIQUES \
                or strat == SamplingStrategy.DIFFUSE_GGX_MIS:
            v.append(
                "error display needs a projected-solid-angle technique and "
                "a non-GGX strategy (user_interface.cpp:186-199)")
        elif s.error_display in (ErrorDisplay.SPECULAR_BACKWARD,
                                 ErrorDisplay.SPECULAR_BACKWARD_SCALED,
                                 ErrorDisplay.SPECULAR_FORWARD) \
                and strat == SamplingStrategy.DIFFUSE_ONLY:
            v.append(
                "specular error display requires a specular sampling "
                "strategy (user_interface.cpp:195-196)")
        elif tech == PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO \
                and s.error_display not in (
                    ErrorDisplay.DIFFUSE_BACKWARD,
                    ErrorDisplay.DIFFUSE_BACKWARD_SCALED):
            v.append(
                "Arvo PSA exposes only diffuse backward errors "
                "(user_interface.cpp:197)")
    return v
