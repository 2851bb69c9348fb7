"""Arvo's projected solid angle sampling (the related-work baseline) for
the per-pixel shading path.

Counterpart of vulkan_renderer_tpu/ops/sampling_arvo_psa.py (reference
polygon_sampling_related_work.glsl:509-1048; Arvo 2001), batched over
pixels: preparation and sampling are ops/soa_arvo_psa.py's (which K4's
plain version runs), the error estimate is written here.
"""

from __future__ import annotations

import torch

from . import soa_arvo_psa as arvo
from .clipping import polygon_lanes
from .math_utils import M_PI


def prepare_projected_solid_angle_polygon_sampling_arvo(vertices,
                                                        vertex_count):
    """glsl:743-820. vertices: (P, m, 3) clipped to z >= 0 (the first
    vertex repeated past the count); vertex_count: (P,) int. Returns
    ops/soa_arvo_psa.py's ArvoPsaSoa: .psa is the projected solid angle."""
    return arvo.prepare_arvo_psa_soa(polygon_lanes(vertices), vertex_count,
                                     vertices.shape[-2])


def sample_projected_solid_angle_polygon_arvo(polygon: arvo.ArvoPsaSoa,
                                              random_numbers,
                                              iteration_count: int = 3):
    """glsl:931-992: a direction (P, 3)."""
    return torch.stack(arvo.sample_arvo_psa_soa(
        polygon, random_numbers[..., 0], random_numbers[..., 1],
        iteration_count), dim=-1)


def compute_projected_solid_angle_polygon_sampling_error_arvo(
        polygon: arvo.ArvoPsaSoa, random_numbers, sampled_dir):
    """glsl:998-1048: (backward error, scaled backward error) as (P, 2),
    zeros in the central case."""
    target = random_numbers[..., 0] * polygon.psa
    sel, remaining = arvo._select_sector(polygon.sector_psa, target,
                                         polygon.count - 1, polygon.m)
    zero = torch.zeros_like(target)
    azimuth_0 = arvo._pick(sel, polygon.azimuths, zero)
    sampled_az = torch.atan2(sampled_dir[..., 1], sampled_dir[..., 0])
    # Bring the sampled azimuth into the sector's wrapped frame.
    sampled_az = torch.where(sampled_az < azimuth_0 - M_PI,
                             sampled_az + 2.0 * M_PI, sampled_az)
    sampled_az = torch.where(sampled_az > azimuth_0 + M_PI,
                             sampled_az - 2.0 * M_PI, sampled_az)
    psa = zero
    for edges in (polygon.sector_outer, polygon.sector_inner):
        cdf = arvo._pick(sel, [e[0] for e in edges], zero)
        length = arvo._pick2(sel, [e[1] for e in edges], zero)
        az = arvo._pick(sel, [e[3] for e in edges], zero)
        edge_psa, _ = arvo._edge_psa_and_derivative(
            cdf, length, azimuth_0 - az, sampled_az - az)
        psa = psa + edge_psa
    scaled = remaining - psa
    errors = torch.stack([scaled / polygon.psa, scaled], dim=-1)
    return torch.where(polygon.central[..., None], 0.0, errors)
