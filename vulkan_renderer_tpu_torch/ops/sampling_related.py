"""The related-work polygon samplers for the per-pixel shading path:
Urena's spherical rectangles, Arvo's solid angle method and Hart et al.'s
bilinear and biquadratic cosine warps.

Counterpart of vulkan_renderer_tpu/ops/sampling_related.py (reference
polygon_sampling_related_work.glsl), batched over pixels like
ops/sampling.py: polygons are (P, m, 3) or (m, 3) tensors, random numbers
(P, 2), directions (P, 3). The arithmetic is ops/soa_techniques.py's,
which K4's plain version runs too.
"""

from __future__ import annotations

import torch

from . import soa_techniques as st
from .sampling import SolidAnglePolygon, _count, _directions


def _vec(v):
    return tuple(v[..., c] for c in range(3))


# ===========================================================================
# Urena spherical rectangles (glsl:121-190)
# ===========================================================================


def prepare_solid_angle_rectangle_sampling_urena(s, exl, eyl, axis_x,
                                                 axis_y, axis_z, o):
    """Urena et al. 2013 (glsl:121-165): s the rectangle's corner (3,),
    exl/eyl its side lengths, axis_* its orthonormal frame (3,) (axis_x
    along the first side), o the shading positions (P, 3). Returns
    ops/soa_techniques.py's UrenaSoa; .solid_angle is (P,)."""
    return st.prepare_urena_soa(_vec(s), exl, eyl, _vec(axis_x),
                                _vec(axis_y), _vec(axis_z), _vec(o))


def sample_solid_angle_rectangle_urena(squad, random_numbers):
    """glsl:167-190: a solid-angle-uniform direction (P, 3)."""
    return torch.stack(st.sample_urena_soa(squad, random_numbers[..., 0],
                                           random_numbers[..., 1]), dim=-1)


# ===========================================================================
# Arvo's solid angle sampling (glsl:205-293)
# ===========================================================================


class SolidAnglePolygonArvo:
    def __init__(self, fan: st.SaArvoSoa, m: int):
        self.fan = fan
        self.m = m
        self.solid_angle = fan.solid_angle


def prepare_solid_angle_polygon_sampling_arvo(vertices, vertex_count,
                                              shading_position):
    """vertices: (P, m, 3) or (m, 3); vertex_count: m or a (P,) int
    tensor; shading_position: (P, 3) or None (the origin)."""
    m = vertices.shape[-2]
    return SolidAnglePolygonArvo(st.prepare_sa_arvo_soa(
        _directions(vertices, shading_position), _count(vertex_count, m),
        m), m)


def sample_solid_angle_polygon_arvo(polygon: SolidAnglePolygonArvo,
                                    random_numbers):
    return torch.stack(st.sample_sa_arvo_soa(
        polygon.fan, random_numbers[..., 0], random_numbers[..., 1],
        polygon.m), dim=-1)


# ===========================================================================
# Hart et al. 2020 cosine warps (glsl:300-500)
# ===========================================================================


class CosineWarpHart:
    """A prepared bilinear or biquadratic warp: .polygon is the solid
    angle fan it warps (a SolidAnglePolygon)."""

    def __init__(self, warp, m: int, biquadratic: bool):
        self.warp = warp
        self.m = m
        self.biquadratic = biquadratic
        self.polygon = SolidAnglePolygon(warp.poly, m)


def prepare_bilinear_cosine_warp_polygon_sampling_hart(vertices,
                                                       vertex_count,
                                                       biased: bool = False):
    """vertices: (P, m, 3) in shading space (about the origin);
    vertex_count: m or a (P,) int tensor (at least 3)."""
    m = vertices.shape[-2]
    return CosineWarpHart(st.prepare_hart_bilinear_soa(
        _directions(vertices, None), _count(vertex_count, m), m, biased),
        m, False)


def sample_bilinear_cosine_warp_polygon_hart(polygon: CosineWarpHart,
                                             random_numbers):
    """(direction (P, 3), density (P,))."""
    d, density = st.sample_hart_bilinear_soa(
        polygon.warp, random_numbers[..., 0], random_numbers[..., 1],
        polygon.m)
    return torch.stack(d, dim=-1), density


def prepare_biquadratic_cosine_warp_polygon_sampling_hart(
        vertices, vertex_count, biased: bool = False):
    m = vertices.shape[-2]
    return CosineWarpHart(st.prepare_hart_biquadratic_soa(
        _directions(vertices, None), _count(vertex_count, m), m, biased),
        m, True)


def sample_biquadratic_cosine_warp_polygon_hart(polygon: CosineWarpHart,
                                                random_numbers):
    """(direction (P, 3), density (P,))."""
    d, density = st.sample_hart_biquadratic_soa(
        polygon.warp, random_numbers[..., 0], random_numbers[..., 1],
        polygon.m)
    return torch.stack(d, dim=-1), density
