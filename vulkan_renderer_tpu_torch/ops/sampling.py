"""Polygonal-light sampling for the per-pixel shading path: solid angle
(ours) and projected solid angle (the paper's method).

Counterpart of vulkan_renderer_tpu/ops/sampling.py (reference
polygon_sampling.glsl), batched over a leading pixel axis P. A polygon is
a (P, m, 3) tensor (or an (m, 3) one shared by every pixel) of m vertex
lanes with a static m and, where clipping made it vary, a per-pixel
vertex count. The preparation and sampling arithmetic is the
structure-of-arrays library that K4's plain version runs (ops/soa.py,
ops/soa_techniques.py: the same sector walk, counterclockwise sort by
pseudo-angle, ellipse sampling and Newton steps); the error estimates of
the iterative inversion are written here.

Random numbers are (P, 2) tensors; directions come back as (P, 3).
"""

from __future__ import annotations

import torch

from . import soa
from . import soa_techniques as st
from .clipping import polygon_lanes


def _directions(vertices, shading_position):
    """Normalized directions from the shading position (None: the
    origin) to each lane, as SoA lanes."""
    if shading_position is not None:
        vertices = vertices - shading_position[..., None, :]
    return [soa.vnormalize(v) for v in polygon_lanes(vertices)]


def _count(vertex_count, m: int):
    """None when every lane is active, else a per-pixel int plane."""
    if isinstance(vertex_count, int):
        if vertex_count != m:
            raise ValueError(f"static vertex count {vertex_count} for {m} "
                             "lanes")
        return None
    return vertex_count


# ===========================================================================
# Solid angle sampling (polygon_sampling.glsl:61-224)
# ===========================================================================


class SolidAnglePolygon:
    """A prepared triangle fan: `solid_angle` (P,), and the SoA fan."""

    def __init__(self, fan: st.SaPolySoa, m: int):
        self.fan = fan
        self.m = m
        self.solid_angle = fan.solid_angle


def prepare_solid_angle_polygon_sampling(vertices, vertex_count,
                                         shading_position,
                                         biased: bool = False):
    """Triangle-fan solid angles (glsl:120-175). vertices: (P, m, 3) or
    (m, 3); vertex_count: m (static) or a (P,) int tensor;
    shading_position: (P, 3), or None for the origin."""
    m = vertices.shape[-2]
    dirs = _directions(vertices, shading_position)
    return SolidAnglePolygon(
        st.prepare_sa_soa(dirs, _count(vertex_count, m), m, biased), m)


def sample_solid_angle_polygon(polygon: SolidAnglePolygon, random_numbers):
    """[0, 1]^2 -> a solid-angle-uniform direction (glsl:194-224)."""
    return torch.stack(st.sample_sa_soa(
        polygon.fan, random_numbers[..., 0], random_numbers[..., 1],
        polygon.m), dim=-1)


# ===========================================================================
# Projected solid angle sampling (polygon_sampling.glsl:230-883)
# ===========================================================================


def prepare_projected_solid_angle_polygon_sampling(vertices, vertex_count,
                                                   biased: bool = False):
    """PSA preparation (glsl:521-589): central and decentral sectors,
    the counterclockwise sort and the inner/outer ellipse walk.

    vertices: (P, m, 3), clipped to z >= 0 (the first vertex repeated past
    the count), clockwise as seen from the origin; vertex_count: (P,) int
    (0 = fully clipped, which the caller gates through psa == 0). Returns
    ops/soa.py's PsaPolySoa: .psa is the projected solid angle (P,)."""
    m = vertices.shape[-2]
    return soa.prepare_psa_soa(polygon_lanes(vertices), vertex_count, m,
                               biased)


def sample_projected_solid_angle_polygon(polygon: soa.PsaPolySoa,
                                         random_numbers,
                                         biased: bool = False):
    """A PSA-uniform direction on the upper hemisphere (glsl:749-805)."""
    return torch.stack(soa.sample_psa_soa(
        polygon, random_numbers[..., 0], random_numbers[..., 1], biased),
        dim=-1)


def compute_projected_solid_angle_polygon_sampling_error(
        polygon: soa.PsaPolySoa, random_numbers, sampled_dir):
    """Backward, scaled backward and forward error of the iterative
    inversion (glsl:823-883): (P, 3), zeros in the central case."""
    r0, r1 = random_numbers[..., 0], random_numbers[..., 1]
    target = r0 * polygon.psa
    sel, remaining = soa._select_sector_soa(polygon.sector_psa, target,
                                            polygon.count - 1, polygon.m)
    inner_e = soa._pick_v(sel, polygon.sector_inner)
    outer_e = soa._pick_v(sel, polygon.sector_outer)
    dir_0 = soa._pick_v(sel, polygon.vertices)
    d_xy = (sampled_dir[..., 0], sampled_dir[..., 1])

    sampled_psa = soa.area_between_ellipses_in_sector_soa(
        inner_e, soa.ellipse_rsqrt_det_soa(inner_e),
        outer_e, soa.ellipse_rsqrt_det_soa(outer_e), dir_0, d_xy, False)
    scaled_backward_error = remaining - sampled_psa
    backward_error = scaled_backward_error / polygon.psa

    inner_dir = soa.ellipse_transform_soa(inner_e, d_xy)
    outer_dir = soa.ellipse_transform_soa(outer_e, d_xy)
    inner_factor = 1.0 / soa.vdot(d_xy, inner_dir)
    outer_factor = 1.0 / soa.vdot(d_xy, outer_dir)
    # The constraint matrix's columns as in the GLSL, then transposed.
    half = 0.5 * (inner_factor - outer_factor)
    col0 = soa.vscale(half, soa.rot90(d_xy))
    w_inner = (1.0 - r1) / (inner_factor * inner_factor)
    w_outer = r1 / (outer_factor * outer_factor)
    col1 = soa.vadd(soa.vscale(w_inner, inner_dir),
                    soa.vscale(w_outer, outer_dir))
    rcp_det = 1.0 / (col0[0] * col1[1] - col0[1] * col1[0])
    deriv_x = rcp_det * col1[1]
    deriv_y = rcp_det * -col0[1]
    deriv_z = -(d_xy[0] * deriv_x + d_xy[1] * deriv_y) / sampled_dir[..., 2]
    forward_error = torch.sqrt(deriv_x * deriv_x + deriv_y * deriv_y
                               + deriv_z * deriv_z) * scaled_backward_error
    errors = torch.stack([backward_error, scaled_backward_error,
                          forward_error], dim=-1)
    return torch.where(polygon.central[..., None], 0.0, errors)
