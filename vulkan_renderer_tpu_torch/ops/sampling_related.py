"""The related-work polygon samplers for the per-pixel shading path:
Urena's spherical rectangles, Arvo's solid angle method and Hart et al.'s
bilinear and biquadratic cosine warps.

Counterpart of vulkan_renderer_tpu/ops/sampling_related.py (reference
polygon_sampling_related_work.glsl) as the JAX package writes it, batched
over pixels like ops/sampling.py: polygons are (P, m, 3) or (m, 3)
tensors, random numbers (P, 2), directions (P, 3). The JAX package's
cos, sin and cumsum are torch's, its positive_atan is
math_utils.positive_atan, and its arccos is written as XLA expands it
(chlo.acos: atan2(sqrt((1 - x)(1 + x)), x)), which rounds unlike
torch.acos where Urena's solid angle cancels (g0 + g1 + g2 + g3 - 2 pi
for a small, distant rectangle). K4's plain version keeps its own
structure-of-arrays copies (ops/soa_techniques.py).

Precision: the float type is the inputs'; the fixed clamps keep their
float32 values (1e-20). A float64 run takes the same branches except at
a fan boundary (target against a cumulative solid angle), where Urena's
cu or hv lands within rounding of its clamp, and where the cubic's
discriminant or a root lies within rounding of 0 or 1 (Hart's
biquadratic warp).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .cubic import solve_cubic
from .math_utils import (cross, dot, first_true_lane, mix_fma, normalize,
                         pick_lane, positive_atan)
from .sampling import (SolidAnglePolygon, prepare_solid_angle_polygon_sampling,
                       sample_solid_angle_polygon, vertex_counts)

_CLAMP_FLOOR = float(np.float32(1e-20))


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), NaN propagating."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ===========================================================================
# Urena spherical rectangles (glsl:121-190)
# ===========================================================================


class SolidAngleRectangleUrena(NamedTuple):
    o: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    z0: torch.Tensor
    z0sq: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor
    y0sq: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    y1sq: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    b0sq: torch.Tensor
    k: torch.Tensor
    solid_angle: torch.Tensor


def _acos(x):
    return torch.atan2(torch.sqrt((1.0 - x) * (1.0 + x)), x)


def _angle(n_a, n_b):
    return _acos(torch.clamp(-dot(n_a, n_b), -1.0, 1.0))


def prepare_solid_angle_rectangle_sampling_urena(s, exl, eyl, axis_x,
                                                 axis_y, axis_z, o):
    """Urena et al. 2013 spherical-rectangle setup (glsl:121-165): s the
    rectangle's corner (3,), exl/eyl its side lengths, axis_* its
    orthonormal frame (3,) (axis_x along the first side), o the shading
    positions (P, 3). Fields are (P,) planes, z (P, 3)."""
    d = s - o
    z0_raw = dot(d, axis_z)
    z = torch.where((z0_raw > 0)[:, None], -axis_z, axis_z)
    z0 = -torch.abs(z0_raw)
    x0 = dot(d, axis_x)
    y0 = dot(d, axis_y)
    x1 = x0 + exl
    y1 = y0 + eyl

    v00 = torch.stack([x0, y0, z0], dim=-1)
    v01 = torch.stack([x0, y1, z0], dim=-1)
    v10 = torch.stack([x1, y0, z0], dim=-1)
    v11 = torch.stack([x1, y1, z0], dim=-1)
    n0 = normalize(cross(v00, v10))
    n1 = normalize(cross(v10, v11))
    n2 = normalize(cross(v11, v01))
    n3 = normalize(cross(v01, v00))
    g0, g1 = _angle(n0, n1), _angle(n1, n2)
    g2, g3 = _angle(n2, n3), _angle(n3, n0)
    b0 = n0[:, 2]
    b1 = n2[:, 2]
    k = 2.0 * math.pi - g2 - g3
    return SolidAngleRectangleUrena(
        o=o, x=axis_x, y=axis_y, z=z, z0=z0, z0sq=z0 * z0, x0=x0, y0=y0,
        y0sq=y0 * y0, x1=x1, y1=y1, y1sq=y1 * y1, b0=b0, b1=b1,
        b0sq=b0 * b0, k=k, solid_angle=g0 + g1 - k)


def sample_solid_angle_rectangle_urena(squad: SolidAngleRectangleUrena,
                                       random_numbers):
    """Area-preserving rectangle parametrization (glsl:172-192)."""
    u, v = random_numbers[:, 0], random_numbers[:, 1]
    au = u * squad.solid_angle + squad.k
    fu = (torch.cos(au) * squad.b0 - squad.b1) / torch.sin(au)
    cu = 1.0 / torch.sqrt(fu * fu + squad.b0sq)
    cu = torch.where(fu > 0.0, cu, -cu)
    cu = torch.clamp(cu, -1.0, 1.0)
    xu = -(cu * squad.z0) / torch.sqrt(torch.clamp(1.0 - cu * cu,
                                                   min=_CLAMP_FLOOR))
    xu = _clip(xu, squad.x0, squad.x1)
    d = torch.sqrt(xu * xu + squad.z0sq)
    h0 = squad.y0 / torch.sqrt(d * d + squad.y0sq)
    h1 = squad.y1 / torch.sqrt(d * d + squad.y1sq)
    hv = h0 + v * (h1 - h0)
    mhv2_1 = -hv * hv + 1.0
    yv = torch.where(mhv2_1 >= 0.0,
                     (hv * d) / torch.sqrt(torch.clamp(mhv2_1,
                                                       min=_CLAMP_FLOOR)),
                     squad.y1)
    return normalize(xu[:, None] * squad.x + yv[:, None] * squad.y
                     + squad.z0[:, None] * squad.z)


# ===========================================================================
# Arvo spherical triangle fans (solid angle; glsl:205-293)
# ===========================================================================


class SolidAnglePolygonArvo(NamedTuple):
    vertex_count: torch.Tensor      # (P,) int32
    vertex_dirs: torch.Tensor       # (P, m, 3)
    fan_solid_angles: torch.Tensor  # (P, m - 2)
    opposite_dirs: torch.Tensor     # (P, m - 2, 2) cos/sin of edge angle
    solid_angle: torch.Tensor       # (P,)


def prepare_solid_angle_polygon_sampling_arvo(vertices, vertex_count,
                                              shading_position):
    """Arvo 1995 stratified spherical-triangle setup (glsl:219-257).
    vertices: (P, m, 3) or (m, 3); vertex_count: m or a (P,) int tensor;
    shading_position: (P, 3) or None (the origin)."""
    if shading_position is not None:
        vertices = vertices - shading_position[:, None, :]
    dirs = normalize(vertices)
    if dirs.dim() == 2:
        dirs = dirs[None]
    m = dirs.shape[1]
    count = vertex_counts(vertex_count, dirs.shape[0], dirs.device)
    if dirs.shape[0] != count.shape[0]:
        dirs = dirs.expand(count.shape[0], -1, -1)
    v0 = dirs[:, :1]
    v1 = dirs[:, 1:m - 1]
    v2 = dirs[:, 2:m]
    edge_n0 = normalize(cross(v1 - v0, v0.expand_as(v1)))
    edge_n1 = normalize(cross(v2 - v1, v1))
    cos_op = -dot(edge_n0, edge_n1)
    sin_op = torch.sqrt(torch.clamp(-cos_op * cos_op + 1.0, min=0.0))
    opposite = torch.stack([cos_op, sin_op], dim=-1)

    dot_0_1 = dot(v0, v1)
    dot_0_2 = dot(v0, v2)
    dot_1_2 = dot(v1, v2)
    simplex = dot(v0, cross(v1, v2))
    tangent = torch.abs(simplex) / (1.0 + dot_0_1 + dot_0_2 + dot_1_2)
    tri_sa = 2.0 * positive_atan(tangent)
    tri = torch.arange(m - 2, dtype=torch.int32, device=dirs.device)
    tri_active = tri[None] + 2 < torch.clamp(count, min=3)[:, None]
    tri_sa = torch.where(tri_active, tri_sa, 0.0)
    fan = torch.cumsum(tri_sa, dim=1)
    return SolidAnglePolygonArvo(count, dirs, fan, opposite, fan[:, -1])


def sample_solid_angle_polygon_arvo(polygon: SolidAnglePolygonArvo,
                                    random_numbers):
    """Arvo 1995 sampling (glsl:262-293)."""
    r0, r1 = random_numbers[:, 0], random_numbers[:, 1]
    target = polygon.solid_angle * r0
    count = polygon.vertex_count
    tri = torch.arange(polygon.fan_solid_angles.shape[1], dtype=torch.int32,
                       device=r0.device)
    valid = tri[None] + 2 < torch.clamp(count, min=3)[:, None]
    reached = (polygon.fan_solid_angles >= target[:, None]) & valid
    sel = first_true_lane(reached, torch.clamp(count - 3, min=0))
    sub_sa = target - pick_lane(polygon.fan_solid_angles, sel - 1)
    opposite = pick_lane(polygon.opposite_dirs, sel)
    op0, op1 = opposite[:, 0], opposite[:, 1]
    tv0 = pick_lane(polygon.vertex_dirs, sel + 1)
    tv1 = polygon.vertex_dirs[:, 0]
    tv2 = pick_lane(polygon.vertex_dirs, sel + 2)

    ssa_cos = torch.cos(sub_sa)
    ssa_sin = torch.sin(sub_sa)
    p = ssa_sin * op0 - ssa_cos * op1
    q = ssa_sin * op1 + ssa_cos * op0
    u = q - op0
    v = p + op1 * dot(tv0, tv1)
    s = ((v * q - u * p) * op0 - v) / ((v * p + u * q) * op1)
    edge_tan_20 = normalize(tv2 - dot(tv0, tv2)[:, None] * tv0)
    vertex_2 = s[:, None] * tv0 + torch.sqrt(
        torch.clamp(-s * s + 1.0, 0.0, 1.0))[:, None] * edge_tan_20
    z = 1.0 - r1 * (1.0 - dot(vertex_2, tv1))
    edge_tan_21 = normalize(vertex_2 - dot(tv1, vertex_2)[:, None] * tv1)
    return z[:, None] * tv1 + torch.sqrt(
        torch.clamp(-z * z + 1.0, 0.0, 1.0))[:, None] * edge_tan_21


# ===========================================================================
# Hart et al. 2020 cosine warps in primary sample space (glsl:300-504)
# ===========================================================================


class BilinearCosineWarpHart(NamedTuple):
    polygon: SolidAnglePolygon
    density_0: torch.Tensor  # (P,)
    density_1: torch.Tensor  # (P, 2)


def _last_vertex(dirs, vertex_count):
    """The last active vertex (P, 3) (the GLSL's register-spill loop)."""
    return pick_lane(dirs, torch.clamp(vertex_count - 1, 2,
                                       dirs.shape[1] - 1))


def _normalized(density_sum, factor, solid_angle, densities):
    """Densities scaled to integrate to 1 over the solid angle, or the
    uniform density where they sum to <= 0."""
    normalization = factor / (solid_angle * density_sum)
    inv_sa = 1.0 / solid_angle
    degenerate = density_sum <= 0.0
    out = []
    for d in densities:
        shape = (-1,) + (1,) * (d.dim() - 1)
        out.append(torch.where(degenerate.view(shape), inv_sa.view(shape),
                               d * normalization.view(shape)))
    return out


def prepare_bilinear_cosine_warp_polygon_sampling_hart(vertices, vertex_count,
                                                       biased: bool = False):
    """Bilinear cosine approximation warp setup (glsl:316-344). vertices:
    (P, m, 3) in shading space (about the origin); vertex_count: m or a
    (P,) int tensor (at least 3)."""
    polygon = prepare_solid_angle_polygon_sampling(vertices, vertex_count,
                                                   None, biased)
    dirs = polygon.vertex_dirs
    density_0 = torch.clamp(dirs[:, 0, 2], min=0.0)
    density_1 = torch.clamp(torch.stack(
        [dirs[:, 1, 2], _last_vertex(dirs, polygon.vertex_count)[:, 2]],
        dim=-1), min=0.0)
    density_sum = 2.0 * density_0 + density_1[:, 0] + density_1[:, 1]
    density_0, density_1 = _normalized(density_sum, 4.0, polygon.solid_angle,
                                       (density_0, density_1))
    return BilinearCosineWarpHart(polygon, density_0, density_1)


def linear_warp(random_number, density_0, density_1):
    """Muller's-method linear warp (glsl:350-364)."""
    lerped_sq = mix_fma(density_0 * density_0, density_1 * density_1,
                        random_number)
    divisor = density_0 + torch.sqrt(torch.clamp(lerped_sq, min=0.0))
    return random_number * (density_0 + density_1) \
        / torch.where(divisor != 0.0, divisor, 1.0)


def sample_bilinear_cosine_warp_polygon_hart(polygon: BilinearCosineWarpHart,
                                             random_numbers):
    """(direction (P, 3), density (P,)) (glsl:375-383)."""
    d0, d1 = polygon.density_0, polygon.density_1
    r1 = linear_warp(random_numbers[:, 1], 2.0 * d0, d1[:, 0] + d1[:, 1])
    density_0 = mix_fma(d0, d1[:, 0], r1)
    density_1 = mix_fma(d0, d1[:, 1], r1)
    r0 = linear_warp(random_numbers[:, 0], density_0, density_1)
    density = mix_fma(density_0, density_1, r0)
    direction = sample_solid_angle_polygon(polygon.polygon,
                                           torch.stack([r0, r1], dim=-1))
    return direction, density


class BiquadraticCosineWarpHart(NamedTuple):
    polygon: SolidAnglePolygon
    density_0: torch.Tensor  # (P,)
    density_1: torch.Tensor  # (P, 3)
    density_2: torch.Tensor  # (P, 3)


def _sum3(x):
    return x[:, 0] + x[:, 1] + x[:, 2]


def prepare_biquadratic_cosine_warp_polygon_sampling_hart(
        vertices, vertex_count, biased: bool = False):
    """Biquadratic cosine approximation warp setup (glsl:405-455)."""
    polygon = prepare_solid_angle_polygon_sampling(vertices, vertex_count,
                                                   None, biased)
    dirs = polygon.vertex_dirs
    last_vertex = _last_vertex(dirs, polygon.vertex_count)
    vertex_0 = dirs[:, 0]
    density_0 = torch.clamp(vertex_0[:, 2], min=0.0)
    half_one = torch.stack([torch.full_like(density_0, 0.5),
                            torch.ones_like(density_0)], dim=-1)
    sample_2_1 = sample_solid_angle_polygon(polygon, half_one)
    density_2 = torch.clamp(torch.stack(
        [dirs[:, 1, 2], sample_2_1[:, 2], last_vertex[:, 2]], dim=-1),
        min=0.0)

    # Middle row: the tail of solid angle sampling again with r1 = 0.5.
    far = torch.stack([vertex_0, sample_2_1, last_vertex], dim=1)
    s2 = dot(vertex_0[:, None], far)
    s = 0.5 * s2 + 0.5
    t = torch.sqrt(torch.clamp(-s * s + 1.0, min=0.0))
    t_axis_z = -s2 * vertex_0[:, 2:3] + far[..., 2]
    norm_t_axis = 1.0 / torch.sqrt(torch.clamp(2.0 * (-s2 * s2 + 1.0),
                                               min=_CLAMP_FLOOR))
    density_1 = torch.clamp(s * vertex_0[:, 2:3]
                            + t * norm_t_axis * t_axis_z, min=0.0)

    density_sum = 3.0 * density_0 + _sum3(density_1) + _sum3(density_2)
    density_0, density_1, density_2 = _normalized(
        density_sum, 9.0, polygon.solid_angle,
        (density_0, density_1, density_2))
    return BiquadraticCosineWarpHart(polygon, density_0, density_1,
                                     density_2)


def quadratic_warp(random_number, density_0, density_1, density_2):
    """Invert the integral of a quadratic Bezier density (glsl:462-485)."""
    q1 = 2.0 * (density_1 - density_0)
    q2 = density_0 - 2.0 * density_1 + density_2
    c1 = density_0
    c2 = 0.5 * q1
    c3 = (1.0 / 3.0) * q2
    scaled = random_number * (c1 + c2 + c3)
    roots, three_real = solve_cubic(torch.stack([-scaled, c1, c2, c3],
                                                dim=-1))
    result = roots[..., 0]
    in_unit_1 = (roots[..., 1] >= 0.0) & (roots[..., 1] <= 1.0)
    in_unit_2 = (roots[..., 2] >= 0.0) & (roots[..., 2] <= 1.0)
    result = torch.where(three_real & in_unit_1, roots[..., 1], result)
    return torch.where(three_real & in_unit_2, roots[..., 2], result)


def quadratic_bezier(b0, b1, b2, location):
    return mix_fma(mix_fma(b0, b1, location), mix_fma(b1, b2, location),
                   location)


def sample_biquadratic_cosine_warp_polygon_hart(
        polygon: BiquadraticCosineWarpHart, random_numbers):
    """(direction (P, 3), density (P,)) (glsl:496-504)."""
    d0, d1, d2 = polygon.density_0, polygon.density_1, polygon.density_2
    r1 = quadratic_warp(random_numbers[:, 1], 3.0 * d0, _sum3(d1), _sum3(d2))
    b = [quadratic_bezier(d0, d1[:, i], d2[:, i], r1) for i in range(3)]
    r0 = quadratic_warp(random_numbers[:, 0], *b)
    density = quadratic_bezier(*b, r0)
    direction = sample_solid_angle_polygon(polygon.polygon,
                                           torch.stack([r0, r1], dim=-1))
    return direction, density
