"""Polygonal-light sampling for the per-pixel shading path: solid angle
(ours) and projected solid angle (the SIGGRAPH 2021 paper's method).

Counterpart of vulkan_renderer_tpu/ops/sampling.py (reference
polygon_sampling.glsl) as the JAX package writes it, batched over a
leading pixel axis P where the JAX package computes one pixel and vmaps
it. A polygon is a (P, m, 3) tensor of m vertex lanes (or an (m, 3) one
shared by every pixel) with a static m and a vertex count that is m or a
(P,) int tensor; lanes past the count repeat the first vertex. Where the
JAX package branches on the count, the port masks: the fan and sector
searches are first-true searches over lanes, the counterclockwise sort
is the JAX package's rank sort (keys compared pairwise, the permutation
applied by gather), and lane reads go through math_utils.pick_lane.
Values a masked lane may hold (NaN, inf) are dropped by torch.where
before any sum over lanes. K4's plain version keeps its own
structure-of-arrays formulation (ops/soa.py); this module imports none
of it.

Precision: the float type is the inputs'. Fixed thresholds keep their
float32 values, so a float64 run (a test's oracle) takes the same
branches except where a compared value lies within float32 rounding of
its threshold: a fan or sector boundary (target against a cumulative
angle), an edge's inner/outer sign (the sign bit of an ellipse's x, which
is_inner_ellipse reads for -0.0 too), a sort key tie, and the Newton
iteration's stability gate |r0 - 0.5| <= 0.5 - 1e-5.

Random numbers are (P, 2) tensors; directions come back as (P, 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .math_utils import (cross_stable, cumsum_lanes, dot, dot2,
                         fast_positive_atan, first_true_lane, gather_lanes,
                         kahan, mix_fma, normalize, pick_lane, positive_atan,
                         rotate_90)

# Thresholds as float32 values (the JAX package's float32 arithmetic).
_STABLE_LIMIT = float(np.float32(0.5) - np.float32(1.0e-5))
_KEY_EPSILON = float(np.float32(1e-37))


def _pos_atan(tangent, biased: bool):
    return fast_positive_atan(tangent) if biased else positive_atan(tangent)


def vertex_counts(vertex_count, p: int, device) -> torch.Tensor:
    """A (P,) int32 count from a static int or a (P,) tensor."""
    if isinstance(vertex_count, int):
        return torch.full((p,), vertex_count, dtype=torch.int32,
                          device=device)
    return vertex_count.to(torch.int32)


def _lanes(m: int, device) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=device)


# ===========================================================================
# Solid angle sampling (our variant of Arvo's method)
# polygon_sampling.glsl:61-224
# ===========================================================================


class SolidAnglePolygon(NamedTuple):
    vertex_count: torch.Tensor         # (P,) int32
    vertex_dirs: torch.Tensor          # (P, m, 3)
    triangle_parameters: torch.Tensor  # (P, m - 2, 3)
    fan_solid_angles: torch.Tensor     # (P, m - 2)
    solid_angle: torch.Tensor          # (P,)


def prepare_solid_angle_polygon_sampling(vertices, vertex_count,
                                         shading_position,
                                         biased: bool = False):
    """Triangle-fan solid angles via Householder-stabilized
    Oosterom-Strackee (polygon_sampling.glsl:120-175). vertices: (P, m, 3)
    or (m, 3); vertex_count: m (static) or a (P,) int tensor;
    shading_position: (P, 3), or None for the origin."""
    if shading_position is not None:
        vertices = vertices - shading_position[:, None, :]
    dirs = normalize(vertices)
    if dirs.dim() == 2:
        dirs = dirs[None]
    m = dirs.shape[1]
    count = vertex_counts(vertex_count, dirs.shape[0], dirs.device)
    if shading_position is None and dirs.shape[0] != count.shape[0]:
        dirs = dirs.expand(count.shape[0], -1, -1)

    d0 = dirs[:, 0]
    householder_sign = torch.where(d0[:, 0] > 0.0, -1.0, 1.0)
    householder_yz = d0[:, 1:] * (1.0 / (torch.abs(d0[:, 0]) + 1.0))[:, None]

    # Fan triangle i uses vertices (i + 1, 0, i + 2).
    v0 = dirs[:, 1:m - 1]
    v1 = d0[:, None]
    v2 = dirs[:, 2:m]
    dot_0_1 = dot(v0, v1)
    dot_0_2 = dot(v0, v2)
    dot_1_2 = dot(v1, v2)

    hs = householder_sign[:, None]
    dot_householder_0 = -hs * v0[..., 0] + dot_0_1
    dot_householder_2 = -hs * v2[..., 0] + dot_1_2
    # Bottom-right 2x2 minor after the Householder transform.
    hyz = householder_yz[:, None]
    col0 = -dot_householder_0[..., None] * hyz + v0[..., 1:]
    col1 = -dot_householder_2[..., None] * hyz + v2[..., 1:]
    simplex_volume = torch.abs(col0[..., 0] * col1[..., 1]
                               - col0[..., 1] * col1[..., 0])

    dot_0_2_plus_1_2 = dot_0_2 + dot_1_2
    one_plus_dot_0_1 = 1.0 + dot_0_1
    tangent = simplex_volume / (one_plus_dot_0_1 + dot_0_2_plus_1_2)
    tri_solid_angle = 2.0 * _pos_atan(tangent, biased)
    tri = _lanes(m - 2, dirs.device)
    tri_active = tri[None] + 2 < torch.clamp(count, min=3)[:, None]
    tri_solid_angle = torch.where(tri_active, tri_solid_angle, 0.0)

    fan = cumsum_lanes(tri_solid_angle)
    params = torch.stack([simplex_volume, dot_0_2_plus_1_2,
                          one_plus_dot_0_1], dim=-1)
    return SolidAnglePolygon(count, dirs, params, fan, fan[:, -1])


def sample_solid_angle_polygon(polygon: SolidAnglePolygon, random_numbers):
    """Map [0, 1]^2 to a solid-angle-uniform direction
    (polygon_sampling.glsl:194-224)."""
    r0, r1 = random_numbers[:, 0], random_numbers[:, 1]
    target = polygon.solid_angle * r0
    tri = _lanes(polygon.fan_solid_angles.shape[1], r0.device)
    count = polygon.vertex_count
    # First fan triangle whose cumulative solid angle reaches the target.
    valid = tri[None] + 2 < torch.clamp(count, min=3)[:, None]
    reached = (polygon.fan_solid_angles >= target[:, None]) & valid
    sel = first_true_lane(reached, torch.clamp(count - 3, min=0))

    prev_fan = pick_lane(polygon.fan_solid_angles, sel - 1)  # 0 at sel 0
    sub_solid_angle = target - prev_fan
    params = pick_lane(polygon.triangle_parameters, sel)
    v0 = pick_lane(polygon.vertex_dirs, sel + 1)
    v1 = polygon.vertex_dirs[:, 0]
    v2 = pick_lane(polygon.vertex_dirs, sel + 2)

    cos_h = torch.cos(0.5 * sub_solid_angle)
    sin_h = torch.sin(0.5 * sub_solid_angle)
    offset = v0 * (params[:, 0] * cos_h - params[:, 1] * sin_h)[:, None] \
        + v2 * (params[:, 2] * sin_h)[:, None]
    new_v2 = (2.0 * dot(v0, offset) / dot(offset, offset))[:, None] \
        * offset - v0

    s2 = dot(v1, new_v2)
    s = mix_fma(1.0, s2, r1)
    denominator = -s2 * s2 + 1.0
    positive = denominator > 0.0
    t_normed = torch.sqrt(torch.clamp(-s * s + 1.0, min=0.0)
                          / torch.where(positive, denominator, 1.0))
    t_normed = torch.where(positive, t_normed, r1)
    return (-t_normed * s2 + s)[:, None] * v1 + t_normed[:, None] * new_v2


# ===========================================================================
# Projected solid angle sampling (the paper's method)
# polygon_sampling.glsl:230-883
# ===========================================================================


class ProjectedSolidAnglePolygon(NamedTuple):
    vertex_count: torch.Tensor     # (P,) int32, at least 3
    vertices: torch.Tensor         # (P, m, 2) xy, ccw-sorted if decentral
    ellipses: torch.Tensor         # (P, m, 2)
    inner_ellipse_0: torch.Tensor  # (P, 2)
    # The running inner/outer ellipse per decentral sector (cached, so
    # sampling does not re-walk the GLSL loops' state machine).
    sector_inner: torch.Tensor     # (P, m, 2)
    sector_outer: torch.Tensor     # (P, m, 2)
    sector_psa: torch.Tensor       # (P, m)
    projected_solid_angle: torch.Tensor  # (P,)


def is_inner_ellipse(ellipse_x):
    """The sign BIT of ellipse.x tells inner from outer edges, -0.0
    included (polygon_sampling.glsl:292-299)."""
    return torch.signbit(ellipse_x)


def ellipse_from_edge(vertex_0, vertex_1):
    """Great-circle normal in half-vector space
    (polygon_sampling.glsl:317-326)."""
    normal = cross_stable(vertex_0, vertex_1)
    nz = normal[..., 2]
    nonzero = nz != 0.0
    scaling = 1.0 / torch.where(nonzero, nz, 1.0)
    scaling = torch.where(is_inner_ellipse(normal[..., 0]), -scaling,
                          scaling)
    ellipse = normal[..., :2] * scaling[..., None]
    ex = torch.where(nonzero, ellipse[..., 0], float("inf"))
    return torch.stack([ex, ellipse[..., 1]], dim=-1)


def ellipse_transform(ellipse, point):
    return dot2(ellipse, point)[..., None] * ellipse + point


def get_ellipse_det(ellipse):
    return ellipse[..., 0] * ellipse[..., 0] \
        + ellipse[..., 1] * ellipse[..., 1] + 1.0


def get_ellipse_rsqrt_det(ellipse):
    return 1.0 / torch.sqrt(get_ellipse_det(ellipse))


def get_ellipse_direction_factor_rsq(ellipse, direction):
    e_dot_d = dot2(ellipse, direction)
    return e_dot_d * e_dot_d + dot2(direction, direction)


def get_ellipse_direction_factor(ellipse, direction):
    return 1.0 / torch.sqrt(get_ellipse_direction_factor_rsq(ellipse,
                                                             direction))


def get_ellipse_normalized_direction_factor(ellipse, normalized_dir):
    e_dot_d = dot2(ellipse, normalized_dir)
    return 1.0 / torch.sqrt(e_dot_d * e_dot_d + 1.0)


def _area_between_from_tangents(inner_rsqrt_det, inner_tangent,
                                outer_rsqrt_det, outer_tangent, biased):
    inner_area = inner_rsqrt_det * _pos_atan(inner_tangent, biased)
    result = outer_rsqrt_det * _pos_atan(outer_tangent, biased) - inner_area
    # NaNs and negatives collapse to zero (glsl:377-382).
    return torch.where(result > 0.0, 0.5 * result, 0.0)


def get_area_between_ellipses_in_sector(inner_ellipse, inner_rsqrt_det,
                                        outer_ellipse, outer_rsqrt_det,
                                        dir_0, dir_1, biased=False):
    det_dirs = torch.clamp(dot2(dir_1, rotate_90(dir_0)), min=0.0)
    inner_dot = inner_rsqrt_det \
        * dot2(dir_0, ellipse_transform(inner_ellipse, dir_1))
    outer_dot = outer_rsqrt_det \
        * dot2(dir_0, ellipse_transform(outer_ellipse, dir_1))
    return _area_between_from_tangents(inner_rsqrt_det, det_dirs / inner_dot,
                                       outer_rsqrt_det, det_dirs / outer_dot,
                                       biased)


def get_ellipse_area_in_sector(ellipse, dir_0, dir_1, biased=False):
    rsqrt_det = get_ellipse_rsqrt_det(ellipse)
    det_dirs = torch.clamp(dot2(dir_1, rotate_90(dir_0)), min=0.0)
    ellipse_dot = rsqrt_det * dot2(dir_0, ellipse_transform(ellipse, dir_1))
    area = 0.5 * rsqrt_det * _pos_atan(det_dirs / ellipse_dot, biased)
    return torch.where(rsqrt_det > 0.0, area, 0.0)


def _sort_convex_polygon_vertices(vertices, ellipses, vertex_count):
    """Counterclockwise sort by relative angle (the JAX package's rank
    sort, sampling.py:276). The decentral case keeps every vertex
    direction within one half-plane, so a pseudo-angle relative to
    vertex 0 orders them without wraparound. vertices, ellipses: (P, m,
    2); vertex_count: (P,) at least 3."""
    m = vertices.shape[1]
    lanes = _lanes(m, vertices.device)
    active = lanes[None] < vertex_count[:, None]
    ref = vertices[:, :1]
    cross = kahan(ref[..., 0], vertices[..., 1], ref[..., 1],
                  vertices[..., 0])
    dot_ref = ref[..., 0] * vertices[..., 0] + ref[..., 1] * vertices[..., 1]
    # Pseudo-angle: strictly monotonic in atan2(cross, dot) over (-pi, pi].
    p = dot_ref / (torch.abs(dot_ref) + torch.abs(cross) + _KEY_EPSILON)
    # The SIGN BIT of cross, so that cross == -0.0 keys as atan2(-0.0,
    # dot < 0) = -pi (sorts first), as the reference's networks order it.
    keys = torch.where(torch.signbit(cross), p - 1.0, 1.0 - p)
    keys = torch.where(active, keys, 4.0)
    # Stable rank: rank[k] = #{j: key_j < key_k, or equal with j < k}.
    kj, kk = keys[:, :, None], keys[:, None, :]
    before = (kj < kk) | ((kj == kk) & (lanes[:, None] < lanes[None, :]))
    rank = torch.sum(before, dim=1)
    # order[j] = the lane of rank j (a permutation even where NaN keys
    # tie every rank, which the caller gates).
    order = torch.argsort(rank, dim=1, stable=True)
    return gather_lanes(vertices, order), gather_lanes(ellipses, order)


def prepare_projected_solid_angle_polygon_sampling(vertices, vertex_count,
                                                   biased: bool = False):
    """PSA preparation (polygon_sampling.glsl:521-589): central and
    decentral sectors, the counterclockwise sort and the inner/outer
    ellipse walk.

    vertices: (P, m, 3), clipped to z >= 0 (the first vertex repeated past
    the count), clockwise as seen from the origin; vertex_count: (P,) int
    (values below 3 are taken as 3; the caller gates a fully clipped
    polygon)."""
    p, m = vertices.shape[:2]
    count = torch.clamp(vertex_counts(vertex_count, p, vertices.device),
                        min=3)
    lanes = _lanes(m, vertices.device)
    active = lanes[None] < count[:, None]

    # Raw ellipses for edge i -> i + 1; the padding repeats vertex 0 at
    # lane `count`, so the closing edge is formed for any count.
    next_v = torch.roll(vertices, -1, dims=1)
    raw = ellipse_from_edge(vertices, next_v)

    raw_inner = is_inner_ellipse(raw[..., 0])
    last_raw = pick_lane(raw, count - 1)
    last_inner = pick_lane(raw_inner, count - 1)
    lane0 = (lanes == 0)[None]
    prev_raw = torch.where(lane0[..., None], last_raw[:, None],
                           torch.roll(raw, 1, dims=1))
    prev_inner = (lane0 & last_inner[:, None]) \
        | (~lane0 & torch.roll(raw_inner, 1, dims=1))

    # If edge i is inner, vertex i keeps the previous (outer) ellipse.
    ellipses = torch.where(raw_inner[..., None], prev_raw, raw)
    # The dropped inner ellipse at the first inner -> outer transition.
    transition = active & prev_inner & ~raw_inner
    has_transition = torch.any(transition, dim=1)
    first = first_true_lane(transition, torch.zeros_like(count))
    picked = pick_lane(prev_raw, first) + 0.0
    default = torch.zeros_like(picked)
    default[:, 0] = 1.0
    inner_ellipse_0 = torch.where(has_transition[:, None], picked, default)

    central = inner_ellipse_0[:, 0] > 0.0

    # --- central case: one ellipse per sector --------------------------------
    v_xy = vertices[..., :2]
    next_xy = next_v[..., :2]
    central_psa = get_ellipse_area_in_sector(ellipses, v_xy, next_xy, biased)
    central_psa = torch.where(active, central_psa, 0.0)

    # --- decentral case: sort ccw, then walk sectors -------------------------
    sorted_v, sorted_e = _sort_convex_polygon_vertices(v_xy, ellipses, count)

    # The running inner/outer ellipse over sectors 0 .. m - 2 (glsl:563-586).
    inner_e = inner_ellipse_0
    outer_e = sorted_e[:, 0]
    sector_inner = [inner_e]
    sector_outer = [outer_e]
    for i in range(1, m - 1):
        vertex_e = sorted_e[:, i]
        vertex_is_inner = is_inner_ellipse(vertex_e[:, 0])[:, None]
        inner_e = torch.where(vertex_is_inner, vertex_e, inner_e)
        outer_e = torch.where(vertex_is_inner, outer_e, vertex_e)
        sector_inner.append(inner_e)
        sector_outer.append(outer_e)
    sector_inner = torch.stack(sector_inner + [inner_e], dim=1)
    sector_outer = torch.stack(sector_outer + [outer_e], dim=1)

    sector_active = lanes[None] < (count - 1)[:, None]
    decentral_psa = get_area_between_ellipses_in_sector(
        sector_inner, get_ellipse_rsqrt_det(sector_inner),
        sector_outer, get_ellipse_rsqrt_det(sector_outer),
        sorted_v, torch.roll(sorted_v, -1, dims=1), biased)
    decentral_psa = torch.where(sector_active, decentral_psa, 0.0)

    c = central[:, None]
    sector_psa = torch.where(c, central_psa, decentral_psa)
    return ProjectedSolidAnglePolygon(
        vertex_count=count,
        vertices=torch.where(c[..., None], v_xy, sorted_v),
        ellipses=torch.where(c[..., None], ellipses, sorted_e),
        inner_ellipse_0=inner_ellipse_0,
        sector_inner=sector_inner,
        sector_outer=sector_outer,
        sector_psa=sector_psa,
        projected_solid_angle=torch.sum(sector_psa, dim=1))


def is_central_case(polygon: ProjectedSolidAnglePolygon):
    return polygon.inner_ellipse_0[:, 0] > 0.0


def _normalize_approx_and_flip(rhs, semi_circle):
    """Cheap magnitude normalization with sign flip
    (polygon_sampling.glsl:599-611, the documented 1/x fallback)."""
    scaling = 1.0 / (torch.abs(rhs[..., 0]) + torch.abs(rhs[..., 1]))
    scaling = torch.where(dot2(rhs, semi_circle) >= 0.0, scaling, -scaling)
    return scaling[..., None] * rhs


def _solve_homogeneous_quadratic(q00, q01, q10, q11):
    """Blinn's stable homogeneous quadratic root
    (polygon_sampling.glsl:625-630); q_cr = quadratic[c][r] (GLSL mat2 is
    column-major)."""
    coeff_xy = 0.5 * (q01 + q10)
    sqrt_disc = torch.sqrt(torch.clamp(coeff_xy * coeff_xy - q00 * q11,
                                       min=0.0))
    scaled_root = torch.abs(coeff_xy) + sqrt_disc
    root_pos = torch.stack([scaled_root, -q00], dim=-1)
    root_neg = torch.stack([q11, scaled_root], dim=-1)
    return torch.where((coeff_xy >= 0.0)[..., None], root_pos, root_neg)


def _outer2(a, b):
    """GLSL outerProduct(a, b) as (q00, q01, q10, q11), M[c][r] = a_r b_c."""
    return (a[..., 0] * b[..., 0], a[..., 1] * b[..., 0],
            a[..., 0] * b[..., 1], a[..., 1] * b[..., 1])


def sample_sector_between_ellipses(random_numbers, target_area, inner_ellipse,
                                   outer_ellipse, dir_0, dir_1,
                                   iteration_count: int = 2,
                                   biased: bool = False):
    """Uniform area sample between two ellipses inside a sector
    (polygon_sampling.glsl:645-739). random_numbers: (P, 2); the ellipses
    and directions (P, 2)."""
    r0, r1 = random_numbers[:, 0], random_numbers[:, 1]
    q0 = normalize(dir_0)
    q2 = normalize(dir_1)
    q1 = q0 + q2

    nf00 = get_ellipse_normalized_direction_factor(inner_ellipse, q0)
    nf01 = get_ellipse_direction_factor(inner_ellipse, q1)
    nf02 = get_ellipse_normalized_direction_factor(inner_ellipse, q2)
    nf10 = get_ellipse_normalized_direction_factor(outer_ellipse, q0)
    nf11 = get_ellipse_direction_factor(outer_ellipse, q1)
    nf12 = get_ellipse_normalized_direction_factor(outer_ellipse, q2)

    sector_area_0 = nf10 * nf11 - nf00 * nf01
    sector_area_1 = nf11 * nf12 - nf01 * nf02

    target_quad_area = mix_fma(-sector_area_0, sector_area_1, r0)
    first_half = target_quad_area <= 0.0
    q2 = torch.where(first_half[:, None], q0, q2)
    nf02 = torch.where(first_half, nf00, nf02)
    nf12 = torch.where(first_half, nf10, nf12)
    target_quad_area = target_quad_area + torch.where(
        first_half, sector_area_0, -sector_area_1)
    target_quad_area = target_quad_area * torch.abs(
        q1[:, 0] * q2[:, 1] - q1[:, 1] * q2[:, 0])

    quad_normal_inner = ellipse_transform(
        inner_ellipse, q1 * nf01[:, None] + q2 * nf02[:, None])
    quad_normal_outer = ellipse_transform(
        outer_ellipse, q1 * nf11[:, None] + q2 * nf12[:, None])
    quad_offset_inner = dot2(quad_normal_inner, q1) * nf01
    quad_offset_outer = dot2(quad_normal_outer, q1) * nf11

    rot_q2 = rotate_90(q2)
    a = (quad_offset_outer * nf12)[:, None] * rot_q2
    q00, q01, q10, q11 = _outer2(a, quad_normal_inner)
    b = (quad_offset_inner * nf02)[:, None] * rot_q2 \
        + target_quad_area[:, None] * quad_normal_inner
    p00, p01, p10, p11 = _outer2(b, quad_normal_outer)
    current_dir = _solve_homogeneous_quadratic(q00 - p00, q01 - p01,
                                               q10 - p10, q11 - p11)

    if not biased:
        # Boundary random numbers would destabilize the iteration
        # (glsl:702-707).
        stable = (torch.abs(r0 - 0.5) <= _STABLE_LIMIT)[:, None]
        inner_rsqrt_det = get_ellipse_rsqrt_det(inner_ellipse)
        outer_rsqrt_det = get_ellipse_rsqrt_det(outer_ellipse)
        rot_q0 = rotate_90(q0)
        for _ in range(iteration_count):
            new_dir = _normalize_approx_and_flip(current_dir, q1)
            inner_dir = ellipse_transform(inner_ellipse, new_dir)
            outer_dir = ellipse_transform(outer_ellipse, new_dir)
            det_dirs = torch.clamp(dot2(new_dir, rot_q0), min=0.0)
            error = target_area - _area_between_from_tangents(
                inner_rsqrt_det,
                det_dirs / (inner_rsqrt_det * dot2(q0, inner_dir)),
                outer_rsqrt_det,
                det_dirs / (outer_rsqrt_det * dot2(q0, outer_dir)),
                biased)
            a00, a01, a10, a11 = _outer2(inner_dir - outer_dir,
                                         rotate_90(new_dir))
            b00, b01, b10, b11 = _outer2((2.0 * error)[:, None] * inner_dir,
                                         outer_dir)
            stepped = _solve_homogeneous_quadratic(a00 - b00, a01 - b01,
                                                   a10 - b10, a11 - b11)
            current_dir = torch.where(stable, stepped, current_dir)

    current_dir = torch.where((dot2(current_dir, q1) >= 0.0)[:, None],
                              current_dir, -current_dir)
    inner_factor = 1.0 / get_ellipse_direction_factor_rsq(inner_ellipse,
                                                          current_dir)
    outer_factor = 1.0 / get_ellipse_direction_factor_rsq(outer_ellipse,
                                                          current_dir)
    radius = torch.sqrt(mix_fma(inner_factor, outer_factor, r1))
    return current_dir * radius[:, None]


def _select_sector(polygon: ProjectedSolidAnglePolygon, target, num_sectors):
    """First sector whose cumulative PSA exceeds the target, and the
    target's remainder in it."""
    cum = cumsum_lanes(polygon.sector_psa)
    lanes = _lanes(cum.shape[1], cum.device)
    valid = lanes[None] < num_sectors[:, None]
    reached = (target[:, None] < cum) & valid
    sel = first_true_lane(reached, num_sectors - 1)
    # pick_lane(cum, -1) == 0 at sel == 0, the reference's branch.
    return sel, target - pick_lane(cum, sel - 1)


def sample_projected_solid_angle_polygon(polygon: ProjectedSolidAnglePolygon,
                                         random_numbers,
                                         biased: bool = False):
    """A PSA-uniform direction (P, 3) on the upper hemisphere
    (polygon_sampling.glsl:749-805). Both cases are evaluated at every
    pixel and selected, as the vmapped JAX function does."""
    r0, r1 = random_numbers[:, 0], random_numbers[:, 1]
    target = r0 * polygon.projected_solid_angle
    central = is_central_case(polygon)
    count = polygon.vertex_count

    # ---- central case -------------------------------------------------------
    sel_c, rem_c = _select_sector(polygon, target, count)
    outer_c = pick_lane(polygon.ellipses, sel_c)
    dir0_c = pick_lane(polygon.vertices, sel_c)
    sqrt_det = torch.sqrt(get_ellipse_det(outer_c))
    angle = 2.0 * rem_c * sqrt_det
    dir_c = (torch.cos(angle) * sqrt_det)[:, None] * dir0_c \
        + torch.sin(angle)[:, None] \
        * rotate_90(ellipse_transform(outer_c, dir0_c))
    dir_c = dir_c * torch.sqrt(
        r1 / get_ellipse_direction_factor_rsq(outer_c, dir_c))[:, None]

    # ---- decentral case -----------------------------------------------------
    sel_d, rem_d = _select_sector(polygon, target, count - 1)
    inner_d = pick_lane(polygon.sector_inner, sel_d)
    outer_d = pick_lane(polygon.sector_outer, sel_d)
    dir0_d = pick_lane(polygon.vertices, sel_d)
    dir1_d = pick_lane(polygon.vertices, sel_d + 1)
    sector_psa = pick_lane(polygon.sector_psa, sel_d)
    r0_d = rem_d / torch.where(sector_psa > 0.0, sector_psa, 1.0)
    dir_d = sample_sector_between_ellipses(
        torch.stack([r0_d, r1], dim=-1), rem_d, inner_d, outer_d, dir0_d,
        dir1_d, 2, biased)

    xy = torch.where(central[:, None], dir_c, dir_d)
    z = torch.sqrt(torch.clamp(1.0 - xy[:, 0] * xy[:, 0]
                               - xy[:, 1] * xy[:, 1], min=0.0))
    return torch.cat([xy, z[:, None]], dim=-1)


def compute_projected_solid_angle_polygon_sampling_error(
        polygon: ProjectedSolidAnglePolygon, random_numbers, sampled_dir):
    """Backward, scaled backward and forward error of the iterative
    inversion (polygon_sampling.glsl:823-883): (P, 3), zeros in the
    central case."""
    r1 = random_numbers[:, 1]
    target = random_numbers[:, 0] * polygon.projected_solid_angle
    sel, remaining = _select_sector(polygon, target,
                                    polygon.vertex_count - 1)
    inner_e = pick_lane(polygon.sector_inner, sel)
    outer_e = pick_lane(polygon.sector_outer, sel)
    dir_0 = pick_lane(polygon.vertices, sel)
    d_xy = sampled_dir[:, :2]

    sampled_psa = get_area_between_ellipses_in_sector(
        inner_e, get_ellipse_rsqrt_det(inner_e),
        outer_e, get_ellipse_rsqrt_det(outer_e), dir_0, d_xy)
    scaled_backward_error = remaining - sampled_psa
    backward_error = scaled_backward_error / polygon.projected_solid_angle

    inner_dir = ellipse_transform(inner_e, d_xy)
    outer_dir = ellipse_transform(outer_e, d_xy)
    inner_factor = 1.0 / dot2(d_xy, inner_dir)
    outer_factor = 1.0 / dot2(d_xy, outer_dir)
    # The constraint matrix's columns as in the GLSL, then transposed.
    col0 = (0.5 * (inner_factor - outer_factor))[:, None] * rotate_90(d_xy)
    col1 = ((1.0 - r1) / (inner_factor * inner_factor))[:, None] * inner_dir \
        + (r1 / (outer_factor * outer_factor))[:, None] * outer_dir
    det = col0[:, 0] * col1[:, 1] - col0[:, 1] * col1[:, 0]
    deriv_xy = (1.0 / det)[:, None] * torch.stack([col1[:, 1], -col0[:, 1]],
                                                  dim=-1)
    deriv_z = -dot2(d_xy, deriv_xy) / sampled_dir[:, 2]
    deriv = torch.cat([deriv_xy, deriv_z[:, None]], dim=-1)
    forward_error = torch.sqrt(dot(deriv, deriv)) * scaled_backward_error
    errors = torch.stack([backward_error, scaled_backward_error,
                          forward_error], dim=-1)
    return torch.where(is_central_case(polygon)[:, None], 0.0, errors)
