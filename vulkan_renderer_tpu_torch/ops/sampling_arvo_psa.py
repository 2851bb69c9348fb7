"""Arvo's projected solid angle sampling (the related-work baseline) for
the per-pixel shading path.

Counterpart of vulkan_renderer_tpu/ops/sampling_arvo_psa.py (reference
polygon_sampling_related_work.glsl:509-1048; Arvo 2001, "Stratified
Sampling of 2-Manifolds") as the JAX package writes it, batched over
pixels: per-edge azimuth CDFs, a cubic-interpolation start and Newton
iterations; fixed vertex lanes, masked sector searches, the azimuth rank
sort and the per-sector inner/outer edge state cached at preparation.
Azimuths come from torch.atan2 (the JAX package's jnp.arctan2), edge
lengths from math_utils.positive_atan. K4's plain version keeps its own
structure-of-arrays copy (ops/soa_arvo_psa.py).

Precision: the float type is the inputs'; the fixed offsets keep their
float32 values (1e-30). A float64 run takes the same branches except
where an edge's cdf is within rounding of 0 (its inner/outer side), at a
sector boundary (target against a cumulative PSA), where a Newton step
is clamped to the sector's edge by a derivative that cancels to
rounding level (a sector starting at a vertex on the horizon), and
where an edge nearly radial about z has sin^2 beta round to 0 in
float32: its length coefficients become (0, ~-1e10), the PSA of a
sector starting at it 0/0, and the polygon's PSA NaN, which float64
keeps finite.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .math_utils import (cross, dot2, first_true_lane, gather_lanes, mix_fma,
                         normalize, pick_lane, positive_atan, rotate_90)
from .sampling import vertex_counts

_TINY = float(np.float32(1e-30))
_TWO_PI = 2.0 * math.pi


class ProjectedSolidAnglePolygonArvo(NamedTuple):
    vertex_count: torch.Tensor     # (P,) int32, at least 3
    vertex_azimuths: torch.Tensor  # (P, m)
    # Edges (cdf factor, length coefficients, elevations).
    edge_cdf: torch.Tensor         # (P, m)
    edge_len: torch.Tensor         # (P, m, 2)
    edge_elev: torch.Tensor        # (P, m, 2)
    inner_cdf: torch.Tensor        # (P,)
    inner_len: torch.Tensor        # (P, 2)
    inner_elev: torch.Tensor       # (P, 2)
    inner_azimuth: torch.Tensor    # (P,)
    # The decentral case's per-sector state.
    sector_inner_cdf: torch.Tensor      # (P, m)
    sector_inner_len: torch.Tensor      # (P, m, 2)
    sector_inner_elev: torch.Tensor     # (P, m, 2)
    sector_inner_azimuth: torch.Tensor  # (P, m)
    sector_outer_cdf: torch.Tensor
    sector_outer_len: torch.Tensor
    sector_outer_elev: torch.Tensor
    sector_outer_azimuth: torch.Tensor
    sector_psa: torch.Tensor            # (P, m)
    projected_solid_angle: torch.Tensor  # (P,)


def _prepare_edge(vertex_0, vertex_1):
    """prepare_edge_arvo (glsl:559-590) over leading dims."""
    normal_a = normalize(cross(vertex_0, vertex_1))
    cdf = 0.5 * normal_a[..., 2]
    ccw = torch.where((cdf > 0.0)[..., None], vertex_0, vertex_1)
    normal_c = rotate_90(normalize(ccw[..., :2]))
    cos_beta = -dot2(normal_a[..., :2], normal_c)
    sin_beta_sq = -cos_beta * cos_beta + 1.0
    csc_beta = 1.0 / torch.sqrt(torch.clamp(sin_beta_sq, min=0.0) + _TINY)
    csc_c = 1.0 / torch.sqrt(torch.clamp(-ccw[..., 2] * ccw[..., 2] + 1.0,
                                         min=0.0) + _TINY)
    len1 = dot2(normal_a[..., :2], rotate_90(normal_c)) * cos_beta
    length_coeffs = torch.stack([sin_beta_sq, len1], dim=-1) \
        * (csc_beta * csc_c)[..., None]
    elev1 = cross(ccw, normal_a)[..., 2]
    elev1 = torch.where(cdf > 0.0, -elev1, elev1)
    return cdf, length_coeffs, torch.stack([ccw[..., 2], elev1], dim=-1)


def _point(length_coeffs, rel_azimuth):
    """(direction, the point on the edge's projected ellipse)."""
    direction = torch.stack([torch.cos(rel_azimuth), torch.sin(rel_azimuth)],
                            dim=-1)
    point = torch.stack([dot2(length_coeffs, direction), direction[..., 1]],
                        dim=-1)
    return direction, point


def _edge_psa_in_sector(cdf, length_coeffs, rel_azimuth_0, rel_azimuth_1):
    """get_edge_projected_solid_angle_in_sector_arvo (glsl:600-612)."""
    _, p0 = _point(length_coeffs, rel_azimuth_0)
    _, p1 = _point(length_coeffs, rel_azimuth_1)
    rx = p0[..., 0] * p1[..., 0] + p0[..., 1] * p1[..., 1]
    ry = p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]
    return cdf * positive_atan(torch.abs(ry) / rx)


def _edge_psa_and_derivative(cdf, length_coeffs, rel_azimuth_0,
                             rel_azimuth_1):
    """glsl:617-642: (psa, d psa / d rel_azimuth_1)."""
    _, p0 = _point(length_coeffs, rel_azimuth_0)
    dir_1, p1 = _point(length_coeffs, rel_azimuth_1)
    rx = p0[..., 0] * p1[..., 0] + p0[..., 1] * p1[..., 1]
    ry = p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]
    quotient = torch.abs(ry) / rx
    length = positive_atan(quotient)
    dir_1d = rotate_90(dir_1)
    p1d = torch.stack([dot2(length_coeffs, dir_1d), dir_1d[..., 1]], dim=-1)
    rxd = p0[..., 0] * p1d[..., 0] + p0[..., 1] * p1d[..., 1]
    ryd = p0[..., 0] * p1d[..., 1] - p0[..., 1] * p1d[..., 0]
    qd = (ryd * rx - ry * rxd) / (rx * rx)
    qd = torch.where(ry < 0.0, -qd, qd)
    length_d = qd / (quotient * quotient + 1.0)
    return cdf * length, cdf * length_d


def _edge_elevation(length_coeffs, elevations, rel_azimuth):
    """glsl:648-654."""
    _, point = _point(length_coeffs, rel_azimuth)
    return dot2(normalize(point), elevations)


def _rows(mask, like):
    """A (P,) mask viewed to broadcast against `like` (P, ...)."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _masked_pick(first, has, values, default):
    """values (P, m, ...) at lane `first`, plus 0 (the JAX package's
    one-hot sum), where has, else default."""
    picked = pick_lane(values, first) + 0.0
    return torch.where(_rows(has, picked), picked, default)


def prepare_projected_solid_angle_polygon_sampling_arvo(vertices,
                                                        vertex_count):
    """glsl:743-820. vertices: (P, m, 3), clipped to z >= 0 (the first
    vertex repeated past the count); vertex_count: (P,) int."""
    p, m = vertices.shape[:2]
    v = normalize(vertices)
    count = torch.clamp(vertex_counts(vertex_count, p, vertices.device),
                        min=3)
    lanes = torch.arange(m, dtype=torch.int32, device=vertices.device)
    active = lanes[None] < count[:, None]

    az = torch.atan2(v[..., 1], v[..., 0])
    az0 = az[:, :1]
    az = torch.where(az > az0 + math.pi, az - _TWO_PI, az)
    az = torch.where(az < az0 - math.pi, az + _TWO_PI, az)

    raw_cdf, raw_len, raw_elev = _prepare_edge(v, torch.roll(v, -1, dims=1))
    raw_inner = raw_cdf < 0.0

    # prev = cyclic shift by one lane, wrapping lane 0 to count - 1.
    lane0 = (lanes == 0)[None]
    last = count - 1
    prev_cdf = torch.where(lane0, pick_lane(raw_cdf, last)[:, None],
                           torch.roll(raw_cdf, 1, dims=1))
    prev_len = torch.where(lane0[..., None], pick_lane(raw_len, last)[:, None],
                           torch.roll(raw_len, 1, dims=1))
    prev_elev = torch.where(lane0[..., None],
                            pick_lane(raw_elev, last)[:, None],
                            torch.roll(raw_elev, 1, dims=1))

    inner = raw_inner[..., None]
    edge_cdf = torch.where(raw_inner, prev_cdf, raw_cdf)
    edge_len = torch.where(inner, prev_len, raw_len)
    edge_elev = torch.where(inner, prev_elev, raw_elev)

    transition = active & (prev_cdf < 0.0) & ~raw_inner
    has_transition = torch.any(transition, dim=1)
    first = first_true_lane(transition, torch.zeros_like(count))
    inner_cdf = _masked_pick(first, has_transition, prev_cdf,
                             torch.ones_like(prev_cdf[:, 0]))
    inner_len = _masked_pick(first, has_transition, prev_len,
                             torch.zeros_like(prev_len[:, 0]))
    inner_elev = _masked_pick(first, has_transition, prev_elev,
                              torch.zeros_like(prev_elev[:, 0]))
    central = inner_cdf > 0.0

    # --- central case --------------------------------------------------------
    next_az = torch.roll(az, -1, dims=1)
    central_psa = _edge_psa_in_sector(edge_cdf, edge_len,
                                      torch.zeros_like(az), next_az - az)
    central_psa = torch.where(active, central_psa, 0.0)

    # --- decentral: sort by azimuth (stable rank), walk sectors --------------
    keys = torch.where(active, az, float("inf"))
    kj, kk = keys[:, :, None], keys[:, None, :]
    before = (kj < kk) | ((kj == kk) & (lanes[:, None] < lanes[None, :]))
    rank = torch.sum(before, dim=1)
    # order[j] = the lane of rank j (a permutation even where NaN keys
    # tie every rank, which the caller gates).
    order = torch.argsort(rank, dim=1, stable=True)
    s_az = gather_lanes(az, order)
    s_cdf = gather_lanes(edge_cdf, order)
    s_len = gather_lanes(edge_len, order)
    s_elev = gather_lanes(edge_elev, order)

    state_in = (inner_cdf, inner_len, inner_elev, s_az[:, 0])
    state_out = (s_cdf[:, 0], s_len[:, 0], s_elev[:, 0], s_az[:, 0])
    walk_in, walk_out = [state_in], [state_out]
    for i in range(1, m - 1):
        lane = (s_cdf[:, i], s_len[:, i], s_elev[:, i], s_az[:, i])
        outer = s_cdf[:, i] >= 0.0
        state_in = tuple(torch.where(_rows(outer, a), a, b)
                         for a, b in zip(state_in, lane))
        state_out = tuple(torch.where(_rows(outer, a), b, a)
                          for a, b in zip(state_out, lane))
        walk_in.append(state_in)
        walk_out.append(state_out)
    walk_in.append(state_in)
    walk_out.append(state_out)
    si_cdf, si_len, si_elev, si_az = (torch.stack(f, dim=1)
                                      for f in zip(*walk_in))
    so_cdf, so_len, so_elev, so_az = (torch.stack(f, dim=1)
                                      for f in zip(*walk_out))

    sector_active = lanes[None] < (count - 1)[:, None]
    next_s_az = torch.roll(s_az, -1, dims=1)
    dec_psa = _edge_psa_in_sector(so_cdf, so_len, s_az - so_az,
                                  next_s_az - so_az) \
        + _edge_psa_in_sector(si_cdf, si_len, s_az - si_az,
                              next_s_az - si_az)
    dec_psa = torch.where(sector_active, dec_psa, 0.0)

    c = central[:, None]
    sector_psa = torch.where(c, central_psa, dec_psa)
    return ProjectedSolidAnglePolygonArvo(
        vertex_count=count,
        vertex_azimuths=torch.where(c, az, s_az),
        edge_cdf=torch.where(c, edge_cdf, s_cdf),
        edge_len=torch.where(c[..., None], edge_len, s_len),
        edge_elev=torch.where(c[..., None], edge_elev, s_elev),
        inner_cdf=inner_cdf, inner_len=inner_len, inner_elev=inner_elev,
        inner_azimuth=s_az[:, 0],
        sector_inner_cdf=si_cdf, sector_inner_len=si_len,
        sector_inner_elev=si_elev, sector_inner_azimuth=si_az,
        sector_outer_cdf=so_cdf, sector_outer_len=so_len,
        sector_outer_elev=so_elev, sector_outer_azimuth=so_az,
        sector_psa=sector_psa,
        projected_solid_angle=torch.sum(sector_psa, dim=1))


def is_central_case_arvo(polygon: ProjectedSolidAnglePolygonArvo):
    return polygon.inner_cdf > 0.0


def _cubic_interpolation(sample_x, xs, ys):
    """Newton divided differences through 4 points (glsl:826-839);
    xs, ys: (P, 4)."""
    x0, x1, x2, x3 = xs.unbind(-1)
    y01 = (ys[:, 0] - ys[:, 1]) / (x0 - x1)
    y12 = (ys[:, 1] - ys[:, 2]) / (x1 - x2)
    y23 = (ys[:, 2] - ys[:, 3]) / (x2 - x3)
    y012 = (y01 - y12) / (x0 - x2)
    y123 = (y12 - y23) / (x1 - x3)
    y0123 = (y012 - y123) / (x0 - x3)
    return (sample_x - x0) * ((sample_x - x1) * (
        (sample_x - x2) * y0123 + y012) + y01) + ys[:, 0]


def _select_sector(polygon, target, num_sectors):
    """First sector whose cumulative PSA exceeds the target (the JAX
    package's jnp.cumsum) and the target's remainder in it."""
    cum = torch.cumsum(polygon.sector_psa, dim=1)
    lanes = torch.arange(cum.shape[1], dtype=torch.int32, device=cum.device)
    valid = lanes[None] < num_sectors[:, None]
    reached = (target[:, None] < cum) & valid
    sel = first_true_lane(reached, num_sectors - 1)
    # pick_lane(cum, -1) == 0 at sel == 0, the reference's branch.
    return sel, target - pick_lane(cum, sel - 1)


def sample_projected_solid_angle_polygon_arvo(
        polygon: ProjectedSolidAnglePolygonArvo, random_numbers,
        iteration_count: int = 3):
    """glsl:931-992: a direction (P, 3). Both cases are evaluated at every
    pixel and selected, as the vmapped JAX function does."""
    r0, r1 = random_numbers[:, 0], random_numbers[:, 1]
    target = r0 * polygon.projected_solid_angle
    count = polygon.vertex_count

    # ---- central case -------------------------------------------------------
    sel_c, rem_c = _select_sector(polygon, target, count)
    out_az_c = pick_lane(polygon.vertex_azimuths, sel_c)
    next_idx = torch.where(sel_c + 1 == count, 0, sel_c + 1)
    az1_c = pick_lane(polygon.vertex_azimuths, next_idx)
    az1_c = torch.where(az1_c < out_az_c, az1_c + _TWO_PI, az1_c)
    dir_central = _sample_sector(
        rem_c, r1, None,
        (pick_lane(polygon.edge_cdf, sel_c),
         pick_lane(polygon.edge_len, sel_c),
         pick_lane(polygon.edge_elev, sel_c), out_az_c),
        out_az_c, az1_c, iteration_count)

    # ---- decentral case -----------------------------------------------------
    sel_d, rem_d = _select_sector(polygon, target, count - 1)
    dir_decentral = _sample_sector(
        rem_d, r1,
        (pick_lane(polygon.sector_inner_cdf, sel_d),
         pick_lane(polygon.sector_inner_len, sel_d),
         pick_lane(polygon.sector_inner_elev, sel_d),
         pick_lane(polygon.sector_inner_azimuth, sel_d)),
        (pick_lane(polygon.sector_outer_cdf, sel_d),
         pick_lane(polygon.sector_outer_len, sel_d),
         pick_lane(polygon.sector_outer_elev, sel_d),
         pick_lane(polygon.sector_outer_azimuth, sel_d)),
        pick_lane(polygon.vertex_azimuths, sel_d),
        pick_lane(polygon.vertex_azimuths, sel_d + 1), iteration_count)

    return torch.where(is_central_case_arvo(polygon)[:, None], dir_central,
                       dir_decentral)


def _sample_sector(target, r1, inner, outer, azimuth_0, azimuth_1,
                   iteration_count: int):
    """sample_sector_within_edge / between_edges (glsl:845-929). inner and
    outer are (cdf, length coefficients, elevations, azimuth) edges; inner
    is None in the central case."""
    out_cdf, out_len, out_elev, out_az = outer
    azimuths = torch.stack([
        azimuth_0, mix_fma(azimuth_0, azimuth_1, 1.0 / 3.0),
        mix_fma(azimuth_0, azimuth_1, 2.0 / 3.0), azimuth_1], dim=-1)

    def psa_at(edge, azimuth):
        cdf, length, _, az = edge
        return _edge_psa_in_sector(cdf[:, None], length[:, None],
                                   (azimuth_0 - az)[:, None],
                                   azimuth - az[:, None])

    psas = psa_at(outer, azimuths)
    if inner is not None:
        psas = psas + psa_at(inner, azimuths)
    sampled_az = _cubic_interpolation(target, psas, azimuths)
    for _ in range(iteration_count):
        out_psa, out_d = _edge_psa_and_derivative(
            out_cdf, out_len, azimuth_0 - out_az, sampled_az - out_az)
        if inner is not None:
            in_cdf, in_len, _, in_az = inner
            in_psa, in_d = _edge_psa_and_derivative(
                in_cdf, in_len, azimuth_0 - in_az, sampled_az - in_az)
            error = in_psa + out_psa - target
            derivative = in_d + out_d
        else:
            error = out_psa - target
            derivative = out_d
        step = error / torch.where(derivative != 0.0, derivative, 1.0)
        sampled_az = torch.minimum(torch.maximum(sampled_az - step,
                                                 azimuth_0), azimuth_1)

    out_z = _edge_elevation(out_len, out_elev, sampled_az - out_az)
    if inner is not None:
        in_z = _edge_elevation(inner[1], inner[2], sampled_az - inner[3])
        z_sq = mix_fma(in_z * in_z, out_z * out_z, r1)
    else:
        z_sq = mix_fma(1.0, out_z * out_z, r1)
    z = torch.sqrt(torch.clamp(z_sq, min=0.0))
    r_xy = torch.sqrt(torch.clamp(-z * z + 1.0, min=0.0))
    return torch.stack([torch.cos(sampled_az) * r_xy,
                        torch.sin(sampled_az) * r_xy, z], dim=-1)


def compute_projected_solid_angle_polygon_sampling_error_arvo(
        polygon: ProjectedSolidAnglePolygonArvo, random_numbers, sampled_dir):
    """glsl:998-1048: (backward error, scaled backward error) as (P, 2),
    zeros in the central case."""
    target = random_numbers[:, 0] * polygon.projected_solid_angle
    sel, remaining = _select_sector(polygon, target,
                                    polygon.vertex_count - 1)
    azimuth_0 = pick_lane(polygon.vertex_azimuths, sel)
    sampled_az = torch.atan2(sampled_dir[:, 1], sampled_dir[:, 0])
    # Bring the sampled azimuth into the sector's wrapped frame.
    sampled_az = torch.where(sampled_az < azimuth_0 - math.pi,
                             sampled_az + _TWO_PI, sampled_az)
    sampled_az = torch.where(sampled_az > azimuth_0 + math.pi,
                             sampled_az - _TWO_PI, sampled_az)
    psas = []
    for cdf, length, az in (
            (polygon.sector_outer_cdf, polygon.sector_outer_len,
             polygon.sector_outer_azimuth),
            (polygon.sector_inner_cdf, polygon.sector_inner_len,
             polygon.sector_inner_azimuth)):
        edge_az = pick_lane(az, sel)
        psas.append(_edge_psa_and_derivative(
            pick_lane(cdf, sel), pick_lane(length, sel),
            azimuth_0 - edge_az, sampled_az - edge_az)[0])
    sampled_psa = psas[0] + psas[1]
    scaled = remaining - sampled_psa
    errors = torch.stack([scaled / polygon.projected_solid_angle, scaled],
                         dim=-1)
    return torch.where(is_central_case_arvo(polygon)[:, None], 0.0, errors)
