"""The per-pixel shading of the reference, transcribed from the JAX
package's plain path (vulkan_renderer_tpu at commit b4b0e8b), not from the
port: the geometry attributes and shading data (render/shading.py
geometry_attributes, finish_shading_data; ops/intersect.py), the material
fetch (render/texture.py, trilinear, one tap), the light display and the
LTC fetch (render/pipeline.py _pixel_preamble, ops/ltc.py), projected
solid angle sampling with its clipping (ops/sampling.py, ops/clipping.py,
ops/math_utils.py), the BRDF (ops/brdf.py) and the two strategies the
cells use of evaluate_polygonal_light_shading: diffuse only, and diffuse
and specular under multiple importance sampling with clamped optimal
weights (ops/mis.py). Other techniques raise NotImplementedError.

Each function handles one pixel, as the JAX package's does, and is
mapped over pixels (and samples) with torch.vmap; vertex lanes run along
axis 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

M_PI = 3.14159265358979323846
M_HALF_PI = 0.5 * M_PI
M_INV_PI = 1.0 / M_PI
INF = float("inf")
STRATEGIES = ("DIFFUSE_ONLY", "DIFFUSE_SPECULAR_MIS")


# -- ops/math_utils.py -------------------------------------------------------

def normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def two_product(a, b):
    """(p, e) with p = fl(a b) and p + e == a b exactly (Veltkamp)."""
    p = a * b
    a_hi = a * 4097.0
    a_hi = a_hi - (a_hi - a)
    a_lo = a - a_hi
    b_hi = b * 4097.0
    b_hi = b_hi - (b_hi - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def kahan(a, b, c, d):
    """a b - c d to about 1.5 ulp."""
    p1, e1 = two_product(a, b)
    p2, e2 = two_product(c, d)
    return (p1 - p2) + (e1 - e2)


def cross_stable(lhs, rhs):
    return torch.stack([
        kahan(lhs[..., 1], rhs[..., 2], lhs[..., 2], rhs[..., 1]),
        kahan(lhs[..., 2], rhs[..., 0], lhs[..., 0], rhs[..., 2]),
        kahan(lhs[..., 0], rhs[..., 1], lhs[..., 1], rhs[..., 0])], -1)


def mix_fma(x, y, a):
    return a * y + (x - a * x)


def atan_f32(x):
    """Cephes atanf, branch-free."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095
    mid = (ax > 0.4142135623730950) & ~big
    safe_ax = torch.where(ax > 0.0, ax, 1.0)
    r = torch.where(big, -1.0 / torch.where(big, safe_ax, 1.0),
                    torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    offset = torch.where(big, M_HALF_PI, torch.where(mid, 0.25 * M_PI, 0.0))
    z = r * r
    p = z * 8.05374449538e-2 - 1.38776856032e-1
    p = z * p + 1.99777106478e-1
    p = z * p - 3.33329491539e-1
    y = offset + (z * p * r + r)
    return torch.where(x < 0.0, -y, y)


def positive_atan(tangent):
    return atan_f32(tangent) + torch.where(tangent < 0.0, M_PI, 0.0)


def cumsum_lanes(x):
    """Inclusive prefix sum over axis 0 by shift-adds, in the JAX
    package's order of additions."""
    n = x.shape[0]
    offset = 1
    while offset < n:
        x = x + torch.cat([torch.zeros_like(x[:offset]), x[:-offset]], 0)
        offset *= 2
    return x


def lanes_like(x, n):
    return torch.arange(n, device=x.device)


def first_true_lane(mask, fallback):
    n = mask.shape[0]
    lanes = lanes_like(mask, n)
    idx = torch.min(torch.where(mask, lanes, n))
    return torch.where(idx < n, idx, fallback)


def pick_lane(arr, idx):
    """arr[idx] along axis 0 as a one-hot masked sum; zero out of range."""
    mask = (lanes_like(arr, arr.shape[0]) == idx).reshape(
        (arr.shape[0],) + (1,) * (arr.dim() - 1))
    if arr.dtype == torch.bool:
        return torch.any(mask & arr, dim=0)
    return torch.sum(torch.where(mask, arr, 0.0), dim=0)


# -- ops/clipping.py ---------------------------------------------------------

def clip_polygon(v, vertex_count: int):
    """Clip a convex polygon ((MAXV, 3), `vertex_count` lanes used) to
    z >= 0: (vertices with the first repeated, count; 0 if degenerate)."""
    maxv = v.shape[0]
    lanes = lanes_like(v, maxv)
    active = lanes < vertex_count
    above = (v[:, 2] > 0.0) & active
    wrap = lanes == vertex_count - 1
    v_next = torch.where(wrap[:, None], v[0], torch.roll(v, -1, 0))
    above_next = (wrap & above[0]) | (~wrap & torch.roll(above, -1, 0))
    emit_cur = above
    emit_int = active & (above != above_next)
    t = v[:, 2] / (v[:, 2] - v_next[:, 2])
    xy = t[:, None] * v_next[:, :2] + (v[:, :2] - t[:, None] * v[:, :2])
    isect = torch.cat([xy, torch.zeros_like(xy[:, :1])], -1)
    counts = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    offsets = cumsum_lanes(counts) - counts
    out_count = torch.sum(counts)
    match_cur = emit_cur[:, None] & (offsets[:, None] == lanes[None, :])
    idx_int = offsets + emit_cur.to(torch.int64)
    match_int = emit_int[:, None] & (idx_int[:, None] == lanes[None, :])
    out = torch.sum(torch.where(match_cur[..., None], v[:, None, :], 0.0), 0)
    out = out + torch.sum(torch.where(match_int[..., None],
                                      isect[:, None, :], 0.0), 0)
    out_count = torch.where(out_count >= 3, out_count, 0)
    out = torch.where((lanes >= out_count)[:, None], out[0], out)
    out = torch.where(out_count == 0, torch.zeros_like(out), out)
    return out, out_count


# -- ops/sampling.py: projected solid angle sampling -----------------------

class PsaPolygon(NamedTuple):
    vertex_count: torch.Tensor
    vertices: torch.Tensor        # (MAXV, 2)
    ellipses: torch.Tensor        # (MAXV, 2)
    inner_ellipse_0: torch.Tensor  # (2,)
    sector_inner: torch.Tensor    # (MAXV, 2)
    sector_outer: torch.Tensor    # (MAXV, 2)
    sector_psa: torch.Tensor      # (MAXV,)
    projected_solid_angle: torch.Tensor


def rotate_90(v):
    return torch.stack([-v[..., 1], v[..., 0]], -1)


def ellipse_from_edge(vertex_0, vertex_1):
    normal = cross_stable(vertex_0, vertex_1)
    nz = normal[..., 2]
    scaling = 1.0 / torch.where(nz != 0.0, nz, 1.0)
    scaling = torch.where(torch.signbit(normal[..., 0]), -scaling, scaling)
    ellipse = normal[..., :2] * scaling[..., None]
    ex = torch.where(nz != 0.0, ellipse[..., 0], INF)
    return torch.stack([ex, ellipse[..., 1]], -1)


def ellipse_transform(ellipse, point):
    return torch.sum(ellipse * point, -1, keepdim=True) * ellipse + point


def ellipse_det(ellipse):
    return ellipse[..., 0] * ellipse[..., 0] \
        + ellipse[..., 1] * ellipse[..., 1] + 1.0


def ellipse_rsqrt_det(ellipse):
    return 1.0 / torch.sqrt(ellipse_det(ellipse))


def direction_factor_rsq(ellipse, direction):
    e_dot_d = dot(ellipse, direction)
    return e_dot_d * e_dot_d + dot(direction, direction)


def direction_factor(ellipse, direction):
    return 1.0 / torch.sqrt(direction_factor_rsq(ellipse, direction))


def normalized_direction_factor(ellipse, normalized_dir):
    e_dot_d = dot(ellipse, normalized_dir)
    return 1.0 / torch.sqrt(e_dot_d * e_dot_d + 1.0)


def area_between_from_tangents(inner_rsqrt_det, inner_tangent,
                               outer_rsqrt_det, outer_tangent):
    inner_area = inner_rsqrt_det * positive_atan(inner_tangent)
    result = outer_rsqrt_det * positive_atan(outer_tangent) - inner_area
    return torch.where(result > 0.0, 0.5 * result, 0.0)


def area_between_ellipses_in_sector(inner, inner_rsqrt_det, outer,
                                    outer_rsqrt_det, dir_0, dir_1):
    det_dirs = torch.clamp(dot(dir_1, rotate_90(dir_0)), min=0.0)
    inner_dot = inner_rsqrt_det * dot(dir_0, ellipse_transform(inner, dir_1))
    outer_dot = outer_rsqrt_det * dot(dir_0, ellipse_transform(outer, dir_1))
    return area_between_from_tangents(inner_rsqrt_det, det_dirs / inner_dot,
                                      outer_rsqrt_det, det_dirs / outer_dot)


def ellipse_area_in_sector(ellipse, dir_0, dir_1):
    rsqrt_det = ellipse_rsqrt_det(ellipse)
    det_dirs = torch.clamp(dot(dir_1, rotate_90(dir_0)), min=0.0)
    ellipse_dot = rsqrt_det * dot(dir_0, ellipse_transform(ellipse, dir_1))
    area = 0.5 * rsqrt_det * positive_atan(det_dirs / ellipse_dot)
    return torch.where(rsqrt_det > 0.0, area, 0.0)


def sort_convex_polygon_vertices(vertices, ellipses, count):
    """Counterclockwise by a pseudo-angle about vertex 0, the stable rank
    of each lane applied as a one-hot permutation."""
    maxv = vertices.shape[0]
    lanes = lanes_like(vertices, maxv)
    active = lanes < count
    ref = vertices[0]
    crossed = kahan(ref[0], vertices[:, 1], ref[1], vertices[:, 0])
    dotted = ref[0] * vertices[:, 0] + ref[1] * vertices[:, 1]
    p = dotted / (torch.abs(dotted) + torch.abs(crossed) + 1e-37)
    keys = torch.where(torch.signbit(crossed), p - 1.0, 1.0 - p)
    keys = torch.where(active, keys, 4.0)
    kj, kk = keys[:, None], keys[None, :]
    before = (kj < kk) | ((kj == kk) & (lanes[:, None] < lanes[None, :]))
    rank = torch.sum(before.to(torch.int64), 0)
    perm = rank[None, :] == lanes[:, None]
    sorted_v = torch.sum(torch.where(perm[..., None], vertices[None], 0.0), 1)
    sorted_e = torch.sum(torch.where(perm[..., None], ellipses[None], 0.0), 1)
    return sorted_v, sorted_e


def prepare_psa(vertices, vertex_count) -> PsaPolygon:
    """vertices (MAXV, 3) with the normal at +z, clipped to z >= 0, the
    first repeated in unused lanes, clockwise as seen from the origin."""
    maxv = vertices.shape[0]
    count = torch.clamp(vertex_count, min=3)
    lanes = lanes_like(vertices, maxv)
    active = lanes < count
    next_v = torch.roll(vertices, -1, 0)
    raw = ellipse_from_edge(vertices, next_v)
    raw_inner = torch.signbit(raw[:, 0])
    last_raw = pick_lane(raw, count - 1)
    last_inner = pick_lane(raw_inner, count - 1)
    lane0 = lanes == 0
    prev_raw = torch.where(lane0[:, None], last_raw, torch.roll(raw, 1, 0))
    prev_inner = (lane0 & last_inner) | (~lane0 & torch.roll(raw_inner, 1, 0))
    ellipses = torch.where(raw_inner[:, None], prev_raw, raw)
    transition = active & prev_inner & ~raw_inner
    has_transition = torch.any(transition)
    first_trans = transition & (cumsum_lanes(transition.to(torch.int64)) == 1)
    picked = torch.sum(torch.where(first_trans[:, None], prev_raw, 0.0), 0)
    inner_ellipse_0 = torch.where(
        has_transition, picked,
        torch.tensor([1.0, 0.0], device=vertices.device))
    central = inner_ellipse_0[0] > 0.0

    v_xy = vertices[:, :2]
    next_xy = next_v[:, :2]
    central_psa = torch.where(
        active, ellipse_area_in_sector(ellipses, v_xy, next_xy), 0.0)

    sorted_v, sorted_e = sort_convex_polygon_vertices(v_xy, ellipses, count)
    inner_e, outer_e = inner_ellipse_0, sorted_e[0]
    sector_inner, sector_outer = [], []
    for i in range(maxv - 1):
        if i > 0:
            vertex_e = sorted_e[i]
            vertex_is_inner = torch.signbit(vertex_e[0])
            inner_e = torch.where(vertex_is_inner, vertex_e, inner_e)
            outer_e = torch.where(vertex_is_inner, outer_e, vertex_e)
        sector_inner.append(inner_e)
        sector_outer.append(outer_e)
    sector_inner = torch.stack(sector_inner + [sector_inner[-1]], 0)
    sector_outer = torch.stack(sector_outer + [sector_outer[-1]], 0)
    decentral_psa = area_between_ellipses_in_sector(
        sector_inner, ellipse_rsqrt_det(sector_inner),
        sector_outer, ellipse_rsqrt_det(sector_outer),
        sorted_v, torch.roll(sorted_v, -1, 0))
    decentral_psa = torch.where(lanes < count - 1, decentral_psa, 0.0)

    sector_psa = torch.where(central, central_psa, decentral_psa)
    return PsaPolygon(
        vertex_count=count,
        vertices=torch.where(central, v_xy, sorted_v),
        ellipses=torch.where(central, ellipses, sorted_e),
        inner_ellipse_0=inner_ellipse_0,
        sector_inner=sector_inner, sector_outer=sector_outer,
        sector_psa=sector_psa,
        projected_solid_angle=torch.sum(sector_psa))


def normalize_approx_and_flip(rhs, semi_circle):
    scaling = 1.0 / (torch.abs(rhs[..., 0]) + torch.abs(rhs[..., 1]))
    scaling = torch.where(dot(rhs, semi_circle) >= 0.0, scaling, -scaling)
    return scaling[..., None] * rhs


def solve_homogeneous_quadratic(q00, q01, q10, q11):
    coeff_xy = 0.5 * (q01 + q10)
    sqrt_disc = torch.sqrt(torch.clamp(coeff_xy * coeff_xy - q00 * q11,
                                       min=0.0))
    scaled_root = torch.abs(coeff_xy) + sqrt_disc
    root_pos = torch.stack([scaled_root, -q00], -1)
    root_neg = torch.stack([q11, scaled_root], -1)
    return torch.where((coeff_xy >= 0.0)[..., None], root_pos, root_neg)


def outer2(a, b):
    """GLSL outerProduct(a, b) as (M[0][0], M[0][1], M[1][0], M[1][1])."""
    return (a[..., 0] * b[..., 0], a[..., 1] * b[..., 0],
            a[..., 0] * b[..., 1], a[..., 1] * b[..., 1])


def sample_sector_between_ellipses(random_numbers, target_area, inner, outer,
                                   dir_0, dir_1, iteration_count: int = 2):
    q0 = normalize(dir_0)
    q2 = normalize(dir_1)
    q1 = q0 + q2
    nf = [[normalized_direction_factor(inner, q0),
           direction_factor(inner, q1),
           normalized_direction_factor(inner, q2)],
          [normalized_direction_factor(outer, q0),
           direction_factor(outer, q1),
           normalized_direction_factor(outer, q2)]]
    sector_areas = [nf[1][0] * nf[1][1] - nf[0][0] * nf[0][1],
                    nf[1][1] * nf[1][2] - nf[0][1] * nf[0][2]]
    target_quad_area = mix_fma(-sector_areas[0], sector_areas[1],
                               random_numbers[0])
    first_half = target_quad_area <= 0.0
    q2 = torch.where(first_half, q0, q2)
    nf02 = torch.where(first_half, nf[0][0], nf[0][2])
    nf12 = torch.where(first_half, nf[1][0], nf[1][2])
    target_quad_area = target_quad_area + torch.where(
        first_half, sector_areas[0], -sector_areas[1])
    target_quad_area = target_quad_area * torch.abs(
        q1[0] * q2[1] - q1[1] * q2[0])
    quad_normal_inner = ellipse_transform(inner, q1 * nf[0][1] + q2 * nf02)
    quad_normal_outer = ellipse_transform(outer, q1 * nf[1][1] + q2 * nf12)
    quad_offset_inner = dot(quad_normal_inner, q1) * nf[0][1]
    quad_offset_outer = dot(quad_normal_outer, q1) * nf[1][1]
    a = (quad_offset_outer * nf12)[..., None] * rotate_90(q2)
    q00, q01, q10, q11 = outer2(a, quad_normal_inner)
    b = (quad_offset_inner * nf02)[..., None] * rotate_90(q2) \
        + target_quad_area[..., None] * quad_normal_inner
    p00, p01, p10, p11 = outer2(b, quad_normal_outer)
    current_dir = solve_homogeneous_quadratic(q00 - p00, q01 - p01,
                                              q10 - p10, q11 - p11)
    # Boundary random numbers would destabilize the iteration.
    stable = torch.abs(random_numbers[0] - 0.5) <= 0.5 - 1.0e-5
    inner_rsqrt_det = ellipse_rsqrt_det(inner)
    outer_rsqrt_det = ellipse_rsqrt_det(outer)
    for _ in range(iteration_count):
        new_dir = normalize_approx_and_flip(current_dir, q1)
        inner_dir = ellipse_transform(inner, new_dir)
        outer_dir = ellipse_transform(outer, new_dir)
        det_dirs = torch.clamp(dot(new_dir, rotate_90(q0)), min=0.0)
        error = target_area - area_between_from_tangents(
            inner_rsqrt_det,
            det_dirs / (inner_rsqrt_det * dot(q0, inner_dir)),
            outer_rsqrt_det,
            det_dirs / (outer_rsqrt_det * dot(q0, outer_dir)))
        a00, a01, a10, a11 = outer2(inner_dir - outer_dir,
                                    rotate_90(new_dir))
        b00, b01, b10, b11 = outer2((2.0 * error)[..., None] * inner_dir,
                                    outer_dir)
        stepped = solve_homogeneous_quadratic(a00 - b00, a01 - b01,
                                              a10 - b10, a11 - b11)
        current_dir = torch.where(stable[..., None], stepped, current_dir)
    current_dir = torch.where((dot(current_dir, q1) >= 0.0)[..., None],
                              current_dir, -current_dir)
    inner_factor = 1.0 / direction_factor_rsq(inner, current_dir)
    outer_factor = 1.0 / direction_factor_rsq(outer, current_dir)
    radius = torch.sqrt(mix_fma(inner_factor, outer_factor,
                                random_numbers[1]))
    return current_dir * radius[..., None]


def select_sector(polygon: PsaPolygon, target, num_sectors):
    cum = cumsum_lanes(polygon.sector_psa)
    valid = lanes_like(cum, cum.shape[0]) < num_sectors
    reached = (target < cum) & valid
    sel = first_true_lane(reached, num_sectors - 1)
    return sel, target - pick_lane(cum, sel - 1)


def sample_psa(polygon: PsaPolygon, random_numbers):
    """A direction (3,) on the upper hemisphere with density proportional
    to its projected solid angle inside the polygon."""
    target = random_numbers[0] * polygon.projected_solid_angle
    central = polygon.inner_ellipse_0[0] > 0.0
    count = polygon.vertex_count
    sel_c, rem_c = select_sector(polygon, target, count)
    outer_c = pick_lane(polygon.ellipses, sel_c)
    dir0_c = pick_lane(polygon.vertices, sel_c)
    sqrt_det = torch.sqrt(ellipse_det(outer_c))
    angle = 2.0 * rem_c * sqrt_det
    dir_c = (torch.cos(angle) * sqrt_det) * dir0_c \
        + torch.sin(angle) * rotate_90(ellipse_transform(outer_c, dir0_c))
    dir_c = dir_c * torch.sqrt(random_numbers[1]
                               / direction_factor_rsq(outer_c, dir_c))
    sel_d, rem_d = select_sector(polygon, target, count - 1)
    inner_d = pick_lane(polygon.sector_inner, sel_d)
    outer_d = pick_lane(polygon.sector_outer, sel_d)
    dir0_d = pick_lane(polygon.vertices, sel_d)
    dir1_d = pick_lane(polygon.vertices, sel_d + 1)
    sector_psa = pick_lane(polygon.sector_psa, sel_d)
    r0 = rem_d / torch.where(sector_psa > 0.0, sector_psa, 1.0)
    dir_d = sample_sector_between_ellipses(
        torch.stack([r0, random_numbers[1]]), rem_d, inner_d, outer_d,
        dir0_d, dir1_d, 2)
    xy = torch.where(central, dir_c, dir_d)
    z = torch.sqrt(torch.clamp(1.0 - xy[0] * xy[0] - xy[1] * xy[1], min=0.0))
    return torch.cat([xy, z[None]])


# -- ops/brdf.py, ops/ltc.py, ops/mis.py -----------------------------------

class ShadingData(NamedTuple):
    position: torch.Tensor
    normal: torch.Tensor
    outgoing: torch.Tensor
    lambert_outgoing: torch.Tensor
    diffuse_albedo: torch.Tensor
    fresnel_0: torch.Tensor
    roughness: torch.Tensor


class Ltc(NamedTuple):
    world_to_shading: torch.Tensor   # (3, 4)
    shading_to_cosine: torch.Tensor  # (3, 3)
    world_to_cosine: torch.Tensor    # (3, 4)
    cosine_to_shading: torch.Tensor  # (3, 3)
    albedo: torch.Tensor
    determinant: torch.Tensor


def fresnel_schlick(fresnel_0, fresnel_90, cos_theta):
    flipped = 1.0 - cos_theta
    flipped_sq = flipped * flipped
    return fresnel_0 + (fresnel_90 - fresnel_0) \
        * (flipped_sq * flipped * flipped_sq)


def evaluate_brdf(data: ShadingData, incoming):
    """Disney diffuse plus Frostbite's GGX specular, over pi."""
    half_vector = normalize(incoming + data.outgoing)
    lambert_in = dot(data.normal, incoming)
    out_dot_half = dot(data.outgoing, half_vector)
    fresnel_90 = out_dot_half * out_dot_half * (2.0 * data.roughness) + 0.5
    f_out = fresnel_schlick(1.0, fresnel_90, data.lambert_outgoing)
    f_in = fresnel_schlick(1.0, fresnel_90, lambert_in)
    brdf = (f_out * f_in)[..., None] * data.diffuse_albedo
    normal_dot_half = dot(data.normal, half_vector)
    r_sq = data.roughness * data.roughness
    ggx = (normal_dot_half * r_sq - normal_dot_half) * normal_dot_half + 1.0
    ggx = r_sq / (ggx * ggx)
    lo = data.lambert_outgoing
    masking = lambert_in * torch.sqrt((-lo * r_sq + lo) * lo + r_sq)
    shadowing = lo * torch.sqrt((-lambert_in * r_sq + lambert_in)
                                * lambert_in + r_sq)
    smith = 0.5 / (masking + shadowing)
    fresnel = fresnel_schlick(data.fresnel_0, 1.0,
                              torch.clamp(out_dot_half, 0.0, 1.0)[..., None])
    return (brdf + (ggx * smith)[..., None] * fresnel) * M_INV_PI


def ltc_fetch(table, constants, fresnel_0, roughness, position, normal,
              outgoing) -> Ltc:
    """ops/ltc.py get_ltc_coefficients: a bilinear clamp-to-edge lookup,
    the nearest Fresnel layer."""
    f_factor, f_summand, r_factor, r_summand, i_factor, i_summand = constants
    n_dot_o = dot(normal, outgoing)
    inclination = torch.arccos(torch.clamp(n_dot_o, 0.0, 1.0))
    tex_x = torch.sqrt(torch.clamp(roughness, 0.0, 1.0)) * r_factor \
        + r_summand
    tex_y = inclination * i_factor + i_summand
    layer = torch.clamp(fresnel_0, 0.0, 1.0) * f_factor + f_summand
    layers, height, width = table.shape[:3]
    x = torch.clamp(tex_x * width - 0.5, 0.0, width - 1.0)
    y = torch.clamp(tex_y * height - 0.5, 0.0, height - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    li = torch.clamp(torch.round(layer).to(torch.int64), 0, layers - 1)
    x1 = torch.clamp(x0 + 1, max=width - 1)
    y1 = torch.clamp(y0 + 1, max=height - 1)
    t00, t01 = table[li, y0, x0], table[li, y0, x1]
    t10, t11 = table[li, y1, x0], table[li, y1, x1]
    top = t00 + fx * (t01 - t00)
    bottom = t10 + fx * (t11 - t10)
    data = top + fy * (bottom - top)
    d0, d1 = data[0:4], data[4:6]
    zero = torch.zeros_like(d0[0])
    m = torch.stack([torch.stack([d0[0], zero, d0[3]]),
                     torch.stack([zero, d0[2], zero]),
                     torch.stack([-d0[1], zero, d1[0]])])
    det_2x2 = d0[0] * d1[0] + d0[1] * d0[3]
    inv_det_2x2 = 1.0 / det_2x2
    m_inv = torch.stack([
        torch.stack([d1[0] * inv_det_2x2, zero, -d0[3] * inv_det_2x2]),
        torch.stack([zero, 1.0 / d0[2], zero]),
        torch.stack([d0[1] * inv_det_2x2, zero, d0[0] * inv_det_2x2])])
    x_axis = normalize(-n_dot_o * normal + outgoing)
    y_axis = cross(normal, x_axis)
    rotation = torch.stack([x_axis, y_axis, normal])
    translation = -torch.stack([dot(x_axis, position), dot(y_axis, position),
                                dot(normal, position)])
    w2s = torch.cat([rotation, translation[:, None]], 1)
    w2c = torch.stack([d0[0] * w2s[0] + d0[3] * w2s[2], d0[2] * w2s[1],
                       -d0[1] * w2s[0] + d1[0] * w2s[2]])
    return Ltc(w2s, m, w2c, m_inv, d1[1], d0[2] * det_2x2)


def ltc_density(ltc: Ltc, dir_shading, rcp_projected_solid_angle):
    dir_cos = torch.sum(ltc.shading_to_cosine * dir_shading[None, :], -1)
    len_sq = dot(dir_cos, dir_cos)
    density = torch.clamp(dir_cos[2], min=0.0) * ltc.determinant \
        / (len_sq * len_sq)
    return density * rcp_projected_solid_angle


def mis_optimal_clamped(integrand, sampled_weight, sampled_density,
                        other_weight, other_density, visibility_estimate):
    balance = 1.0 / (sampled_density + other_density)
    weighted_sum = sampled_weight * sampled_density \
        + other_weight * other_density
    weighted_wod = sampled_weight / weighted_sum
    mixed = -visibility_estimate * balance + balance
    mixed = visibility_estimate * weighted_wod + mixed
    return mixed * integrand


# -- shading data (render/shading.py, render/texture.py) --------------------

def bilinear_wrap(atlas, tex, level, uv):
    w = atlas.width[tex, level]
    h = atlas.height[tex, level]
    offset = atlas.offset[tex, level]
    x = uv[0] * w.to(torch.float32) - 0.5
    y = uv[1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def fetch(xi, yi):
        return atlas.texels[offset + torch.remainder(yi, h) * w
                            + torch.remainder(xi, w)]
    t00, t10 = fetch(x0i, y0i), fetch(x0i + 1, y0i)
    t01, t11 = fetch(x0i, y0i + 1), fetch(x0i + 1, y0i + 1)
    top = t00 + fx * (t10 - t00)
    bottom = t01 + fx * (t11 - t01)
    return top + fy * (bottom - top)


def sample_texture_grad(atlas, tex, uv, duv_dx, duv_dy):
    """textureGrad with the isotropic footprint: trilinear at
    log2 of the larger scaled derivative."""
    scale = torch.stack([atlas.width[tex, 0], atlas.height[tex, 0]]) \
        .to(torch.float32)
    dx, dy = duv_dx * scale, duv_dy * scale
    rho_max = torch.clamp(torch.maximum(torch.sqrt(dot(dx, dx)),
                                        torch.sqrt(dot(dy, dy))), min=1e-12)
    max_level = (atlas.count[tex] - 1).to(torch.float32)
    lod = torch.minimum(torch.clamp(torch.log2(rho_max), min=0.0), max_level)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, atlas.count[tex] - 1)
    frac = lod - l0.to(torch.float32)
    c0 = bilinear_wrap(atlas, tex, l0, uv)
    c1 = bilinear_wrap(atlas, tex, l1, uv)
    return c0 + frac * (c1 - c0)


def shading_data(atlas, camera_position, dcam, roughness_factor, positions,
                 normals, tex_coords, material, ray_direction) -> ShadingData:
    """The hit triangle's shading data at the view ray's hit
    (geometry_attributes and finish_shading_data, one trilinear tap)."""
    edge0 = positions[1] - positions[0]
    edge1 = positions[2] - positions[0]
    ray_cross_e1 = cross(ray_direction, edge1)
    rcp_det = 1.0 / dot(edge0, ray_cross_e1)
    ray_to_0 = camera_position - positions[0]
    det_0 = dot(ray_to_0, ray_cross_e1)
    b1 = rcp_det * det_0
    e0_cross_0 = cross(edge0, ray_to_0)
    det_1 = dot(ray_direction, e0_cross_0)
    b2 = -rcp_det * det_1
    b0 = 1.0 - (b1 + b2)
    derivs = []
    for i in range(2):
        dd = dcam[i]
        ray_cross_e1_d = cross(dd, edge1)
        rcp_det_d = -dot(edge0, ray_cross_e1_d) * rcp_det * rcp_det
        det_0_d = dot(ray_to_0, ray_cross_e1_d)
        db1 = rcp_det_d * det_0 + rcp_det * det_0_d
        det_1_d = dot(dd, e0_cross_0)
        db2 = -rcp_det_d * det_1 - rcp_det * det_1_d
        derivs.append(torch.stack([-(db1 + db2), db1, db2]))
    position = b0 * positions[0] + b1 * positions[1] + b2 * positions[2]
    normal_interp = normalize(b0 * normals[0] + b1 * normals[1]
                              + b2 * normals[2])
    tex_coord = b0 * tex_coords[0] + b1 * tex_coords[1] + b2 * tex_coords[2]
    duv = [torch.sum(d[:, None] * tex_coords, 0) for d in derivs]
    edges = [positions[1] - positions[0], positions[2] - positions[0]]
    tex_edges = [tex_coords[1] - tex_coords[0], tex_coords[2] - tex_coords[0]]
    normal_cross_e0 = cross(normal_interp, edges[0])
    e1_cross_normal = cross(edges[1], normal_interp)
    tangent = e1_cross_normal * tex_edges[0][0] \
        + normal_cross_e0 * tex_edges[1][0]
    bitangent = e1_cross_normal * tex_edges[0][1] \
        + normal_cross_e0 * tex_edges[1][1]
    mean_tangent_length = torch.sqrt(0.5 * (dot(tangent, tangent)
                                            + dot(bitangent, bitangent)))

    texel = sample_texture_grad(atlas, material, tex_coord, duv[0], duv[1])
    base_color = texel[0:3]
    specular_data = texel[3:6]
    normal_ts_xy = texel[6:8] * 2.0 - 1.0
    normal_ts_z = torch.sqrt(torch.clamp(
        1.0 - normal_ts_xy[0] ** 2 - normal_ts_xy[1] ** 2, min=0.0))
    metalicity = specular_data[2]
    diffuse_albedo = base_color - metalicity * base_color
    fresnel_0 = (1.0 - metalicity) * 0.02 + metalicity * base_color
    roughness = specular_data[1] * specular_data[1]
    roughness = torch.clamp(roughness * roughness_factor, 0.0064, 1.0)
    nz = normal_ts_z * torch.clamp(mean_tangent_length, min=1.0e-10)
    normal = normalize(normal_ts_xy[0] * tangent + normal_ts_xy[1] * bitangent
                       + nz * normal_interp)
    outgoing = normalize(camera_position - position)
    normal_offset = torch.clamp(1.0e-3 - dot(normal, outgoing), min=0.0)
    normal = normalize(normal_offset * outgoing + normal)
    return ShadingData(position, normal, outgoing, dot(normal, outgoing),
                       diffuse_albedo, fresnel_0, roughness)


def light_hit(plane, vertices, vertex_count: int, origin, ray_end):
    """Whether the segment (a point end, w 1) or ray (a direction, w 0)
    from `origin` crosses the convex light polygon."""
    o_dot = dot(plane[:3], origin) + plane[3]
    e_dot = dot(plane[:3], ray_end[:3]) + plane[3] * ray_end[3]
    opposite = o_dot * e_dot <= 0.0
    ray_dir = ray_end[:3] - ray_end[3] * origin
    rel = vertices - origin[None, :]
    signs = torch.sum(ray_dir[None, :] * cross(rel, torch.roll(rel, -1, 0)),
                      -1)
    lanes = lanes_like(vertices, vertices.shape[0])
    prev_signs = torch.cat([torch.zeros_like(signs[:1]), signs[:-1]])
    ok = (prev_signs * signs >= 0.0) | ((lanes >= 3) & (lanes >= vertex_count))
    return opposite & torch.all(ok)


# -- per-light shading (evaluate_polygonal_light_shading) -------------------

def light_shading(settings, data: ShadingData, ltc: Ltc, plane, vertices,
                  vertex_count: int, radiance, pairs, mis_estimate: float):
    """One light at one pixel under projected solid angle sampling:
    (base (3,), b (S, 3), directions (S, 3), t_max (S,)), each sample's
    share over the sample count; the light's part of the color is
    base + sum_s b_s V_s, V_s the visibility of shadow ray s."""
    strategy = settings.sampling_strategy
    n = settings.sample_count
    verts = torch.cat([vertices, vertices[:1]], 0)  # MAXL -> MAXV lanes

    def rad_brdf(d):
        lambert = dot(data.normal, d)
        visible = lambert > 0.0
        denom = dot(d, plane[:3])
        t_max = -(dot(plane[:3], data.position) + plane[3]) \
            / torch.where(denom != 0.0, denom, 1.0)
        value = torch.where(visible, radiance * evaluate_brdf(data, d), 0.0)
        return value, lambert, torch.where(visible, t_max, 0.0)

    side = dot(plane[:3], data.position) + plane[3]
    flip = torch.where(side < 0.0, -1.0, 1.0)
    w2s = torch.cat([ltc.world_to_shading[:1], ltc.world_to_shading[1:2]
                     * flip, ltc.world_to_shading[2:]], 0)
    w2c = torch.cat([ltc.world_to_cosine[:1], ltc.world_to_cosine[1:2]
                     * flip, ltc.world_to_cosine[2:]], 0)
    rot_t = w2s[:, :3]

    def local(world_to_local):
        return verts @ world_to_local[:, :3].T + world_to_local[:, 3]
    clipped, clip_count = clip_polygon(local(w2s), vertex_count)
    poly_d = prepare_psa(clipped, clip_count)
    psa_d = poly_d.projected_solid_angle
    diffuse_ok = (clip_count > 0) & (psa_d > 0.0)

    if strategy == "DIFFUSE_ONLY":
        def one_sample(rnd):
            d_shading = sample_psa(poly_d, rnd)
            density = d_shading[2] / torch.where(psa_d > 0.0, psa_d, 1.0)
            d = rot_t.T @ d_shading
            value, lambert, t_max = rad_brdf(d)
            b = torch.where(density > 0.0, value * (lambert / torch.where(
                density > 0.0, density, 1.0)), 0.0)
            return (torch.where(diffuse_ok, b, 0.0)[None], d[None],
                    t_max[None])
        b, dirs, t_max = torch.vmap(one_sample)(pairs[:n])
        return (torch.zeros_like(radiance), b.reshape(-1, 3) * (1.0 / n),
                dirs.reshape(-1, 3), t_max.reshape(-1))

    clipped_c, clip_count_c = clip_polygon(local(w2c), vertex_count)
    poly_s = prepare_psa(clipped_c, clip_count_c)
    psa_s = torch.where(clip_count_c > 0, poly_s.projected_solid_angle, 0.0)
    specular_ok = psa_s > 0.0
    diffuse_weight = torch.clamp(data.diffuse_albedo, min=0.01) * psa_d
    specular_weight = (ltc.albedo * psa_s).expand(3)
    rcp_psa_d = 1.0 / torch.where(psa_d > 0.0, psa_d, 1.0)
    rcp_psa_s = 1.0 / torch.where(psa_s > 0.0, psa_s, 1.0)

    def one_sample(pair2):
        d_diffuse = sample_psa(poly_d, pair2[0])
        d_specular = normalize(ltc.cosine_to_shading
                               @ sample_psa(poly_s, pair2[1]))
        a_out = torch.zeros_like(radiance)
        b_out, dir_out, t_out = [], [], []
        for j, d_shading in enumerate((d_diffuse, d_specular)):
            in_upper = d_shading[2] > 0.0
            diffuse_density = d_shading[2] * rcp_psa_d
            specular_density = ltc_density(ltc, d_shading, rcp_psa_s)
            d_world = rot_t.T @ d_shading
            value, _, t_max = rad_brdf(d_world)
            integrand = d_shading[2] * value
            weights = (diffuse_weight, diffuse_density, specular_weight,
                       specular_density) if j == 0 else \
                (specular_weight, specular_density, diffuse_weight,
                 diffuse_density)
            # Affine in the visibility: est(0) and the ray's weight.
            est0 = mis_optimal_clamped(torch.zeros_like(integrand), *weights,
                                       mis_estimate)
            est1 = mis_optimal_clamped(integrand, *weights, mis_estimate)
            if j == 0:
                no_mis = integrand / torch.where(diffuse_density > 0.0,
                                                 diffuse_density, 1.0)
                a_term = torch.where(specular_ok, est0, 0.0)
                b_term = torch.where(specular_ok, est1 - est0, no_mis)
                gate = in_upper & diffuse_ok
            else:
                a_term, b_term = est0, est1 - est0
                gate = in_upper & diffuse_ok & specular_ok
            a_out = a_out + torch.where(gate, a_term, 0.0)
            b_out.append(torch.where(gate, b_term, 0.0))
            dir_out.append(d_world)
            t_out.append(t_max)
        return a_out, torch.stack(b_out), torch.stack(dir_out), \
            torch.stack(t_out)
    a, b, dirs, t_max = torch.vmap(one_sample)(pairs[:2 * n].reshape(n, 2, 2))
    return (torch.sum(a, 0) * (1.0 / n), b.reshape(-1, 3) * (1.0 / n),
            dirs.reshape(-1, 3), t_max.reshape(-1))


def pairs_per_light(settings) -> int:
    if settings.sampling_strategy not in STRATEGIES:
        raise NotImplementedError(
            f"the reference renders {STRATEGIES}, not "
            f"{settings.sampling_strategy}")
    per_sample = 1 if settings.sampling_strategy == "DIFFUSE_ONLY" else 2
    return settings.sample_count * per_sample
