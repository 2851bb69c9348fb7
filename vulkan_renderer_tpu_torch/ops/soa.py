"""Shading math in plain PyTorch, structure-of-arrays: the plain version of
kernel K4 (csrc/fused_shading.cu).

Counterpart of vulkan_renderer_tpu/ops/soa.py, function by function and
operation by operation:

- a per-pixel scalar is a PLANE: a (P,) float32 / bool / int32 tensor;
- a 2/3-vector is a TUPLE of planes;
- a polygon is a python LIST of vector tuples (vertex lanes unrolled);
- every structural index (lane, component, sample) is a Python int.

The CUDA kernel runs the same operations in the same order on scalars
(one thread per pixel), so the two agree to rounding on the card. The
atan here is the Cephes polynomial of the JAX package (math_utils.atan_f32),
not torch.atan, so the port and the reference share one formula.
"""

from __future__ import annotations

import numpy as np
import torch

from .math_utils import (M_HALF_PI, M_PI, atan_f32, fast_positive_atan,
                         two_product)

# 0.5 - acceptable error, rounded in float32 as the reference computes it.
_STABLE_LIMIT = float(np.float32(0.5) - np.float32(1.0e-5))

# ---------------------------------------------------------------------------
# Plane/vector helpers
# ---------------------------------------------------------------------------


def vwh(c, a, b):
    """Component-wise where over vector tuples."""
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def vadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def vsub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def vscale(s, a):
    return tuple(s * x for x in a)


def vdot(a, b):
    acc = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        acc = acc + x * y
    return acc


def vneg(a):
    return tuple(-x for x in a)


def vnormalize(a):
    return vscale(torch.rsqrt(vdot(a, a)), a)


def kahan_soa(a, b, c, d):
    """a*b - c*d via error-free two_product."""
    p1, e1 = two_product(a, b)
    p2, e2 = two_product(c, d)
    return (p1 - p2) + (e1 - e2)


def cross3(a, b):
    """Stable cross product (math_utils cross_stable)."""
    return (kahan_soa(a[1], b[2], a[2], b[1]),
            kahan_soa(a[2], b[0], a[0], b[2]),
            kahan_soa(a[0], b[1], a[1], b[0]))


def cross3_fast(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def rot90(v):
    return (-v[1], v[0])


def mix_fma(x, y, a):
    return a * y + (x - a * x)


def positive_atan_soa(t, biased: bool):
    if biased:
        return fast_positive_atan(t)
    return atan_f32(t) + torch.where(t < 0.0, M_PI, 0.0)


def atan2_soa(y, x):
    """arctan2 built on the Cephes atan, as the JAX package's atan2_soa:
    every azimuth of the port comes through one formula."""
    base = atan_f32(y / torch.where(x != 0.0, x, 1.0))
    # x < 0: shift by +/- pi toward y's sign (atan2(+-0, -1) = +-pi).
    neg_y = (y < 0.0) | (torch.signbit(y) & (y == 0.0))
    shifted = base + torch.where(neg_y, -M_PI, M_PI)
    res = torch.where(x > 0.0, base, shifted)
    on_axis = torch.where(
        y == 0.0,
        torch.where(x >= 0.0, 0.0, torch.where(neg_y, -M_PI, M_PI)),
        torch.where(y > 0.0, M_HALF_PI, -M_HALF_PI))
    return torch.where(x == 0.0,
                       torch.where(y == 0.0, torch.zeros_like(base),
                                   on_axis),
                       torch.where(y == 0.0, on_axis, res))


def acos_soa(x):
    """acos(x) = atan2(sqrt(1 - x^2), x) (the JAX package's acos_soa)."""
    return atan2_soa(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)


# ---------------------------------------------------------------------------
# Polygon clipping to z >= 0 (polygon_clipping.glsl:19-225)
# ---------------------------------------------------------------------------


def clip_soa(verts, n: int):
    """Clip a convex polygon with static vertex count n to z >= 0.

    verts: list of n vec3 tuples. Returns (out, count): out is a list of
    n+1 vec3 tuples (first vertex repeated in unused lanes, zeros when
    fully clipped), count an int32 plane in {0, 3..n+1}."""
    above = [verts[k][2] > 0.0 for k in range(n)]
    zero = torch.zeros_like(verts[0][0])
    isect = []
    emit_int = []
    for k in range(n):
        v0, v1 = verts[k], verts[(k + 1) % n]
        crosses = above[k] != above[(k + 1) % n]
        emit_int.append(crosses)
        t = v0[2] / torch.where(crosses, v0[2] - v1[2], 1.0)
        isect.append((t * v1[0] + (v0[0] - t * v0[0]),
                      t * v1[1] + (v0[1] - t * v0[1]), zero))

    cur_i = [above[k].to(torch.int32) for k in range(n)]
    int_i = [emit_int[k].to(torch.int32) for k in range(n)]
    offsets = []
    running = torch.zeros_like(cur_i[0])
    for k in range(n):
        offsets.append(running)
        running = running + cur_i[k] + int_i[k]
    total = running

    zero3 = (zero, zero, zero)
    out = []
    for j in range(n + 1):
        acc = zero3
        for k in range(n):
            acc = vadd(acc, vwh(above[k] & (offsets[k] == j), verts[k],
                                zero3))
            acc = vadd(acc, vwh(emit_int[k] & (offsets[k] + cur_i[k] == j),
                                isect[k], zero3))
        out.append(acc)

    count = torch.where(total >= 3, total, 0)
    for j in range(1, n + 1):
        out[j] = vwh(count <= j, out[0], out[j])
    return out, count


# ---------------------------------------------------------------------------
# Ellipse helpers (polygon_sampling.glsl:236-412)
# ---------------------------------------------------------------------------


def ellipse_from_edge_soa(v0, v1):
    n = cross3(v0, v1)
    nz_ok = n[2] != 0.0
    scaling = 1.0 / torch.where(nz_ok, n[2], 1.0)
    scaling = torch.where(torch.signbit(n[0]), -scaling, scaling)
    return (torch.where(nz_ok, n[0] * scaling, float("inf")),
            n[1] * scaling)


def ellipse_transform_soa(e, p):
    d = e[0] * p[0] + e[1] * p[1]
    return (d * e[0] + p[0], d * e[1] + p[1])


def ellipse_det_soa(e):
    return e[0] * e[0] + e[1] * e[1] + 1.0


def ellipse_rsqrt_det_soa(e):
    return torch.rsqrt(ellipse_det_soa(e))


def ellipse_dir_factor_rsq_soa(e, d):
    ed = e[0] * d[0] + e[1] * d[1]
    return ed * ed + d[0] * d[0] + d[1] * d[1]


def ellipse_dir_factor_soa(e, d):
    return torch.rsqrt(ellipse_dir_factor_rsq_soa(e, d))


def ellipse_normalized_dir_factor_soa(e, d):
    ed = e[0] * d[0] + e[1] * d[1]
    return torch.rsqrt(ed * ed + 1.0)


def _area_between_from_tangents_soa(inner_rsd, inner_tan, outer_rsd,
                                    outer_tan, biased):
    inner_area = inner_rsd * positive_atan_soa(inner_tan, biased)
    result = outer_rsd * positive_atan_soa(outer_tan, biased) - inner_area
    return torch.where(result > 0.0, 0.5 * result, 0.0)


def area_between_ellipses_in_sector_soa(inner_e, inner_rsd, outer_e,
                                        outer_rsd, d0, d1, biased):
    det_dirs = torch.clamp(d1[0] * (-d0[1]) + d1[1] * d0[0], min=0.0)
    it = ellipse_transform_soa(inner_e, d1)
    ot = ellipse_transform_soa(outer_e, d1)
    inner_dot = inner_rsd * (d0[0] * it[0] + d0[1] * it[1])
    outer_dot = outer_rsd * (d0[0] * ot[0] + d0[1] * ot[1])
    return _area_between_from_tangents_soa(
        inner_rsd, det_dirs / inner_dot, outer_rsd, det_dirs / outer_dot,
        biased)


def ellipse_area_in_sector_soa(e, d0, d1, biased):
    rsd = ellipse_rsqrt_det_soa(e)
    det_dirs = torch.clamp(d1[0] * (-d0[1]) + d1[1] * d0[0], min=0.0)
    et = ellipse_transform_soa(e, d1)
    e_dot = rsd * (d0[0] * et[0] + d0[1] * et[1])
    area = 0.5 * rsd * positive_atan_soa(det_dirs / e_dot, biased)
    return torch.where(rsd > 0.0, area, 0.0)


# ---------------------------------------------------------------------------
# PSA sampling preparation (polygon_sampling.glsl:521-589)
# ---------------------------------------------------------------------------


class PsaPolySoa:
    """Prepared PSA polygon: lists of planes/tuples."""
    __slots__ = ("m", "count", "vertices", "ellipses", "sector_inner",
                 "sector_outer", "sector_psa", "psa", "central")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def prepare_psa_soa(verts, count, m: int, biased: bool):
    """verts: list of m vec3 tuples (clip_soa output); count: int32 plane
    in {0, 3..m}. The fully clipped case (count 0) is gated by the caller
    through psa == 0."""
    count = torch.clamp(count, min=3)
    zero = torch.zeros_like(verts[0][0])
    active = [count > k for k in range(m)]

    raw = [ellipse_from_edge_soa(verts[k], verts[(k + 1) % m])
           for k in range(m)]
    raw_inner = [torch.signbit(raw[k][0]) for k in range(m)]

    # Lane k's previous edge: lane count-1 for k == 0, else k-1.
    last_raw = (zero, zero)
    last_inner = torch.zeros_like(active[0])
    for k in range(m):
        is_last = count - 1 == k
        last_raw = vwh(is_last, raw[k], last_raw)
        last_inner = (is_last & raw_inner[k]) | (~is_last & last_inner)
    prev_raw = [last_raw] + raw[:-1]
    prev_inner = [last_inner] + raw_inner[:-1]

    ellipses = [vwh(raw_inner[k], prev_raw[k], raw[k]) for k in range(m)]

    # The first inner->outer transition records the dropped inner ellipse.
    picked = (zero, zero)
    seen = torch.zeros_like(active[0])
    for k in range(m):
        trans = active[k] & prev_inner[k] & ~raw_inner[k]
        picked = vwh(trans & ~seen, prev_raw[k], picked)
        seen = seen | trans
    inner0 = vwh(seen, picked, (torch.ones_like(zero), zero))
    central = inner0[0] > 0.0

    v_xy = [(verts[k][0], verts[k][1]) for k in range(m)]

    central_psa = [
        torch.where(active[k],
                    ellipse_area_in_sector_soa(ellipses[k], v_xy[k],
                                               v_xy[(k + 1) % m], biased),
                    0.0)
        for k in range(m)]

    # Decentral case: ccw sort by a tie-preserving pseudo-angle, then a
    # sector walk.
    keys = []
    for k in range(m):
        cr = kahan_soa(v_xy[0][0], v_xy[k][1], v_xy[0][1], v_xy[k][0])
        dt = v_xy[0][0] * v_xy[k][0] + v_xy[0][1] * v_xy[k][1]
        p = dt / (torch.abs(dt) + torch.abs(cr) + 1e-37)
        key = torch.where(cr >= 0.0, 1.0 - p, p - 1.0)
        keys.append(torch.where(active[k], key, 4.0))
    rank = []
    for k in range(m):
        r = torch.zeros_like(count)
        for j in range(m):
            if j < k:
                before = (keys[j] < keys[k]) | (keys[j] == keys[k])
            elif j > k:
                before = keys[j] < keys[k]
            else:
                continue
            r = r + before.to(torch.int32)
        rank.append(r)
    sorted_v = []
    sorted_e = []
    for j in range(m):
        av = (zero, zero)
        ae = (zero, zero)
        for k in range(m):
            sel = rank[k] == j
            av = vwh(sel, v_xy[k], av)
            ae = vwh(sel, ellipses[k], ae)
        sorted_v.append(av)
        # "+ 0.0" canonicalizes -0.0 (the sign bit of a horizon ellipse's
        # x decides inner/outer below), as in the reference.
        sorted_e.append((ae[0] + 0.0, ae[1] + 0.0))

    inner_e = inner0
    outer_e = sorted_e[0]
    sector_inner = []
    sector_outer = []
    for i in range(m - 1):
        if i > 0:
            is_inner = torch.signbit(sorted_e[i][0])
            inner_e = vwh(is_inner, sorted_e[i], inner_e)
            outer_e = vwh(is_inner, outer_e, sorted_e[i])
        sector_inner.append(inner_e)
        sector_outer.append(outer_e)
    sector_inner.append(sector_inner[-1])
    sector_outer.append(sector_outer[-1])

    decentral_psa = []
    for i in range(m - 1):
        a = area_between_ellipses_in_sector_soa(
            sector_inner[i], ellipse_rsqrt_det_soa(sector_inner[i]),
            sector_outer[i], ellipse_rsqrt_det_soa(sector_outer[i]),
            sorted_v[i], sorted_v[i + 1], biased)
        decentral_psa.append(torch.where(count - 1 > i, a, 0.0))
    decentral_psa.append(zero)

    sector_psa = [torch.where(central, central_psa[k], decentral_psa[k])
                  for k in range(m)]
    psa = sector_psa[0]
    for k in range(1, m):
        psa = psa + sector_psa[k]
    return PsaPolySoa(
        m=m, count=count,
        vertices=[vwh(central, v_xy[k], sorted_v[k]) for k in range(m)],
        ellipses=[vwh(central, ellipses[k], sorted_e[k]) for k in range(m)],
        sector_inner=sector_inner, sector_outer=sector_outer,
        sector_psa=sector_psa, psa=psa, central=central)


# ---------------------------------------------------------------------------
# PSA sampling (polygon_sampling.glsl:595-805)
# ---------------------------------------------------------------------------


def _solve_homogeneous_quadratic_soa(q00, q01, q10, q11):
    coeff_xy = 0.5 * (q01 + q10)
    sqrt_disc = torch.sqrt(torch.clamp(coeff_xy * coeff_xy - q00 * q11,
                                       min=0.0))
    scaled_root = torch.abs(coeff_xy) + sqrt_disc
    pos = coeff_xy >= 0.0
    return (torch.where(pos, scaled_root, q11),
            torch.where(pos, -q00, scaled_root))


def _outer2_soa(a, b):
    return a[0] * b[0], a[1] * b[0], a[0] * b[1], a[1] * b[1]


def _normalize_approx_and_flip_soa(rhs, semi_circle):
    scaling = 1.0 / (torch.abs(rhs[0]) + torch.abs(rhs[1]))
    scaling = torch.where(rhs[0] * semi_circle[0] + rhs[1] * semi_circle[1]
                          >= 0.0, scaling, -scaling)
    return (scaling * rhs[0], scaling * rhs[1])


def sample_sector_between_ellipses_soa(r0, r1, target_area, inner_e, outer_e,
                                       dir_0, dir_1, iteration_count: int,
                                       biased: bool):
    """polygon_sampling.glsl:645-739."""
    def norm2(v):
        rl = torch.rsqrt(v[0] * v[0] + v[1] * v[1])
        return (v[0] * rl, v[1] * rl)

    q0 = norm2(dir_0)
    q2 = norm2(dir_1)
    q1 = vadd(q0, q2)

    nf = [[ellipse_normalized_dir_factor_soa(inner_e, q0),
           ellipse_dir_factor_soa(inner_e, q1),
           ellipse_normalized_dir_factor_soa(inner_e, q2)],
          [ellipse_normalized_dir_factor_soa(outer_e, q0),
           ellipse_dir_factor_soa(outer_e, q1),
           ellipse_normalized_dir_factor_soa(outer_e, q2)]]
    sector_areas = [nf[1][0] * nf[1][1] - nf[0][0] * nf[0][1],
                    nf[1][1] * nf[1][2] - nf[0][1] * nf[0][2]]

    target_quad_area = mix_fma(-sector_areas[0], sector_areas[1], r0)
    first_half = target_quad_area <= 0.0
    q2 = vwh(first_half, q0, q2)
    nf02 = torch.where(first_half, nf[0][0], nf[0][2])
    nf12 = torch.where(first_half, nf[1][0], nf[1][2])
    target_quad_area = target_quad_area + torch.where(
        first_half, sector_areas[0], -sector_areas[1])
    target_quad_area = target_quad_area * torch.abs(
        q1[0] * q2[1] - q1[1] * q2[0])

    quad_normal_inner = ellipse_transform_soa(
        inner_e, (q1[0] * nf[0][1] + q2[0] * nf02,
                  q1[1] * nf[0][1] + q2[1] * nf02))
    quad_normal_outer = ellipse_transform_soa(
        outer_e, (q1[0] * nf[1][1] + q2[0] * nf12,
                  q1[1] * nf[1][1] + q2[1] * nf12))
    quad_offset_inner = (quad_normal_inner[0] * q1[0]
                         + quad_normal_inner[1] * q1[1]) * nf[0][1]
    quad_offset_outer = (quad_normal_outer[0] * q1[0]
                         + quad_normal_outer[1] * q1[1]) * nf[1][1]

    r90q2 = rot90(q2)
    q00, q01, q10, q11 = _outer2_soa(
        vscale(quad_offset_outer * nf12, r90q2), quad_normal_inner)
    p00, p01, p10, p11 = _outer2_soa(
        vadd(vscale(quad_offset_inner * nf02, r90q2),
             vscale(target_quad_area, quad_normal_inner)),
        quad_normal_outer)
    current_dir = _solve_homogeneous_quadratic_soa(
        q00 - p00, q01 - p01, q10 - p10, q11 - p11)

    if not biased:
        stable = torch.abs(r0 - 0.5) <= _STABLE_LIMIT
        inner_rsd = ellipse_rsqrt_det_soa(inner_e)
        outer_rsd = ellipse_rsqrt_det_soa(outer_e)
        r90q0 = rot90(q0)
        for _ in range(iteration_count):
            new_dir = _normalize_approx_and_flip_soa(current_dir, q1)
            inner_dir = ellipse_transform_soa(inner_e, new_dir)
            outer_dir = ellipse_transform_soa(outer_e, new_dir)
            det_dirs = torch.clamp(
                new_dir[0] * r90q0[0] + new_dir[1] * r90q0[1], min=0.0)
            error = target_area - _area_between_from_tangents_soa(
                inner_rsd,
                det_dirs / (inner_rsd * (q0[0] * inner_dir[0]
                                         + q0[1] * inner_dir[1])),
                outer_rsd,
                det_dirs / (outer_rsd * (q0[0] * outer_dir[0]
                                         + q0[1] * outer_dir[1])),
                biased)
            a00, a01, a10, a11 = _outer2_soa(vsub(inner_dir, outer_dir),
                                             rot90(new_dir))
            b00, b01, b10, b11 = _outer2_soa(vscale(2.0 * error, inner_dir),
                                             outer_dir)
            stepped = _solve_homogeneous_quadratic_soa(
                a00 - b00, a01 - b01, a10 - b10, a11 - b11)
            current_dir = vwh(stable, stepped, current_dir)

    flip_ok = (current_dir[0] * q1[0] + current_dir[1] * q1[1]) >= 0.0
    current_dir = vwh(flip_ok, current_dir, vneg(current_dir))
    inner_factor = 1.0 / ellipse_dir_factor_rsq_soa(inner_e, current_dir)
    outer_factor = 1.0 / ellipse_dir_factor_rsq_soa(outer_e, current_dir)
    radius = torch.sqrt(mix_fma(inner_factor, outer_factor, r1))
    return vscale(radius, current_dir)


def _select_sector_soa(sector_psa, target, num_sectors, m: int):
    """One-hot select of the first sector whose cumulative PSA exceeds
    target (else the last valid sector). Returns (sel, remaining)."""
    prev = []
    running = torch.zeros_like(target)
    cum = []
    for k in range(m):
        prev.append(running)
        running = running + sector_psa[k]
        cum.append(running)
    any_before = torch.zeros_like(target < 0.0)
    sel = []
    for k in range(m):
        reached = (target < cum[k]) & (num_sectors > k)
        sel.append(reached & ~any_before)
        any_before = any_before | reached
    for k in range(m):
        fallback = num_sectors - 1 == k
        sel[k] = (any_before & sel[k]) | (~any_before & fallback)
    remaining = torch.zeros_like(target)
    for k in range(m):
        remaining = remaining + torch.where(sel[k], target - prev[k], 0.0)
    return sel, remaining


def _pick(sel, values, zero_like):
    acc = zero_like
    for s, v in zip(sel, values):
        acc = torch.where(s, v, acc)
    return acc


def _pick_v(sel, values):
    acc = tuple(torch.zeros_like(c) for c in values[0])
    for s, v in zip(sel, values):
        acc = vwh(s, v, acc)
    return acc


def sample_psa_soa(poly: PsaPolySoa, r0, r1, biased: bool):
    """One PSA sample per pixel; returns a vec3 tuple (x, y, z)."""
    m = poly.m
    target = r0 * poly.psa

    # Central case.
    sel_c, rem_c = _select_sector_soa(poly.sector_psa, target, poly.count, m)
    outer_c = _pick_v(sel_c, poly.ellipses)
    dir0_c = _pick_v(sel_c, poly.vertices)
    sqrt_det = torch.sqrt(ellipse_det_soa(outer_c))
    angle = 2.0 * rem_c * sqrt_det
    r90 = rot90(ellipse_transform_soa(outer_c, dir0_c))
    ca = torch.cos(angle) * sqrt_det
    sa = torch.sin(angle)
    dir_c = (ca * dir0_c[0] + sa * r90[0], ca * dir0_c[1] + sa * r90[1])
    dir_c = vscale(torch.sqrt(
        r1 / ellipse_dir_factor_rsq_soa(outer_c, dir_c)), dir_c)

    # Decentral case.
    sel_d, rem_d = _select_sector_soa(poly.sector_psa, target,
                                      poly.count - 1, m)
    inner_d = _pick_v(sel_d, poly.sector_inner)
    outer_d = _pick_v(sel_d, poly.sector_outer)
    dir0_d = _pick_v(sel_d, poly.vertices)
    dir1_d = _pick_v(sel_d, poly.vertices[1:] + poly.vertices[:1])
    sector_psa = _pick(sel_d, poly.sector_psa, torch.zeros_like(target))
    rr0 = rem_d / torch.where(sector_psa > 0.0, sector_psa, 1.0)
    dir_d = sample_sector_between_ellipses_soa(
        rr0, r1, rem_d, inner_d, outer_d, dir0_d, dir1_d, 2, biased)

    x = torch.where(poly.central, dir_c[0], dir_d[0])
    y = torch.where(poly.central, dir_c[1], dir_d[1])
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return (x, y, z)


# ---------------------------------------------------------------------------
# BRDF (brdfs.glsl:57-88)
# ---------------------------------------------------------------------------


def fresnel_schlick_soa(f0, f90, cos_theta):
    flipped = 1.0 - cos_theta
    fsq = flipped * flipped
    return f0 + (f90 - f0) * (fsq * flipped * fsq)


def evaluate_brdf_soa(normal, outgoing, lambert_out, diffuse_albedo,
                      fresnel_0, roughness, incoming):
    """Frostbite diffuse + GGX specular; returns a vec3 tuple."""
    half = vnormalize(vadd(incoming, outgoing))
    lambert_in = vdot(normal, incoming)
    out_dot_half = vdot(outgoing, half)
    zero = torch.zeros_like(lambert_in)
    brdf = (zero, zero, zero)

    f90 = out_dot_half * out_dot_half * (2.0 * roughness) + 0.5
    ff = fresnel_schlick_soa(1.0, f90, lambert_out) \
        * fresnel_schlick_soa(1.0, f90, lambert_in)
    brdf = vadd(brdf, vscale(ff, diffuse_albedo))

    ndh = vdot(normal, half)
    r_sq = roughness * roughness
    ggx = (ndh * r_sq - ndh) * ndh + 1.0
    ggx = r_sq / (ggx * ggx)
    lo = lambert_out
    masking = lambert_in * torch.sqrt((-lo * r_sq + lo) * lo + r_sq)
    shadowing = lo * torch.sqrt(
        (-lambert_in * r_sq + lambert_in) * lambert_in + r_sq)
    smith = 0.5 / (masking + shadowing)
    codh = torch.clamp(out_dot_half, 0.0, 1.0)
    fr = tuple(fresnel_schlick_soa(f, 1.0, codh) for f in fresnel_0)
    brdf = vadd(brdf, vscale(ggx * smith, fr))
    return vscale(1.0 / M_PI, brdf)


# ---------------------------------------------------------------------------
# LTC density (ltc_utility.glsl:103-108)
# ---------------------------------------------------------------------------


def ltc_density_soa(s2c, det, dir_shading, rcp_psa):
    """s2c: 9 planes row-major (3x3 shading->cosine), det: plane."""
    dx = (s2c[0] * dir_shading[0] + s2c[1] * dir_shading[1]
          + s2c[2] * dir_shading[2])
    dy = (s2c[3] * dir_shading[0] + s2c[4] * dir_shading[1]
          + s2c[5] * dir_shading[2])
    dz = (s2c[6] * dir_shading[0] + s2c[7] * dir_shading[1]
          + s2c[8] * dir_shading[2])
    len_sq = dx * dx + dy * dy + dz * dz
    density = torch.clamp(dz, min=0.0) * det / (len_sq * len_sq)
    return density * rcp_psa


# ---------------------------------------------------------------------------
# MIS estimators (shading_pass.frag.glsl:243-293)
# ---------------------------------------------------------------------------


HEURISTICS = ("balance", "power", "weighted", "optimal_clamped", "optimal")


def mis_estimate_soa(heuristic: str, integrand, sampled_weight,
                     sampled_density, other_weight, other_density,
                     visibility_estimate: float):
    """Weights are vec3 tuples, densities planes; returns a vec3 tuple."""
    if heuristic == "weighted":
        wsum = vadd(vscale(sampled_density, sampled_weight),
                    vscale(other_density, other_weight))
        return tuple(sw * i / ws for sw, i, ws in
                     zip(sampled_weight, integrand, wsum))
    if heuristic in ("optimal_clamped", "optimal"):
        balance = 1.0 / (sampled_density + other_density)
        wsum = vadd(vscale(sampled_density, sampled_weight),
                    vscale(other_density, other_weight))
        if heuristic == "optimal_clamped":
            out = []
            for sw, ws, i in zip(sampled_weight, wsum, integrand):
                mixed = -visibility_estimate * balance + balance
                mixed = visibility_estimate * (sw / ws) + mixed
                out.append(mixed * i)
            return tuple(out)
        return tuple(visibility_estimate * sw
                     + balance * (i - visibility_estimate * ws)
                     for sw, ws, i in zip(sampled_weight, wsum, integrand))
    if heuristic == "balance":
        wod = 1.0 / (sampled_density + other_density)
    elif heuristic == "power":
        wod = sampled_density / (sampled_density * sampled_density
                                 + other_density * other_density)
    else:
        raise ValueError(heuristic)
    return vscale(wod, integrand)
