"""The polygon-sampling techniques other than PSA, structure-of-arrays, in
plain PyTorch: part of the plain version of kernels K4 and K5
(csrc/techniques.cuh).

Counterpart of vulkan_renderer_tpu/ops/soa_techniques.py, function by
function and operation by operation: solid-angle triangle fans (ours and
Arvo's), Urena's spherical rectangles, Turk's uniform area sampling and
Hart's bilinear and biquadratic cosine warps. Planes are (P,) tensors,
vec3s tuples of planes, light data 0-d tensors that broadcast. Loops over
fan triangles and vertices are Python loops over static counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .math_utils import M_PI
from .soa import (acos_soa, atan2_soa, cross3, mix_fma, positive_atan_soa,
                  vadd, vdot, vnormalize, vscale, vsub, vwh)

_SQRT_075 = float(np.float32(np.sqrt(0.75)))
_THIRD = float(np.float32(1.0 / 3.0))


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


# ===========================================================================
# Solid-angle triangle fans (ours): polygon_sampling.glsl:120-224
# ===========================================================================

class SaPolySoa:
    """Prepared fan: per-triangle (simplex_volume, dot_0_2_plus_1_2,
    one_plus_dot_0_1), cumulative solid angles, per-pixel active masks
    (None = always active) and the total solid angle."""

    def __init__(self, dirs, params, fan, active, solid_angle):
        self.dirs = dirs
        self.params = params
        self.fan = fan
        self.active = active
        self.solid_angle = solid_angle


def prepare_sa_soa(dirs, count, m: int, biased: bool = False) -> SaPolySoa:
    """dirs: m normalized vec3s; count: int plane of the per-pixel vertex
    count, or None when all m lanes are active."""
    d0 = dirs[0]
    hh_sign = torch.where(d0[0] > 0.0, -1.0, 1.0)
    rcp = 1.0 / (torch.abs(d0[0]) + 1.0)
    hy = d0[1] * rcp
    hz = d0[2] * rcp

    params, fan, active = [], [], []
    cum = None
    for i in range(m - 2):
        v0 = dirs[i + 1]
        v2 = dirs[i + 2]
        dot01 = vdot(v0, d0)
        dot02 = vdot(v0, v2)
        dot12 = vdot(d0, v2)
        dh0 = -hh_sign * v0[0] + dot01
        dh2 = -hh_sign * v2[0] + dot12
        col00 = -dh0 * hy + v0[1]
        col01 = -dh0 * hz + v0[2]
        col10 = -dh2 * hy + v2[1]
        col11 = -dh2 * hz + v2[2]
        simplex = torch.abs(col00 * col11 - col01 * col10)
        d02p12 = dot02 + dot12
        opd01 = 1.0 + dot01
        tangent = simplex / (opd01 + d02p12)
        sa_i = 2.0 * positive_atan_soa(tangent, biased)
        if count is None:
            act = None
        else:
            act = (i + 2) < torch.clamp(count, min=3)
            sa_i = torch.where(act, sa_i, 0.0)
        params.append((simplex, d02p12, opd01))
        active.append(act)
        cum = sa_i if cum is None else cum + sa_i
        fan.append(cum)
    return SaPolySoa(dirs, params, fan, active, cum)


def _select_fan(poly, values, target, m: int):
    """First fan triangle whose cumulative value reaches target (default:
    the last active one). values[i] is a tuple of planes per triangle.
    Returns (values, prev_fan, v0, v2) of the selected triangle."""
    nt = m - 2
    zero = torch.zeros_like(target)
    sel = values[nt - 1]
    sel_prev = poly.fan[nt - 2] if nt >= 2 else zero
    sel_v0 = poly.dirs[nt]
    sel_v2 = poly.dirs[nt + 1]
    for i in range(nt - 2, -1, -1):
        reach = poly.fan[i] >= target
        if poly.active[i] is not None:
            reach = reach & poly.active[i]
        sel = vwh(reach, values[i], sel)
        prev = poly.fan[i - 1] if i >= 1 else zero
        sel_prev = torch.where(reach, prev, sel_prev)
        sel_v0 = vwh(reach, poly.dirs[i + 1], sel_v0)
        sel_v2 = vwh(reach, poly.dirs[i + 2], sel_v2)
    if poly.active[nt - 1] is not None:
        # Nothing reached the target (fp slop): take the last ACTIVE one.
        last = values[0]
        last_prev = zero
        last_v0 = poly.dirs[1]
        last_v2 = poly.dirs[2]
        for i in range(1, nt):
            act = poly.active[i]
            last = vwh(act, values[i], last)
            last_prev = torch.where(act, poly.fan[i - 1], last_prev)
            last_v0 = vwh(act, poly.dirs[i + 1], last_v0)
            last_v2 = vwh(act, poly.dirs[i + 2], last_v2)
        any_reach = None
        for i in range(nt):
            r = (poly.fan[i] >= target) & poly.active[i]
            any_reach = r if any_reach is None else (any_reach | r)
        sel = vwh(any_reach, sel, last)
        sel_prev = torch.where(any_reach, sel_prev, last_prev)
        sel_v0 = vwh(any_reach, sel_v0, last_v0)
        sel_v2 = vwh(any_reach, sel_v2, last_v2)
    return sel, sel_prev, sel_v0, sel_v2


def sample_sa_soa(poly: SaPolySoa, r0, r1, m: int):
    """polygon_sampling.glsl:194-224."""
    target = poly.solid_angle * r0
    params, prev_fan, v0, v2 = _select_fan(poly, poly.params, target, m)
    v1 = poly.dirs[0]
    sub = target - prev_fan
    cos_h = torch.cos(0.5 * sub)
    sin_h = torch.sin(0.5 * sub)
    s0 = params[0] * cos_h - params[1] * sin_h
    s2 = params[2] * sin_h
    offset = vadd(vscale(s0, v0), vscale(s2, v2))
    off_sq = vdot(offset, offset)
    scale = 2.0 * vdot(v0, offset) / torch.where(off_sq != 0.0, off_sq, 1.0)
    new_v2 = vsub(vscale(scale, offset), v0)
    s2d = vdot(v1, new_v2)
    s = mix_fma(torch.ones_like(s2d), s2d, r1)
    denom = -s2d * s2d + 1.0
    t_normed = torch.sqrt(torch.clamp(-s * s + 1.0, min=0.0)
                          / torch.where(denom > 0.0, denom, 1.0))
    t_normed = torch.where(denom > 0.0, t_normed, r1)
    return vadd(vscale(-t_normed * s2d + s, v1), vscale(t_normed, new_v2))


# ===========================================================================
# Arvo spherical triangle fans (polygon_sampling_related_work.glsl:229-293)
# ===========================================================================

class SaArvoSoa:
    def __init__(self, dirs, fan, opposite, active, solid_angle):
        self.dirs = dirs
        self.fan = fan
        self.opposite = opposite  # (cos, sin) of the opposite angle per tri
        self.active = active
        self.solid_angle = solid_angle


def prepare_sa_arvo_soa(dirs, count, m: int) -> SaArvoSoa:
    v0 = dirs[0]
    fan, opposite, active = [], [], []
    cum = None
    for i in range(m - 2):
        v1 = dirs[i + 1]
        v2 = dirs[i + 2]
        en0 = vnormalize(cross3(vsub(v1, v0), v0))
        en1 = vnormalize(cross3(vsub(v2, v1), v1))
        cos_op = -vdot(en0, en1)
        sin_op = torch.sqrt(torch.clamp(-cos_op * cos_op + 1.0, min=0.0))
        simplex = vdot(v0, cross3(v1, v2))
        tangent = torch.abs(simplex) / (1.0 + vdot(v0, v1) + vdot(v0, v2)
                                        + vdot(v1, v2))
        sa_i = 2.0 * positive_atan_soa(tangent, False)
        if count is None:
            act = None
        else:
            act = (i + 2) < torch.clamp(count, min=3)
            sa_i = torch.where(act, sa_i, 0.0)
        opposite.append((cos_op, sin_op))
        active.append(act)
        cum = sa_i if cum is None else cum + sa_i
        fan.append(cum)
    return SaArvoSoa(dirs, fan, opposite, active, cum)


def sample_sa_arvo_soa(poly: SaArvoSoa, r0, r1, m: int):
    """polygon_sampling_related_work.glsl:262-293."""
    target = poly.solid_angle * r0
    (cos_op, sin_op), sel_prev, tv0, tv2 = _select_fan(
        poly, poly.opposite, target, m)
    tv1 = poly.dirs[0]
    sub = target - sel_prev
    ssa_cos = torch.cos(sub)
    ssa_sin = torch.sin(sub)
    p = ssa_sin * cos_op - ssa_cos * sin_op
    q = ssa_sin * sin_op + ssa_cos * cos_op
    u = q - cos_op
    v = p + sin_op * vdot(tv0, tv1)
    s_div = (v * p + u * q) * sin_op
    s = ((v * q - u * p) * cos_op - v) \
        / torch.where(s_div != 0.0, s_div, 1.0)
    edge20 = vnormalize(vsub(tv2, vscale(vdot(tv0, tv2), tv0)))
    vertex2 = vadd(vscale(s, tv0),
                   vscale(torch.sqrt(_clip01(-s * s + 1.0)), edge20))
    z = 1.0 - r1 * (1.0 - vdot(vertex2, tv1))
    edge21 = vnormalize(vsub(vertex2, vscale(vdot(tv1, vertex2), tv1)))
    return vadd(vscale(z, tv1),
                vscale(torch.sqrt(_clip01(-z * z + 1.0)), edge21))


# ===========================================================================
# Urena spherical rectangles (polygon_sampling_related_work.glsl:70-166)
# ===========================================================================

class UrenaSoa:
    __slots__ = ("x_axis", "y_axis", "z_axis", "z0", "z0sq", "x0", "y0",
                 "y0sq", "x1", "y1", "y1sq", "b0", "b1", "b0sq", "k",
                 "solid_angle")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def prepare_urena_soa(s, exl, eyl, axis_x, axis_y, axis_z, o) -> UrenaSoa:
    """s (rectangle corner), axes: vec3s of light scalars; exl/eyl light
    scalars; o: vec3 of planes (the shading position)."""
    d = tuple(s[c] - o[c] for c in range(3))
    z0_raw = vdot(d, axis_z)
    neg = z0_raw > 0.0
    zero = torch.zeros_like(z0_raw)
    z_axis = tuple(torch.where(neg, -axis_z[c] + zero, axis_z[c] + zero)
                   for c in range(3))
    z0 = -torch.abs(z0_raw)
    x0 = vdot(d, axis_x)
    y0 = vdot(d, axis_y)
    x1 = x0 + exl
    y1 = y0 + eyl
    v00 = (x0, y0, z0)
    v01 = (x0, y1, z0)
    v10 = (x1, y0, z0)
    v11 = (x1, y1, z0)
    n0 = vnormalize(cross3(v00, v10))
    n1 = vnormalize(cross3(v10, v11))
    n2 = vnormalize(cross3(v11, v01))
    n3 = vnormalize(cross3(v01, v00))
    g0 = acos_soa(torch.clamp(-vdot(n0, n1), -1.0, 1.0))
    g1 = acos_soa(torch.clamp(-vdot(n1, n2), -1.0, 1.0))
    g2 = acos_soa(torch.clamp(-vdot(n2, n3), -1.0, 1.0))
    g3 = acos_soa(torch.clamp(-vdot(n3, n0), -1.0, 1.0))
    b0 = n0[2]
    b1 = n2[2]
    k = 2.0 * M_PI - g2 - g3
    return UrenaSoa(x_axis=axis_x, y_axis=axis_y, z_axis=z_axis, z0=z0,
                    z0sq=z0 * z0, x0=x0, y0=y0, y0sq=y0 * y0, x1=x1, y1=y1,
                    y1sq=y1 * y1, b0=b0, b1=b1, b0sq=b0 * b0, k=k,
                    solid_angle=g0 + g1 - k)


def sample_urena_soa(sq: UrenaSoa, u, v):
    au = u * sq.solid_angle + sq.k
    sin_au = torch.sin(au)
    fu = (torch.cos(au) * sq.b0 - sq.b1) \
        / torch.where(sin_au != 0.0, sin_au, 1.0)
    cu = 1.0 / torch.sqrt(fu * fu + sq.b0sq)
    cu = torch.where(fu > 0.0, cu, -cu)
    cu = torch.clamp(cu, -1.0, 1.0)
    xu = -(cu * sq.z0) / torch.sqrt(torch.clamp(1.0 - cu * cu, min=1e-20))
    xu = torch.minimum(torch.maximum(xu, sq.x0), sq.x1)
    d = torch.sqrt(xu * xu + sq.z0sq)
    h0 = sq.y0 / torch.sqrt(d * d + sq.y0sq)
    h1 = sq.y1 / torch.sqrt(d * d + sq.y1sq)
    hv = h0 + v * (h1 - h0)
    mhv2_1 = -hv * hv + 1.0
    yv = torch.where(mhv2_1 >= 0.0,
                     (hv * d) / torch.sqrt(torch.clamp(mhv2_1, min=1e-20)),
                     sq.y1)
    zero = torch.zeros_like(xu)
    out = tuple(xu * (sq.x_axis[c] + zero) + yv * (sq.y_axis[c] + zero)
                + sq.z0 * sq.z_axis[c] for c in range(3))
    return vnormalize(out)


# ===========================================================================
# Turk uniform area sampling (polygon_sampling_related_work.glsl:38-64)
# ===========================================================================

def sample_area_turk_soa(verts, fan_tri_areas, fan_cum_areas, nv: int,
                         r0, r1):
    """verts: nv world-space vec3s of light scalars; fan_*: per fan
    triangle light scalars. Returns the sampled world position."""
    nt = nv - 2
    zero = torch.zeros_like(r0)
    total = fan_cum_areas[nt - 1]
    target = total * r0
    sel_prev = fan_cum_areas[nt - 2] if nt >= 2 else zero
    sel_area = fan_tri_areas[nt - 1] + zero
    sel_v0 = tuple(verts[nt][c] + zero for c in range(3))
    sel_v2 = tuple(verts[nt + 1][c] + zero for c in range(3))
    for i in range(nt - 2, -1, -1):
        reach = fan_cum_areas[i] >= target
        prev = fan_cum_areas[i - 1] if i >= 1 else zero
        sel_prev = torch.where(reach, prev, sel_prev)
        sel_area = torch.where(reach, fan_tri_areas[i], sel_area)
        sel_v0 = tuple(torch.where(reach, verts[i + 1][c], sel_v0[c])
                       for c in range(3))
        sel_v2 = tuple(torch.where(reach, verts[i + 2][c], sel_v2[c])
                       for c in range(3))
    sub = target - sel_prev
    r0t = sub / torch.where(sel_area != 0.0, sel_area, 1.0)
    sqrt_r0 = torch.sqrt(torch.clamp(r0t, min=0.0))
    b0 = 1.0 - sqrt_r0
    b1 = sqrt_r0 * r1
    b2 = -sqrt_r0 * r1 + sqrt_r0
    v1 = verts[0]
    return tuple(b0 * sel_v0[c] + b1 * v1[c] + b2 * sel_v2[c]
                 for c in range(3))


# ===========================================================================
# Hart et al. cosine warps (polygon_sampling_related_work.glsl:300-500)
# ===========================================================================

def _last_active_dir(dirs, count, m: int):
    """The vertex at index count - 1, clipped to [2, m - 1]."""
    if count is None:
        return dirs[m - 1]
    v = dirs[2]
    for i in range(3, m):
        v = vwh(count - 1 >= i, dirs[i], v)
    return v


class HartBilinearSoa:
    def __init__(self, poly, density_0, density_1a, density_1b):
        self.poly = poly
        self.density_0 = density_0
        self.density_1a = density_1a
        self.density_1b = density_1b


def prepare_hart_bilinear_soa(dirs, count, m: int,
                              biased: bool = False) -> HartBilinearSoa:
    poly = prepare_sa_soa(dirs, count, m, biased)
    d0 = torch.clamp(dirs[0][2], min=0.0)
    d1a = torch.clamp(dirs[1][2], min=0.0)
    d1b = torch.clamp(_last_active_dir(dirs, count, m)[2], min=0.0)
    dsum = 2.0 * d0 + d1a + d1b
    sa = poly.solid_angle
    norm = 4.0 / (sa * dsum)
    inv_sa = 1.0 / sa
    degen = dsum <= 0.0
    return HartBilinearSoa(
        poly,
        torch.where(degen, inv_sa, d0 * norm),
        torch.where(degen, inv_sa, d1a * norm),
        torch.where(degen, inv_sa, d1b * norm))


def linear_warp_soa(r, density_0, density_1):
    lerped_sq = mix_fma(density_0 * density_0, density_1 * density_1, r)
    divisor = density_0 + torch.sqrt(torch.clamp(lerped_sq, min=0.0))
    return r * (density_0 + density_1) \
        / torch.where(divisor != 0.0, divisor, 1.0)


def sample_hart_bilinear_soa(w: HartBilinearSoa, r0, r1, m: int):
    """Returns (direction vec3, density)."""
    r1w = linear_warp_soa(r1, 2.0 * w.density_0, w.density_1a + w.density_1b)
    d0 = mix_fma(w.density_0, w.density_1a, r1w)
    d1 = mix_fma(w.density_0, w.density_1b, r1w)
    r0w = linear_warp_soa(r0, d0, d1)
    density = mix_fma(d0, d1, r0w)
    return sample_sa_soa(w.poly, r0w, r1w, m), density


class HartBiquadraticSoa:
    def __init__(self, poly, density_0, density_1, density_2):
        self.poly = poly
        self.density_0 = density_0
        self.density_1 = density_1  # 3-tuple
        self.density_2 = density_2  # 3-tuple


def prepare_hart_biquadratic_soa(dirs, count, m: int,
                                 biased: bool = False) -> HartBiquadraticSoa:
    poly = prepare_sa_soa(dirs, count, m, biased)
    v0 = dirs[0]
    last = _last_active_dir(dirs, count, m)
    d0 = torch.clamp(v0[2], min=0.0)
    d2_0 = torch.clamp(dirs[1][2], min=0.0)
    d2_2 = torch.clamp(last[2], min=0.0)
    sample_2_1 = sample_sa_soa(poly, torch.full_like(d0, 0.5),
                               torch.ones_like(d0), m)
    d2_1 = torch.clamp(sample_2_1[2], min=0.0)

    # Middle row: the tail of SA sampling at r1 = 0.5 toward the three far
    # directions (column 0 warps toward vertex 0 itself, glsl:430-443).
    d1 = []
    for far in (v0, sample_2_1, last):
        s2 = vdot(v0, far)
        s = 0.5 * s2 + 0.5
        t = torch.sqrt(torch.clamp(-s * s + 1.0, min=0.0))
        t_axis_z = -s2 * v0[2] + far[2]
        norm_t = 1.0 / torch.sqrt(torch.clamp(2.0 * (-s2 * s2 + 1.0),
                                              min=1e-20))
        d1.append(torch.clamp(s * v0[2] + t * norm_t * t_axis_z, min=0.0))

    dsum = 3.0 * d0 + d1[0] + d1[1] + d1[2] + d2_0 + d2_1 + d2_2
    sa = poly.solid_angle
    norm = 9.0 / (sa * dsum)
    inv_sa = 1.0 / sa
    degen = dsum <= 0.0

    def fix(x):
        return torch.where(degen, inv_sa, x * norm)

    return HartBiquadraticSoa(
        poly, fix(d0), (fix(d1[0]), fix(d1[1]), fix(d1[2])),
        (fix(d2_0), fix(d2_1), fix(d2_2)))


def solve_cubic_soa(c0, c1, c2, c3):
    """Blinn's cubic solver (ops/cubic.py) on planes: (r0, r1, r2,
    three_real)."""
    n0 = c0 / c3
    n1 = c1 / (3.0 * c3)
    n2 = c2 / (3.0 * c3)
    delta0 = -n2 * n2 + n1
    delta1 = -n1 * n2 + n0
    delta2 = n2 * n0 - n1 * n1
    disc = 4.0 * delta0 * delta2 - delta1 * delta1
    sqrt_abs = torch.sqrt(torch.abs(disc))
    dep0 = -2.0 * n2 * delta0 + delta1
    dep1 = delta0
    theta = atan2_soa(sqrt_abs, -dep0) * _THIRD
    cr_cos = torch.cos(theta)
    cr_sin = torch.sin(theta)
    scale = 2.0 * torch.sqrt(torch.clamp(-dep1, min=0.0))
    r0 = cr_cos * scale - n2
    r1 = (-_SQRT_075 * cr_sin - 0.5 * cr_cos) * scale - n2
    r2 = (_SQRT_075 * cr_sin - 0.5 * cr_cos) * scale - n2
    signed_sqrt = torch.where(dep0 < 0.0, sqrt_abs, -sqrt_abs)
    quad_root = 0.5 * (signed_sqrt - dep0)
    abs_qr = torch.abs(quad_root)
    cube0_mag = torch.exp(torch.log(torch.where(abs_qr > 0.0, abs_qr, 1.0))
                          * _THIRD)
    cube0 = torch.where(abs_qr > 0.0,
                        torch.where(quad_root < 0.0, -cube0_mag, cube0_mag),
                        0.0)
    cube1 = -dep1 / torch.where(cube0 != 0.0, cube0, 1.0)
    cube1 = torch.where(cube0 != 0.0, cube1, 0.0)
    root1 = cube0 + cube1 - n2
    three = disc >= 0.0
    return (torch.where(three, r0, root1), torch.where(three, r1, root1),
            torch.where(three, r2, root1), three)


def quadratic_warp_soa(r, d0, d1, d2):
    q0 = d0
    q1 = 2.0 * (d1 - d0)
    q2 = d0 - 2.0 * d1 + d2
    c1 = q0
    c2 = 0.5 * q1
    c3 = _THIRD * q2
    scaled = r * (c1 + c2 + c3)
    r0, r1, r2, three = solve_cubic_soa(-scaled, c1, c2, c3)
    out = r0
    out = torch.where(three & (r1 >= 0.0) & (r1 <= 1.0), r1, out)
    out = torch.where(three & (r2 >= 0.0) & (r2 <= 1.0), r2, out)
    return out


def quadratic_bezier_soa(b0, b1, b2, x):
    return mix_fma(mix_fma(b0, b1, x), mix_fma(b1, b2, x), x)


def sample_hart_biquadratic_soa(w: HartBiquadraticSoa, r0, r1, m: int):
    """Returns (direction vec3, density)."""
    r1w = quadratic_warp_soa(
        r1, 3.0 * w.density_0,
        w.density_1[0] + w.density_1[1] + w.density_1[2],
        w.density_2[0] + w.density_2[1] + w.density_2[2])
    d0 = quadratic_bezier_soa(w.density_0, w.density_1[0], w.density_2[0],
                              r1w)
    d1 = quadratic_bezier_soa(w.density_0, w.density_1[1], w.density_2[1],
                              r1w)
    d2 = quadratic_bezier_soa(w.density_0, w.density_1[2], w.density_2[2],
                              r1w)
    r0w = quadratic_warp_soa(r0, d0, d1, d2)
    density = quadratic_bezier_soa(d0, d1, d2, r0w)
    return sample_sa_soa(w.poly, r0w, r1w, m), density
