"""Arvo's projected-solid-angle polygon sampling, structure-of-arrays, in
plain PyTorch: part of the plain version of kernels K4 and K5
(csrc/techniques.cuh, arvo_psa_*).

Counterpart of vulkan_renderer_tpu/ops/soa_arvo_psa.py operation by
operation (Arvo 2001; polygon_sampling_related_work.glsl:509-992):
per-edge azimuth CDFs, cubic-interpolation initialization and Newton
iterations. Polygons are lists of m lanes; every structural index is a
Python int.
"""

from __future__ import annotations

import torch

from .math_utils import M_PI
from .soa import atan2_soa, cross3_fast, mix_fma, positive_atan_soa, vwh

_TWO_PI = 2.0 * M_PI
_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0


def _normalize3(v):
    rl = torch.rsqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] * rl, v[1] * rl, v[2] * rl)


def _prepare_edge(v0, v1):
    """prepare_edge_arvo (glsl:559-590): (cdf, len2, elev2)."""
    normal_a = _normalize3(cross3_fast(v0, v1))
    cdf = 0.5 * normal_a[2]
    pos = cdf > 0.0
    ccw = vwh(pos, v0, v1)
    rl = torch.rsqrt(ccw[0] * ccw[0] + ccw[1] * ccw[1])
    ncx, ncy = -ccw[1] * rl, ccw[0] * rl  # rotate_90(normalize(ccw.xy))
    cos_beta = -(normal_a[0] * ncx + normal_a[1] * ncy)
    sin_beta_sq = -cos_beta * cos_beta + 1.0
    csc_beta = 1.0 / torch.sqrt(torch.clamp(sin_beta_sq, min=0.0) + 1e-30)
    csc_c = 1.0 / torch.sqrt(torch.clamp(-ccw[2] * ccw[2] + 1.0, min=0.0)
                             + 1e-30)
    scale = csc_beta * csc_c
    len0 = sin_beta_sq * scale
    len1 = (normal_a[0] * (-ncy) + normal_a[1] * ncx) * cos_beta * scale
    elev0 = ccw[2]
    elev1 = ccw[0] * normal_a[1] - ccw[1] * normal_a[0]
    elev1 = torch.where(pos, -elev1, elev1)
    return cdf, (len0, len1), (elev0, elev1)


def _edge_psa_in_sector(cdf, length, ra0, ra1):
    """glsl:600-612."""
    c0, s0 = torch.cos(ra0), torch.sin(ra0)
    p0 = (length[0] * c0 + length[1] * s0, s0)
    c1, s1 = torch.cos(ra1), torch.sin(ra1)
    p1 = (length[0] * c1 + length[1] * s1, s1)
    rx = p0[0] * p1[0] + p0[1] * p1[1]
    ry = p0[0] * p1[1] - p0[1] * p1[0]
    return cdf * positive_atan_soa(torch.abs(ry) / rx, False)


def _edge_psa_and_derivative(cdf, length, ra0, ra1):
    """glsl:617-642: (psa, d psa / d ra1)."""
    c0, s0 = torch.cos(ra0), torch.sin(ra0)
    p0 = (length[0] * c0 + length[1] * s0, s0)
    c1, s1 = torch.cos(ra1), torch.sin(ra1)
    p1 = (length[0] * c1 + length[1] * s1, s1)
    rx = p0[0] * p1[0] + p0[1] * p1[1]
    ry = p0[0] * p1[1] - p0[1] * p1[0]
    quotient = torch.abs(ry) / rx
    psa = positive_atan_soa(quotient, False)
    # d/d ra1 of dir_1 is rotate_90(dir_1).
    d1x, d1y = -s1, c1
    p1d = (length[0] * d1x + length[1] * d1y, d1y)
    rxd = p0[0] * p1d[0] + p0[1] * p1d[1]
    ryd = p0[0] * p1d[1] - p0[1] * p1d[0]
    qd = (ryd * rx - ry * rxd) / (rx * rx)
    qd = torch.where(ry < 0.0, -qd, qd)
    psa_d = qd / (quotient * quotient + 1.0)
    return cdf * psa, cdf * psa_d


def _edge_elevation(length, elev, ra):
    """glsl:648-654."""
    c, s = torch.cos(ra), torch.sin(ra)
    px = length[0] * c + length[1] * s
    rl = torch.rsqrt(px * px + s * s)
    return (px * elev[0] + s * elev[1]) * rl


class ArvoPsaSoa:
    """Prepared Arvo PSA polygon (lists of m lanes)."""
    __slots__ = ("m", "count", "azimuths", "edge_cdf", "edge_len",
                 "edge_elev", "sector_inner", "sector_outer", "sector_psa",
                 "psa", "central")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def prepare_arvo_psa_soa(verts, count, m: int) -> ArvoPsaSoa:
    """verts: m vec3s (clip_soa output); count: int32 plane in {0, 3..m}
    (glsl:743-820)."""
    count = torch.clamp(count, min=3)
    v = [_normalize3(verts[k]) for k in range(m)]
    active = [count > k for k in range(m)]
    zero = torch.zeros_like(v[0][0])

    az = [atan2_soa(v[k][1], v[k][0]) for k in range(m)]
    az0 = az[0]
    for k in range(m):
        a = torch.where(az[k] > az0 + M_PI, az[k] - _TWO_PI, az[k])
        az[k] = torch.where(a < az0 - M_PI, a + _TWO_PI, a)

    raw = [_prepare_edge(v[k], v[(k + 1) % m]) for k in range(m)]
    raw_cdf = [raw[k][0] for k in range(m)]
    raw_len = [raw[k][1] for k in range(m)]
    raw_elev = [raw[k][2] for k in range(m)]
    raw_inner = [raw_cdf[k] < 0.0 for k in range(m)]

    # prev = cyclic shift by one with the dynamic count (lane 0 <- count-1).
    last_cdf, last_len, last_elev = zero, (zero, zero), (zero, zero)
    for k in range(m):
        is_last = count - 1 == k
        last_cdf = torch.where(is_last, raw_cdf[k], last_cdf)
        last_len = vwh(is_last, raw_len[k], last_len)
        last_elev = vwh(is_last, raw_elev[k], last_elev)
    prev_cdf = [last_cdf] + raw_cdf[:-1]
    prev_len = [last_len] + raw_len[:-1]
    prev_elev = [last_elev] + raw_elev[:-1]

    edge_cdf = [torch.where(raw_inner[k], prev_cdf[k], raw_cdf[k])
                for k in range(m)]
    edge_len = [vwh(raw_inner[k], prev_len[k], raw_len[k]) for k in range(m)]
    edge_elev = [vwh(raw_inner[k], prev_elev[k], raw_elev[k])
                 for k in range(m)]

    # The first inner->outer transition records the dropped inner edge.
    seen = torch.zeros_like(active[0])
    picked_cdf, picked_len, picked_elev = zero, (zero, zero), (zero, zero)
    for k in range(m):
        trans = active[k] & (prev_cdf[k] < 0.0) & ~raw_inner[k]
        first = trans & ~seen
        picked_cdf = torch.where(first, prev_cdf[k], picked_cdf)
        picked_len = vwh(first, prev_len[k], picked_len)
        picked_elev = vwh(first, prev_elev[k], picked_elev)
        seen = seen | trans
    inner_cdf = torch.where(seen, picked_cdf, 1.0)
    inner_len = vwh(seen, picked_len, (zero, zero))
    inner_elev = vwh(seen, picked_elev, (zero, zero))
    central = inner_cdf > 0.0

    # Central case.
    central_psa = [
        torch.where(active[k],
                    _edge_psa_in_sector(edge_cdf[k], edge_len[k], zero,
                                        az[(k + 1) % m] - az[k]), 0.0)
        for k in range(m)]

    # Decentral case: azimuth sort (rank one-hot), then the sector walk.
    keys = [torch.where(active[k], az[k], float("inf")) for k in range(m)]
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
    s_az, s_cdf, s_len, s_elev = [], [], [], []
    for j in range(m):
        a_az, a_cdf = zero, zero
        a_len = (zero, zero)
        a_elev = (zero, zero)
        for k in range(m):
            sel = rank[k] == j
            a_az = torch.where(sel, az[k], a_az)
            a_cdf = torch.where(sel, edge_cdf[k], a_cdf)
            a_len = vwh(sel, edge_len[k], a_len)
            a_elev = vwh(sel, edge_elev[k], a_elev)
        s_az.append(a_az)
        s_cdf.append(a_cdf)
        s_len.append(a_len)
        s_elev.append(a_elev)

    in_c, in_l, in_e = inner_cdf, inner_len, inner_elev
    in_a = s_az[0]
    out_c, out_l, out_e, out_a = s_cdf[0], s_len[0], s_elev[0], s_az[0]
    si, so = [], []
    for i in range(m - 1):
        if i > 0:
            is_outer = s_cdf[i] >= 0.0
            in_c = torch.where(is_outer, in_c, s_cdf[i])
            in_l = vwh(~is_outer, s_len[i], in_l)
            in_e = vwh(~is_outer, s_elev[i], in_e)
            in_a = torch.where(is_outer, in_a, s_az[i])
            out_c = torch.where(is_outer, s_cdf[i], out_c)
            out_l = vwh(is_outer, s_len[i], out_l)
            out_e = vwh(is_outer, s_elev[i], out_e)
            out_a = torch.where(is_outer, s_az[i], out_a)
        si.append((in_c, in_l, in_e, in_a))
        so.append((out_c, out_l, out_e, out_a))
    si.append(si[-1])
    so.append(so[-1])

    dec_psa = []
    for i in range(m - 1):
        oc, ol, _, oa = so[i]
        ic, il, _, ia = si[i]
        a = _edge_psa_in_sector(oc, ol, s_az[i] - oa, s_az[i + 1] - oa) \
            + _edge_psa_in_sector(ic, il, s_az[i] - ia, s_az[i + 1] - ia)
        dec_psa.append(torch.where(count - 1 > i, a, 0.0))
    dec_psa.append(zero)

    sector_psa = [torch.where(central, central_psa[k], dec_psa[k])
                  for k in range(m)]
    psa = sector_psa[0]
    for k in range(1, m):
        psa = psa + sector_psa[k]

    return ArvoPsaSoa(
        m=m, count=count,
        azimuths=[torch.where(central, az[k], s_az[k]) for k in range(m)],
        edge_cdf=[torch.where(central, edge_cdf[k], s_cdf[k])
                  for k in range(m)],
        edge_len=[vwh(central, edge_len[k], s_len[k]) for k in range(m)],
        edge_elev=[vwh(central, edge_elev[k], s_elev[k]) for k in range(m)],
        sector_inner=si, sector_outer=so, sector_psa=sector_psa, psa=psa,
        central=central)


def _cubic_interpolation(sample_x, xs, ys):
    """Newton divided differences through 4 points (glsl:826-839)."""
    y01 = (ys[0] - ys[1]) / (xs[0] - xs[1])
    y12 = (ys[1] - ys[2]) / (xs[1] - xs[2])
    y23 = (ys[2] - ys[3]) / (xs[2] - xs[3])
    y012 = (y01 - y12) / (xs[0] - xs[2])
    y123 = (y12 - y23) / (xs[1] - xs[3])
    y0123 = (y012 - y123) / (xs[0] - xs[3])
    return (sample_x - xs[0]) * ((sample_x - xs[1]) * (
        (sample_x - xs[2]) * y0123 + y012) + y01) + ys[0]


def _select_sector(sector_psa, target, num_sectors, m: int):
    """First sector whose cumulative PSA exceeds the target, else the last
    valid one: (one-hot sel list, remaining)."""
    cum = []
    running = torch.zeros_like(target)
    prev = []
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


def _pick(sel, values, zero):
    acc = zero
    for s, x in zip(sel, values):
        acc = torch.where(s, x, acc)
    return acc


def _pick2(sel, values, zero):
    acc = (zero, zero)
    for s, x in zip(sel, values):
        acc = vwh(s, x, acc)
    return acc


def _sample_sector(target, r1, inner, out_cdf, out_len, out_elev, out_az,
                   azimuth_0, azimuth_1, iteration_count: int):
    """sample_sector_within_edge / between_edges (glsl:845-929); inner is
    None (central) or (cdf, len, elev, az)."""
    azs = [azimuth_0, mix_fma(azimuth_0, azimuth_1, _THIRD),
           mix_fma(azimuth_0, azimuth_1, _TWO_THIRDS), azimuth_1]
    psas = [_edge_psa_in_sector(out_cdf, out_len, azimuth_0 - out_az,
                                a - out_az) for a in azs]
    if inner is not None:
        in_cdf, in_len, in_elev, in_az = inner
        psas = [p + _edge_psa_in_sector(in_cdf, in_len, azimuth_0 - in_az,
                                        a - in_az)
                for p, a in zip(psas, azs)]
    sampled_az = _cubic_interpolation(target, psas, azs)
    for _ in range(iteration_count):
        out_psa, out_d = _edge_psa_and_derivative(
            out_cdf, out_len, azimuth_0 - out_az, sampled_az - out_az)
        if inner is not None:
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

    cos_az = torch.cos(sampled_az)
    sin_az = torch.sin(sampled_az)
    out_z = _edge_elevation(out_len, out_elev, sampled_az - out_az)
    if inner is not None:
        in_z = _edge_elevation(in_len, in_elev, sampled_az - in_az)
        z_sq = mix_fma(in_z * in_z, out_z * out_z, r1)
    else:
        z_sq = mix_fma(torch.ones_like(r1), out_z * out_z, r1)
    z = torch.sqrt(torch.clamp(z_sq, min=0.0))
    r_xy = torch.sqrt(torch.clamp(-z * z + 1.0, min=0.0))
    return (cos_az * r_xy, sin_az * r_xy, z)


def sample_arvo_psa_soa(poly: ArvoPsaSoa, r0, r1, iteration_count: int = 3):
    """sample_projected_solid_angle_polygon_arvo (glsl:931-992)."""
    m = poly.m
    target = r0 * poly.psa
    zero = torch.zeros_like(target)

    # Central.
    sel_c, rem_c = _select_sector(poly.sector_psa, target, poly.count, m)
    cdf_c = _pick(sel_c, poly.edge_cdf, zero)
    len_c = _pick2(sel_c, poly.edge_len, zero)
    elev_c = _pick2(sel_c, poly.edge_elev, zero)
    az0_c = _pick(sel_c, poly.azimuths, zero)
    az1_cands = [torch.where(poly.count == k + 1, poly.azimuths[0],
                             poly.azimuths[(k + 1) % m]) for k in range(m)]
    az1_c = _pick(sel_c, az1_cands, zero)
    az1_c = torch.where(az1_c < az0_c, az1_c + _TWO_PI, az1_c)
    dir_c = _sample_sector(rem_c, r1, None, cdf_c, len_c, elev_c, az0_c,
                           az0_c, az1_c, iteration_count)

    # Decentral.
    sel_d, rem_d = _select_sector(poly.sector_psa, target, poly.count - 1, m)
    inner = (_pick(sel_d, [s[0] for s in poly.sector_inner], zero),
             _pick2(sel_d, [s[1] for s in poly.sector_inner], zero),
             _pick2(sel_d, [s[2] for s in poly.sector_inner], zero),
             _pick(sel_d, [s[3] for s in poly.sector_inner], zero))
    out_cdf = _pick(sel_d, [s[0] for s in poly.sector_outer], zero)
    out_len = _pick2(sel_d, [s[1] for s in poly.sector_outer], zero)
    out_elev = _pick2(sel_d, [s[2] for s in poly.sector_outer], zero)
    out_az = _pick(sel_d, [s[3] for s in poly.sector_outer], zero)
    az0_d = _pick(sel_d, poly.azimuths, zero)
    az1_d = _pick(sel_d, poly.azimuths[1:] + poly.azimuths[:1], zero)
    dir_d = _sample_sector(rem_d, r1, inner, out_cdf, out_len, out_elev,
                           out_az, az0_d, az1_d, iteration_count)

    return tuple(torch.where(poly.central, c, d)
                 for c, d in zip(dir_c, dir_d))
