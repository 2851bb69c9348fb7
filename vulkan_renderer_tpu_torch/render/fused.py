"""Fused per-light shading: kernels K4 (csrc/fused_shading.cu) and K5
(csrc/fused_resolved.cu) and their plain PyTorch versions.

K4 replaces the Pallas kernel vulkan_renderer_tpu/render/fused.py::
fused_light_shading (kernel2, pallas_call :672): per pixel and light, the
light's sampler (world->shading transform, clip, prepare) and its ray
slots. Under DIFFUSE_SPECULAR_MIS (PSA and PSA-biased) each sample gives a
diffuse and a specular slot with the LTC density and the MIS estimate
(fused.py:330-467, math in ops/soa.py); under DIFFUSE_ONLY each sample
gives one slot, for all 13 techniques (fused.py:156-327, math in
ops/soa_techniques.py and ops/soa_arvo_psa.py). Visibility is deferred:
the frame's color is base + sum_slot b * V(slot ray).

K5 replaces fused_light_shading_resolved (one_group.kernel, pallas_call
:816): the same shading with visibility resolved to 1 (no shadow rays),
accumulated into one RGB value per pixel.

Both take the (62, P) planes of BASE_PLANES, the frame's noise as an
ops/noise.py FrameNoise (the kernels read the noise table at each pixel;
light i's pair q is the frame's pair i * rays_per_light + q) and the
(L, 58) per-light records of pack_light_scalars. K4 returns (3 + 7 S, P):
base RGB, then per ray slot b RGB, direction xyz, t_max (S = light_count *
rays_per_light; a pixel that hit nothing gets dead slots, b 0, direction 0,
t_max -1); K5 returns (P, 3). The plain versions take the same
arguments and build the noise image with get_noise_image.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import trace
from ..core.device import to_device_async
from ..core.settings import (ErrorDisplay, MisHeuristic,
                             PolygonSamplingTechnique, RenderSettings,
                             SamplingStrategy)
from ..kernels import build
from ..ops import soa
from ..ops import soa_techniques as st
from ..ops.ltc import LtcCoefficients
from ..ops.noise import FrameNoise
from ..ops.soa import vadd, vdot, vscale, vwh
from ..ops.soa_arvo_psa import prepare_arvo_psa_soa, sample_arvo_psa_soa
from .shading import ShadingData, rays_per_light

Tech = PolygonSamplingTechnique

# Per-light record layout (fused.py:49-60): 8 vertices x 3, plane (4),
# surface radiance (3), rotation columns (9), translation (3),
# scaling x/y (2), area (1), fan areas (6 x (tri, cumulative)).
LS_VERTS = 0
LS_PLANE = 24
LS_RADIANCE = 28
LS_ROTATION = 31
LS_TRANSLATION = 40
LS_SCALING = 43
LS_AREA = 45
LS_FAN = 46
LIGHT_SCALARS = LS_FAN + 6 * 2

BASE_PLANES = (
    ["pos0", "pos1", "pos2", "nrm0", "nrm1", "nrm2", "out0", "out1", "out2",
     "lambert_out", "alb0", "alb1", "alb2", "f00", "f01", "f02", "rough",
     "hit", "ltc_albedo", "ltc_det"]
    + [f"w2s{i}{j}" for i in range(3) for j in range(4)]
    + [f"w2c{i}{j}" for i in range(3) for j in range(4)]
    + [f"s2c{i}{j}" for i in range(3) for j in range(3)]
    + [f"c2s{i}{j}" for i in range(3) for j in range(3)]
)
_PLANE_INDEX = {name: k for k, name in enumerate(BASE_PLANES)}

# Ids shared with csrc/techniques.cuh (VR_HEURISTIC, VR_TECHNIQUE).
HEURISTIC_IDS = {MisHeuristic.BALANCE: 0, MisHeuristic.POWER: 1,
                 MisHeuristic.WEIGHTED: 2, MisHeuristic.OPTIMAL_CLAMPED: 3,
                 MisHeuristic.OPTIMAL: 4}
TECHNIQUE_IDS = {t: i for i, t in enumerate(PolygonSamplingTechnique)}
_PSA_PAIR = (Tech.PROJECTED_SOLID_ANGLE, Tech.PROJECTED_SOLID_ANGLE_BIASED)


def check_settings_class(settings) -> None:
    """Raise TypeError for settings of another class (the JAX package's
    RenderSettings): their enum members compare unequal to the port's, so
    every branch on them would go the wrong way."""
    if not isinstance(settings, RenderSettings):
        raise TypeError(
            f"expected the port's RenderSettings "
            f"(vulkan_renderer_tpu_torch.core.settings), got "
            f"{type(settings).__module__}.{type(settings).__qualname__}")


def fused_supported(static, settings: RenderSettings) -> bool:
    """Whether K4 and K5 cover (static, settings): the JAX package's
    fused_supported (fused.py:63-94). All 13 techniques with DIFFUSE_ONLY,
    the PSA pair also with DIFFUSE_SPECULAR_MIS; untextured polygonal
    lights of 3-8 vertices, no linear lights, no error display. The
    frame takes the per-pixel path (render/shading.py) for the rest."""
    check_settings_class(settings)
    if settings.error_display != ErrorDisplay.NONE:
        return False
    allowed = (SamplingStrategy.DIFFUSE_ONLY,)
    if settings.polygon_sampling_technique in _PSA_PAIR:
        allowed += (SamplingStrategy.DIFFUSE_SPECULAR_MIS,)
    if settings.sampling_strategy not in allowed:
        return False
    if static.linear_light_count:
        return False
    if any(t != 0 for t in static.light_texturing):
        return False
    if len(static.light_vertex_counts) != static.light_count:
        return False
    return all(3 <= nv <= 8 for nv in static.light_vertex_counts)


def check_supported(static, settings: RenderSettings) -> None:
    """Raise ValueError where K4 and K5 do not cover (static, settings)
    (fused_supported), TypeError for settings of another class."""
    if not fused_supported(static, settings):
        raise ValueError(
            f"kernels K4/K5 do not cover strategy "
            f"{settings.sampling_strategy.value} with technique "
            f"{settings.polygon_sampling_technique.value}, error display "
            f"{settings.error_display.value}, light texturing "
            f"{static.light_texturing}, {static.linear_light_count} linear "
            "lights (render/fused.py fused_supported); the frame renders "
            "them on the per-pixel path")


def kernel_defines(settings: RenderSettings) -> dict:
    """The compile-time configuration of K4 and K5 (csrc/techniques.cuh)."""
    mis = settings.sampling_strategy == SamplingStrategy.DIFFUSE_SPECULAR_MIS
    return {"VR_TECHNIQUE": TECHNIQUE_IDS[settings.polygon_sampling_technique],
            "VR_MIS": int(mis),
            "VR_HEURISTIC": HEURISTIC_IDS[settings.mis_heuristic] if mis
            else 0}


def vertex_count_mask(static) -> int:
    """VR_NV_MASK: the vertex counts a library instantiates."""
    mask = 0
    for nv in static.light_vertex_counts:
        mask |= 1 << nv
    return mask


def vertex_groups(static) -> list[tuple[int, list[int]]]:
    """(vertex count, light indices) in ascending vertex count: one kernel
    launch per group."""
    groups: dict[int, list[int]] = {}
    for i, nv in enumerate(static.light_vertex_counts):
        groups.setdefault(nv, []).append(i)
    return sorted(groups.items())


def pack_light_scalars(lights, light_count: int) -> torch.Tensor:
    """(L, 58) float32 per-light records (fused.py _pack_light_scalars);
    vertex and fan lanes are padded by repetition."""
    rows = []
    for i in range(light_count):
        verts = lights.vertices_world_space[i]
        if verts.shape[0] < 8:
            verts = torch.cat([verts, verts[:1].expand(8 - verts.shape[0],
                                                        3)])
        fan = lights.fan_areas[i]
        if fan.shape[0] < 6:
            fan = torch.cat([fan, fan[-1:].expand(6 - fan.shape[0], 2)])
        rows.append(torch.cat([
            verts[:8].reshape(-1), lights.plane[i],
            lights.surface_radiance[i],
            lights.rotation[i].T.reshape(-1),  # columns
            lights.translation[i],
            torch.stack([lights.scaling_x[i], lights.scaling_y[i]]),
            lights.area[i][None], fan[:6].reshape(-1)]))
    return torch.stack(rows).to(torch.float32).contiguous()


def pack_planes(data, ltc, hit) -> torch.Tensor:
    """ShadingData / LtcCoefficients with (P, ...) fields, hit (P,) bool ->
    the (62, P) float32 planes of BASE_PLANES."""
    cols = [data.position.T, data.normal.T, data.outgoing.T,
            data.lambert_outgoing[None], data.diffuse_albedo.T,
            data.fresnel_0.T, data.roughness[None],
            hit.to(torch.float32)[None], ltc.albedo[None],
            ltc.shading_to_cosine_space_determinant[None],
            ltc.world_to_shading_space.reshape(-1, 12).T,
            ltc.world_to_cosine_space.reshape(-1, 12).T,
            ltc.shading_to_cosine_space.reshape(-1, 9).T,
            ltc.cosine_to_shading_space.reshape(-1, 9).T]
    return torch.cat(cols, dim=0).to(torch.float32).contiguous()


def plane_views(planes: torch.Tensor):
    """The (62, P) planes of BASE_PLANES -> (ShadingData, LtcCoefficients)
    whose (P, ...) fields are views of the planes' rows: pack_planes
    undone without a copy."""
    def rows(start, count):
        return planes[start:start + count].T

    def matrices(start, columns):
        return rows(start, 3 * columns).reshape(-1, 3, columns)

    k = _PLANE_INDEX
    data = ShadingData(
        position=rows(k["pos0"], 3), normal=rows(k["nrm0"], 3),
        outgoing=rows(k["out0"], 3),
        lambert_outgoing=planes[k["lambert_out"]],
        diffuse_albedo=rows(k["alb0"], 3), fresnel_0=rows(k["f00"], 3),
        roughness=planes[k["rough"]])
    ltc = LtcCoefficients(
        world_to_shading_space=matrices(k["w2s00"], 4),
        shading_to_cosine_space=matrices(k["s2c00"], 3),
        world_to_cosine_space=matrices(k["w2c00"], 4),
        cosine_to_shading_space=matrices(k["c2s00"], 3),
        albedo=planes[k["ltc_albedo"]],
        shading_to_cosine_space_determinant=planes[k["ltc_det"]])
    return data, ltc


def unpack_outputs(out: torch.Tensor, slot_count: int):
    """(3 + 7 S, P) -> (base (P, 3), b (P, S, 3), dirs (P, S, 3),
    t_max (P, S))."""
    p = out.shape[1]
    rest = out[3:].reshape(slot_count, 7, p)
    return (out[0:3].T, rest[:, 0:3].permute(2, 0, 1),
            rest[:, 3:6].permute(2, 0, 1), rest[:, 6].T)


# ---------------------------------------------------------------------------
# Plain version (torch planes)
# ---------------------------------------------------------------------------


def _light_record(ls: torch.Tensor, i: int, nv: int) -> dict:
    """One light's scalars (fused.py _read_light), as 0-d tensors."""
    def vec(start, count=3):
        return tuple(ls[i, start + c] for c in range(count))
    return dict(
        verts=[vec(LS_VERTS + 3 * k) for k in range(nv)],
        plane=vec(LS_PLANE, 4), radiance=vec(LS_RADIANCE),
        rot_cols=[vec(LS_ROTATION + 3 * k) for k in range(3)],
        translation=vec(LS_TRANSLATION), scaling=vec(LS_SCALING, 2),
        area=ls[i, LS_AREA],
        fan_tri=[ls[i, LS_FAN + 2 * k] for k in range(6)],
        fan_cum=[ls[i, LS_FAN + 2 * k + 1] for k in range(6)])


def _unpack_px(planes: torch.Tensor) -> dict:
    def g(name):
        return planes[_PLANE_INDEX[name]]

    px = {"position": (g("pos0"), g("pos1"), g("pos2")),
          "normal": (g("nrm0"), g("nrm1"), g("nrm2")),
          "outgoing": (g("out0"), g("out1"), g("out2")),
          "lambert_out": g("lambert_out"),
          "diffuse_albedo": (g("alb0"), g("alb1"), g("alb2")),
          "fresnel_0": (g("f00"), g("f01"), g("f02")),
          "roughness": g("rough"), "hit": g("hit") > 0.5,
          "ltc_albedo": g("ltc_albedo"), "ltc_det": g("ltc_det")}
    for name in BASE_PLANES[20:]:
        px[name] = g(name)
    return px


def _rad_brdf(px, light, d_world):
    """radiance x BRDF assuming visibility, the geometric lambert and the
    shadow ray's t_max (shading.py radiance_brdf_deferred)."""
    lambert = vdot(px["normal"], d_world)
    geo = lambert > 0.0
    p = light["plane"]
    denom = d_world[0] * p[0] + d_world[1] * p[1] + d_world[2] * p[2]
    dist = (px["position"][0] * p[0] + px["position"][1] * p[1]
            + px["position"][2] * p[2]) + p[3]
    t_max = -dist / torch.where(denom != 0.0, denom, 1.0)
    brdf = soa.evaluate_brdf_soa(
        px["normal"], px["outgoing"], px["lambert_out"],
        px["diffuse_albedo"], px["fresnel_0"], px["roughness"], d_world)
    value = tuple(torch.where(geo, light["radiance"][c] * brdf[c], 0.0)
                  for c in range(3))
    return value, lambert, torch.where(geo, t_max, 0.0)


def _rows(px, prefix, flip=None):
    """The 3x4 world->space matrix as rows and translations; with flip,
    row 1 negated behind the light (glsl:444-452)."""
    rows = [tuple(px[f"{prefix}{i}{j}"] for j in range(3)) for i in range(3)]
    trans = [px[f"{prefix}{i}3"] for i in range(3)]
    if flip is not None:
        rows[1] = tuple(flip * c for c in rows[1])
        trans[1] = flip * trans[1]
    return rows, trans


def _flip(px, light):
    p = light["plane"]
    side = vdot(px["position"], p[:3]) + p[3]
    return torch.where(side < 0.0, -1.0, 1.0)


def _affine(rows, trans, v):
    return tuple(vdot(rows[i], v) + trans[i] for i in range(3))


def _rot_t_apply(rows, d):
    return tuple(d[0] * rows[0][c] + d[1] * rows[1][c] + d[2] * rows[2][c]
                 for c in range(3))


def _diffuse_slots(px, light, sample, ok, n: int, noise):
    """DIFFUSE_ONLY slots of one light: sample(r0, r1) -> (d_world,
    density, per-sample gate or None); ok is the light's gate or None."""
    zero = torch.zeros_like(px["roughness"])
    zero3 = (zero, zero, zero)
    slots = []
    inv_n = 1.0 / n
    for s in range(n):
        r0, r1 = noise[s]
        d_world, density, sample_ok = sample(r0, r1)
        value1, lambert, t_max = _rad_brdf(px, light, d_world)
        scale = torch.where(density > 0.0,
                            lambert / torch.where(density > 0.0, density,
                                                  1.0), 0.0)
        gate = px["hit"] if ok is None else (ok & px["hit"])
        if sample_ok is not None:
            gate = gate & sample_ok
        b = vwh(gate, vscale(scale, value1), zero3)
        slots.append((vscale(inv_n, b), d_world, t_max))
    return zero3, slots


def _shade_one_light_diffuse(px, light, nv: int, tech, n: int, noise):
    """DIFFUSE_ONLY for the techniques other than the PSA family
    (fused.py:156-282; the reference's per-technique branches,
    shading_pass.frag.glsl:329-502)."""
    ok = None
    if tech == Tech.BASELINE:
        corner = tuple(light["translation"][c] - px["position"][c]
                       for c in range(3))
        cols = light["rot_cols"]

        def sample(r0, r1):
            d = soa.vnormalize(tuple(corner[c] + r0 * cols[0][c]
                                     + r1 * cols[1][c] for c in range(3)))
            return d, torch.ones_like(r0), None
    elif tech == Tech.AREA_TURK:
        def sample(r0, r1):
            pos = st.sample_area_turk_soa(light["verts"], light["fan_tri"],
                                          light["fan_cum"], nv, r0, r1)
            offset = tuple(pos[c] - px["position"][c] for c in range(3))
            dist_sq = vdot(offset, offset)
            rcp = 1.0 / torch.sqrt(dist_sq)
            d = tuple(offset[c] * rcp for c in range(3))
            pl = light["plane"]
            projected = torch.abs(d[0] * pl[0] + d[1] * pl[1]
                                  + d[2] * pl[2]) * light["area"]
            density = dist_sq / torch.where(projected > 0.0, projected, 1.0)
            return d, torch.where(projected > 0.0, density, 0.0), None
    elif tech in (Tech.SOLID_ANGLE, Tech.SOLID_ANGLE_ARVO):
        dirs = [soa.vnormalize(tuple(light["verts"][k][c] - px["position"][c]
                                     for c in range(3))) for k in range(nv)]
        arvo = tech == Tech.SOLID_ANGLE_ARVO
        prep = st.prepare_sa_arvo_soa(dirs, None, nv) if arvo \
            else st.prepare_sa_soa(dirs, None, nv)
        ok = prep.solid_angle > 0.0
        density = 1.0 / torch.where(ok, prep.solid_angle, 1.0)

        def sample(r0, r1):
            d = st.sample_sa_arvo_soa(prep, r0, r1, nv) if arvo \
                else st.sample_sa_soa(prep, r0, r1, nv)
            return d, density, None
    elif tech == Tech.RECTANGLE_SOLID_ANGLE_URENA:
        cols = light["rot_cols"]
        prep = st.prepare_urena_soa(light["translation"],
                                    light["scaling"][0], light["scaling"][1],
                                    cols[0], cols[1], cols[2],
                                    px["position"])
        ok = prep.solid_angle > 0.0
        density = 1.0 / torch.where(ok, prep.solid_angle, 1.0)

        def sample(r0, r1):
            return st.sample_urena_soa(prep, r0, r1), density, None
    else:
        # The shading-space family: clipped solid angle and the Hart warps
        # (render/shading.py:501-556), no winding flip.
        rows, trans = _rows(px, "w2s")
        verts = [_affine(rows, trans, light["verts"][k]) for k in range(nv)]
        if tech in (Tech.BILINEAR_COSINE_WARP_HART,
                    Tech.BIQUADRATIC_COSINE_WARP_HART):
            count, m = None, nv
        else:
            verts, count = soa.clip_soa(verts, nv)
            m = nv + 1
            ok = count > 0
            count = torch.clamp(count, min=3)
        dirs = [soa.vnormalize(v) for v in verts]
        if tech == Tech.CLIPPED_SOLID_ANGLE:
            prep = st.prepare_sa_soa(dirs, count, m)
            density = 1.0 / torch.where(prep.solid_angle > 0.0,
                                        prep.solid_angle, 1.0)

            def sample_sh(r0, r1):
                return st.sample_sa_soa(prep, r0, r1, m), density
            poly = prep
        elif tech in (Tech.BILINEAR_COSINE_WARP_HART,
                      Tech.BILINEAR_COSINE_WARP_CLIPPING_HART):
            prep = st.prepare_hart_bilinear_soa(dirs, count, m)

            def sample_sh(r0, r1):
                return st.sample_hart_bilinear_soa(prep, r0, r1, m)
            poly = prep.poly
        else:
            prep = st.prepare_hart_biquadratic_soa(dirs, count, m)

            def sample_sh(r0, r1):
                return st.sample_hart_biquadratic_soa(prep, r0, r1, m)
            poly = prep.poly
        sa_ok = poly.solid_angle > 0.0
        ok = sa_ok if ok is None else (sa_ok & ok)

        def sample(r0, r1):
            d_sh, density = sample_sh(r0, r1)
            return _rot_t_apply(rows, d_sh), density, None
    return _diffuse_slots(px, light, sample, ok, n, noise)


def _shade_one_light_arvo_psa(px, light, nv: int, n: int, noise):
    """DIFFUSE_ONLY Arvo PSA (fused.py:285-327), with the PSA winding flip;
    horizon samples (z <= 1e-5) are dropped."""
    rows, trans = _rows(px, "w2s", _flip(px, light))
    clipped, ccount = soa.clip_soa(
        [_affine(rows, trans, light["verts"][k]) for k in range(nv)], nv)
    poly = prepare_arvo_psa_soa(clipped, ccount, nv + 1)
    ok = (ccount > 0) & (poly.psa > 0.0)
    rcp_psa = 1.0 / torch.where(poly.psa > 0.0, poly.psa, 1.0)

    def sample(r0, r1):
        d_sh = sample_arvo_psa_soa(poly, r0, r1, 3)
        return (_rot_t_apply(rows, d_sh), d_sh[2] * rcp_psa,
                d_sh[2] > 1e-5)
    return _diffuse_slots(px, light, sample, ok, n, noise)


def _shade_one_light_psa(px, light, nv: int, settings: RenderSettings,
                         noise):
    """PSA / PSA-biased with DIFFUSE_ONLY or DIFFUSE_SPECULAR_MIS
    (fused.py:345-467). Returns (base vec3, [(b, dir, t_max) per slot])."""
    biased = settings.polygon_sampling_technique \
        == Tech.PROJECTED_SOLID_ANGLE_BIASED
    heuristic = settings.mis_heuristic.value
    vis = float(settings.mis_visibility_estimate)
    n = settings.sample_count
    flip = _flip(px, light)
    w2s_rows, w2s_trans = _rows(px, "w2s", flip)
    clipped, ccount = soa.clip_soa(
        [_affine(w2s_rows, w2s_trans, light["verts"][k]) for k in range(nv)],
        nv)
    poly_d = soa.prepare_psa_soa(clipped, ccount, nv + 1, biased)
    psa_d = poly_d.psa
    diffuse_ok = (ccount > 0) & (psa_d > 0.0)
    rcp_psa_d = 1.0 / torch.where(psa_d > 0.0, psa_d, 1.0)

    if settings.sampling_strategy == SamplingStrategy.DIFFUSE_ONLY:
        def sample(r0, r1):
            d_sh = soa.sample_psa_soa(poly_d, r0, r1, biased)
            return _rot_t_apply(w2s_rows, d_sh), d_sh[2] * rcp_psa_d, None
        return _diffuse_slots(px, light, sample, diffuse_ok, n, noise)

    w2c_rows, w2c_trans = _rows(px, "w2c", flip)
    clipped_c, ccount_c = soa.clip_soa(
        [_affine(w2c_rows, w2c_trans, light["verts"][k]) for k in range(nv)],
        nv)
    poly_s = soa.prepare_psa_soa(clipped_c, ccount_c, nv + 1, biased)
    psa_s = torch.where(ccount_c > 0, poly_s.psa, 0.0)
    specular_ok = psa_s > 0.0
    rcp_psa_s = 1.0 / torch.where(psa_s > 0.0, psa_s, 1.0)
    specular_weight = px["ltc_albedo"] * psa_s

    diffuse_weight = tuple(torch.clamp(px["diffuse_albedo"][c], min=0.01)
                           * psa_d for c in range(3))
    specular_weight3 = (specular_weight,) * 3
    if heuristic == "optimal":
        rad_over_pi = tuple(light["radiance"][c] * (1.0 / np.pi)
                            for c in range(3))
        diffuse_weight = tuple(diffuse_weight[c] * rad_over_pi[c]
                               for c in range(3))
        specular_weight3 = tuple(specular_weight3[c] * rad_over_pi[c]
                                 for c in range(3))

    s2c = [px[f"s2c{i}{j}"] for i in range(3) for j in range(3)]
    c2s = [px[f"c2s{i}{j}"] for i in range(3) for j in range(3)]
    zero = torch.zeros_like(psa_d)
    zero3 = (zero, zero, zero)
    base = zero3
    slots = []
    for s in range(n):
        d_diffuse = soa.sample_psa_soa(poly_d, *noise[2 * s], biased)
        d_spec_c = soa.sample_psa_soa(poly_s, *noise[2 * s + 1], biased)
        d_specular = soa.vnormalize(tuple(
            c2s[3 * i + 0] * d_spec_c[0] + c2s[3 * i + 1] * d_spec_c[1]
            + c2s[3 * i + 2] * d_spec_c[2] for i in range(3)))
        for j, d_sh in enumerate((d_diffuse, d_specular)):
            in_upper = d_sh[2] > 0.0
            diffuse_density = d_sh[2] * rcp_psa_d
            specular_density = soa.ltc_density_soa(s2c, px["ltc_det"], d_sh,
                                                   rcp_psa_s)
            d_world = _rot_t_apply(w2s_rows, d_sh)
            value1, _, t_max = _rad_brdf(px, light, d_world)
            integrand1 = vscale(d_sh[2], value1)
            if j == 0:
                weights = (diffuse_weight, diffuse_density,
                           specular_weight3, specular_density)
            else:
                weights = (specular_weight3, specular_density,
                           diffuse_weight, diffuse_density)
            est0 = soa.mis_estimate_soa(heuristic, zero3, *weights, vis)
            est1 = soa.mis_estimate_soa(heuristic, integrand1, *weights, vis)
            est_delta = tuple(est1[c] - est0[c] for c in range(3))
            if j == 0:
                dd_safe = torch.where(diffuse_density > 0.0,
                                      diffuse_density, 1.0)
                no_mis1 = vscale(1.0 / dd_safe, integrand1)
                a_term = vwh(specular_ok, est0, zero3)
                b_term = vwh(specular_ok, est_delta, no_mis1)
                gate = in_upper & diffuse_ok
            else:
                a_term = est0
                b_term = est_delta
                gate = in_upper & diffuse_ok & specular_ok
            gate = gate & px["hit"]
            base = vadd(base, vwh(gate, a_term, zero3))
            slots.append((vwh(gate, b_term, zero3), d_world, t_max))
    scale = 1.0 / n
    return (vscale(scale, base),
            [(vscale(scale, b), d, t) for (b, d, t) in slots])


def _shade_one_light(px, light, nv: int, settings: RenderSettings, noise):
    """One light's (base vec3, [(b, dir, t_max) per ray slot])
    (fused.py:330-344 dispatch); noise: (r0, r1) plane pairs."""
    tech = settings.polygon_sampling_technique
    if tech == Tech.PROJECTED_SOLID_ANGLE_ARVO:
        return _shade_one_light_arvo_psa(px, light, nv,
                                         settings.sample_count, noise)
    if tech not in _PSA_PAIR:
        return _shade_one_light_diffuse(px, light, nv, tech,
                                        settings.sample_count, noise)
    return _shade_one_light_psa(px, light, nv, settings, noise)


def _light_noise(image: torch.Tensor, light: int, ppl: int):
    """Light `light`'s (r0, r1) plane pairs of the (2 pairs, P) noise
    image."""
    return [(image[2 * (light * ppl + q)], image[2 * (light * ppl + q) + 1])
            for q in range(ppl)]


def fused_light_shading_plain(planes: torch.Tensor, noise: FrameNoise,
                              light_scalars: torch.Tensor, static,
                              settings: RenderSettings) -> torch.Tensor:
    """Plain version of K4: (62, P) planes -> (3 + 7 S, P). A pixel that
    hit nothing has base and b +0 (every gate includes the hit) and dead
    slots: direction 0, t_max -1, as K4 writes them without shading it."""
    check_supported(static, settings)
    ppl = rays_per_light(settings)
    px = _unpack_px(planes)
    image = noise.image()
    zero = torch.zeros_like(px["roughness"])
    base = (zero, zero, zero)
    outs = []
    for i in range(static.light_count):
        nv = static.light_vertex_counts[i]
        lbase, slots = _shade_one_light(
            px, _light_record(light_scalars, i, nv), nv, settings,
            _light_noise(image, i, ppl))
        base = vadd(base, lbase)
        for (b, d, t) in slots:
            d = tuple(torch.where(px["hit"], c, 0.0) for c in d)
            t = torch.where(px["hit"], t, -1.0)
            outs.extend([b[0], b[1], b[2], d[0], d[1], d[2], t])
    return torch.stack(list(base) + outs, dim=0)


def fused_light_shading_resolved_plain(planes: torch.Tensor,
                                       noise: FrameNoise,
                                       light_scalars: torch.Tensor, static,
                                       settings: RenderSettings
                                       ) -> torch.Tensor:
    """Plain version of K5: (62, P) base planes -> (P, 3) = base + sum over
    lights and slots of b. Sums go per light base + (0 + b_0 + b_1 + ...),
    lights in ascending vertex-count groups, groups added in turn: the
    order K5 uses."""
    check_supported(static, settings)
    ppl = rays_per_light(settings)
    px = _unpack_px(planes)
    image = noise.image()
    zero = torch.zeros_like(px["roughness"])
    zero3 = (zero, zero, zero)
    out = None
    for nv, ids in vertex_groups(static):
        group = zero3
        for i in ids:
            lbase, slots = _shade_one_light(
                px, _light_record(light_scalars, i, nv), nv, settings,
                _light_noise(image, i, ppl))
            bsum = zero3
            for (b, _, _) in slots:
                bsum = vadd(bsum, b)
            group = vadd(group, vadd(lbase, bsum))
        out = group if out is None else vadd(out, group)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Kernels K4 and K5
# ---------------------------------------------------------------------------

# k4_fused_shading and k5_fused_resolved take the same arguments.
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int,    # planes, P
             ctypes.c_void_p, ctypes.c_int,    # noise table, its height
             ctypes.c_int, ctypes.c_void_p,    # its width, fetches
             ctypes.c_void_p, ctypes.c_int,    # pixels or null, frame width
             ctypes.c_void_p, ctypes.c_void_p,  # lights, light ids
             ctypes.c_int,                     # lights in the group
             ctypes.c_int, ctypes.c_int,       # vertex count, sample count
             ctypes.c_int,                     # first group (writes)
             ctypes.c_float,                   # mis visibility estimate
             ctypes.c_void_p, ctypes.c_void_p,  # out, op counts or null
             ctypes.c_void_p]                  # stream
# The counting build's counters (csrc/count_ops.cuh): stage-major, kinds
# within a stage.
OP_KINDS = ("add", "mul", "fma", "div", "sqrt", "transcendental", "compare")
OP_STAGES = ("pixel", "prepare", "sample")
_KERNELS = {"K4": ("fused_shading", "k4_fused_shading"),
            "K5": ("fused_resolved", "k5_fused_resolved")}
# Threads per block and the blocks per SM that __launch_bounds__ asks the
# register allocator for, per kernel: chosen by measurement over a few
# candidates (tools/tune_shading.py, PERF.md section 6). Both cap a thread
# at 128 registers, 16 resident warps per SM.
LAUNCH_BOUNDS = {"K4": {"VR_THREADS": 256, "VR_MIN_BLOCKS": 2},
                 "K5": {"VR_THREADS": 128, "VR_MIN_BLOCKS": 4}}


def library_defines(kernel: str, static, settings: RenderSettings) -> dict:
    """The defines of K4's or K5's (`kernel`) library for this light layout
    and these settings."""
    return {**kernel_defines(settings), **LAUNCH_BOUNDS[kernel],
            "VR_NV_MASK": vertex_count_mask(static)}


def _check_inputs(planes, noise: FrameNoise, light_scalars, static,
                  settings) -> int:
    build.require_cuda(planes, noise.table, noise.fetches, light_scalars)
    check_supported(static, settings)
    p = planes.shape[1]
    build.check_tensor(planes, "planes", torch.float32,
                       (len(BASE_PLANES), p))
    build.check_tensor(light_scalars, "light_scalars", torch.float32,
                       (static.light_count, LIGHT_SCALARS))
    table = noise.table
    if table.dtype != torch.int32 or table.dim() != 4 \
            or table.shape[3] != 4 or not table.is_contiguous():
        raise ValueError("noise table: expected a contiguous int32 "
                         f"(layers, H, W, 4) tensor, got {table.dtype} "
                         f"{tuple(table.shape)}")
    for side in table.shape[1:3]:
        if side & (side - 1):
            raise ValueError(f"noise table sides must be powers of two, "
                             f"got {tuple(table.shape[1:3])}")
    pairs = rays_per_light(settings) * static.light_count
    if noise.fetches.shape[0] < (pairs + 1) // 2:
        raise ValueError(f"{noise.fetches.shape[0]} noise fetches for "
                         f"{pairs} pairs")
    build.check_tensor(noise.fetches, "fetches", torch.int32,
                       (noise.fetches.shape[0], 3))
    if noise.column_count != p:
        raise ValueError(f"the noise covers {noise.column_count} pixels, "
                         f"the planes {p}")
    if noise.pixels is not None:
        build.require_cuda(planes, noise.pixels)
        build.check_tensor(noise.pixels, "pixels", torch.int32, (p,))
    return p


def launch_kernel(kernel: str, lib, planes, noise: FrameNoise,
                  light_scalars, static, settings, out,
                  op_counts=None) -> None:
    """Launch K4 or K5 (`kernel`) from library `lib` over every vertex-count
    group: the first launch writes `out`, the others add to it. Each
    launch adds one to the counter f"{kernel}.launches" (core/trace.py)."""
    entry = getattr(lib, _KERNELS[kernel][1])
    table = noise.table
    for first, (nv, ids) in enumerate(vertex_groups(static)):
        ids_t = to_device_async(torch.tensor(ids, dtype=torch.int32),
                                planes.device)
        with torch.cuda.device(planes.device):
            err = entry(
                build.ptr(planes), planes.shape[1], build.ptr(table),
                table.shape[1], table.shape[2], build.ptr(noise.fetches),
                None if noise.pixels is None else build.ptr(noise.pixels),
                noise.width, build.ptr(light_scalars), build.ptr(ids_t),
                len(ids), nv, settings.sample_count, int(first == 0),
                float(settings.mis_visibility_estimate), build.ptr(out),
                None if op_counts is None else build.ptr(op_counts),
                build.stream(planes.device))
        build.check_launch(err, _KERNELS[kernel][1])
        trace.count(f"{kernel}.launches")


def load_kernel(kernel: str, static, settings, extra_defines=None):
    """K4's or K5's library for this light layout and settings; extra
    defines select a measurement build (VR_COUNT_OPS, VR_THREADS)."""
    name, entry = _KERNELS[kernel]
    return build.load_library(
        name, {entry: _ARGTYPES},
        defines={**library_defines(kernel, static, settings),
                 **(extra_defines or {})})


def _op_count_defines(planes, op_counts):
    """The counting build's defines, or none without op_counts (an int64
    tensor of len(OP_STAGES) * len(OP_KINDS) on the planes' device)."""
    if op_counts is None:
        return None
    build.require_cuda(planes, op_counts)
    build.check_tensor(op_counts, "op_counts", torch.int64,
                       (len(OP_STAGES) * len(OP_KINDS),))
    return {"VR_COUNT_OPS": 1}


def fused_light_shading(planes: torch.Tensor, noise: FrameNoise,
                        light_scalars: torch.Tensor, static,
                        settings: RenderSettings,
                        op_counts=None) -> torch.Tensor:
    """(62, P) planes, the frame's noise, (L, 58) light records ->
    (3 + 7 S, P).

    CPU tensors take fused_light_shading_plain; CUDA tensors launch K4 (one
    launch per distinct light vertex count). op_counts: the counting
    build adds the float operations it executes into it (a measurement
    build; see _op_count_defines)."""
    if planes.device.type == "cpu":
        return fused_light_shading_plain(planes, noise, light_scalars, static,
                                         settings)
    p = _check_inputs(planes, noise, light_scalars, static, settings)
    nout = 3 + 7 * rays_per_light(settings) * static.light_count
    if p == 0:
        return planes.new_zeros((nout, 0))
    lib = load_kernel("K4", static, settings,
                      _op_count_defines(planes, op_counts))
    out = torch.empty((nout, p), dtype=torch.float32, device=planes.device)
    launch_kernel("K4", lib, planes, noise, light_scalars, static, settings,
                  out, op_counts)
    return out


def fused_light_shading_resolved(planes: torch.Tensor, noise: FrameNoise,
                                 light_scalars: torch.Tensor, static,
                                 settings: RenderSettings,
                                 op_counts=None) -> torch.Tensor:
    """(62, P) base planes, the frame's noise, (L, 58) light records ->
    (P, 3) color with visibility 1.

    CPU tensors take fused_light_shading_resolved_plain; CUDA tensors
    launch K5 (one launch per distinct light vertex count). op_counts: as
    for fused_light_shading."""
    if planes.device.type == "cpu":
        return fused_light_shading_resolved_plain(planes, noise,
                                                  light_scalars, static,
                                                  settings)
    p = _check_inputs(planes, noise, light_scalars, static, settings)
    if p == 0:
        return planes.new_zeros((0, 3))
    lib = load_kernel("K5", static, settings,
                      _op_count_defines(planes, op_counts))
    out = torch.empty((3, p), dtype=torch.float32, device=planes.device)
    launch_kernel("K5", lib, planes, noise, light_scalars, static, settings,
                  out, op_counts)
    return out.T
