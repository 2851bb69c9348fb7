"""The deferred shading pass: per-pixel shading data, and the per-pixel
Monte Carlo shading of polygonal lights for every sampling technique,
strategy, MIS heuristic and error display.

Counterpart of vulkan_renderer_tpu/render/shading.py (reference
shading_pass.frag.glsl): FrameConstants, finish_shading_data (texture
fetch, Falcor material decode, normal mapping, hemisphere clip;
glsl:779-823), get_polygon_radiance with every texturing mode,
radiance_brdf_deferred, evaluate_polygonal_light_shading and its GGX MIS
loop. The JAX package computes one pixel and vmaps it; here every function
takes a leading pixel axis P (vectors (P, 3), per-light ray slots
(P, S, ...)) and the light and sample loops are Python loops, as the
reference unrolls them. Light vertex counts are static ints
(SceneStatic.light_vertex_counts), as on the fused path.

The port's SceneStatic keeps only the facts the frame specializes on; the
TPU budgets, re-trace and seed knobs of the JAX class have no counterpart
because the CUDA tracers are exact by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import trace
from ..core.device import device_constant
from ..core.settings import (ErrorDisplay, MisHeuristic,
                             PolygonSamplingTechnique, RenderSettings,
                             SamplingStrategy)
from ..ops import sampling
from ..ops import sampling_arvo_psa as arvo_psa
from ..ops import sampling_related
from ..ops.brdf import (evaluate_brdf, ggx_reflected_direction_density,
                        sample_ggx_reflected_direction)
from ..ops.clipping import clip_polygon
from ..ops.intersect import polygonal_light_ray_intersection
from ..ops.ltc import evaluate_ltc_density
from ..ops.math_utils import (M_PI, dot, first_true_lane, normalize,
                              pick_lane)
from ..ops.mis import MisHeuristic as OpsMis
from ..ops.mis import mis_estimate, mis_weight_over_density
from .texture import sample_texture_grad, sample_texture_lod0
from .trace_kernel import (ATTR_BITANGENT, ATTR_DUVDX, ATTR_DUVDY,
                           ATTR_MATERIAL, ATTR_MTL, ATTR_NORMAL, ATTR_TANGENT,
                           ATTR_UV)

INVALID_PRIMITIVE = -1  # int32 primitive id of a miss (0xFFFFFFFF as uint32)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static scene facts (the reference's scene-dependent shader
    defines). light_vertex_counts: per-light vertex count, 3-8.
    fused: the shading path (render/pipeline.py): "auto" takes kernels
    K4/K5 wherever render/fused.py fused_supported holds and the
    per-pixel path elsewhere, "on" raises where it does not hold, "off"
    always takes the per-pixel path."""
    light_count: int
    light_texturing: tuple
    light_vertex_counts: tuple
    linear_light_count: int = 0
    fused: str = "auto"

    def __post_init__(self):
        if self.fused not in ("auto", "on", "off"):
            raise ValueError(f"fused must be auto, on or off, got "
                             f"{self.fused!r}")

    @staticmethod
    def for_scene(scene, fused: str = "auto") -> "SceneStatic":
        count = scene.lights.count
        return SceneStatic(
            light_count=count,
            light_texturing=tuple(
                int(v) for v in scene.lights.texturing_technique.tolist()),
            light_vertex_counts=tuple(
                int(v) for v in scene.lights.vertex_count.tolist()),
            linear_light_count=scene.linear_lights.count, fused=fused)


@dataclasses.dataclass
class FrameConstants:
    """per_frame_constants_t (main.h:488-505, main.c:2114-2157)."""
    camera_position: torch.Tensor  # (3,)
    pixel_to_ray: torch.Tensor     # (3, 3) pixel (x, y, 1) -> ray direction
    exposure_factor: float
    roughness_factor: float
    noise_random_numbers: tuple    # 4 uint32 values as Python ints


@dataclasses.dataclass
class ShadingData:
    """Per-pixel shading inputs (brdfs.glsl shading_data_t), leading pixel
    axis on every field."""
    position: torch.Tensor          # (P, 3)
    normal: torch.Tensor            # (P, 3)
    outgoing: torch.Tensor          # (P, 3)
    lambert_outgoing: torch.Tensor  # (P,)
    diffuse_albedo: torch.Tensor    # (P, 3)
    fresnel_0: torch.Tensor         # (P, 3)
    roughness: torch.Tensor         # (P,) GGX alpha, squared and clamped


def finish_shading_data(scene, constants: FrameConstants, attrs, position):
    """attrs: (ATTR_PLANES, P) attribute planes from the attribute kernel
    K3; position: (P, 3).

    Texture fetch + Falcor decode + normal mapping + hemisphere clip
    (shading_pass.frag.glsl:779-823), batched over pixels."""
    normal_interp = attrs[ATTR_NORMAL:ATTR_NORMAL + 3].T
    with trace.span("preamble.texture"):
        texel = sample_texture_grad(
            scene.material_atlas, attrs[ATTR_MATERIAL].long(),
            attrs[ATTR_UV:ATTR_UV + 2].T, attrs[ATTR_DUVDX:ATTR_DUVDX + 2].T,
            attrs[ATTR_DUVDY:ATTR_DUVDY + 2].T)
    tangent = attrs[ATTR_TANGENT:ATTR_TANGENT + 3].T
    bitangent = attrs[ATTR_BITANGENT:ATTR_BITANGENT + 3].T
    mean_tangent_length = attrs[ATTR_MTL]

    base_color = texel[:, 0:3]
    specular_data = texel[:, 3:6]
    normal_ts_xy = texel[:, 6:8] * 2.0 - 1.0
    nx, ny = normal_ts_xy[:, 0], normal_ts_xy[:, 1]
    normal_ts_z = torch.sqrt(torch.clamp(1.0 - nx * nx - ny * ny, min=0.0))

    # Falcor/Unreal-compatible material decode (glsl:786-796).
    metalicity = specular_data[:, 2:3]
    diffuse_albedo = base_color - metalicity * base_color
    fresnel_0 = (1.0 - metalicity) * 0.02 + metalicity * base_color
    linear_roughness = specular_data[:, 1]
    roughness = linear_roughness * linear_roughness
    roughness = torch.clamp(roughness * constants.roughness_factor,
                            0.0064, 1.0)

    nz = normal_ts_z * torch.clamp(mean_tangent_length, min=1.0e-10)
    normal = normalize(nx[:, None] * tangent + ny[:, None] * bitangent
                       + nz[:, None] * normal_interp)

    # Clip the shading normal into the outgoing hemisphere (glsl:815-823).
    outgoing = normalize(constants.camera_position - position)
    normal_offset = torch.clamp(1.0e-3 - dot(normal, outgoing), min=0.0)
    normal = normalize(normal_offset[:, None] * outgoing + normal)
    return ShadingData(position=position, normal=normal, outgoing=outgoing,
                       lambert_outgoing=dot(normal, outgoing),
                       diffuse_albedo=diffuse_albedo, fresnel_0=fresnel_0,
                       roughness=roughness)


def pairs_per_light(settings: RenderSettings) -> int:
    """Noise pairs each light consumes per pixel (matches the GLSL)."""
    if settings.error_display != ErrorDisplay.NONE:
        return max(settings.sample_count, 1)
    per_sample = {
        SamplingStrategy.DIFFUSE_ONLY: 1,
        SamplingStrategy.DIFFUSE_GGX_MIS: 2,
        SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY: 2,
        SamplingStrategy.DIFFUSE_SPECULAR_MIS: 2,
        SamplingStrategy.DIFFUSE_SPECULAR_RANDOM: 1,
    }[settings.sampling_strategy]
    return settings.sample_count * per_sample


def rays_per_light(settings: RenderSettings) -> int:
    """Shadow-ray slots per light: one per technique sample plus one per
    GGX or specular companion sample, which is the noise-pair budget. K4
    and K5 take the same count (n under DIFFUSE_ONLY, 2n under
    DIFFUSE_SPECULAR_MIS)."""
    return pairs_per_light(settings)


# ---------------------------------------------------------------------------
# Error display (shading_pass.frag.glsl:76-114)
# ---------------------------------------------------------------------------

_TAB20B = np.array([
    [0.04092, 0.04374, 0.19120], [0.08438, 0.08866, 0.36625],
    [0.14703, 0.15593, 0.62396], [0.33245, 0.34191, 0.73046],
    [0.12477, 0.19120, 0.04092], [0.26225, 0.36131, 0.08438],
    [0.46208, 0.62396, 0.14703], [0.61721, 0.70838, 0.33245],
    [0.26225, 0.15293, 0.03071], [0.50888, 0.34191, 0.04092],
    [0.79910, 0.49102, 0.08438], [0.79910, 0.59720, 0.29614],
    [0.23074, 0.04519, 0.04092], [0.41789, 0.06663, 0.06848],
    [0.67244, 0.11954, 0.14703], [0.79910, 0.30499, 0.33245],
    [0.19807, 0.05286, 0.17144], [0.37626, 0.08228, 0.29614],
    [0.61721, 0.15293, 0.50888], [0.73046, 0.34191, 0.67244],
], np.float32)
_TAB20B_ROWS = tuple(tuple(row) for row in _TAB20B.tolist())
# 20 colors over the five decades [1, 1e5), in float32 as the reference.
_ERROR_INDEX_SCALE = float(np.float32(20.0) / (np.float32(5.0)
                                               * np.log2(np.float32(10.0))))
_ERROR_MAX = float(np.float32(10.0 ** (5.0 - 0.01)))


def error_factor(settings: RenderSettings) -> float:
    """The error display's scale, 10^-error_min_exponent (main.c:2145)."""
    return float(np.float32(10.0 ** (-settings.error_min_exponent)))


def error_to_color(error, factor: float):
    """(P,) errors -> (P, 3) tab20b colors on a log scale."""
    e = torch.clamp(torch.abs(factor * error), 1.0, _ERROR_MAX)
    color_index = torch.log2(e) * _ERROR_INDEX_SCALE
    idx = torch.clamp(color_index.to(torch.int64), 0, 19)
    return device_constant(_TAB20B_ROWS, error.device)[idx]


# ---------------------------------------------------------------------------
# Light radiance and the radiance-BRDF product (glsl:119-239)
# ---------------------------------------------------------------------------


def _rows_times(rows, v):
    """rows (P, 3, >= 3) times v (P, 3): out_i = rows_i . v."""
    return torch.stack([rows[:, i, 0] * v[:, 0] + rows[:, i, 1] * v[:, 1]
                        + rows[:, i, 2] * v[:, 2] for i in range(3)], dim=-1)


def _rows_transposed_times(rows, d):
    """rows^T d for rows (P, 3, >= 3) (the shading axes): the world
    direction sum_i d_i rows_i."""
    return d[:, 0:1] * rows[:, 0, :3] + d[:, 1:2] * rows[:, 1, :3] \
        + d[:, 2:3] * rows[:, 2, :3]


def get_polygon_radiance(scene, light_index: int, texturing: int,
                         sampled_dir, shading_position):
    """Incoming radiance from light `light_index` along sampled_dir (P, 3)
    seen from shading_position ((P, 3) or (3,)) (glsl:142-185).
    texturing (static per light): 0 none ((3,) radiance), 1 area
    texture, 2 light probe (portal), 3 IES profile (divided by |cos| of
    the emission angle, so infinite at grazing angles as in the
    reference)."""
    lights = scene.lights
    radiance = lights.surface_radiance[light_index]
    if texturing == 0:
        return radiance
    plane = lights.plane[light_index]
    rotation = lights.rotation[light_index]
    if texturing == 1:  # area
        t = -(dot(plane[:3], shading_position) + plane[3]) \
            / dot(sampled_dir, plane[:3])
        intersection = shading_position + t[:, None] * sampled_dir \
            - lights.translation[light_index]
        # rotation^T intersection, x and y only.
        tex_coord = torch.stack([
            dot(rotation[:, c], intersection) * scale for c, scale in
            ((0, lights.inv_scaling_x[light_index]),
             (1, lights.inv_scaling_y[light_index]))], dim=-1)
    else:
        if texturing == 3:  # IES profile
            lookup = torch.stack([dot(rotation[:, c], sampled_dir)
                                  for c in range(3)], dim=-1)
            radiance = radiance / torch.abs(lookup[:, 2:3])
        else:  # light probe convention
            lookup = torch.stack([-sampled_dir[:, 0], sampled_dir[:, 1],
                                  sampled_dir[:, 2]], dim=-1)
        tex_coord = torch.stack([
            torch.atan2(lookup[:, 1], lookup[:, 0]) * (0.5 / M_PI),
            torch.acos(torch.clamp(lookup[:, 2], -1.0, 1.0)) * (1.0 / M_PI)],
            dim=-1)
    texel = sample_texture_lod0(scene.light_atlas,
                                lights.texture_index[light_index], tex_coord)
    return radiance * texel[:, :3]


def radiance_brdf_deferred(scene, light_index: int, texturing: int,
                           sampled_dir, data: ShadingData,
                           diffuse: bool = True, specular: bool = True):
    """get_polygon_radiance_visibility_brdf_product (glsl:195-239) with
    visibility deferred: the value assuming the shadow ray is unoccluded
    (the geometric lambert > 0 gate still applies) and the shadow ray's
    t range. Every estimator is affine in the visibility, so the shadow
    rays batch into one megabatch trace.

    Returns (value_if_visible (P, 3), lambert (P,), t_max (P,))."""
    lambert = dot(data.normal, sampled_dir)
    geo_visible = lambert > 0.0
    plane = scene.lights.plane[light_index]
    denom = dot(sampled_dir, plane[:3])
    t_max = -(dot(plane[:3], data.position) + plane[3]) \
        / torch.where(denom != 0.0, denom, 1.0)
    radiance = get_polygon_radiance(scene, light_index, texturing,
                                    sampled_dir, data.position)
    brdf = evaluate_brdf(data, sampled_dir, diffuse, specular)
    value = torch.where(geo_visible[:, None], radiance * brdf, 0.0)
    return value, lambert, torch.where(geo_visible, t_max, 0.0)


# ---------------------------------------------------------------------------
# Per-light shading (glsl:329-711)
# ---------------------------------------------------------------------------

_HEURISTICS = {h: OpsMis(h.value) for h in MisHeuristic}
# Arvo's PSA drops samples this close to the horizon (a float32 value).
_HORIZON_Z = float(np.float32(1e-5))
Tech = PolygonSamplingTechnique
_DIFFUSE_ERRORS = {ErrorDisplay.DIFFUSE_BACKWARD: 0,
                   ErrorDisplay.DIFFUSE_BACKWARD_SCALED: 1,
                   ErrorDisplay.DIFFUSE_FORWARD: 2}
_SPECULAR_ERRORS = {ErrorDisplay.SPECULAR_BACKWARD: 0,
                    ErrorDisplay.SPECULAR_BACKWARD_SCALED: 1,
                    ErrorDisplay.SPECULAR_FORWARD: 2}


@dataclasses.dataclass
class LightShadingResult:
    """One light's deferred shading at every pixel: its contribution is
    base + sum_i b[:, i] V_i, V_i the visibility of shadow ray i."""
    base: torch.Tensor      # (P, 3)
    b: torch.Tensor         # (P, S, 3)
    ray_dirs: torch.Tensor  # (P, S, 3)
    t_max: torch.Tensor     # (P, S)


def _no_ray(a_color, ray_count: int):
    p = a_color.shape[0]
    return LightShadingResult(
        a_color, a_color.new_zeros((p, ray_count, 3)),
        device_constant((0.0, 0.0, 1.0), a_color.device).expand(
            p, ray_count, 3),
        a_color.new_zeros((p, ray_count)))


def _transform_to_local(world_to_local, verts):
    """(P, 3, 4) affine transforms applied to (m, 3) points -> (P, m, 3)."""
    w = world_to_local
    return torch.stack([
        verts[None, :, 0] * w[:, i, None, 0]
        + verts[None, :, 1] * w[:, i, None, 1]
        + verts[None, :, 2] * w[:, i, None, 2] + w[:, i, None, 3]
        for i in range(3)], dim=-1)


def _flip_row_1(matrix, flip):
    """matrix (P, 3, k) with row 1 multiplied by flip (P,)."""
    return torch.cat([matrix[:, 0:1], matrix[:, 1:2] * flip[:, None, None],
                      matrix[:, 2:3]], dim=1)


def _sample_area_polygon_turk(vertex_count: int, verts_world, fan_areas,
                              random_numbers):
    """Uniform area sampling over the light's triangle fan
    (polygon_sampling_related_work.glsl:38-64; the JAX package's
    _sample_area_polygon_turk): a world position (P, 3). verts_world:
    (MAXL, 3), the first vertex repeated past vertex_count; fan_areas:
    (MAXL - 2, 2) (area, cumulative area) per fan triangle."""
    p = random_numbers.shape[0]
    tri_count = fan_areas.shape[0]
    target = fan_areas[tri_count - 1, 1] * random_numbers[:, 0]
    tri = torch.arange(tri_count, device=target.device)
    valid = (tri + 3 <= max(vertex_count, 3))[None]
    reached = (fan_areas[None, :, 1] >= target[:, None]) & valid
    sel = first_true_lane(reached, torch.full_like(
        target, max(vertex_count - 3, 0), dtype=torch.int32))
    fans = fan_areas[None].expand(p, -1, -1)
    verts = verts_world[None].expand(p, -1, -1)
    sub_area = target - pick_lane(fans[..., 1], sel - 1)  # 0 at sel 0
    tri_area = pick_lane(fans[..., 0], sel)
    v0 = pick_lane(verts, sel + 1)
    v2 = pick_lane(verts, sel + 2)
    r0 = sub_area / torch.where(tri_area != 0.0, tri_area, 1.0)
    sqrt_r0 = torch.sqrt(torch.clamp(r0, min=0.0))
    r1 = random_numbers[:, 1]
    b0 = (1.0 - sqrt_r0)[:, None]
    b1 = (sqrt_r0 * r1)[:, None]
    b2 = (-sqrt_r0 * r1 + sqrt_r0)[:, None]
    return b0 * v0 + b1 * verts_world[0] + b2 * v2


def evaluate_polygonal_light_shading(scene, static: SceneStatic,
                                     settings: RenderSettings,
                                     constants: FrameConstants,
                                     light_index: int, data: ShadingData,
                                     ltc, noise_pairs) -> LightShadingResult:
    """Monte Carlo shading of light `light_index` at every pixel.
    noise_pairs: (P, pairs_per_light(settings), 2). Shadow rays are
    emitted for the deferred megabatch trace (LightShadingResult); every
    light has rays_per_light(settings) slots, the unused ones padded with
    direction (0, 0, 1), t_max 0 and weight 0."""
    tech = settings.polygon_sampling_technique
    strategy = settings.sampling_strategy
    lights = scene.lights
    texturing = static.light_texturing[light_index]
    nv = static.light_vertex_counts[light_index]
    n = settings.sample_count
    total_rays = rays_per_light(settings)
    verts_world = lights.vertices_world_space[light_index][:nv]
    err_factor = error_factor(settings)
    exposure = float(constants.exposure_factor)
    p = data.position.shape[0]
    zero3 = torch.zeros_like(data.position)

    def rad_brdf(sampled_dir, diffuse=True, specular=True):
        return radiance_brdf_deferred(scene, light_index, texturing,
                                      sampled_dir, data, diffuse, specular)

    def light_splat(sampled_dir, density):
        """get_polygonal_light_mis_estimate (glsl:300-323), deferred:
        (a, b (P, 1, 3), dir (P, 1, 3), t_max (P, 1)) of one ray."""
        value1, lambert, t_max = rad_brdf(sampled_dir)
        if strategy == SamplingStrategy.DIFFUSE_ONLY:
            ok = density > 0.0
            b = torch.where(ok[:, None], value1 * (
                lambert / torch.where(ok, density, 1.0))[:, None], 0.0)
        elif strategy == SamplingStrategy.DIFFUSE_GGX_MIS:
            ggx_density = ggx_reflected_direction_density(
                data.lambert_outgoing, data.outgoing, sampled_dir,
                data.normal, data.roughness)
            heuristic = OpsMis.POWER \
                if settings.mis_heuristic == MisHeuristic.POWER \
                else OpsMis.BALANCE
            wod = mis_weight_over_density(heuristic, density, ggx_density)
            b = value1 * lambert[:, None] * wod[:, None]
        else:
            b = zero3
        return zero3, b[:, None], sampled_dir[:, None], t_max[:, None]

    pair_cursor = 0

    def take_pairs(count):
        nonlocal pair_cursor
        pairs = noise_pairs[:, pair_cursor:pair_cursor + count]
        pair_cursor += count
        return pairs

    def over_samples(per_sample, pairs):
        """per_sample over the samples' noise pairs, slots sample-major:
        (a_sum, b (P, n R, 3), dirs (P, n R, 3), t_max (P, n R))."""
        outs = [per_sample(pairs[:, s]) for s in range(pairs.shape[1])]
        a = outs[0][0]
        for o in outs[1:]:
            a = a + o[0]
        return (a, torch.cat([o[1] for o in outs], dim=1),
                torch.cat([o[2] for o in outs], dim=1),
                torch.cat([o[3] for o in outs], dim=1))

    def finish(parts):
        """Sum the parts' a, concatenate their rays, scale by 1/n and pad
        to total_rays."""
        a = zero3
        for part in parts:
            a = a + part[0]
        b = torch.cat([part[1] for part in parts], dim=1)
        d = torch.cat([part[2] for part in parts], dim=1)
        t = torch.cat([part[3] for part in parts], dim=1)
        pad = total_rays - b.shape[1]
        if pad > 0:
            b = torch.cat([b, b.new_zeros((p, pad, 3))], dim=1)
            d = torch.cat([d, device_constant((0.0, 0.0, 1.0), d.device)
                           .expand(p, pad, 3)], dim=1)
            t = torch.cat([t, t.new_zeros((p, pad))], dim=1)
        scale = float(np.float32(1.0 / n))
        return LightShadingResult(a * scale, b * scale, d, t)

    def gated(splat, good):
        a, b, dirs, t_max = splat
        return a, torch.where(good[:, None, None], b, 0.0), dirs, t_max

    def error_color(errors, index, ok):
        color = error_to_color(errors[:, index], err_factor)
        return _no_ray(torch.where(ok[:, None], color / exposure, 0.0),
                       total_rays)

    # ---- world-space techniques (no clipping) ------------------------------
    if tech == Tech.BASELINE:
        corner_offset = lights.translation[light_index] - data.position
        rot = lights.rotation[light_index]

        def one_sample(rnd):
            d = normalize(corner_offset + rnd[:, 0:1] * rot[:, 0]
                          + rnd[:, 1:2] * rot[:, 1])
            return light_splat(d, torch.ones_like(rnd[:, 0]))

        parts = [over_samples(one_sample, take_pairs(n))]

    elif tech == Tech.AREA_TURK:
        plane = lights.plane[light_index]

        def one_sample(rnd):
            light_sample = _sample_area_polygon_turk(
                nv, lights.vertices_world_space[light_index],
                lights.fan_areas[light_index], rnd)
            offset = light_sample - data.position
            dist_sq = dot(offset, offset)
            d = offset / torch.sqrt(dist_sq)[:, None]
            projected = torch.abs(dot(plane[:3], d)) * lights.area[light_index]
            return light_splat(d, dist_sq / projected)

        parts = [over_samples(one_sample, take_pairs(n))]

    elif tech in (Tech.SOLID_ANGLE, Tech.SOLID_ANGLE_ARVO):
        if tech == Tech.SOLID_ANGLE:
            poly = sampling.prepare_solid_angle_polygon_sampling(
                verts_world, nv, data.position)
            sample = sampling.sample_solid_angle_polygon
        else:
            poly = sampling_related.prepare_solid_angle_polygon_sampling_arvo(
                verts_world, nv, data.position)
            sample = sampling_related.sample_solid_angle_polygon_arvo
        ok = poly.solid_angle > 0.0
        density = 1.0 / torch.where(ok, poly.solid_angle, 1.0)

        def one_sample(rnd):
            return gated(light_splat(sample(poly, rnd), density), ok)

        parts = [over_samples(one_sample, take_pairs(n))]

    elif tech == Tech.RECTANGLE_SOLID_ANGLE_URENA:
        # Rectangular lights only (GUI legality in the reference; call
        # signature per shading_pass.frag.glsl:355-362).
        rot = lights.rotation[light_index]
        poly = sampling_related.prepare_solid_angle_rectangle_sampling_urena(
            lights.translation[light_index], lights.scaling_x[light_index],
            lights.scaling_y[light_index], rot[:, 0], rot[:, 1], rot[:, 2],
            data.position)
        ok = poly.solid_angle > 0.0
        density = 1.0 / torch.where(ok, poly.solid_angle, 1.0)

        def one_sample(rnd):
            d = sampling_related.sample_solid_angle_rectangle_urena(poly, rnd)
            return gated(light_splat(d, density), ok)

        parts = [over_samples(one_sample, take_pairs(n))]

    # ---- shading-space techniques (clipping, diffuse-only family) ----------
    elif tech in (Tech.CLIPPED_SOLID_ANGLE, Tech.BILINEAR_COSINE_WARP_HART,
                  Tech.BILINEAR_COSINE_WARP_CLIPPING_HART,
                  Tech.BIQUADRATIC_COSINE_WARP_HART,
                  Tech.BIQUADRATIC_COSINE_WARP_CLIPPING_HART):
        w2s = ltc.world_to_shading_space
        verts_shading = _transform_to_local(w2s, verts_world)
        if tech in (Tech.BILINEAR_COSINE_WARP_HART,
                    Tech.BIQUADRATIC_COSINE_WARP_HART):
            clipped, clip_count = verts_shading, nv
            ok = torch.ones_like(data.roughness, dtype=torch.bool)
        else:
            clipped, clip_count = clip_polygon(verts_shading, nv)
            ok = clip_count > 0
            clip_count = torch.clamp(clip_count, min=3)

        if tech == Tech.CLIPPED_SOLID_ANGLE:
            poly = sampling.prepare_solid_angle_polygon_sampling(
                clipped, clip_count, None)
            density = 1.0 / torch.where(poly.solid_angle > 0.0,
                                        poly.solid_angle, 1.0)

            def sample_shading(rnd):
                return sampling.sample_solid_angle_polygon(poly, rnd), density
        else:
            if tech in (Tech.BILINEAR_COSINE_WARP_HART,
                        Tech.BILINEAR_COSINE_WARP_CLIPPING_HART):
                warp = sampling_related \
                    .prepare_bilinear_cosine_warp_polygon_sampling_hart(
                        clipped, clip_count)
                sample_warp = sampling_related \
                    .sample_bilinear_cosine_warp_polygon_hart
            else:
                warp = sampling_related \
                    .prepare_biquadratic_cosine_warp_polygon_sampling_hart(
                        clipped, clip_count)
                sample_warp = sampling_related \
                    .sample_biquadratic_cosine_warp_polygon_hart
            poly = warp.polygon

            def sample_shading(rnd):
                return sample_warp(warp, rnd)

        good = ok & (poly.solid_angle > 0.0)

        def one_sample(rnd):
            d_shading, density = sample_shading(rnd)
            d = _rows_transposed_times(w2s, d_shading)
            return gated(light_splat(d, density), good)

        parts = [over_samples(one_sample, take_pairs(n))]

    # ---- projected solid angle (ours, biased, Arvo) ------------------------
    elif tech in (Tech.PROJECTED_SOLID_ANGLE,
                  Tech.PROJECTED_SOLID_ANGLE_BIASED,
                  Tech.PROJECTED_SOLID_ANGLE_ARVO):
        return _psa_light_shading(
            scene, static, settings, light_index, data, ltc, tech,
            verts_world, nv, rad_brdf, light_splat, take_pairs,
            over_samples, finish, gated, error_color)
    else:
        raise ValueError(f"unknown technique {tech}")

    # GGX MIS companion loop for the world- and shading-space techniques.
    if strategy == SamplingStrategy.DIFFUSE_GGX_MIS:
        if tech in (Tech.SOLID_ANGLE, Tech.SOLID_ANGLE_ARVO,
                    Tech.CLIPPED_SOLID_ANGLE):
            density_factor = 1.0 / torch.where(poly.solid_angle > 0.0,
                                               poly.solid_angle, 1.0)
        else:
            density_factor = torch.ones_like(data.roughness)
        parts.append(_ggx_mis_loop(
            settings, data, ltc.world_to_shading_space, scene, light_index,
            nv, density_factor, False, take_pairs(n), rad_brdf))
    return finish(parts)


def _psa_light_shading(scene, static, settings, light_index, data, ltc,
                       tech, verts_world, nv, rad_brdf, light_splat,
                       take_pairs, over_samples, finish, gated, error_color):
    """The projected-solid-angle family (shading.py:695-976 of the JAX
    package; glsl:444-670): the diffuse-only and GGX MIS strategies for
    all three techniques and the combined diffuse + specular strategies
    for the PSA pair, each with its error displays."""
    strategy = settings.sampling_strategy
    n = settings.sample_count
    biased = tech == Tech.PROJECTED_SOLID_ANGLE_BIASED
    lights = scene.lights
    # Flip the shading frame's y if the shading point is behind the light
    # plane to restore clockwise winding (glsl:444-452).
    plane = lights.plane[light_index]
    side = dot(plane[:3], data.position) + plane[3]
    flip = torch.where(side < 0.0, -1.0, 1.0)
    w2s = _flip_row_1(ltc.world_to_shading_space, flip)
    w2c = _flip_row_1(ltc.world_to_cosine_space, flip)
    c2s = ltc.cosine_to_shading_space

    clipped, clip_count = clip_polygon(_transform_to_local(w2s, verts_world),
                                       nv)
    diffuse_ok = clip_count > 0
    error_display = settings.error_display
    one_sample = None

    if tech == Tech.PROJECTED_SOLID_ANGLE_ARVO:
        # Settings legality: Arvo PSA takes DIFFUSE_ONLY or GGX MIS.
        poly = arvo_psa.prepare_projected_solid_angle_polygon_sampling_arvo(
            clipped, clip_count)
        psa_d = poly.projected_solid_angle
        diffuse_ok = diffuse_ok & (psa_d > 0.0)
        if error_display in (ErrorDisplay.DIFFUSE_BACKWARD,
                             ErrorDisplay.DIFFUSE_BACKWARD_SCALED):
            rnd = take_pairs(1)[:, 0]
            d = arvo_psa.sample_projected_solid_angle_polygon_arvo(poly, rnd)
            errors = arvo_psa \
                .compute_projected_solid_angle_polygon_sampling_error_arvo(
                    poly, rnd, d)
            return error_color(errors, _DIFFUSE_ERRORS[error_display],
                               diffuse_ok)
        rcp_psa = 1.0 / torch.where(psa_d > 0.0, psa_d, 1.0)

        def one_sample(rnd):
            d_shading = arvo_psa.sample_projected_solid_angle_polygon_arvo(
                poly, rnd)
            d = _rows_transposed_times(w2s, d_shading)
            # Arvo's method lands samples exactly on the horizon; there
            # the lambert/z cancellation breaks down in float32 and
            # fireflies explode, so tiny-z samples are dropped (the
            # unstable baseline the paper compares against).
            good = diffuse_ok & (d_shading[:, 2] > _HORIZON_Z)
            return gated(light_splat(d, d_shading[:, 2] * rcp_psa), good)
    else:
        poly_d = sampling.prepare_projected_solid_angle_polygon_sampling(
            clipped, clip_count, biased)
        psa_d = poly_d.projected_solid_angle
        diffuse_ok = diffuse_ok & (psa_d > 0.0)
        rcp_psa_d = 1.0 / torch.where(psa_d > 0.0, psa_d, 1.0)

    def psa_error(poly, ok, index):
        rnd = take_pairs(1)[:, 0]
        d = sampling.sample_projected_solid_angle_polygon(poly, rnd, biased)
        errors = sampling.compute_projected_solid_angle_polygon_sampling_error(
            poly, rnd, d)
        return error_color(errors, index, ok)

    if one_sample is not None:
        parts = [over_samples(one_sample, take_pairs(n))]
    elif strategy in (SamplingStrategy.DIFFUSE_ONLY,
                      SamplingStrategy.DIFFUSE_GGX_MIS):
        if error_display in _DIFFUSE_ERRORS:
            return psa_error(poly_d, diffuse_ok,
                             _DIFFUSE_ERRORS[error_display])

        def one_sample(rnd):
            d_shading = sampling.sample_projected_solid_angle_polygon(
                poly_d, rnd, biased)
            d = _rows_transposed_times(w2s, d_shading)
            return gated(light_splat(d, d_shading[:, 2] * rcp_psa_d),
                         diffuse_ok)

        parts = [over_samples(one_sample, take_pairs(n))]
    else:
        # Combined diffuse + specular strategies (glsl:506-670).
        clipped_c, clip_count_c = clip_polygon(
            _transform_to_local(w2c, verts_world), nv)
        poly_s = sampling.prepare_projected_solid_angle_polygon_sampling(
            clipped_c, clip_count_c, biased)
        psa_s = torch.where(clip_count_c > 0, poly_s.projected_solid_angle,
                            0.0)
        specular_ok = psa_s > 0.0
        specular_albedo = ltc.albedo
        specular_weight = specular_albedo * psa_s

        if error_display in _DIFFUSE_ERRORS:
            return psa_error(poly_d, diffuse_ok,
                             _DIFFUSE_ERRORS[error_display])
        if error_display in _SPECULAR_ERRORS:
            return psa_error(poly_s, specular_ok,
                             _SPECULAR_ERRORS[error_display])

        def sample_specular(rnd):
            d_cosine = sampling.sample_projected_solid_angle_polygon(
                poly_s, rnd, biased)
            return d_cosine, normalize(_rows_times(c2s, d_cosine))

        if strategy == SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY:
            def one_pair_sample(rnd_d, rnd_s):
                d_shading = sampling.sample_projected_solid_angle_polygon(
                    poly_d, rnd_d, biased)
                d = _rows_transposed_times(w2s, d_shading)
                value1, _, t_max_d = rad_brdf(d, True, False)
                b_d = torch.where(diffuse_ok[:, None],
                                  value1 * psa_d[:, None], 0.0)
                d_cosine, d_shading_s = sample_specular(rnd_s)
                ltc_density = evaluate_ltc_density(ltc, d_shading_s, 1.0)
                d_s = _rows_transposed_times(w2s, d_shading_s)
                value_s, _, t_max_s = rad_brdf(d_s, False, True)
                spec = value_s * d_shading_s[:, 2:3] * psa_s[:, None] \
                    / torch.where(ltc_density > 0.0, ltc_density,
                                  1.0)[:, None]
                good = specular_ok & (d_shading_s[:, 2] > 0.0) \
                    & (d_cosine[:, 2] > 0.0) & (ltc_density > 0.0)
                b_s = torch.where((diffuse_ok & good)[:, None], spec, 0.0)
                return (torch.zeros_like(b_d), torch.stack([b_d, b_s], 1),
                        torch.stack([d, d_s], 1),
                        torch.stack([t_max_d, t_max_s], 1))

            parts = [_over_pair_samples(one_pair_sample, take_pairs(2 * n),
                                        over_samples)]

        elif strategy == SamplingStrategy.DIFFUSE_SPECULAR_MIS:
            heuristic = _HEURISTICS[settings.mis_heuristic]
            vis = float(settings.mis_visibility_estimate)
            diffuse_weight = torch.clamp(data.diffuse_albedo, min=0.01) \
                * psa_d[:, None]
            rcp_psa_s = 1.0 / torch.where(psa_s > 0.0, psa_s, 1.0)
            specular_weight_rgb = specular_weight[:, None].expand(-1, 3)
            if settings.mis_heuristic == MisHeuristic.OPTIMAL:
                radiance_over_pi = lights.surface_radiance[light_index] \
                    * float(np.float32(1.0 / M_PI))
                diffuse_weight = diffuse_weight * radiance_over_pi
                specular_weight_rgb = specular_weight_rgb * radiance_over_pi

            def one_pair_sample(rnd_d, rnd_s):
                d_diffuse = sampling.sample_projected_solid_angle_polygon(
                    poly_d, rnd_d, biased)
                _, d_specular = sample_specular(rnd_s)
                a_out = torch.zeros_like(diffuse_weight)
                b_out, dir_out, t_out = [], [], []
                for j, d_shading in enumerate((d_diffuse, d_specular)):
                    in_upper = d_shading[:, 2] > 0.0
                    diffuse_density = d_shading[:, 2] * rcp_psa_d
                    specular_density = evaluate_ltc_density(ltc, d_shading,
                                                            rcp_psa_s)
                    d_world = _rows_transposed_times(w2s, d_shading)
                    value1, _, t_max = rad_brdf(d_world)
                    integrand1 = d_shading[:, 2:3] * value1
                    if j == 0:
                        weights = (diffuse_weight, diffuse_density,
                                   specular_weight_rgb, specular_density)
                    else:
                        weights = (specular_weight_rgb, specular_density,
                                   diffuse_weight, diffuse_density)
                    # The estimator is affine in the integrand, which is
                    # linear in V: the V-independent part est(0) and the
                    # ray weight est(1) - est(0).
                    est0 = mis_estimate(heuristic,
                                        torch.zeros_like(integrand1),
                                        *weights, vis)
                    est1 = mis_estimate(heuristic, integrand1, *weights, vis)
                    if j == 0:
                        no_mis1 = integrand1 / torch.where(
                            diffuse_density > 0.0, diffuse_density,
                            1.0)[:, None]
                        a_term = torch.where(specular_ok[:, None], est0, 0.0)
                        b_term = torch.where(specular_ok[:, None],
                                             est1 - est0, no_mis1)
                        gate = in_upper & diffuse_ok
                    else:
                        a_term = est0
                        b_term = est1 - est0
                        gate = in_upper & diffuse_ok & specular_ok
                    a_out = a_out + torch.where(gate[:, None], a_term, 0.0)
                    b_out.append(torch.where(gate[:, None], b_term, 0.0))
                    dir_out.append(d_world)
                    t_out.append(t_max)
                return (a_out, torch.stack(b_out, 1),
                        torch.stack(dir_out, 1), torch.stack(t_out, 1))

            parts = [_over_pair_samples(one_pair_sample, take_pairs(2 * n),
                                        over_samples)]

        else:  # DIFFUSE_SPECULAR_RANDOM
            lum = device_constant((0.21263901, 0.71516868, 0.07219232),
                                  data.diffuse_albedo.device)
            diffuse_albedo = torch.clamp(dot(data.diffuse_albedo, lum),
                                         min=0.01)
            diffuse_weight = diffuse_albedo * psa_d
            ratio = diffuse_weight / (diffuse_weight + specular_weight)

            def one_sample(rnd):
                spec_selected = rnd[:, 0] >= ratio
                offset = torch.where(spec_selected, 1.0, 0.0)
                r0 = (rnd[:, 0] - offset) / (ratio - offset)
                rnd2 = torch.stack([r0, rnd[:, 1]], dim=-1)
                d_d = sampling.sample_projected_solid_angle_polygon(
                    poly_d, rnd2, biased)
                _, d_s = sample_specular(rnd2)
                d_shading = torch.where(spec_selected[:, None], d_s, d_d)
                lam = d_shading[:, 2]
                diffuse_density = lam * diffuse_albedo
                specular_density = evaluate_ltc_density(ltc, d_shading,
                                                        specular_albedo)
                density = (diffuse_density + specular_density) \
                    / (diffuse_weight + specular_weight)
                d_world = _rows_transposed_times(w2s, d_shading)
                value1, _, t_max = rad_brdf(d_world)
                est = value1 * lam[:, None] \
                    / torch.where(density > 0.0, density, 1.0)[:, None]
                gate = (lam > 0.0) & diffuse_ok & (density > 0.0)
                return (torch.zeros_like(est),
                        torch.where(gate[:, None], est, 0.0)[:, None],
                        d_world[:, None], t_max[:, None])

            parts = [over_samples(one_sample, take_pairs(n))]

    # The GGX MIS loop shares the diffuse polygon's density.
    if strategy == SamplingStrategy.DIFFUSE_GGX_MIS:
        parts.append(_ggx_mis_loop(
            settings, data, w2s, scene, light_index, nv,
            1.0 / torch.where(psa_d > 0.0, psa_d, 1.0), True,
            take_pairs(n), rad_brdf))
    return finish(parts)


def _over_pair_samples(one_pair_sample, pairs, over_samples):
    """Samples that take two consecutive noise pairs each: sample s reads
    pairs 2 s and 2 s + 1 (take_pairs(2 n).reshape(n, 2, 2))."""
    p = pairs.shape[0]
    grouped = pairs.reshape(p, -1, 2, 2)
    return over_samples(lambda rnd2: one_pair_sample(rnd2[:, 0], rnd2[:, 1]),
                        grouped)


def _ggx_mis_loop(settings, data, w2s, scene, light_index: int, nv: int,
                  density_factor, density_times_lambert: bool, pairs,
                  rad_brdf):
    """The BRDF-sampling half of the diffuse/GGX MIS strategy
    (glsl:676-709), deferred: (a, b (P, n, 3), dirs (P, n, 3),
    t_max (P, n)). w2s: (P, 3, >= 3) world->shading rows."""
    outgoing_shading = _rows_times(w2s, data.outgoing)
    outgoing_shading = torch.stack(
        [outgoing_shading[:, 0], torch.zeros_like(outgoing_shading[:, 1]),
         outgoing_shading[:, 2]], dim=-1)
    lights = scene.lights
    plane = lights.plane[light_index]
    heuristic = OpsMis.POWER if settings.mis_heuristic == MisHeuristic.POWER \
        else OpsMis.BALANCE
    b_all, d_all, t_all = [], [], []
    for s in range(pairs.shape[1]):
        d_shading, ggx_density = sample_ggx_reflected_direction(
            outgoing_shading, data.roughness, pairs[:, s])
        d_world = _rows_transposed_times(w2s, d_shading)
        hit = polygonal_light_ray_intersection(
            plane, lights.vertices_world_space[light_index], nv,
            data.position,
            torch.cat([d_world, torch.zeros_like(d_world[:, :1])], dim=1))
        value1, lambert, t_max = rad_brdf(d_world)
        polygon_density = lambert * density_factor if density_times_lambert \
            else density_factor
        wod = mis_weight_over_density(heuristic, ggx_density,
                                      polygon_density)
        est = value1 * lambert[:, None] * wod[:, None]
        gate = (d_shading[:, 2] > 0.0) & hit
        b_all.append(torch.where(gate[:, None], est, 0.0))
        d_all.append(d_world)
        t_all.append(t_max)
    return (torch.zeros_like(data.position), torch.stack(b_all, 1),
            torch.stack(d_all, 1), torch.stack(t_all, 1))
