"""Per-pixel shading data and frame-level shading facts.

Counterpart of the parts of vulkan_renderer_tpu/render/shading.py that the
frame's fused path uses: FrameConstants, finish_shading_data (texture
fetch, Falcor material decode, normal mapping, hemisphere clip;
shading_pass.frag.glsl:779-823), untextured get_polygon_radiance and
pairs_per_light. The port's SceneStatic keeps only the facts the kernels
specialize on; the TPU budgets, re-trace and seed knobs of the JAX class
have no counterpart because the CUDA tracers are exact by construction.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.settings import ErrorDisplay, RenderSettings, SamplingStrategy
from ..ops.math_utils import dot, normalize
from .texture import sample_texture_grad
from .trace_kernel import (ATTR_BITANGENT, ATTR_DUVDX, ATTR_DUVDY,
                           ATTR_MATERIAL, ATTR_MTL, ATTR_NORMAL, ATTR_TANGENT,
                           ATTR_UV)

INVALID_PRIMITIVE = -1  # int32 primitive id of a miss (0xFFFFFFFF as uint32)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static scene facts (the reference's scene-dependent shader
    defines). light_vertex_counts: per-light vertex count, 3-8."""
    light_count: int
    light_texturing: tuple
    light_vertex_counts: tuple

    @staticmethod
    def for_scene(scene) -> "SceneStatic":
        count = scene.lights.count
        return SceneStatic(
            light_count=count,
            light_texturing=tuple(
                int(v) for v in scene.lights.texturing_technique.tolist()),
            light_vertex_counts=tuple(
                int(v) for v in scene.lights.vertex_count.tolist()))


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


def get_polygon_radiance(scene, light_index: int, texturing: int):
    """Radiance of an untextured polygonal light (glsl:142-185)."""
    if texturing != 0:
        raise NotImplementedError(
            "textured / IES polygonal lights are not ported yet "
            "(ROADMAP Queue 1, item 11)")
    return scene.lights.surface_radiance[light_index]


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
