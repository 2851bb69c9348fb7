"""The frame: render(scene, camera, settings) -> image.

Counterpart of vulkan_renderer_tpu/render/pipeline.py::_render_frame_body
on its accelerator path (Pallas tracers + fused shader), stage by stage:

1. camera rays, pixels row-major (:372-373);
2. primary closest hit (K2) and attribute fetch (K3);
3. the noise image (ops/noise.py);
4. the per-pixel preamble: texture fetch and material decode, light
   display, LTC coefficients (:78-120);
5. fused light shading: with shadow rays, K4 exports every ray slot;
   without them, K5 accumulates each pixel's color with visibility 1
   (:503-514);
6. the sample-major shadow megabatch; a ray whose weight is zero gets
   t_max = -1 and is dead (:537-552);
7. shadow any-hit (K1);
8. the resolve: base + sum_slot b * V, NaN/Inf -> pink, exposure, sRGB
   (:587-594).

Everything between the kernels is plain PyTorch on the scene's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from vulkan_renderer_tpu.core.settings import RenderSettings
from vulkan_renderer_tpu.scene.camera import (
    FirstPersonCamera, get_pixel_to_ray_direction_world_space)

from ..ops.intersect import polygonal_light_ray_intersection
from ..ops.ltc import get_ltc_coefficients
from ..ops.noise import get_noise_image
from ..ops.srgb import linear_to_srgb
from .fused import (check_supported, fused_light_shading,
                    fused_light_shading_plain, fused_light_shading_resolved,
                    fused_light_shading_resolved_plain,
                    pack_light_scalars, pack_planes, rays_per_light)
from .shading import (FrameConstants, SceneStatic, finish_shading_data,
                      get_polygon_radiance, pairs_per_light)
from .trace_kernel import (closest_attrs, closest_attrs_plain, trace_anyhit,
                           trace_anyhit_plain, trace_closest,
                           trace_closest_plain)


@dataclasses.dataclass(frozen=True)
class FrameKernels:
    """The kernel entry points a frame calls, with the signatures of the
    wrappers in trace_kernel.py and fused.py."""
    trace_closest: Callable    # K2
    closest_attrs: Callable    # K3
    fused_shading: Callable    # K4
    trace_anyhit: Callable     # K1
    fused_resolved: Callable   # K5


# The frame's kernels: CUDA on CUDA tensors, plain versions on the CPU.
KERNELS = FrameKernels(trace_closest, closest_attrs, fused_light_shading,
                       trace_anyhit, fused_light_shading_resolved)
# The plain versions on any device: the on-card reference of a frame.
PLAIN_VERSIONS = FrameKernels(trace_closest_plain, closest_attrs_plain,
                              fused_light_shading_plain, trace_anyhit_plain,
                              fused_light_shading_resolved_plain)


def make_frame_constants(camera: FirstPersonCamera, width: int, height: int,
                         settings: RenderSettings, noise_random_numbers,
                         device) -> FrameConstants:
    return FrameConstants(
        camera_position=torch.as_tensor(
            np.asarray(camera.position_world_space, np.float32),
            device=device),
        pixel_to_ray=torch.as_tensor(
            get_pixel_to_ray_direction_world_space(camera, width, height),
            device=device),
        exposure_factor=float(settings.exposure_factor),
        roughness_factor=float(settings.roughness_factor),
        noise_random_numbers=tuple(
            int(v) for v in np.asarray(noise_random_numbers, np.uint32)),
    )


def camera_rays(constants: FrameConstants, width: int, height: int):
    """Row-major (P, 3) ray directions: pixel_to_ray @ (x, y, 1)."""
    device = constants.pixel_to_ray.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    x, y = xs.reshape(-1, 1), ys.reshape(-1, 1)
    m = constants.pixel_to_ray
    return x * m[:, 0] + y * m[:, 1] + m[:, 2]


def pixel_preamble(scene, static: SceneStatic, settings: RenderSettings,
                   constants: FrameConstants, hit, ray_dirs, attrs,
                   position):
    """Shading data, light display radiance and LTC coefficients for every
    pixel (pipeline.py _pixel_preamble). Returns (data, ltc, base0)."""
    data = finish_shading_data(scene, constants, attrs, position)
    base = torch.zeros_like(ray_dirs)
    if settings.show_polygonal_lights:
        # Display the light sources themselves (glsl:841-850).
        ones = torch.ones_like(ray_dirs[:, :1])
        ray_end = torch.where(hit[:, None],
                              torch.cat([data.position, ones], dim=1),
                              torch.cat([ray_dirs, 0.0 * ones], dim=1))
        lights = scene.lights
        for i in range(static.light_count):
            light_hit = polygonal_light_ray_intersection(
                lights.plane[i], lights.vertices_world_space[i],
                static.light_vertex_counts[i], constants.camera_position,
                ray_end)
            radiance = get_polygon_radiance(scene, i,
                                            static.light_texturing[i])
            base = base + torch.where(light_hit[:, None], radiance, 0.0)
    f0 = data.fresnel_0
    fresnel_luminance = f0[:, 0] * 0.2126 + f0[:, 1] * 0.7152 \
        + f0[:, 2] * 0.0722
    ltc = get_ltc_coefficients(scene.ltc, fresnel_luminance, data.roughness,
                               data.position, data.normal, data.outgoing)
    return data, ltc, base


def render_frame_constants(scene, static: SceneStatic,
                           settings: RenderSettings,
                           constants: FrameConstants, width: int,
                           height: int,
                           kernels: FrameKernels = KERNELS) -> torch.Tensor:
    """One frame: (height, width, 3) float32 in output color space."""
    check_supported(static, settings)
    if settings.frame_bits != 0:
        raise NotImplementedError(
            "HDR frame_bits capture is not ported (ROADMAP Queue 1, "
            "item 13)")
    cam = constants.camera_position
    ray_dirs = camera_rays(constants, width, height)
    p = ray_dirs.shape[0]
    origins = cam.expand(p, 3).contiguous()
    prim, t_hit = kernels.trace_closest(
        scene.clusters, origins, ray_dirs,
        torch.full((p,), float("inf"), device=ray_dirs.device))
    dcam = constants.pixel_to_ray[:, :2].T.contiguous()
    attrs = kernels.closest_attrs(scene.clusters, prim, origins, ray_dirs, dcam)
    hit = prim != -1
    t_safe = torch.where(hit & torch.isfinite(t_hit), t_hit, 0.0)
    position = cam + t_safe[:, None] * ray_dirs

    ppl = pairs_per_light(settings)
    noise_planes = get_noise_image(
        scene.noise_table, width, height, max(ppl * static.light_count, 1),
        scene.noise_texture_index_mask, constants.noise_random_numbers)

    data, ltc, base0 = pixel_preamble(scene, static, settings, constants,
                                      hit, ray_dirs, attrs, position)
    light_scalars = pack_light_scalars(scene.lights, static.light_count)
    if not settings.trace_shadow_rays:
        # No shadow rays: every slot's visibility is 1, so K5 accumulates
        # the color in registers and no slot plane is stored (:503-514).
        # The noise planes viewed light-major: (L, 2 ppl, P), no copy.
        noise_lm = noise_planes[:2 * ppl * static.light_count].view(
            static.light_count, 2 * ppl, p)
        colors = base0 + kernels.fused_resolved(
            pack_planes(data, ltc, hit, noise_planes[:0]), noise_lm,
            light_scalars, static, settings)
        return _resolve(colors, constants, settings, width, height)

    out = kernels.fused_shading(
        pack_planes(data, ltc, hit, noise_planes), light_scalars, static,
        settings)
    slots = static.light_count * rays_per_light(settings)
    rest = out[3:].reshape(slots, 7, p)     # slot-major: (S, 7, P)
    b = rest[:, 0:3]                        # (S, 3, P)
    # Sample-major megabatch: every pixel's ray of slot 0, then slot 1...
    shade_origins = torch.where(hit[:, None], data.position, cam)
    flat_origins = shade_origins.repeat(slots, 1)
    flat_dirs = rest[:, 3:6].permute(0, 2, 1).reshape(-1, 3).contiguous()
    live = torch.any(b != 0.0, dim=1).reshape(-1)
    flat_tmax = torch.where(live, rest[:, 6].reshape(-1), -1.0)
    occluded = kernels.trace_anyhit(scene.clusters, flat_origins, flat_dirs,
                                    flat_tmax.contiguous())
    visibility = torch.where(occluded, 0.0, 1.0).reshape(slots, 1, p)
    colors = base0 + out[0:3].T + torch.sum(b * visibility, dim=0).T
    return _resolve(colors, constants, settings, width, height)


def _resolve(colors, constants: FrameConstants, settings: RenderSettings,
             width: int, height: int) -> torch.Tensor:
    """(P, 3) linear color -> (height, width, 3) output image."""
    # NaN/Inf -> pink (glsl:861-864), then exposure.
    bad = torch.any(torch.isnan(colors) | torch.isinf(colors), dim=-1,
                    keepdim=True)
    pink = torch.tensor([1.0, 0.0, 0.8], device=colors.device) \
        / constants.exposure_factor
    colors = torch.where(bad, pink, colors) * constants.exposure_factor
    if not settings.output_linear_rgb:
        colors = linear_to_srgb(colors)
    return colors.reshape(height, width, 3)


def render_frame(scene, static: SceneStatic, camera: FirstPersonCamera,
                 settings: RenderSettings, width: int, height: int,
                 noise_random_numbers=None,
                 kernels: FrameKernels = KERNELS) -> torch.Tensor:
    """Render one frame on the scene's device; returns (H, W, 3)."""
    if noise_random_numbers is None:
        noise_random_numbers = (np.arange(4) * 0x123456).astype(np.uint32)
    constants = make_frame_constants(camera, width, height, settings,
                                     noise_random_numbers, scene.device)
    with torch.no_grad():
        return render_frame_constants(scene, static, settings, constants,
                                      width, height, kernels)
