"""The frame: render(scene, camera, settings) -> image.

Counterpart of vulkan_renderer_tpu/render/pipeline.py::_render_frame_body
with the Pallas tracers, stage by stage:

1. camera rays, pixels row-major (:372-373);
2. primary closest hit (K2) and attribute fetch (K3);
3. the frame's noise fetches (ops/noise.py frame_noise: three scalars per
   fetch);
4. the per-pixel preamble: texture fetch and material decode, light
   display, LTC coefficients (:78-120);
5. light shading, by SceneStatic.fused (_use_fused :160):
   - fused: with shadow rays, K4 exports every ray slot; without them,
     K5 accumulates each pixel's color with visibility 1 (:485-522; the
     kernels read the noise table themselves);
   - per-pixel (render/shading.py, render/line_shading.py; _shade_pixel
     :123): every other configuration, in plain PyTorch over chunks of
     PIXEL_CHUNK pixels, each chunk reading its own noise pairs;
6. the sample-major shadow megabatch; a ray whose weight is zero gets
   t_max = -1 and is dead (:537-552);
7. shadow any-hit (K1);
8. the resolve: base + sum_slot b * V, NaN/Inf -> pink, exposure, then
   sRGB, or one byte of the float16 bits for the two-frame HDR capture
   (frame_bits, :587-594 and _postprocess :181-199).

A frame may be one band of image rows (row_offset; parallel/tiles.py).
stop_after ends a frame after one of STAGES, for timing its stages
(render_frame_constants says what each cut includes). Each stage a frame
passes is a span of core/trace.py under its STAGES name, and the resolve
one named "resolve".

Everything between the kernels is plain PyTorch on the scene's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core import trace
from ..core.device import device_constant, to_device_async
from ..core.settings import RenderSettings
from ..ops.intersect import polygonal_light_ray_intersection
from ..ops.ltc import get_ltc_coefficients
from ..ops.math_utils import normalize
from ..ops.noise import frame_noise, noise_pairs
from ..ops.srgb import linear_to_srgb
from ..scene.camera import (FirstPersonCamera,
                            get_pixel_to_ray_direction_world_space)
from .fused import (check_settings_class, fused_light_shading,
                    fused_light_shading_plain, fused_light_shading_resolved,
                    fused_light_shading_resolved_plain, fused_supported,
                    pack_light_scalars, pack_planes)
from .line_shading import (evaluate_linear_light_shading,
                           linear_pairs_per_light, linear_rays_per_light)
from .shading import (FrameConstants, SceneStatic,
                      evaluate_polygonal_light_shading, finish_shading_data,
                      get_polygon_radiance, pairs_per_light, rays_per_light)
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

# Pixels the per-pixel path shades at once. It changes no result (frames
# are bit-equal at every size) and bounds the path's device memory. Each
# chunk launches the path's kernels again (~29,500 for the bench frame's
# four lights), so fewer chunks are faster: 2^21 holds a 1920x1080 frame
# in one chunk. There the linear-light reference, the per-pixel
# experiment with the most slots (327: 64 samples of 2 rays), peaks at
# 24.7 GiB against 16.2 at 2^20 and takes 1.7 s against 2.8 s a frame
# under the profiler (tools/profile_frame.py --experiment 327
# --pixel-chunks, one H100).
PIXEL_CHUNK = 1 << 21
# The NaN/Inf sentinel color (glsl:861-864), linear, before exposure.
PINK = (1.0, 0.0, 0.8)


def make_frame_constants(camera: FirstPersonCamera, width: int, height: int,
                         settings: RenderSettings, noise_random_numbers,
                         device) -> FrameConstants:
    """The frame's constants on `device`. The two small tensors go there in
    stream order (to_device_async): a pageable copy would make the host
    wait for the frames already queued."""
    device = torch.device(device)
    return FrameConstants(
        camera_position=to_device_async(torch.from_numpy(np.array(
            camera.position_world_space, np.float32)), device),
        pixel_to_ray=to_device_async(torch.from_numpy(np.array(
            get_pixel_to_ray_direction_world_space(camera, width, height),
            np.float32)), device),
        exposure_factor=float(settings.exposure_factor),
        roughness_factor=float(settings.roughness_factor),
        noise_random_numbers=tuple(
            int(v) for v in np.asarray(noise_random_numbers, np.uint32)),
    )


def camera_rays(constants: FrameConstants, width: int, height: int,
                row_offset: int = 0):
    """Row-major (P, 3) ray directions: pixel_to_ray @ (x, y, 1), for the
    rows row_offset..row_offset+height-1 of the frame (pipeline.py
    :335-342)."""
    device = constants.pixel_to_ray.device
    ys, xs = torch.meshgrid(
        torch.arange(row_offset, row_offset + height, dtype=torch.float32,
                     device=device),
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
        with trace.span("preamble.display"):
            # Textured lights look their radiance up along the view ray.
            view_dir = normalize(ray_dirs) if any(static.light_texturing) \
                else None
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
                radiance = get_polygon_radiance(
                    scene, i, static.light_texturing[i], view_dir,
                    constants.camera_position)
                base = base + torch.where(light_hit[:, None], radiance, 0.0)
    f0 = data.fresnel_0
    fresnel_luminance = f0[:, 0] * 0.2126 + f0[:, 1] * 0.7152 \
        + f0[:, 2] * 0.0722
    with trace.span("preamble.ltc"):
        ltc = get_ltc_coefficients(scene.ltc, fresnel_luminance,
                                   data.roughness, data.position,
                                   data.normal, data.outgoing)
    return data, ltc, base


def use_fused(static: SceneStatic, settings: RenderSettings) -> bool:
    """The shading path (pipeline.py _use_fused :160): K4/K5 wherever
    fused_supported holds under static.fused "auto", on any device (on
    the CPU the kernels' plain versions run); the per-pixel path under
    "off" and where it does not hold. "on" raises there instead."""
    if static.fused == "off":
        return False
    supported = fused_supported(static, settings)
    if static.fused == "on" and not supported:
        raise ValueError(
            "static.fused='on' but kernels K4/K5 do not cover this "
            "configuration (render/fused.py fused_supported)")
    return supported


# The stages after which stop_after cuts a frame (pipeline.py
# render_frame_jit), in the order a frame passes them.
STAGES = ("rays", "trace", "noise", "preamble", "shade", "shadowrays",
          "shadow")


def render_frame_constants(scene, static: SceneStatic,
                           settings: RenderSettings,
                           constants: FrameConstants, width: int,
                           height: int,
                           kernels: FrameKernels = KERNELS,
                           row_offset: int = 0,
                           stop_after: str | None = None) -> torch.Tensor:
    """One frame: (height, width, 3) float32 in output color space.

    With row_offset, the image is the band of rows row_offset..row_offset
    +height-1 of a frame whose constants were made for its full height:
    rays and noise read global pixel rows, so the bands of a frame
    concatenate to the whole frame bit for bit (parallel/tiles.py).

    stop_after, for timing a frame's stages (the JAX package's stage
    names), ends the frame after that stage and returns _stage_stub of
    the exit's outputs: the tensors that hold what the JAX exit sums, as
    the port holds them. Each cut includes, from the start of the frame,
    and its stub sums:
    - "rays": the camera rays; ray_dirs;
    - "trace": K2 and K3 (the port fetches the attributes with the hit,
      as the JAX Pallas path does); prim;
    - "noise": the frame's noise fetches (K3 ran before them, where the
      JAX package runs its attribute fetch after); prim and the fetches
      (FrameNoise.fetches, from which noise_pairs gives the JAX pairs);
    - "preamble": the per-pixel preamble, on the fused path only; base0
      and every field of the ShadingData and LtcCoefficients;
    - "shade": K4 with shadows, K5 without, or the per-pixel shading;
      base0 and K4's planes (the JAX base is base0 plus their first
      three, its b, dirs and t_max the slots'), without shadows the
      colors (the JAX base);
    - "shadowrays": the shadow megabatch, with shadows only; base0, the
      planes and the megabatch's origins, directions and t_max;
    - "shadow": K1; base0, the planes and occluded (without shadows: the
      colors, as after "shade").
    A stage the frame does not pass, "preamble" on the per-pixel path and
    "shadowrays" without shadows, does not cut it: the frame runs on to
    the end, as in the JAX package. stop_after=None renders the whole
    frame."""
    check_settings_class(settings)
    if stop_after is not None and stop_after not in STAGES:
        raise ValueError(f"stop_after {stop_after!r} is none of {STAGES}")
    fused = use_fused(static, settings)

    cam = constants.camera_position
    with trace.span("rays"):
        ray_dirs = camera_rays(constants, width, height, row_offset)
    if stop_after == "rays":
        return _stage_stub(width, height, ray_dirs)
    p = ray_dirs.shape[0]
    with trace.span("trace"):
        origins = cam.expand(p, 3).contiguous()
        prim, t_hit = kernels.trace_closest(
            scene.clusters, origins, ray_dirs,
            torch.full((p,), float("inf"), device=ray_dirs.device))
        dcam = constants.pixel_to_ray[:, :2].T.contiguous()
        attrs = kernels.closest_attrs(scene.clusters, prim, origins,
                                      ray_dirs, dcam)
    if stop_after == "trace":
        return _stage_stub(width, height, prim)

    with trace.span("noise"):
        if fused:
            noise = frame_noise(
                scene.noise_table, width, row_offset + height,
                max(pairs_per_light(settings) * static.light_count, 1),
                scene.noise_texture_index_mask,
                constants.noise_random_numbers)
            if row_offset:
                # The band's frame pixels (FrameNoise.pixels): K4 and K5
                # read the noise at these, as their plain versions do.
                noise = noise.subset(torch.arange(
                    row_offset * width, (row_offset + height) * width,
                    device=ray_dirs.device))
        else:
            noise = frame_noise(
                scene.noise_table, width, row_offset + height,
                max(pairs_per_light(settings) * static.light_count
                    + linear_pairs_per_light(settings)
                    * static.linear_light_count, 1),
                scene.noise_texture_index_mask,
                constants.noise_random_numbers)
    if stop_after == "noise":
        return _stage_stub(width, height, prim, noise.fetches)

    with trace.span("preamble"):
        hit = prim != -1
        t_safe = torch.where(hit & torch.isfinite(t_hit), t_hit, 0.0)
        position = cam + t_safe[:, None] * ray_dirs
        data, ltc, base0 = pixel_preamble(scene, static, settings, constants,
                                          hit, ray_dirs, attrs, position)
    if fused and stop_after == "preamble":
        return _stage_stub(width, height, base0, *_fields(data),
                           *_fields(ltc))

    with trace.span("shade"):
        if fused:
            with trace.span("shade.pack"):
                light_scalars = pack_light_scalars(scene.lights,
                                                   static.light_count)
                planes = pack_planes(data, ltc, hit)
            shadows = settings.trace_shadow_rays
            slots = static.light_count * rays_per_light(settings)
            if shadows:
                out = kernels.fused_shading(planes, noise, light_scalars,
                                            static, settings)
            else:
                # No shadow rays: every slot's visibility is 1, so K5
                # accumulates the color in registers and no slot plane is
                # stored (:503-514).
                colors = base0 + kernels.fused_resolved(
                    planes, noise, light_scalars, static, settings)
        else:
            slots = rays_per_light(settings) * static.light_count \
                + linear_rays_per_light(settings) \
                * static.linear_light_count
            shadows = settings.trace_shadow_rays and slots > 0
            out = _shade_per_pixel(scene, static, settings, constants, hit,
                                   data, ltc, noise, slots, shadows,
                                   row_offset * width)
            if not shadows:
                colors = base0 + out

    if not shadows:
        if stop_after in ("shade", "shadow"):
            return _stage_stub(width, height, colors)
        with trace.span("resolve"):
            return _resolve(colors, constants, settings, width, height)
    if stop_after == "shade":
        return _stage_stub(width, height, base0, out)
    with trace.span("shadowrays"):
        rays = _shadow_megabatch(out, slots, hit, data.position, cam)
    if stop_after == "shadowrays":
        return _stage_stub(width, height, base0, out, *rays)
    with trace.span("shadow"):
        occluded = kernels.trace_anyhit(scene.clusters, *rays)
    if stop_after == "shadow":
        return _stage_stub(width, height, base0, out, occluded)
    with trace.span("resolve"):
        colors = _shadow_combine(out, slots, occluded, base0)
        return _resolve(colors, constants, settings, width, height)


def _fields(record):
    """The tensors of a ShadingData or LtcCoefficients."""
    return [getattr(record, f.name) for f in dataclasses.fields(record)]


def _stage_stub(width: int, height: int, *outputs) -> torch.Tensor:
    """The image of a frame cut by stop_after (pipeline.py _stage_stub):
    0 + acc 1e-30 in every pixel and channel, acc the float32 sum of the
    exit's outputs, so that the image depends on all of them. They are
    summed in one reduction, so that the stub adds little to the stage's
    time. A non-finite value (a miss pixel's NaN frame) adds 0, so that
    the image is finite."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in outputs])
    acc = flat.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0).sum()
    return torch.zeros((height, width, 3), dtype=torch.float32,
                       device=acc.device) + acc * 1e-30


def _shadow_megabatch(out, slots: int, hit, position, cam):
    """The sample-major shadow megabatch of out (3 + 7 slots, P) (base RGB,
    then per ray slot b RGB, direction, t_max): (origins, directions,
    t_max), every pixel's ray of slot 0, then of slot 1, ...; a ray whose
    b is zero gets t_max = -1 and is dead (:537-552)."""
    p = out.shape[1]
    rest = out[3:].reshape(slots, 7, p)     # slot-major: (S, 7, P)
    shade_origins = torch.where(hit[:, None], position, cam)
    flat_origins = shade_origins.repeat(slots, 1)
    flat_dirs = rest[:, 3:6].permute(0, 2, 1).reshape(-1, 3).contiguous()
    live = torch.any(rest[:, 0:3] != 0.0, dim=1).reshape(-1)
    flat_tmax = torch.where(live, rest[:, 6].reshape(-1), -1.0)
    return flat_origins, flat_dirs, flat_tmax.contiguous()


def _shadow_combine(out, slots: int, occluded, base0):
    """base0 + base + sum_slot b V as (P, 3), V = 1 where K1 found the
    slot's ray unoccluded."""
    p = out.shape[1]
    b = out[3:].reshape(slots, 7, p)[:, 0:3]    # (S, 3, P)
    visibility = torch.where(occluded, 0.0, 1.0).reshape(slots, 1, p)
    return base0 + out[0:3].T + torch.sum(b * visibility, dim=0).T


def _rows(fields, start: int, stop: int):
    """A ShadingData / LtcCoefficients with pixels start..stop-1."""
    return dataclasses.replace(fields, **{
        f.name: getattr(fields, f.name)[start:stop]
        for f in dataclasses.fields(fields)})


def shade_pixels(scene, static: SceneStatic, settings: RenderSettings,
                 constants: FrameConstants, hit, data, ltc, pairs):
    """Per-pixel shading except shadow visibility (pipeline.py
    _shade_pixel :123), batched: pairs (P, total pairs, 2), polygonal
    lights' pairs first, then the linear lights'. Returns (base (P, 3),
    b (P, S, 3), ray_dirs (P, S, 3), t_max (P, S)) with base and b zero
    where hit is false; the color is base0 + base + sum_slot b V."""
    base = torch.zeros_like(data.position)
    b_all, dir_all, tmax_all = [], [], []

    def add(light_base, b, dirs, t_max):
        nonlocal base
        base = base + torch.where(hit[:, None], light_base, 0.0)
        b_all.append(torch.where(hit[:, None, None], b, 0.0))
        dir_all.append(dirs)
        tmax_all.append(t_max)

    ppl = pairs_per_light(settings)
    for i in range(static.light_count):
        r = evaluate_polygonal_light_shading(
            scene, static, settings, constants, i, data, ltc,
            pairs[:, i * ppl:(i + 1) * ppl])
        add(r.base, r.b, r.ray_dirs, r.t_max)
    lppl = linear_pairs_per_light(settings)
    offset = static.light_count * ppl
    for i in range(static.linear_light_count):
        add(*evaluate_linear_light_shading(
            scene, settings, i, data, ltc,
            pairs[:, offset + i * lppl:offset + (i + 1) * lppl]))
    if not b_all:
        p = base.shape[0]
        return base, base.new_zeros((p, 0, 3)), base.new_zeros((p, 0, 3)), \
            base.new_zeros((p, 0))
    return (base, torch.cat(b_all, dim=1), torch.cat(dir_all, dim=1),
            torch.cat(tmax_all, dim=1))


def _shade_per_pixel(scene, static: SceneStatic, settings: RenderSettings,
                     constants: FrameConstants, hit, data, ltc, noise,
                     slots: int, shadows: bool, first: int):
    """Stage 5 on the per-pixel path, PIXEL_CHUNK pixels at a time: with
    shadows, the frame's slots packed as K4 exports them, (3 + 7 slots,
    P); without, the shaded color less base0, (P, 3). `first` is the frame
    pixel of the first row (a band's noise pairs are those of its global
    frame pixels)."""
    p = hit.shape[0]
    chunks = []
    for start in range(0, p, PIXEL_CHUNK):
        stop = min(p, start + PIXEL_CHUNK)
        base, b, dirs, t_max = shade_pixels(
            scene, static, settings, constants, hit[start:stop],
            _rows(data, start, stop), _rows(ltc, start, stop),
            noise_pairs(noise, first + start, first + stop))
        if shadows:
            # The (3 + 7 S, P) layout of K4's output.
            slot_planes = torch.cat([b, dirs, t_max[..., None]], dim=2)
            chunks.append(torch.cat([base.T, slot_planes.permute(1, 2, 0)
                                     .reshape(7 * slots, -1)], dim=0))
        else:
            chunks.append(base + torch.sum(b, dim=1))
    return torch.cat(chunks, dim=1 if shadows else 0)


def _resolve(colors, constants: FrameConstants, settings: RenderSettings,
             width: int, height: int) -> torch.Tensor:
    """(P, 3) linear color -> (height, width, 3) output image
    (pipeline.py:587-594 and _postprocess :181-199)."""
    # NaN/Inf -> pink (glsl:861-864), then exposure.
    bad = torch.any(torch.isnan(colors) | torch.isinf(colors), dim=-1,
                    keepdim=True)
    pink = device_constant(PINK, colors.device) / constants.exposure_factor
    colors = torch.where(bad, pink, colors) * constants.exposure_factor
    if settings.frame_bits > 0:
        colors = half_float_byte(colors, settings.frame_bits)
    elif not settings.output_linear_rgb:
        colors = linear_to_srgb(colors)
    return colors.reshape(height, width, 3)


def half_float_byte(colors: torch.Tensor, frame_bits: int) -> torch.Tensor:
    """The low (frame_bits 1) or high (2) byte of each value's float16
    bits, over 255: one half of the two-frame HDR capture, with no sRGB
    step (main.c:1700-1763; render/screenshot.py
    combine_ldr_screenshots_into_hdr puts the halves back together).
    Values past float16's range give the bits of inf, as a cast does."""
    # view(int16) is signed: widen and mask before taking the high byte.
    bits = colors.to(torch.float16).view(torch.int16).to(torch.int32) \
        & 0xFFFF
    byte = bits & 0xFF if frame_bits == 1 else bits >> 8
    return byte.to(torch.float32) / 255.0


def render_frame(scene, static: SceneStatic, camera: FirstPersonCamera,
                 settings: RenderSettings, width: int, height: int,
                 noise_random_numbers=None,
                 kernels: FrameKernels = KERNELS,
                 stop_after: str | None = None) -> torch.Tensor:
    """Render one frame on the scene's device; returns (H, W, 3).
    stop_after cuts it after a stage (render_frame_constants)."""
    if noise_random_numbers is None:
        noise_random_numbers = (np.arange(4) * 0x123456).astype(np.uint32)
    constants = make_frame_constants(camera, width, height, settings,
                                     noise_random_numbers, scene.device)
    with torch.no_grad():
        return render_frame_constants(scene, static, settings, constants,
                                      width, height, kernels,
                                      stop_after=stop_after)
