"""The plain reference of a frame, at chosen pixels.

It renders what the port's frame loop renders, pixel by pixel, from the
same scene files, camera, lights, settings and per-frame noise numbers,
with code that shares nothing with the port: camera rays, a brute-force
closest hit over every triangle (trace.py), and the JAX package's plain
per-pixel path transcribed to PyTorch (shade.py, scene.py): shading data,
light display, LTC fetch, projected solid angle sampling with MIS,
brute-force shadow rays, and the resolve to output color. It imports
nothing of the program.

precision="bfloat16" is the control: the same computation with every
per-pixel record it hands from one stage to the next (shading data, LTC
coefficients, the light display, each light's base and ray weights)
rounded to bfloat16, the nearest precision below the float32 that the
configuration states (no operation of the frame runs on tensor cores,
so TF32 would change nothing). It must come out as not correct.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import shade, trace
from .scene import frame_random_numbers, pixel_to_ray

# A pixel whose largest channel differs by more than this (output color,
# sRGB in [0, 1]) counts as far off: the repo's frame agreement threshold.
FAR = 1e-2
PRECISIONS = ("float32", "bfloat16")
# The NaN/Inf sentinel color (glsl:861-864), linear, before exposure.
PINK = (1.0, 0.0, 0.8)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The render settings the reference reads, enums by member name
    (core/settings.py's defaults)."""
    sampling_strategy: str = "DIFFUSE_SPECULAR_MIS"
    polygon_sampling_technique: str = "PROJECTED_SOLID_ANGLE"
    mis_heuristic: str = "OPTIMAL_CLAMPED"
    mis_visibility_estimate: float = 0.5
    sample_count: int = 1
    exposure_factor: float = 1.0
    roughness_factor: float = 1.0
    noise_type: str = "ahmed_2d"
    animate_noise: bool = True
    trace_shadow_rays: bool = False
    show_polygonal_lights: bool = True
    output_linear_rgb: bool = False
    frame_bits: int = 0
    error_display: str = "NONE"

    def __post_init__(self):
        for name, allowed in (
                ("polygon_sampling_technique", ("PROJECTED_SOLID_ANGLE",)),
                ("sampling_strategy", shade.STRATEGIES),
                ("error_display", ("NONE",)), ("frame_bits", (0,))):
            if getattr(self, name) not in allowed:
                raise NotImplementedError(
                    f"the reference renders {name} in {allowed}, not "
                    f"{getattr(self, name)!r}")
        if self.sampling_strategy == "DIFFUSE_SPECULAR_MIS" and \
                self.mis_heuristic != "OPTIMAL_CLAMPED":
            raise NotImplementedError("the reference's MIS is clamped optimal")


def settings_from_fields(fields: dict) -> Settings:
    known = {f.name for f in dataclasses.fields(Settings)}
    return Settings(**{k: v for k, v in fields.items() if k in known})


def random_numbers(settings: Settings, noise_seed: int) -> np.ndarray:
    return frame_random_numbers(noise_seed, settings.animate_noise)


def _noise_pairs(scene, pair_count, randoms, xs, ys):
    """(P, pair_count, 2) noise pairs of pixels (xs, ys)
    (ops/noise.py get_noise_pairs)."""
    rn = [int(v) for v in np.asarray(randoms, np.uint32)]
    mask_x, mask_y = scene.noise_resolution_mask
    fetches = []
    for i in range((pair_count + 1) // 2):
        r = [rn[2], rn[3], rn[0], rn[1]] if i & 2 else rn
        rx, ry, rz = (r[1], r[2], r[3]) if i & 1 else (r[0], r[1], r[2])
        shift = (i & 124) >> 2
        off_x, off_y = rx >> shift, ry >> shift
        layer = ((rz + i) & 0xFFFFFFFF) & scene.noise_texture_index_mask
        loc_x = (xs + off_x) & mask_x
        loc_y = (ys + off_y) & mask_y
        fetches.append(scene.noise[layer, loc_y, loc_x].to(torch.float32)
                       * (1.0 / 65535.0))
    pairs = torch.stack(fetches, 1).reshape(xs.shape[0], -1, 2)
    return pairs[:, :pair_count]


def _rounded(x, precision):
    if precision == "float32":
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def _rounded_fields(record, precision):
    return type(record)(*(_rounded(v, precision) for v in record))


def _preamble(scene, settings, cam, dcam, positions, normals, uvs, material,
              ray_dir, hit):
    data = shade.shading_data(scene.atlas, cam, dcam,
                              settings.roughness_factor, positions, normals,
                              uvs, material, ray_dir)
    base = torch.zeros_like(cam)
    if settings.show_polygonal_lights:
        ones = torch.ones_like(cam[:1])
        ray_end = torch.where(hit, torch.cat([data.position, ones]),
                              torch.cat([ray_dir, 0.0 * ones]))
        for i in range(scene.light_count):
            base = base + torch.where(shade.light_hit(
                scene.light_plane[i], scene.light_vertices[i],
                scene.light_vertex_counts[i], cam, ray_end),
                scene.light_radiance[i], 0.0)
    luminance = torch.sum(data.fresnel_0 * torch.tensor(
        [0.2126, 0.7152, 0.0722], device=cam.device))
    ltc = shade.ltc_fetch(scene.ltc_table, scene.ltc_constants, luminance,
                          data.roughness, data.position, data.normal,
                          data.outgoing)
    return data, ltc, base


def render_pixels(scene, settings: Settings, camera: dict, width: int,
                  height: int, randoms, pixels: torch.Tensor,
                  precision: str = "float32") -> torch.Tensor:
    """(P, 3) output colors of frame pixels `pixels` ((P,) int64 row-major
    ids) of the frame whose noise numbers are `randoms`."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is none of {PRECISIONS}")
    device = scene.v0.device
    pixels = pixels.to(device)
    m = torch.as_tensor(pixel_to_ray(camera, width, height), device=device)
    cam = torch.as_tensor(np.asarray(camera["position_world_space"],
                                     np.float32), device=device)
    xs, ys = pixels % width, pixels // width
    ray_dirs = xs.to(torch.float32)[:, None] * m[:, 0] \
        + ys.to(torch.float32)[:, None] * m[:, 1] + m[:, 2]
    p = ray_dirs.shape[0]
    origins = cam.expand(p, 3).contiguous()
    prim, _ = trace.closest_hit(scene.v0, scene.e1, scene.e2, origins,
                                ray_dirs)
    hit = prim != -1
    safe = torch.where(hit, prim, 0)
    dcam = m[:, :2].T.contiguous()
    data, ltc, base0 = torch.vmap(
        functools.partial(_preamble, scene, settings, cam, dcam))(
        scene.positions[safe], scene.normals[safe], scene.uvs[safe],
        scene.material[safe], ray_dirs, hit)
    data = _rounded_fields(data, precision)
    ltc = _rounded_fields(ltc, precision)
    base0 = _rounded(base0, precision)
    ppl = shade.pairs_per_light(settings)
    pairs = _noise_pairs(scene, max(ppl * scene.light_count, 1), randoms,
                         xs, ys)
    base = base0
    b_all, dir_all, tmax_all = [], [], []
    for i in range(scene.light_count):
        light = functools.partial(
            shade.light_shading, settings,
            plane=scene.light_plane[i], vertices=scene.light_vertices[i],
            vertex_count=scene.light_vertex_counts[i],
            radiance=scene.light_radiance[i],
            mis_estimate=settings.mis_visibility_estimate)
        a, b, dirs, t_max = torch.vmap(
            lambda d, l, q: light(data=d, ltc=l, pairs=q))(
            data, ltc, pairs[:, i * ppl:(i + 1) * ppl])
        base = base + torch.where(hit[:, None], _rounded(a, precision), 0.0)
        b_all.append(torch.where(hit[:, None, None], _rounded(b, precision),
                                 0.0))
        dir_all.append(dirs)
        tmax_all.append(t_max)
    b = torch.cat(b_all, 1)
    slots = b.shape[1]
    if settings.trace_shadow_rays and slots > 0:
        # The shadow megabatch: origin at the hit (the camera on a miss), a
        # ray whose weight is zero is dead (t_max -1).
        shade_origins = torch.where(hit[:, None], data.position, cam)
        live = torch.any(b != 0.0, dim=2)
        tmax = torch.where(live, torch.cat(tmax_all, 1), -1.0)
        occ = trace.occluded(
            scene.v0, scene.e1, scene.e2,
            shade_origins[:, None, :].expand(-1, slots, 3).reshape(-1, 3),
            torch.cat(dir_all, 1).reshape(-1, 3).contiguous(),
            tmax.reshape(-1))
        visibility = torch.where(occ, 0.0, 1.0).reshape(p, slots, 1)
    else:
        visibility = torch.ones_like(b[..., :1])
    colors = base + torch.sum(b * visibility, dim=1)
    # NaN/Inf -> pink (glsl:861-864), then exposure and sRGB.
    bad = torch.any(torch.isnan(colors) | torch.isinf(colors), dim=-1,
                    keepdim=True)
    pink = torch.tensor(PINK, device=device) / settings.exposure_factor
    colors = torch.where(bad, pink, colors) * settings.exposure_factor
    if not settings.output_linear_rgb:
        colors = torch.clamp(colors, 0.0, 1.0)
        colors = torch.where(
            colors <= 0.0031308, 12.92 * colors,
            1.055 * torch.pow(torch.clamp(colors, min=1e-12), 1.0 / 2.4)
            - 0.055)
    return colors


def compare(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """The numbers `correct` is decided on, for one frame's sampled pixels
    ((P, 3) output colors each): the mean absolute difference over every
    channel, and the share of pixels whose largest channel difference is
    above FAR. A non-finite value counts as infinitely far."""
    diff = (program.to(torch.float64) - reference.to(torch.float64)).abs()
    diff = torch.nan_to_num(diff, nan=float("inf"))
    return {"mean_abs_diff": float(diff.mean()),
            "far_pixel_share": float((diff.amax(dim=1) > FAR)
                                     .to(torch.float64).mean())}
