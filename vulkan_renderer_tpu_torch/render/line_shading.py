"""Shading for linear lights, with deferred shadows like the polygonal
lights' per-pixel path.

Counterpart of vulkan_renderer_tpu/render/line_shading.py, batched over
pixels: a diffuse-target technique for the cosine-weighted line integral
and an LTC-target one for the specular part (the combined strategies),
both unbiased; visibility stays affine, so the rays join the frame's
shadow megabatch.
"""

from __future__ import annotations

import torch

from ..core.settings import RenderSettings, SamplingStrategy
from ..ops.brdf import evaluate_brdf
from ..ops.line_sampling import (line_geometry, prepare_line_sampling,
                                 sample_line_distance, sample_line_ris,
                                 sample_line_uniform)
from ..ops.ltc import evaluate_ltc_density
from ..ops.math_utils import dot

RIS_CANDIDATES = 4


def linear_rays_per_sample(settings: RenderSettings) -> int:
    return 1 if settings.sampling_strategy == SamplingStrategy.DIFFUSE_ONLY \
        else 2


def linear_pairs_per_sample(settings: RenderSettings) -> int:
    """Noise pairs one sample of one linear light takes."""
    per_ray = RIS_CANDIDATES + 1 \
        if settings.linear_technique == "projected_ris" else 1
    return per_ray * linear_rays_per_sample(settings)


def linear_pairs_per_light(settings: RenderSettings) -> int:
    return settings.sample_count * linear_pairs_per_sample(settings)


def linear_rays_per_light(settings: RenderSettings) -> int:
    return settings.sample_count * linear_rays_per_sample(settings)


def evaluate_linear_light_shading(scene, settings: RenderSettings,
                                  light_index: int, data, ltc, noise_pairs):
    """One linear light at every pixel. noise_pairs: (P,
    linear_pairs_per_light, 2). Returns (base (P, 3), b (P, S, 3),
    ray_dirs (P, S, 3), t_max (P, S)) like the polygonal lights' path,
    S = linear_rays_per_light(settings)."""
    lights = scene.linear_lights
    radiance = lights.linear_radiance[light_index]
    prep = prepare_line_sampling(lights.start[light_index],
                                 lights.end[light_index], data.position)
    n = settings.sample_count
    per_ray_pairs = RIS_CANDIDATES + 1 \
        if settings.linear_technique == "projected_ris" else 1
    combined = settings.sampling_strategy != SamplingStrategy.DIFFUSE_ONLY
    w2s = ltc.world_to_shading_space

    def diffuse_target(t, omega, dist, sin_alpha):
        return torch.clamp(dot(data.normal, omega), min=0.0) \
            * sin_alpha / (dist * dist)

    def specular_target(t, omega, dist, sin_alpha):
        omega_shading = torch.stack(
            [w2s[:, i, 0] * omega[:, 0] + w2s[:, i, 1] * omega[:, 1]
             + w2s[:, i, 2] * omega[:, 2] for i in range(3)], dim=-1)
        density = evaluate_ltc_density(ltc, omega_shading, 1.0)
        return torch.clamp(density, min=0.0) * sin_alpha / (dist * dist)

    def one_estimate(pairs, target_fn, diffuse: bool, specular: bool):
        """pairs: (P, per_ray_pairs, 2) -> (b (P, 3), dir, t_max)."""
        if settings.linear_technique == "uniform":
            t, dens = sample_line_uniform(prep, pairs[:, 0, 0])
            omega, dist, sin_alpha = line_geometry(prep, t, data.position)
            contrib_factor = 1.0 / torch.clamp(dens, min=1e-20)
        elif settings.linear_technique == "distance":
            t, dens = sample_line_distance(prep, pairs[:, 0, 0])
            omega, dist, sin_alpha = line_geometry(prep, t, data.position)
            contrib_factor = 1.0 / torch.clamp(dens, min=1e-20)
        else:  # projected_ris: contrib_factor = ris_weight / target
            t, omega, dist, sin_alpha, contrib_factor = sample_line_ris(
                prep, data.position, target_fn, pairs, RIS_CANDIDATES)
        cos_x = dot(data.normal, omega)
        brdf = evaluate_brdf(data, omega, diffuse, specular)
        # f = brdf cos L_eff sin_alpha / d^2; the estimate is f / p (RIS:
        # f ris_weight / target).
        f = brdf * radiance * torch.clamp(cos_x, min=0.0)[:, None] \
            * sin_alpha[:, None] / (dist * dist)[:, None]
        b = f * contrib_factor[:, None]
        gate = (cos_x > 0.0) & (prep.length > 0.0)
        return (torch.where(gate[:, None], b, 0.0), omega,
                torch.where(gate, dist * 0.999, 0.0))

    b_all, d_all, t_all = [], [], []
    cursor = 0
    for _ in range(n):
        pairs_d = noise_pairs[:, cursor:cursor + per_ray_pairs]
        cursor += per_ray_pairs
        b, d, t = one_estimate(pairs_d, diffuse_target, True, not combined)
        b_all.append(b)
        d_all.append(d)
        t_all.append(t)
        if combined:
            pairs_s = noise_pairs[:, cursor:cursor + per_ray_pairs]
            cursor += per_ray_pairs
            b, d, t = one_estimate(pairs_s, specular_target, False, True)
            b_all.append(b)
            d_all.append(d)
            t_all.append(t)
    scale = 1.0 / n
    return (torch.zeros_like(data.position),
            torch.stack(b_all, dim=1) * scale, torch.stack(d_all, dim=1),
            torch.stack(t_all, dim=1))
