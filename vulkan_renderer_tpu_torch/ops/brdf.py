"""BRDF for the per-pixel shading path: Disney diffuse + Frostbite
GGX/Smith/Schlick specular and GGX visible-normal sampling.

Counterpart of vulkan_renderer_tpu/ops/brdf.py (reference
brdfs.glsl:21-224), batched over a leading pixel axis: vectors are (P, 3),
scalars (P,). ShadingData is render/shading.py's.
"""

from __future__ import annotations

import torch

from .math_utils import M_PI, cross, dot, normalize

M_INV_PI = 1.0 / M_PI


def fresnel_schlick(fresnel_0, fresnel_90, cos_theta):
    flipped = 1.0 - cos_theta
    flipped_sq = flipped * flipped
    return fresnel_0 + (fresnel_90 - fresnel_0) \
        * (flipped_sq * flipped * flipped_sq)


def evaluate_brdf(data, incoming, diffuse: bool = True,
                  specular: bool = True):
    """Disney diffuse + Frostbite specular, times 1/pi (brdfs.glsl:57-88).
    data: ShadingData with (P, ...) fields; incoming: (P, 3). diffuse and
    specular are static choices, as the reference's compile-time bools."""
    half_vector = normalize(incoming + data.outgoing)
    lambert_in = dot(data.normal, incoming)
    out_dot_half = dot(data.outgoing, half_vector)
    brdf = torch.zeros_like(data.diffuse_albedo)
    if diffuse:
        fresnel_90 = out_dot_half * out_dot_half * (2.0 * data.roughness) \
            + 0.5
        f_out = fresnel_schlick(1.0, fresnel_90, data.lambert_outgoing)
        f_in = fresnel_schlick(1.0, fresnel_90, lambert_in)
        brdf = brdf + (f_out * f_in)[..., None] * data.diffuse_albedo
    if specular:
        normal_dot_half = dot(data.normal, half_vector)
        r_sq = data.roughness * data.roughness
        ggx = (normal_dot_half * r_sq - normal_dot_half) * normal_dot_half \
            + 1.0
        ggx = r_sq / (ggx * ggx)
        lo = data.lambert_outgoing
        masking = lambert_in * torch.sqrt((-lo * r_sq + lo) * lo + r_sq)
        shadowing = lo * torch.sqrt(
            (-lambert_in * r_sq + lambert_in) * lambert_in + r_sq)
        smith = 0.5 / (masking + shadowing)
        fresnel = fresnel_schlick(
            data.fresnel_0, 1.0,
            torch.clamp(out_dot_half, 0.0, 1.0)[..., None])
        brdf = brdf + (ggx * smith)[..., None] * fresnel
    return brdf * M_INV_PI


def sample_ggx_visible_normal(outgoing_shading_space, roughness_xy,
                              random_numbers):
    """Sample the GGX visible-normal distribution (brdfs.glsl:122-162),
    in shading space (z = surface normal). outgoing: (P, 3);
    roughness_xy, random_numbers: (P, 2)."""
    out = outgoing_shading_space
    axis_z = normalize(torch.stack([roughness_xy[..., 0] * out[..., 0],
                                    roughness_xy[..., 1] * out[..., 1],
                                    out[..., 2]], dim=-1))
    length_sq = axis_z[..., 0] ** 2 + axis_z[..., 1] ** 2
    inv_len = torch.where(
        length_sq > 0.0,
        1.0 / torch.sqrt(torch.clamp(length_sq, min=1e-37)), 0.0)
    axis_x = torch.stack([-axis_z[..., 1] * inv_len,
                          axis_z[..., 0] * inv_len,
                          torch.zeros_like(inv_len)], dim=-1)
    axis_x = torch.where((length_sq <= 0.0)[..., None],
                         axis_x.new_tensor([1.0, 0.0, 0.0]), axis_x)
    axis_y = cross(axis_z, axis_x)

    radius = torch.sqrt(random_numbers[..., 0])
    azimuth = (2.0 * M_PI) * random_numbers[..., 1]
    disk_x = radius * torch.cos(azimuth)
    disk_y = radius * torch.sin(azimuth)
    lerp_factor = 0.5 * axis_z[..., 2] + 0.5
    y = (1.0 - lerp_factor) \
        * torch.sqrt(torch.clamp(1.0 - disk_x * disk_x, min=0.0)) \
        + lerp_factor * disk_y
    z = torch.sqrt(torch.clamp(1.0 - disk_x * disk_x - y * y, min=0.0))
    hemi = disk_x[..., None] * axis_x + y[..., None] * axis_y \
        + z[..., None] * axis_z
    return normalize(torch.stack([roughness_xy[..., 0] * hemi[..., 0],
                                  roughness_xy[..., 1] * hemi[..., 1],
                                  hemi[..., 2]], dim=-1))


def ggx_visible_normal_density(outgoing_dot_normal, microfacet_dot_normal,
                               microfacet_dot_outgoing, roughness):
    """Density of sample_ggx_visible_normal (brdfs.glsl:180-191)."""
    r_sq = roughness * roughness
    m = microfacet_dot_normal
    ggx = (m * r_sq - m) * m + 1.0
    ggx = r_sq / (ggx * ggx) * M_INV_PI
    o = outgoing_dot_normal
    masking_over_out_z = torch.sqrt((-o * r_sq + o) * o + r_sq)
    masking_over_out_z = 2.0 / (o + masking_over_out_z)
    return masking_over_out_z * microfacet_dot_outgoing * ggx


def sample_ggx_reflected_direction(outgoing_shading_space, roughness,
                                   random_numbers):
    """A direction roughly proportional to the GGX specular BRDF
    (brdfs.glsl:200-213): (direction (P, 3), density (P,))."""
    roughness_xy = torch.stack([roughness, roughness], dim=-1)
    micro_normal = sample_ggx_visible_normal(outgoing_shading_space,
                                             roughness_xy, random_numbers)
    micro_dot_out = dot(micro_normal, outgoing_shading_space)
    density = ggx_visible_normal_density(outgoing_shading_space[..., 2],
                                         micro_normal[..., 2],
                                         micro_dot_out, roughness)
    incoming = (2.0 * micro_dot_out)[..., None] * micro_normal \
        - outgoing_shading_space
    return incoming, density / (4.0 * micro_dot_out)


def ggx_reflected_direction_density(outgoing_dot_normal, outgoing_dir,
                                    incoming_dir, surface_normal, roughness):
    """Density of sample_ggx_reflected_direction (brdfs.glsl:218-224)."""
    micro_normal = normalize(outgoing_dir + incoming_dir)
    micro_dot_out = dot(micro_normal, outgoing_dir)
    micro_dot_normal = dot(micro_normal, surface_normal)
    density = ggx_visible_normal_density(outgoing_dot_normal,
                                         micro_dot_normal, micro_dot_out,
                                         roughness)
    return density / (4.0 * micro_dot_out)
