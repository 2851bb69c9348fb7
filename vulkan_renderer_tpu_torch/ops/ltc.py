"""Linearly transformed cosines: per-pixel coefficient fetch.

Counterpart of vulkan_renderer_tpu/ops/ltc.py (reference
ltc_utility.glsl:15-119), batched over pixels: the bilinear fetch gathers
the four corners of the merged (F, I, R, 6) table directly.
"""

from __future__ import annotations

import dataclasses

import torch

from .math_utils import cross, dot, normalize


@dataclasses.dataclass
class LtcTable:
    table: torch.Tensor      # (F, I, R, 6) float32
    constants: torch.Tensor  # (6,) float32, see assets/ltc_table.py


@dataclasses.dataclass
class LtcCoefficients:
    """Per-pixel LTC frame + transform (ltc_utility.glsl:28-50); leading
    pixel axis on every field."""
    world_to_shading_space: torch.Tensor   # (P, 3, 4)
    shading_to_cosine_space: torch.Tensor  # (P, 3, 3)
    world_to_cosine_space: torch.Tensor    # (P, 3, 4)
    cosine_to_shading_space: torch.Tensor  # (P, 3, 3)
    albedo: torch.Tensor                   # (P,)
    shading_to_cosine_space_determinant: torch.Tensor  # (P,)


def _bilinear_fetch(table, tex_x, tex_y, layer):
    """Clamp-to-edge bilinear lookup in (L, H, W, C); texcoords address
    texel centers at (i+0.5)/N; the layer rounds to nearest."""
    layers, height, width = table.shape[0], table.shape[1], table.shape[2]
    x = torch.clamp(tex_x * width - 0.5, 0.0, width - 1.0)
    y = torch.clamp(tex_y * height - 0.5, 0.0, height - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    # A miss pixel's NaN coordinates must still index in range (its
    # result is NaN through fx/fy and gated off later, as in the JAX
    # package, whose gathers clamp).
    x0 = torch.nan_to_num(x0f, nan=0.0).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).long()
    li = torch.clamp(torch.nan_to_num(torch.round(layer), nan=0.0).long(),
                     0, layers - 1)
    x1 = torch.clamp(x0 + 1, max=width - 1)
    y1 = torch.clamp(y0 + 1, max=height - 1)
    t00 = table[li, y0, x0]
    t01 = table[li, y0, x1]
    t10 = table[li, y1, x0]
    t11 = table[li, y1, x1]
    top = t00 + fx * (t01 - t00)
    bottom = t10 + fx * (t11 - t10)
    return top + fy * (bottom - top)


def get_ltc_coefficients(ltc: LtcTable, fresnel_luminance, roughness,
                         world_position, world_normal, world_outgoing
                         ) -> LtcCoefficients:
    """(P,) fresnel luminance and roughness, (P, 3) position, normal and
    outgoing direction -> LtcCoefficients (ltc_utility.glsl:58-91)."""
    c = ltc.constants
    normal_dot_outgoing = dot(world_normal, world_outgoing)
    inclination = torch.acos(torch.clamp(normal_dot_outgoing, 0.0, 1.0))
    tex_x = torch.sqrt(torch.clamp(roughness, 0.0, 1.0)) * c[2] + c[3]
    tex_y = inclination * c[4] + c[5]
    layer = torch.clamp(fresnel_luminance, 0.0, 1.0) * c[0] + c[1]

    data = _bilinear_fetch(ltc.table, tex_x, tex_y, layer)
    d0x, d0y, d0z, d0w = data[:, 0], data[:, 1], data[:, 2], data[:, 3]
    d1x, d1y = data[:, 4], data[:, 5]
    zero = torch.zeros_like(d0x)

    # shading_to_cosine_space rows: [d0x 0 d0w], [0 d0z 0], [-d0y 0 d1x].
    m = torch.stack([torch.stack([d0x, zero, d0w], -1),
                     torch.stack([zero, d0z, zero], -1),
                     torch.stack([-d0y, zero, d1x], -1)], -2)
    det_2x2 = d0x * d1x + d0y * d0w
    determinant = d0z * det_2x2
    inv_det_2x2 = 1.0 / det_2x2
    m_inv = torch.stack([
        torch.stack([d1x * inv_det_2x2, zero, -d0w * inv_det_2x2], -1),
        torch.stack([zero, 1.0 / d0z, zero], -1),
        torch.stack([d0y * inv_det_2x2, zero, d0x * inv_det_2x2], -1)], -2)

    # Shading frame: x-axis in the plane of normal and outgoing.
    x_axis = normalize(-normal_dot_outgoing[:, None] * world_normal
                       + world_outgoing)
    y_axis = cross(world_normal, x_axis)
    rotation = torch.stack([x_axis, y_axis, world_normal], dim=-2)
    translation = -torch.stack([dot(x_axis, world_position),
                                dot(y_axis, world_position),
                                dot(world_normal, world_position)], dim=-1)
    world_to_shading = torch.cat([rotation, translation[:, :, None]], dim=-1)
    # world_to_cosine = m @ world_to_shading with m's sparsity
    # (rows [a 0 b], [0 c 0], [-d 0 e]).
    ws0 = world_to_shading[:, 0, :]
    ws1 = world_to_shading[:, 1, :]
    ws2 = world_to_shading[:, 2, :]
    world_to_cosine = torch.stack(
        [d0x[:, None] * ws0 + d0w[:, None] * ws2,
         d0z[:, None] * ws1,
         -d0y[:, None] * ws0 + d1x[:, None] * ws2], dim=-2)
    return LtcCoefficients(
        world_to_shading_space=world_to_shading,
        shading_to_cosine_space=m,
        world_to_cosine_space=world_to_cosine,
        cosine_to_shading_space=m_inv,
        albedo=d1y,
        shading_to_cosine_space_determinant=determinant,
    )


def evaluate_ltc_density(ltc: LtcCoefficients, dir_shading_space,
                         rcp_projected_solid_angle):
    """LTC density with respect to solid angle (ltc_utility.glsl:103-108)
    of (P, 3) shading-space directions: the JAX package's
    evaluate_ltc_density, batched."""
    m = ltc.shading_to_cosine_space
    d = dir_shading_space
    dir_cos = [m[:, i, 0] * d[:, 0] + m[:, i, 1] * d[:, 1]
               + m[:, i, 2] * d[:, 2] for i in range(3)]
    len_sq = dir_cos[0] * dir_cos[0] + dir_cos[1] * dir_cos[1] \
        + dir_cos[2] * dir_cos[2]
    density = torch.clamp(dir_cos[2], min=0.0) \
        * ltc.shading_to_cosine_space_determinant / (len_sq * len_sq)
    return density * rcp_projected_solid_angle
