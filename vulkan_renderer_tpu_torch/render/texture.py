"""Texture fetch without texture units: material and light textures.

Counterpart of vulkan_renderer_tpu/render/texture.py: all mips of all
textures are flattened into one texel array (the atlas) and filtered by
explicit gathers — isotropic trilinear with the footprint LOD of the
Vulkan spec for materials (textureGrad, shading_pass.frag.glsl:754-766),
bilinear at mip 0 for light textures (textureLod(.., 0)), both with repeat
addressing like the reference's samplers (scene.c:546-557). Material
atlases hold UNORM16 texels, light atlases float32 ones (HDR probes). The
TPU build's corner-quad view is not carried over: a GPU gathers the four
bilinear corners directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TextureAtlas:
    texels: torch.Tensor      # (N, C) int32 holding UNORM16 values, or
    #                           float32
    mip_offset: torch.Tensor  # (T, L) int64 first texel of mip l of texture t
    mip_width: torch.Tensor   # (T, L) int64
    mip_height: torch.Tensor  # (T, L) int64
    mip_count: torch.Tensor   # (T,) int64


def build_texture_atlas_np(textures: "list[list[np.ndarray]]",
                           channels: int = 8, unorm16: bool = True) -> dict:
    """textures: per texture, list of (H, W, C) float32 mips -> numpy
    atlas arrays {texels, mip_offset, mip_width, mip_height, mip_count},
    laid out exactly as the JAX package's build_texture_atlas. The
    material atlas (channels 8, unorm16) stores round(clip(v, 0, 1) *
    65535) as uint16, lossless for BC-decoded material data; the light
    atlas (channels 4, unorm16 False) float32 texels, alpha 1 where a
    texture has fewer than 4 channels."""
    texel_list = []
    offsets, widths, heights, counts = [], [], [], []
    max_levels = max(len(mips) for mips in textures)
    cursor = 0
    for mips in textures:
        off, ws, hs = [], [], []
        for m in mips:
            h, w = m.shape[:2]
            flat = np.zeros((h * w, channels), np.float32)
            c = min(channels, m.shape[-1])
            flat[:, :c] = m.reshape(h * w, -1)[:, :c]
            if channels == 4 and m.shape[-1] < 4:
                flat[:, 3] = 1.0
            texel_list.append(flat)
            off.append(cursor)
            ws.append(w)
            hs.append(h)
            cursor += h * w
        while len(off) < max_levels:  # pad level tables with the last mip
            off.append(off[-1])
            ws.append(ws[-1])
            hs.append(hs[-1])
        offsets.append(off)
        widths.append(ws)
        heights.append(hs)
        counts.append(len(mips))
    texels = np.concatenate(texel_list, axis=0)
    if unorm16:
        texels = np.round(np.clip(texels, 0.0, 1.0)
                          * 65535.0).astype(np.uint16)
    return dict(texels=texels,
                mip_offset=np.array(offsets, np.int32),
                mip_width=np.array(widths, np.int32),
                mip_height=np.array(heights, np.int32),
                mip_count=np.array(counts, np.int32))


def atlas_from_numpy(arrays: dict, device) -> TextureAtlas:
    """Atlas arrays (build_texture_atlas_np's, or a JAX TextureAtlas's)
    on `device`: UNORM16 texels as int32, float32 texels as they are."""
    texels = np.asarray(arrays["texels"])
    if texels.dtype not in (np.uint16, np.float32):
        raise TypeError(f"atlas texels must be UNORM16 or float32, got "
                        f"{texels.dtype}")
    return TextureAtlas(
        texels=torch.from_numpy(texels.astype(
            np.int32 if texels.dtype == np.uint16 else np.float32))
        .to(device),
        **{k: torch.from_numpy(np.array(arrays[k], np.int64))
           .to(device)
           for k in ("mip_offset", "mip_width", "mip_height", "mip_count")})


def _bilinear_wrap(atlas: TextureAtlas, tex_index, level, uv):
    """Bilinear fetch with repeat addressing at per-pixel mip levels.
    tex_index, level: (P,) int64; uv: (P, 2)."""
    w = atlas.mip_width[tex_index, level]
    h = atlas.mip_height[tex_index, level]
    offset = atlas.mip_offset[tex_index, level]
    x = uv[:, 0] * w.to(torch.float32) - 0.5
    y = uv[:, 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.nan_to_num(x0, nan=0.0, posinf=0.0, neginf=0.0).long()
    y0i = torch.nan_to_num(y0, nan=0.0, posinf=0.0, neginf=0.0).long()

    def fetch(xi, yi):
        texel = atlas.texels[offset + torch.remainder(yi, h) * w
                             + torch.remainder(xi, w)]
        if texel.dtype == torch.float32:
            return texel
        return texel.to(torch.float32) * (1.0 / 65535.0)

    t00 = fetch(x0i, y0i)
    t10 = fetch(x0i + 1, y0i)
    t01 = fetch(x0i, y0i + 1)
    t11 = fetch(x0i + 1, y0i + 1)
    top = t00 + fx * (t10 - t00)
    bottom = t01 + fx * (t11 - t01)
    return top + fy * (bottom - top)


def _trilinear(atlas: TextureAtlas, tex_index, uv, lod):
    l0 = torch.nan_to_num(torch.floor(lod), nan=0.0).long()
    l1 = torch.minimum(l0 + 1, atlas.mip_count[tex_index] - 1)
    frac = (lod - l0.to(torch.float32))[:, None]
    c0 = _bilinear_wrap(atlas, tex_index, l0, uv)
    c1 = _bilinear_wrap(atlas, tex_index, l1, uv)
    return c0 + frac * (c1 - c0)


def sample_texture_grad(atlas: TextureAtlas, tex_index, uv, duv_dx, duv_dy):
    """textureGrad with isotropic trilinear filtering: the LOD is log2 of
    the larger scaled derivative norm (Vulkan spec rho_max). tex_index:
    (P,) int64; uv, duv_dx, duv_dy: (P, 2). Returns (P, C) float32."""
    zeros = torch.zeros_like(tex_index)
    w0 = atlas.mip_width[tex_index, zeros].to(torch.float32)
    h0 = atlas.mip_height[tex_index, zeros].to(torch.float32)
    dx0, dx1 = duv_dx[:, 0] * w0, duv_dx[:, 1] * h0
    dy0, dy1 = duv_dy[:, 0] * w0, duv_dy[:, 1] * h0
    rho_x = torch.sqrt(dx0 * dx0 + dx1 * dx1)
    rho_y = torch.sqrt(dy0 * dy0 + dy1 * dy1)
    rho_max = torch.clamp(torch.maximum(rho_x, rho_y), min=1e-12)
    max_level = (atlas.mip_count[tex_index] - 1).to(torch.float32)
    lod = torch.minimum(torch.clamp(torch.log2(rho_max), min=0.0), max_level)
    return _trilinear(atlas, tex_index, uv, lod)


def sample_texture_lod0(atlas: TextureAtlas, tex_index, uv):
    """textureLod(.., 0): bilinear at mip 0 with repeat addressing (light
    textures, shading_pass.frag.glsl:170-184). tex_index: (P,) int64 or an
    int; uv: (P, 2). Returns (P, C) float32."""
    if isinstance(tex_index, int):
        tex_index = torch.full(uv.shape[:1], tex_index, dtype=torch.int64,
                               device=uv.device)
    return _bilinear_wrap(atlas, tex_index, torch.zeros_like(tex_index), uv)
