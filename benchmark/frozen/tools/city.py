"""Procedural city: a street of subdivided box buildings on a ground plane.

Counterpart of vulkan_renderer_tpu/tools/city.py (the stand-in for the
reference's Bistro benchmark scene), without JAX. The same seed gives the
same triangles, .vks bytes and textures as the JAX package's generator.
"""

from __future__ import annotations

import os

import numpy as np

from ..assets.vks import save_vks
from .export_scene import (build_scene_mesh, checkerboard_texture,
                           write_material_textures)


def make_city(n_buildings: int = 600, seed: int = 7,
              n_materials: int = 6,
              detail: int = 3) -> tuple:
    """Returns (tris, normals, uvs, material_indices, material_names).
    About n_buildings * 90 * (detail / 3)^2 triangles."""
    rng = np.random.default_rng(seed)
    tris, norms, uvs, mats = [], [], [], []

    def add_quad(p0, p1, p2, p3, material, uv_scale=1.0, subdivide=1):
        p0, p1, p2, p3 = [np.asarray(p, np.float64) for p in (p0, p1, p2, p3)]
        n = np.cross(p1 - p0, p3 - p0)
        norm = np.linalg.norm(n)
        if norm < 1e-12:
            return
        n = n / norm
        for i in range(subdivide):
            for j in range(subdivide):
                f0, f1 = i / subdivide, (i + 1) / subdivide
                g0, g1 = j / subdivide, (j + 1) / subdivide

                def lerp2(fu, fv):
                    a = p0 + (p1 - p0) * fu
                    b = p3 + (p2 - p3) * fu
                    return a + (b - a) * fv

                c00, c10 = lerp2(f0, g0), lerp2(f1, g0)
                c11, c01 = lerp2(f1, g1), lerp2(f0, g1)
                u0, u1 = f0 * uv_scale, f1 * uv_scale
                v0, v1 = g0 * uv_scale, g1 * uv_scale
                for ids, uvq in (((c00, c10, c11),
                                  ((u0, v0), (u1, v0), (u1, v1))),
                                 ((c00, c11, c01),
                                  ((u0, v0), (u1, v1), (u0, v1)))):
                    tris.append(list(ids))
                    norms.append([n] * 3)
                    uvs.append(list(uvq))
                    mats.append(material)

    n_materials = min(max(n_materials, 2), 256)
    size = 220.0
    add_quad([-size, -size, 0], [size, -size, 0], [size, size, 0],
             [-size, size, 0], 0, uv_scale=32.0, subdivide=8)

    for b in range(n_buildings):
        side = 1 if b % 2 == 0 else -1  # two parallel street fronts
        along = (b // 2) * 7.0 - (n_buildings // 4) * 7.0 \
            + rng.uniform(-1.0, 1.0)
        w = rng.uniform(4.0, 6.5)
        d = rng.uniform(4.0, 9.0)
        h = rng.uniform(4.0, 18.0)
        cx = along
        cy = side * (6.0 + d / 2 + rng.uniform(0, 3))
        material = 1 + (b % (n_materials - 1))
        x0, x1 = cx - w / 2, cx + w / 2
        y0, y1 = cy - d / 2, cy + d / 2
        add_quad([x0, y0, h], [x1, y0, h], [x1, y1, h], [x0, y1, h],
                 material, 2.0, detail)
        add_quad([x0, y0, 0], [x1, y0, 0], [x1, y0, h], [x0, y0, h],
                 material, 3.0, detail)
        add_quad([x1, y1, 0], [x0, y1, 0], [x0, y1, h], [x1, y1, h],
                 material, 3.0, detail)
        add_quad([x0, y1, 0], [x0, y0, 0], [x0, y0, h], [x0, y1, h],
                 material, 3.0, detail)
        add_quad([x1, y0, 0], [x1, y1, 0], [x1, y1, h], [x1, y0, h],
                 material, 3.0, detail)

    names = [f"city{m}" for m in range(n_materials)]
    return (np.array(tris), np.array(norms), np.array(uvs),
            np.array(mats, np.uint8), names)


def write_city_scene(directory: str, stem: str = "city",
                     n_buildings: int = 600, texture_resolution: int = 64,
                     detail: int = 3, n_materials: int = 6) -> str:
    """Write <dir>/<stem>.vks and <dir>/<stem>_textures/*.vkt; returns the
    .vks path."""
    os.makedirs(directory, exist_ok=True)
    tris, norms, uvs, mats, names = make_city(n_buildings, detail=detail,
                                              n_materials=n_materials)
    vks_path = os.path.join(directory, f"{stem}.vks")
    save_vks(vks_path, build_scene_mesh(tris, norms, uvs, mats, names))
    tex_dir = os.path.join(directory, "Bistro_textures"
                           if stem.startswith("Bistro") else f"{stem}_textures")
    os.makedirs(tex_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    r = texture_resolution
    for i, name in enumerate(names):
        tint = 0.4 + 0.5 * rng.uniform(0, 1, 3)
        base = checkerboard_texture(r, 4 + i, tuple(tint), tuple(tint * 0.8))
        write_material_textures(
            tex_dir, name, base,
            np.array([1.0, 0.25 + 0.1 * i, 0.05 * i], np.float32))
    return vks_path
