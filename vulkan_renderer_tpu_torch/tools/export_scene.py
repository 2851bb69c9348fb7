"""Triangle soup -> .vks, plus the procedural test scenes (cornell box,
roughness planes).

Counterpart of vulkan_renderer_tpu/tools/export_scene.py without JAX. The
pipeline is the reference Blender exporter's: Morton sort of triangles by
centroid (io_export_vulkan_blender28.py:459-469), 21-bit positions
(:476-487), octahedral 16-bit normals (:24-46), UVs quantized x(65535/8)
with offset-to-min-cell (:508-520). Same inputs give the same bytes as the
JAX package's writer.
"""

from __future__ import annotations

import os

import numpy as np

from vulkan_renderer_tpu.assets.vks import SceneMesh, save_vks

from ..assets import vkt
from ..ops.math_utils import (encode_normal_octahedral_32bit_np,
                              encode_position_64bit_np)


def _morton_3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integer coords into a 63-bit Morton code."""
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v
    return spread(x) | (spread(y) << np.uint64(1)) \
        | (spread(z) << np.uint64(2))


def morton_order(centroids: np.ndarray, box_min, box_max) -> np.ndarray:
    """Triangle order by the Morton code of the centroid."""
    extent = np.maximum(np.asarray(box_max) - np.asarray(box_min), 1e-30)
    q = np.clip((centroids - box_min) / extent * ((1 << 21) - 1),
                0, (1 << 21) - 1).astype(np.uint64)
    codes = _morton_3d(q[:, 0], q[:, 1], q[:, 2])
    return np.argsort(codes, kind="stable")


def build_scene_mesh(positions: np.ndarray, normals: np.ndarray,
                     tex_coords: np.ndarray, material_indices: np.ndarray,
                     material_names: list[str]) -> SceneMesh:
    """Quantize a triangle soup into the .vks representation.

    positions: (T, 3, 3); normals: (T, 3, 3); tex_coords: (T, 3, 2);
    material_indices: (T,)."""
    positions = np.asarray(positions, np.float64)
    tri_count = positions.shape[0]
    box_min = positions.reshape(-1, 3).min(axis=0)
    box_max = positions.reshape(-1, 3).max(axis=0)
    degenerate = box_max - box_min < 1e-9  # flat scenes
    box_max = np.where(degenerate, box_min + 1.0, box_max)

    order = morton_order(positions.mean(axis=1), box_min, box_max)
    positions = positions[order]
    normals = np.asarray(normals, np.float64)[order]
    tex_coords = np.asarray(tex_coords, np.float64)[order]
    material_indices = np.asarray(material_indices, np.uint8)[order]

    packed, factor, summand = encode_position_64bit_np(
        positions.reshape(-1, 3), box_min, box_max)
    oct_normals = encode_normal_octahedral_32bit_np(normals.reshape(-1, 3))

    # The shader decodes tex_coord = fma(unorm, (8, -8), (0, 1)): encode
    # u' = u and w = 1 - v, each shifted to its per-triangle min cell
    # (integer shifts are invisible under wrapping), then /8 to UNORM.
    uv = tex_coords.reshape(tri_count, 3, 2)
    u = uv[..., 0]
    w = 1.0 - uv[..., 1]
    u = u - np.floor(u.min(axis=1, keepdims=True))
    w = w - np.floor(w.min(axis=1, keepdims=True))
    quant_uv = np.clip(np.round(
        np.stack([u, w], axis=-1) / 8.0 * 65535.0), 0, 65535) \
        .astype(np.uint16).reshape(-1, 2)

    return SceneMesh(
        material_names=material_names,
        dequantization_factor=factor,
        dequantization_summand=summand,
        quantized_positions=packed,
        normals_and_tex_coords=np.concatenate([oct_normals, quant_uv],
                                              axis=-1),
        material_indices=material_indices,
    )


def _quad(p0, p1, p2, p3, material, uv_scale=1.0):
    """Two triangles for quad p0-p1-p2-p3 (ccw), with planar UVs."""
    p0, p1, p2, p3 = [np.asarray(p, np.float64) for p in (p0, p1, p2, p3)]
    normal = np.cross(p1 - p0, p3 - p0)
    normal = normal / np.linalg.norm(normal)
    uvs = np.array([[0, 0], [uv_scale, 0], [uv_scale, uv_scale],
                    [0, uv_scale]], np.float64)
    tris, norms, uv_out, mats = [], [], [], []
    for ids in ((0, 1, 2), (0, 2, 3)):
        corners = [p0, p1, p2, p3]
        tris.append([corners[i] for i in ids])
        norms.append([normal] * 3)
        uv_out.append([uvs[i] for i in ids])
        mats.append(material)
    return tris, norms, uv_out, mats


def make_cornell_box(size: float = 2.0) -> tuple:
    """Floor, ceiling, back, red left and green right walls and two boxes
    (z up). Returns (tris, normals, uvs, material_indices, names)."""
    s = size
    tris, norms, uvs, mats = [], [], [], []

    def add(quad_args):
        t, n, u, m = quad_args
        tris.extend(t)
        norms.extend(n)
        uvs.extend(u)
        mats.extend(m)

    add(_quad([0, 0, 0], [s, 0, 0], [s, s, 0], [0, s, 0], 0))
    add(_quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s], 0))
    add(_quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s], 0))
    add(_quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s], 1))
    add(_quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0], 2))

    def add_box(cx, cy, w, d, h, rot, material):
        c, sn = np.cos(rot), np.sin(rot)
        r = np.array([[c, -sn], [sn, c]])
        corners = np.array([[-w / 2, -d / 2], [w / 2, -d / 2],
                            [w / 2, d / 2], [-w / 2, d / 2]]) @ r.T \
            + np.array([cx, cy])
        bottom = [np.array([x, y, 0.0]) for x, y in corners]
        top = [np.array([x, y, h]) for x, y in corners]
        add(_quad(top[0], top[1], top[2], top[3], material))
        for i in range(4):
            j = (i + 1) % 4
            add(_quad(bottom[i], bottom[j], top[j], top[i], material))

    add_box(0.35 * s, 0.6 * s, 0.3 * s, 0.3 * s, 0.6 * s, np.radians(17), 0)
    add_box(0.68 * s, 0.3 * s, 0.3 * s, 0.3 * s, 0.3 * s, np.radians(-16), 0)
    return (np.array(tris), np.array(norms), np.array(uvs),
            np.array(mats, np.uint8), ["white", "red", "green"])


def make_plane_scene(size: float = 10.0, material_count: int = 1) -> tuple:
    """Textured ground plane (the roughness-planes and MIS-plane stand-in):
    material_count quads side by side in the z = 0 plane."""
    tris, norms, uvs, mats = [], [], [], []
    width = size / material_count
    for m in range(material_count):
        x0 = -size / 2 + m * width
        t, n, u, mm = _quad([x0, -size / 2, 0], [x0 + width, -size / 2, 0],
                            [x0 + width, size / 2, 0], [x0, size / 2, 0],
                            m, uv_scale=4.0)
        tris.extend(t)
        norms.extend(n)
        uvs.extend(u)
        mats.extend(mm)
    names = [f"plane{m}" for m in range(material_count)]
    return (np.array(tris), np.array(norms), np.array(uvs),
            np.array(mats, np.uint8), names)


def checkerboard_texture(resolution: int = 256, squares: int = 8,
                         color_a=(0.725, 0.71, 0.68),
                         color_b=(0.325, 0.31, 0.25)) -> np.ndarray:
    ij = np.arange(resolution) * squares // resolution
    checker = (ij[:, None] + ij[None, :]) % 2
    img = np.where(checker[..., None] == 0,
                   np.asarray(color_a, np.float32),
                   np.asarray(color_b, np.float32))
    return img.astype(np.float32)


def write_material_textures(tex_dir: str, name: str, base: np.ndarray,
                            specular: np.ndarray) -> None:
    """<name>_{BaseColor (BC1 sRGB), Specular (BC1), Normal (BC5, flat)}.vkt,
    the three files load_scene expects per material (scene.c:523-543)."""
    r = base.shape[0]
    vkt.save_vkt(os.path.join(tex_dir, f"{name}_BaseColor.vkt"),
                 vkt.encode_texture(base, vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK))
    vkt.save_vkt(os.path.join(tex_dir, f"{name}_Specular.vkt"),
                 vkt.encode_texture(np.tile(specular, (r, r, 1)),
                                    vkt.VK_FORMAT_BC1_RGB_UNORM_BLOCK))
    normal = np.tile(np.array([0.5, 0.5], np.float32), (r, r, 1))
    vkt.save_vkt(os.path.join(tex_dir, f"{name}_Normal.vkt"),
                 vkt.encode_texture(normal, vkt.VK_FORMAT_BC5_UNORM_BLOCK))


def write_test_scene(directory: str, scene: str = "cornell_box",
                     texture_resolution: int = 128) -> str:
    """A procedural test scene, "cornell_box" or "roughness_planes": .vks
    plus <dir>/<scene>_textures/*.vkt. Returns the .vks path."""
    if scene == "cornell_box":
        tris, norms, uvs, mats, names = make_cornell_box()
        base_colors = [(0.73, 0.73, 0.73), (0.61, 0.06, 0.06),
                       (0.12, 0.45, 0.09)]
    elif scene == "roughness_planes":
        tris, norms, uvs, mats, names = make_plane_scene(material_count=5)
        base_colors = [(0.7, 0.7, 0.7)] * 5
    else:
        raise ValueError(scene)
    os.makedirs(directory, exist_ok=True)
    tex_dir = os.path.join(directory, f"{scene}_textures")
    os.makedirs(tex_dir, exist_ok=True)
    vks_path = os.path.join(directory, f"{scene}.vks")
    save_vks(vks_path, build_scene_mesh(tris, norms, uvs, mats, names))
    r = texture_resolution
    for i, name in enumerate(names):
        base = checkerboard_texture(r, 8, base_colors[i],
                                    tuple(0.85 * c for c in base_colors[i]))
        # Specular: (occlusion, linear roughness, metalicity).
        write_material_textures(
            tex_dir, name, base,
            np.array([1.0, 0.3 + 0.1 * i, 0.0], np.float32))
    return vks_path
