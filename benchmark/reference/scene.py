"""The reference's scene, worked out again from the raw files and numbers
the benchmark hands both sides: the .vks mesh and its .vkt textures, the
light and camera numbers, the noise table file and the packaged LTC fits.
Nothing the program made is read.

The raw files are parsed by the frozen file readers (frozen/assets:
load_vks, load_vkt's block decoders, load_noise_table, the LTC fit
reader). Everything derived from them is transcribed here from the JAX
package, the renderer the port was ported from (vulkan_renderer_tpu at
commit b4b0e8b): the mesh decode (assets/vks.py SceneMesh), the material
texture packing and its UNORM16 atlas (scene/scene.py, render/texture.py),
the light records (scene/lights.py update_polygonal_light), the camera's
pixel-to-ray matrix (scene/camera.py), the LTC texture constants
(ops/ltc.py) and the per-frame noise numbers (assets/noise.py). The
triangles stay flat for the brute-force tracer.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from frozen.assets.ltc_table import default_ltc_table
from frozen.assets.noise import load_noise_table
from frozen.assets.vks import load_vks
from frozen.assets.vkt import load_vkt

M_PI = 3.14159265358979323846
MAXL = 7  # MAX_POLYGONAL_LIGHT_VERTEX_COUNT
MAXV = MAXL + 1  # MAX_POLYGON_VERTEX_COUNT: a clipped light gains one
MATERIAL_TEXTURE_SUFFIXES = ("BaseColor", "Specular", "Normal")


@dataclasses.dataclass
class Atlas:
    """All mips of all textures as rows of one table (render/texture.py
    TextureAtlas without the corner-quad view): texels (N, C) float32,
    already normalized from UNORM16; per texture and level the first row,
    width and height; per texture its level count."""
    texels: torch.Tensor
    offset: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    count: torch.Tensor


@dataclasses.dataclass
class ReferenceScene:
    positions: torch.Tensor  # (T, 3, 3)
    normals: torch.Tensor    # (T, 3, 3)
    uvs: torch.Tensor        # (T, 3, 2)
    material: torch.Tensor   # (T,) int64
    v0: torch.Tensor         # (T, 3), for the tracer
    e1: torch.Tensor
    e2: torch.Tensor
    atlas: Atlas
    light_count: int
    light_vertex_counts: tuple
    light_plane: torch.Tensor     # (L, 4)
    light_vertices: torch.Tensor  # (L, MAXL, 3) first vertex repeated
    light_radiance: torch.Tensor  # (L, 3) surface radiance
    ltc_table: torch.Tensor       # (F, I, R, 6)
    ltc_constants: tuple          # six float32 numbers (ops/ltc.py)
    noise: torch.Tensor           # (layers, H, W, 4) int64 UNORM16
    noise_resolution_mask: tuple  # (W - 1, H - 1)
    noise_texture_index_mask: int


# -- the mesh (assets/vks.py SceneMesh) ------------------------------------

def decode_normal_octahedral(unorm: np.ndarray) -> np.ndarray:
    """ops/math_utils.py decode_normal_octahedral_32bit."""
    factor = np.float32(2.0 * (65534.0 / 65535.0))
    summand = np.float32(-(32768.0 / 65535.0) * (2.0 * (65534.0 / 65535.0)))
    o = unorm * factor + summand
    ox, oy = o[..., 0], o[..., 1]
    nz = np.float32(1.0) - np.abs(ox) - np.abs(oy)
    sign_x = np.where(ox >= 0.0, np.float32(1.0), np.float32(-1.0))
    sign_y = np.where(oy >= 0.0, np.float32(1.0), np.float32(-1.0))
    below = nz < 0.0
    nx = np.where(below, (np.float32(1.0) - np.abs(oy)) * sign_x, ox)
    ny = np.where(below, (np.float32(1.0) - np.abs(ox)) * sign_y, oy)
    n = np.stack([nx, ny, nz], axis=-1).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def mesh_triangles(mesh):
    """(T, 3, 3) positions, (T, 3, 3) normals, (T, 3, 2) uvs."""
    q = mesh.quantized_positions.astype(np.uint64)
    combined = q[:, 0] | (q[:, 1] << np.uint64(32))
    mask = np.uint64(0x1FFFFF)
    pos = np.stack([combined & mask, (combined >> np.uint64(21)) & mask,
                    (combined >> np.uint64(42)) & mask],
                   axis=-1).astype(np.float32)
    positions = pos * mesh.dequantization_factor \
        + mesh.dequantization_summand
    unorm = mesh.normals_and_tex_coords.astype(np.float32) / \
        np.float32(65535.0)
    normals = decode_normal_octahedral(unorm[:, :2])
    # The shader applies fma(uv, (8, -8), (0, 1)) (glsl:734).
    uvs = unorm[:, 2:] * np.array([8.0, -8.0], np.float32) \
        + np.array([0.0, 1.0], np.float32)
    return (positions.astype(np.float32).reshape(-1, 3, 3),
            normals.reshape(-1, 3, 3), uvs.reshape(-1, 3, 2))


# -- textures (scene/scene.py, render/texture.py) --------------------------

def _nearest_resize(img, h, w):
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def material_textures(texture_dir: str, names) -> list:
    """Per material its mips as (H, W, 8): base color, specular data
    (occlusion, roughness, metalicity) and the normal's xy, each chain
    brought to the base color's resolutions."""
    fallbacks = {
        "BaseColor": np.full((4, 4, 3), 0.8, np.float32),
        "Specular": np.tile(np.array([1.0, 0.5, 0.0], np.float32),
                            (4, 4, 1)),
        "Normal": np.tile(np.array([0.5, 0.5], np.float32), (4, 4, 1))}
    textures = []
    for name in names:
        chains = []
        for suffix in MATERIAL_TEXTURE_SUFFIXES:
            path = os.path.join(texture_dir, f"{name}_{suffix}.vkt")
            chains.append(load_vkt(path).decode_to_float()
                          if os.path.exists(path) else [fallbacks[suffix]])
        packed = []
        for level, base in enumerate(chains[0]):
            h, w = base.shape[:2]
            spec = chains[1][min(level, len(chains[1]) - 1)]
            norm = chains[2][min(level, len(chains[2]) - 1)]
            if spec.shape[:2] != (h, w):
                spec = _nearest_resize(spec, h, w)
            if norm.shape[:2] != (h, w):
                norm = _nearest_resize(norm, h, w)
            out = np.empty((h, w, 8), np.float32)
            out[..., 0:3] = base[..., :3]
            out[..., 3:6] = spec[..., :3]
            out[..., 6:8] = norm[..., :2]
            packed.append(out)
        textures.append(packed)
    return textures


def build_atlas(textures, device) -> Atlas:
    """UNORM16 rows of every mip (lossless for the 8-bit block-compressed
    material data), normalized as the fetch does."""
    rows, offsets, widths, heights, counts = [], [], [], [], []
    levels = max(len(mips) for mips in textures)
    cursor = 0
    for mips in textures:
        off, ws, hs = [], [], []
        for m in mips:
            h, w = m.shape[:2]
            rows.append(m.reshape(h * w, -1))
            off.append(cursor)
            ws.append(w)
            hs.append(h)
            cursor += h * w
        while len(off) < levels:
            off.append(off[-1])
            ws.append(ws[-1])
            hs.append(hs[-1])
        offsets.append(off)
        widths.append(ws)
        heights.append(hs)
        counts.append(len(mips))
    unorm = np.round(np.clip(np.concatenate(rows), 0.0, 1.0) * 65535.0) \
        .astype(np.uint16)
    texels = unorm.astype(np.float32) * np.float32(1.0 / 65535.0)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return Atlas(t(texels, torch.float32), t(offsets), t(widths),
                 t(heights), t(counts))


# -- lights (scene/lights.py update_polygonal_light) -----------------------

def rotation_matrix_from_euler(angles) -> np.ndarray:
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    cxsy = cx * sy
    sxsy = sx * sy
    return np.array([
        [cy * cz, -cy * sz, -sy],
        [-sxsy * cz + cx * sz, sxsy * sz + cx * cz, -sx * cy],
        [cxsy * cz + sx * sz, -cxsy * sz + sx * cz, cx * cy]], np.float32)


def light_record(light: dict) -> dict:
    """(plane (4,), vertices (MAXL, 3), surface radiance (3,), vertex
    count) of one light from its numbers."""
    verts_plane = np.asarray(light["vertices_plane_space"], np.float32)
    count = verts_plane.shape[0]
    if light.get("texturing_technique", 0) != 0:
        raise NotImplementedError("the reference renders untextured lights")
    rotation = rotation_matrix_from_euler(
        np.asarray(light["rotation_angles"], np.float32))
    scalings = np.array([light["scaling_x"], light["scaling_y"]], np.float32)
    translation = np.asarray(light["translation"], np.float32)
    verts_world = (translation[None, :]
                   + verts_plane[:, 0:1] * (scalings[0] * rotation[:, 0])[None]
                   + verts_plane[:, 1:2] * (scalings[1] * rotation[:, 1])[None]
                   ).astype(np.float32)
    plane = np.empty(4, np.float32)
    plane[:3] = rotation[:, 2]
    plane[3] = -float(rotation[:, 2] @ translation)
    signed_area = np.float32(0.0)
    for i in range(count - 2):
        m00 = verts_plane[i + 2, 0] - verts_plane[0, 0]
        m01 = verts_plane[i + 1, 0] - verts_plane[0, 0]
        m10 = verts_plane[i + 2, 1] - verts_plane[0, 1]
        m11 = verts_plane[i + 1, 1] - verts_plane[0, 1]
        signed_area += np.float32(0.5) * (m00 * m11 - m01 * m10)
    signed_area *= np.float32(scalings[0] * scalings[1])
    radiance = np.asarray(light["radiant_flux"], np.float32) / \
        np.float32(abs(float(signed_area)) * M_PI)
    if signed_area <= 0.0:
        plane = -plane
    verts = np.concatenate(
        [verts_world, np.repeat(verts_world[:1], MAXL - count, 0)], axis=0)
    return dict(plane=plane, vertices=verts,
                radiance=radiance.astype(np.float32), count=count)


# -- camera (scene/camera.py) ----------------------------------------------

def pixel_to_ray(camera: dict, width: int, height: int) -> np.ndarray:
    """3x3 matrix from (pixel x, pixel y, 1) to a world ray direction:
    the vertical field of view is 70 degrees, x mirrored as the
    reference's projection has it (camera.c:59-71)."""
    cx, sx = np.cos(camera["rotation_x"]), np.sin(camera["rotation_x"])
    cz, sz = np.cos(camera["rotation_z"]), np.sin(camera["rotation_z"])
    rot_x = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]], np.float32)
    rot_z = np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]], np.float32)
    # world_to_view's rotation is (rot_z @ rot_x)^T; view_to_world its
    # transpose.
    view_to_world = (rot_z @ rot_x).astype(np.float64)
    top = np.tan(0.5 * np.radians(70.0))
    right = (width / height) * top
    vt0, vt1 = 2.0 / width, 2.0 / height
    vt2, vt3 = 0.5 * vt0 - 1.0, 0.5 * vt1 - 1.0
    pixel_to_dir_view = np.array([[-right * vt0, 0.0, -right * vt2],
                                  [0.0, top * vt1, top * vt3],
                                  [0.0, 0.0, -1.0]], np.float64)
    return (view_to_world @ pixel_to_dir_view).astype(np.float32)


# -- noise (assets/noise.py) -------------------------------------------------

def wang_hash(seed: np.ndarray) -> np.ndarray:
    seed = np.asarray(seed, np.uint32)
    with np.errstate(over="ignore"):
        seed = (seed ^ np.uint32(61)) ^ (seed >> np.uint32(16))
        seed = seed * np.uint32(9)
        seed = seed ^ (seed >> np.uint32(4))
        seed = seed * np.uint32(0x27D4EB2D)
        seed = seed ^ (seed >> np.uint32(15))
    return seed


def frame_random_numbers(noise_seed: int, animate: bool) -> np.ndarray:
    """The four uint32 numbers that scramble the noise of the frame whose
    seed is `noise_seed` (noise_table.c:160-167)."""
    i = np.arange(4, dtype=np.uint32)
    if not animate:
        return (i * np.uint32(0x123456)).astype(np.uint32)
    with np.errstate(over="ignore"):
        return wang_hash(np.uint32(noise_seed % 2**32) * np.uint32(4) + i)


# -- the scene ---------------------------------------------------------------

def build(vks_path: str, texture_dir: str, lights: list[dict],
          noise_type: str, data_dir: str, device) -> ReferenceScene:
    mesh = load_vks(vks_path)
    positions, normals, uvs = mesh_triangles(mesh)
    records = [light_record(light) for light in lights]
    ltc_table, _ = default_ltc_table(data_dir)
    noise = load_noise_table(noise_type, data_dir)
    table = np.asarray(noise.table)
    f, i, r = ltc_table.shape[:3]
    # ops/ltc.py make_ltc_constants(fresnel, roughness, inclination).
    ltc_constants = tuple(float(np.float32(v)) for v in (
        f - 1, 0.0, (r - 1) / r, 0.5 / r,
        (i - 1) / (0.5 * M_PI * i), 0.5 / i))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return ReferenceScene(
        positions=t(positions), normals=t(normals), uvs=t(uvs),
        material=t(mesh.material_indices.astype(np.int64), torch.int64),
        v0=t(positions[:, 0]), e1=t(positions[:, 1] - positions[:, 0]),
        e2=t(positions[:, 2] - positions[:, 0]),
        atlas=build_atlas(material_textures(texture_dir,
                                            mesh.material_names), device),
        light_count=len(records),
        light_vertex_counts=tuple(rec["count"] for rec in records),
        light_plane=t(np.stack([rec["plane"] for rec in records])),
        light_vertices=t(np.stack([rec["vertices"] for rec in records])),
        light_radiance=t(np.stack([rec["radiance"] for rec in records])),
        ltc_table=t(ltc_table),
        ltc_constants=ltc_constants,
        noise=t(table.astype(np.int64), torch.int64),
        noise_resolution_mask=(table.shape[2] - 1, table.shape[1] - 1),
        noise_texture_index_mask=table.shape[0] - 1)
