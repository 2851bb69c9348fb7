"""Scene assembly: .vks/.vkt files or numpy arrays -> tensors on one device.

Counterpart of vulkan_renderer_tpu/scene/scene.py::build_scene/load_scene
(reference scene.c:409-559) for what the frame uses: the cluster tables,
the u16 material atlas, the polygonal lights and their float32 texture
atlas, the linear lights, the LTC table and the noise table. The JAX Scene's shading_rows and BVH have no use here and are not
built. scene_from_numpy carries a JAX Scene's arrays over unchanged, so
tests can feed both packages identical data.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import numpy as np
import torch

from ..assets import vkt
from ..assets.ltc_table import default_ltc_table
from ..assets.noise import NoiseTable, noise_table_for_settings
from ..assets.vks import SceneMesh, load_vks
from ..core.device import get_device
from ..ops.ltc import LtcTable
from ..ops.math_utils import (decode_normal_octahedral_32bit_np,
                              decode_position_64bit_np)
from ..render.clusters import Clusters, build_clusters_np, \
    clusters_from_numpy
from ..render.texture import TextureAtlas, atlas_from_numpy, \
    build_texture_atlas_np
from .lights import PolygonalLightSpec, update_polygonal_light
from .linear_lights import (LinearLights, LinearLightSpec,
                            linear_lights_from_numpy, stack_linear_lights)

MATERIAL_TEXTURE_SUFFIXES = ("BaseColor", "Specular", "Normal")

# PolygonalLight fields the frame reads (scene/lights.py).
LIGHT_FIELDS = ("plane", "vertices_world_space", "vertex_count",
                "surface_radiance", "rotation", "translation", "scaling_x",
                "scaling_y", "inv_scaling_x", "inv_scaling_y", "area",
                "fan_areas", "texturing_technique", "texture_index")
_INT_LIGHT_FIELDS = ("vertex_count", "texturing_technique", "texture_index")


@dataclasses.dataclass
class Lights:
    """Polygonal light records with a leading light axis, on the device.
    vertices_world_space repeats the first vertex past vertex_count."""
    plane: torch.Tensor                 # (L, 4)
    vertices_world_space: torch.Tensor  # (L, MAXL, 3)
    vertex_count: torch.Tensor          # (L,) int64
    surface_radiance: torch.Tensor      # (L, 3)
    rotation: torch.Tensor              # (L, 3, 3) plane -> world
    translation: torch.Tensor           # (L, 3)
    scaling_x: torch.Tensor             # (L,)
    scaling_y: torch.Tensor             # (L,)
    inv_scaling_x: torch.Tensor         # (L,)
    inv_scaling_y: torch.Tensor         # (L,)
    area: torch.Tensor                  # (L,)
    fan_areas: torch.Tensor             # (L, MAXL-2, 2)
    texturing_technique: torch.Tensor   # (L,) int64 PolygonTexturing
    texture_index: torch.Tensor         # (L,) int64 into the light atlas

    @property
    def count(self) -> int:
        return self.plane.shape[0]


@dataclasses.dataclass
class Scene:
    triangle_positions: torch.Tensor   # (T, 3, 3) float32
    material_atlas: TextureAtlas        # 8 channels, UNORM16
    lights: Lights
    light_atlas: TextureAtlas           # 4 channels, float32
    linear_lights: LinearLights
    ltc: LtcTable
    clusters: Clusters
    noise_table: torch.Tensor          # (layers, H, W, 4) int32 UNORM16
    noise_texture_index_mask: int

    @property
    def device(self) -> torch.device:
        return self.triangle_positions.device


def _lights_from_numpy(fields: Mapping[str, np.ndarray], device) -> Lights:
    def t(name):
        a = np.asarray(fields[name])
        dtype = np.int64 if name in _INT_LIGHT_FIELDS else np.float32
        return torch.from_numpy(np.array(a, dtype)).to(device)
    return Lights(**{name: t(name) for name in LIGHT_FIELDS})


def lights_from_specs(specs: list[PolygonalLightSpec], device) -> Lights:
    """Derive and stack light records (polygonal_light.c:46-107). Every
    texturing technique (scene/lights.py PolygonTexturing) is taken; a
    textured light's texture_index names its texture in the scene's
    light atlas (decode_light_textures)."""
    for spec in specs:
        if spec.texturing_technique not in (0, 1, 2, 3):
            raise ValueError(f"texturing technique "
                             f"{spec.texturing_technique} is none of 0-3")
    # No polygonal lights (a linear-light scene): empty records of the
    # right shapes, stacked from a default light.
    records = [update_polygonal_light(spec)
               for spec in specs or [PolygonalLightSpec()]]
    return _lights_from_numpy(
        {name: np.stack([np.asarray(getattr(r, name))
                         for r in records])[:len(specs)]
         for name in LIGHT_FIELDS}, device)


def _nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def decode_material_textures(texture_dir: str, material_names: list[str]
                             ) -> list[list[np.ndarray]]:
    """<mat>_{BaseColor,Specular,Normal}.vkt mips packed into one 8-channel
    texture per material: [base.rgb | occlusion, roughness, metalicity |
    normal.xy] (scene.c:523-543). Missing files take neutral constants."""
    fallbacks = {
        "BaseColor": np.full((4, 4, 3), 0.8, np.float32),
        "Specular": np.tile(np.array([1.0, 0.5, 0.0], np.float32),
                            (4, 4, 1)),
        "Normal": np.tile(np.array([0.5, 0.5], np.float32), (4, 4, 1)),
    }
    textures = []
    for name in material_names:
        mips_by_kind = []
        for suffix in MATERIAL_TEXTURE_SUFFIXES:
            path = os.path.join(texture_dir, f"{name}_{suffix}.vkt")
            if os.path.exists(path):
                mips_by_kind.append(vkt.load_vkt(path).decode_to_float())
            else:
                mips_by_kind.append([fallbacks[suffix]])
        packed = []
        for level, base in enumerate(mips_by_kind[0]):
            h, w = base.shape[:2]
            spec = mips_by_kind[1][min(level, len(mips_by_kind[1]) - 1)]
            norm = mips_by_kind[2][min(level, len(mips_by_kind[2]) - 1)]
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


def decode_light_textures(paths: list[str]
                          ) -> tuple[list[list[np.ndarray]], dict[str, int]]:
    """The light atlas's textures and {path: texture index}: index 0 is
    white, each distinct existing path is decoded once, and a missing or
    empty path gives white (main.c:371-391)."""
    unique: dict[str, int] = {}
    textures: list[list[np.ndarray]] = [[np.ones((4, 4, 4), np.float32)]]
    for p in paths:
        if not p or p in unique:
            continue
        if os.path.exists(p):
            unique[p] = len(textures)
            textures.append(vkt.load_vkt(p).decode_to_float())
        else:
            unique[p] = 0
    return textures, unique


def mesh_triangles(mesh: SceneMesh):
    """Dequantized (T, 3, 3) positions, (T, 3, 3) normals, (T, 3, 2) uvs."""
    positions = decode_position_64bit_np(
        mesh.quantized_positions, mesh.dequantization_factor,
        mesh.dequantization_summand).reshape(-1, 3, 3)
    normals = decode_normal_octahedral_32bit_np(
        mesh.normals_and_tex_coords[:, :2]).reshape(-1, 3, 3)
    # The shader applies fma(uv, (8, -8), (0, 1)) (glsl:734).
    unorm = mesh.normals_and_tex_coords[:, 2:].astype(np.float32) / 65535.0
    uvs = (unorm * np.array([8.0, -8.0], np.float32)
           + np.array([0.0, 1.0], np.float32)).reshape(-1, 3, 2)
    return positions, normals, uvs


def build_scene(mesh: SceneMesh, texture_dir: str,
                light_specs: list[PolygonalLightSpec], device,
                noise: NoiseTable | None = None,
                data_directory: str = "data",
                cluster_size: int = 64,
                noise_type: str = "ahmed_2d",
                linear_light_specs: list[LinearLightSpec] | None = None,
                ltc=None) -> Scene:
    """Scene on `device` from a parsed mesh, its textures, light specs and
    linear light specs. The noise table is `noise` if given, else the
    table of `noise_type` (RenderSettings.noise_type; a name that is no
    noise type takes white noise, as the JAX package's Application
    does). The LTC table is `ltc`, a (table, constants) pair, if given,
    else default_ltc_table(data_directory). Each light's texture_index is
    set from its texture_file_path."""
    device = get_device(device)
    positions, normals, uvs = mesh_triangles(mesh)
    atlas = build_texture_atlas_np(
        decode_material_textures(texture_dir, mesh.material_names))
    clusters = build_clusters_np(positions, normals, uvs,
                                 mesh.material_indices, cluster_size)
    if noise is None:
        noise = noise_table_for_settings(noise_type, data_directory)
    ltc_table, ltc_constants = ltc if ltc is not None \
        else default_ltc_table(data_directory)
    light_textures, path_to_index = decode_light_textures(
        [spec.texture_file_path for spec in light_specs])
    light_specs = [dataclasses.replace(
        spec, texture_index=path_to_index.get(spec.texture_file_path, 0))
        for spec in light_specs]
    return Scene(
        triangle_positions=torch.from_numpy(positions).to(device),
        material_atlas=atlas_from_numpy(atlas, device),
        lights=lights_from_specs(light_specs, device),
        light_atlas=atlas_from_numpy(build_texture_atlas_np(
            light_textures, channels=4, unorm16=False), device),
        linear_lights=stack_linear_lights(linear_light_specs or [], device),
        ltc=LtcTable(torch.as_tensor(ltc_table).to(device),
                     torch.as_tensor(ltc_constants).to(device)),
        clusters=clusters_from_numpy(clusters, device),
        noise_table=torch.from_numpy(noise.table.astype(np.int32)).to(device),
        noise_texture_index_mask=noise.texture_index_mask,
    )


def load_scene(vks_path: str, texture_dir: str,
               light_specs: list[PolygonalLightSpec], device,
               **kwargs) -> Scene:
    return build_scene(load_vks(vks_path), texture_dir, light_specs, device,
                       **kwargs)


_LTC_CONSTANT_NAMES = ("fresnel_index_factor", "fresnel_index_summand",
                       "roughness_factor", "roughness_summand",
                       "inclination_factor", "inclination_summand")


def tree_leaves(tree, prefix: str = "") -> dict:
    """Flatten a NamedTuple tree of arrays (such as the JAX package's
    Scene) into {dotted field path: numpy array}; None leaves are
    skipped."""
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(tree_leaves(getattr(tree, name),
                                   f"{prefix}{name}."))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree)}


def scene_from_numpy(leaves: Mapping[str, np.ndarray], device) -> Scene:
    """The port's Scene from a JAX Scene's arrays, keyed by their dotted
    field paths ("triangle_positions", "material_atlas.texels",
    "lights.plane", "ltc.table", "ltc.constants.roughness_factor",
    "clusters.planes", "noise_table", "noise_texture_index_mask",
    "light_atlas.texels", "linear_lights.start", ...). The arrays are
    carried over as they are."""
    device = get_device(device)

    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in leaves.items()
                if k.startswith(prefix + ".")}

    ltc_constants = np.array([np.asarray(leaves[f"ltc.constants.{n}"])
                              for n in _LTC_CONSTANT_NAMES], np.float32)
    return Scene(
        triangle_positions=torch.from_numpy(np.array(
            leaves["triangle_positions"], np.float32)).to(device),
        material_atlas=atlas_from_numpy(sub("material_atlas"), device),
        lights=_lights_from_numpy(sub("lights"), device),
        light_atlas=atlas_from_numpy(sub("light_atlas"), device),
        linear_lights=linear_lights_from_numpy(
            leaves["linear_lights.start"], leaves["linear_lights.end"],
            leaves["linear_lights.linear_radiance"], device),
        ltc=LtcTable(torch.from_numpy(np.array(
            leaves["ltc.table"], np.float32)).to(device),
            torch.from_numpy(ltc_constants).to(device)),
        clusters=clusters_from_numpy(sub("clusters"), device),
        noise_table=torch.from_numpy(np.asarray(leaves["noise_table"])
                                     .astype(np.int32)).to(device),
        noise_texture_index_mask=int(leaves["noise_texture_index_mask"]),
    )
