"""The roughness-planes stand-in (frozen/tools/export_scene.py::
write_test_scene("roughness_planes")): planes of rising roughness, one
checkerboard texture each. Scene keys: material_count, base_color,
texture_resolution."""

import os

import numpy as np


def write(scene: dict, vks_path: str, texture_dir: str) -> None:
    from frozen.assets.vks import save_vks
    from frozen.tools.export_scene import (build_scene_mesh,
                                           checkerboard_texture,
                                           make_plane_scene,
                                           write_material_textures)
    tris, norms, uvs, mats, names = make_plane_scene(
        material_count=scene["material_count"])
    save_vks(vks_path, build_scene_mesh(tris, norms, uvs, mats, names))
    os.makedirs(texture_dir, exist_ok=True)
    color = tuple(scene["base_color"])
    for i, name in enumerate(names):
        base = checkerboard_texture(scene["texture_resolution"], 8, color,
                                    tuple(0.85 * c for c in color))
        write_material_textures(
            texture_dir, name, base,
            np.array([1.0, 0.3 + 0.1 * i, 0.0], np.float32))
