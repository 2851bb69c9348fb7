"""The procedural city (frozen/tools/city.py::write_city_scene): buildings
on a street grid, their checkerboard material textures. Scene keys:
n_buildings, detail, seed, n_materials, texture_resolution."""

import os

import numpy as np


def write(scene: dict, vks_path: str, texture_dir: str) -> None:
    from frozen.assets.vks import save_vks
    from frozen.tools import city, export_scene
    tris, norms, uvs, mats, names = city.make_city(
        scene["n_buildings"], seed=scene["seed"],
        n_materials=scene["n_materials"], detail=scene["detail"])
    save_vks(vks_path, export_scene.build_scene_mesh(tris, norms, uvs, mats,
                                                     names))
    os.makedirs(texture_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    for i, name in enumerate(names):
        tint = 0.4 + 0.5 * rng.uniform(0, 1, 3)
        base = export_scene.checkerboard_texture(
            scene["texture_resolution"], 4 + i, tuple(tint),
            tuple(tint * 0.8))
        export_scene.write_material_textures(
            texture_dir, name, base,
            np.array([1.0, 0.25 + 0.1 * i, 0.05 * i], np.float32))
