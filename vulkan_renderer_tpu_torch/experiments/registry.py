"""Scene registry (reference: g_scene_paths, main.c:34-44).

Counterpart of vulkan_renderer_tpu/experiments/registry.py. Paths follow
the reference's data layout (data/<scene>.vks, data/<scene>_textures,
data/quicksaves/<scene>.save). The published scene files are separate
downloads; when a .vks is missing, resolve_scene materializes a procedural
stand-in with the port's own writers, marks it with a `<vks>.standin`
sentinel, and reports stand_in so every output is tagged.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import warnings


@dataclasses.dataclass(frozen=True)
class SceneEntry:
    name: str
    vks_path: str
    texture_dir: str
    quicksave_path: str
    procedural: str | None = None  # stand-in generator name
    # True on resolved entries whose real asset was missing: outputs must
    # carry the `standin` tag.
    stand_in: bool = False


SCENES = {
    "cornell_box": SceneEntry(
        "Cornell box", "data/cornell_box.vks", "data/cornell_box_textures",
        "data/quicksaves/cornell_box.save", procedural="cornell_box"),
    "mis_plane": SceneEntry(
        "MIS plane", "data/mis_plane.vks", "data/mis_plane_textures",
        "data/quicksaves/mis_plane.save", procedural="roughness_planes"),
    "roughness_planes": SceneEntry(
        "Roughness planes", "data/roughness_planes.vks",
        "data/roughness_planes_textures",
        "data/quicksaves/roughness_planes.save",
        procedural="roughness_planes"),
    "shadowed_plane": SceneEntry(
        "Shadowed plane", "data/shadowed_plane.vks",
        "data/shadowed_plane_textures",
        "data/quicksaves/shadowed_plane.save", procedural="roughness_planes"),
    "arcade": SceneEntry(
        "Arcade", "data/Arcade.vks", "data/Arcade_textures",
        "data/quicksaves/Arcade.save", procedural="cornell_box"),
    "living_room": SceneEntry(
        "Living room", "data/living_room.vks", "data/living_room_textures",
        "data/quicksaves/living_room.save", procedural="cornell_box"),
    "attic": SceneEntry(
        "Attic", "data/attic.vks", "data/attic_textures",
        "data/quicksaves/attic.save", procedural="cornell_box"),
    "bistro_inside": SceneEntry(
        "Bistro inside", "data/Bistro_inside.vks", "data/Bistro_textures",
        "data/quicksaves/Bistro_inside.save", procedural="city"),
    "bistro_outside": SceneEntry(
        "Bistro outside", "data/Bistro_outside.vks", "data/Bistro_textures",
        "data/quicksaves/Bistro_outside.save", procedural="city"),
}


def resolve_scene(key: str, data_directory: str = "data") -> SceneEntry:
    """The entry with paths under data_directory, materializing the
    procedural stand-in if the real .vks is absent."""
    entry = SCENES[key]
    vks = os.path.join(data_directory, os.path.basename(entry.vks_path))
    # A stand-in materialized earlier keeps reporting stand_in: the file on
    # disk does not make it the real content.
    sentinel = vks + ".standin"
    stand_in = os.path.exists(vks) and os.path.exists(sentinel)
    if not os.path.exists(vks) and entry.procedural:
        warnings.warn(
            f"scene asset '{vks}' is missing: materializing the procedural "
            f"stand-in '{entry.procedural}' instead of the real {entry.name} "
            "content. Outputs will be tagged 'standin'.", stacklevel=2)
        stand_in = True
        from ..tools.city import write_city_scene
        from ..tools.export_scene import write_test_scene
        os.makedirs(data_directory, exist_ok=True)
        stem = os.path.splitext(os.path.basename(entry.vks_path))[0]
        if entry.procedural == "city":
            write_city_scene(data_directory, stem)
        else:
            write_test_scene(data_directory, entry.procedural)
            # Copy to the registry's stem when the generator's differs.
            src = os.path.join(data_directory, f"{entry.procedural}.vks")
            if src != vks and os.path.exists(src):
                # The generator's own file is a stand-in too (for the
                # scene of that name, resolved later).
                with open(src + ".standin", "w") as f:
                    f.write(f"procedural stand-in '{entry.procedural}'\n")
                shutil.copyfile(src, vks)
                tex_src = os.path.join(data_directory,
                                       f"{entry.procedural}_textures")
                tex_dst = os.path.join(data_directory,
                                       os.path.basename(entry.texture_dir))
                if not os.path.exists(tex_dst):
                    shutil.copytree(tex_src, tex_dst)
        with open(sentinel, "w") as f:
            f.write(f"procedural stand-in '{entry.procedural}', not the "
                    f"real {entry.name} content\n")
    return SceneEntry(
        name=entry.name,
        vks_path=vks,
        texture_dir=os.path.join(data_directory,
                                 os.path.basename(entry.texture_dir)),
        quicksave_path=os.path.join(data_directory, "quicksaves",
                                    os.path.basename(entry.quicksave_path)),
        procedural=entry.procedural,
        stand_in=stand_in)
