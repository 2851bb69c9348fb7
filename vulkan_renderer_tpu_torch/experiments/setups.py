"""Per-experiment scene setups: the quicksave-equivalent wiring.

Counterpart of vulkan_renderer_tpu/experiments/setups.py. The reference
encodes each experiment's camera and lights in a quicksave file
(experiment_list.c passes quick_save_path; main.c:1965-1976 loads it).
Those .save files ship with the reference's data download:

- if the experiment's quicksave file exists it is loaded verbatim
  (assets/quicksave.py reads the reference format);
- otherwise the layout is rebuilt from the experiment's `light_layout`
  descriptor (the timing sweep's regular n-gons in the paper's central and
  decentral placements; a plausible light for the figure groups, an
  IES-profile downlight, a linear light under the attic ridge), and the
  harness tags the output `standin`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.app import Application, ApplicationUpdates, SceneSpecification
from ..scene.camera import FirstPersonCamera
from ..assets import vkt
from ..scene.lights import PolygonalLightSpec, PolygonTexturing
from ..scene.linear_lights import LinearLightSpec
from .registry import resolve_scene


def _regular_polygon(vertex_count: int) -> np.ndarray:
    """Plane-space vertices of a regular n-gon inscribed in the unit
    circle (the paper's timing experiments use regular polygons)."""
    a = 2.0 * np.pi * (np.arange(vertex_count) + 0.5) / vertex_count
    return np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)


def timing_lights(vertex_count: int, central: bool,
                  light_count: int) -> list[PolygonalLightSpec]:
    """The roughness-planes timing layouts (experiment_list.c:364-409,
    quicksaves roughness_planes_{central,decentral}_{3..7}[_128].save):
    central lights face the plane from straight above the lit region,
    decentral ones sit far to the side at a grazing offset; 128-light
    layouts tile a grid."""
    specs = []
    grid = int(np.ceil(np.sqrt(light_count)))
    verts = _regular_polygon(vertex_count)
    for i in range(light_count):
        gx, gy = i % grid, i // grid
        span = 8.0
        x = -span / 2 + (gx + 0.5) * span / grid
        y = -span / 2 + (gy + 0.5) * span / grid
        if central:
            translation = np.array([x, y, 4.0], np.float32)
        else:
            translation = np.array([x + 9.0, y, 1.2], np.float32)
        specs.append(PolygonalLightSpec(
            translation=translation,
            rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
            scaling_x=2.5 / grid, scaling_y=2.5 / grid,
            radiant_flux=np.array([25.0, 24.0, 22.0], np.float32)
            / light_count,
            vertices_plane_space=verts))
    return specs


def _scene_default_lights(scene_key: str) -> list[PolygonalLightSpec]:
    """A plausible light per scene family for figure groups whose
    quicksave is absent."""
    if scene_key in ("cornell_box", "arcade", "living_room", "attic"):
        return [PolygonalLightSpec(
            translation=np.array([1.0, 1.0, 1.99], np.float32),
            rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
            scaling_x=0.4, scaling_y=0.4,
            radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))]
    if scene_key in ("bistro_inside", "bistro_outside"):
        return [PolygonalLightSpec(
            translation=np.array([0.0, 0.0, 9.0], np.float32),
            rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
            scaling_x=1.0, scaling_y=1.0,
            radiant_flux=np.array([500.0, 470.0, 420.0], np.float32))]
    return [PolygonalLightSpec(
        translation=np.array([0.0, 0.0, 3.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.0, scaling_y=1.0,
        radiant_flux=np.array([30.0, 28.0, 25.0], np.float32))]


def _scene_default_camera(scene_key: str) -> FirstPersonCamera:
    if scene_key in ("cornell_box", "arcade", "living_room", "attic"):
        return FirstPersonCamera(
            position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
            rotation_x=np.pi / 2, rotation_z=np.pi)
    if scene_key in ("bistro_inside", "bistro_outside"):
        return FirstPersonCamera(
            position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
            rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    # Plane scenes: look down at the plane from the -y side at a shallow
    # angle (rotation_z = pi faces +y, rotation_x < pi/2 pitches down).
    return FirstPersonCamera(
        position_world_space=np.array([0.0, -7.0, 2.5], np.float32),
        rotation_x=0.38 * np.pi, rotation_z=np.pi)


def _ies_profile_texture(data_directory: str) -> str:
    """An IES-like luminous intensity profile (a downlight with a hot core
    and a soft cutoff) as a BC1 .vkt, written once into data_directory:
    the stand-in for the reference's attic_ies_profile.save profile
    texture (polygon_texturing_ies_profile, polygonal_light_utility.glsl).
    The same file as the JAX package's setups._ies_profile_texture."""
    path = os.path.join(data_directory, "ies_profile_standin.vkt")
    if os.path.exists(path):
        return path
    r = 64
    theta = (np.arange(r) + 0.5) / r * np.pi  # polar angle rows
    profile = np.clip(np.cos(theta) ** 3, 0.0, 1.0) \
        + 0.35 * np.exp(-((theta - 0.5) / 0.25) ** 2)
    img = np.tile(profile[:, None, None].astype(np.float32), (1, r, 3))
    os.makedirs(data_directory or ".", exist_ok=True)
    vkt.save_vkt(path, vkt.encode_texture(
        img, vkt.VK_FORMAT_BC1_RGB_UNORM_BLOCK))
    return path


def experiment_lights(experiment, data_directory: str = "data"
                      ) -> list[PolygonalLightSpec]:
    """Lights for an experiment whose quicksave is missing, from its
    light_layout descriptor."""
    layout = getattr(experiment, "light_layout", None) or "default"
    if layout == "linear":
        return []  # a pure linear-light figure (HPG branch)
    if layout.startswith("timing:"):
        _, vc, case, lc = layout.split(":")
        return timing_lights(int(vc), case == "central", int(lc))
    if layout in ("small_light", "tiny_light"):
        scale = 0.35 if layout == "small_light" else 0.08
        return [PolygonalLightSpec(
            translation=np.array([4.0, 2.0, 14.0], np.float32),
            rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
            scaling_x=scale, scaling_y=scale,
            radiant_flux=np.array([4000.0, 3800.0, 3400.0], np.float32)
            * scale * scale)]
    if layout == "ies_profile":
        light = _scene_default_lights(experiment.scene)[0]
        return [dataclasses.replace(
            light, texturing_technique=PolygonTexturing.IES_PROFILE,
            texture_file_path=_ies_profile_texture(data_directory))]
    if layout == "heptagon":
        base = _scene_default_lights(experiment.scene)[0]
        return [dataclasses.replace(
            base, vertices_plane_space=_regular_polygon(7))]
    return _scene_default_lights(experiment.scene)


def experiment_linear_lights(experiment) -> list[LinearLightSpec]:
    """Linear lights of the HPG-branch figure group (layout "linear"): a
    bright tube under the attic ridge, the workload shape of the branch's
    line_sampling.glsl."""
    if (getattr(experiment, "light_layout", None) or "") != "linear":
        return []
    return [LinearLightSpec(
        start=np.array([0.2, 1.0, 1.9], np.float32),
        end=np.array([1.8, 1.0, 1.9], np.float32),
        radiant_flux=np.array([40.0, 36.0, 30.0], np.float32))]


def build_default_application(experiment, data_directory: str = "data",
                              frames_in_flight: int = 3,
                              device: str = "cuda") -> Application:
    """The default Application factory of run_experiments: resolves the
    scene (materializing tagged stand-ins when assets are missing), loads
    the experiment's quicksave when present, rebuilds the layout
    otherwise."""
    lights = experiment_lights(experiment, data_directory)
    entry = resolve_scene(experiment.scene, data_directory)
    spec = SceneSpecification(
        name=experiment.scene, vks_path=entry.vks_path,
        texture_dir=entry.texture_dir,
        quicksave_path=experiment.quicksave_path or "",
        camera=_scene_default_camera(experiment.scene), lights=lights,
        linear_lights=experiment_linear_lights(experiment))
    app = Application(spec, settings=experiment.settings,
                      width=experiment.width, height=experiment.height,
                      frames_in_flight=frames_in_flight,
                      data_directory=data_directory, device=device)
    if experiment.quicksave_path and os.path.exists(experiment.quicksave_path):
        app.update(ApplicationUpdates(quick_load=True))
        app.layout_stand_in = False
    else:
        app.layout_stand_in = experiment.quicksave_path is not None
    app.scene_stand_in = entry.stand_in
    return app
