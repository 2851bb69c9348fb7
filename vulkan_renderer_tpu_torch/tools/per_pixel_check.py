"""The per-pixel shading path's check classes, on any device.

One configuration of each kind that only the per-pixel path renders
(render/pipeline.py, SceneStatic.fused "off" or a configuration
render/fused.py fused_supported rejects): DIFFUSE_SPECULAR_SEPARATELY,
DIFFUSE_SPECULAR_RANDOM, DIFFUSE_GGX_MIS, an error display, an IES-profile
light, a textured area light and a linear light, on the cornell-box
stand-in at 64x32. chip_smoke.py and tests/test_torch_gpu.py render each
class on the card and on the CPU and hold the two frames together with
frames_agree (error displays: error_bins_agree).

The tolerance is the frame tolerance of the CPU parity tests: mean |sRGB
difference| <= 1e-3 and >= 99% of pixels within 1e-2. An error display's
color is the log10 bin of a float32 rounding residual, which the card's
transcendental and rsqrt instructions change like another formulation
does: its frames agree when the unlit pattern matches for >= 99.5% of
pixels, >= 98% of lit pixels are within 4 bins (one decade), the mean
|bin difference| over lit pixels is at most 0.75, and of the lit pixels
above the clamp floor (the reference's bin above the lowest) at most
MAX_ONE_WAY_SHARE moved the same way (the larger of the shares that
moved up and that moved down). A bin is a quarter decade; most pixels
sit in the lowest bin, where the residual is clamped, so an estimate off
by a factor of 2 moves only the others, each by about 1.2 bins, all one
way: at 64x32 the doubled estimate (error_to_color's factor x2) keeps
the mean |bin difference| at 0.577 and moves 675 of 675 pixels above the
floor up, a one-way share of 1.0, where the card against the CPU moves
them both ways: 0.504 (chip_smoke.py phase 11 on an NVIDIA H100 80GB
HBM3, 700 W), and the port against the JAX package's per-pixel path at
most 0.492 (the CPU tests of the error displays). MAX_ONE_WAY_SHARE =
0.75 lies between. The estimates themselves are held by value against
the JAX package on the CPU (tests/test_torch_sampling_ops.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..assets import vkt
from ..assets.noise import white_noise_table
from ..core.settings import (ErrorDisplay, MisHeuristic,
                             PolygonSamplingTechnique, RenderSettings,
                             SamplingStrategy)
from ..experiments.setups import _ies_profile_texture
from ..render.pipeline import render_frame
from ..render.shading import _TAB20B, SceneStatic
from ..scene.camera import FirstPersonCamera
from ..scene.lights import PolygonalLightSpec, PolygonTexturing
from ..scene.linear_lights import LinearLightSpec
from ..scene.scene import load_scene
from .export_scene import write_test_scene

WIDTH, HEIGHT = 64, 32
MAX_ONE_WAY_SHARE = 0.75
Strategy = SamplingStrategy
Tech = PolygonSamplingTechnique

# class -> (scene, camera, RenderSettings fields).
CLASSES = {
    "separately": ("plain", "level", dict(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_SEPARATELY,
        trace_shadow_rays=True)),
    "random": ("plain", "level", dict(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_RANDOM)),
    "ggx_mis": ("plain", "level", dict(
        sampling_strategy=Strategy.DIFFUSE_GGX_MIS,
        polygon_sampling_technique=Tech.SOLID_ANGLE,
        mis_heuristic=MisHeuristic.BALANCE, trace_shadow_rays=True)),
    "error_display": ("plain", "level", dict(
        sampling_strategy=Strategy.DIFFUSE_ONLY,
        error_display=ErrorDisplay.DIFFUSE_BACKWARD,
        output_linear_rgb=True)),
    "ies": ("ies", "up", dict(trace_shadow_rays=True)),
    "textured_area": ("area", "up", dict(
        sampling_strategy=Strategy.DIFFUSE_ONLY)),
    "linear": ("linear", "level", dict(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_MIS)),
}
CAMERAS = {
    "level": FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=np.pi / 2, rotation_z=np.pi),
    # Looking up at the ceiling light: the light display shows its
    # textured radiance.
    "up": FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=0.7 * np.pi, rotation_z=np.pi),
}


def _ceiling_light(**fields) -> PolygonalLightSpec:
    return PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32), **fields)


def write_scene_files(directory: str) -> dict:
    """Write the cornell box, an IES profile and a float16 area texture
    into directory; returns {scene: (vks, texture dir, light specs,
    linear light specs)}."""
    vks = write_test_scene(directory, "cornell_box", texture_resolution=16)
    textures = os.path.join(directory, "cornell_box_textures")
    area = os.path.join(directory, "area_light.vkt")
    if not os.path.exists(area):
        image = np.random.default_rng(17).uniform(0.2, 2.0, (16, 16, 4))
        vkt.save_vkt(area, vkt.Texture2d(
            format=vkt.VK_FORMAT_R16G16B16A16_SFLOAT,
            mips=[image.astype(np.float16).reshape(-1).view(np.uint8)
                  .copy()], width=16, height=16))
    tube = LinearLightSpec(
        start=np.array([0.2, 1.0, 1.9], np.float32),
        end=np.array([1.8, 1.0, 1.9], np.float32),
        radiant_flux=np.array([40.0, 36.0, 30.0], np.float32))
    return {
        "plain": (vks, textures, [_ceiling_light()], []),
        "ies": (vks, textures, [_ceiling_light(
            texturing_technique=PolygonTexturing.IES_PROFILE,
            texture_file_path=_ies_profile_texture(directory))], []),
        "area": (vks, textures, [_ceiling_light(
            texturing_technique=PolygonTexturing.AREA,
            texture_file_path=area)], []),
        "linear": (vks, textures, [], [tube]),
    }


def load_scenes(files: dict, device) -> dict:
    """The scenes of write_scene_files on `device`."""
    return {name: load_scene(vks, textures, lights, device,
                             noise=white_noise_table(32, 32, 8),
                             linear_light_specs=linear)
            for name, (vks, textures, lights, linear) in files.items()}


def render_class(scenes: dict, name: str) -> torch.Tensor:
    """Class `name`'s frame on the per-pixel path, on its scene's
    device: (HEIGHT, WIDTH, 3)."""
    scene_name, camera, fields = CLASSES[name]
    scene = scenes[scene_name]
    return render_frame(scene, SceneStatic.for_scene(scene, fused="off"),
                        CAMERAS[camera], RenderSettings(**fields), WIDTH,
                        HEIGHT)


def frames_agree(got, want) -> tuple[bool, dict]:
    """The frame tolerance: (ok, {mean_abs, within_1e-2})."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    stats = {"mean_abs": float(diff.mean()),
             "within_1e-2": float((diff.max(axis=-1) <= 1e-2).mean()),
             "finite": bool(np.isfinite(got).all())}
    return (stats["finite"] and stats["mean_abs"] <= 1e-3
            and stats["within_1e-2"] >= 0.99), stats


def error_bins(colors) -> np.ndarray:
    """(..., 3) linear error-display colors -> tab20b bin, -1 for black."""
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    d = np.abs(colors[:, None, :] - _TAB20B[None]).max(axis=-1)
    return np.where(np.abs(colors).max(axis=-1) == 0.0, -1,
                    d.argmin(axis=-1))


def error_bins_agree(got, want) -> tuple[bool, dict]:
    """The error display's tolerance (module docstring)."""
    a, b = error_bins(want), error_bins(got)
    lit = (a >= 0) & (b >= 0)
    diff = np.abs(a[lit] - b[lit])
    above = lit & (a > 0)
    shift = b[above] - a[above]
    stats = {"unlit_pattern": float(((a < 0) == (b < 0)).mean()),
             "lit_share": float(lit.mean()),
             "within_4_bins": float((diff <= 4).mean()) if lit.any() else 0.0,
             "mean_abs_bin_diff": float(diff.mean()) if lit.any() else 0.0,
             "above_floor": int(above.sum()),
             "one_way_share": float(max((shift > 0).mean(),
                                        (shift < 0).mean()))
             if above.any() else 0.0}
    return (stats["unlit_pattern"] >= 0.995 and stats["lit_share"] > 0.3
            and stats["within_4_bins"] >= 0.98
            and stats["mean_abs_bin_diff"] <= 0.75
            and stats["one_way_share"] <= MAX_ONE_WAY_SHARE), stats


def compare_class(name: str, got, want) -> tuple[bool, dict]:
    if CLASSES[name][2].get("error_display") is not None:
        return error_bins_agree(got, want)
    return frames_agree(got, want)

