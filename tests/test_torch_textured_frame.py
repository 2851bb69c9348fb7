"""Textured, IES-profile and linear lights through the whole per-pixel
frame: the port's render_frame (fused "off") against the JAX package's
(fused "off", traversal "bruteforce") on the cornell box at 64x32, the
light textures decoded from .vkt files by each package's own loader; and
the light-texture formats themselves (half and single float, 3 and 4
channels, BC1 sRGB) decoded by both packages.

Tolerance: mean |sRGB difference| <= 1e-3 and >= 99% of pixels within
1e-2 (test_torch_per_pixel_frame.py). Decoded texels: float formats bit
for bit, BC1 sRGB within 1e-6 (the sRGB curve in numpy vs XLA)."""

import numpy as np
import pytest

from test_torch_per_pixel_frame import (CAMERA, assert_frames_agree,
                                        compare_frames)
from vulkan_renderer_tpu.assets import vkt as j_vkt
from vulkan_renderer_tpu.assets.noise import NoiseType
from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.linear_lights import LinearLightSpec
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene
from vulkan_renderer_tpu.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.assets import vkt
from vulkan_renderer_tpu_torch.experiments.setups import _ies_profile_texture
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)

Strategy = SamplingStrategy
# Looking up at the ceiling light, so the light display (textured
# radiance in the preamble) shows too.
CAMERA_UP = FirstPersonCamera(
    position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
    rotation_x=0.7 * np.pi, rotation_z=np.pi)


def _float_texture(path, fmt, image):
    dtype = np.float16 if fmt in (vkt.VK_FORMAT_R16G16B16_SFLOAT,
                                  vkt.VK_FORMAT_R16G16B16A16_SFLOAT) \
        else np.float32
    raw = np.ascontiguousarray(image.astype(dtype)).reshape(-1) \
        .view(np.uint8).copy()
    vkt.save_vkt(path, vkt.Texture2d(format=fmt, mips=[raw],
                                     width=image.shape[1],
                                     height=image.shape[0]))
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("textured"))
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    rng = np.random.default_rng(17)
    area = _float_texture(d + "/area.vkt", vkt.VK_FORMAT_R16G16B16A16_SFLOAT,
                          rng.uniform(0.2, 2.0, (16, 16, 4)))

    def light(**kw):
        return PolygonalLightSpec(
            translation=np.array([1.0, 1.0, 1.99], np.float32),
            rotation_angles=np.array([np.pi, 0, 0], np.float32),
            scaling_x=0.4, scaling_y=0.4,
            radiant_flux=np.array([40.0, 35.0, 30.0], np.float32), **kw)

    def build(lights, linear=()):
        jscene = load_scene(vks, d + "/cornell_box_textures", lights,
                            noise_type=NoiseType.WHITE, data_directory=d,
                            linear_light_specs=list(linear))
        return jscene, scene_from_numpy(tree_leaves(jscene), "cpu")

    return {
        "ies": build([light(texturing_technique=3,
                            texture_file_path=_ies_profile_texture(d))]),
        "area": build([light(texturing_technique=1, texture_file_path=area),
                       light(texturing_technique=1,
                             texture_file_path=d + "/missing.vkt")]),
        "linear": build([light()], [LinearLightSpec(
            start=np.array([0.2, 1.0, 1.9], np.float32),
            end=np.array([1.8, 1.0, 1.9], np.float32),
            radiant_flux=np.array([40.0, 36.0, 30.0], np.float32))]),
    }


def test_ies_light_frame_matches_reference(scenes):
    """The IES-profile experiment's configuration (46): MIS, shadows."""
    jscene, scene = scenes["ies"]
    assert int(np.asarray(jscene.lights.texture_index)[0]) == 1
    assert int(scene.lights.texture_index[0]) == 1
    settings = RenderSettings(trace_shadow_rays=True)
    for camera in (CAMERA, CAMERA_UP):
        got, want = compare_frames(jscene, scene, settings, camera)
        assert_frames_agree(got, want)


def test_textured_area_light_frame_matches_reference(scenes):
    """A float16 area texture and a missing file (white)."""
    jscene, scene = scenes["area"]
    np.testing.assert_array_equal(scene.lights.texture_index.numpy(), [1, 0])
    settings = RenderSettings(sampling_strategy=Strategy.DIFFUSE_ONLY,
                              sample_count=2)
    got, want = compare_frames(jscene, scene, settings, CAMERA_UP)
    assert_frames_agree(got, want)


@pytest.mark.parametrize("technique", ["uniform", "projected_ris"])
def test_linear_light_frame_matches_reference(scenes, technique):
    jscene, scene = scenes["linear"]
    settings = RenderSettings(
        sampling_strategy=Strategy.DIFFUSE_SPECULAR_MIS,
        linear_technique=technique)
    got, want = compare_frames(jscene, scene, settings,
                               linear_light_count=1)
    assert_frames_agree(got, want)


@pytest.mark.parametrize("fmt", [vkt.VK_FORMAT_R16G16B16_SFLOAT,
                                 vkt.VK_FORMAT_R16G16B16A16_SFLOAT,
                                 vkt.VK_FORMAT_R32G32B32_SFLOAT,
                                 vkt.VK_FORMAT_R32G32B32A32_SFLOAT,
                                 vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK])
def test_light_texture_decoding_matches_reference(tmp_path, fmt):
    rng = np.random.default_rng(fmt)
    channels = 3 if fmt in (vkt.VK_FORMAT_R16G16B16_SFLOAT,
                            vkt.VK_FORMAT_R32G32B32_SFLOAT) else 4
    image = rng.uniform(0.0, 3.0, (16, 16, channels)).astype(np.float32)
    path = str(tmp_path / "t.vkt")
    if fmt == vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK:
        vkt.save_vkt(path, vkt.encode_texture(np.clip(image, 0, 1), fmt))
    else:
        _float_texture(path, fmt, image)
    got = vkt.load_vkt(path).decode_to_float()
    want = j_vkt.load_vkt(path).decode_to_float()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        if fmt == vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK:
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
