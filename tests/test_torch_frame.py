"""The slice as a whole: the PyTorch port's render_frame on the CPU (plain
versions of K1-K4) against the JAX package's render_frame with
traversal="bruteforce" (vmapped per-pixel shading), on the cornell box
and a tiny city, with shadows on and off. Both packages get the same
scene arrays through scene_from_numpy.

Tolerance: mean |sRGB difference| <= 1e-3 and >= 99% of pixels within
1e-2. The two pipelines reach the same estimator through different
float32 formulations (per-pixel reference sampling code vs the
structure-of-arrays twin, re-intersection vs t * direction), so a
1-spp pixel may legitimately flip a sector or shadow decision."""

import numpy as np
import pytest

from _torch_shading_inputs import to_port
from vulkan_renderer_tpu.assets.noise import NoiseType
from vulkan_renderer_tpu.core.settings import RenderSettings
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene
from vulkan_renderer_tpu.tools.city import write_city_scene
from vulkan_renderer_tpu.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.render.pipeline import render_frame
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)

WIDTH, HEIGHT = 64, 32


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cornell"))
    vks = write_test_scene(d, "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    scene = load_scene(vks, d + "/cornell_box_textures", [light],
                       noise_type=NoiseType.WHITE, data_directory=d)
    camera = FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=np.pi / 2, rotation_z=np.pi)
    return scene, camera


@pytest.fixture(scope="module")
def tiny_city(tmp_path_factory):
    """make_city(20, detail=3): 1,928 triangles in 31 clusters, two of the
    bench's street lights and the bench camera; the bench's Ahmed noise."""
    d = str(tmp_path_factory.mktemp("city"))
    vks = write_city_scene(d, "city", n_buildings=20, detail=3,
                           texture_resolution=16)
    lights = [PolygonalLightSpec(
        translation=np.array([-10.0 + 20.0 * i, 0.0, 8.0], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=1.5, scaling_y=1.5,
        radiant_flux=np.array([400.0, 380.0, 340.0], np.float32))
        for i in range(2)]
    scene = load_scene(vks, d + "/city_textures", lights,
                       noise_type=NoiseType.AHMED, data_directory=d)
    camera = FirstPersonCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    return scene, camera


def _compare(jscene, camera, shadows):
    settings = RenderSettings(trace_shadow_rays=shadows)
    count = int(jscene.lights.plane.shape[0])
    jstatic = JSceneStatic(light_count=count, light_texturing=(0,) * count,
                           traversal="bruteforce")
    want = np.asarray(j_render(jscene, jstatic, camera, settings, WIDTH,
                               HEIGHT))
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    got = render_frame(scene, SceneStatic.for_scene(scene), to_port(camera),
                       to_port(settings), WIDTH, HEIGHT).numpy()
    assert got.shape == want.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-3, diff.mean()
    assert (diff.max(axis=-1) <= 1e-2).mean() >= 0.99
    return got


@pytest.mark.parametrize("shadows", [True, False])
def test_cornell_frame_matches_reference(cornell, shadows):
    got = _compare(*cornell, shadows)
    assert 0.05 < got.mean() < 0.95


def test_frame_refuses_jax_settings(cornell):
    """The JAX package's RenderSettings is another class whose enum
    members compare unequal to the port's: the frame raises TypeError
    instead of taking a wrong branch on them."""
    jscene, camera = cornell
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    with pytest.raises(TypeError, match="port's RenderSettings"):
        render_frame(scene, SceneStatic.for_scene(scene), to_port(camera),
                     RenderSettings(), WIDTH, HEIGHT)


@pytest.mark.parametrize("shadows", [True, False])
def test_tiny_city_frame_matches_reference(tiny_city, shadows):
    jscene, _ = tiny_city
    assert jscene.clusters.cluster_count > 1
    got = _compare(*tiny_city, shadows)
    assert 0.05 < got.mean() < 0.95
